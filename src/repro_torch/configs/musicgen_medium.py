"""MusicGen-medium [arXiv:2306.05284]: 48L decoder-only over EnCodec tokens,
d_model 1536, 24H MHA, d_ff 6144, vocab 2048.  The EnCodec/text frontend is
a stub: conditioning frame embeddings ([B, 64, d]) are prepended."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-medium",
        family="audio",
        n_layers=48,
        d_model=1536,
        n_heads=24,
        n_kv_heads=24,
        d_ff=6144,
        vocab=2048,
        mlp_kind="gelu",
        frontend="audio_frames",
        n_frontend_tokens=64,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=256,
        n_frontend_tokens=8,
        param_dtype="float32", compute_dtype="float32", attn_chunk=32, remat=False,
    )

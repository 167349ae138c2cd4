"""Yi-34B [arXiv:2403.04652]: 60L, d_model 7168, 56H GQA kv=8, d_ff 20480,
vocab 64000 (llama arch)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-34b",
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab=64000,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=128, vocab=512,
        param_dtype="float32", compute_dtype="float32", attn_chunk=32, remat=False,
    )

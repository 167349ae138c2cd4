"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B]: 32L, d_model 4096, 32H MHA,
d_ff 13440, vocab 92416, QKV bias (qwen1.5 arch)."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=13440,
        vocab=92416,
        qkv_bias=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        param_dtype="float32", compute_dtype="float32", attn_chunk=32, remat=False,
    )

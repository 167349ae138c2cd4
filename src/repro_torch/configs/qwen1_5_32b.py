"""Qwen1.5-32B [hf:Qwen/Qwen1.5-32B]: 64L, d_model 5120, 40H (kv=40 MHA),
d_ff 27392, vocab 152064, QKV bias."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b",
        family="dense",
        n_layers=64,
        d_model=5120,
        n_heads=40,
        n_kv_heads=40,
        d_ff=27392,
        vocab=152064,
        qkv_bias=True,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
        param_dtype="float32", compute_dtype="float32", attn_chunk=32, remat=False,
    )

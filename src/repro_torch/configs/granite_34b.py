"""Granite-34B-Code [arXiv:2405.04324]: 88L, d_model 6144, 48H MQA (kv=1),
d_ff 24576, vocab 49152."""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab=49152,
        mlp_kind="gelu",
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128, vocab=512,
        param_dtype="float32", compute_dtype="float32", attn_chunk=32, remat=False,
    )

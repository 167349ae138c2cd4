"""Mixtral-8x7B [arXiv:2401.04088]: 32L, d_model 4096, 32H GQA kv=8,
8 experts top-2 (d_ff_expert 14336), vocab 32000, sliding window 4096."""

from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=0,  # every layer is MoE
        vocab=32000,
        attn_kind="swa",
        window=4096,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        vocab=512,
        window=32,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
        param_dtype="float32",
        compute_dtype="float32",
        attn_chunk=32,
        remat=False,
    )

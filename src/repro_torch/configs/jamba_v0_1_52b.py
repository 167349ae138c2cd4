"""Jamba-v0.1-52B [arXiv:2403.19887]: 32L, d_model 4096, 32H GQA kv=8,
Mamba:attention 7:1 interleave (attention at position 3 of each 8-layer
block), MoE 16 experts top-2 (d_ff_expert 14336) every other layer,
vocab 65536."""

from repro_torch.models.config import MambaConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        d_ff=14336,  # dense-MLP layers between MoE layers
        vocab=65536,
        block_pattern=(
            "mamba", "mamba", "mamba", "attn",
            "mamba", "mamba", "mamba", "mamba",
        ),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336, every=2, offset=1),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, every=2, offset=1),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2, chunk=16),
        param_dtype="float32", compute_dtype="float32", attn_chunk=32, remat=False,
    )

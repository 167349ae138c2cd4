"""PaliGemma-3B [arXiv:2407.07726] — Gemma-2B text backbone + SigLIP vision.

Backbone only per the assignment: 18L, d_model 2048, 8 heads MQA (kv=1),
d_ff 16384, vocab 257216.  The SigLIP frontend is a stub — ``input_specs``
provides precomputed patch embeddings ([B, 256, d] for 224px/14px patches)
that are prepended to the text sequence (prefix-LM simplified to causal;
noted in DESIGN.md).
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        family="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,  # gemma uses wide heads: 8 x 256
        d_ff=16384,
        vocab=257216,
        frontend="vision_patches",
        n_frontend_tokens=256,
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        head_dim=16,
        d_ff=128,
        vocab=512,
        n_frontend_tokens=8,
        param_dtype="float32",
        compute_dtype="float32",
        attn_chunk=32,
        remat=False,
    )

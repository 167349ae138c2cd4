"""DeepSeek-V2-236B [arXiv:2405.04434]: 60L, d_model 5120, 128H, MLA with
kv_lora 512 (+64 decoupled RoPE dims), MoE 160 routed experts top-6 +
2 shared, expert d_ff 1536, vocab 102400.  Layer 0 uses a dense MLP
(12288) per the released model.

The registry's form is the reference's (``repro.configs``), field for
field, and leaves out parts of the published config.json: the q-LoRA
bottleneck (rank 1536) and its RMSNorm, the latent's RMSNorm, YaRN's
RoPE scaling (factor 40 over 4096 positions) and its softmax scale,
group-limited routing (8 groups, 3 kept) and the routed scale (16, the
top-6 not renormalised).  ``bench/configs/deepseek-v2-236b.12l.ep8.json`` carries them, built as
``models.config.MLAConfig`` with a ``GroupedMoEConfig``."""

from repro_torch.models.config import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=12288,  # dense-MLP width (first_dense layer only)
        vocab=102400,
        kv_lora_rank=512,
        qk_rope_dim=64,
        moe=MoEConfig(
            n_experts=160,
            top_k=6,
            d_ff_expert=1536,
            n_shared_experts=2,
            first_dense=1,
        ),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        kv_lora_rank=32,
        qk_rope_dim=8,
        moe=MoEConfig(
            n_experts=8, top_k=2, d_ff_expert=32, n_shared_experts=1, first_dense=1
        ),
        param_dtype="float32",
        compute_dtype="float32",
        attn_chunk=32,
        remat=False,
    )

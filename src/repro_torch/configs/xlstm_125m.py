"""xLSTM-125M [arXiv:2405.04517]: 12 blocks, d_model 768, 4 heads,
sLSTM + mLSTM mix (one sLSTM per 6 blocks here), vocab 50304, no FFN
(d_ff=0; the cells carry their own up/down projections)."""

from repro_torch.models.config import ModelConfig, XLSTMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab=50304,
        block_pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
        xlstm=XLSTMConfig(proj_factor=2.0),
        param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )


def smoke_config() -> ModelConfig:
    return config().with_(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, vocab=512,
        block_pattern=("mlstm", "slstm"),
        param_dtype="float32", compute_dtype="float32", attn_chunk=32, remat=False,
    )

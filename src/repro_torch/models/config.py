"""Model configuration covering all ten assigned architectures.

One dataclass describes dense/GQA/MQA transformers, MoE (Mixtral/DeepSeek/
Jamba style), MLA compressed-KV attention, sliding-window attention, Mamba
(SSM) blocks, xLSTM (sLSTM/mLSTM) blocks, and hybrid interleaves — plus the
modality-frontend stubs ([vlm]/[audio] backbones take precomputed patch /
frame embeddings as an extra input, per the assignment spec).

``block_pattern`` is the repeating layer-group pattern; the LM scans over
pattern repeats (stacked params) so HLO stays compact for 88-layer models.

Port of ``repro.models.config``, copied whole: pure dataclasses.  The
port's LM keeps the stacked layout (one tensor per parameter, groups
along axis 0) and loops over the groups in Python.

Beyond the reference: ``MLAConfig`` and ``GroupedMoEConfig``, frozen
subclasses of ``ModelConfig`` and ``MoEConfig`` that carry what
DeepSeek-V2's published config adds to the registry's MLA and MoE
(q-LoRA, the latent norms, YaRN; group-limited routing, the routed
scale, and the share of the experts one chip holds; sigmoid scoring with
a correction bias and renormalised weights, as Kimi-Linear publishes
it), and ``HybridMLAConfig``, MLA beside KDA linear-attention layers
(``KDAConfig``) in a published per-layer order.  The base classes keep
exactly the reference's fields, so every registry configuration
compares field for field with the reference's; code that reads one of
the new settings treats a base-class configuration as having it off.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Literal

BlockKind = Literal["attn", "mamba", "mlstm", "slstm", "kda"]


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # which layers are MoE: every `every`-th layer starting at `offset`
    every: int = 1
    offset: int = 0
    # first `first_dense` layers use the dense MLP regardless (DeepSeek-V2)
    first_dense: int = 0
    # router jitter/aux-loss weight
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class GroupedMoEConfig(MoEConfig):
    """DeepSeek-V2's router and one chip's share of its experts.

    The router scores ``n_routed_experts`` experts (the published count),
    split into ``n_group`` equal groups: each token keeps the
    ``topk_group`` groups whose best expert scores highest and takes its
    ``top_k`` experts from those (``group_limited_greedy``).  The weights
    are the softmax scores of the experts taken times
    ``routed_scaling_factor``, not renormalised (``norm_topk_prob`` false,
    as DeepSeek-V2 publishes it).  This chip holds ``n_experts`` of them,
    from ``first_expert`` on: the layer computes only what those give,
    and the capacity is counted over the router's width."""

    n_routed_experts: int = 0  # the router's width; 0: n_experts (every expert held)
    first_expert: int = 0
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    # Kimi-Linear's router: "sigmoid" scores each expert on its own; the
    # experts are chosen by score + a learned correction bias (the FFN's
    # ``score_bias`` parameter, over the router's width) and weighted by
    # their unbiased scores, renormalised to sum to 1 where ``renormalize``
    scoring: Literal["softmax", "sigmoid"] = "softmax"
    renormalize: bool = False


@dataclass(frozen=True)
class YarnRope:
    """YaRN's scaling of RoPE (arXiv:2309.00071) with DeepSeek-V2's
    ``rope_scaling`` keys: the frequencies blend from interpolated
    (divided by ``factor``) to the original ones over the dims whose
    wavelengths lie between ``beta_fast`` and ``beta_slow`` rotations of
    ``original_max_position``; the tables are multiplied by
    mscale(factor, ``mscale``) / mscale(factor, ``mscale_all_dim``), and
    the softmax scale by mscale(factor, ``mscale_all_dim``) squared."""

    factor: float
    original_max_position: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 => ceil(d_model / 16)
    chunk: int = 128  # associative-scan chunk length


@dataclass(frozen=True)
class XLSTMConfig:
    # positions (mod pattern length) that are sLSTM blocks; rest are mLSTM
    slstm_every: int = 4  # one sLSTM per 4 blocks (xLSTM[7:1]-style mix)
    proj_factor: float = 2.0
    conv_kernel: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 => d_model // n_heads
    # attention flavor
    attn_kind: str = "full"  # full | swa
    window: int = 0
    qkv_bias: bool = False
    # MLA (DeepSeek-V2): latent-compressed KV; 0 disables.  Decoupled RoPE
    # carries position info in a small shared k_rope dim so decode can run
    # fully in latent space (matrix absorption).
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    # FFN kind: "swiglu" (3-matrix gated) or "gelu" (2-matrix classic)
    mlp_kind: str = "swiglu"
    # block pattern: None => all-attention; else repeated layer-group kinds
    block_pattern: tuple[BlockKind, ...] | None = None
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    xlstm: XLSTMConfig | None = None
    # modality frontend stub: extra embedding input prepended/added
    frontend: str | None = None  # "vision_patches" | "audio_frames" | None
    n_frontend_tokens: int = 0
    # numerics / misc
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True
    attn_chunk: int = 512  # blockwise-attention chunk (memory control)
    # serving
    kv_cache_dtype: str = "bfloat16"  # "int8" enables quantized KV cache
    # scheduled-kernel policy: route hot GEMMs through the paper's backend
    use_scheduled_kernels: bool = False

    # ---- derived -----------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pattern(self) -> tuple[BlockKind, ...]:
        if self.block_pattern is not None:
            return self.block_pattern
        return ("attn",)

    @property
    def n_groups(self) -> int:
        p = len(self.pattern)
        assert self.n_layers % p == 0, (self.name, self.n_layers, p)
        return self.n_layers // p

    def layer_kind(self, i: int) -> BlockKind:
        return self.pattern[i % len(self.pattern)]

    def is_moe_layer(self, i: int) -> bool:
        m = self.moe
        if m is None:
            return False
        if i < m.first_dense:
            return False
        return (i - m.offset) % m.every == 0 if i >= m.offset else False

    def param_count(self) -> int:
        """Approximate total parameter count (embeddings + blocks + head)."""
        d, dh = self.d_model, self.head_dim_
        total = self.vocab * d  # embed
        if not self.tie_embeddings:
            total += self.vocab * d  # head
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind == "attn":
                if self.kv_lora_rank:
                    total += d * self.n_heads * dh  # q
                    total += d * self.kv_lora_rank  # kv down
                    total += self.kv_lora_rank * self.n_kv_heads * dh * 2  # k,v up
                else:
                    total += d * self.n_heads * dh  # q
                    total += 2 * d * self.n_kv_heads * dh  # k, v
                total += self.n_heads * dh * d  # out
            elif kind == "mamba":
                mc = self.mamba or MambaConfig()
                d_in = mc.expand * d
                dt_rank = mc.dt_rank or -(-d // 16)
                total += d * 2 * d_in  # in_proj
                total += d_in * mc.d_conv  # conv
                total += d_in * (dt_rank + 2 * mc.d_state)  # x_proj
                total += dt_rank * d_in + d_in  # dt_proj
                total += d_in * mc.d_state + d_in  # A_log, D
                total += d_in * d  # out_proj
            elif kind in ("mlstm", "slstm"):
                xc = self.xlstm or XLSTMConfig()
                if kind == "mlstm":
                    d_in = int(xc.proj_factor * d)
                    total += d * 2 * d_in + 3 * d_in * d_in + d_in * d
                else:
                    total += 4 * 2 * d * d + 4 * d  # in + recurrent gates
            # FFN
            if self.is_moe_layer(i):
                m = self.moe
                total += m.n_experts * 3 * d * m.d_ff_expert
                total += m.n_shared_experts * 3 * d * m.d_ff_expert
                total += d * m.n_experts  # router
            elif self.d_ff:
                n_mats = 3 if self.mlp_kind == "swiglu" else 2
                total += n_mats * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        n_moe_layers = sum(self.is_moe_layer(i) for i in range(self.n_layers))
        unused = (m.n_experts - m.top_k) * 3 * self.d_model * m.d_ff_expert
        return full - n_moe_layers * unused

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class MLAConfig(ModelConfig):
    """MLA as DeepSeek-V2 publishes it (§2.1 of arXiv:2405.04434): q
    through a rank-``q_lora_rank`` bottleneck with an RMSNorm between its
    two projections (0: the registry's direct q), an RMSNorm on the
    latent before its up-projections, and RoPE under ``rope_scaling``
    (YaRN; None: plain RoPE).  ``head_dim`` is the nope and value head
    size, ``qk_rope_dim`` the rope part's."""

    q_lora_rank: int = 0
    rope_scaling: YarnRope | None = None
    rope: bool = True  # False: no positional encoding (Kimi-Linear's mla_use_nope)


@dataclass(frozen=True)
class KDAConfig:
    """Kimi Delta Attention (KDA), a gated delta-rule linear attention:
    ``n_heads`` heads whose keys and values are ``head_dim`` wide (a
    ``head_dim`` x ``head_dim`` float32 state a head), after depthwise
    causal convolutions of ``conv_size`` taps."""

    n_heads: int = 32
    head_dim: int = 128
    conv_size: int = 4


@dataclass(frozen=True)
class HybridMLAConfig(MLAConfig):
    """MLA layers beside KDA layers in a published order that need not be
    whole repeats of one pattern (Kimi-Linear: 27 layers, MLA at 1-based
    4, 8, ..., 24 and 27).  ``layer_types`` names every layer's block kind
    in order; ``block_pattern`` is the period the layers after the dense
    prefix repeat, and the layers past its last whole repeat sit in a
    tail of their own (``models/lm.py``)."""

    layer_types: tuple[BlockKind, ...] = ()
    kda: KDAConfig | None = None

    def layer_kind(self, i: int) -> BlockKind:
        return self.layer_types[i] if self.layer_types else super().layer_kind(i)


# ---------------------------------------------------------------------------
# Input shape cells (assignment): per-arch shape suite.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def shapes_for(config: ModelConfig) -> tuple[ShapeCell, ...]:
    """long_500k requires sub-quadratic attention: only SSM/hybrid archs
    run it (full-attention archs skip it; see DESIGN.md)."""
    if config.family in ("ssm", "hybrid"):
        return SHAPES
    return tuple(s for s in SHAPES if s.name != "long_500k")

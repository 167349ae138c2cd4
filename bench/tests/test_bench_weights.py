"""The benchmark's weights: ``init_lm``'s tree, drawn from the seed."""

import dataclasses
import json
from pathlib import Path

import pytest
import torch

import lmshapes
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import lm

BENCH = Path(__file__).resolve().parents[1]
ARCHS = {"codeqwen1.5-7b": "codeqwen1_5_7b", "jamba-v0.1-52b.8l": "jamba_v0_1_52b"}


def smoke_spec(name: str, dtype: str = "bfloat16") -> dict:
    """The configuration file with the port's smoke sizes in place."""
    cfg = get_smoke_config(ARCHS[name])
    spec = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    spec.update(n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                d_ff=cfg.d_ff, vocab=cfg.vocab, attn_chunk=cfg.attn_chunk, param_dtype=dtype, compute_dtype=dtype)
    if cfg.moe:
        spec["moe"] = dataclasses.asdict(cfg.moe)
    if cfg.mamba:
        spec["mamba"] = dataclasses.asdict(cfg.mamba)
    return spec


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, (*path, k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, (*path, i))
    else:
        yield path, tree


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_tree_matches_init_lm(name):
    cfg = lmshapes.model_config(smoke_spec(name))
    ours = {p: (tuple(t.shape), t.dtype) for p, t in leaves(lmshapes.make_weights(7, cfg, "cpu"))}
    port = {p: (tuple(t.shape), t.dtype) for p, t in leaves(lm.init_lm(0, cfg, device="cpu"))}
    assert ours == port


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_configuration_file_is_the_ports_published_config(name):
    """The file's sizes are the port's registry entry, but for the cut in
    ``reduced`` and the keys in ``registry_differs``, where the registry
    departs from the published config.json and the file holds the
    published value."""
    spec = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    cfg = lmshapes.model_config(spec)
    full = get_config(ARCHS[name])
    if full.mamba is not None and not full.mamba.dt_rank:  # 0: ceil(d_model / 16), stated in the file
        full = full.with_(mamba=dataclasses.replace(full.mamba, dt_rank=-(-full.d_model // 16)))
    fields = {f.name for f in dataclasses.fields(full)} - {"name"}
    differ = {k for k in spec if k in fields and getattr(cfg, k) != getattr(full, k)}
    assert differ == set(spec["reduced"]) | set(spec.get("registry_differs", []))
    assert cfg.with_(name=full.name, **{k: getattr(full, k) for k in differ}) == full


def test_same_seed_same_weights_and_scales():
    cfg = lmshapes.model_config(smoke_spec("jamba-v0.1-52b.8l", "float32"))
    a, b, c = (dict(leaves(lmshapes.make_weights(s, cfg, "cpu"))) for s in (3, 3, 4))
    assert all(torch.equal(a[p], b[p]) for p in a)
    assert not torch.equal(a[("head", "w")], c[("head", "w")])
    # init_lm's scales: the embedding 0.02, a dense sqrt(2 / (d_in + d_out))
    assert abs(float(a[("embed", "table")].std()) - 0.02) < 0.002
    w = a[("head", "w")]
    assert abs(float(w.std()) - (2 / sum(w.shape)) ** 0.5) < 0.1 * (2 / sum(w.shape)) ** 0.5
    assert torch.equal(a[("groups", "pos0", "block", "A_log")][0, 0],
                       torch.log(torch.arange(1, cfg.mamba.d_state + 1, dtype=torch.float32)))
    assert a[("groups", "pos1", "ffn", "router", "w")].dtype == torch.float32


def test_flops_count_the_active_weights():
    cfg = lmshapes.model_config(json.loads((BENCH / "configs" / "codeqwen1.5-7b.json").read_text()))
    # every weight of a dense model is active; the head and embedding aside
    assert lmshapes.active_body_params(cfg) == cfg.param_count() - 2 * cfg.vocab * cfg.d_model
    one = lmshapes.request_flops(cfg, 1, 1)
    assert one == 2 * lmshapes.active_body_params(cfg) + 2 * cfg.d_model * cfg.vocab + 4 * 4096 * 32
    jamba = lmshapes.model_config(json.loads((BENCH / "configs" / "jamba-v0.1-52b.8l.json").read_text()))
    assert lmshapes.active_body_params(jamba) + 2 * jamba.vocab * jamba.d_model < jamba.active_param_count() * 1.001

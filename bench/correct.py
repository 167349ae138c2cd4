"""The comparison that decides ``correct``.

After the window, a sample of whole waves drawn from the seed
(``harness.check_waves``: at least 256 served tokens) is run again by the
configuration's plain reference (``reference/<config>.py``, float32, TF32
off): one forward pass over each wave's padded prompts and the tokens the
engine served.  Over every position compared, the numbers that
``limits/<cell>.json`` may hold, each against its limit, each over the
largest reference logit of the position's wave:

* ``served_err``: the widest departure of a served position from the
  reference, the larger of ``logit_err`` and ``token_gap``.
* ``logit_err``: the largest distance between a logit that
  ``lm.prefill`` or ``lm.decode_step`` returned inside the window and the
  reference's.
* ``token_gap``: the widest gap by which a served token's reference logit
  lies below the reference's best at its position.  Greedy decoding
  serves the program's best, so a served token lies within twice its
  position's logit distance of the best; a wrong token lies about a
  whole logit below it.
* ``route_gap`` (MoE models): the widest gap, in router logits, by
  which an expert that ``moe.route`` chose inside the window lies below
  the reference router's k-th best for the same token, over every MoE
  layer and position, the reference's router reading its own input to
  that layer.  The reference takes the program's experts, so the numbers
  above measure the arithmetic and not the top-2 choice's discontinuity
  (``reference/jamba-v0.1-52b.8l.py``); this one checks the router's
  choice, as ``token_gap`` checks the head's.

The control (``control.py``) reads the same numbers of the reference
computed with float8 products in the program's place, its own experts
handed to the float32 reference in the same way.
"""

from __future__ import annotations

import torch


def wave_inputs(wave, new_tokens: int, device):
    """(tokens [B, L + new], positions read, the engine calls' positions)
    of a wave: its prompts left-padded with token 0 to the longest L, as
    the engine pads them, then the served tokens; the positions of the
    prefill's logits and each decode step's; the prefill's segment
    [0, L), then one segment per decode step."""
    plen = max(len(p) for p in wave.prompts)
    rows = []
    for p, out in zip(wave.prompts, wave.outputs, strict=True):
        row = [0] * (plen - len(p)) + [int(x) for x in p] + [int(x) for x in out]
        rows.append(row)
    tokens = torch.tensor(rows, dtype=torch.long, device=device)
    read = torch.arange(plen - 1, plen + new_tokens, device=device)
    segments = [(0, plen)] + [(plen + j, plen + j + 1) for j in range(new_tokens)]
    return tokens, read, segments


def reference_logits(cell, weights, wave, device, mm=None, routes=None):
    """The reference's logits [B, new + 1, V] at the wave's read positions
    (``routes``: ``plain.Routes``, the experts to take, where the model
    has MoE layers)."""
    from reference import plain

    tokens, read, segments = wave_inputs(wave, cell.traffic.new_tokens, device)
    with torch.inference_mode(), plain.full_f32():
        return cell.reference.logits(weights, cell.spec, tokens, read, segments, mm=mm or plain.f32_mm,
                                     routes=routes)


def program_routes(wave, new_tokens: int) -> list | None:
    """The program's expert choices per MoE layer, [B, S, k] over the
    wave's positions, from its calls to ``moe.route`` in call order: the
    prefill's, one per MoE layer, then each decode step's."""
    calls = wave.routes
    if not calls:
        return None
    n_moe, b = len(calls) // (new_tokens + 1), len(wave.prompts)
    return [torch.cat([calls[m].reshape(b, -1, calls[m].shape[-1])]
                      + [calls[n_moe * (1 + j) + m].reshape(b, 1, -1) for j in range(new_tokens)], dim=1)
            for m in range(n_moe)]


def gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """How far each token's reference logit lies below the position's best:
    ref [B, P, V], tokens [B, P]."""
    return ref.amax(-1) - ref.gather(-1, tokens[..., None].long())[..., 0]


def logit_errs(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each position's largest logit distance over the largest reference
    logit: [B, P] from [B, P, V]."""
    return (got.to(torch.float32) - ref).abs().amax(-1) / ref.abs().max()


def token_gaps(ref: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``gaps`` of the tokens at the positions that serve one ([B, new]
    of the [B, new + 1] read), over the largest reference logit."""
    return gaps(ref[:, :-1], tokens) / ref.abs().max()


def numbers(gap: torch.Tensor, err: torch.Tensor, route_gap: float | None = None) -> dict[str, float]:
    """The numbers a limit may hold, over every position compared (``gap``
    and ``err`` over their wave's largest reference logit; ``route_gap``
    where the model routes)."""
    gap, err = gap.flatten(), err.flatten()
    out = {"served_err": max(float(gap.max()), float(err.max())), "token_gap": float(gap.max()),
           "logit_err": float(err.max())}
    if route_gap is not None:
        out["route_gap"] = route_gap
    return out


def wave_arrays(cell, weights, wave, device):
    """(served tokens' ``token_gaps``, positions' ``logit_errs``, the
    ``route_gap`` of the program's experts or None) of one wave the
    program served, the reference taking the program's experts; None
    where a request went unanswered (the run counts it failed)."""
    from reference import plain

    n = cell.traffic.new_tokens
    if any(o is None or len(o) != n for o in wave.outputs) or len(wave.logits) != n + 1:
        return None
    routes = plain.Routes(program_routes(wave, n))
    ref = reference_logits(cell, weights, wave, device, routes=routes)
    served = torch.tensor(wave.outputs, device=device)
    return token_gaps(ref, served), logit_errs(torch.cat(wave.logits, dim=1), ref), route_gap(routes)


def route_gap(routes) -> float | None:
    """A ``plain.Routes``' gap, where it forced any choice."""
    return routes.gap if routes.used and routes.forced is not None else None


def judge(found: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(correct, each number beside its limit)."""
    checks = {k: {"value": found.get(k), "limit": limits[k]} for k in sorted(limits)}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def check(cell, weights, kept, device) -> dict[str, float]:
    """The numbers over every position of the sampled waves."""
    arrays = [a for a in (wave_arrays(cell, weights, w, device) for w in kept) if a is not None]
    for w in kept:
        w.logits = w.routes = []
    return combine(arrays)


def combine(arrays: list) -> dict[str, float]:
    """``numbers`` over several waves' ``wave_arrays``."""
    if not arrays:
        return {}
    routed = [a[2] for a in arrays if a[2] is not None]
    return numbers(torch.cat([a[0].flatten() for a in arrays]), torch.cat([a[1].flatten() for a in arrays]),
                   max(routed) if routed else None)

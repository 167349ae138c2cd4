"""Model FLOP utilisation of the whole serving step: the useful model
FLOPs of the timed waves' requests (``configs/<config>.py:request_flops``:
the matrix weights a token meets, the head for each generated token,
attention over each token's real causal context; no padding, no Mamba
scan) over those waves' host-clock seconds x the card's bf16 peak.  The
timed waves run without the profiler, whose per-launch cost would
lengthen the denominator."""

import hopper


def read(obs):
    if not obs.get("timed_s"):
        return None
    return 100.0 * obs["timed_flops"] / (obs["timed_s"] * hopper.MFU_PEAK_FLOPS)

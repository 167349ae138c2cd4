"""Readings that the limits of ``correct`` are set from.

    python3 bench/control.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3

In one process, for each seed: the cell's weights, then the waves that a
run checks, served at the cell's own load through the timed path (the
engine under the scheduled-kernel policy), then the reference.  Prints one
JSON line a seed with the program's numbers (``correct.numbers``) and,
for the control seeds, the control's: the reference computed with
float8 e4m3 products in the program's place (the precision below the
configuration's bfloat16), its greedy token at each position read by the
float32 reference's gap, its logits by their distance.  The lower
reading of a limit is the program's largest over the seeds, the upper
the control's smallest (``PERF.md`` gives both).  Needs a card.
"""

import argparse
import json
import sys
import time

import run


def control_arrays(cell, weights, wave, device):
    """The control on one wave, held to the float32 reference as the
    program is (``correct.wave_arrays``): the gaps of the tokens that
    float8 products in the program's place put first, their logits'
    distances, and the ``route_gap`` of its expert choices."""
    import correct
    from reference import plain

    chosen = plain.Routes()
    ctrl = correct.reference_logits(cell, weights, wave, device, mm=plain.fp8_mm, routes=chosen)
    routes = plain.Routes(chosen.used or None)
    ref = correct.reference_logits(cell, weights, wave, device, routes=routes)
    return (correct.token_gaps(ref, ctrl[:, :-1].argmax(-1)), correct.logit_errs(ctrl, ref),
            correct.route_gap(routes))


def readings(cell, seed: int, control: bool, device, log=sys.stderr) -> dict:
    import torch

    import correct
    import harness

    out = harness.run(cell, seed, 0.0, False, device, time.perf_counter(), log,
                      min_waves=harness.check_waves(cell.traffic))
    row = {"seed": seed, "waves": len(out["kept"])}
    if control:
        row["control"] = correct.combine([control_arrays(cell, out["weights"], w, device) for w in out["kept"]])
    row["program"] = correct.check(cell, out["weights"], out["kept"], device)
    del out
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    run.prepare()
    import torch

    import harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = harness.Cell.load(json.loads((run.ROOT / "BENCHMARK.json").read_text()), args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        row = readings(cell, seed, seed in controls, "cuda")
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

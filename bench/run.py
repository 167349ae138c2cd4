"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (the port under ``src/``, the benchmark
under ``bench/``, ``BENCHMARK.json`` beside them).  It needs as many
CUDA cards as the cell asks for and never falls back to the CPU.  With
``--trace 0`` the result line carries the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics and a breakdown of the traced
waves.  The kernel library and the schedule cache live under
``build/`` in the checkout, so only a checkout's first run builds them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names the process must not hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CACHE = ROOT / "build" / "bench_cache"


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def prepare() -> None:
    """The port's schedule cache at a fixed path in the checkout (the
    kernel library builds under ``build/`` there by itself), and the
    harness and the port on the import path."""
    os.environ["REPRO_TORCH_CACHE_DIR"] = str(CACHE / "schedules")
    for path in (ROOT / "bench", ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir() or not (ROOT / "BENCHMARK.json").is_file():
        print(f"bench: {ROOT} is not a checkout of the repository (src/repro_torch, BENCHMARK.json)",
              file=sys.stderr)
        return 2
    prepare()

    import torch

    import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = harness.Cell.load(bench, args.workload)
    chips = next(w["chips"] for w in bench["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: {args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f"bench: the process holds {', '.join(loaded)} after the window", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each library's sources under ``kernels/csrc/`` (``SOURCES``) compile on
first use, one ``nvcc`` per source, all started together, and link into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), under ``build/repro_torch_kernels/`` at the root of the
checkout.  The file name carries a hash of every file under ``csrc/`` and
the flags, so an edited source or header rebuilds and an unchanged tree
loads what is there.  Nothing builds when a module is imported: ``load``
runs inside the first launch.

It also holds what every kernel wrapper shares: ``check`` turns an entry
point's return code into an error, and ``LaunchCounts`` counts each
kernel's launches, all of them reset at once by ``reset_launches``; a
CUDA graph's replays add what its capture counted (``add_launches``).

The port's own module, with no counterpart in the reference (Pallas
compiles its kernels inside ``pl.pallas_call``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"

#: Hopper with its architecture-specific features; no --use_fast_math
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
#: the sources of each library: the scheduled GEMM's mma.sync design
#: (every form) and its wgmma + TMA design (bf16, m >= 64), the LM
#: prefill's fused attention (``kernels/attention.py``), Mamba's
#: selective scan (``kernels/scan.py``), MLA's decode attention
#: (``kernels/mla.py``) and KDA's recurrence (``kernels/kda.py``)
SOURCES = {"gemm": ("gemm.cu", "gemm_wgmma.cu", "attention_wgmma.cu", "selective_scan.cu", "mla_decode.cu",
                    "kda_recurrent.cu")}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}

#: ``hopper.cuh``'s own return codes beyond CUDA's: kEncodeError plus the
#: CUresult of a failed cuTensorMapEncodeTiled, and kNoEncoder
ENCODE_ERROR, NO_ENCODER = 100_000, 200_000


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default
    install location.  Raises if neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin/nvcc); "
        "the port's CUDA kernels build on a machine with the CUDA toolkit"
    )


def build_dir() -> Path:
    """``build/repro_torch_kernels/`` at the root of the checkout this
    package runs from.  An installed copy has no checkout around it, so it
    raises rather than build beside the interpreter."""
    root = Path(__file__).resolve().parents[3]
    if not (root / "src" / "repro_torch").is_dir():
        raise RuntimeError(
            f"repro_torch is not running from a checkout ({root / 'src' / 'repro_torch'} "
            f"does not exist); its CUDA kernels build under the checkout's build/ "
            f"directory, so run it from a source tree (PYTHONPATH=src or an "
            f"editable install)"
        )
    return root / "build" / "repro_torch_kernels"


def library_path(name: str) -> Path:
    """Where the library ``name`` lives for this tree of sources."""
    digest = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile and link the library ``name`` unless it is already built.
    Returns the library path and the compiler's report (``-Xptxas=-v``:
    registers, shared memory and spills per kernel; empty when the library
    was already there).  Each source compiles in its own ``nvcc``, all at
    once; the library is linked under a temporary name and renamed into
    place, so concurrent builds never see half a file."""
    out = library_path(name)
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objects = [Path(tmp) / f"{Path(src).stem}.o" for src in SOURCES[name]]
        procs = [
            subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(SOURCES[name], objects)
        ]
        reports = [proc.communicate()[0] for proc in procs]
        for src, proc, report in zip(SOURCES[name], procs, reports):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{report}")
        lib = Path(tmp) / out.name
        link = subprocess.run([nvcc(), "-shared", "-o", str(lib), *map(str, objects)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed linking lib{name} (exit {link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(lib, out)
    return out, "".join(reports)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library ``name`` once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build(name)
            lib = ctypes.CDLL(str(path))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def bind(fn, argtypes: list) -> ctypes._CFuncPtr:
    """An entry point ``fn`` of a loaded library, its arguments typed as
    ``argtypes`` on first use; every entry point returns an int status
    (``check``)."""
    if fn.argtypes is None:
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise RuntimeError unless ``rc``, the status an entry point of
    ``lib`` returned for the kernel ``what``, is 0: ``hopper.cuh``'s
    tensor-map codes, else a CUDA error with its string."""
    if rc == 0:
        return
    if rc >= NO_ENCODER:
        raise RuntimeError(f"{what}: the CUDA driver has no cuTensorMapEncodeTiled")
    if rc >= ENCODE_ERROR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed: CUresult {rc - ENCODE_ERROR}")
    msg = lib.repro_cuda_error_string(rc).decode()
    raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


_counts_lock = threading.Lock()
_counts: list[LaunchCounts] = []


class LaunchCounts(dict):
    """A kernel's launches by key, a live dict whose keys its wrapper
    declares, counted where the kernel launches and nowhere else (the
    plain versions never count).  Serving threads launch beside the
    caller's, so every kernel's counts move under one lock, and
    ``reset_launches`` zeros them all."""

    def __init__(self, *keys: str) -> None:
        super().__init__(dict.fromkeys(keys, 0))
        with _counts_lock:
            _counts.append(self)

    def record(self, key: str, *split: tuple[LaunchCounts, str]) -> None:
        """Count one launch under ``key``, and under each (counts, key) of
        ``split`` in the same hold of the lock."""
        with _counts_lock:
            self[key] += 1
            for counts, sub in split:
                counts[sub] += 1


def reset_launches() -> None:
    """Every kernel's launch counts to 0: a launch window opens."""
    with _counts_lock:
        for counts in _counts:
            for key in counts:
                counts[key] = 0


def launches() -> dict[str, int]:
    """Every kernel's launch counts in one table, read at once."""
    with _counts_lock:
        return {key: n for counts in _counts for key, n in counts.items()}


def add_launches(counts: dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` (keys of ``launches()``) to the live
    counts at once: a CUDA graph's replay launches what its capture
    counted, and the capture itself launched nothing."""
    with _counts_lock:
        for live in _counts:
            for key in live.keys() & counts.keys():
                live[key] += times * counts[key]

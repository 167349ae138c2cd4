"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source under ``kernels/csrc/`` compiles on first use into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), under ``build/repro_torch_kernels/`` at the root of the
checkout.  The file name carries a hash of the source and the flags, so an
edited source rebuilds and an unchanged one loads what is there.  Nothing
builds when a module is imported: ``load`` runs inside the first launch.

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
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


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
    """Where the library of ``csrc/<name>.cu`` lives for this source."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.
    Returns the library path and the compiler's report (``-Xptxas=-v``:
    registers, shared memory and spills per kernel; empty when the library
    was already there).  The library is written under a temporary name
    and renamed into place, so concurrent builders never see half a file."""
    out = library_path(name)
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` once per process."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build(name)
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib

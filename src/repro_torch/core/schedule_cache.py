"""Persistent schedule cache for the integration registry.

Extended-CoSA DSE is the expensive step of a compile: per workload it sweeps
(dataflow x memory-share x double-buffer) candidates, solves each with the
greedy heuristic, and ranks them on the cycle model.  Models reuse the
same handful of GEMM shapes across layers and across *runs*, so
``build_integrated_backend()`` attaches this cache to every backend it
builds: entries are keyed by ``(workload, architecture fingerprint,
pipeline mode)`` and persisted as JSON, so recompiling the same graph —
even in a fresh process — performs zero scheduler invocations.

The arch fingerprint (``AcceleratorDescription.fingerprint()``) covers the
full architectural description plus scheduling-relevant functional state, so
editing an accelerator description invalidates its entries automatically.

Port of ``repro.core.schedule_cache``, whole, with two deliberate
differences:

  * its own default directory, ``$REPRO_TORCH_CACHE_DIR`` or
    ``~/.cache/repro_torch`` (never the reference's ``REPRO_CACHE_DIR``),
    so the two packages share a cache file only when a caller points both
    at one directory;
  * a **measured** entry's selector names the device that timed it
    (``measured8@cuda:NVIDIA H100 80GB HBM3``, ``measured8@cpu``; see
    ``measured_selector``), so a CPU-timed winner never answers for the
    card.  Modeled keys are spelled exactly as the reference spells them
    (the two packages' description fingerprints are equal), so a file of
    modeled entries written by either package is warm for the other.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import threading
from dataclasses import dataclass, field
from pathlib import Path

try:
    import fcntl
except ImportError:  # non-POSIX: fall back to atomic replace only
    fcntl = None


from repro_torch.core.accel import AcceleratorDescription
from repro_torch.core.arch_spec import GemmWorkload
from repro_torch.core.schedule import Schedule
from repro_torch.core.scheduler import ScheduleResult
from repro_torch.core.simulator import SimReport

CACHE_FORMAT_VERSION = 1
_CACHE_FILE = "schedules.json"


@contextlib.contextmanager
def _writer_lock(cache_file: Path):
    """Advisory cross-process lock around a cache-file read-merge-write
    (sidecar ``<file>.lock``).  Degrades to a no-op where ``flock`` is
    unavailable or the lock file cannot be created — writes then rely on
    atomic replace alone (never torn, possibly losing a merge race)."""
    if fcntl is None:
        yield
        return
    lock_path = cache_file.with_name(cache_file.name + ".lock")
    try:
        fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
    except OSError:
        yield
        return
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        with contextlib.suppress(OSError):
            fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


#: the port's own cache-location variable (the reference reads REPRO_CACHE_DIR)
CACHE_DIR_ENV = "REPRO_TORCH_CACHE_DIR"


def default_cache_dir() -> Path:
    """``$REPRO_TORCH_CACHE_DIR``, else ``~/.cache/repro_torch``."""
    env = os.environ.get(CACHE_DIR_ENV)
    if env:
        return Path(env)
    return Path.home() / ".cache" / "repro_torch"


def measured_selector(k: int, device_tag: str) -> str:
    """The cache selector of a measured-DSE entry: ``measured{k}`` (the
    reference's spelling) plus the device that timed the candidates, e.g.
    ``measured8@cuda:NVIDIA H100 80GB HBM3`` or ``measured8@cpu`` — the
    one place the port's keys differ from the reference's."""
    return f"measured{k}@{device_tag}"


# -- (de)serialization of cache values --------------------------------------


def result_to_dict(r: ScheduleResult) -> dict:
    d = {
        "best": r.best.to_dict(),
        "report": dataclasses.asdict(r.report),
        "n_candidates": r.n_candidates,
        "n_infeasible": r.n_infeasible,
    }
    # optional fields stay absent when empty, as the reference writes them,
    # so the two packages' entries serialize identically
    if r.top:
        d["top"] = [
            [s.to_dict(), dataclasses.asdict(rep)] for s, rep in r.top
        ]
    if r.measured is not None:
        d["measured"] = r.measured
    return d


def result_from_dict(d: dict) -> ScheduleResult:
    return ScheduleResult(
        best=Schedule.from_dict(d["best"]),
        report=SimReport(**d["report"]),
        n_candidates=d["n_candidates"],
        n_infeasible=d["n_infeasible"],
        top=tuple(
            (Schedule.from_dict(s), SimReport(**rep))
            for s, rep in d.get("top", [])
        ),
        measured=d.get("measured"),
    )


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    puts: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class ScheduleCache:
    """Two-tier (memory + optional JSON file) cache of ScheduleResults.

    ``path=None`` keeps the cache purely in-memory (still shared across the
    backends of one process when the same instance is passed around).  With a
    directory path, ``flush()`` (called once per backend compile) writes the
    file atomically and merges with entries other processes wrote in the
    meantime, so concurrent writers at worst lose a race, never corrupt the
    file or drop each other's entries.
    """

    path: Path | None = None
    stats: CacheStats = field(default_factory=CacheStats)
    _mem: dict[str, ScheduleResult] = field(default_factory=dict)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _dirty: bool = False

    def __post_init__(self):
        if self.path is not None:
            self.path = Path(self.path)
            self._load()

    # -- keying -------------------------------------------------------------
    @staticmethod
    def key_for(
        workload: GemmWorkload,
        desc: AcceleratorDescription | str,
        mode: str,
        solver: str = "mip",
        selector: str = "modeled",
    ) -> str:
        """``desc`` is a description or its precomputed ``fingerprint()``
        (callers on a hot path memoize it).  ``solver`` names what actually
        produced the schedule (the scheduler's ``solver_id()``) so MIP- and
        heuristic-derived entries never shadow each other.  ``selector``
        discriminates how the winner was picked: ``"modeled"`` (cycle-model
        argmin, the reference's key spelling) vs a ``measured_selector``
        (wall-clock re-rank of the top-K candidates on one device) — a
        measured entry never shadows a modeled one and vice versa."""
        fp = desc if isinstance(desc, str) else desc.fingerprint()
        sel = "" if selector == "modeled" else f"{selector}|"
        wl = workload.key()  # (N, C, K, in_bytes, w_bytes, out_bytes)
        return f"{fp}|{solver}|{mode}|{sel}" + "x".join(str(v) for v in wl)

    # -- lookup / insert ----------------------------------------------------
    def get(self, key: str) -> ScheduleResult | None:
        with self._lock:
            hit = self._mem.get(key)
            if hit is not None:
                self.stats.hits += 1
            else:
                self.stats.misses += 1
            return hit

    def put(self, key: str, result: ScheduleResult) -> None:
        """Insert into the memory tier; the disk tier is written by
        ``flush()`` (the backend flushes once per compile, not per node)."""
        with self._lock:
            self._mem[key] = result
            self.stats.puts += 1
            self._dirty = True

    def flush(self) -> None:
        """Write pending entries through to disk (merging with concurrent
        writers' entries).  No-op when nothing changed or memory-only."""
        with self._lock:
            if self._dirty:
                self._try_save_locked(merge=True)
                self._dirty = False

    def __len__(self) -> int:
        return len(self._mem)

    def clear(self) -> None:
        """Drop every entry from BOTH tiers (the disk file is rewritten
        empty, not merged)."""
        with self._lock:
            self._mem.clear()
            self._dirty = False
            self._try_save_locked(merge=False)

    # -- persistence --------------------------------------------------------
    @property
    def file(self) -> Path | None:
        return None if self.path is None else self.path / _CACHE_FILE

    def _load(self) -> None:
        f = self.file
        if f is None or not f.exists():
            return
        try:
            payload = json.loads(f.read_text())
            if payload.get("version") != CACHE_FORMAT_VERSION:
                return  # stale format: start fresh, overwrite on next put
            self._mem = {
                k: result_from_dict(v) for k, v in payload["entries"].items()
            }
        except (OSError, ValueError, KeyError, TypeError):
            self._mem = {}  # corrupt cache is never fatal

    def _try_save_locked(self, merge: bool = True) -> None:
        """Persist if possible; an unwritable cache location must never fail
        a compile — degrade to memory-only with a one-time warning."""
        if self.path is None:
            return
        try:
            self._save_locked(merge=merge)
        except OSError as e:
            import warnings

            warnings.warn(
                f"schedule cache is not persistable at {self.path} ({e}); "
                f"continuing with the in-memory tier only",
                RuntimeWarning,
                stacklevel=3,
            )
            self.path = None

    def _save_locked(self, merge: bool = True) -> None:
        f = self.file
        assert f is not None
        f.parent.mkdir(parents=True, exist_ok=True)
        # Serialize the read-merge-write against every other writer of this
        # cache dir (other processes AND other ScheduleCache instances in
        # this process — a pid-suffixed tmp name is NOT unique across
        # threads) with an advisory lock on a sidecar file.  Where flock is
        # unavailable the atomic tmp+replace below still guarantees the
        # file is never torn; at worst a concurrent writer's entries lose
        # the replace race.
        with _writer_lock(f):
            # merge with whatever is on disk (raw, no deserialization) so
            # concurrent writers sharing the cache dir don't drop each
            # other's entries; our entries win on key collision.  clear()
            # passes merge=False so the disk tier is actually emptied.
            entries: dict = {}
            if merge:
                try:
                    prior = json.loads(f.read_text())
                    if prior.get("version") == CACHE_FORMAT_VERSION:
                        entries = dict(prior.get("entries", {}))
                except (OSError, ValueError):
                    pass
            entries.update(
                (k, result_to_dict(v)) for k, v in self._mem.items()
            )
            payload = {"version": CACHE_FORMAT_VERSION, "entries": entries}
            fd, tmp_name = tempfile.mkstemp(
                prefix=f.name + ".tmp.", dir=f.parent
            )
            try:
                with os.fdopen(fd, "w") as out:
                    out.write(json.dumps(payload))
                os.replace(tmp_name, f)
            except BaseException:
                with contextlib.suppress(OSError):
                    os.unlink(tmp_name)
                raise

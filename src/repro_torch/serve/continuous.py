"""Block-based continuous batching over compiled decode plans.

The serve path for stateful decode: one compiled *prefill* plan and one
compiled batched *decode* plan — both produced by ``repro_torch.compile``
from a ``repro_torch.core.zoo.DecodeModel``'s traced graphs — run behind a
scheduler that keeps a static decode batch of ``batch`` slots and
backfills each finished slot with a prefill of the next queued prompt.
Unlike ``MicroBatcher``'s restart-the-bucket waves, a long request never
stalls the batch: short requests drain and their slots are reused
immediately (continuous batching).

KV storage follows the pie/symphony ``Block`` scheme: a ``BlockPool``
owns fixed-size blocks of K/V rows, each request holds a *block table*
(logical row ``t`` lives in ``table[t // block_size]`` at offset
``t % block_size``), and blocks are allocated on admit / freed on finish.
The pool is the durable, fragmentation-free store and the admission
control (a request is only admitted when enough blocks exist for its
prompt + generation budget); the compiled plan itself consumes dense
``[B, max_len, d]`` staging arrays — static shapes are what keep the
decode step a single plan execution — which the engine keeps consistent
with the pool row-for-row.

Everything is single-threaded and deterministic: the decode batch is one
``CompiledModule.run`` per step, and the cache outputs (named by the
graph's ``CacheSpec.state``) are threaded back as the next step's cache
inputs without any per-step gather.

Port of ``repro.serve.continuous``.  The engine and ``sequential_generate``
compile the decode model's traced graphs (``trace(batch=B)``,
``trace(seq=P)``, ``trace()``), as the reference does.  The state
stays numpy between steps, as in the reference: each step uploads the two
staging caches to the module's device and downloads the updated ones.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

import repro_torch
from repro_torch.core import zoo
from repro_torch.core.zoo import DecodeModel


class PoolExhausted(RuntimeError):
    """The BlockPool has no free block (admission control failed to gate)."""


class BlockPool:
    """Fixed-size-block K/V storage with a free list.

    ``n_blocks`` blocks of ``block_size`` rows of width ``width``; K and V
    are stored side by side per block.  ``alloc``/``free`` are O(1); the
    peak occupancy is tracked for the serve banner and the bench report.
    """

    def __init__(self, n_blocks: int, block_size: int, width: int, dtype="int8"):
        if n_blocks < 1 or block_size < 1:
            raise ValueError("BlockPool needs n_blocks >= 1 and block_size >= 1")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.k = np.zeros((n_blocks, block_size, width), dtype)
        self.v = np.zeros((n_blocks, block_size, width), dtype)
        self._free = list(range(n_blocks - 1, -1, -1))
        self.peak_used = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_blocks - len(self._free)

    def occupancy(self) -> float:
        return self.n_used / self.n_blocks

    def blocks_for(self, n_rows: int) -> int:
        return -(-n_rows // self.block_size)

    def alloc(self) -> int:
        if not self._free:
            raise PoolExhausted(
                f"no free KV block ({self.n_blocks} x {self.block_size} rows all in use)"
            )
        blk = self._free.pop()
        self.peak_used = max(self.peak_used, self.n_used)
        return blk

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            self.k[b] = 0
            self.v[b] = 0
            self._free.append(b)

    def write_row(self, table: list[int], row: int, k_vec, v_vec) -> None:
        blk, off = table[row // self.block_size], row % self.block_size
        self.k[blk, off] = k_vec
        self.v[blk, off] = v_vec

    def gather(self, table: list[int], n_rows: int) -> tuple[np.ndarray, np.ndarray]:
        """Contiguous ``[n_rows, width]`` K and V views of a block table."""
        rows_k = [self.k[table[t // self.block_size], t % self.block_size]
                  for t in range(n_rows)]
        rows_v = [self.v[table[t // self.block_size], t % self.block_size]
                  for t in range(n_rows)]
        width = self.k.shape[-1]
        empty = np.zeros((0, width), self.k.dtype)
        return (np.stack(rows_k) if rows_k else empty,
                np.stack(rows_v) if rows_v else empty)


@dataclass(frozen=True)
class EngineConfig:
    #: static decode batch — the compiled decode plan's slot count
    batch: int = 4
    #: static prefill length (prompts are right-padded up to this)
    prompt_len: int = 8
    max_new_tokens: int = 16
    #: KV block granularity in rows
    block_size: int = 8
    #: pool capacity; default sizes the pool for ``batch`` full-length caches
    n_blocks: int | None = None


@dataclass
class DecodeRequest:
    rid: int
    #: int8 feature rows ``[S, d]`` (the decode models are feature-level:
    #: no embedding op in the IR, so a "token" is the model's output row and
    #: the reported token id is its argmax)
    prompt: np.ndarray
    tokens: list[int] = field(default_factory=list)
    vectors: list[np.ndarray] = field(default_factory=list)
    done: bool = False

    def emit(self, vec: np.ndarray) -> None:
        self.vectors.append(np.array(vec))
        self.tokens.append(int(np.argmax(vec)))


@dataclass
class ServeReport:
    requests: list[DecodeRequest]
    total_new_tokens: int
    wall_s: float
    tokens_per_s: float
    decode_steps: int
    prefills: int
    peak_occupancy: float
    n_blocks: int
    block_size: int


class ContinuousBatchingEngine:
    """Continuous batching over one prefill plan + one batched decode plan."""

    def __init__(self, model: DecodeModel, target, cfg: EngineConfig | None = None,
                 options=None):
        self.model = model
        self.cfg = cfg = cfg or EngineConfig()
        if cfg.prompt_len + cfg.max_new_tokens > model.max_len:
            raise ValueError(
                f"prompt_len {cfg.prompt_len} + max_new_tokens {cfg.max_new_tokens} "
                f"exceeds the model's KV capacity max_len={model.max_len}"
            )
        t0 = time.perf_counter()
        self.decode_mod = repro_torch.compile(
            model.trace(batch=cfg.batch), target=target, options=options
        )
        self.prefill_mod = repro_torch.compile(
            model.trace(seq=cfg.prompt_len), target=target, options=options
        )
        self.compile_s = time.perf_counter() - t0
        spec = self.decode_mod.graph.cache_spec
        #: cache input name -> graph output index, from the graph contract
        self.state_wiring = dict(spec.state)

        d, ml = model.d_model, model.max_len
        n_blocks = cfg.n_blocks
        if n_blocks is None:
            n_blocks = cfg.batch * (-(-ml // cfg.block_size))
        self.pool = BlockPool(n_blocks, cfg.block_size, d)
        b = cfg.batch
        self._state = {name: np.zeros((b, ml, d), np.int8) for name in self.state_wiring}
        self._pos = np.zeros((b,), np.int32)
        self._x = np.zeros((b, 1, d), np.int8)
        self._slots: list[DecodeRequest | None] = [None] * b
        self._tables: list[list[int]] = [[] for _ in range(b)]

    # -- admission ----------------------------------------------------------
    def _admit(self, queue: list[DecodeRequest]) -> int:
        cfg, admitted = self.cfg, 0
        for slot in range(cfg.batch):
            if self._slots[slot] is not None or not queue:
                continue
            need = self.pool.blocks_for(len(queue[0].prompt) + cfg.max_new_tokens)
            if need > self.pool.n_free:
                break  # backpressure: head-of-line waits for blocks
            self._prefill_into(slot, queue.pop(0))
            admitted += 1
        return admitted

    def _prefill_into(self, slot: int, req: DecodeRequest) -> None:
        cfg, d, ml = self.cfg, self.model.d_model, self.model.max_len
        s = len(req.prompt)
        if not 1 <= s <= cfg.prompt_len:
            raise ValueError(
                f"prompt length {s} outside [1, prompt_len={cfg.prompt_len}]"
            )
        x = np.zeros((cfg.prompt_len, d), np.int8)
        x[:s] = req.prompt
        out, kc, vc = self.prefill_mod.run({
            "x": x,
            "k_cache": np.zeros((ml, d), np.int8),
            "v_cache": np.zeros((ml, d), np.int8),
            "pos": np.zeros((), np.int32),
            "mask": zoo.prefill_mask(cfg.prompt_len, ml),
        })
        table = [self.pool.alloc() for _ in range(self.pool.blocks_for(s + cfg.max_new_tokens))]
        self._tables[slot] = table
        for row in range(s):
            self.pool.write_row(table, row, kc[row], vc[row])
        self._state["k_cache"][slot] = kc
        self._state["v_cache"][slot] = vc
        self._pos[slot] = s
        self._x[slot, 0] = out[s - 1]
        self._slots[slot] = req
        req.emit(out[s - 1])
        if len(req.tokens) >= cfg.max_new_tokens:
            self._finish(slot)  # prefill already produced the whole budget

    # -- decode -------------------------------------------------------------
    def _step(self) -> int:
        """One batched decode step; returns tokens produced."""
        cfg, ml = self.cfg, self.model.max_len
        feeds = {
            "x": self._x,
            "pos": self._pos,
            "mask": zoo.decode_mask(self._pos, ml),
            **self._state,
        }
        outs = self.decode_mod.run(feeds)
        out = outs[0]
        for name, idx in self.state_wiring.items():
            self._state[name] = np.asarray(outs[idx])
        produced = 0
        for slot, req in enumerate(self._slots):
            if req is None:
                continue
            row = int(self._pos[slot])  # the row this step's token occupied
            table = self._tables[slot]
            if row // self.pool.block_size >= len(table):
                table.append(self.pool.alloc())
            self.pool.write_row(
                table, row,
                self._state["k_cache"][slot, row],
                self._state["v_cache"][slot, row],
            )
            self._pos[slot] = row + 1
            vec = out[slot, 0]
            req.emit(vec)
            self._x[slot, 0] = vec
            produced += 1
            if len(req.tokens) >= cfg.max_new_tokens or int(self._pos[slot]) >= ml:
                self._finish(slot)
        return produced

    def _finish(self, slot: int) -> None:
        req = self._slots[slot]
        req.done = True
        self.pool.free(self._tables[slot])
        self._tables[slot] = []
        self._slots[slot] = None
        self._pos[slot] = 0
        self._x[slot] = 0

    # -- public -------------------------------------------------------------
    def run(self, requests: list[DecodeRequest]) -> ServeReport:
        queue = list(requests)
        t0 = time.perf_counter()
        steps = prefills = 0
        while queue or any(r is not None for r in self._slots):
            prefills += self._admit(queue)
            if not any(r is not None for r in self._slots):
                if queue:  # pool can't fit even the head request
                    raise PoolExhausted(
                        "queued request cannot be admitted: pool of "
                        f"{self.pool.n_blocks} blocks x {self.pool.block_size} rows "
                        "is smaller than one request's prompt + generation budget"
                    )
                break
            self._step()
            steps += 1
        wall = time.perf_counter() - t0
        total = sum(len(r.tokens) for r in requests)
        return ServeReport(
            requests=requests,
            total_new_tokens=total,
            wall_s=wall,
            tokens_per_s=total / wall if wall > 0 else float("inf"),
            decode_steps=steps,
            prefills=prefills,
            peak_occupancy=self.pool.peak_used / self.pool.n_blocks,
            n_blocks=self.pool.n_blocks,
            block_size=self.pool.block_size,
        )


def sequential_generate(model: DecodeModel, target, requests: list[DecodeRequest],
                        cfg: EngineConfig | None = None, options=None) -> ServeReport:
    """The naive baseline: one request at a time, prefill then a batch-1
    decode loop — what serving an LM without continuous batching costs.
    Emits bit-identical tokens to the engine (same plans' math, batch of 1)."""
    cfg = cfg or EngineConfig()
    d, ml = model.d_model, model.max_len
    decode_mod = repro_torch.compile(model.trace(), target=target, options=options)
    prefill_mod = repro_torch.compile(model.trace(seq=cfg.prompt_len), target=target,
                                      options=options)
    t0 = time.perf_counter()
    steps = 0
    for req in requests:
        s = len(req.prompt)
        x = np.zeros((cfg.prompt_len, d), np.int8)
        x[:s] = req.prompt
        out, kc, vc = prefill_mod.run({
            "x": x,
            "k_cache": np.zeros((ml, d), np.int8),
            "v_cache": np.zeros((ml, d), np.int8),
            "pos": np.zeros((), np.int32),
            "mask": zoo.prefill_mask(cfg.prompt_len, ml),
        })
        req.emit(out[s - 1])
        cur = out[s - 1 : s]
        pos = s
        while len(req.tokens) < cfg.max_new_tokens and pos < ml:
            out1, kc, vc = decode_mod.run({
                "x": cur,
                "k_cache": kc,
                "v_cache": vc,
                "pos": np.asarray(pos, np.int32),
                "mask": zoo.decode_mask(np.asarray(pos), ml),
            })
            req.emit(out1[0])
            cur = out1
            pos += 1
            steps += 1
        req.done = True
    wall = time.perf_counter() - t0
    total = sum(len(r.tokens) for r in requests)
    return ServeReport(
        requests=requests,
        total_new_tokens=total,
        wall_s=wall,
        tokens_per_s=total / wall if wall > 0 else float("inf"),
        decode_steps=steps,
        prefills=len(requests),
        peak_occupancy=0.0,
        n_blocks=0,
        block_size=cfg.block_size,
    )


def random_requests(model: DecodeModel, n: int, prompt_len: int,
                    seed: int = 0) -> list[DecodeRequest]:
    """``n`` requests with deterministic random prompts of varied lengths in
    ``[1, prompt_len]`` (the ragged arrival mix continuous batching exists
    for)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        s = int(rng.integers(1, prompt_len + 1))
        prompt = rng.integers(-128, 128, (s, model.d_model)).astype(np.int8)
        reqs.append(DecodeRequest(rid=i, prompt=prompt))
    return reqs

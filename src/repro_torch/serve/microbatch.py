"""Micro-batching request queue for accelerator-compiled modules.

Serving traffic arrives one request at a time; batched ExecutionPlans want
it in bucket-sized chunks.  The :class:`MicroBatcher` sits between the two:
``submit(feeds)`` enqueues one per-sample request and returns a future, a
single dispatcher thread collects requests until either ``max_batch`` are
waiting or ``max_delay_s`` has passed since the *oldest* undispatched
request, then executes the whole batch as ONE ``run_many`` call (which a
``BatchedModule`` turns into padded bucketed executions).

The module handed in must be safe to call from the dispatcher thread while
callers keep submitting — both ``CompiledModule`` (one arena per call) and
``BatchedModule`` are.  Use as a context manager, or call ``close()``; both
drain the queue before shutting the dispatcher down.

Port of ``repro.serve.microbatch``, whole.  The dispatcher thread issues
the module's kernel launches; it makes the module's device its current
CUDA device first (CUDA's current device is per thread), so a module on
any card dispatches on that card.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field

import torch


@dataclass
class BatchStats:
    """Dispatch accounting: how well the queue is actually batching.
    ``batch_sizes`` keeps only the most recent dispatches (bounded, so a
    long-lived serving process never grows it without limit)."""

    requests: int = 0
    batches: int = 0
    batch_sizes: deque = field(default_factory=lambda: deque(maxlen=1024))

    def mean_batch(self) -> float:
        return self.requests / self.batches if self.batches else 0.0


class MicroBatcher:
    """Collect up to ``max_batch`` requests (or until ``max_delay_s`` after
    the first) and dispatch them as one batched execution."""

    def __init__(self, module, *, max_batch: int = 8, max_delay_s: float = 0.002):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay_s < 0:
            raise ValueError(f"max_delay_s must be >= 0, got {max_delay_s}")
        self.module = module
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.stats = BatchStats()
        self._queue: queue.Queue = queue.Queue()
        self._closed = False
        # serializes submit() against close(): nothing may be enqueued
        # after the shutdown sentinel, or its future would never resolve
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(
            target=self._dispatch_loop, name="microbatcher", daemon=True
        )
        self._worker.start()

    # -- client surface ------------------------------------------------------
    def submit(self, feeds) -> Future:
        """Enqueue one per-sample request; the future resolves to that
        request's output list."""
        future: Future = Future()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.put((feeds, future, time.monotonic()))
        return future

    def close(self) -> None:
        """Drain outstanding requests, then stop the dispatcher."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # after this, no request can follow it
        self._worker.join()

    def __enter__(self) -> "MicroBatcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatcher ----------------------------------------------------------
    def _collect(self) -> list | None:
        """Block for the first request, then gather until the batch is full
        or its deadline passes.  The deadline counts from the head
        request's SUBMIT time, so a request that queued behind a previous
        dispatch never waits another full max_delay_s on top.  None means
        shutdown (after draining)."""
        head = self._queue.get()
        if head is None:
            return None
        batch = [head]
        deadline = head[2] + self.max_delay_s
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            try:
                item = (
                    self._queue.get_nowait()
                    if timeout <= 0
                    else self._queue.get(timeout=timeout)
                )
            except queue.Empty:
                break
            if item is None:
                # shutdown sentinel: dispatch what we have, then exit on
                # the next loop round
                self._queue.put(None)
                break
            batch.append(item)
        return batch

    def _dispatch_loop(self) -> None:
        device = getattr(self.module, "device", None)
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(device)
        while True:
            batch = self._collect()
            if batch is None:
                return
            # transition every future to RUNNING; a client that cancelled
            # while queued is dropped here (and set_result below can never
            # hit an already-cancelled future and kill the dispatcher)
            batch = [
                item for item in batch if item[1].set_running_or_notify_cancel()
            ]
            if not batch:
                continue
            feeds_list = [feeds for feeds, _, _ in batch]
            try:
                outs = self.module.run_many(feeds_list)
            except BaseException:  # noqa: BLE001 — isolate the bad request
                # one request's bad feeds (or any input-dependent failure)
                # must not fail its co-batched neighbors: re-run each
                # request alone and attribute errors individually
                for feeds, future, _ in batch:
                    try:
                        out = self.module.run_many([feeds])[0]
                    except BaseException as e:  # noqa: BLE001
                        future.set_exception(e)
                    else:
                        self.stats.requests += 1
                        self.stats.batches += 1
                        self.stats.batch_sizes.append(1)
                        future.set_result(out)
                continue
            self.stats.requests += len(batch)
            self.stats.batches += 1
            self.stats.batch_sizes.append(len(batch))
            for (_, future, _), out in zip(batch, outs):
                future.set_result(out)

"""The Verifier seam: the CPU verifier and the batched CUDA verifier.

Counterpart of ``at2_node_tpu/crypto/verifier.py``. Every signature a node
checks goes through an async :class:`Verifier`. :class:`CpuVerifier` checks
each signature on the CPU (OpenSSL, on a thread pool or in one native bulk
call), as the reference's ``CpuVerifier`` does on its per-signature route.
:class:`CudaBatchVerifier` is the port of ``TpuBatchVerifier``'s
per-signature path: it accumulates
requests, pads a flush to a bucket of its ladder, and runs each batch
through a three-stage pipeline (host prep and upload, kernel launch,
completion) on three executor threads, so consecutive batches overlap. A
flush goes out when the queue reaches ``batch_size`` or when the oldest
request has waited ``max_delay``, whichever comes first; a backlog deeper
than ``batch_size`` coalesces into the largest bucket it can fill.

Random-linear-combination (RLC) verification is not ported yet (ROADMAP.md,
queue 1, item 8). ``CudaBatchVerifier`` takes ``mode="per_sig"``, and
``auto`` without ``rlc_min_batch`` (which on the reference's device path
never routes a flush to RLC either). ``CpuVerifier`` takes ``per_sig``
only, since the reference's CPU ``auto`` routes to RLC from 128 signatures;
its default mode is therefore ``per_sig`` where the reference's is
``auto``, as is ``VerifierConfig.mode``'s (``node/config.py:78``), which the
node slice settles. Anything that would route to RLC raises
``NotImplementedError``.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import List, Protocol, Sequence, Tuple

import numpy as np
import torch

from ..obs.registry import Histogram
from ..ops import cuda_verify
from ..ops import ed25519 as kernel
from .keys import verify_one

_MODE_CODES = {"per_sig": 0, "rlc": 1, "auto": 2}

_RLC_NOT_PORTED = (
    "RLC verification is not ported yet (ROADMAP.md, queue 1, item 8: "
    "ops/aggregate.py -> certificate and RLC verify); use mode='per_sig'"
)


class Verifier(Protocol):
    """Anything that can check ed25519 signatures asynchronously."""

    async def verify(self, public_key: bytes, message: bytes, signature: bytes) -> bool:
        ...

    async def verify_many(
        self, items: Sequence[Tuple[bytes, bytes, bytes]]
    ) -> List[bool]:
        ...

    async def warmup(self) -> None:
        ...

    async def close(self) -> None:
        ...

    def stats(self) -> dict:
        ...


class CpuVerifier:
    """Per-signature CPU verification on a thread pool (the reference's
    execution model: `num_cpus` broadcast workers each verifying inline,
    at2-node/src/bin/server/rpc.rs:125). Verdicts are OpenSSL's (or the
    RFC 8032 fallback's), as ``verify_one`` gives them. Per-sig only:
    ``mode`` other than ``per_sig`` raises ``NotImplementedError``."""

    def __init__(self, max_workers: int | None = None, mode: str = "per_sig") -> None:
        if mode not in _MODE_CODES:
            raise ValueError(f"unknown verifier mode: {mode!r}")
        if mode != "per_sig":
            raise NotImplementedError(_RLC_NOT_PORTED)
        self.mode = mode
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._max_workers = self._pool._max_workers
        self.signatures_verified = 0

    def stats(self) -> dict:
        return {
            "signatures": self.signatures_verified,
            "mode": _MODE_CODES[self.mode],
            "mode_name": self.mode,
        }

    async def warmup(self) -> None:
        """Build and load the native ingest library off the event loop
        (the bulk-verify path uses it)."""
        from ..native.ingest import ingest_available

        await asyncio.get_running_loop().run_in_executor(self._pool, ingest_available)

    async def verify(self, public_key: bytes, message: bytes, signature: bytes) -> bool:
        loop = asyncio.get_running_loop()
        self.signatures_verified += 1
        return await loop.run_in_executor(
            self._pool, verify_one, public_key, message, signature
        )

    async def verify_many(
        self, items: Sequence[Tuple[bytes, bytes, bytes]]
    ) -> List[bool]:
        """Bulk path: one executor round-trip and, when the native ingest
        library is built, one C call for the whole chunk: OpenSSL runs on
        native threads with the GIL released. Else per-slice Python
        verification on the pool."""
        from ..native.ingest import ingest_ready_or_kick, verify_bulk_native

        loop = asyncio.get_running_loop()
        self.signatures_verified += len(items)
        n = len(items)
        if n == 0:
            return []
        # The one-C-call path has a fixed staging cost (ragged packing,
        # the ctypes crossing) that pays off only on real batches, so
        # small chunks stay on the slice path. ingest_ready_or_kick never
        # builds: g++ must not run on the event loop.
        if n >= 32 and ingest_ready_or_kick():
            # native threads capped at the real core count: the executor's
            # max_workers is an IO-sizing default (cpu + 4)
            n_threads = max(1, min(self._max_workers, os.cpu_count() or 1))
            result = await loop.run_in_executor(
                self._pool, verify_bulk_native, items, n_threads
            )
            return result.tolist()

        slices = min(n, self._max_workers)
        step = (n + slices - 1) // slices

        def run(chunk):
            return [verify_one(pk, msg, sig) for pk, msg, sig in chunk]

        futs = [
            loop.run_in_executor(self._pool, run, items[i : i + step])
            for i in range(0, n, step)
        ]
        out: List[bool] = []
        for results in await asyncio.gather(*futs):
            out.extend(results)
        return out

    async def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)


class _ChunkSink:
    """Result collector shared by every signature of one enqueued chunk:
    one asyncio future per chunk, not one per signature, which keeps the
    per-message future/gather overhead off the event loop."""

    __slots__ = ("future", "results", "remaining")

    def __init__(self, loop: asyncio.AbstractEventLoop, n: int) -> None:
        self.future: asyncio.Future = loop.create_future()
        self.results: List[bool] = [False] * n
        self.remaining = n

    def set(self, idx: int, ok: bool) -> None:
        self.results[idx] = ok
        self.remaining -= 1
        if self.remaining == 0 and not self.future.done():
            self.future.set_result(self.results)

    def fail(self, exc: BaseException) -> None:
        if not self.future.done():
            self.future.set_exception(exc)


@dataclass
class _Pending:
    public_key: bytes
    message: bytes
    signature: bytes
    sink: _ChunkSink
    idx: int  # this signature's slot in sink.results
    enqueued_at: float


class _Routes:
    """Per-flush route record. Every flush of this verifier is per-sig;
    the counters keep the reference's ``stats()`` keys (its router's) so
    an operator view reads both verifiers alike. As in the reference, a
    flush is recorded only in ``auto`` mode."""

    def __init__(self) -> None:
        self.route_per_sig = 0
        self.last_batch = 0
        self.h_rlc_lanes = Histogram("route_rlc_lanes", "lanes per RLC-routed flush")
        self.h_per_sig_lanes = Histogram(
            "route_per_sig_lanes", "lanes per per-sig-routed flush"
        )

    def per_sig(self, n: int) -> None:
        self.route_per_sig += 1
        self.last_batch = n
        self.h_per_sig_lanes.observe(float(n))

    def stats(self) -> dict:
        return {
            "route_rlc": 0,
            "route_per_sig": self.route_per_sig,
            "route_last": "per_sig",
            "route_last_batch": self.last_batch,
            "route_last_expected_bad": 0.0,
            "router_sources": 0,
            **self.h_rlc_lanes.flat("route_rlc_lanes"),
            **self.h_per_sig_lanes.flat("route_per_sig_lanes"),
        }


class CudaBatchVerifier:
    """Accumulate -> pad to bucket -> one kernel launch -> resolve futures.

    Stages, each on its own executor thread, so batch N+1's prep and
    upload overlap batch N's kernel and completion:

    * ``_prep``   — host prep into a pooled pinned staging buffer, then the
      host->device copy on the verifier's copy stream;
    * ``_launch`` — the compute stream waits for the copy, launches the
      kernel and starts the bitmask's copy back (returns at once);
    * ``_finish`` — waits for the batch's completion event, unpacks the
      verdicts and gives the staging buffer back.

    Up to ``PIPELINE_DEPTH`` batches are in flight past launch. Each stage
    thread enters the verifier's device and uses the verifier's streams.
    ``device`` None means cuda:0 and raises without a GPU; ``device="cpu"``
    runs the plain PyTorch version (tests).
    """

    PIPELINE_DEPTH = 4

    def __init__(
        self,
        batch_size: int = 256,
        max_delay: float = 0.002,
        buckets: Sequence[int] | None = None,
        max_queue: int | None = None,
        clock=None,
        mode: str = "auto",
        rlc_min_batch: int | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        from ..clock import SYSTEM_CLOCK

        if mode not in _MODE_CODES:
            raise ValueError(f"unknown verifier mode: {mode!r}")
        if mode == "rlc" or (mode == "auto" and rlc_min_batch is not None):
            raise NotImplementedError(_RLC_NOT_PORTED)
        self.device = cuda_verify.resolve_device(device)
        self.mode = mode
        self.batch_size = batch_size
        self.max_delay = max_delay
        self._clock = SYSTEM_CLOCK if clock is None else clock
        # One bucket == one launch shape; with an explicit ladder (e.g.
        # ops.ed25519.BUCKETS) a timer flush lands in the smallest bucket
        # that fits and a backlog coalesces into the largest it can fill.
        self.buckets = tuple(sorted(set(buckets or ()) | {batch_size}))
        self._queue: List[_Pending] = []
        # Backpressure: callers await queue room (a counted reservation,
        # bulk acquire/release) instead of growing the accumulator.
        self.max_queue = (
            max_queue if max_queue is not None else max(8 * batch_size, 4096)
        )
        self._cap_free = self.max_queue
        self._cap_cond = asyncio.Condition()
        self._wakeup = asyncio.Event()
        self._staging = kernel.StagingPool(pinned=self.device.type == "cuda")
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._compute_stream = torch.cuda.Stream(self.device)
        else:
            self._copy_stream = self._compute_stream = None
        self._prep_pool = ThreadPoolExecutor(max_workers=1)
        self._device_pool = ThreadPoolExecutor(max_workers=1)
        self._finish_pool = ThreadPoolExecutor(max_workers=1)
        self._inflight = asyncio.Semaphore(self.PIPELINE_DEPTH)
        self._completions: set = set()
        self._closed = False
        self._flusher = asyncio.get_running_loop().create_task(self._flush_loop())
        self._routes = _Routes()
        self.batches_dispatched = 0
        self.signatures_verified = 0
        self.total_padding = 0
        self.total_dispatch_s = 0.0
        self.last_dispatch_s = 0.0
        self.total_prep_s = 0.0
        self.total_launch_s = 0.0
        self.total_finish_s = 0.0
        self.queue_peak = 0
        self.h_queue_wait = Histogram(
            "queue_wait", "enqueue -> dispatch wait of a batch's oldest item"
        )
        self.h_prep = Histogram("prep", "host prep + upload stage per batch")
        self.h_launch = Histogram("launch", "kernel launch stage per batch")
        self.h_finish = Histogram("finish", "device sync + readback per batch")
        self.h_dispatch = Histogram(
            "dispatch", "prep -> results pipeline latency per batch"
        )
        # optional flight recorder, duck-typed (``record(kind, fields)``):
        # flush decisions (take / depth / bucket) explain latency spikes
        self.recorder = None

    def stats(self) -> dict:
        """Operator counters: batch occupancy, padding, stage latencies."""
        n_b = self.batches_dispatched
        n_s = self.signatures_verified
        lanes = n_s + self.total_padding
        return {
            "batches": n_b,
            "signatures": n_s,
            "queue_depth": len(self._queue),
            "queue_peak": self.queue_peak,
            "max_queue": self.max_queue,
            "capacity_free": self._cap_free,
            "batch_occupancy": n_s / lanes if lanes else 0.0,
            "padding_ratio": self.total_padding / lanes if lanes else 0.0,
            # per-batch prep->results latency (stages overlap across
            # batches, so this is not additive with throughput)
            "avg_dispatch_ms": (1e3 * self.total_dispatch_s / n_b) if n_b else 0.0,
            "last_dispatch_ms": 1e3 * self.last_dispatch_s,
            # stage means include their executor-queue wait
            "prep_ms_avg": (1e3 * self.total_prep_s / n_b) if n_b else 0.0,
            "launch_ms_avg": (1e3 * self.total_launch_s / n_b) if n_b else 0.0,
            "finish_ms_avg": (1e3 * self.total_finish_s / n_b) if n_b else 0.0,
            **self.h_queue_wait.flat("queue_wait"),
            "mode": _MODE_CODES[self.mode],
            "mode_name": self.mode,
            "rlc_batches": 0,
            "rlc_fallbacks": 0,
            "rlc_reroutes": 0,
            **self._routes.stats(),
        }

    def stage_histograms(self) -> dict:
        """Per-stage latency distributions (count/sum/max/p50/p90/p99 ms)."""
        return {
            "queue_wait": self.h_queue_wait.snapshot(),
            "prep": self.h_prep.snapshot(),
            "launch": self.h_launch.snapshot(),
            "finish": self.h_finish.snapshot(),
            "dispatch": self.h_dispatch.snapshot(),
        }

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _take_for_flush(self) -> int:
        """Adaptive dispatch sizing from the live queue depth: normally one
        batch_size slice, but a backlog deeper than batch_size coalesces
        into the largest configured bucket it can fill, so one launch
        carries the fixed per-batch cost of many. A single-bucket verifier
        takes fixed batch_size slices."""
        depth = len(self._queue)
        take = self.batch_size
        for b in self.buckets:
            if b <= depth:
                take = max(take, b)
        return take

    async def _acquire(self, n: int) -> None:
        """Reserve queue room for ``n`` signatures in one await."""
        async with self._cap_cond:
            while self._cap_free < n and not self._closed:
                try:
                    await self._cap_cond.wait()
                except asyncio.CancelledError:
                    # a cancelled waiter may have CONSUMED a notify meant
                    # for a sibling; pass it on before unwinding or that
                    # sibling parks forever on free capacity (classic
                    # Condition lost-wakeup)
                    self._cap_cond.notify_all()
                    raise
            if self._closed:
                raise RuntimeError("verifier closed")
            self._cap_free -= n

    async def _release(self, n: int) -> None:
        async with self._cap_cond:
            self._cap_free += n
            self._cap_cond.notify_all()

    def _enqueue_chunk(self, items, sink: _ChunkSink) -> None:
        was_empty = not self._queue
        now = self._clock.monotonic()
        append = self._queue.append
        for idx, (pk, msg, sig) in enumerate(items):
            append(_Pending(pk, msg, sig, sink, idx, now))
        if len(self._queue) > self.queue_peak:
            self.queue_peak = len(self._queue)
        # Wake the flusher on the empty->non-empty transition too, so a lone
        # request waits max_delay, not the flusher's 100ms idle-poll tick.
        if was_empty or len(self._queue) >= self.batch_size:
            self._wakeup.set()

    async def _evict_sinks(self, sinks: set) -> None:
        """Pull a cancelled caller's not-yet-dispatched entries back out of
        the accumulator and return their reserved capacity. Entries already
        popped by the flusher are past the point of no return (the device
        is working on them); they resolve or fail through _complete."""
        kept: List[_Pending] = []
        evicted = 0
        for p in self._queue:
            if p.sink in sinks:
                evicted += 1
            else:
                kept.append(p)
        self._queue = kept
        for sink in sinks:
            sink.fail(RuntimeError("verify cancelled"))
        if evicted:
            # shielded: this runs inside cancellation unwinding and MUST
            # complete, or the cancelled caller's capacity leaks forever
            await asyncio.shield(self._release(evicted))

    async def verify(self, public_key: bytes, message: bytes, signature: bytes) -> bool:
        if self._closed:
            raise RuntimeError("verifier closed")
        await self._acquire(1)
        sink = _ChunkSink(asyncio.get_running_loop(), 1)
        self._enqueue_chunk(((public_key, message, signature),), sink)
        return (await sink.future)[0]

    async def verify_many(
        self, items: Sequence[Tuple[bytes, bytes, bytes]]
    ) -> List[bool]:
        """Bulk path: the whole chunk enters the accumulator under ONE
        capacity reservation and resolves through ONE future per
        batch_size slice (slices larger than a batch could never flush as
        one dispatch anyway, so slicing there costs nothing)."""
        if self._closed:
            raise RuntimeError("verifier closed")
        n = len(items)
        if n == 0:
            return []
        loop = asyncio.get_running_loop()
        sinks: List[_ChunkSink] = []
        items = list(items) if not isinstance(items, (list, tuple)) else items
        try:
            for i in range(0, n, self.batch_size):
                chunk = items[i : i + self.batch_size]
                await self._acquire(len(chunk))
                sink = _ChunkSink(loop, len(chunk))
                self._enqueue_chunk(chunk, sink)
                sinks.append(sink)
        except BaseException:
            # close() landed between chunks: the already-enqueued sinks
            # WILL be resolved (close fails queued entries; in-flight
            # batches resolve via _complete) — consume those futures so
            # their exceptions are retrieved and any completed chunk's
            # results aren't silently dropped as un-awaited warnings
            if sinks:
                await asyncio.gather(
                    *(s.future for s in sinks), return_exceptions=True
                )
            raise
        # gather (not sequential awaits): when an early chunk's dispatch
        # fails, every sink's exception is still retrieved — no
        # "exception was never retrieved" spam for the later chunks
        try:
            chunk_results = await asyncio.gather(*(s.future for s in sinks))
        except asyncio.CancelledError:
            # the CALLER was cancelled mid-wait: its undispatched entries
            # must not squat in the accumulator holding reserved capacity
            # (a flood of cancelled clients would otherwise wedge the
            # verifier at max_queue with work nobody wants)
            await self._evict_sinks(set(sinks))
            raise
        out: List[bool] = []
        for results in chunk_results:
            out.extend(results)
        return out

    async def _flush_loop(self) -> None:
        while not self._closed:
            if not self._queue:
                self._wakeup.clear()
                try:
                    await asyncio.wait_for(self._wakeup.wait(), timeout=0.1)
                except asyncio.TimeoutError:
                    continue
            # wait for a full batch or until the oldest request expires
            while (
                len(self._queue) < self.batch_size
                and self._queue
                and (self._clock.monotonic() - self._queue[0].enqueued_at)
                < self.max_delay
            ):
                self._wakeup.clear()
                remaining = self.max_delay - (
                    self._clock.monotonic() - self._queue[0].enqueued_at
                )
                try:
                    await asyncio.wait_for(
                        self._wakeup.wait(), timeout=max(remaining, 0.0001)
                    )
                except asyncio.TimeoutError:
                    break
            if not self._queue:
                continue
            take = self._take_for_flush()
            if self.recorder is not None:
                self.recorder.record(
                    "vflush",
                    (take, len(self._queue), self._bucket_for(take)),
                )
            batch, self._queue = (
                self._queue[:take],
                self._queue[take:],
            )
            try:
                await self._release(len(batch))
                await self._dispatch(batch)
            except BaseException as exc:
                # once popped from _queue, close()'s sweep can no longer
                # see this batch — a cancellation landing in the _release
                # await (or anywhere before dispatch resolves the sinks)
                # must fail them here or their callers hang forever
                for p in batch:
                    p.sink.fail(
                        RuntimeError("verifier closed")
                        if isinstance(exc, asyncio.CancelledError)
                        else exc
                    )
                if isinstance(exc, asyncio.CancelledError):
                    raise  # close() is tearing the flusher down
                # anything else: this batch already failed its callers;
                # the flusher itself stays up for subsequent batches

    # -- pipeline stages ---------------------------------------------------

    def _device_ctx(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _prep(self, pks, msgs, sigs, bucket):
        """Host stage: prep into a pinned staging buffer, then the upload on
        the copy stream, here rather than in _launch so batch N+1's copy
        overlaps batch N's kernel."""
        with self._device_ctx():
            host = kernel.prep_packed(pks, msgs, sigs, bucket, self._staging)
            return kernel.upload_packed(host, self.device, self._copy_stream)

    def _launch(self, uploaded):
        """Device stage: launch after the upload's event and start the
        bitmask's copy back; returns the in-flight handle without blocking."""
        with self._device_ctx():
            return kernel.launch_packed(uploaded, self._compute_stream)

    def _finish(self, handle, n: int) -> np.ndarray:
        """Completion stage: block until this batch's results land."""
        with self._device_ctx():
            return kernel.finish_packed(handle, n, self._staging)

    def _run_batch(self, pks, msgs, sigs, bucket) -> np.ndarray:
        """The three stages back to back (warm-up)."""
        return self._finish(self._launch(self._prep(pks, msgs, sigs, bucket)), len(pks))

    async def warmup(self) -> None:
        """Build the kernel and run EVERY bucket before serving traffic, so
        the first real signature never waits for nvcc or a first launch.
        Each bucket carries one good and one tampered signature and must
        return exactly [True, False]; then one request goes through the
        full accumulate/flush path."""
        from .keys import SignKeyPair

        kp = SignKeyPair.from_hex("01" * 32)
        msg = b"verifier warmup"
        sig = kp.sign(msg)
        loop = asyncio.get_running_loop()
        if self.device.type == "cuda":
            await loop.run_in_executor(self._device_pool, cuda_verify.build)
        for bucket in self.buckets:
            out = await loop.run_in_executor(
                self._device_pool, self._run_batch,
                [kp.public, kp.public], [msg, msg + b"!"], [sig, sig], bucket,
            )
            if out.tolist() != [True, False]:
                raise RuntimeError(
                    f"verifier warm-up failed for bucket {bucket}: {out.tolist()}"
                )
        if not await self.verify(kp.public, msg, sig):
            raise RuntimeError("verifier warm-up batch failed to verify")

    @staticmethod
    def _fail_batch(batch: List[_Pending], exc: BaseException) -> None:
        """Resolve every sink of an abandoned batch (callers must never
        hang; close() cannot see batches already popped from _queue)."""
        err = (
            RuntimeError("verifier closed")
            if isinstance(exc, asyncio.CancelledError)
            else exc
        )
        for p in batch:
            p.sink.fail(err)

    async def _dispatch(self, batch: List[_Pending]) -> None:
        """Prep and launch this batch, then hand completion to a background
        task so the flusher can pipeline the next batch while the device
        works; at most PIPELINE_DEPTH batches run past launch."""
        bucket = self._bucket_for(len(batch))
        loop = asyncio.get_running_loop()
        pks = [p.public_key for p in batch]
        msgs = [p.message for p in batch]
        sigs = [p.signature for p in batch]

        # queue wait of the oldest item, observed before the depth gate:
        # waiting for an in-flight slot is queue time to the caller
        self.h_queue_wait.observe(self._clock.monotonic() - batch[0].enqueued_at)
        await self._inflight.acquire()
        if self.mode == "auto":
            self._routes.per_sig(len(batch))
        # the clock starts after the depth gate: dispatch latency is one
        # batch's prep -> results time, not its queue wait
        t0 = self._clock.monotonic()
        try:
            prepared = await loop.run_in_executor(
                self._prep_pool, self._prep, pks, msgs, sigs, bucket
            )
            t1 = self._clock.monotonic()
            self.total_prep_s += t1 - t0
            self.h_prep.observe(t1 - t0)
            handle = await loop.run_in_executor(self._device_pool, self._launch, prepared)
            t2 = self._clock.monotonic()
            self.total_launch_s += t2 - t1
            self.h_launch.observe(t2 - t1)
            finish = loop.run_in_executor(self._finish_pool, self._finish, handle, len(batch))
        except BaseException as exc:
            self._inflight.release()
            self._fail_batch(batch, exc)
            if isinstance(exc, asyncio.CancelledError):
                raise
            return
        task = loop.create_task(self._complete(batch, bucket, finish, t0))
        self._completions.add(task)
        task.add_done_callback(self._completions.discard)

    async def _complete(self, batch, bucket, finish, t0) -> None:
        t_fin = self._clock.monotonic()
        try:
            results = await finish
        except BaseException as exc:
            self._fail_batch(batch, exc)
            if isinstance(exc, asyncio.CancelledError):
                raise
            return
        finally:
            self._inflight.release()
        t_done = self._clock.monotonic()
        self.total_finish_s += t_done - t_fin
        self.h_finish.observe(t_done - t_fin)
        self.last_dispatch_s = t_done - t0
        self.total_dispatch_s += self.last_dispatch_s
        self.h_dispatch.observe(self.last_dispatch_s)
        self.batches_dispatched += 1
        self.signatures_verified += len(batch)
        self.total_padding += bucket - len(batch)
        for p, ok in zip(batch, results):
            p.sink.set(p.idx, bool(ok))

    async def close(self) -> None:
        self._closed = True
        # Wake parked _acquire callers FIRST, before draining in-flight
        # completions: a wedged device (a hung batch) can hold
        # the completion gather below forever, and a caller parked in
        # _cap_cond.wait() must get its "verifier closed" RuntimeError
        # now, not after a hang that never ends. They re-check _closed
        # under the condition and raise.
        async with self._cap_cond:
            self._cap_cond.notify_all()
        self._wakeup.set()
        self._flusher.cancel()
        try:
            await self._flusher
        except (asyncio.CancelledError, Exception):
            pass
        # drain in-flight completions: their batches already left _queue,
        # so only these tasks can resolve (or fail) those sinks
        if self._completions:
            await asyncio.gather(
                *list(self._completions), return_exceptions=True
            )
        for p in self._queue:
            p.sink.fail(RuntimeError("verifier closed"))
        released = len(self._queue)
        self._queue.clear()
        # return the dead queue's capacity and wake every caller parked in
        # _acquire (they re-check _closed under the condition and raise —
        # the notify matters even when released == 0)
        await self._release(released)
        for pool in (self._prep_pool, self._device_pool, self._finish_pool):
            pool.shutdown(wait=False, cancel_futures=True)


def make_verifier(kind: str, **kwargs) -> Verifier:
    """Config-driven verifier selection (``verifier = "cpu" | "cuda"``).
    ``"cuda"`` never falls back to the CPU: without a GPU it raises unless
    the caller passes ``device="cpu"``."""
    if kind == "cpu":
        return CpuVerifier(**kwargs)
    if kind == "cuda":
        return CudaBatchVerifier(**kwargs)
    raise ValueError(f"unknown verifier kind: {kind!r}")

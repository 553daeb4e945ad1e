"""The Verifier seam: the CPU verifier and the batched CUDA verifier.

Counterpart of ``at2_node_tpu/crypto/verifier.py``. Every signature a node
checks goes through an async :class:`Verifier`. :class:`CpuVerifier` checks
signatures on the CPU, as the reference's ``CpuVerifier`` does: per
signature (OpenSSL, on a thread pool or in one native bulk call), or, in
``mode="auto"`` (the default) for a clean flush of ``rlc_min_batch`` (128)
or more, with one random-linear-combination (RLC) check through the host
engine :class:`RlcEngine` (``native/at2_rlc.cpp``, g++), which bisects a
failing batch down to exact per-signature leaves. :class:`VerifyRouter`
makes that choice per flush from the batch size and a decaying
per-source failure rate. Verdicts are always the per-signature ones.

:class:`CudaBatchVerifier` is the port of ``TpuBatchVerifier``'s
per-signature path: it accumulates requests, pads a flush to a bucket of
its ladder, and runs each batch through a three-stage pipeline (host prep
and upload, kernel launch, completion) on three executor threads, so
consecutive batches overlap. A flush goes out when the queue reaches
``batch_size`` or when the oldest request has waited ``max_delay``,
whichever comes first; a backlog deeper than ``batch_size`` coalesces into
the largest bucket it can fill. Its RLC route (``ops/aggregate.py``, the
kernels of ``ops/cuda_rlc.py``) runs a flush as one classified RLC check
through the same three stages, and falls back to one exact per-signature
pass over the flush when the equation fails or a lane must be rerouted.
``mode="rlc"`` sends every flush there; ``auto`` does so only for flushes
of ``rlc_min_batch`` or more, and never without it, as on the reference's
device path.
"""

from __future__ import annotations

import asyncio
import contextlib
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, List, Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

from ..obs.registry import Histogram
from ..ops import aggregate as agg
from ..ops import cuda_rlc, cuda_verify
from ..ops import ed25519 as kernel
from .keys import verify_one

_MODE_CODES = {"per_sig": 0, "rlc": 1, "auto": 2}


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
    at2-node/src/bin/server/rpc.rs:125)."""

    def __init__(
        self,
        max_workers: int | None = None,
        mode: str = "auto",
        rlc_min_batch: int = 128,
    ) -> None:
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._max_workers = self._pool._max_workers
        self.signatures_verified = 0
        self.router = VerifyRouter(mode, min_batch=rlc_min_batch)
        self.engine = RlcEngine()

    @property
    def mode(self) -> str:
        return self.router.mode

    def stats(self) -> dict:
        return {
            "signatures": self.signatures_verified,
            "mode": _MODE_CODES[self.router.mode],
            "mode_name": self.router.mode,
            **self.router.stats(),
            **self.engine.stats(),
        }

    async def warmup(self) -> None:
        """Build/load the native ingest AND rlc libraries off the event
        loop (the bulk-verify and RLC paths use them; Broadcast.start
        covers the parse path for every verifier configuration)."""
        from ..native.ingest import ingest_available
        from ..native.rlc import rlc_available

        loop = asyncio.get_running_loop()
        await loop.run_in_executor(self._pool, ingest_available)
        if self.router.mode != "per_sig":
            await loop.run_in_executor(self._pool, rlc_available)

    async def verify(self, public_key: bytes, message: bytes, signature: bytes) -> bool:
        loop = asyncio.get_running_loop()
        self.signatures_verified += 1
        return await loop.run_in_executor(
            self._pool, verify_one, public_key, message, signature
        )

    async def verify_many(
        self, items: Sequence[Tuple[bytes, bytes, bytes]]
    ) -> List[bool]:
        """Bulk path: ONE executor round-trip and (when the native ingest
        library built) ONE C call for the whole chunk — OpenSSL grinds on
        native threads with the GIL released, fanned out across real
        cores C++-side instead of GIL-juggled Python slices. Falls back
        to per-slice Python verification otherwise."""
        loop = asyncio.get_running_loop()
        self.signatures_verified += len(items)
        n = len(items)
        if n == 0:
            return []

        from ..native.ingest import ingest_ready_or_kick, verify_bulk_native

        # Amortized route: ONE RLC check for the whole chunk
        # when the router says the batch is big and clean enough. The
        # engine resolves exact per-entry verdicts (bisection on batch
        # failure), so callers can't tell the routes apart except by
        # speed; verdict outcomes feed the router's per-source EWMA on
        # both routes.
        if self.router.mode != "per_sig":
            sources = [it[0] for it in items]
            route = self.router.choose(sources, rlc_ready=self.engine.ready())
            if route == "rlc":
                results = await loop.run_in_executor(
                    self._pool, self.engine.verify_batch, items
                )
                self.router.observe(list(zip(sources, results)))
                return results

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
            out = result.tolist()
            self._observe(items, out)
            return out

        slices = min(n, self._max_workers)
        step = (n + slices - 1) // slices

        def run(chunk):
            return [verify_one(pk, msg, sig) for pk, msg, sig in chunk]

        futs = [
            loop.run_in_executor(self._pool, run, items[i : i + step])
            for i in range(0, n, step)
        ]
        out = []
        for results in await asyncio.gather(*futs):
            out.extend(results)
        self._observe(items, out)
        return out

    def _observe(self, items, results: Sequence[bool]) -> None:
        """Per-sig verdicts still train the router's failure EWMA, so a
        salting source stays routed per-sig while misbehaving and decays
        back to RLC eligibility once it stops."""
        if self.router.mode == "auto":
            self.router.observe(
                [(it[0], bool(ok)) for it, ok in zip(items, results)]
            )

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


class VerifyRouter:
    """Per-flush routing between per-signature and RLC verification.

    Policy: route a flush to RLC only when (a) the engine is
    ready, (b) the batch is big enough that one RLC check beats B
    per-sig checks (the fixed torsion-round cost dominates small
    batches), and
    (c) the batch's *expected bad count* — the sum of a decaying
    per-source failure EWMA over its entries — stays under budget. A
    salting source drives its own EWMA toward 1 within one bad flush, so
    batches carrying its traffic fall back to per-sig cost immediately
    and recover (EWMA decays on clean observations) when it stops.
    """

    def __init__(
        self,
        mode: str = "auto",
        *,
        min_batch: int = 128,
        decay: float = 0.2,
        expected_bad_budget: float = 0.5,
        max_sources: int = 8192,
    ) -> None:
        if mode not in _MODE_CODES:
            raise ValueError(f"unknown verifier mode: {mode!r}")
        self.mode = mode
        self.min_batch = min_batch
        self.decay = decay
        self.expected_bad_budget = expected_bad_budget
        self.max_sources = max_sources
        self._fail_ewma: dict[bytes, float] = {}
        self._lock = threading.Lock()
        self.route_rlc = 0
        self.route_per_sig = 0
        self.last_route = "per_sig"
        self.last_batch = 0
        self.last_expected_bad = 0.0
        # routing DISTRIBUTIONS: lanes per flush by chosen route — the
        # crossover evidence /metrics needs (a healthy auto node shows
        # rlc lanes clustered at full buckets, per-sig at trickles)
        self.h_rlc_lanes = Histogram("route_rlc_lanes", "lanes per RLC-routed flush")
        self.h_per_sig_lanes = Histogram(
            "route_per_sig_lanes", "lanes per per-sig-routed flush"
        )

    def expected_bad(self, sources: Sequence[bytes]) -> float:
        ewma = self._fail_ewma
        return sum(ewma.get(s, 0.0) for s in sources)

    def choose(
        self, sources: Sequence[bytes], *, rlc_ready: bool = True
    ) -> str:
        """Route one flush: ``"rlc"`` or ``"per_sig"``."""
        n = len(sources)
        if self.mode == "per_sig" or not rlc_ready:
            route = "per_sig"
            exp_bad = 0.0
        elif self.mode == "rlc":
            route = "rlc"
            exp_bad = 0.0
        else:
            exp_bad = self.expected_bad(sources)
            route = (
                "rlc"
                if n >= self.min_batch and exp_bad <= self.expected_bad_budget
                else "per_sig"
            )
        with self._lock:
            if route == "rlc":
                self.route_rlc += 1
                self.h_rlc_lanes.observe(float(n))
            else:
                self.route_per_sig += 1
                self.h_per_sig_lanes.observe(float(n))
            self.last_route = route
            self.last_batch = n
            self.last_expected_bad = exp_bad
        return route

    def observe(self, outcomes: Sequence[Tuple[bytes, bool]]) -> None:
        """Feed per-entry verdicts back into the per-source failure EWMA
        (both routes observe, so a salter stays hot even while its
        traffic runs per-sig, and decays back once it behaves)."""
        d = self.decay
        with self._lock:
            ewma = self._fail_ewma
            for src, ok in outcomes:
                p = ewma.get(src, 0.0)
                p += d * ((0.0 if ok else 1.0) - p)
                if p < 1e-4:
                    ewma.pop(src, None)
                else:
                    ewma[src] = p
            while len(ewma) > self.max_sources:
                # bounded state: drop the coldest source
                coldest = min(ewma, key=ewma.get)
                del ewma[coldest]

    def hot_sources(self, threshold: float = 0.1) -> int:
        with self._lock:
            return sum(1 for p in self._fail_ewma.values() if p > threshold)

    def stats(self) -> dict:
        with self._lock:
            return {
                "route_rlc": self.route_rlc,
                "route_per_sig": self.route_per_sig,
                "route_last": self.last_route,
                "route_last_batch": self.last_batch,
                "route_last_expected_bad": round(self.last_expected_bad, 4),
                "router_sources": len(self._fail_ewma),
                **self.h_rlc_lanes.flat("route_rlc_lanes"),
                **self.h_per_sig_lanes.flat("route_per_sig_lanes"),
            }


class RlcEngine:
    """CPU RLC batch verification with bisection fallback (sync; callers
    run it on executor threads — the native calls release the GIL).

    One :meth:`verify_batch` call resolves exact per-entry verdicts:

    1. prepare (shared host prep: s-range checks, h = SHA-512 mod L);
    2. certify public keys through the per-key cache — exact [L]A once
       per distinct key; lanes whose A is tainted/undecodable reroute to
       the exact per-sig path (their cofactorless verdict can differ
       from any batched check, so they never enter the RLC equation);
    3. ONE native RLC check (equation + randomized R-torsion rounds)
       over the remaining lanes;
    4. on failure, bisect: recursively split and re-check halves with
       fresh randomness until sub-batches pass whole or shrink to
       ``leaf_size``, then resolve leaves exactly per-signature — a
       poison entry costs ~2·log2(B/leaf) extra checks, everyone else
       still verifies amortized.

    ``check_fn``/``leaf_fn`` are injectable for tests (check counting
    without curve work).
    """

    def __init__(
        self,
        *,
        leaf_size: int = 16,
        k_rounds: int | None = None,
        cert_cache_max: int = 65536,
        check_fn: Optional[Callable] = None,
        leaf_fn: Optional[Callable] = None,
    ) -> None:
        from ..native import rlc as rlc_native

        self._rlc = rlc_native
        self.leaf_size = leaf_size
        self.k_rounds = (
            k_rounds if k_rounds is not None else rlc_native.TORSION_ROUNDS
        )
        self.cert_cache_max = cert_cache_max
        self._check_fn = check_fn
        self._leaf_fn = leaf_fn
        self._cert: dict[bytes, int] = {}
        self._lock = threading.Lock()
        # counters (locked: CpuVerifier's pool may run two batches at once)
        self.rlc_batches = 0
        self.rlc_fallbacks = 0
        self.rlc_checks = 0
        self.rlc_sigs = 0
        self.rlc_anomalies = 0
        self.bisection_depth = 0
        self.leaf_sigs = 0
        self.cert_misses = 0
        self.exact_reroutes = 0

    def stats(self) -> dict:
        with self._lock:
            return {
                "rlc_batches": self.rlc_batches,
                "rlc_fallbacks": self.rlc_fallbacks,
                "rlc_checks": self.rlc_checks,
                "rlc_sigs": self.rlc_sigs,
                "rlc_anomalies": self.rlc_anomalies,
                "bisection_depth": self.bisection_depth,
                "leaf_sigs": self.leaf_sigs,
                "certified_keys": len(self._cert),
                "cert_misses": self.cert_misses,
                "exact_reroutes": self.exact_reroutes,
            }

    def ready(self) -> bool:
        return self._rlc.rlc_ready_or_kick()

    # -- certification cache ---------------------------------------------

    def _certify(self, pks: Sequence[bytes]) -> np.ndarray:
        """Per-lane verdicts from the cache: True when the key's A is
        certified torsion-free (safe for the RLC equation)."""
        cache = self._cert
        misses: list[bytes] = []
        seen: set = set()
        for pk in pks:
            if pk not in cache and pk not in seen:
                seen.add(pk)
                misses.append(pk)
        if misses:
            verdicts = self._rlc.certify_keys(misses)
            with self._lock:
                self.cert_misses += len(misses)
                for pk, v in zip(misses, verdicts):
                    cache[pk] = int(v)
                while len(cache) > self.cert_cache_max:
                    cache.pop(next(iter(cache)))
        return np.fromiter(
            (cache.get(pk, 0) == 2 for pk in pks), dtype=bool, count=len(pks)
        )

    # -- checking --------------------------------------------------------

    def _check(self, prep, idxs: np.ndarray):
        """One RLC check over the lanes in ``idxs``. Returns
        (batch_ok, decomp_ok-over-idxs)."""
        a, r, s_le, h_le, _valid = prep
        with self._lock:
            self.rlc_checks += 1
        if self._check_fn is not None:
            return self._check_fn(prep, idxs)
        sub_valid = np.ones(len(idxs), dtype=bool)
        return self._rlc.rlc_check(
            r[idxs], a[idxs], s_le[idxs], h_le[idxs], sub_valid,
            k_rounds=self.k_rounds,
        )

    def _leaf(self, items, idxs: np.ndarray, verdicts: np.ndarray) -> None:
        """Exact per-signature resolution of a bisection leaf."""
        with self._lock:
            self.leaf_sigs += len(idxs)
        if self._leaf_fn is not None:
            res = self._leaf_fn(items, idxs)
        else:
            from ..native.ingest import ingest_available, verify_bulk_native

            chunk = [items[int(i)] for i in idxs]
            if ingest_available():
                res = verify_bulk_native(chunk, 1)
            else:
                res = [verify_one(pk, m, s) for pk, m, s in chunk]
        for i, ok in zip(idxs, res):
            verdicts[int(i)] = bool(ok)

    def _bisect(
        self, prep, items, idxs: np.ndarray, verdicts: np.ndarray, depth: int
    ) -> None:
        """Resolve ``idxs`` (known to have failed a check) exactly."""
        with self._lock:
            if depth > self.bisection_depth:
                self.bisection_depth = depth
        if len(idxs) <= self.leaf_size:
            self._leaf(items, idxs, verdicts)
            return
        mid = len(idxs) // 2
        halves = (idxs[:mid], idxs[mid:])
        results = []
        for half in halves:
            ok, decomp = self._check(prep, half)
            results.append((half, ok, decomp))
        if all(ok for _, ok, _ in results):
            # the parent failed but both halves pass: a torsion round
            # fired on the parent and missed on both halves (probability
            # 2^-k each) — resolve everything exactly rather than trust
            # either verdict
            with self._lock:
                self.rlc_anomalies += 1
            self._leaf(items, idxs, verdicts)
            return
        for half, ok, decomp in results:
            if ok:
                verdicts[half[decomp]] = True  # non-decomp lanes stay False
            else:
                sub = half[decomp]
                if len(sub):
                    self._bisect(prep, items, sub, verdicts, depth + 1)

    def verify_batch(
        self, items: Sequence[Tuple[bytes, bytes, bytes]]
    ) -> List[bool]:
        """Exact per-entry verdicts for one flush, RLC-amortized."""
        from ..ops import ed25519 as ed_ops

        n = len(items)
        pks = [it[0] for it in items]
        msgs = [it[1] for it in items]
        sigs = [it[2] for it in items]
        prep = ed_ops.prepare_batch(pks, msgs, sigs)
        a, r, s_le, h_le, valid = prep
        verdicts = np.zeros(n, dtype=bool)

        if self._check_fn is None:
            cert_ok = self._certify(pks)
        else:
            cert_ok = np.ones(n, dtype=bool)
        rlc_lanes = np.flatnonzero(valid[:n] & cert_ok)
        exact_lanes = np.flatnonzero(valid[:n] & ~cert_ok)
        with self._lock:
            self.rlc_batches += 1
            self.rlc_sigs += len(rlc_lanes)
            self.exact_reroutes += len(exact_lanes)

        if len(rlc_lanes) <= self.leaf_size:
            # not enough amortizable lanes to beat per-sig: resolve exact
            if len(rlc_lanes):
                self._leaf(items, rlc_lanes, verdicts)
        else:
            ok, decomp = self._check(prep, rlc_lanes)
            if ok:
                verdicts[rlc_lanes[decomp]] = True
            else:
                with self._lock:
                    self.rlc_fallbacks += 1
                sub = rlc_lanes[decomp]
                if len(sub):
                    self._bisect(prep, items, sub, verdicts, 1)
        if len(exact_lanes):
            self._leaf(items, exact_lanes, verdicts)
        return verdicts.tolist()


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

    A flush the router sends to RLC runs ``_prep_rlc``, ``_launch_rlc`` and
    ``_finish_rlc`` in their place, and ``_resolve_rlc`` turns its (eq_ok,
    codes) into exact verdicts. Up to ``PIPELINE_DEPTH`` batches are in
    flight past launch. Each stage
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

        self.device = cuda_verify.resolve_device(device)
        # the reference's device default: auto never routes a flush to RLC
        # unless the operator opts in with rlc_min_batch; "rlc" forces it
        self.router = VerifyRouter(
            mode, min_batch=rlc_min_batch if rlc_min_batch is not None else 1 << 30
        )
        self.rlc_batches = 0
        self.rlc_fallbacks = 0
        self.rlc_reroutes = 0
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
        self._rlc_staging = kernel.StagingPool(
            pinned=self.device.type == "cuda", width=agg.RLC_PACKED_WIDTH
        )
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
            "mode": _MODE_CODES[self.router.mode],
            "mode_name": self.router.mode,
            "rlc_batches": self.rlc_batches,
            "rlc_fallbacks": self.rlc_fallbacks,
            "rlc_reroutes": self.rlc_reroutes,
            **self.router.stats(),
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
        """The three stages back to back (warm-up, and the exact pass of a
        failed RLC flush)."""
        return self._finish(self._launch(self._prep(pks, msgs, sigs, bucket)), len(pks))

    def _staged_overrides_consistent(self) -> bool:
        """True when the staged pipeline is this instance's verify logic:
        nothing is overridden, or the stages are. A subclass that overrides
        only ``_run_batch`` must not be bypassed by the stages."""
        cls = type(self)
        run_overridden = cls._run_batch is not CudaBatchVerifier._run_batch
        stages_overridden = (
            cls._prep is not CudaBatchVerifier._prep
            or cls._launch is not CudaBatchVerifier._launch
        )
        return stages_overridden or not run_overridden

    # -- RLC stages: the same three threads, but the device runs one
    # classified RLC check (ops/aggregate.py) instead of the per-signature
    # kernel; _resolve_rlc interprets its (eq_ok, codes) ---------------------

    def _prep_rlc(self, pks, msgs, sigs, bucket):
        with self._device_ctx():
            host = agg.rlc_prep(pks, msgs, sigs, bucket, self._rlc_staging)
            return agg.rlc_upload(host, self.device, self._copy_stream)

    def _launch_rlc(self, uploaded):
        with self._device_ctx():
            return agg.rlc_launch(uploaded, self._compute_stream)

    def _finish_rlc(self, handle, n: int):
        with self._device_ctx():
            return agg.rlc_finish(handle, n, self._rlc_staging)

    def _run_batch_rlc(self, pks, msgs, sigs, bucket):
        return self._finish_rlc(
            self._launch_rlc(self._prep_rlc(pks, msgs, sigs, bucket)), len(pks)
        )

    async def warmup(self) -> None:
        """Build the kernels and run EVERY bucket before serving traffic, so
        the first real signature never waits for nvcc or a first launch.
        Each bucket carries one good and one tampered signature and must
        return exactly [True, False]; where the router can route to RLC, the
        RLC stages must give eq_ok with code 1 for the good signature alone
        and no eq_ok with the tampered one beside it. Then one request goes
        through the full accumulate/flush path."""
        from .keys import SignKeyPair

        kp = SignKeyPair.from_hex("01" * 32)
        msg = b"verifier warmup"
        sig = kp.sign(msg)
        pks, msgs, sigs = [kp.public, kp.public], [msg, msg + b"!"], [sig, sig]
        loop = asyncio.get_running_loop()
        # whether the router can send a flush to RLC at all (never past a
        # subclass's own _run_batch)
        mode = self.router.mode
        warm_rlc = (
            mode == "rlc" or (mode == "auto" and self.router.min_batch < (1 << 30))
        ) and self._staged_overrides_consistent()
        if self.device.type == "cuda":
            await loop.run_in_executor(self._device_pool, cuda_verify.build)
            if warm_rlc:
                await loop.run_in_executor(self._device_pool, cuda_rlc.build)
        for bucket in self.buckets:
            out = await loop.run_in_executor(
                self._device_pool, self._run_batch, pks, msgs, sigs, bucket
            )
            if out.tolist() != [True, False]:
                raise RuntimeError(
                    f"verifier warm-up failed for bucket {bucket}: {out.tolist()}"
                )
            if warm_rlc:
                good = await loop.run_in_executor(
                    self._device_pool, self._run_batch_rlc, pks[:1], msgs[:1], sigs[:1], bucket
                )
                both = await loop.run_in_executor(
                    self._device_pool, self._run_batch_rlc, pks, msgs, sigs, bucket
                )
                if not (good[0] and good[1].tolist() == [1]) or both[0]:
                    raise RuntimeError(
                        f"rlc warm-up failed for bucket {bucket}: {good}, {both}"
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
        # route this flush: per dispatch, from its size and the per-source
        # failure rates; per_sig mode, and a subclass that overrides only
        # _run_batch, always take the per-signature path
        staged = self._staged_overrides_consistent()
        rlc = self.router.mode != "per_sig" and staged and self.router.choose(pks) == "rlc"
        # the clock starts after the depth gate: dispatch latency is one
        # batch's prep -> results time, not its queue wait
        t0 = self._clock.monotonic()
        try:
            if staged:
                prepared = await loop.run_in_executor(
                    self._prep_pool, self._prep_rlc if rlc else self._prep, pks, msgs, sigs, bucket
                )
                t1 = self._clock.monotonic()
                self.total_prep_s += t1 - t0
                self.h_prep.observe(t1 - t0)
                handle = await loop.run_in_executor(
                    self._device_pool, self._launch_rlc if rlc else self._launch, prepared
                )
                t2 = self._clock.monotonic()
                self.total_launch_s += t2 - t1
                self.h_launch.observe(t2 - t1)
                finish = loop.run_in_executor(
                    self._finish_pool, self._finish_rlc if rlc else self._finish, handle, len(batch)
                )
            else:
                # the subclass's _run_batch, whole, on the device thread (no
                # stage overlap; the depth bound still queues batches)
                finish = loop.run_in_executor(
                    self._device_pool, self._run_batch, pks, msgs, sigs, bucket
                )
        except BaseException as exc:
            self._inflight.release()
            self._fail_batch(batch, exc)
            if isinstance(exc, asyncio.CancelledError):
                raise
            return
        task = loop.create_task(self._complete(batch, bucket, finish, t0, rlc))
        self._completions.add(task)
        task.add_done_callback(self._completions.discard)

    async def _resolve_rlc(self, batch, bucket, out) -> np.ndarray:
        """Exact per-lane verdicts from an RLC flush's (eq_ok, codes): the
        codes themselves when the equation holds and no lane is rerouted,
        else one exact per-signature kernel pass over the same flush (on the
        card one launch resolves every lane, so it is the whole bisection).
        Runs while the flush still holds its pipeline slot."""
        eq_ok, codes = out
        self.rlc_batches += 1
        reroutes = int((codes == 2).sum())
        self.rlc_reroutes += reroutes
        if eq_ok and not reroutes:
            results = codes == 1
        else:
            self.rlc_fallbacks += 1
            loop = asyncio.get_running_loop()
            pks = [p.public_key for p in batch]
            msgs = [p.message for p in batch]
            sigs = [p.signature for p in batch]
            results = await loop.run_in_executor(
                self._device_pool, self._run_batch, pks, msgs, sigs, bucket
            )
        if self.router.mode == "auto":
            self.router.observe([(p.public_key, bool(ok)) for p, ok in zip(batch, results)])
        return results

    async def _complete(self, batch, bucket, finish, t0, rlc=False) -> None:
        t_fin = self._clock.monotonic()
        try:
            results = await finish
            if rlc:
                results = await self._resolve_rlc(batch, bucket, results)
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
    """Config-driven verifier selection (``verifier = "cpu" | "cuda" |
    "pool"``). ``"cuda"`` and ``"pool"`` never fall back to the CPU: without
    a GPU they raise unless the caller passes ``device="cpu"`` (``"cuda"``)
    or ``devices=["cpu"] * k`` (``"pool"``)."""
    if kind == "cpu":
        return CpuVerifier(**kwargs)
    if kind == "cuda":
        return CudaBatchVerifier(**kwargs)
    if kind == "pool":
        from ..parallel.pool import PoolVerifier

        return PoolVerifier(**kwargs)
    raise ValueError(f"unknown verifier kind: {kind!r}")

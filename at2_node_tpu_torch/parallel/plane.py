"""PlaneExecutor seam: where sharded broadcast drain work runs.

Counterpart of ``at2_node_tpu/parallel/plane.py``.

The sharded plane (broadcast/shards.py) partitions slot state by origin
key and needs two things from the runtime: a place to run each shard's
drain closure, and a bounded handoff lane for the effects a shard
produces (outbound frames, delivered payloads, stall kicks) that must be
applied on the owner event loop. This module provides both behind a
seam small enough that the sim can substitute a synchronous executor
and keep the whole plane deterministic:

- ``InlinePlaneExecutor`` runs shard closures synchronously on the
  caller. One logical worker, no threads, no reordering — this is what
  ``SimScheduler``-driven nodes use, and why the same-seed campaign
  hash is identical at shards=1 and shards=4.
- ``ThreadPlaneExecutor`` pins one OS thread per shard (single-thread
  pool each, so shard state is confined to exactly one thread for its
  lifetime). Python-level work still serializes on the GIL; the
  scaling comes from the native quorum/parse kernels releasing it.
- ``ProcessPlaneExecutor`` breaks the GIL outright: one spawn worker
  process per shard, each owning its whole shard core
  (parallel/plane_worker.py), with a pair of fixed-slot shared-memory
  rings per shard (parallel/ring.py) as the only channel. The owner
  loop routes flat wire records in and applies flat effect records
  out; Python-level shard work (admission, quorum transitions, the
  verify term itself) runs on genuinely independent cores.
- ``SPSCQueue`` is the bounded single-producer single-consumer lane a
  THREAD shard uses to hand effects back to the owner loop: same
  address space, so records are plain object references and the GIL
  makes deque ops atomic — serializing them through a byte ring would
  only add copies. Process shards use ``ShmRing``, the cross-address-
  space twin with the same drop-accounted, latency-instrumented
  contract. The plane's protocol lanes never drop: a thread shard's lane
  is unbounded (the owner drains it right after each shard's work), and
  a process shard's actions and effects rings spill what does not fit
  into their producer's backlog (``ShmRing.spill``). Both feed the same
  ``plane_shard_handoff_ns`` histogram and ``effects_dropped`` export.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
import time
from collections import deque
from typing import Any, Callable, List, Tuple

from .ring import ShmRing


class SPSCQueue:
    """Bounded single-producer single-consumer handoff queue.

    One shard thread puts, the owner loop drains. Under CPython's GIL a
    deque's append/popleft are atomic, so no lock is needed for the
    1-producer/1-consumer discipline this class documents. ``put``
    returns False when the queue is full — the producer decides whether
    to spin, drop, or run the effect degraded; it must not block the
    shard drain loop on the owner.
    """

    __slots__ = ("_q", "_cap", "_dropped")

    def __init__(self, capacity: int = 4096):
        if capacity <= 0:
            raise ValueError("SPSCQueue capacity must be positive")
        self._q: deque = deque()
        self._cap = capacity
        self._dropped = 0

    def put(self, item: Any) -> bool:
        if len(self._q) >= self._cap:
            self._dropped += 1
            return False
        self._q.append((time.perf_counter_ns(), item))
        return True

    def drain(self, max_items: int = 0) -> Tuple[List[Any], int]:
        """Pop up to ``max_items`` entries (0 = all currently visible).

        Returns ``(items, max_handoff_ns)`` where the second element is
        the oldest enqueue-to-drain latency seen in this drain — the
        number /metrics reports as ``plane_shard_handoff_ns``.
        """
        out: List[Any] = []
        worst = 0
        now = time.perf_counter_ns()
        n = len(self._q) if max_items <= 0 else min(max_items, len(self._q))
        for _ in range(n):
            try:
                t0, item = self._q.popleft()
            except IndexError:  # racing producer-side len() snapshot
                break
            dt = now - t0
            if dt > worst:
                worst = dt
            out.append(item)
        return out, worst

    def __len__(self) -> int:
        return len(self._q)

    @property
    def dropped(self) -> int:
        return self._dropped


class InlinePlaneExecutor:
    """Synchronous executor: shard closures run on the caller, in call
    order. This is the deterministic path — the sim drives every shard
    from one logical worker, so wire behavior is byte-identical to the
    monolithic plane."""

    name = "inline"

    def __init__(self, shards: int = 1):
        self.shards = shards

    def submit(
        self, shard_id: int, fn: Callable[..., Any], *args: Any
    ) -> "concurrent.futures.Future":
        fut: concurrent.futures.Future = concurrent.futures.Future()
        try:
            fut.set_result(fn(*args))
        except BaseException as exc:  # noqa: BLE001 - mirrored to future
            fut.set_exception(exc)
        return fut

    def shutdown(self) -> None:
        pass


class ThreadPlaneExecutor:
    """One OS thread per shard. Each shard gets its own single-thread
    pool so its slot state is only ever touched from that thread —
    confinement, not locking, is the memory model. The owner loop
    awaits the returned futures (wrapped via asyncio) and applies the
    shard's queued effects afterwards."""

    name = "thread"

    def __init__(self, shards: int):
        if shards <= 0:
            raise ValueError("ThreadPlaneExecutor needs >= 1 shard")
        self.shards = shards
        self._pools = [
            concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix=f"plane-shard-{i}"
            )
            for i in range(shards)
        ]

    def submit(
        self, shard_id: int, fn: Callable[..., Any], *args: Any
    ) -> "concurrent.futures.Future":
        return self._pools[shard_id].submit(fn, *args)

    def shutdown(self) -> None:
        for p in self._pools:
            p.shutdown(wait=False, cancel_futures=True)


class ProcessPlaneExecutor:
    """One spawn worker PROCESS per shard — true parallelism.

    The executor owns the per-shard ring pair (actions owner->worker,
    effects worker->owner) and the worker lifecycle; the sharded plane
    owns the protocol (what goes into the rings and how effects apply).
    Spawn, not fork: the owner runs an event loop, executor threads and
    (on a GPU host) a CUDA context, none of which survive a fork — spawn
    children import fresh from a picklable :class:`WorkerSpec`.

    Lifecycle contract (production-shaped):

    * ``shutdown()`` sends every live worker a SHUTDOWN record, joins
      with a bounded timeout, terminates stragglers, and unlinks the
      rings — a clean exit leaves nothing in /dev/shm;
    * ``poll_crashed()`` reports workers that died UNINVITED (exitcode
      without a shutdown in flight) exactly once each, so the plane can
      flip /healthz degraded with shard attribution instead of hanging;
    * workers reap themselves if the owner dies (the getppid check in
      plane_worker.worker_main) — orphan processes never accumulate.
    """

    name = "process"

    def __init__(
        self,
        shards: int,
        *,
        ring_slots: int = 4096,
        ring_slot_bytes: int = 1024,
    ):
        if shards <= 0:
            raise ValueError("ProcessPlaneExecutor needs >= 1 shard")
        self.shards = shards
        self.ring_slots = ring_slots
        self.ring_slot_bytes = ring_slot_bytes
        self.actions: List[ShmRing] = []
        self.effects: List[ShmRing] = []
        self.obs: List[ShmRing] = []
        self._procs: list = []
        self._crashed: dict = {}  # sid -> exitcode, reported once
        self._closing = False
        self._started = False

    def start(self, make_spec: Callable[[int, str, str, str], Any]) -> None:
        """Create the rings, then spawn one worker per shard.
        ``make_spec(shard_id, actions_ring, effects_ring, obs_ring)``
        builds the picklable spec (broadcast/shards.py supplies it)."""
        if self._started:
            return
        self._started = True
        from .plane_worker import worker_main

        base = f"at2pl-{os.getpid()}-{os.urandom(3).hex()}"
        for sid in range(self.shards):
            self.actions.append(ShmRing(
                f"{base}-a{sid}", slots=self.ring_slots,
                slot_bytes=self.ring_slot_bytes, create=True,
            ))
            # the owner never drops a protocol record for a worker: what
            # does not fit waits in its backlog (flushed by the plane's
            # effects loop)
            self.actions[-1].spill = True
            self.effects.append(ShmRing(
                f"{base}-e{sid}", slots=self.ring_slots,
                slot_bytes=self.ring_slot_bytes, create=True,
            ))
            # dedicated observability lane (worker -> owner): phase /
            # recorder / trace / folded-stack delta records must never
            # compete with protocol effects for ring capacity
            self.obs.append(ShmRing(
                f"{base}-o{sid}", slots=self.ring_slots,
                slot_bytes=self.ring_slot_bytes, create=True,
            ))
        ctx = multiprocessing.get_context("spawn")
        for sid in range(self.shards):
            proc = ctx.Process(
                target=worker_main,
                args=(make_spec(
                    sid, self.actions[sid].name, self.effects[sid].name,
                    self.obs[sid].name,
                ),),
                daemon=True,
                name=f"plane-shard-{sid}",
            )
            proc.start()
            self._procs.append(proc)

    def alive(self, shard_id: int) -> bool:
        return (
            shard_id < len(self._procs) and self._procs[shard_id].is_alive()
        )

    def poll_crashed(self) -> List[Tuple[int, int]]:
        """Newly-dead workers as ``(shard_id, exitcode)``, each reported
        exactly once. Empty during/after an intentional shutdown."""
        if self._closing or not self._started:
            return []
        out = []
        for sid, proc in enumerate(self._procs):
            if sid not in self._crashed and not proc.is_alive():
                code = proc.exitcode if proc.exitcode is not None else -1
                self._crashed[sid] = code
                out.append((sid, code))
        return out

    @property
    def crashed(self) -> dict:
        """All shard crashes seen so far: ``{shard_id: exitcode}``."""
        return dict(self._crashed)

    def submit(self, shard_id: int, fn, *args):
        raise RuntimeError(
            "process plane shards run in workers, not owner closures"
        )

    def stop_workers(self) -> None:
        """Send SHUTDOWN, join with a bounded timeout, terminate
        stragglers. Rings stay open so the caller can drain the final
        state flush the workers emit on the way out."""
        if self._closing:
            return
        self._closing = True
        from .plane_worker import C_SHUTDOWN

        for sid, proc in enumerate(self._procs):
            if proc.is_alive():
                self.actions[sid].put(C_SHUTDOWN, b"")
        # a SHUTDOWN behind a backlog reaches its worker once the worker
        # drains what is ahead of it
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline and not all(
            ring.flush() or not proc.is_alive()
            for ring, proc in zip(self.actions, self._procs)
        ):
            time.sleep(0.001)
        for proc in self._procs:
            proc.join(timeout=2.0)
            if proc.is_alive():  # pragma: no cover - stuck worker
                proc.terminate()
                proc.join(timeout=1.0)

    def shutdown(self) -> None:
        self.stop_workers()
        for ring in (*self.actions, *self.effects, *self.obs):
            ring.close()
        self.actions = []
        self.effects = []
        self.obs = []


def make_plane_executor(
    kind: str,
    shards: int,
    *,
    ring_slots: int = 4096,
    ring_slot_bytes: int = 1024,
):
    """Factory behind the config seam: ``[plane] executor = ...``."""
    if kind == "inline":
        return InlinePlaneExecutor(shards)
    if kind == "thread":
        return ThreadPlaneExecutor(shards)
    if kind == "process":
        return ProcessPlaneExecutor(
            shards, ring_slots=ring_slots, ring_slot_bytes=ring_slot_bytes
        )
    raise ValueError(f"unknown plane executor {kind!r}")

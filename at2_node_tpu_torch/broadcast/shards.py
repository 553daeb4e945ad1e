"""Sharded broadcast plane: per-origin slot shards behind one ingress.

Counterpart of ``at2_node_tpu/broadcast/shards.py``.

The monolithic :class:`~.stack.Broadcast` runs every slot state machine
on the event loop, which caps plane-only capacity at one core no matter
how many the host has. This module partitions that state by ORIGIN KEY —
the first key of every slot: client sender for the per-tx plane, batch
origin for the batch plane — into N full :class:`Broadcast` cores, each
owning a disjoint slice of quorum bitmaps, dedup sets, slot GC, and
poison resolution. Partitioning by the slot's own key means every
message about a given slot lands on the same shard, so no per-slot state
is ever shared and the cores need no locks.

What stays on the owner loop (cross-shard concerns):

* ingress: ONE inbox, one parse pass (native ingest when available),
  and ONE bulk ``verify_many`` per drain cycle across all shards — the
  batched verifier keeps its amortization regardless of shard count;
* the delivered queue the service's commit tail consumes (commit-tail
  ordering is whatever order shard effects are applied in, exactly as
  the monolithic plane's was worker-chunk order);
* the entry registry — the (client sender, seq) -> first-endorsed-entry
  equivocation guard spans BOTH planes, and a client's per-tx slots and
  the node batches carrying that client's entries can hash to different
  shards, so the registry is one shared structure injected into every
  core;
* membership epochs, watermark export (merged), stats (one shared
  counter group), and the stall-kick signal.

Executor seam (parallel/plane.py): ``inline`` runs every shard closure
synchronously on the caller IN ARRIVAL ORDER — one logical worker, so
the wire behavior is byte-identical to the monolithic plane and the
same-seed sim campaign hash is IDENTICAL at shards=1 and shards=4
(pinned by the plane-shard tests). ``thread`` pins one OS thread per shard;
Python-level transitions still serialize on the GIL, so the real-host
scaling comes from the GIL-released native kernels (quorum counting,
parse, verify) overlapping across shards. Shard threads never touch the
mesh or the delivered queue directly: effects are handed back through
bounded SPSC queues and applied by the owner loop after each dispatch.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import struct
import sys
from collections import deque
from typing import Dict, List, Optional

from ..parallel import plane_worker as pw
from ..parallel.plane import SPSCQueue, make_plane_executor
from ..parallel.plane_worker import STAT_KEYS, WorkerSpec
from .messages import (
    BATCH,
    BATCH_ECHO,
    BATCH_READY,
    BATCH_REQ,
    ECHO,
    GOSSIP,
    READY,
    REQUEST,
    Attestation,
    BatchAttestation,
    BatchContentRequest,
    ContentRequest,
    Payload,
    TxBatch,
)
from .stack import (
    GC_INTERVAL,
    INBOX_MAX_BYTES,
    RETRANSMIT_BUDGET_PER_PASS,
    STALL_KICK_MIN_INTERVAL,
    WORKER_CHUNK,
    Broadcast,
)

# wire kinds whose state lives on a shard core (everything else is
# control plane, dispatched on the owner through core 0's handlers)
_SLOT_KINDS = frozenset(
    (GOSSIP, ECHO, READY, REQUEST, BATCH, BATCH_ECHO, BATCH_READY, BATCH_REQ)
)
_SLOT_TYPES = (
    Payload,
    Attestation,
    TxBatch,
    BatchAttestation,
    ContentRequest,
    BatchContentRequest,
)

logger = logging.getLogger(__name__)

__all__ = ["ShardedPlane", "shard_of"]

# plane_shard_handoff_ns histogram ladder: 1µs .. ~33s, in ns.
_HANDOFF_BOUNDS = tuple(1e3 * 2.0**i for i in range(26))


def shard_of(key: bytes, shards: int) -> int:
    """Stable origin-key -> shard map. The first 8 bytes of an ed25519
    key are uniform, so a modulus spreads origins evenly; stability (no
    dependence on arrival order or shard load) is what makes the
    partition deterministic and the sim hash shard-count-invariant."""
    return int.from_bytes(key[:8], "little") % shards


class _ShardMesh:
    """Mesh facade for a THREADED shard core: reads delegate, sends are
    queued as effects for the owner loop (mesh transports are event-loop
    affine and must not be touched from shard threads)."""

    __slots__ = ("_real", "_effects")

    def __init__(self, real, effects: SPSCQueue) -> None:
        self._real = real
        self._effects = effects

    @property
    def peers(self):
        return self._real.peers

    @property
    def by_sign(self):
        return self._real.by_sign

    def send(self, peer, data: bytes) -> None:
        self._effects.put(("send", peer, data))

    def broadcast(self, data: bytes) -> None:
        self._effects.put(("broadcast", data))


class _ShardDelivered:
    """Delivered-queue facade for a THREADED shard core: deliveries are
    effects, re-put into the real asyncio queue by the owner."""

    __slots__ = ("_effects",)

    def __init__(self, effects: SPSCQueue) -> None:
        self._effects = effects

    def put_nowait(self, payload) -> None:
        self._effects.put(("deliver", payload))


class ShardedPlane:
    """N per-origin :class:`Broadcast` shard cores behind one ingress.

    Drop-in for :class:`Broadcast` at the service seam: same
    constructor shape (plus ``shards`` / ``executor``), same public
    surface (``on_frame``/``broadcast``/``broadcast_batch``/
    ``delivered``/``stats``/handler hooks/watermarks/thresholds).
    ``shards=1`` deployments should keep constructing ``Broadcast``
    directly (node/service.py does) — this class earns its overhead
    only when there are cores to spread across.
    """

    def __init__(
        self,
        keypair,
        mesh,
        verifier,
        *,
        shards: int = 2,
        executor: str = "thread",
        echo_threshold: Optional[int] = None,
        ready_threshold: Optional[int] = None,
        workers: int = 4,
        registry=None,
        trace=None,
        recorder=None,
        clock=None,
        phases=None,
        overlap_ready: bool = False,
        ring_slots: int = 4096,
        ring_slot_bytes: int = 1024,
        worker_profiler: bool = True,
        profiler_hz: float = 97.0,
        profiler_max_nodes: int = 20000,
        obs_flush_s: float = 0.05,
    ) -> None:
        from ..clock import SYSTEM_CLOCK
        from ..obs.registry import Registry

        if shards <= 0:
            raise ValueError("ShardedPlane needs >= 1 shard")
        self.shards = shards
        self.keypair = keypair
        self.mesh = mesh
        self.verifier = verifier
        self.clock = SYSTEM_CLOCK if clock is None else clock
        self.workers = workers
        self.registry = Registry() if registry is None else registry
        self.trace = trace
        self.recorder = recorder
        self.phases = phases
        self._overlap_ready = overlap_ready
        self.delivered: asyncio.Queue = asyncio.Queue()
        self._inbox: asyncio.Queue = asyncio.Queue(maxsize=65536)
        self._inbox_bytes = 0
        self._tasks: list = []
        # thread mode: a core is touched by the owner (stage 1) and by its
        # shard thread (stage 3, GC) in turns, never at once; the drain
        # cycle and the GC pass take this lock for their whole turn
        self._shard_turn = asyncio.Lock()
        self._executor = make_plane_executor(
            executor, shards,
            ring_slots=ring_slots, ring_slot_bytes=ring_slot_bytes,
        )
        self._inline = self._executor.name == "inline"
        self._proc = self._executor.name == "process"
        # process-mode owner-side state: merged watermarks, per-shard
        # gauge snapshots, and the crash ledger /healthz attributes
        self._proc_wm_tx: Dict[bytes, int] = {}
        self._proc_wm_batch: Dict[bytes, int] = {}
        self._proc_undeliv = [0] * shards
        self._proc_floor_refusals = [0] * shards
        self.worker_crashed: Dict[int, int] = {}
        self.on_worker_crash = None  # service hook: (shard_id, exitcode)
        self._pending_wm_restore: list = []
        # entry-registry releases bound for the workers, packed into as
        # few ring records as fit (see release_entry)
        self._pending_release: list = []

        # obs shipping lane (process mode): each worker runs its own
        # diagnosis-tier slice and streams delta records over a dedicated
        # per-shard obs ring; the owner folds them into THIS registry so
        # /metrics, /statusz, /profilez, /debugz see through the process
        # boundary. The lane exists whenever any instrument that would
        # ride it is enabled (worker gating mirrors the owner's).
        self._obs_ship = self._proc and (
            recorder is not None
            or trace is not None
            or phases is not None
            or worker_profiler
        )
        self._worker_profiler = worker_profiler
        self._profiler_hz = profiler_hz
        self._profiler_max_nodes = profiler_max_nodes
        self._obs_flush_s = obs_flush_s
        # per-shard fold state: raw phase-ns vectors (post-mortem + the
        # *_shardN counters derive from these increments), recorder
        # event tails, and folded-stack increments for /profilez merges
        self._obs_phase_ns: List[Dict[str, int]] = [
            dict() for _ in range(shards)
        ]
        self._obs_worker_events: List[deque] = [
            deque(maxlen=2048) for _ in range(shards)
        ]
        self._obs_folds: List[Dict[str, int]] = [dict() for _ in range(shards)]
        self._obs_fold_samples = [0] * shards

        # one effects lane per shard (only drained in threaded mode, but
        # constructed always so instruments exist and stay cheap). The
        # owner drains a thread shard's lane right after awaiting the
        # shard's work, so a full lane never pushes back on anything: a
        # bound could only lose effects, deliveries among them (one drain
        # cycle of 256-entry batches can deliver more entries than the
        # reference's 4,096-item lane holds, and a lost delivery stalls
        # its sender's sequence for good). The lanes are unbounded.
        self._effects: List[SPSCQueue] = [
            SPSCQueue(capacity=sys.maxsize) for _ in range(shards)
        ]
        self._stall_pending = False
        # plane-level stall hysteresis for the inline global GC pass
        # (Broadcast._gc_resolve_stall duck-types against these)
        self._stall_last_kick = float("-inf")
        self._stall_backoff = STALL_KICK_MIN_INTERVAL

        # service-facing hooks, fanned into the cores below
        self.catchup_handler = None
        self.directory_handler = None
        self.config_handler = None
        self.beacon_handler = None
        self.cert_handler = None
        self.stall_handler = None

        self.stats = self.registry.counter_group((
            "gossip_rx",
            "echo_rx",
            "ready_rx",
            "invalid_sig",
            "delivered",
            "slots_dropped",
            "content_req_tx",
            "content_req_rx",
            "content_served",
            "batch_rx",
            "batch_echo_rx",
            "batch_ready_rx",
            "batch_entries_delivered",
            "retransmits",
            "poison_resolved",
            "slots_retired",
            "stall_kicks_suppressed",
        ))

        # Process mode still builds the owner-side cores, but they stay
        # EMPTY forever: the real shard state lives in the worker
        # processes (parallel/plane_worker.py). What the owner cores
        # provide is the control-plane dispatch seam (core 0's _pre_msg
        # runs the catchup/directory/config/beacon handlers), the
        # threshold/floor bookkeeping the spec factory reads, and an
        # unchanged surface for every cross-shard accessor below.
        owner_side = self._inline or self._proc
        self._cores: List[Broadcast] = []
        for sid in range(shards):
            core = Broadcast(
                keypair,
                mesh if owner_side else _ShardMesh(mesh, self._effects[sid]),
                verifier,  # unused by cores (owner runs the bulk verify)
                echo_threshold=echo_threshold,
                ready_threshold=ready_threshold,
                workers=0,
                registry=None,  # private registry; shared stats below
                trace=trace if self._inline else None,
                recorder=recorder if owner_side else None,
                clock=self.clock,
                phases=(
                    phases.shard_view(sid, self.registry)
                    if phases is not None
                    else None
                ),
                overlap_ready=overlap_ready,
            )
            core.stats = self.stats  # ONE aggregate counter group
            if owner_side:
                core.delivered = self.delivered
                core.stall_handler = self._fire_stall
            else:
                core.delivered = _ShardDelivered(self._effects[sid])
                core.stall_handler = self._make_thread_stall(sid)
            self._cores.append(core)
        # the equivocation registry spans shards (module docstring):
        # every core binds and reads through ONE shared instance
        shared_registry = self._cores[0]._entry_registry
        for core in self._cores[1:]:
            core._entry_registry = shared_registry
        # ONE slot-birth counter across cores: the global creation
        # ordinal reconstructs the monolithic plane's GC iteration order
        # (see _gc_pass_global)
        shared_births = self._cores[0]._birth_seq
        for core in self._cores[1:]:
            core._birth_seq = shared_births

        self.registry.gauge(
            "slots_undelivered", "live undelivered broadcast slots",
            fn=lambda: (
                sum(c._undelivered for c in self._cores)
                + sum(self._proc_undeliv)
            ),
        )
        self.registry.gauge(
            "inbox_depth", "raw frames queued for the broadcast workers",
            fn=lambda: self._inbox.qsize(),
        )
        self.registry.gauge(
            "plane_shards", "broadcast plane shard count",
            fn=lambda: float(self.shards),
        )
        self.registry.gauge(
            "plane_shard_queue_depth",
            "deepest shard effects handoff lane right now (queue items "
            "for thread shards, ring slots for process shards)",
            fn=lambda: float(max(
                max(len(q) for q in self._effects),
                max((len(r) for r in self._live_rings()), default=0),
            )),
        )
        self.registry.gauge(
            "plane_shard_effects_dropped",
            "shard handoff records refused at lane capacity "
            "(producer-side drop accounting; should be 0)",
            fn=lambda: float(self.effects_dropped),
        )
        self.registry.gauge(
            "obs_records_dropped",
            "observability delta records shed at obs-ring capacity "
            "(accounted loss, never backpressure; distinct from "
            "plane_shard_effects_dropped)",
            fn=lambda: float(self.obs_dropped),
        )
        self._handoff_hist = self.registry.histogram(
            "plane_shard_handoff_ns",
            "shard effect enqueue-to-apply latency (ns)",
            bounds=_HANDOFF_BOUNDS,
        )

    # -- threshold fan-out (service reconfigures these on membership
    # epochs; every core must agree or quorum math diverges per shard) --

    @property
    def echo_threshold(self) -> int:
        return self._cores[0].echo_threshold

    @echo_threshold.setter
    def echo_threshold(self, value: int) -> None:
        for core in self._cores:
            core.echo_threshold = value
        self._proc_push_thresholds()

    @property
    def ready_threshold(self) -> int:
        return self._cores[0].ready_threshold

    @ready_threshold.setter
    def ready_threshold(self, value: int) -> None:
        for core in self._cores:
            core.ready_threshold = value
        self._proc_push_thresholds()

    def _proc_push_thresholds(self) -> None:
        if not self._proc or not self._executor._started:
            return
        payload = struct.pack(
            "<II",
            self._cores[0].echo_threshold,
            self._cores[0].ready_threshold,
        )
        for ring in self._executor.actions:
            ring.put(pw.C_THRESH, payload)

    @property
    def on_attest(self):
        return self._cores[0].on_attest

    @on_attest.setter
    def on_attest(self, hook) -> None:
        for core in self._cores:
            core.on_attest = hook

    @property
    def floor_refusals(self) -> int:
        return sum(c.floor_refusals for c in self._cores)

    # -- lifecycle --------------------------------------------------------

    async def start(self) -> None:
        from ..native.ingest import ingest_available

        # pre-build BEFORE spawning workers: they load the cached .so
        await asyncio.get_running_loop().run_in_executor(None, ingest_available)
        if self._proc:
            self._executor.start(self._make_worker_spec)
            self._proc_push_thresholds()
            for doc in self._pending_wm_restore:
                payload = json.dumps(doc).encode()
                for ring in self._executor.actions:
                    ring.put(pw.C_WM_RESTORE, payload)
            self._pending_wm_restore.clear()
            self._tasks.append(asyncio.create_task(self._flusher()))
        for _ in range(self.workers):
            self._tasks.append(asyncio.create_task(self._worker()))
        self._tasks.append(asyncio.create_task(self._gc_loop()))

    async def close(self) -> None:
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        if self._proc:
            # stop workers FIRST (they flush state on shutdown), fold
            # their final effects in, then unlink the rings
            self._executor.stop_workers()
            try:
                self._flush_proc_effects()
                self._flush_proc_obs()
            except Exception:  # pragma: no cover - teardown best-effort
                pass
        self._executor.shutdown()

    def _make_worker_spec(
        self, sid: int, actions_ring: str, effects_ring: str,
        obs_ring: str = "",
    ) -> WorkerSpec:
        return WorkerSpec(
            shard_id=sid,
            shards=self.shards,
            sign_seed=self.keypair.private_bytes,
            echo_threshold=self._cores[0].echo_threshold,
            ready_threshold=self._cores[0].ready_threshold,
            overlap_ready=self._overlap_ready,
            peers=tuple(
                (p.address, p.exchange_public, p.sign_public, p.region)
                for p in self.mesh.peers
            ),
            actions_ring=actions_ring,
            effects_ring=effects_ring,
            ring_slots=self._executor.ring_slots,
            ring_slot_bytes=self._executor.ring_slot_bytes,
            parent_pid=os.getpid(),
            # worker obs slice: gated by the SAME instruments the owner
            # runs, so thread-mode and process-mode observability agree
            obs_ring=obs_ring if self._obs_ship else "",
            recorder_cap=(
                self.recorder._cap if self.recorder is not None else 0
            ),
            trace_sample=(
                self.trace._sample_every if self.trace is not None else 0
            ),
            phase_accounting=self.phases is not None,
            profiler_hz=self._profiler_hz,
            profiler_max_nodes=self._profiler_max_nodes,
            obs_flush_s=self._obs_flush_s,
        )

    # -- ingress (mirrors Broadcast.on_frame admission exactly) -----------

    async def on_frame(self, peer, frame: bytes) -> None:
        if self.recorder is not None and frame:
            self.recorder.record("rx", (frame[0], len(frame), peer.address))
        if self._inbox_bytes + len(frame) > INBOX_MAX_BYTES:
            logger.warning("inbox byte budget exhausted; dropping frame")
            if self.recorder is not None:
                self.recorder.record("rx_drop", ("bytes", len(frame)))
            return
        try:
            self._inbox.put_nowait((peer, frame))
        except asyncio.QueueFull:
            logger.warning("inbox overflow; dropping frame")
            if self.recorder is not None:
                self.recorder.record("rx_drop", ("depth", len(frame)))
        else:
            self._inbox_bytes += len(frame)

    async def broadcast(self, payload: Payload) -> None:
        await self._inbox.put((None, payload))

    async def broadcast_batch(self, batch: TxBatch) -> None:
        await self._inbox.put((None, batch))

    # -- routing ----------------------------------------------------------

    def _route(self, msg) -> int:
        """The owning shard id for a message — keyed by the SLOT's
        origin key so every message about one slot lands on one core."""
        if isinstance(msg, Payload):
            key = msg.sender
        elif isinstance(msg, Attestation):
            key = msg.sender
        elif isinstance(msg, TxBatch):
            key = msg.origin
        elif isinstance(msg, BatchAttestation):
            key = msg.batch_origin
        elif isinstance(msg, ContentRequest):
            key = msg.sender
        elif isinstance(msg, BatchContentRequest):
            key = msg.batch_origin
        else:
            # control plane (catchup / directory / config): stateless wrt
            # shard slots — handled wherever, keep it on core 0
            return 0
        return shard_of(key, self.shards)

    # -- drain cycle ------------------------------------------------------

    async def _worker(self) -> None:
        while True:
            item = await self._inbox.get()
            chunk = [item]
            while len(chunk) < WORKER_CHUNK:
                try:
                    chunk.append(self._inbox.get_nowait())
                except asyncio.QueueEmpty:
                    break
            for _, payload in chunk:
                if isinstance(payload, (bytes, bytearray, memoryview)):
                    self._inbox_bytes -= len(payload)
            ph = self.phases
            t_plane = ph.begin_plane() if ph is not None else 0
            t0 = ph.t() if ph is not None else 0
            try:
                if self._proc:
                    # process mode: the owner's whole hot path is ONE
                    # native parse+route call and ring copies — no
                    # message objects, no verify_wait on this loop
                    self._dispatch_chunk_proc(chunk)
                    if ph is not None:
                        ph.add("rx_decode", t0)
                else:
                    msgs = self._parse_chunk_routed(chunk)
                    if ph is not None:
                        ph.add("rx_decode", t0)
                    async with self._shard_turn:
                        await self._process_chunk(msgs)
            except Exception:
                logger.exception("sharded plane worker error")
            if ph is not None:
                ph.end_plane(t_plane)

    def _parse_chunk_routed(self, chunk) -> list:
        """Parse a drained chunk into ``(peer, msg, shard_id)`` triples.

        The fused native call (at2_plane_drain) computes the owning
        shard for every message IN the GIL-released parse pass, so the
        owner loop never runs the per-message isinstance routing chain;
        the Python fallback derives the same ids via :func:`shard_of`
        (differentially pinned by the plane-shard tests). Ordering
        is exactly ``Broadcast._parse_chunk``'s: local objects first in
        chunk order, then frame messages in frame order."""
        from ..native.ingest import plane_drain_native, plane_drain_ready

        out = []
        frames: list = []
        frame_peers: list = []
        for peer, item in chunk:
            if isinstance(item, (bytes, bytearray, memoryview)):
                frames.append(bytes(item))
                frame_peers.append(peer)
            else:
                out.append((peer, item, self._route(item)))
        if not frames:
            return out
        total_bytes = sum(len(f) for f in frames)
        if total_bytes >= 4096 and plane_drain_ready():
            items, frame_ok, _counts = plane_drain_native(frames, self.shards)
            for i, ok in enumerate(frame_ok):
                if not ok:
                    peer = frame_peers[i]
                    logger.warning(
                        "bad frame from %s",
                        peer.address if peer is not None else "local",
                    )
            out.extend(
                (frame_peers[fi], msg, sid) for fi, sid, msg in items
            )
        else:
            parsed = self._cores[0]._parse_chunk(
                list(zip(frame_peers, frames))
            )
            out.extend((peer, msg, self._route(msg)) for peer, msg in parsed)
        return out

    async def _process_chunk(self, msgs) -> None:
        """Stage 1 per message in ARRIVAL order on the owning core, ONE
        bulk verify for the whole chunk, stage 3 in arrival order
        (inline) or grouped per shard on the executor (threaded).
        ``msgs`` are ``(peer, msg, shard_id)`` triples from
        :meth:`_parse_chunk_routed`."""
        ph = self.phases
        t0 = ph.t() if ph is not None else 0
        to_verify: list = []
        actions: list = []  # (shard_id, (kind, msg, n_sigs))
        scratch: list = []
        for peer, msg, sid in msgs:
            self._cores[sid]._pre_msg(peer, msg, to_verify, scratch)
            if scratch:
                actions.append((sid, scratch[0]))
                scratch.clear()
        if ph is not None:
            t0 = ph.add("rx_decode", t0)
        if not to_verify:
            if not self._inline:
                self._flush_effects()
            self._maybe_fire_stall()
            return
        results = await self.verifier.verify_many(to_verify)
        if ph is not None:
            ph.add("verify_wait", t0)

        idx = 0
        if self._inline:
            for sid, (kind, msg, n_sigs) in actions:
                ok = results[idx]
                entry_oks = (
                    results[idx + 1 : idx + n_sigs] if kind == BATCH else None
                )
                idx += n_sigs
                self._cores[sid]._post_action(kind, msg, ok, entry_oks)
        else:
            per_shard: Dict[int, list] = {}
            for sid, (kind, msg, n_sigs) in actions:
                ok = results[idx]
                entry_oks = (
                    results[idx + 1 : idx + n_sigs] if kind == BATCH else None
                )
                idx += n_sigs
                per_shard.setdefault(sid, []).append(
                    (kind, msg, ok, entry_oks)
                )
            futs = [
                self._executor.submit(
                    sid, self._run_actions, self._cores[sid], alist
                )
                for sid, alist in per_shard.items()
            ]
            if futs:
                await asyncio.gather(
                    *(asyncio.wrap_future(f) for f in futs)
                )
            self._flush_effects()
        self._maybe_fire_stall()

    @staticmethod
    def _run_actions(core: Broadcast, alist) -> None:
        """Shard-thread entry point: apply this shard's verified actions
        in order. Exceptions stay on the shard (logged) so one poisoned
        message cannot take the owner's drain cycle down."""
        for kind, msg, ok, entry_oks in alist:
            try:
                core._post_action(kind, msg, ok, entry_oks)
            except Exception:
                logger.exception("shard action error")

    # -- process-mode owner loop ------------------------------------------

    def _dispatch_chunk_proc(self, chunk) -> None:
        """Process-mode stage 1: ONE native parse+route call over the
        chunk's frames, then flat ``peer_sign + wire`` records into each
        owning shard's actions ring. Slot-bound kinds never become
        Python objects on the owner; control kinds (catchup, directory,
        config, beacon) are peeled off and dispatched through core 0's
        handlers right here. A record that does not fit its ring waits
        in the ring's backlog on this side (the actions rings spill),
        which the effects loop moves into the ring as the worker drains
        it."""
        from ..native.ingest import plane_drain_native, plane_drain_ready

        rings = self._executor.actions
        frames: list = []
        frame_peers: list = []
        for peer, item in chunk:
            if isinstance(item, (bytes, bytearray, memoryview)):
                frames.append(bytes(item))
                frame_peers.append(peer)
            else:
                # locally-submitted Payload/TxBatch: encode and ship to
                # the owning shard (the sentinel peer means "local")
                rings[self._route(item)].put(
                    pw.C_MSG, pw._LOCAL_SENTINEL + item.encode()
                )
        if not frames:
            return
        if plane_drain_ready():
            items, frame_ok, _counts = plane_drain_native(
                frames, self.shards, want_objects=False
            )
            for i, ok in enumerate(frame_ok):
                if not ok:
                    peer = frame_peers[i]
                    logger.warning(
                        "bad frame from %s",
                        peer.address if peer is not None else "local",
                    )
            for fidx, sid, kind, wire in items:
                if kind in _SLOT_KINDS:
                    peer = frame_peers[fidx]
                    pub = (
                        peer.sign_public if peer is not None
                        else pw._LOCAL_SENTINEL
                    )
                    rings[sid].put(pw.C_MSG, pub + wire)
                else:
                    self._ctrl_dispatch_wire(frame_peers[fidx], wire)
        else:
            parsed = self._cores[0]._parse_chunk(
                list(zip(frame_peers, frames))
            )
            for peer, msg in parsed:
                if isinstance(msg, _SLOT_TYPES):
                    pub = (
                        peer.sign_public if peer is not None
                        else pw._LOCAL_SENTINEL
                    )
                    rings[self._route(msg)].put(pw.C_MSG, pub + msg.encode())
                else:
                    self._ctrl_dispatch(peer, msg)

    def _ctrl_dispatch_wire(self, peer, wire: bytes) -> None:
        from .messages import WireError, parse_frame

        try:
            msgs = parse_frame(wire)
        except WireError:  # pragma: no cover - native already validated
            return
        for msg in msgs:
            self._ctrl_dispatch(peer, msg)

    def _ctrl_dispatch(self, peer, msg) -> None:
        """Owner-side control dispatch through core 0's handler seam
        (control kinds touch no shard slot state, only service hooks)."""
        scratch_v: list = []
        scratch_a: list = []
        try:
            self._cores[0]._pre_msg(peer, msg, scratch_v, scratch_a)
        except Exception:
            logger.exception("control dispatch error")

    async def _flusher(self) -> None:
        """Process-mode owner task: poll every shard's effects ring,
        apply records, and watch worker health. Adaptive cadence: tight
        while records flow, relaxed when idle (the handoff histogram
        keeps the latency honest either way)."""
        while True:
            try:
                self._flush_releases()
                n = sum(not ring.flush() for ring in self._executor.actions)
                n += self._flush_proc_effects()
                n += self._flush_proc_obs()
                self._poll_workers()
            except Exception:
                logger.exception("plane effects flush error")
                n = 0
            self._maybe_fire_stall()
            await asyncio.sleep(0.0005 if n else 0.002)

    def _flush_proc_effects(self) -> int:
        """Drain + apply every worker's effect records on the owner
        loop. Returns the number of records applied."""
        total = 0
        worst = 0
        by_sign = self.mesh.by_sign
        for sid, ring in enumerate(self._executor.effects):
            recs, handoff = ring.drain()
            if handoff > worst:
                worst = handoff
            for kind, payload in recs:
                if kind == pw.E_SEND:
                    peer = by_sign.get(payload[:32])
                    if peer is not None:
                        self.mesh.send(peer, payload[32:])
                elif kind == pw.E_BCAST:
                    self.mesh.broadcast(payload)
                elif kind == pw.E_DELIVER:
                    msg = Payload.decode_body(payload[:140])
                    object.__setattr__(msg, "_chash", payload[140:172])
                    self.delivered.put_nowait(msg)
                elif kind == pw.E_STALL:
                    self._stall_pending = True
                elif kind == pw.E_STATS:
                    for i, key in enumerate(STAT_KEYS):
                        delta = int.from_bytes(
                            payload[i * 8 : (i + 1) * 8], "little"
                        )
                        if delta:
                            self.stats[key] += delta
                elif kind == pw.E_WM:
                    key = payload[1:33]
                    seq = int.from_bytes(payload[33:41], "little")
                    wm = (
                        self._proc_wm_tx if payload[0] == 0
                        else self._proc_wm_batch
                    )
                    if wm.get(key, -1) < seq:
                        wm[key] = seq
                elif kind == pw.E_INFO:
                    undeliv, floors = struct.unpack("<IQ", payload)
                    self._proc_undeliv[sid] = undeliv
                    self._proc_floor_refusals[sid] = floors
            total += len(recs)
        if worst > 0:
            self._handoff_hist.observe(worst)
        return total

    # -- obs shipping lane: owner-side fold ------------------------------

    def _flush_proc_obs(self) -> int:
        """Drain every worker's obs ring and fold the delta records into
        the owner's registry / tracer / event tails. Returns the number
        of records folded (feeds the flusher's adaptive cadence)."""
        if not self._obs_ship or not self._executor._started:
            return 0
        total = 0
        for sid in range(len(self._executor.obs)):
            total += self._drain_obs_ring(sid)
        return total

    def _drain_obs_ring(self, sid: int) -> int:
        recs, _ = self._executor.obs[sid].drain()
        for kind, payload in recs:
            try:
                self._apply_obs_record(sid, kind, payload)
            except Exception:
                logger.exception("obs record fold error (shard %d)", sid)
        return len(recs)

    def _apply_obs_record(self, sid: int, kind: int, payload: bytes) -> None:
        from ..obs.profiler import (
            PHASE_BOUNDS,
            PHASES,
            PLANE_LEAF_PHASES,
            parse_folded,
        )

        if kind == pw.O_PHASE:
            # Fold rules mirror thread-mode ShardPhaseView: leaf phases
            # dual-write base + shardN; slot_gc (and any other non-leaf
            # a worker marks) goes to base only; plane_total goes ONLY
            # to its shardN counter — the worker's drain-cycle span and
            # the owner's dispatch span are DIFFERENT denominators, and
            # profile_collect sums them explicitly.
            head, nb = pw._ophase, len(PHASE_BOUNDS) + 1
            step = head.size + 4 * nb
            for off in range(0, len(payload), step):
                idx, ns, count, sum_s, max_s = head.unpack_from(payload, off)
                if idx >= len(PHASES):
                    continue  # vocabulary drift: shed rather than crash
                phase = PHASES[idx]
                buckets = struct.unpack_from(f"<{nb}I", payload, off + head.size)
                acc = self._obs_phase_ns[sid]
                acc[phase] = acc.get(phase, 0) + ns
                if phase == "plane_total":
                    self.registry.counter(
                        f"phase_plane_total_shard{sid}_ns",
                        "elapsed ns of plane shard worker drain cycles "
                        f"(shard {sid} process)",
                    ).inc(ns)
                    continue
                self.registry.counter(f"phase_{phase}_ns").inc(ns)
                if phase in PLANE_LEAF_PHASES:
                    self.registry.counter(
                        f"phase_{phase}_shard{sid}_ns",
                        f"elapsed ns accounted to phase {phase} on plane "
                        f"shard {sid}",
                    ).inc(ns)
                self.registry.histogram(
                    f"phase_{phase}", bounds=PHASE_BOUNDS
                ).merge_deltas(buckets, sum_s, count, max_s)
        elif kind == pw.O_REC:
            events = json.loads(payload.decode())
            self._obs_worker_events[sid].extend(events)
        elif kind == pw.O_TRACE:
            if self.trace is None:
                return
            rec = pw._otrace
            for off in range(0, len(payload), rec.size):
                sender, seq, stage_idx, mono = rec.unpack_from(payload, off)
                if stage_idx < len(pw.TRACE_STAGES):
                    self.trace.stamp(
                        (sender, seq), pw.TRACE_STAGES[stage_idx], now=mono
                    )
        elif kind == pw.O_FOLD:
            samples = int.from_bytes(payload[:8], "little")
            self._obs_fold_samples[sid] += samples
            fold = self._obs_folds[sid]
            for stack, count in parse_folded(payload[8:].decode()).items():
                fold[stack] = fold.get(stack, 0) + count

    @property
    def obs_dropped(self) -> int:
        """Producer-side drops on the obs lane only — exported as
        ``obs_records_dropped``, deliberately OUTSIDE
        ``plane_shard_effects_dropped`` (losing a phase delta is an
        observability gap; losing an effect record is protocol loss)."""
        if not self._proc or not self._executor._started:
            return 0
        total = 0
        for ring in self._executor.obs:
            try:
                total += ring.dropped
            except Exception:  # pragma: no cover - ring torn down
                pass
        return total

    def worker_events(self) -> list:
        """Worker-side recorder events shipped over the obs lane, in the
        /debugz event shape with codes prefixed ``shardN/``, sorted by
        mono timestamp (one CLOCK_MONOTONIC machine-wide, so they
        interleave truthfully with owner events)."""
        out = []
        for sid, dq in enumerate(self._obs_worker_events):
            pre = f"shard{sid}/"
            out.extend([t, pre + code, detail] for t, code, detail in dq)
        out.sort(key=lambda e: e[0])
        return out

    def profiler_start(self, duration: Optional[float] = None) -> bool:
        """Fan a StackSampler start to every worker (C_PROF) and reset
        the owner-side fold accumulators, so a /profilez session reports
        only its own window. Returns True if the fan-out happened."""
        if not (
            self._obs_ship
            and self._worker_profiler
            and self._executor._started
        ):
            return False
        for sid in range(self.shards):
            self._obs_folds[sid] = {}
            self._obs_fold_samples[sid] = 0
        payload = pw._prof.pack(1, float(duration if duration else 0.0))
        for ring in self._executor.actions:
            ring.put(pw.C_PROF, payload)
        return True

    def profiler_stop(self) -> bool:
        if not (
            self._obs_ship
            and self._worker_profiler
            and self._executor._started
        ):
            return False
        payload = pw._prof.pack(0, 0.0)
        for ring in self._executor.actions:
            ring.put(pw.C_PROF, payload)
        return True

    def worker_folds(self) -> list:
        """``(prefix, {stack: count})`` parts for
        :func:`~..obs.profiler.merge_folded` — one per shard that has
        shipped folded-stack increments."""
        return [
            (f"shard{sid}/", dict(self._obs_folds[sid]))
            for sid in range(self.shards)
            if self._obs_folds[sid]
        ]

    def worker_fold_samples(self) -> int:
        return sum(self._obs_fold_samples)

    def _poll_workers(self) -> None:
        """Surface worker deaths exactly once each: crash ledger for
        /healthz attribution, flight-recorder code, service hook. The
        plane keeps draining — surviving shards stay live, the dead
        shard's traffic drops with accounting until an operator
        restarts the node (degraded, never hung)."""
        for sid, code in self._executor.poll_crashed():
            self.worker_crashed[sid] = code
            self._executor.actions[sid].stop_spilling()
            logger.error(
                "plane shard %d worker died (exit %s)", sid, code
            )
            extra = None
            if self._obs_ship:
                # post-mortem: the dead worker can't flush again, but
                # whatever it already shipped is still in shared memory
                # — drain it FIRST so the crash snapshot carries the
                # worker's last recorder events and phase totals
                try:
                    self._drain_obs_ring(sid)
                except Exception:
                    logger.exception("post-mortem obs drain failed")
                extra = {
                    "shard": sid,
                    "exit": code,
                    "recorder_tail": list(self._obs_worker_events[sid])[-64:],
                    "phases": dict(self._obs_phase_ns[sid]),
                }
            if self.recorder is not None:
                try:
                    self.recorder.snapshot(
                        f"plane_worker_crash:shard={sid},exit={code}",
                        extra=extra,
                    )
                except Exception:
                    logger.exception("crash snapshot failed")
            hook = self.on_worker_crash
            if hook is not None:
                try:
                    hook(sid, code)
                except Exception:
                    logger.exception("worker-crash hook error")

    def _live_rings(self):
        if not self._proc or not self._executor._started:
            return ()
        return (*self._executor.actions, *self._executor.effects)

    @property
    def effects_dropped(self) -> int:
        """Producer-side handoff drops across EVERY lane: the in-process
        SPSC queues (thread mode) plus both ring directions (process
        mode). Exported as ``plane_shard_effects_dropped``."""
        total = sum(q.dropped for q in self._effects)
        for ring in self._live_rings():
            try:
                total += ring.dropped
            except Exception:  # pragma: no cover - ring torn down
                pass
        return total

    # -- effects + stall marshaling ---------------------------------------

    def _fire_stall(self) -> None:
        # inline cores call straight through on the owner loop
        self._stall_pending = True

    def _make_thread_stall(self, sid: int):
        effects = self._effects[sid]

        def _stall() -> None:
            effects.put(("stall",))

        return _stall

    def _flush_effects(self) -> None:
        """Apply queued shard effects on the owner loop (threaded mode).
        Per-queue FIFO keeps each shard's sends in its own order — the
        same guarantee the monolithic plane gave within a worker chunk."""
        worst = 0
        for q in self._effects:
            items, handoff = q.drain()
            if handoff > worst:
                worst = handoff
            for item in items:
                tag = item[0]
                if tag == "send":
                    self.mesh.send(item[1], item[2])
                elif tag == "broadcast":
                    self.mesh.broadcast(item[1])
                elif tag == "deliver":
                    self.delivered.put_nowait(item[1])
                elif tag == "stall":
                    self._stall_pending = True
        if worst > 0:
            self._handoff_hist.observe(worst)

    def _maybe_fire_stall(self) -> None:
        if not self._stall_pending:
            return
        self._stall_pending = False
        if self.stall_handler is not None:
            try:
                self.stall_handler()
            except Exception:
                logger.exception("stall handler error")

    # -- GC ---------------------------------------------------------------

    async def _gc_loop(self) -> None:
        while True:
            await self.clock.sleep(GC_INTERVAL)
            now = self.clock.monotonic()
            if self._inline:
                self._gc_pass_global(now)
            elif self._proc:
                # workers GC their own slots; CLOCK_MONOTONIC is one
                # clock machine-wide, so the owner's now is theirs
                payload = struct.pack("<d", now)
                for ring in self._executor.actions:
                    ring.put(pw.C_GC, payload)
            else:
                async with self._shard_turn:
                    futs = [
                        self._executor.submit(sid, core._gc_pass, now)
                        for sid, core in enumerate(self._cores)
                    ]
                    await asyncio.gather(
                        *(asyncio.wrap_future(f) for f in futs),
                        return_exceptions=True,
                    )
                    self._flush_effects()
            self._maybe_fire_stall()

    def _gc_pass_global(self, now: float) -> None:
        """Inline (sim) GC: interleave EVERY shard's slots in global
        creation order under ONE retransmit budget and ONE plane-level
        stall hysteresis — exactly the pass the monolithic plane runs
        over its single insertion-ordered slot dict, so retransmission
        order (and with it the sim wire trace) is shard-count-invariant.
        Threaded mode keeps per-core passes instead: real-time hosts buy
        GC parallelism with a per-shard budget, a trade the sim never
        makes."""
        ph = self.phases
        t_gc = ph.t() if ph is not None else 0
        budget = [RETRANSMIT_BUDGET_PER_PASS]
        stalled = False
        tx = [
            (state.birth, core, slot)
            for core in self._cores
            for slot, state in core._slots.items()
        ]
        tx.sort(key=lambda e: e[0])
        for _, core, slot in tx:
            if core._gc_tx_slot(slot, now, budget):
                stalled = True
        batches = [
            (state.birth, core, slot)
            for core in self._cores
            for slot, state in core._batch_slots.items()
        ]
        batches.sort(key=lambda e: e[0])
        for _, core, slot in batches:
            if core._gc_batch_slot(slot, now, budget):
                stalled = True
        Broadcast._gc_resolve_stall(self, now, stalled)
        if ph is not None:
            ph.add("slot_gc", t_gc)

    # -- cross-shard service surface --------------------------------------

    def release_entry(self, sender: bytes, sequence: int) -> None:
        # the registry is shared: one pop releases the binding plane-wide
        self._cores[0].release_entry(sender, sequence)
        if self._proc and self._executor._started:
            # process workers each hold a registry; the binding lives on
            # whichever worker bound it — fan the release (no-op pops).
            # The flusher ships the releases packed, as many a record as a
            # ring slot holds: one record a release (the reference's) takes
            # a whole slot of every shard's actions ring, so a burst of
            # commits filled the rings and dropped records
            self._pending_release.append(sender + struct.pack("<Q", sequence))

    def _flush_releases(self) -> None:
        """Ship the pending entry-registry releases to every worker:
        ``C_RELEASE`` records of whole 40-byte ``sender + u64 sequence``
        items, each record filling one ring slot."""
        items, self._pending_release = self._pending_release, []
        per = max(1, (self._executor.ring_slot_bytes - 16) // 40)
        for i in range(0, len(items), per):
            payload = b"".join(items[i : i + per])
            for ring in self._executor.actions:
                ring.put(pw.C_RELEASE, payload)

    def export_watermarks(self) -> dict:
        """Merge per-shard watermark exports. Keys partition by shard for
        LIVE attestation bumps, but restored floors are fanned to every
        core, so merge with max to stay monotone either way. Process
        workers stream their bumps through the effects ring; the merged
        owner-side dicts are folded in here."""
        tx: Dict[str, int] = {}
        batch: Dict[str, int] = {}
        for core in self._cores:
            doc = core.export_watermarks()
            for k, v in doc["tx"].items():
                tx[k] = max(tx.get(k, 0), v)
            for k, v in doc["batch"].items():
                batch[k] = max(batch.get(k, 0), v)
        for key, v in self._proc_wm_tx.items():
            k = key.hex()
            tx[k] = max(tx.get(k, 0), v)
        for key, v in self._proc_wm_batch.items():
            k = key.hex()
            batch[k] = max(batch.get(k, 0), v)
        return {"tx": tx, "batch": batch}

    def restore_watermarks(self, doc: dict) -> None:
        for core in self._cores:
            core.restore_watermarks(doc)
        if self._proc:
            if self._executor._started:
                payload = json.dumps(doc).encode()
                for ring in self._executor.actions:
                    ring.put(pw.C_WM_RESTORE, payload)
            else:
                # the usual service order is restore-then-start: queue
                # the doc and replay it right after the workers spawn
                self._pending_wm_restore.append(doc)

    def part_delivered_batches(self, limit: int = 16) -> list:
        """Every owner-side core's part-delivered batch slots, oldest
        first, each with its shard (a process shard's live in its
        worker and are not listed)."""
        rows = [
            dict(row, shard=sid)
            for sid, core in enumerate(self._cores)
            for row in core.part_delivered_batches(limit)
        ]
        rows.sort(key=lambda r: -r["age_s"])
        return rows[:limit]

    def plane_info(self) -> dict:
        """The /statusz ``plane`` block (tools/top.py shards column)."""
        info = {
            "shards": self.shards,
            "executor": self._executor.name,
            "effects_dropped": self.effects_dropped,
        }
        if self._proc:
            info["obs_records_dropped"] = self.obs_dropped
            info["actions_backlog"] = sum(r.backlog for r in self._executor.actions)
        if self.worker_crashed:
            info["worker_crashed"] = {
                str(sid): code for sid, code in self.worker_crashed.items()
            }
        return info

    # handler hooks are plain attributes on Broadcast; fan writes through
    # so cores see the service's callbacks (the sharded plane routes
    # control messages to core 0, but catchup replies can come from any
    # core's GC pass via stall, so keep them all consistent)
    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name in (
            "catchup_handler",
            "directory_handler",
            "config_handler",
            "beacon_handler",
            "cert_handler",
        ):
            for core in getattr(self, "_cores", ()):  # pre-init writes
                setattr(core, name, value)

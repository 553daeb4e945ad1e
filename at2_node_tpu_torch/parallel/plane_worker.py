"""Process-mode plane shard: the spawn target and its wire records.

Counterpart of ``at2_node_tpu/parallel/plane_worker.py``.

One worker process owns one shard's ENTIRE :class:`Broadcast` core —
slots, dedup sets, quorum bitmaps, entry registry, watermarks. The
memory model is confinement taken one level past the thread executor:
where a shard thread shares the owner's address space and merely
promises not to touch cross-shard state, a shard process CANNOT — the
only channel in or out is a pair of shared-memory rings
(parallel/ring.py):

* ``actions`` (owner -> worker): routed messages as flat
  ``peer_sign(32) + wire`` records plus control records (GC ticks,
  threshold updates, watermark restores, shutdown);
* ``effects`` (worker -> owner): outbound frames, delivered payload
  bodies, stall kicks, and periodic state diffs (stats counter deltas,
  attestation watermarks, gauge snapshots) the owner folds into its
  shared observability surfaces.

Everything that crosses is bytes that were already bytes on the wire —
no pickling. Verification happens IN the worker (native bulk ed25519
when the ingest library is available, per-item OpenSSL otherwise), so
shard processes genuinely overlap the dominant verify term on separate
cores with no GIL in common.

The worker is production-shaped about dying: it exits when told
(SHUTDOWN record), and it exits when ORPHANED — every loop iteration
checks ``os.getppid()`` against the owner pid captured at spawn, so an
owner that crashes without cleanup reaps its workers within one poll
interval instead of leaking them.

This module's import graph is deliberately light (stdlib only at module
level); the broadcast/crypto imports happen inside :func:`worker_main`
so the spawn child pays them, not every importer of the parallel
package.
"""

from __future__ import annotations

import json
import os
import struct
import time
from dataclasses import dataclass
from typing import Tuple

__all__ = ["WorkerSpec", "worker_main", "STAT_KEYS", "TRACE_STAGES"]

# owner -> worker control/message record kinds (ShmRing `kind` byte)
C_MSG = 1  # peer_sign(32) + one-message wire frame
C_GC = 2  # f64 monotonic now
C_SHUTDOWN = 3  # clean exit after flushing state
C_THRESH = 4  # u32 echo_threshold, u32 ready_threshold
C_WM_RESTORE = 5  # JSON watermark doc (floors fan-in)
C_RELEASE = 6  # [sender(32) + u64 sequence]... (entry-registry releases)
C_EXIT = 7  # u8 exit code: simulate a worker crash (tests only)
C_PROF = 8  # u8 start(1)/stop(0) + f64 duration (<=0 = until stopped)

# worker -> owner effect record kinds
E_SEND = 16  # peer_sign(32) + frame
E_BCAST = 17  # frame
E_DELIVER = 18  # payload body(140) + content hash(32)
E_STALL = 19  # empty
E_STATS = 20  # len(STAT_KEYS) * u64 counter deltas, STAT_KEYS order
E_WM = 21  # u8 plane (0=tx 1=batch) + key(32) + u64 sequence
E_INFO = 22  # u32 undelivered + u64 floor_refusals

# worker -> owner OBSERVABILITY record kinds. These ride a dedicated
# per-shard obs ring, never the effects ring: a firehose of phase deltas
# must not evict protocol frames, and an obs drop is a separate budget
# (`obs_records_dropped`) from `plane_shard_effects_dropped`.
O_PHASE = 32  # repeated per-changed-phase delta records (see _ophase)
O_REC = 33  # JSON [[t, code, [detail...]], ...] recorder event increments
O_TRACE = 34  # repeated sender(32) + u64 seq + u8 stage idx + f64 mono
O_FOLD = 35  # u64 sample-tick delta + folded-stack text increments

# The TxTrace stages a Broadcast core stamps, in wire order for O_TRACE
# records. Owner replays each through its real tracer; drift here would
# misattribute every worker-side lifecycle stamp.
TRACE_STAGES: Tuple[str, ...] = (
    "echoed",
    "ready_quorum",
    "delivered",
    "echo_quorum",
    "ready_sent",
)
_TRACE_IDX = {s: i for i, s in enumerate(TRACE_STAGES)}

# The shared plane counter names, in wire order for E_STATS records.
# MUST match the counter_group tuples in broadcast/stack.py and
# broadcast/shards.py (pinned by the plane-shard tests).
STAT_KEYS: Tuple[str, ...] = (
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
)

_LOCAL_SENTINEL = bytes(32)  # peer_sign of a locally-submitted message

_u64 = struct.Struct("<Q")
_info = struct.Struct("<IQ")
_prof = struct.Struct("<Bd")
# O_PHASE per-phase head: phase idx (PHASES order), ns delta, histogram
# count delta, histogram sum delta (seconds), ABSOLUTE histogram max
# (merged with max() on the owner). Bucket deltas follow as
# len(PHASE_BOUNDS)+1 little-endian u32s.
_ophase = struct.Struct("<BQQdd")
_otrace = struct.Struct("<32sQBd")


@dataclass(frozen=True)
class WorkerSpec:
    """Everything a spawn child needs; plain picklable data only."""

    shard_id: int
    shards: int
    sign_seed: bytes
    echo_threshold: int
    ready_threshold: int
    overlap_ready: bool
    # ((address, exchange_public, sign_public, region), ...)
    peers: Tuple[Tuple[str, bytes, bytes, str], ...]
    actions_ring: str
    effects_ring: str
    ring_slots: int
    ring_slot_bytes: int
    parent_pid: int
    # observability slice (all defaulted: pre-obs constructions and
    # pickles keep working). Empty obs_ring = no shipping lane at all.
    obs_ring: str = ""
    recorder_cap: int = 0
    trace_sample: int = 0
    phase_accounting: bool = False
    profiler_hz: float = 97.0
    profiler_max_nodes: int = 20000
    obs_flush_s: float = 0.05


class _ProcMesh:
    """Mesh facade inside the worker: reads serve the core's peer/quorum
    bookkeeping from the spec's peer table; sends become effect records
    (the real transports live in the owner process)."""

    __slots__ = ("peers", "by_sign", "_effects")

    def __init__(self, peers, effects) -> None:
        self.peers = peers
        self.by_sign = {p.sign_public: p for p in peers}
        self._effects = effects

    def send(self, peer, data: bytes) -> None:
        self._effects.put(E_SEND, peer.sign_public + bytes(data))

    def broadcast(self, data: bytes) -> None:
        self._effects.put(E_BCAST, bytes(data))


class _ProcDelivered:
    """Delivered-queue facade: payload body + content hash cross as one
    record; the owner rebuilds the Payload (hash pre-seeded, nothing
    re-hashes) and feeds the real asyncio queue the commit tail reads."""

    __slots__ = ("_effects",)

    def __init__(self, effects) -> None:
        self._effects = effects

    def put_nowait(self, payload) -> None:
        self._effects.put(
            E_DELIVER, payload.encode()[1:] + payload.content_hash()
        )


class _WorkerTrace:
    """TxTrace facade inside the worker: buffers ``(key, stage, t)``
    stamps for the obs lane instead of mutating a tracer — the real
    TxTrace lives in the owner, which replays these with the worker's
    CLOCK_MONOTONIC timestamp preserved (machine-wide, so spans stay
    aligned). Applies the same KEYED relay lottery obs/trace.py uses for
    relay-side opens, so a sampled fleet ships only stamps the owner
    could accept; at ``sample_every=1`` (the default) everything ships.
    Records that were origin-sampled by the owner's SEQUENTIAL lottery
    but lose the keyed one miss their worker-interior stamps — the
    documented cost of sampling under process mode."""

    __slots__ = ("_sample", "buf")

    _CAP = 8192  # stamps buffered between flushes; beyond this we shed

    def __init__(self, sample_every: int) -> None:
        self._sample = max(1, int(sample_every))
        self.buf: list = []

    def stamp(self, key, stage: str, now=None) -> None:
        idx = _TRACE_IDX.get(stage)
        if idx is None:
            return
        if self._sample > 1 and (key[0][0] + key[1]) % self._sample:
            return
        if len(self.buf) >= self._CAP:
            return
        self.buf.append(
            (key[0], key[1], idx, time.monotonic() if now is None else now)
        )


class _WorkerObs:
    """The worker process's private slice of the diagnosis tier, plus
    the shipping lane that folds it back into the owner's.

    Each shard process runs its OWN registry + PhaseAccounting (so every
    interior ``phases``/``recorder``/``trace`` mark site in
    broadcast/stack.py lights up unchanged inside the worker), its own
    FlightRecorder ring, and an opt-in StackSampler driven by C_PROF
    records from the owner. Every ``obs_flush_s`` (~50ms) the worker
    ships compact DELTA records over the dedicated obs ring:

    * O_PHASE — per-phase ns + histogram bucket/sum/count deltas (max is
      absolute, merged with max() on the owner), only for phases that
      changed;
    * O_REC — recorder events newer than the last ship, as the same
      formatted JSON the /debugz dump uses;
    * O_TRACE — buffered TxTrace stage stamps with their mono timestamp;
    * O_FOLD — folded-stack increments (the sampler tree is reset after
      each ship, so records are additive).

    ``put`` never blocks: a full obs ring sheds the record and the drop
    lands in the ring's producer-side counter, which the owner exports
    as ``obs_records_dropped``. Observability loss is survivable and
    accounted; it never backpressures the protocol.
    """

    def __init__(self, spec: "WorkerSpec", ring) -> None:
        from ..obs.profiler import (
            PHASE_BOUNDS,
            PHASES,
            PhaseAccounting,
            StackSampler,
        )
        from ..obs.recorder import FlightRecorder
        from ..obs.registry import Registry

        self._ring = ring
        self._phase_names = PHASES
        self._nb = len(PHASE_BOUNDS) + 1
        self._buckets = struct.Struct(f"<{self._nb}I")
        self.registry = Registry()
        self.phases = (
            PhaseAccounting(self.registry) if spec.phase_accounting else None
        )
        self.recorder = (
            FlightRecorder(cap=spec.recorder_cap)
            if spec.recorder_cap
            else None
        )
        self.trace = (
            _WorkerTrace(spec.trace_sample) if spec.trace_sample else None
        )
        self.sampler = StackSampler(
            hz=spec.profiler_hz, max_nodes=spec.profiler_max_nodes
        )
        self._last_phase: dict = {}
        self._rec_seen = 0
        self._flush_s = max(0.005, spec.obs_flush_s)
        self._next_flush = time.monotonic() + self._flush_s

    def handle_prof(self, payload: bytes) -> None:
        start, duration = _prof.unpack(payload)
        if start:
            self.sampler.reset()
            self.sampler.start(duration if duration > 0 else None)
        else:
            self.sampler.stop()
            self._ship_fold()

    def maybe_flush(self) -> None:
        now = time.monotonic()
        if now < self._next_flush:
            return
        self._next_flush = now + self._flush_s
        self.flush()

    def flush(self) -> None:
        self._ship_phases()
        self._ship_recorder()
        self._ship_trace()
        self._ship_fold()

    def _ship_phases(self) -> None:
        ph = self.phases
        if ph is None:
            return
        parts = []
        for idx, name in enumerate(self._phase_names):
            ns = ph._counters[name].value
            counts, total, count, mx = ph._hists[name].raw()
            last = self._last_phase.get(name)
            if last is None:
                last = (0, [0] * self._nb, 0.0, 0, 0.0)
            lns, lcounts, lsum, lcount, lmax = last
            if ns == lns and count == lcount and mx == lmax:
                continue
            deltas = [a - b for a, b in zip(counts, lcounts)]
            parts.append(
                _ophase.pack(idx, ns - lns, count - lcount, total - lsum, mx)
                + self._buckets.pack(*deltas)
            )
            self._last_phase[name] = (ns, counts, total, count, mx)
        if parts:
            self._ring.put(O_PHASE, b"".join(parts))

    def _ship_recorder(self) -> None:
        rec = self.recorder
        if rec is None:
            return
        events, self._rec_seen = rec.events_since(self._rec_seen)
        if events:
            self._ring.put(O_REC, json.dumps(events).encode())

    def _ship_trace(self) -> None:
        tr = self.trace
        if tr is None or not tr.buf:
            return
        buf, tr.buf = tr.buf, []
        # chunked so one full ring sheds hundreds of stamps, not all 8k
        for i in range(0, len(buf), 512):
            self._ring.put(
                O_TRACE,
                b"".join(_otrace.pack(*stamp) for stamp in buf[i : i + 512]),
            )

    def _ship_fold(self) -> None:
        samples = self.sampler.stats()["samples"]
        if not samples:
            return
        folded = self.sampler.folded()
        self.sampler.reset()
        self._ring.put(O_FOLD, _u64.pack(samples) + folded.encode())


def _flush_state(core, effects, last) -> None:
    """Ship observable-state DIFFS to the owner: counter deltas (the
    owner's group is the plane-wide aggregate), watermark bumps (merged
    with max on the owner; monotone either way), and the gauge pair."""
    vals = [int(core.stats[k]) for k in STAT_KEYS]
    if vals != last["stats"]:
        deltas = [v - o for v, o in zip(vals, last["stats"])]
        effects.put(E_STATS, b"".join(_u64.pack(max(0, d)) for d in deltas))
        last["stats"] = vals
    for tag, wm, seen in (
        (0, core._wm_tx, last["wm_tx"]),
        (1, core._wm_batch, last["wm_batch"]),
    ):
        for key, seq in wm.items():
            if seen.get(key) != seq:
                effects.put(E_WM, bytes([tag]) + key + _u64.pack(seq))
                seen[key] = seq
    info = (core._undelivered, core.floor_refusals)
    if info != last["info"]:
        effects.put(
            E_INFO, _info.pack(max(0, core._undelivered), core.floor_refusals)
        )
        last["info"] = info


def worker_main(spec: WorkerSpec) -> None:
    """Spawn entry point: build this shard's core, then drain the
    actions ring forever (parse -> admission pre-checks -> bulk verify
    -> state transitions -> effect records), exactly the three-stage
    pipeline the owner loop runs, minus everything cross-shard."""
    from ..broadcast.messages import WireError, parse_frame
    from ..broadcast.stack import Broadcast
    from ..crypto.keys import SignKeyPair, verify_one
    from ..native.ingest import ingest_available, verify_bulk_native
    from ..net.peers import Peer
    from .ring import ShmRing

    actions_ring = ShmRing(spec.actions_ring)
    effects = ShmRing(spec.effects_ring)
    # protocol effects are never dropped: the owner drains them on its own
    # clock, and a dropped delivery would stall its sender for good, so
    # what does not fit waits in this process's backlog
    effects.spill = True
    obs = None
    obs_ring = None
    if spec.obs_ring:
        obs_ring = ShmRing(spec.obs_ring)
        obs = _WorkerObs(spec, obs_ring)
    peers = [
        Peer(address=a, exchange_public=x, sign_public=s, region=r)
        for a, x, s, r in spec.peers
    ]
    mesh = _ProcMesh(peers, effects)
    core = Broadcast(
        SignKeyPair(spec.sign_seed),
        mesh,
        None,  # verifier unused: this loop verifies, not _process_chunk
        echo_threshold=spec.echo_threshold,
        ready_threshold=spec.ready_threshold,
        workers=0,
        overlap_ready=spec.overlap_ready,
        registry=obs.registry if obs is not None else None,
        trace=obs.trace if obs is not None else None,
        recorder=obs.recorder if obs is not None else None,
        phases=obs.phases if obs is not None else None,
    )
    core.delivered = _ProcDelivered(effects)
    core.stall_handler = lambda: effects.put(E_STALL, b"")
    # .so already compiled by the owner's start(); this is a cached load
    native = ingest_available()

    last = {
        "stats": [0] * len(STAT_KEYS),
        "wm_tx": {},
        "wm_batch": {},
        "info": (0, 0),
    }
    idle = 0.0002
    stop = False
    ph = obs.phases if obs is not None else None
    while not stop:
        if os.getppid() != spec.parent_pid:
            break  # orphaned: the owner died without a clean shutdown
        spilled = not effects.flush()
        recs, _ = actions_ring.drain()
        if not recs:
            if obs is not None:
                obs.maybe_flush()
            time.sleep(idle)
            idle = 0.0002 if spilled else min(idle * 2.0, 0.002)
            continue
        idle = 0.0002
        # plane_total in a worker wraps the whole drain cycle (parse +
        # verify + apply + state flush) — the worker-side twin of the
        # owner-loop span, shipped as phase_plane_total_shardN_ns
        t_plane = ph.begin_plane() if ph is not None else -1
        t0 = ph.t() if ph is not None else 0
        to_verify: list = []
        acts: list = []
        for kind, payload in recs:
            if kind == C_MSG:
                peer = mesh.by_sign.get(payload[:32])
                try:
                    msgs = parse_frame(payload[32:])
                except WireError:
                    continue  # owner routed it, so it parsed there; defensive
                for msg in msgs:
                    core._pre_msg(peer, msg, to_verify, acts)
            elif kind == C_GC:
                core._gc_pass(struct.unpack("<d", payload)[0])
                if ph is not None:
                    t0 = ph.t()  # keep the GC sweep out of rx_decode
            elif kind == C_THRESH:
                core.echo_threshold, core.ready_threshold = struct.unpack(
                    "<II", payload
                )
            elif kind == C_WM_RESTORE:
                core.restore_watermarks(json.loads(payload.decode()))
            elif kind == C_RELEASE:
                for off in range(0, len(payload) - 39, 40):
                    core.release_entry(
                        payload[off : off + 32],
                        _u64.unpack_from(payload, off + 32)[0],
                    )
            elif kind == C_PROF:
                if obs is not None:
                    obs.handle_prof(payload)
            elif kind == C_EXIT:  # tests: simulate a crash mid-campaign
                os._exit(payload[0] if payload else 42)
            elif kind == C_SHUTDOWN:
                stop = True
        if ph is not None:
            t0 = ph.add("rx_decode", t0)
        if to_verify:
            if native:
                results = verify_bulk_native(to_verify, 1)
            else:
                results = [verify_one(pk, m, s) for pk, m, s in to_verify]
            if ph is not None:
                t0 = ph.add("verify_wait", t0)
            core._apply_actions(acts, results)
        _flush_state(core, effects, last)
        if ph is not None:
            ph.end_plane(t_plane)
        if obs is not None:
            obs.maybe_flush()
    _flush_state(core, effects, last)
    if obs is not None:
        obs.sampler.stop()
        obs.flush()
    actions_ring.close()
    effects.close()
    if obs_ring is not None:
        obs_ring.close()

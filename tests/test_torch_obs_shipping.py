"""The obs shipping lane's records: the port's twin of
``tests/test_obs_shipping.py``'s ``TestObsRecordsOverRing``.

A shard worker's slice of the diagnosis tier (``parallel/plane_worker.py``
``_WorkerObs``) ships delta records over a ``/dev/shm`` ring, and the
owner (``broadcast/shards.py`` ``ShardedPlane._apply_obs_record``) folds
them into the registry every surface reads. Each case runs the
reference's steps on the port's modules, and holds the port against
the JAX package both ways: the records one package's worker ships are
folded by both packages' owners into the same counters, histograms,
recorder events, trace stamps and folded stacks; and both packages'
workers ship the same phase records for the same marks. Every key is
seeded with numpy; every comparison is exact.
"""

import importlib
import itertools
import os
import struct
from types import SimpleNamespace

import numpy as np

PACKAGES = ("at2_node_tpu_torch", "at2_node_tpu")
PORT, REF = PACKAGES
_ring_ids = itertools.count()


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _obs_spec(**kw):
    """The WorkerSpec fields ``_WorkerObs`` reads."""
    base = dict(recorder_cap=256, trace_sample=1, phase_accounting=True, profiler_hz=97.0,
                profiler_max_nodes=1000, obs_flush_s=0.005)
    base.update(kw)
    return SimpleNamespace(**base)


def _owner_plane(pkg: str, shards: int = 1):
    """An inline ShardedPlane of ``pkg`` with the owner's obs kit, and
    its registry: the fold is pure in (sid, kind, payload)."""
    prof, reg_mod = _mod(pkg, "obs.profiler"), _mod(pkg, "obs.registry")
    reg = reg_mod.Registry()
    key = _mod(pkg, "crypto.keys").SignKeyPair(np.random.default_rng(17).bytes(32))
    plane = _mod(pkg, "broadcast.shards").ShardedPlane(
        key, SimpleNamespace(peers=[], by_sign={}), None, shards=shards, executor="inline", registry=reg,
        phases=prof.PhaseAccounting(reg), trace=_mod(pkg, "obs.trace").TxTrace(reg, sample_every=1),
        recorder=_mod(pkg, "obs.recorder").FlightRecorder(cap=256))
    return plane, reg


def _ring(pkg: str, slots: int = 256, slot_bytes: int = 1024):
    return _mod(pkg, "parallel.ring").ShmRing(f"at2obs-twin-{os.getpid()}-{next(_ring_ids)}", slots=slots,
                                              slot_bytes=slot_bytes, create=True)


def _worker(pkg: str, ring, **kw):
    return _mod(pkg, "parallel.plane_worker")._WorkerObs(_obs_spec(**kw), ring)


def _fold(pkg: str, records: list, shards: int = 1, sid: int = 0):
    """``records`` (kind, payload) folded by a fresh owner plane of ``pkg``."""
    plane, reg = _owner_plane(pkg, shards)
    for kind, payload in records:
        plane._apply_obs_record(sid, kind, payload)
    return plane, reg


def _phase_view(pkg: str, reg) -> dict:
    """Every phase counter and histogram of ``reg``."""
    prof = _mod(pkg, "obs.profiler")
    snap = reg.snapshot()
    out = {k: v for k, v in snap.items() if k.startswith("phase_") and k.endswith("_ns")}
    for p in prof.PHASES:
        counts, total_s, count, mx = reg.histogram(f"phase_{p}", bounds=prof.PHASE_BOUNDS).raw()
        out[f"hist_{p}"] = (list(counts), total_s, count, mx)
    return out


def _both_folds(records: list, shards: int = 1, sid: int = 0) -> tuple:
    """``records`` folded by each package's owner: (port plane, port
    registry); the phase views and worker events of both are equal."""
    (plane, reg), (rplane, rreg) = (_fold(pkg, records, shards, sid) for pkg in PACKAGES)
    assert _phase_view(PORT, reg) == _phase_view(REF, rreg)
    assert plane.worker_events() == rplane.worker_events()
    assert plane.worker_folds() == rplane.worker_folds()
    assert plane.worker_fold_samples() == rplane.worker_fold_samples()
    return plane, reg


def _ship(pkg: str, marks, **kw) -> list:
    """``marks(obs)`` on a fresh worker of ``pkg``, then the records its
    flushes put on the ring."""
    ring = _ring(pkg)
    try:
        obs = _worker(pkg, ring, **kw)
        marks(obs)
        return ring.drain()[0]
    finally:
        ring.close()


class TestObsRecordsOverRing:
    def test_phase_fold_matches_worker_numbers(self):
        """After the fold the base leaf counters and the shardN counters
        carry exactly the ns the worker accounted, histograms merge count
        and sum exactly, and plane_total lands only under shardN."""
        leaves = _mod(PORT, "obs.profiler").PLANE_LEAF_PHASES
        assert leaves == _mod(REF, "obs.profiler").PLANE_LEAF_PHASES
        ns = np.random.default_rng(21).integers(1, 10**8, size=len(leaves) + 2)
        marks = {p: int(n) for p, n in zip(leaves, ns)}

        def mark(obs):
            for p, n in marks.items():
                obs.phases.add_ns(p, n)
            obs.phases.add_ns("plane_total", int(ns[-2]))
            obs.phases.add_ns("slot_gc", int(ns[-1]))
            obs.flush()

        records = {pkg: _ship(pkg, mark) for pkg in PACKAGES}
        phase_kind = _mod(PORT, "parallel.plane_worker").O_PHASE
        assert [r for r in records[PORT] if r[0] == phase_kind] == \
            [r for r in records[REF] if r[0] == phase_kind]
        for src in PACKAGES:
            _, reg = _both_folds(records[src])
            prof = _mod(PORT, "obs.profiler")
            for p, n in marks.items():
                assert reg.counter(f"phase_{p}_ns").value == n
                assert reg.counter(f"phase_{p}_shard0_ns").value == n
                counts, total_s, count, _ = reg.histogram(f"phase_{p}", bounds=prof.PHASE_BOUNDS).raw()
                assert count == 1 and sum(counts) == 1 and abs(total_s - n * 1e-9) < 1e-12
            # slot_gc is not a plane leaf: base only
            assert reg.counter("phase_slot_gc_ns").value == int(ns[-1])
            assert "phase_slot_gc_shard0_ns" not in reg.snapshot()
            # plane_total: shardN only
            assert reg.counter("phase_plane_total_ns").value == 0
            assert reg.counter("phase_plane_total_shard0_ns").value == int(ns[-2])

    def test_second_flush_ships_only_deltas(self):
        seen = {}
        for pkg in PACKAGES:
            ring = _ring(pkg)
            try:
                obs = _worker(pkg, ring)
                obs.phases.add_ns("verify_wait", 5_000_000)
                obs.flush()
                first = ring.drain()[0]
                obs.phases.add_ns("verify_wait", 3_000_000)
                obs.flush()
                second = ring.drain()[0]
                obs.flush()  # an idle flush ships no phase record
                idle = [k for k, _ in ring.drain()[0] if k == _mod(pkg, "parallel.plane_worker").O_PHASE]
            finally:
                ring.close()
            assert idle == []
            seen[pkg] = (first, second)
        assert seen[PORT] == seen[REF]
        for src in PACKAGES:
            _, reg = _both_folds(seen[src][0] + seen[src][1])
            assert reg.counter("phase_verify_wait_ns").value == 8_000_000
            assert reg.counter("phase_verify_wait_shard0_ns").value == 8_000_000
            bounds = _mod(PORT, "obs.profiler").PHASE_BOUNDS
            assert reg.histogram("phase_verify_wait", bounds=bounds).raw()[2] == 2

    def test_recorder_events_survive_with_shard_prefix(self):
        for pkg in PACKAGES:
            ring = _ring(pkg)
            try:
                obs = _worker(pkg, ring)
                obs.recorder.record("echo", (7,))
                obs.recorder.record("ready_quorum", (7,))
                obs.flush()
                first = ring.drain()[0]
                obs.recorder.record("stall_kick", ())  # only new events ship next
                obs.flush()
                second = ring.drain()[0]
            finally:
                ring.close()
            plane, _ = _both_folds(first, shards=2, sid=1)
            events = plane.worker_events()
            assert [e[1] for e in events] == ["shard1/echo", "shard1/ready_quorum"]
            assert events == sorted(events, key=lambda e: e[0])
            plane, _ = _both_folds(first + second, shards=2, sid=1)
            assert [e[1] for e in plane.worker_events()] == [
                "shard1/echo", "shard1/ready_quorum", "shard1/stall_kick"]

    def test_trace_stamps_replay_on_owner_tracer(self):
        """A worker's stage stamp becomes a record in the owner's TxTrace
        at the worker's mono timestamp, in both packages' owners."""
        sender = np.random.default_rng(22).bytes(32)

        def mark(obs):
            obs.trace.stamp((sender, 3), "delivered", now=123.25)
            obs.flush()

        records = {pkg: _ship(pkg, mark) for pkg in PACKAGES}
        assert records[PORT] == records[REF]
        stamps = []
        for pkg in PACKAGES:
            plane, _ = _fold(pkg, records[PORT])
            rec = plane.trace._live.get((sender, 3))
            assert rec is not None
            stamps.append(sorted((s, m) for s, m, _w in rec[3]))
        assert stamps[0] == stamps[1] and ("delivered", 123.25) in stamps[0]

    def test_trace_lottery_matches_owner_sampling(self):
        """At sample_every = 4 a worker keeps exactly the stamps the
        owner's keyed lottery keeps, in both packages."""
        kept = {}
        rng = np.random.default_rng(23)
        senders = [rng.bytes(32) for _ in range(7)]
        for pkg in PACKAGES:
            obs = _worker(pkg, None, trace_sample=4)
            for seq in range(32):
                obs.trace.stamp((senders[seq % 7], seq), "echoed", now=1.0)
            kept[pkg] = [(sender, seq) for sender, seq, _idx, _mono in obs.trace.buf]
            assert kept[pkg] and {(s[0] + q) % 4 for s, q in kept[pkg]} == {0}
        assert kept[PORT] == kept[REF]

    def test_ring_wrap_drops_counted_not_fatal(self):
        """A tiny obs ring under a burst sheds records into the drop
        counter; everything that did ship folds cleanly in both owners."""
        for pkg in PACKAGES:
            ring = _ring(pkg, slots=8, slot_bytes=256)
            try:
                obs = _worker(pkg, ring)
                for i in range(64):
                    obs.recorder.record("echo", (i, "x" * 40))
                    obs.flush()
                assert ring.dropped > 0
                records = ring.drain()[0]
            finally:
                ring.close()
            assert records
            plane, _ = _both_folds(records)
            assert plane.worker_events()

    def test_unknown_phase_idx_is_shed(self):
        """A phase index this owner does not know is shed, not folded,
        by both owners."""
        pw = _mod(PORT, "parallel.plane_worker")
        nb = len(_mod(PORT, "obs.profiler").PHASE_BOUNDS) + 1
        payload = pw._ophase.pack(250, 1_000_000, 1, 0.001, 0.001)
        payload += struct.pack(f"<{nb}I", *([1] + [0] * (nb - 1)))
        for pkg in PACKAGES:
            _, reg = _fold(pkg, [(pw.O_PHASE, payload)])
            assert not any(v for k, v in reg.snapshot().items() if k.startswith("phase_") and k.endswith("_ns"))

    def test_fold_records_accumulate_samples(self):
        """O_FOLD records add up: stacks sum, samples sum."""
        pw = _mod(PORT, "parallel.plane_worker")
        assert pw.O_FOLD == _mod(REF, "parallel.plane_worker").O_FOLD
        payload = (5).to_bytes(8, "little") + b"a;b 3\nc 2"
        plane, _ = _both_folds([(pw.O_FOLD, payload)] * 2)
        assert plane.worker_fold_samples() == 10
        assert dict(plane.worker_folds())["shard0/"] == {"a;b": 6, "c": 4}

"""The port's sharded broadcast plane against the JAX package's:
``broadcast/shards.py``, ``parallel/plane.py``, ``plane_worker.py``,
``ring.py`` and the fused owner drain of ``native/ingest.py``.

* ``shard_of`` equals the reference's for 1-8 shards on seeded keys;
* ``ShmRing``: round trip across the wrap, full-ring drop accounting,
  stale-segment reclaim, and a ring written by one package read by the
  other's (the byte layout is the reference's);
* ``plane_drain_native`` gives the reference's items, frame verdicts and
  per-shard counts on seeded frames;
* the worker's wire vocabulary (``STAT_KEYS``, record kinds, record
  layouts) equals the reference's;
* the same scripted messages through the reference's ``ShardedPlane`` and
  the port's (``inline``) give the same deliveries and frames at 1, 2 and
  4 shards; ``inline`` sends the monolithic plane's frames in its order at
  1 and 4 shards; ``thread`` delivers what ``inline`` does;
* port ``Service`` nets on the ``process`` executor deliver, a killed
  worker degrades ``/healthz`` with shard attribution, and the workers'
  observability crosses the process boundary;
* a shard worker's imports leave torch out.

Every key is seeded with numpy; every comparison is exact."""

import asyncio
import os
import struct
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from at2_node_tpu.broadcast import shards as ref_shards
from at2_node_tpu.native import ingest as ref_ingest
from at2_node_tpu.parallel import plane_worker as ref_pw
from at2_node_tpu.parallel import ring as ref_ring
from at2_node_tpu_torch.broadcast import messages as port_msgs
from at2_node_tpu_torch.broadcast import shards as port_shards
from at2_node_tpu_torch.broadcast.stack import Broadcast
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.native import ingest as port_ingest
from at2_node_tpu_torch.node.config import PlaneConfig, VerifierConfig
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.parallel import plane as port_plane
from at2_node_tpu_torch.parallel import plane_worker as port_pw
from at2_node_tpu_torch.parallel import ring as port_ring
from at2_node_tpu_torch.tools._common import make_net_configs
from at2_node_tpu_torch.types import ThinTransaction

from test_torch_broadcast import Net, _scripted_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60.0


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return [SignKeyPair(rng.bytes(32)) for _ in range(n)]


def _spread_keys(seed, n, shards=2):
    """``n`` seeded keys that land on every one of ``shards`` shards."""
    keys = _keys(seed, n)
    assert {port_shards.shard_of(k.public, shards) for k in keys} == set(range(shards))
    return keys


# -- routing --------------------------------------------------------------


@pytest.mark.parametrize("shards", range(1, 9))
def test_shard_of_equals_reference(shards):
    rng = np.random.default_rng(shards)
    keys = [rng.bytes(32) for _ in range(256)]
    port = [port_shards.shard_of(k, shards) for k in keys]
    assert port == [ref_shards.shard_of(k, shards) for k in keys]
    assert set(port) == set(range(shards))


def test_plane_config_and_zero_shards_refused():
    assert PlaneConfig().shards == 1
    with pytest.raises(ValueError):
        PlaneConfig(shards=0)
    with pytest.raises(ValueError):
        PlaneConfig(shards=2, executor="fork")
    with pytest.raises(ValueError):
        port_shards.ShardedPlane(SignKeyPair(bytes(32)), None, None, shards=0)
    with pytest.raises(ValueError):
        port_plane.make_plane_executor("fork", 2)


# -- the shared-memory ring -------------------------------------------------

RINGS = {"port": port_ring.ShmRing, "ref": ref_ring.ShmRing}


def _ring_name(tag):
    return f"at2t-{os.getpid()}-{tag}"


def test_ring_roundtrip_and_wrap_preserves_order():
    ring = port_ring.ShmRing(_ring_name("wrap"), slots=16, slot_bytes=32, create=True)
    try:
        rng = np.random.default_rng(5)
        # far more traffic than the ring holds: every record crosses the
        # wrap many times, sizes span one slot to several
        for batch in range(100):
            sent = []
            for i in range(int(rng.integers(1, 4))):
                payload = rng.bytes(int(rng.integers(0, 40)))
                kind = 1 + (batch + i) % 7
                assert ring.put(kind, payload)
                sent.append((kind, payload))
            got, worst = ring.drain()
            assert got == sent
            assert worst >= 0
        assert ring.dropped == 0
    finally:
        ring.close()


def test_ring_full_drops_with_producer_accounting():
    ring = port_ring.ShmRing(_ring_name("full"), slots=4, slot_bytes=32, create=True)
    try:
        # each 20-byte payload takes ceil((16 + 20) / 32) = 2 slots
        assert ring.put(1, b"x" * 20) and ring.put(2, b"y" * 20)
        assert len(ring) == 4
        assert not ring.put(3, b"z" * 20)  # refused, never blocking or overwriting
        assert not ring.put(3, b"z" * 20)
        assert not ring.put(4, b"w" * 4096)  # larger than the whole ring
        assert ring.dropped == 3
        got, _ = ring.drain()
        assert [k for k, _ in got] == [1, 2]
        assert ring.put(5, b"q" * 20)
        assert ring.drain()[0] == [(5, b"q" * 20)]
        assert ring.dropped == 3
    finally:
        ring.close()


def test_ring_stale_segment_reclaimed_on_create():
    name = _ring_name("stale")
    dead = port_ring.ShmRing(name, slots=8, slot_bytes=32, create=True)
    dead.put(1, b"predecessor state")
    dead._owner = False  # an owner that died without unlinking
    dead.close()
    reborn = port_ring.ShmRing(name, slots=8, slot_bytes=32, create=True)
    try:
        assert len(reborn) == 0 and reborn.drain() == ([], 0)
        assert reborn.put(2, b"fresh")
        assert reborn.drain()[0] == [(2, b"fresh")]
    finally:
        reborn.close()


def test_ring_producer_waits_for_room_when_asked():
    """``spill``: a record that does not fit waits in the producer's
    backlog and reaches the ring in order as the consumer makes room (a
    backlog head that belongs at the ring start publishes the wrap pad
    alone); a record larger than the ring still drops, and
    ``stop_spilling`` drops the backlog with accounting."""
    ring = port_ring.ShmRing(_ring_name("wait"), slots=4, slot_bytes=32, create=True)
    try:
        ring.spill = True
        for kind in (1, 2, 3, 4):  # two slots each: 3 and 4 wait
            assert ring.put(kind, b"x" * 20)
        assert ring.backlog == 2 and ring.spilled == 2 and ring.dropped == 0
        assert [k for k, _ in ring.drain()[0]] == [1, 2]
        assert ring.put(5, b"y" * 20)  # behind the backlog, not before it
        assert [k for k, _ in ring.drain()[0]] == [3, 4]
        assert ring.flush() and ring.backlog == 0
        assert ring.drain()[0] == [(5, b"y" * 20)]
        # head at slot 2: a four-slot record needs the ring start
        assert ring.put(6, b"z" * 100) and ring.backlog == 1
        assert ring.head % 4 == 0 and ring.drain()[0] == []  # the pad alone
        assert ring.flush() and ring.drain()[0] == [(6, b"z" * 100)]
        assert not ring.put(7, b"w" * 200) and ring.dropped == 1  # larger than the ring
        for kind in (8, 9, 10):
            assert ring.put(kind, b"v" * 20)
        ring.stop_spilling()
        assert ring.backlog == 0 and ring.dropped == 2
        assert not ring.put(11, b"u" * 20) and ring.dropped == 3
        assert [k for k, _ in ring.drain()[0]] == [8, 9]
    finally:
        ring.close()


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_ring_written_by_one_package_reads_in_the_other(writer, reader):
    rng = np.random.default_rng(11)
    name = _ring_name(f"x-{writer}")
    owner = RINGS[writer](name, slots=32, slot_bytes=64, create=True)
    peer = RINGS[reader](name)
    try:
        sent = [(1 + i % 9, rng.bytes(int(rng.integers(0, 150)))) for i in range(12)]
        for kind, payload in sent:
            assert owner.put(kind, payload)
        got, _ = peer.drain()
        assert got == sent
        # and back: the reader's puts drain on the writer's side
        for kind, payload in sent[:5]:
            assert peer.put(kind, payload)
        assert owner.drain()[0] == sent[:5]
        assert owner.dropped == peer.dropped == 0
    finally:
        peer.close()
        owner.close()


# -- the fused owner drain ----------------------------------------------------


def _mixed_frames(rng, m, n=64):
    """Payloads, Echo/Ready attestations and content requests of four
    seeded senders, which land on both of two shards."""
    senders = [SignKeyPair(rng.bytes(32)) for _ in range(4)]
    assert {port_shards.shard_of(s.public, 2) for s in senders} == {0, 1}
    origin = SignKeyPair(rng.bytes(32))
    frames = []
    for i in range(n):
        pick = int(rng.integers(0, 3))
        sender = senders[i % 4]
        if pick == 0:
            msg = m.Payload.create(sender, i + 1, ThinTransaction(b"r" * 32, 10))
        elif pick == 1:
            phase = m.ECHO if i % 2 else m.READY
            chash = rng.bytes(32)
            sig = origin.sign(m.Attestation.signing_bytes(phase, sender.public, i + 1, chash))
            msg = m.Attestation(phase, origin.public, sender.public, i + 1, chash, sig)
        else:
            msg = m.ContentRequest(sender.public, i + 1, rng.bytes(32))
        frames.append(msg.encode())
    # one malformed frame: both drains must refuse it alike
    frames.insert(7, frames[3][:-5])
    return frames


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_plane_drain_native_equals_reference(shards):
    if not (port_ingest.ingest_available() and ref_ingest.ingest_available()):
        pytest.skip("the native ingest library did not build on this host")
    frames = _mixed_frames(np.random.default_rng(27), port_msgs)
    items, ok, counts = port_ingest.plane_drain_native(frames, shards)
    r_items, r_ok, r_counts = ref_ingest.plane_drain_native(frames, shards)
    assert list(ok) == list(r_ok) and not ok[7] and ok.sum() == len(frames) - 1
    assert list(counts) == list(r_counts)
    assert [(f, s, type(x).__name__, x.encode()) for f, s, x in items] == \
        [(f, s, type(x).__name__, x.encode()) for f, s, x in r_items]
    for fidx, sid, msg in items:
        assert sid == port_shards.shard_of(msg.sender, shards)
    if shards > 1:
        assert sum(1 for c in counts if c) > 1, "routing collapsed onto one shard"
    wires = port_ingest.plane_drain_native(frames, shards, want_objects=False)
    r_wires = ref_ingest.plane_drain_native(frames, shards, want_objects=False)
    assert wires[0] == r_wires[0]
    for fidx, sid, kind, wire in wires[0]:
        assert wire == frames[fidx] and wire[0] == kind


# -- the worker's wire vocabulary ---------------------------------------------


def test_worker_records_equal_reference():
    assert port_pw.STAT_KEYS == ref_pw.STAT_KEYS
    assert len(set(port_pw.STAT_KEYS)) == len(port_pw.STAT_KEYS)
    assert port_pw.TRACE_STAGES == ref_pw.TRACE_STAGES
    kinds = [k for k in dir(ref_pw) if k[:2] in ("C_", "E_", "O_") and k[2:].isupper()]
    assert len(kinds) == 19
    assert {k: getattr(port_pw, k) for k in kinds} == {k: getattr(ref_pw, k) for k in kinds}
    for name in ("_u64", "_info", "_prof", "_ophase", "_otrace"):
        assert getattr(port_pw, name).format == getattr(ref_pw, name).format
    assert port_pw._LOCAL_SENTINEL == ref_pw._LOCAL_SENTINEL
    assert [f.name for f in port_pw.WorkerSpec.__dataclass_fields__.values()] == \
        [f.name for f in ref_pw.WorkerSpec.__dataclass_fields__.values()]
    # the keys name counters of both counter groups
    kp = SignKeyPair(bytes(32))
    mesh = type("Mesh", (), {"peers": [], "by_sign": {}})()
    plane = port_shards.ShardedPlane(kp, mesh, None, shards=2, executor="inline")
    core = Broadcast(kp, mesh, None, workers=0)
    for key in port_pw.STAT_KEYS:
        plane.stats[key], core.stats[key]  # KeyError on drift


def test_worker_flush_state_records_decode_on_the_owner():
    """``_flush_state`` ships counter deltas, watermarks and the gauge pair
    in records the owner's ``_flush_proc_effects`` folds back."""

    class Ring:
        def __init__(self):
            self.recs = []

        def put(self, kind, payload):
            self.recs.append((kind, bytes(payload)))
            return True

    kp, other = _keys(3, 2)
    mesh = type("Mesh", (), {"peers": [], "by_sign": {}})()
    core = Broadcast(kp, mesh, None, workers=0)
    core.stats["echo_rx"] += 5
    core.stats["delivered"] += 2
    core._wm_tx[other.public] = 9
    ring = Ring()
    last = {"stats": [0] * len(port_pw.STAT_KEYS), "wm_tx": {}, "wm_batch": {}, "info": (0, 0)}
    port_pw._flush_state(core, ring, last)
    kinds = [k for k, _ in ring.recs]
    assert kinds.count(port_pw.E_STATS) == 1 and kinds.count(port_pw.E_WM) == 1
    stats = dict(ring.recs)[port_pw.E_STATS]
    deltas = dict(zip(port_pw.STAT_KEYS, struct.unpack(f"<{len(port_pw.STAT_KEYS)}Q", stats)))
    assert deltas["echo_rx"] == 5 and deltas["delivered"] == 2
    assert dict(ring.recs)[port_pw.E_WM] == b"\x00" + other.public + struct.pack("<Q", 9)
    ring.recs.clear()
    port_pw._flush_state(core, ring, last)  # nothing changed: nothing shipped
    assert ring.recs == []


# -- differential runs ---------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4])
async def test_sharded_plane_same_messages_as_reference(shards):
    ref = await _scripted_run("ref", 3, shards=shards)
    port = await _scripted_run("port", 3, shards=shards)
    assert len(port["delivered"]) == 14
    for key in ("delivered", "sent_in_order", "unicast", "stats"):
        assert port[key] == ref[key], key


async def test_inline_shards_are_wire_identical_to_the_monolithic_plane():
    mono = await _scripted_run("port", 4)
    one = await _scripted_run("port", 4, shards=1)
    four = await _scripted_run("port", 4, shards=4)
    assert len(mono["sent_in_order"]) > 20
    assert four["sent_in_order"] == one["sent_in_order"] == mono["sent_in_order"]
    for key in ("delivered", "unicast", "stats"):
        assert four[key] == one[key] == mono[key], key


async def test_thread_executor_delivers_what_inline_does():
    inline = await _scripted_run("port", 5, shards=2)
    thread = await _scripted_run("port", 5, shards=2, executor="thread")
    assert thread["delivered"] == inline["delivered"]
    assert thread["sent"] == inline["sent"]


async def test_thread_gc_pass_takes_turns_with_the_drain_cycle(monkeypatch):
    """Thread mode: the owner runs stage 1 (``_pre_msg``) on a core that
    its shard thread also GC-passes; the two never run at once."""
    import threading
    import time

    monkeypatch.setattr(port_shards, "GC_INTERVAL", 0.005)
    net = Net("port", 3, seed=43, shards=2, executor="thread")
    in_gc = threading.Event()
    seen = []
    async with net:
        for core in net.bcast._cores:
            def gc_pass(now, gc=core._gc_pass):
                in_gc.set()
                time.sleep(0.01)
                gc(now)
                in_gc.clear()

            def pre_msg(*args, pre=core._pre_msg):
                seen.append(in_gc.is_set())
                return pre(*args)

            core._gc_pass, core._pre_msg = gc_pass, pre_msg
        for _ in range(40):
            await net.inject(net.payload(net.client()))
            await asyncio.sleep(0.003)
        await net.settle()
    assert len(seen) == 40 and not any(seen)


async def _large_drain_cycle(impl):
    """17 batches of 256 entries from one peer origin reach their Ready
    quorum in one drain cycle; returns the deliveries and the plane's
    handoff drops."""
    net = Net(impl, 3, seed=41, shards=2, executor="thread")
    m = net.x.m
    n_batches = 17

    async def own(phase):
        """Wait until the node has sent its own attestation of this phase
        on every batch (it has verified them all)."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + TIMEOUT
        while sum(isinstance(x, m.BatchAttestation) and x.phase == phase
                  for x in net.sent_messages()) < n_batches:
            assert loop.time() < deadline, f"the node never attested phase {phase}"
            await asyncio.sleep(0.05)

    async with net:
        clients = [net.client() for _ in range(n_batches * 256)]
        batches = []
        for b in range(n_batches):
            entries = [net.payload(clients[256 * b + i], amount=1) for i in range(256)]
            batch = m.TxBatch.create(net.peer_keys[0], b + 1, b"".join(p.encode()[1:] for p in entries))
            batches.append(batch)
            await net.inject(batch, peer=net.mesh.peers[0])
        await own(m.BATCH_ECHO)
        for phase in (m.BATCH_ECHO, m.BATCH_READY):
            # queued without a yield: the owner drains them as one chunk
            for kp in net.peer_keys:
                for batch in batches:
                    await net.inject(net.batch_vote(kp, batch, phase, (1 << 256) - 1))
            if phase == m.BATCH_ECHO:
                await own(m.BATCH_READY)
        # every entry delivered on the shard core, and each delivery either
        # handed to the owner's queue or dropped at the lane
        total = n_batches * 256
        await _wait(lambda: net.bcast.stats["batch_entries_delivered"] == total
                    and net.bcast.delivered.qsize() + net.bcast.effects_dropped == total,
                    "the batches deliver")
        return net.bcast.delivered.qsize(), net.bcast.effects_dropped


async def test_thread_lanes_keep_every_delivery_of_a_large_drain_cycle():
    """4,352 deliveries from one shard thread in one drain cycle: the
    port's thread lanes keep them all; the reference's 4,096-item lane
    drops the overflow, and a lost delivery stalls its sender for good."""
    assert await _large_drain_cycle("port") == (17 * 256, 0)
    delivered, dropped = await _large_drain_cycle("ref")
    assert dropped == 17 * 256 - 4096 and delivered == 4096


async def test_thread_shards_bumping_one_counter_lose_no_delivery():
    """The thread shards share one counter group, and ``stats[k] += 1``
    is a read and then a write. Forced interleaving: a shard core reads
    ``batch_entries_delivered`` in its delivery loop, another thread bumps
    it twice, then the core writes its stale sum back. Every entry still
    reaches the delivered queue and every bump counts. (A plain ``set``
    raised ``ValueError`` on the monotone counter after the loop's first
    entry: the rest were marked delivered but never handed over, and the
    slot then retired with them, the phase-9a stall.)"""
    import threading

    from at2_node_tpu_torch.obs.registry import Counter

    net = Net("port", 3, seed=45, shards=2, executor="thread")
    m = net.x.m
    group = net.bcast.stats
    real = group._counters["batch_entries_delivered"]
    fired = []

    class Interleaved(Counter):
        @property
        def value(self):
            value = real.value
            if not fired and threading.current_thread() is not threading.main_thread():
                fired.append(value)

                def other_shard():
                    group["batch_entries_delivered"] += 1
                    group["batch_entries_delivered"] += 1

                bumper = threading.Thread(target=other_shard)
                bumper.start()
                bumper.join()
            return value

        def inc(self, n=1):
            real.inc(n)

        def set(self, value):
            real.set(value)

    group._counters["batch_entries_delivered"] = Interleaved(real.name)
    n = 16
    async with net:
        entries = [net.payload(net.client(), amount=1) for _ in range(n)]
        batch = m.TxBatch.create(net.peer_keys[0], 1, b"".join(p.encode()[1:] for p in entries))
        await net.inject(batch, peer=net.mesh.peers[0])
        for phase in (m.BATCH_ECHO, m.BATCH_READY):
            await _wait(lambda: any(isinstance(x, m.BatchAttestation) and x.phase == phase
                                    for x in net.sent_messages()),
                        f"the node attests phase {phase}", 20)
            for kp in net.peer_keys:
                await net.inject(net.batch_vote(kp, batch, phase, (1 << n) - 1))
        await _wait(lambda: net.bcast.delivered.qsize() == n, "every entry delivers", 20)
    assert fired == [0]
    assert real.value == n + 2
    got = [net.bcast.delivered.get_nowait() for _ in range(n)]
    assert sorted(p.sender for p in got) == sorted(p.sender for p in entries)


async def test_process_plane_packs_registry_releases():
    """A burst of commits releases thousands of registry entries; the
    owner packs them into few ring records, so small rings drop none (one
    record a release, the reference's, fills them)."""
    from at2_node_tpu_torch.crypto.verifier import CpuVerifier

    kp = SignKeyPair(bytes(range(32)))
    mesh = type("Mesh", (), {"peers": [], "by_sign": {}})()
    plane = port_shards.ShardedPlane(kp, mesh, CpuVerifier(), shards=2, executor="process",
                                     ring_slots=256, ring_slot_bytes=1024)
    await plane.start()
    try:
        senders = _keys(44, 50)
        for seq in range(1, 101):
            for sender in senders:
                plane.release_entry(sender.public, seq)
        await _wait(lambda: not plane._pending_release and all(len(r) == 0 for r in plane._executor.actions),
                    "the workers drain the releases", 20)
        assert plane.effects_dropped == 0
        assert all(plane._executor.alive(sid) for sid in range(2))
    finally:
        await plane.close()
        await plane.verifier.close()


# -- the process executor under port Services ---------------------------------


def _net_configs(n, seed, **plane):
    ports = iter(chip_smoke.free_ports(2 * n))
    return make_net_configs(n, ports, seed=seed, verifier=VerifierConfig(kind="cpu"),
                            plane=PlaneConfig(**plane))


async def _wait(pred, what, timeout=TIMEOUT):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if pred():
            return
        await asyncio.sleep(0.05)
    raise TimeoutError(f"{what} not reached within {timeout} s")


def _payload(kp, seq):
    return port_msgs.Payload.create(kp, seq, ThinTransaction(b"r" * 32, 10))


async def test_process_executor_delivers_then_survives_worker_crash():
    services = [await Service.start(c) for c in _net_configs(3, 21, shards=2, executor="process")]
    try:
        for svc in services:
            assert isinstance(svc.broadcast, port_shards.ShardedPlane)
            assert svc.broadcast.plane_info()["executor"] == "process"
            assert all(svc.broadcast._executor.alive(sid) for sid in range(2))
        senders = _spread_keys(21, 4)
        for kp in senders:
            for seq in (1, 2):
                await services[0].broadcast.broadcast(_payload(kp, seq))
        await _wait(lambda: all(s.committed >= 8 for s in services), "commits through the process plane")

        victim = services[0]
        victim.broadcast._executor.actions[0].put(port_pw.C_EXIT, bytes([7]))
        await _wait(lambda: victim.broadcast.worker_crashed == {0: 7}, "the owner sees the dead worker")
        hv = victim.health_verdict()
        assert hv["status"] == "degraded" and hv["plane_workers_crashed"] == {"0": 7}
        assert victim.broadcast.plane_info()["worker_crashed"] == {"0": 7}
        assert victim.statusz()["plane"]["worker_crashed"] == {"0": 7}
        assert any(s["reason"].startswith("plane_worker_crash:shard=0")
                   for s in victim.recorder.dump()["snapshots"])
        assert victim.broadcast._executor.alive(1)
        assert victim.broadcast._executor.poll_crashed() == []
        assert services[1].health_verdict()["status"] == "ok"
    finally:
        for s in services:
            await s.close()
    for svc in services:  # a clean shutdown reaps the workers and unlinks the rings
        ex = svc.broadcast._executor
        assert all(not p.is_alive() for p in ex._procs)
        assert ex.actions == [] and ex.effects == [] and ex.obs == []


async def test_process_rings_spill_instead_of_dropping():
    """Rings of 8 slots under three Services: a burst overflows the
    protocol rings, the overflow waits in its producer's backlog, and
    every payload commits on every node with no record dropped. Messages
    still arrive after the commits (the late Readies), so every backlog
    is read once the planes have drained it."""
    services = [await Service.start(c)
                for c in _net_configs(3, 23, shards=2, executor="process", ring_slots=8)]
    try:
        senders = _spread_keys(23, 4)
        for seq in range(1, 31):
            for kp in senders:
                await services[0].broadcast.broadcast(_payload(kp, seq))
        await _wait(lambda: all(s.committed >= 120 for s in services), "commits through 8-slot rings")
        assert sum(r.spilled for r in services[0].broadcast._executor.actions) > 0
        await _wait(lambda: all(s.broadcast.plane_info()["actions_backlog"] == 0 for s in services),
                    "the actions backlogs drained")
        for svc in services:
            assert svc.broadcast.effects_dropped == 0
            assert svc.broadcast.plane_info()["actions_backlog"] == 0
    finally:
        for s in services:
            await s.close()


async def test_observability_crosses_the_process_boundary():
    services = [await Service.start(c) for c in _net_configs(3, 31, shards=2, executor="process")]
    try:
        victim = services[0]
        assert victim.broadcast._obs_ship
        senders = _spread_keys(32, 4)
        for kp in senders:
            for seq in (1, 2):
                await victim.broadcast.broadcast(_payload(kp, seq))
        await _wait(lambda: all(s.committed >= 8 for s in services), "commits through the process plane")

        # worker phase accounting folds into the shardN counters, the
        # verify term (run inside the workers) included
        def phases_folded():
            st = victim.snapshot_stats()
            return all(sum(st.get(f"phase_{p}_shard{k}_ns", 0) for k in range(2)) > 0
                       for p in ("verify_wait", "rx_decode", "ready_deliver"))

        await _wait(phases_folded, "worker phase deltas fold into shardN counters", 15)
        st = victim.snapshot_stats()
        assert st.get("obs_records_dropped", -1) == 0
        assert sum(st.get(f"phase_plane_total_shard{k}_ns", 0) for k in range(2)) > 0
        # /debugz interleaves the workers' recorder events by time
        await _wait(lambda: victim.debugz()["recorder"].get("worker_events", 0) > 0,
                    "worker recorder events reach /debugz", 15)
        dump = victim.debugz()["recorder"]
        assert any(str(e[1]).startswith("shard") for e in dump["events"])
        assert [e[0] for e in dump["events"]] == sorted(e[0] for e in dump["events"])
        # the profiler fans out to the workers and merges their frames
        plane = victim._plane_obs()
        assert plane is not None and plane.profiler_start()
        for kp in senders:
            for seq in (3, 4):
                await victim.broadcast.broadcast(_payload(kp, seq))
        await asyncio.sleep(1.2)
        assert plane.profiler_stop()
        await _wait(lambda: plane.worker_fold_samples() > 0, "worker folded stacks ship", 15)
        merged = victim._merged_folded(plane, None)
        assert any(line.startswith("shard") for line in merged.splitlines())
        # a crashed worker's snapshot carries the post-mortem obs drain
        victim.broadcast._executor.actions[0].put(port_pw.C_EXIT, bytes([7]))
        await _wait(lambda: victim.broadcast.worker_crashed == {0: 7}, "the owner sees the dead worker", 30)
        snaps = [s for s in victim.recorder.dump()["snapshots"]
                 if s["reason"].startswith("plane_worker_crash:shard=0")]
        extra = snaps[-1]["extra"]
        assert extra["shard"] == 0 and extra["exit"] == 7 and extra["recorder_tail"]
        assert any(p in extra["phases"] for p in ("verify_wait", "rx_decode", "ready_deliver"))
    finally:
        for s in services:
            await s.close()


# -- a worker loads no torch ---------------------------------------------------


def test_plane_worker_imports_leave_torch_out():
    """The spawn child imports the worker module and everything
    ``worker_main`` and ``_WorkerObs`` import, and the plane names of the
    parallel package; none of it may load torch (nor CUDA with it)."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import at2_node_tpu_torch.parallel.plane_worker\n"
        "from at2_node_tpu_torch.parallel import make_plane_executor, SPSCQueue\n"
        "import at2_node_tpu_torch.cli.server\n"
        "import at2_node_tpu_torch.broadcast.messages, at2_node_tpu_torch.broadcast.stack\n"
        "import at2_node_tpu_torch.crypto.keys, at2_node_tpu_torch.native.ingest\n"
        "import at2_node_tpu_torch.net.peers, at2_node_tpu_torch.parallel.ring\n"
        "import at2_node_tpu_torch.obs.profiler, at2_node_tpu_torch.obs.recorder\n"
        "import at2_node_tpu_torch.obs.registry\n"
        "bad = sorted(m for m in sys.modules if m == 'torch' or m.startswith('torch.')"
        " or m.endswith('parallel.pool'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# -- where a stalled run stopped ------------------------------------------------


async def test_debugz_lists_part_delivered_batch_slots():
    """``/debugz`` ``plane_slots``: the batch slots a plane still holds
    with no content fully delivered, each with its shard, entries and the
    entries delivered and rejected here; a fully delivered or retired
    slot is not listed, and a net that committed everything lists none."""
    from at2_node_tpu_torch.broadcast.stack import _BatchState

    services = [await Service.start(c) for c in _net_configs(3, 25, shards=2, executor="thread")]
    try:
        senders = _spread_keys(21, 4)
        for kp in senders:
            await services[0].broadcast.broadcast(_payload(kp, 1))
        await _wait(lambda: all(s.committed >= 4 for s in services), "commits through the thread plane")
        await _wait(lambda: all(s.debugz()["plane_slots"] == [] for s in services), "no slot held")
        plane = services[1].broadcast
        now = plane.clock.monotonic()
        held, done, retired = _BatchState(now - 2.0), _BatchState(now), _BatchState(now)
        held.nbits, held.delivered_bits, held.rejected_bits = 8, {b"h": 0b1011}, {b"h": 0b100}
        done.delivered_all = True
        retired.retired = True
        plane._cores[1]._batch_slots[(b"\x07" * 32, 9)] = held
        plane._cores[0]._batch_slots[(b"\x08" * 32, 1)] = done
        plane._cores[0]._batch_slots[(b"\x09" * 32, 1)] = retired
        (row,) = services[1].debugz()["plane_slots"]
        assert row["shard"] == 1 and row["origin"] == "07" * 8 and row["batch_seq"] == 9
        assert (row["entries"], row["delivered"], row["rejected"]) == (8, 3, 1)
        assert row["age_s"] >= 2.0 and row["echoed"] is False
        for core, key in ((1, (b"\x07" * 32, 9)), (0, (b"\x08" * 32, 1)), (0, (b"\x09" * 32, 1))):
            del plane._cores[core]._batch_slots[key]
    finally:
        for s in services:
            await s.close()

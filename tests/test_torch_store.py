"""The port's durable sharded store (``at2_node_tpu_torch/store/``)
against the JAX package's:

* the reference's store cases on the port: the WAL's record kinds, torn
  and corrupt tails, flush and reopen with the manifest's small state,
  WAL replay, incremental flushes, parked payloads, the one-shot legacy
  migration, a crash injected at every durability step, and a service
  that migrates a monolithic checkpoint;
* ``encode_line`` writes the reference's bytes;
* a store directory written by one package opens in the other with the
  same state, and the same commits give byte-identical segment and
  manifest files in both;
* a port ``Service`` starts with ``[store] dir`` and reports the store;
* the slice as a whole: a 4-node port net on the sharded plane (``thread``
  executor) and the store, with the batched CUDA verifier's plain path
  (``device="cpu"``) on every node, where node 0 dies mid-run
  (``InjectedCrash`` at a WAL append) and restarts from its store; every
  ledger must equal a python-int replay.

Every key is seeded; every comparison is exact."""

import asyncio
import hashlib
import json
import os

import numpy as np
import pytest

import chip_smoke
from at2_node_tpu.broadcast import messages as ref_msgs
from at2_node_tpu.crypto import keys as ref_keys
from at2_node_tpu.store import sharded as ref_sharded
from at2_node_tpu.store import wal as ref_wal
from at2_node_tpu.types import ThinTransaction as RefThin
from at2_node_tpu_torch.broadcast.messages import Payload
from at2_node_tpu_torch.broadcast.shards import ShardedPlane, shard_of
from at2_node_tpu_torch.client import Client
from at2_node_tpu_torch.crypto.keys import ExchangeKeyPair, SignKeyPair
from at2_node_tpu_torch.crypto.verifier import make_verifier
from at2_node_tpu_torch.ledger import checkpoint
from at2_node_tpu_torch.ledger.accounts import Accounts
from at2_node_tpu_torch.ledger.recent import RecentTransactions
from at2_node_tpu_torch.node.config import (
    CheckpointConfig,
    Config,
    PlaneConfig,
    StoreConfig,
    VerifierConfig,
)
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.store import InjectedCrash, ShardedStore, WalRecord
from at2_node_tpu_torch.store.manifest import MANIFEST_NAME, read_manifest
from at2_node_tpu_torch.store.sharded import PARKED_CAP
from at2_node_tpu_torch.store.wal import encode_line, replay
from at2_node_tpu_torch.tools._common import make_net_configs
from at2_node_tpu_torch.types import ThinTransaction

TIMEOUT = 120.0


def _kp(tag: str) -> SignKeyPair:
    return SignKeyPair(hashlib.sha256(f"store-test-{tag}".encode()).digest())


def _payload(kp: SignKeyPair, seq: int, amount: int = 10) -> Payload:
    return Payload.create(kp, seq, ThinTransaction(b"r" * 32, amount))


def _commit(store, kp, seq: int, amount: int = 10, payload=None):
    p = _payload(kp, seq, amount) if payload is None else payload
    store.note_commit(p, sender_seq=seq, sender_balance=100_000 - seq * amount,
                      recipient_balance=100_000 + seq * amount)
    return p


# -- the reference's cases on the port ---------------------------------------


class TestWal:
    def test_record_kinds_roundtrip(self, tmp_path):
        path = str(tmp_path / "wal.log")
        records = [
            WalRecord("aa" * 70, 3, 970, 1030, True),
            WalRecord("bb" * 70, 4, 960, None, False),
            WalRecord.parked("cc" * 70),
            WalRecord.unparked("cc" * 70),
        ]
        with open(path, "wb") as fp:
            for r in records:
                fp.write(encode_line(r))
        assert list(replay(path)) == records

    def test_torn_tail_stops_replay(self, tmp_path):
        path = str(tmp_path / "wal.log")
        good = [WalRecord(f"{i:02x}" * 70, i, 100 - i, None, True) for i in range(1, 4)]
        tail = encode_line(WalRecord("ee" * 70, 9, 1, None, True))
        with open(path, "wb") as fp:
            fp.write(b"".join(encode_line(r) for r in good) + tail[: len(tail) // 2])
        assert list(replay(path)) == good

    def test_corrupt_checksum_stops_replay(self, tmp_path):
        path = str(tmp_path / "wal.log")
        good = WalRecord("ab" * 70, 1, 99, None, True)
        bad = bytearray(encode_line(WalRecord("cd" * 70, 2, 98, None, True)))
        bad[20] ^= 0xFF
        with open(path, "wb") as fp:
            fp.write(encode_line(good) + bytes(bad))
        assert list(replay(path)) == [good]

    def test_missing_file_replays_empty(self, tmp_path):
        assert list(replay(str(tmp_path / "absent.log"))) == []

    def test_encode_line_bytes_equal_reference(self):
        rng = np.random.default_rng(4)
        for _ in range(20):
            body = rng.bytes(140).hex()
            seq, sb, rb = (int(x) for x in rng.integers(0, 1 << 40, 3))
            for args in ((body, seq, sb, rb, True), (body, seq, sb, None, False)):
                assert encode_line(WalRecord(*args)) == ref_wal.encode_line(ref_wal.WalRecord(*args))
            assert encode_line(WalRecord.parked(body)) == ref_wal.encode_line(ref_wal.WalRecord.parked(body))
            assert encode_line(WalRecord.unparked(body)) == \
                ref_wal.encode_line(ref_wal.WalRecord.unparked(body))


class TestStoreLifecycle:
    def test_flush_reopen_roundtrip_with_meta(self, tmp_path):
        d = str(tmp_path / "store")
        store = ShardedStore.open(d, n_shards=4, sync="always")
        kp_a, kp_b = _kp("a"), _kp("b")
        for seq in range(1, 4):
            _commit(store, kp_a, seq)
        _commit(store, kp_b, 1)
        store.set_meta(directory_rows=[[7, kp_a.public.hex()]], recent_rows=[],
                       watermarks={"tx": {kp_a.public.hex(): 3}, "batch": {}},
                       distill_seen=[[12, 34]], epoch=2)
        stats = store.flush()
        assert stats is not None and stats["gen"] == 1
        expected = store.accounts_state()
        store.close()

        loaded = ShardedStore.open(d, n_shards=4, sync="always")
        assert loaded.gen == 1
        assert loaded.accounts_state() == expected
        assert loaded.history_count() == 4
        assert loaded.directory_rows == [[7, kp_a.public.hex()]]
        assert loaded.watermarks["tx"] == {kp_a.public.hex(): 3}
        assert loaded.distill_seen == [[12, 34]]
        assert loaded.epoch == 2
        assert loaded.wal_replayed == 0
        assert loaded.segments_loaded == stats["segments_written"]
        loaded.close()

    def test_wal_replay_recovers_unflushed_commits(self, tmp_path):
        d = str(tmp_path / "store")
        store = ShardedStore.open(d, n_shards=4, sync="always")
        kp = _kp("replay")
        store.flush(force=True)
        for seq in range(1, 6):
            _commit(store, kp, seq)
        expected = store.accounts_state()
        store.close()

        loaded = ShardedStore.open(d, n_shards=4, sync="always")
        assert loaded.wal_replayed == 5
        assert loaded.accounts_state() == expected
        assert loaded.history_count() == 5
        assert loaded.flush() is not None
        loaded.close()
        third = ShardedStore.open(d, n_shards=4, sync="always")
        assert third.wal_replayed == 0
        assert third.accounts_state() == expected
        third.close()

    def test_incremental_flush_writes_only_dirty_shards(self, tmp_path):
        d = str(tmp_path / "store")
        store = ShardedStore.open(d, n_shards=8, sync="always")
        senders = [_kp(f"delta-{i}") for i in range(12)]
        for kp in senders:
            _commit(store, kp, 1)
        full = store.flush()
        assert full is not None and full["segments_written"] > 2
        _commit(store, senders[0], 2)
        delta = store.flush()
        assert delta is not None
        assert delta["segments_written"] <= 2
        assert delta["segment_bytes"] < full["segment_bytes"]
        assert len(read_manifest(d)["segments"]) == full["segments_written"]
        store.close()

    def test_parked_payloads_survive_crash_and_rotation(self, tmp_path):
        d = str(tmp_path / "store")
        store = ShardedStore.open(d, n_shards=4, sync="always")
        kp = _kp("parked")
        p2, p3 = _payload(kp, 2), _payload(kp, 3)
        store.note_parked(p2)
        store.note_parked(p3)
        store.note_parked(p2)
        assert store.parked_count() == 2
        store.close()

        loaded = ShardedStore.open(d, n_shards=4, sync="always")
        assert [p.sequence for p in loaded.iter_parked()] == [2, 3]
        _commit(loaded, kp, 2)
        assert loaded.parked_count() == 1
        loaded.flush()
        loaded.close()

        again = ShardedStore.open(d, n_shards=4, sync="always")
        assert [p.sequence for p in again.iter_parked()] == [3]
        again.note_unparked(_payload(kp, 3))
        assert again.parked_count() == 0
        again.close()

    def test_parked_cap_evicts_oldest(self, tmp_path):
        store = ShardedStore.open(str(tmp_path / "store"), n_shards=2)
        for i in range(PARKED_CAP + 5):
            store._fold(WalRecord.parked(f"{i:08x}"), mark_dirty=False)
        assert store.parked_count() == PARKED_CAP
        assert next(iter(store._parked)) == f"{5:08x}"
        store.close()


class TestLegacyMigration:
    def _legacy_doc(self, kp):
        return {"version": 1, "accounts": {kp.public.hex(): [3, 97_000], "ff" * 32: [0, 103_000]},
                "recent": [], "directory": [[5, kp.public.hex()]]}

    def test_one_shot_migration(self, tmp_path):
        d = str(tmp_path / "store")
        kp = _kp("legacy")
        store = ShardedStore.open(d, n_shards=4, legacy_checkpoint=self._legacy_doc(kp))
        assert store.migrated is True and store.gen == 1
        assert store.accounts_state()[kp.public.hex()] == [3, 97_000]
        assert store.directory_rows == [[5, kp.public.hex()]]
        store.close()
        stale = self._legacy_doc(kp)
        stale["accounts"][kp.public.hex()] = [1, 1]
        again = ShardedStore.open(d, n_shards=4, legacy_checkpoint=stale)
        assert again.migrated is False
        assert again.accounts_state()[kp.public.hex()] == [3, 97_000]
        again.close()

    def test_bad_legacy_version_raises(self, tmp_path):
        with pytest.raises(ValueError):
            ShardedStore.open(str(tmp_path / "store"), legacy_checkpoint={"version": 99})


class TestCrashAtomicity:
    def _labels(self, tmp_path):
        seen = []
        store = ShardedStore.open(str(tmp_path / "probe"), n_shards=4, sync="always")
        store.failpoint = seen.append
        _commit(store, _kp("probe"), 1)
        store.flush()
        store.close()
        return seen

    def test_failpoint_walk_every_step(self, tmp_path):
        labels = self._labels(tmp_path)
        assert {"wal:pre_append", "flush:pre_manifest", "flush:post_manifest"} <= set(labels)
        for n, crash_label in enumerate(labels):
            d = str(tmp_path / f"walk-{n}")
            store = ShardedStore.open(d, n_shards=4, sync="always")
            kp = _kp("walk")
            _commit(store, kp, 1)
            store.flush()
            baseline = store.accounts_state()

            def fp(label, _crash=crash_label):
                if label == _crash:
                    raise InjectedCrash(label)

            store.failpoint = fp
            crashed = False
            try:
                _commit(store, kp, 2)
                store.flush()
            except InjectedCrash:
                crashed = True
            store.failpoint = None
            store.close()
            assert crashed, f"failpoint {crash_label!r} never fired"

            loaded = ShardedStore.open(d, n_shards=4, sync="always")
            state = loaded.accounts_state()
            if crash_label == "wal:pre_append":
                assert state == baseline
            else:
                assert state[kp.public.hex()][0] == 2, (crash_label, state)
            _commit(loaded, kp, state[kp.public.hex()][0] + 1)
            assert loaded.flush() is not None
            loaded.close()

    def test_crashed_flush_does_not_leak_wal_fd(self, tmp_path):
        store = ShardedStore.open(str(tmp_path / "store"), n_shards=4, sync="always")
        _commit(store, _kp("fd"), 1)

        def fp(label):
            if label == "flush:pre_manifest":
                raise InjectedCrash(label)

        store.failpoint = fp
        with pytest.raises(InjectedCrash):
            store.flush()
        store.failpoint = None
        _commit(store, _kp("fd"), 2)
        assert store.flush()["gen"] >= 1
        store.close()

    def test_orphans_swept_after_crash_recovery(self, tmp_path):
        d = str(tmp_path / "store")
        store = ShardedStore.open(d, n_shards=4, sync="always")
        _commit(store, _kp("orphan"), 1)

        def fp(label):
            if label == "flush:pre_manifest":
                raise InjectedCrash(label)

        store.failpoint = fp
        with pytest.raises(InjectedCrash):
            store.flush()
        store.failpoint = None
        store.close()
        ShardedStore.open(d, n_shards=4, sync="always").close()
        doc = read_manifest(d)
        referenced = set(doc["segments"].values()) | {doc["wal"]}
        on_disk = {f for f in os.listdir(d) if f.startswith(("seg-", "wal-"))}
        assert on_disk == referenced


def _free_ports():
    return iter(chip_smoke.free_ports(16))


class TestServiceMigration:
    async def test_service_migrates_monolithic_checkpoint(self, tmp_path):
        ckpt_path = str(tmp_path / "legacy.ckpt")
        sender = _kp("svc-sender")
        accounts, recent = Accounts(), RecentTransactions()
        await accounts.transfer(sender.public, 1, b"\x02" * 32, 250)
        doc = await checkpoint.snapshot(accounts, recent)
        doc["directory"] = [["9", sender.public.hex()]]
        checkpoint.write_atomic(ckpt_path, doc)
        ports = _free_ports()
        node_key, net_key = _kp("svc-node"), ExchangeKeyPair(hashlib.sha256(b"svc-x").digest())

        def make_config():
            return Config(
                node_address=f"127.0.0.1:{next(ports)}", rpc_address=f"127.0.0.1:{next(ports)}",
                sign_key=node_key, network_key=net_key, verifier=VerifierConfig(kind="cpu"),
                checkpoint=CheckpointConfig(path=ckpt_path, interval=60.0),
                store=StoreConfig(dir=str(tmp_path / "store"), sync="always", shards=4),
            )

        service = await Service.start(make_config())
        try:
            assert service.recovery.migrated is True and service.store.migrated is True
            async with Client(f"http://{service.config.rpc_address}") as c:
                assert await c.get_balance(sender.public) == 99_750
                assert await c.get_last_sequence(sender.public) == 1
            assert service.directory.export() == [["9", sender.public.hex()]]
            await service._store_flush()
        finally:
            await service.close()

        service2 = await Service.start(make_config())
        try:
            assert service2.recovery.migrated is False
            async with Client(f"http://{service2.config.rpc_address}") as c:
                assert await c.get_balance(sender.public) == 99_750
            assert service2.directory.export() == [["9", sender.public.hex()]]
            sz = service2.statusz()
            assert sz["recovery"]["state"] == "live"
            assert json.dumps(sz, default=float)
        finally:
            await service2.close()


# -- store directories across packages ----------------------------------------

PKGS = {
    "port": (ShardedStore, Payload, SignKeyPair, ThinTransaction),
    "ref": (ref_sharded.ShardedStore, ref_msgs.Payload, ref_keys.SignKeyPair, RefThin),
}


def _write_store(pkg: str, d: str, seed: int, flush_twice: bool = True):
    """Seeded commits, parked payloads and manifest meta, flushed (twice:
    a full flush, then a delta) with more commits left in the WAL."""
    store_cls, payload_cls, sk, thin = PKGS[pkg]
    rng = np.random.default_rng(seed)
    clients = [sk(rng.bytes(32)) for _ in range(6)]
    store = store_cls.open(d, n_shards=4, sync="always")

    def commit(kp, seq, amount):
        p = payload_cls.create(kp, seq, thin(clients[(seq + 1) % 6].public, amount))
        store.note_commit(p, sender_seq=seq, sender_balance=100_000 - seq * amount,
                          recipient_balance=100_000 + seq * amount)

    for seq in (1, 2):
        for kp in clients:
            commit(kp, seq, int(rng.integers(1, 50)))
    store.note_parked(payload_cls.create(clients[0], 9, thin(clients[1].public, 5)))
    store.set_meta(directory_rows=[[3, clients[2].public.hex()]], recent_rows=[],
                   watermarks={"tx": {clients[0].public.hex(): 2}, "batch": {}},
                   distill_seen=[[1, 2]], epoch=3, audit={"chain": "ab" * 32, "commits": 12})
    store.flush()
    if flush_twice:
        commit(clients[3], 3, 7)
        store.flush()
    commit(clients[4], 3, 11)  # left in the WAL
    store.close()


def _state(pkg: str, d: str) -> dict:
    store = PKGS[pkg][0].open(d, n_shards=4, sync="always")
    try:
        return {
            "accounts": store.accounts_state(),
            "history": [p.encode() for p in store.iter_history()],
            "parked": [p.encode() for p in store.iter_parked()],
            "recent": store.recent_rows, "directory": store.directory_rows,
            "watermarks": store.watermarks, "epoch": store.epoch, "gen": store.gen,
            "distill_seen": store.distill_seen, "audit": store.audit,
            "wal_replayed": store.wal_replayed, "segments_loaded": store.segments_loaded,
        }
    finally:
        store.close()


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_store_written_by_one_package_opens_in_the_other(tmp_path, writer, reader):
    d = str(tmp_path / "store")
    _write_store(writer, d, seed=8)
    got = _state(reader, d)
    # opening replayed the WAL tail: compare with a second copy opened by
    # the writer itself
    d2 = str(tmp_path / "store2")
    _write_store(writer, d2, seed=8)
    assert got == _state(writer, d2)
    assert got["wal_replayed"] == 1 and got["segments_loaded"] > 0 and got["epoch"] == 3
    assert len(got["history"]) == 14 and len(got["parked"]) == 1


def test_same_commits_give_byte_identical_files(tmp_path):
    dirs = {pkg: str(tmp_path / pkg) for pkg in PKGS}
    for pkg, d in dirs.items():
        _write_store(pkg, d, seed=9)
    names = {pkg: sorted(os.listdir(d)) for pkg, d in dirs.items()}
    assert names["port"] == names["ref"]
    assert MANIFEST_NAME in names["port"] and any(n.startswith("seg-") for n in names["port"])
    for name in names["port"]:
        with open(os.path.join(dirs["port"], name), "rb") as a, \
                open(os.path.join(dirs["ref"], name), "rb") as b:
            assert a.read() == b.read(), name


# -- a port Service with [store] dir --------------------------------------------


async def test_service_with_store_dir_reports_it_and_restarts(tmp_path):
    ports = _free_ports()
    cfg = Config(node_address=f"127.0.0.1:{next(ports)}", rpc_address=f"127.0.0.1:{next(ports)}",
                 sign_key=_kp("one"), network_key=ExchangeKeyPair(hashlib.sha256(b"one").digest()),
                 verifier=VerifierConfig(kind="cpu"),
                 store=StoreConfig(dir=str(tmp_path / "store"), flush_interval=0.2, shards=4))
    sender, recipient = _kp("one-sender"), _kp("one-recipient")
    service = await Service.start(cfg)
    try:
        assert service.store is not None and service._store_task is not None
        async with Client(f"http://{cfg.rpc_address}") as c:
            for seq in (1, 2, 3):
                await c.send_asset(sender, seq, recipient.public, 5)
            for _ in range(200):
                if await c.get_last_sequence(sender.public) == 3:
                    break
                await asyncio.sleep(0.05)
        await asyncio.sleep(0.5)  # at least one periodic flush
        st = service.snapshot_stats()
        assert st["store_flushes"] >= 1 and st["store_segments_written"] >= 1
        assert st["store_history"] == 3 and st["store_gen"] >= 1
    finally:
        await service.close()
    again = await Service.start(cfg)
    try:
        assert again.recovery.segments_loaded >= 1 and again.recovery.state == "live"
        assert again.statusz()["recovery"]["segments_loaded"] >= 1
        async with Client(f"http://{cfg.rpc_address}") as c:
            assert await c.get_last_sequence(sender.public) == 3
            assert await c.get_balance(recipient.public) == 100_015
    finally:
        await again.close()


# -- the slice as a whole on the CPU ------------------------------------------


def _replay(per_client, clients):
    ledger = {}

    def acct(pk):
        return ledger.setdefault(pk, [0, 100_000])

    for c, transfers in enumerate(per_client):
        for seq, recipient, amount in transfers:
            s = acct(clients[c].public)
            assert seq == s[0] + 1 and s[1] >= amount
            s[0], s[1] = seq, s[1] - amount
            acct(recipient)[1] += amount
    return ledger


async def _crash(service) -> None:
    """Abrupt death: tasks cancelled, the plane, the mesh, the RPC surface
    and the verifier closed, the store's WAL closed with no flush."""
    service._closing = True
    for task in (service._catchup_task, service._stats_task, service._slo_task,
                 service._checkpoint_task, service._store_task, service._membership_task,
                 service._batch_flush_task, service._delivery_task):
        if task is not None:
            task.cancel()
            try:
                await task
            except BaseException:
                pass
    await service.broadcast.close()
    await service.mesh.close()
    if service._mux is not None:
        await service._mux.close()
    if service._grpc_server is not None:
        await service._grpc_server.stop(grace=0)
    service.store.close()
    await service.verifier.close()


async def _wait(pred, what, timeout=TIMEOUT, report=None):
    """Await ``pred()`` until it holds; past ``timeout`` print
    ``report()``'s lines, then fail."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if await pred():
            return
        await asyncio.sleep(0.1)
    if report is not None:
        for line in report():
            print(line)
    raise TimeoutError(f"{what} not reached within {timeout} s")


def _stall_report(services) -> list:
    """Where a net that stopped short stopped, node by node: the plane
    block and broadcast counters, the commit heap, the part-delivered
    batch slots and the watermarks (live, and as the store last
    flushed them)."""
    lines = []
    for i, s in enumerate(services):
        if s._closing:
            lines.append(f"node {i}: down")
            continue
        snap = s.registry.snapshot()
        lines.append(f"node {i}: plane {s.broadcast.plane_info()}; "
                     + ", ".join(f"{k} {snap.get(k)}" for k in chip_smoke.STALL_KEYS))
        pending = s._heap + [e for group in s._parked.values() for e in group[2]]
        heap = sorted((p.sender.hex()[:12], p.sequence) for *_, p in pending)[:16]
        lines.append(f"node {i}: commit heap {len(pending)} {heap}")
        lines.append(f"node {i}: part-delivered batch slots {s.broadcast.part_delivered_batches()}")
        lines.append(f"node {i}: watermarks live {s.broadcast.export_watermarks()}, "
                     f"store {s.store.watermarks if s.store is not None else None}")
    return lines


@pytest.fixture
def one_torch_thread():
    """The plain path's small tensors gain nothing from torch's intra-op
    threads, which would only spin on the cores other tests run on."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


async def test_sharded_durable_net_killed_and_restarted_equals_replay(tmp_path, one_torch_thread):
    rng = np.random.default_rng(77)
    ports = iter(chip_smoke.free_ports(8))
    cfgs = make_net_configs(4, ports, seed=78, echo_threshold=2, ready_threshold=2,
                            verifier=VerifierConfig(kind="cpu"),
                            plane=PlaneConfig(shards=2, executor="thread"))
    for i, cfg in enumerate(cfgs):
        cfg.store = StoreConfig(dir=str(tmp_path / f"store{i}"), flush_interval=0.5, sync="always",
                                shards=4)

    plain = []

    async def start(i):
        """Node 0, the node that dies, verifies every signature through the
        batched CUDA verifier's plain path (K1's plain version); nodes 1-3
        use the host verifier, which keeps the net's run short here."""
        if i:
            return await Service.start(cfgs[i])
        ver = make_verifier("cuda", device="cpu", batch_size=64, max_delay=0.05)
        await ver.warmup()
        plain.append(ver)
        service = await Service.start(cfgs[0], verifier=ver)
        service._owns_verifier = True
        return service

    clients = [SignKeyPair(rng.bytes(32)) for _ in range(4)]
    assert {shard_of(kp.public, 2) for kp in clients} == {0, 1}  # both plane shards carry slots
    per_client = [[(seq, clients[(c + 1 + int(rng.integers(0, 3))) % 4].public,
                    int(rng.integers(1, 50))) for seq in range(1, 5)] for c in range(4)]
    services = [await start(i) for i in range(4)]
    assert all(isinstance(s.broadcast, ShardedPlane) for s in services)
    assert {s.broadcast.shards for s in services} == {2}
    try:
        # node 0 dies at its store's fourth WAL append: the records before
        # it are in its WAL, the rest of the run goes on without it
        appends = []

        def failpoint(label):
            if label == "wal:pre_append":
                appends.append(label)
                if len(appends) == 4:
                    raise InjectedCrash(label)

        services[0].store.failpoint = failpoint

        async def send(node, c, transfers):
            async with Client(f"http://{cfgs[node].rpc_address}") as conn:
                await conn.send_asset_many(clients[c], transfers)

        async def committed_on(nodes, want):
            async def ok():
                for i in nodes:
                    async with Client(f"http://{cfgs[i].rpc_address}") as conn:
                        for kp in clients:
                            if await conn.get_last_sequence(kp.public) != want:
                                return False
                return True
            return ok

        await asyncio.gather(*(send(c % 4, c, per_client[c][:2]) for c in range(4)))
        # the first half broadcast and committed by the others (an
        # acknowledged transfer that node 0 never broadcast would be lost
        # with it, as in the reference)
        await _wait(await committed_on([1, 2, 3], 2), "nodes 1-3 commit the first half",
                    report=lambda: _stall_report(services))
        await _wait(lambda: asyncio.sleep(0, result=services[0]._delivery_task.done()),
                    "node 0's commit path dies at the injected crash")
        assert isinstance(services[0]._delivery_task.exception(), InjectedCrash)
        await _crash(services[0])
        await asyncio.gather(*(send(1 + c % 3, c, per_client[c][2:]) for c in range(4)))
        await _wait(await committed_on([1, 2, 3], 4), "nodes 1-3 commit with node 0 down",
                    report=lambda: _stall_report(services))
        # the records node 0 appended before it died (payloads parked at
        # its sequence gate, commits) are durable: in its WAL, or folded by
        # a flush into the manifest (parked) and the segments (commits)
        store_dir = cfgs[0].store.dir
        doc = read_manifest(store_dir)
        wal = list(replay(os.path.join(store_dir, doc["wal"])))
        segments = [json.load(open(os.path.join(store_dir, name))) for name in doc["segments"].values()]
        history = sum(len(b) for seg in segments for b in seg["history"].values())
        assert len(wal) + len(doc["parked"]) + history > 0
        services[0] = await start(0)
        rec = services[0].recovery
        assert rec.wal_records_replayed == len(wal) and rec.segments_loaded == len(segments)
        assert rec.state in ("catchup", "live")
        # one more transfer a client exposes any gap left to catchup
        nudge = [[(5, clients[(c + 1) % 4].public, 1)] for c in range(4)]
        await asyncio.gather(*(send(c % 4, c, nudge[c]) for c in range(4)))
        await _wait(await committed_on(range(4), 5), "every node at the last sequence",
                    report=lambda: _stall_report(services))
        await _wait(lambda: asyncio.sleep(0, result=services[0].recovery.state == "live"),
                    "node 0 live again")
        ledger = _replay([per_client[c] + nudge[c] for c in range(4)], clients)
        for i, cfg in enumerate(cfgs):
            async with Client(f"http://{cfg.rpc_address}") as conn:
                for kp in clients:
                    got = [await conn.get_last_sequence(kp.public), await conn.get_balance(kp.public)]
                    assert got == ledger[kp.public], (i, kp.public.hex()[:12])
        # K1's plain version ran on node 0's path (CPU tensors), before the
        # crash and after the restart
        assert [v.stats()["batches"] > 0 for v in plain] == [True, True]
    finally:
        for s in services:
            if not s._closing:
                await s.close()

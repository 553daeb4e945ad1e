"""The broker tier's codec and client directory: the port's twins of
``tests/test_distill.py``'s ``TestDistillCodec``, ``TestClientDirectory``
and ``TestReviewHardening``.

Every case runs the reference's steps on the port's modules
(``proto/distill.py``, ``node/directory.py``, ``ledger/checkpoint.py``,
``sim/net.py``, ``broker.py``) and holds the port against the JAX
package: the same numpy-seeded input through both gives the same frame
bytes, decoded entries, verdicts, directory answers and exports, and
the same counters. Every comparison is exact.
"""

import asyncio
import importlib

import numpy as np
import pytest

PACKAGES = ("at2_node_tpu_torch", "at2_node_tpu")
PORT, REF = PACKAGES

_U32_MAX = (1 << 32) - 1
_U64_MAX = (1 << 64) - 1


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _rows(rng, n: int, max_id: int = 500) -> list:
    """n plain entries (sender id, sequence, recipient, amount, signature)
    with unique (sender id, sequence) pairs and a mix of directory-id and
    raw-key recipients."""
    pairs, rows = set(), []
    while len(rows) < n:
        sid, seq = int(rng.integers(max_id)), int(rng.integers(1, 201))
        if (sid, seq) in pairs:
            continue
        pairs.add((sid, seq))
        recipient = int(rng.integers(1 << 20)) if rng.random() < 0.5 else rng.bytes(32)
        rows.append((sid, seq, recipient, int(rng.integers(1 << 40)), rng.bytes(64)))
    return rows


def _entries(pkg: str, rows: list) -> list:
    entry = _mod(pkg, "proto.distill").DistilledEntry
    return [entry(*r) for r in rows]


def _plain(entries: list) -> list:
    return [(e.sender_id, e.sequence, e.recipient, e.amount, e.signature) for e in entries]


def _distill(pkg: str, rows: list) -> tuple:
    """``distill`` of ``rows`` by ``pkg``: (frame, dropped)."""
    return _mod(pkg, "proto.distill").distill(_entries(pkg, rows))


def _decode_both(frame: bytes) -> list:
    """``frame`` decoded by each package, as plain rows; equal."""
    out = [_plain(_mod(pkg, "proto.distill").decode(frame)) for pkg in PACKAGES]
    assert out[0] == out[1]
    return out[0]


def _rejects(pkg: str, frame: bytes) -> bool:
    d = _mod(pkg, "proto.distill")
    try:
        d.decode(frame)
    except d.DistillError:
        return True
    return False


class TestDistillCodec:
    def test_roundtrip_property(self):
        rng = np.random.default_rng(1)
        for trial in range(50):
            rows = _rows(rng, int(rng.integers(1, 65)))
            (frame, dropped), (ref_frame, ref_dropped) = (_distill(pkg, rows) for pkg in PACKAGES)
            assert frame == ref_frame and dropped == ref_dropped == 0, f"trial {trial}"
            assert _decode_both(frame) == sorted(rows, key=lambda r: (r[0], r[1])), f"trial {trial}"

    def test_single_entry_edge(self):
        rows = [(0, 1, b"\x07" * 32, 0, b"\x01" * 64)]
        frame, _ = _distill(PORT, rows)
        assert frame == _distill(REF, rows)[0]
        assert _decode_both(frame) == rows

    def test_max_gap_edges(self):
        # the widest deltas in one frame: id 0 -> u64 max, a sequence of
        # u32 max, an amount of u64 max
        rows = [(0, _U32_MAX, 0, _U64_MAX, b"\x01" * 64), (_U64_MAX, 1, _U64_MAX - 1, 0, b"\x02" * 64)]
        frame, _ = _distill(PORT, rows)
        assert frame == _distill(REF, rows)[0]
        assert _decode_both(frame) == rows

    def test_distill_drops_exact_duplicates(self):
        rng = np.random.default_rng(2)
        first = (3, 9, 0, 5, rng.bytes(64))
        later = (3, 9, 1, 6, rng.bytes(64))  # the same slot, another body
        (frame, dropped), ref = (_distill(pkg, [first, later, first]) for pkg in PACKAGES)
        assert (frame, dropped) == ref and dropped == 2
        assert _decode_both(frame) == [first]  # the first submission wins

    @pytest.mark.parametrize("dup_kind", ["seq", "sender"])
    def test_duplicate_slot_unrepresentable(self, dup_kind):
        # a second entry on one (sender, seq) needs a zero delta, which
        # both decoders refuse: a broker cannot encode a duplicate
        frames = []
        for pkg in PACKAGES:
            d = _mod(pkg, "proto.distill")
            head = bytearray([d.MAGIC, d.VERSION])
            if dup_kind == "seq":
                for v in (1, 2, 5, 2):  # groups, entries, sender id, group size
                    d._write_varint(head, v)
                for delta in (1, 0):  # the second sequence repeats the first
                    for v in (delta, 1, 1):  # delta, recipient id 0, amount
                        d._write_varint(head, v)
            else:
                for v in (2, 2):
                    d._write_varint(head, v)
                for gid_delta in (5, 0):  # the second group repeats the id
                    for v in (gid_delta, 1, 1, 1, 1):
                        d._write_varint(head, v)
            frames.append(bytes(head) + b"\x00" * 128)
        assert frames[0] == frames[1]
        assert _rejects(PORT, frames[0]) and _rejects(REF, frames[0])

    def test_bounds(self):
        for pkg in PACKAGES:
            d = _mod(pkg, "proto.distill")
            with pytest.raises(d.DistillError):
                d.encode([])
        d, r = _mod(PORT, "proto.distill"), _mod(REF, "proto.distill")
        assert d.DISTILL_MAX_ENTRIES == r.DISTILL_MAX_ENTRIES
        rows = [(0, s + 1, 0, 1, b"\x00" * 64) for s in range(d.DISTILL_MAX_ENTRIES + 1)]
        for pkg in PACKAGES:
            mod = _mod(pkg, "proto.distill")
            with pytest.raises(mod.DistillError):
                mod.encode(_entries(pkg, rows))
        exact = rows[: d.DISTILL_MAX_ENTRIES]
        frame = d.encode(_entries(PORT, exact))
        assert frame == r.encode(_entries(REF, exact))
        assert len(_decode_both(frame)) == d.DISTILL_MAX_ENTRIES

    def test_strict_rejects(self):
        frame, _ = _distill(PORT, [(1, 1, b"\x05" * 32, 7, b"\x09" * 64)])
        for bad in (
            b"",
            frame[:3],
            frame[:-1],  # a truncated signature block
            frame + b"\x00",  # a trailing byte
            b"\x00" + frame[1:],  # bad magic
            bytes([frame[0], 0x7F]) + frame[2:],  # bad version
        ):
            assert _rejects(PORT, bad) and _rejects(REF, bad), bad.hex()


def _directory(pkg: str, **kw):
    return _mod(pkg, "node.directory").ClientDirectory(**kw)


def _keys(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


class TestClientDirectory:
    def test_strided_assignment_disjoint_and_idempotent(self):
        keys = _keys(11, 8)
        seen = []
        for pkg in PACKAGES:
            a, b = _directory(pkg, rank=0, total=3), _directory(pkg, rank=2, total=3)
            ids_a = [a.assign(k)[0] for k in keys[:4]]
            ids_b = [b.assign(k)[0] for k in keys[4:]]
            assert ids_a == [0, 3, 6, 9] and ids_b == [2, 5, 8, 11]
            assert a.assign(keys[0]) == (0, False)  # an idempotent re-register
            assert a.get(0) == keys[0] and a.id_of(keys[0]) == 0
            assert a.get(1) is None  # other strides unknown until gossip
            seen.append((ids_a, ids_b, a.export(), b.export()))
        assert seen[0] == seen[1]

    def test_apply_stride_and_first_binding(self):
        key, other, third = _keys(12, 3)
        answers = []
        for pkg in PACKAGES:
            d = _directory(pkg, rank=0, total=2)
            got = [
                d.apply(1, key, rank=1),  # rank 1's stride
                d.apply(3, key, rank=0),  # id 3 is not rank 0's
                d.apply(1, other, rank=1),  # a rebind: the first wins
                d.get(1) == key,
                d.apply(1, key, rank=1),  # a matching re-announce
                d.apply(5, b"\x00" * 32, rank=1),  # the zero key
                # gossip into our own stride moves the assign cursor past it
                d.apply(4, other, rank=0),
                d.assign(third),
            ]
            assert got == [True, False, False, True, True, False, True, (6, True)]
            answers.append((got, d.export()))
        assert answers[0] == answers[1]

    def test_export_import_roundtrip(self):
        keys = _keys(13, 5)
        exports = {}
        for pkg in PACKAGES:
            d = _directory(pkg, rank=1, total=2)
            for k in keys[:3]:
                d.assign(k)
            d.apply(0, keys[3], rank=0)
            exports[pkg] = (d, d.export())
        assert exports[PORT][1] == exports[REF][1]
        # each package imports the other's export
        for src, dst in ((PORT, REF), (REF, PORT), (PORT, PORT)):
            d, doc = exports[src]
            restored = _directory(dst, rank=1, total=2)
            assert restored.import_(doc) == 4
            for cid in (0, 1, 3, 5):
                assert restored.get(cid) == d.get(cid)
            assert restored.export() == doc

    async def test_checkpoint_roundtrip(self, tmp_path):
        keys = _keys(14, 3)
        d = _directory(PORT, rank=0, total=2)
        ids = [d.assign(k)[0] for k in keys]
        path = str(tmp_path / "ledger.json")
        await _mod(PORT, "ledger.checkpoint").save(
            path, _mod(PORT, "ledger.accounts").Accounts(), _mod(PORT, "ledger.recent").RecentTransactions(), d)
        for pkg in PACKAGES:  # each package resumes the port's snapshot
            restored = _directory(pkg, rank=0, total=2)
            ok = await _mod(pkg, "ledger.checkpoint").load(
                path, _mod(pkg, "ledger.accounts").Accounts(), _mod(pkg, "ledger.recent").RecentTransactions(),
                restored)
            assert ok is True
            assert [restored.id_of(k) for k in keys] == ids
            # the stride cursor is restored: the next assign does not collide
            cid, created = restored.assign(b"\x77" * 32)
            assert created and cid not in ids and cid == 2 * len(ids)

    async def test_checkpoint_without_directory_still_loads(self, tmp_path):
        path = str(tmp_path / "ledger.json")
        await _mod(PORT, "ledger.checkpoint").save(
            path, _mod(PORT, "ledger.accounts").Accounts(), _mod(PORT, "ledger.recent").RecentTransactions())
        for pkg in PACKAGES:
            d = _directory(pkg)
            ok = await _mod(pkg, "ledger.checkpoint").load(
                path, _mod(pkg, "ledger.accounts").Accounts(), _mod(pkg, "ledger.recent").RecentTransactions(), d)
            assert ok is True and len(d) == 0


def _replay_at_shifted_sequence(pkg: str) -> dict:
    """The reference's replay case on ``pkg``'s SimNet: a captured
    signature re-encoded at the sender's next sequence dies at ingress,
    and the sender's own next transfer still commits. What it saw."""
    net_mod, distill = _mod(pkg, "sim.net"), _mod(pkg, "proto.distill")
    transfer_signing_bytes = _mod(pkg, "types").transfer_signing_bytes
    net = net_mod.SimNet(4, 1, 903, hostile=0).start()
    seen: dict = {}
    try:
        run = net.loop.run_until_complete
        client, rcpt = net_mod.sim_client(903, 0), net_mod.sim_client(903, 1).public
        cid = run(net.aregister(0, client.public))
        assert cid is not None

        def frame(rows):
            return distill.distill([
                distill.DistilledEntry(cid, seq, rcpt, amount, client.sign(
                    transfer_signing_bytes(client.public, seq, rcpt, amount)))
                for seq, amount in rows])[0]

        def sequences():
            return [run(s.accounts.get_last_sequence(client.public)) for s in net.services]

        seen["first"] = run(net.asubmit_distilled(0, frame([(1, 5), (2, 5)])))
        net.settle(horizon=60.0)
        seen["after_first"] = sequences()
        captured = distill.decode(frame([(2, 5)]))[0]
        replay = distill.distill([distill.DistilledEntry(cid, 3, rcpt, 5, captured.signature)])[0]
        seen["replay"] = run(net.asubmit_distilled(1, replay))
        net.settle(horizon=30.0)
        seen["rejected_at_ingress"] = net.services[1].admission_stats["rejected_at_ingress"]
        seen["after_replay"] = sequences()
        seen["own"] = run(net.asubmit_distilled(0, frame([(3, 7)])))
        net.settle(horizon=60.0)
        seen["after_own"] = sequences()
        net.touched.update((client.public, rcpt))
        seen["violations"] = net.check_invariants()
    finally:
        net.close()
    return seen


def _register_throttle(pkg: str) -> dict:
    """The reference's register throttle and stride-gated announce on
    ``pkg``'s SimNet. What it saw."""
    net_mod = _mod(pkg, "sim.net")
    DIR_ANNOUNCE = _mod(pkg, "broadcast.messages").DIR_ANNOUNCE
    net = net_mod.SimNet(2, 0, 904, hostile=0).start()
    seen: dict = {}
    try:
        run = net.loop.run_until_complete
        svc0 = net.services[0]
        # new assignments charge the per-source register bucket; a
        # re-registration of a known key stays free
        svc0.config.admission.register_limit = 2
        svc0.config.admission.register_window = 10_000.0
        k1, k2, k3 = (net_mod.sim_client(904, i).public for i in range(3))
        seen["registers"] = [run(net.aregister(0, k)) for k in (k1, k2, k3)]
        seen["throttled"] = svc0.admission_stats["admission_throttled"]
        seen["lookup"] = run(net.aregister(0, k1))
        net.settle(horizon=30.0)
        seen["gossiped"] = net.services[1].directory.get(seen["registers"][0]) == k1
        sent = []
        mesh1 = net.services[1].mesh
        orig = mesh1.broadcast

        def spy(frame, *a, **kw):
            sent.append(bytes(frame))
            return orig(frame, *a, **kw)

        mesh1.broadcast = spy
        seen["node1_lookup"] = run(net.aregister(1, k1))
        seen["announced_known"] = any(f and f[0] == DIR_ANNOUNCE for f in sent)
        seen["node1_new"] = run(net.aregister(1, net_mod.sim_client(904, 9).public))
        seen["announced_new"] = any(f and f[0] == DIR_ANNOUNCE for f in sent)
    finally:
        net.close()
    return seen


async def _collect_recheck(pkg: str, monkeypatch, seed: int) -> tuple:
    """The reference's broker buffer-cap race on ``pkg``'s broker: two
    ``_collect`` calls meet at the Register await with PENDING_CAP 3.
    (aborted calls, buffered entries, overflow drops)."""
    broker_mod, pb = _mod(pkg, "broker"), _mod(pkg, "proto.at2_pb2")
    kp = _mod(pkg, "crypto.keys").SignKeyPair(np.random.default_rng(seed).bytes(32))
    monkeypatch.setattr(broker_mod, "PENDING_CAP", 3)
    br = broker_mod.Broker("http://127.0.0.1:1", window=60.0)
    gate = asyncio.Event()

    async def slow_client_id(pubkey):
        await gate.wait()
        return 1

    br._client_id = slow_client_id

    class Ctx:
        def peer(self):
            return "test"

        async def abort(self, code, details=""):
            raise RuntimeError(f"abort {code}: {details}")

    def reqs(base):
        return [pb.SendAssetRequest(sender=kp.public, sequence=base + i, recipient=kp.public, amount=1,
                                    signature=b"\x01" * 64) for i in range(2)]

    try:
        tasks = [asyncio.ensure_future(br._collect(reqs(b), Ctx())) for b in (1, 10)]
        await asyncio.sleep(0)  # both pass the pre-check, both stall
        gate.set()
        results = await asyncio.gather(*tasks, return_exceptions=True)
        return (sum(isinstance(r, RuntimeError) for r in results), len(br._buf),
                br.stats["broker_overflow_drops"])
    finally:
        br._buf.clear()
        if br._flush_task is not None:
            br._flush_task.cancel()
        await br.close()


class TestReviewHardening:
    def test_directory_apply_bounds(self):
        answers = []
        for pkg in PACKAGES:
            mod = _mod(pkg, "node.directory")
            slack, cap = mod.APPLY_GAP_SLACK, mod.MAX_CLIENTS_PER_RANK
            d = mod.ClientDirectory(rank=0, total=2)
            got = [
                # an astronomical id in the announcer's own stride is
                # refused before any allocation
                d.apply(1 + 2 * (1 << 60), b"\x11" * 32, rank=1),
                len(d),
                d.apply(1 + 2 * cap, b"\x11" * 32, rank=1),  # the per-stride cap
                d.apply(1 + 2 * slack, b"\x12" * 32, rank=1),  # within the gap slack
                d.apply(1 + 2 * (2 * slack + 2), b"\x13" * 32, rank=1),  # past the advanced slack
                d.apply(1, b"\x14" * 32, rank=1),  # honest in-order announces
            ]
            assert got == [False, 0, False, True, False, True]
            answers.append((slack, cap, got, d.export()))
        assert answers[0] == answers[1]

    def test_directory_assign_cap(self, monkeypatch):
        answers = []
        for pkg in PACKAGES:
            mod = _mod(pkg, "node.directory")
            monkeypatch.setattr(mod, "MAX_CLIENTS_PER_RANK", 2)
            d = mod.ClientDirectory(rank=0, total=1)
            got = [d.assign(b"\x01" * 32), d.assign(b"\x02" * 32)]
            with pytest.raises(mod.DirectoryFullError):
                d.assign(b"\x03" * 32)
            got.append(d.assign(b"\x01" * 32))  # a known key at the cap
            assert got == [(0, True), (1, True), (0, False)]
            answers.append(got)
        assert answers[0] == answers[1]

    def test_replay_at_shifted_sequence_rejected(self):
        port = _replay_at_shifted_sequence(PORT)
        assert port["first"] is None and port["replay"] is None and port["own"] is None
        assert port["after_first"] == port["after_replay"] == [2] * 4
        assert port["rejected_at_ingress"] >= 1
        assert port["after_own"] == [3] * 4 and port["violations"] == []
        assert port == _replay_at_shifted_sequence(REF)

    def test_register_throttle_and_stride_gated_announce(self):
        port = _register_throttle(PORT)
        cid1 = port["registers"][0]
        assert cid1 is not None and port["registers"][1] is not None and port["registers"][2] is None
        assert port["throttled"] >= 1 and port["lookup"] == cid1 and port["gossiped"]
        assert port["node1_lookup"] == cid1 and not port["announced_known"]
        assert port["node1_new"] is not None and port["announced_new"]
        assert port == _register_throttle(REF)

    async def test_broker_collect_recheck_after_awaits(self, monkeypatch):
        port = await _collect_recheck(PORT, monkeypatch, 15)
        # one call aborts; the buffer never passes the cap of 3
        assert port == (1, 2, 2)
        assert port == await _collect_recheck(REF, monkeypatch, 15)

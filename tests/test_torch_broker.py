"""The broker ingress tier and its tools in the port against the JAX
package's.

* The round trip, real gRPC: clients -> port ``Broker`` -> distilled
  frames -> a port node -> commit on both nodes; the broker hop stitched
  by the port's ``trace_collect``; the broker's ``/healthz`` and
  ``/statusz``; the recorder codes of both sides.
* The capacity re-check after the ``Register`` awaits (``PENDING_CAP``
  patched on the port's module).
* Forged entries never commit: distilled frames sent straight to two
  in-process port nodes through the port's ``Client`` commit, dedup a
  replay, count a directory miss, refuse a malformed frame, and never
  commit a forged, re-priced or re-sequenced entry.
* Frame parity: the port's and the reference's ``Broker``, each in front
  of a recording stub node, take the same seeded submissions in the same
  order (the ``max_entries`` trigger, a long window, the final flush at
  close) and forward byte-equal ``SendDistilledBatch`` frames.
* The tools: ``stitch`` (with the broker-hop decomposition),
  ``chrome_trace``, ``render_summary``, ``phase_overlap``,
  ``render_trace_lines``, ``render_frame`` and ``once_verdict`` of the
  port equal the reference's on the same dumps.

Every key and input is drawn from a numpy generator; comparisons are
exact.
"""

import asyncio
import json

import grpc
import numpy as np
import pytest

import chip_smoke
from at2_node_tpu import broker as ref_broker_mod
from at2_node_tpu.tools import top as ref_top
from at2_node_tpu.tools import trace_collect as ref_tc
from at2_node_tpu_torch import broker as broker_mod
from at2_node_tpu_torch.broker import Broker
from at2_node_tpu_torch.client import Client
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.node.config import VerifierConfig
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.proto import at2_pb2 as pb
from at2_node_tpu_torch.proto import distill
from at2_node_tpu_torch.proto.distill import DistilledEntry
from at2_node_tpu_torch.proto.rpc import At2Servicer, At2Stub, add_to_server
from at2_node_tpu_torch.tools import top as port_top
from at2_node_tpu_torch.tools import trace_collect as port_tc
from at2_node_tpu_torch.tools._common import make_net_configs
from at2_node_tpu_torch.types import transfer_signing_bytes

TIMEOUT = 20.0


def _keys(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [SignKeyPair(rng.bytes(32)) for _ in range(n)]


async def _until(pred, what, timeout=TIMEOUT):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if await pred():
            return
        await asyncio.sleep(0.05)
    raise TimeoutError(f"{what} not reached within {timeout} s")


def _two_nodes(seed: int):
    return make_net_configs(2, iter(chip_smoke.free_ports(4)), seed=seed,
                            verifier=VerifierConfig(kind="cpu"))


# -- the round trip -------------------------------------------------------------


async def test_broker_roundtrip_commits_and_stitches_the_hop():
    cfgs = _two_nodes(41)
    services = [await Service.start(c) for c in cfgs]
    broker_addr = f"127.0.0.1:{chip_smoke.free_ports(1)[0]}"
    broker = await Broker.start(f"http://{cfgs[0].rpc_address}", broker_addr, max_entries=16, window=0.01)
    try:
        (kp,) = _keys(42, 1)
        async with Client(f"http://{broker_addr}") as c:
            cid = await c.register(kp.public)
            assert await c.register(kp.public) == cid  # idempotent
            await c.send_asset_many(kp, [(s, kp.public, 1) for s in range(1, 21)])

            async def at_20(conn=c):
                return await conn.get_last_sequence(kp.public) == 20

            await _until(at_20, "commit read through the broker")  # the broker proxies reads
        async with Client(f"http://{cfgs[1].rpc_address}") as c1:
            # totality: node 1, which the broker never talked to, converges
            await _until(lambda: _seq_is(c1, kp.public, 20), "node 1 commits")
        await _until(lambda: asyncio.sleep(0, result=services[1].directory.get(cid) == kp.public),
                     "the directory gossip reaches node 1")
        assert services[0].distill_stats["distilled_batches_rx"] >= 1
        assert broker.stats["broker_entries_tx"] == 20
        assert broker.stats["broker_batches_tx"] >= 1

        status, _, body = broker.obs_http("/tracez")
        assert status == 200
        broker_dump = json.loads(body)
        assert broker_dump["node"] == f"broker:{broker.node_uri}"
        dumps = [s.tracez() for s in services] + [broker_dump]
        st = port_tc.stitch(dumps)
        assert st == ref_tc.stitch(dumps)
        assert st["coverage"]["with_broker"] >= 1
        hop_txs = [t for t in st["txs"] if "broker_hop" in t]
        assert hop_txs
        hop = hop_txs[0]["broker_hop"]
        assert {"queue_ms", "handoff_ms", "plane_ms", "total_ms", "bottleneck"} <= set(hop)
        assert hop["queue_ms"] >= 0 and hop["handoff_ms"] >= 0
        assert hop["total_ms"] >= hop["plane_ms"] > 0
        assert st["broker_hop"]["segments"]["total_ms"]["count"] == len(hop_txs)

        status, _, body = broker.obs_http("/healthz")
        hv = json.loads(body)
        assert status == 200 and hv["status"] == "ok" and hv["backpressure"] is False
        assert hv["role"] == "broker" and hv["pending"] == 0
        sz = json.loads(broker.obs_http("/statusz")[2])
        assert sz["role"] == "broker" and sz["health"]["status"] == "ok"
        assert sz["flush"]["count"] >= 1
        assert sz["pressure"]["level"] == "normal"
        assert b"at2_broker_entries_tx" in broker.obs_http("/metrics")[2]
        assert "flush" in {e[1] for e in broker.recorder.dump()["events"]}
        assert "distill_rx" in {e[1] for e in services[0].recorder.dump()["events"]}
    finally:
        await broker.close()
        for s in services:
            await s.close()


async def _seq_is(conn, key, want) -> bool:
    return await conn.get_last_sequence(key) == want


class _Ctx:
    def peer(self):
        return "test"

    async def abort(self, code, details=""):
        raise RuntimeError(f"abort {code}: {details}")


async def test_broker_collect_recheck_after_awaits(monkeypatch):
    """Two _collect calls interleaving at the Register await must not
    overshoot PENDING_CAP: the capacity check re-runs with no await point
    before the buffer extend."""
    monkeypatch.setattr(broker_mod, "PENDING_CAP", 3)
    br = Broker("http://127.0.0.1:1", window=60.0)
    gate = asyncio.Event()

    async def slow_client_id(pubkey):
        await gate.wait()
        return 1

    br._client_id = slow_client_id
    (kp,) = _keys(43, 1)

    def reqs(base):
        return [pb.SendAssetRequest(sender=kp.public, sequence=base + i, recipient=kp.public, amount=1,
                                    signature=b"\x01" * 64) for i in range(2)]

    try:
        tasks = [asyncio.ensure_future(br._collect(reqs(b), _Ctx())) for b in (1, 10)]
        await asyncio.sleep(0)  # both pass the pre-check, both stall
        gate.set()
        results = await asyncio.gather(*tasks, return_exceptions=True)
        aborted = [r for r in results if isinstance(r, RuntimeError)]
        assert len(aborted) == 1, results
        assert "RESOURCE_EXHAUSTED" in str(aborted[0])
        assert len(br._buf) == 2  # never overshot the cap of 3
        assert br.stats["broker_overflow_drops"] == 2
    finally:
        br._buf.clear()
        if br._flush_task is not None:
            br._flush_task.cancel()
        await br.close()


async def test_broker_refuses_bad_submissions_and_sets_its_constants():
    assert (broker_mod.PENDING_CAP, broker_mod.BACKPRESSURE_FRAC, broker_mod.EAGER_MIN_FRAC) == (
        ref_broker_mod.PENDING_CAP, ref_broker_mod.BACKPRESSURE_FRAC, ref_broker_mod.EAGER_MIN_FRAC)
    with pytest.raises(ValueError):
        Broker("http://127.0.0.1:1", max_entries=0)
    br = Broker("http://127.0.0.1:1", window=60.0)
    (kp,) = _keys(44, 1)
    try:
        for bad, what in ((dict(sender=b"x"), "keys must be 32 bytes"),
                          (dict(signature=b"\x01" * 63), "signature must be 64 bytes")):
            req = dict(sender=kp.public, sequence=1, recipient=kp.public, amount=1, signature=b"\x01" * 64)
            req.update(bad)
            with pytest.raises(RuntimeError, match=what):
                await br._collect([pb.SendAssetRequest(**req)], _Ctx())
        assert br._buf == [] and br.stats["broker_entries_rx"] == 0
    finally:
        await br.close()


# -- forged entries never commit ------------------------------------------------


def _frame(cid: int, client, rows) -> bytes:
    entries = [DistilledEntry(cid, seq, recipient, amount,
                              client.sign(transfer_signing_bytes(client.public, seq, recipient, amount)))
               for seq, recipient, amount in rows]
    return distill.distill(entries)[0]


class _Pair:
    """Two in-process port nodes and a client of each."""

    def __init__(self, seed):
        self.cfgs = _two_nodes(seed)

    async def __aenter__(self):
        self.services = [await Service.start(c) for c in self.cfgs]
        self.conns = [Client(f"http://{c.rpc_address}") for c in self.cfgs]
        return self

    async def __aexit__(self, *exc):
        for conn in self.conns:
            await conn.close()
        for s in self.services:
            await s.close()

    async def at(self, key, seq, balance_of=None, balance=None):
        async def ok():
            for conn in self.conns:
                if await conn.get_last_sequence(key) != seq:
                    return False
                if balance_of is not None and await conn.get_balance(balance_of) != balance:
                    return False
            return True
        await _until(ok, f"every node at sequence {seq}")


async def test_distilled_commit_dedup_miss_and_malformed():
    client, rcpt = _keys(45, 2)
    async with _Pair(46) as net:
        svc = net.services[0]
        cid = await net.conns[0].register(client.public)
        frame = _frame(cid, client, [(s, rcpt.public, 2) for s in (1, 2, 3)])
        await net.conns[0].send_distilled(frame)
        await net.at(client.public, 3, rcpt.public, 100_006)
        assert svc.distill_stats["distilled_batches_rx"] == 1
        # an exact replay: every slot already ingested, so dedup drops
        await net.conns[0].send_distilled(frame)
        assert svc.distill_stats["dedup_drops"] == 3
        assert await net.conns[0].get_last_sequence(client.public) == 3
        # an unknown sender id: a directory miss, no state change
        bogus = distill.distill([DistilledEntry(cid + 10**6, 1, rcpt.public, 1, b"\x05" * 64)])[0]
        await net.conns[1].send_distilled(bogus)
        assert net.services[1].distill_stats["directory_misses"] == 1
        # a malformed frame: the whole frame refused at the RPC
        with pytest.raises(grpc.aio.AioRpcError) as exc:
            await net.conns[0].send_distilled(b"\xd5\x01junk")
        assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT


async def test_forged_and_repriced_entries_never_commit():
    client, rcpt = _keys(47, 2)
    async with _Pair(48) as net:
        cid = await net.conns[0].register(client.public)
        # a broker that forges: a valid frame shape, a garbage signature
        forged = distill.distill([DistilledEntry(cid, 1, rcpt.public, 50, b"\x0f" * 64)])[0]
        await net.conns[0].send_distilled(forged)  # taken, but never admitted
        assert net.services[0].admission_stats["rejected_at_ingress"] == 1
        # an altered entry (the signature of another body): the broker
        # can neither redirect nor reprice a transfer
        signed = client.sign(transfer_signing_bytes(client.public, 1, rcpt.public, 1))
        repriced = distill.distill([DistilledEntry(cid, 1, rcpt.public, 9999, signed)])[0]
        await _until(lambda: asyncio.sleep(0, result=net.services[1].directory.get(cid) == client.public),
                     "the directory gossip reaches node 1")
        await net.conns[1].send_distilled(repriced)
        assert net.services[1].admission_stats["rejected_at_ingress"] == 1
        await asyncio.sleep(0.3)
        for conn in net.conns:
            assert await conn.get_last_sequence(client.public) == 0
            assert await conn.get_balance(rcpt.public) == 100_000
        # the client's own transfer at that slot still commits
        await net.conns[0].send_distilled(_frame(cid, client, [(1, rcpt.public, 1)]))
        await net.at(client.public, 1, rcpt.public, 100_001)


async def test_a_signature_re_encoded_at_another_sequence_never_commits():
    client, rcpt = _keys(49, 2)
    async with _Pair(50) as net:
        cid = await net.conns[0].register(client.public)
        await net.conns[0].send_distilled(_frame(cid, client, [(1, rcpt.public, 5), (2, rcpt.public, 5)]))
        await net.at(client.public, 2)
        captured = distill.decode(_frame(cid, client, [(2, rcpt.public, 5)]))[0]
        replay = distill.distill([DistilledEntry(cid, 3, rcpt.public, 5, captured.signature)])[0]
        await _until(lambda: asyncio.sleep(0, result=net.services[1].directory.get(cid) == client.public),
                     "the directory gossip reaches node 1")
        await net.conns[1].send_distilled(replay)
        assert net.services[1].admission_stats["rejected_at_ingress"] == 1
        await asyncio.sleep(0.3)
        for conn in net.conns:
            assert await conn.get_last_sequence(client.public) == 2
        # the slot is not burned: the client's own sequence 3 commits
        await net.conns[0].send_distilled(_frame(cid, client, [(3, rcpt.public, 7)]))
        await net.at(client.public, 3, rcpt.public, 100_017)


# -- frame parity: the two brokers ---------------------------------------------


class _Recorder(At2Servicer):
    """A stub node: deterministic directory ids, every distilled frame
    kept in arrival order."""

    def __init__(self):
        self.ids: dict = {}
        self.frames: list = []

    async def Register(self, request, context):
        cid = self.ids.setdefault(bytes(request.public_key), 7 + 3 * len(self.ids))
        return pb.RegisterReply(client_id=cid)

    async def SendDistilledBatch(self, request, context):
        self.frames.append(bytes(request.frame))
        return pb.SendAssetReply()


async def _frames_through(broker_cls, submissions, max_entries: int, per_call: int) -> list:
    """Start a stub node and a broker of ``broker_cls`` in front of it,
    send ``submissions`` in order (``per_call`` a SendAssetBatch, 1 = unary
    SendAsset), close the broker; the frames the stub received."""
    stub = _Recorder()
    server = grpc.aio.server()
    add_to_server(stub, server)
    node_port = server.add_insecure_port("127.0.0.1:0")
    await server.start()
    addr = f"127.0.0.1:{chip_smoke.free_ports(1)[0]}"
    broker = await broker_cls.start(f"http://127.0.0.1:{node_port}", addr, max_entries=max_entries,
                                    window=60.0)
    try:
        async with grpc.aio.insecure_channel(addr) as channel:
            conn = At2Stub(channel)
            for lo in range(0, len(submissions), per_call):
                chunk = submissions[lo:lo + per_call]
                if per_call == 1:
                    await conn.SendAsset(chunk[0])
                else:
                    await conn.SendAssetBatch(pb.SendAssetBatchRequest(transactions=chunk))
    finally:
        await broker.close()  # the final flush of what is left
        await server.stop(0)
    return stub.frames


def _submissions(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    clients = _keys(seed, 6)
    outsiders = [rng.bytes(32) for _ in range(3)]
    seqs = [0] * len(clients)
    out = []
    for _ in range(n):
        c = int(rng.integers(0, len(clients)))
        seqs[c] += 1
        # recipients: other clients (compressed to ids once registered) or raw keys
        r = int(rng.integers(0, len(clients) + len(outsiders)))
        recipient = clients[r].public if r < len(clients) else outsiders[r - len(clients)]
        amount = int(rng.integers(1, 1 << 20))
        out.append(pb.SendAssetRequest(
            sender=clients[c].public, sequence=seqs[c], recipient=recipient, amount=amount,
            signature=clients[c].sign(transfer_signing_bytes(clients[c].public, seqs[c], recipient, amount))))
    return out


@pytest.mark.parametrize("seed,n,max_entries,per_call", [
    (51, 40, 8, 1),  # unary SendAsset, a frame every 8
    (52, 150, 32, 5),  # SendAssetBatch of 5, frames of 32, a partial one at close
    (53, 60, 1024, 7),  # one frame, at close
])
async def test_brokers_forward_byte_equal_frames(seed, n, max_entries, per_call):
    submissions = _submissions(seed, n)
    mine = await _frames_through(Broker, submissions, max_entries, per_call)
    theirs = await _frames_through(ref_broker_mod.Broker, submissions, max_entries, per_call)
    assert mine == theirs
    assert len(mine) >= -(-n // max_entries)
    assert sum(len(distill.decode(f)) for f in mine) == n


# -- the tools ------------------------------------------------------------------


def _dump(node, records):
    return {"node": node, "live": [], "completed": records}


def _rec(seq, origin, stages, terminal="committed", sender="aa" * 32):
    return {"sender": sender, "seq": seq, "origin": origin, "terminal": terminal, "stages": stages}


def test_stitch_joins_and_attributes_stragglers():
    origin = _dump("n0", [_rec(1, True, [["ingress", 0.0, 100.0], ["echoed", 0.01, 100.01],
                                         ["committed", 0.05, 100.05]])])
    relay = _dump("n1", [_rec(1, False, [["echoed", 7.02, 100.02], ["committed", 7.09, 100.09]])])
    st = port_tc.stitch([relay, origin])  # polling order must not matter
    assert st == ref_tc.stitch([relay, origin]) == port_tc.stitch([origin, relay])
    assert st["coverage"] == {"txs": 1, "committed": 1, "stitched_committed": 1, "with_origin": 1,
                              "with_broker": 0}
    (tx,) = st["txs"]
    assert tx["stragglers"]["committed"] == ["n1", 0.09]
    assert port_tc.render_summary(st) == ref_tc.render_summary(st)


def test_stitch_broker_hop_decomposition():
    broker = _dump("broker:127.0.0.1:9", [_rec(1, False, [["broker_rx", 0.0, 99.96],
                                                          ["broker_flush", 0.03, 99.99]],
                                               terminal="broker_flush")])
    node = _dump("n0", [_rec(1, True, [["ingress", 0.0, 100.0], ["committed", 0.05, 100.05]])])
    st = port_tc.stitch([node, broker])
    assert st == ref_tc.stitch([node, broker])
    hop = st["txs"][0]["broker_hop"]
    assert (hop["rx"], hop["flush"], hop["queue_ms"], hop["handoff_ms"], hop["plane_ms"], hop["total_ms"]) == \
        (-0.04, -0.01, 30.0, 10.0, 50.0, 90.0)
    assert st["broker_hop"]["bottleneck_counts"] == {"plane_ms": 1}
    assert port_tc.chrome_trace(st) == ref_tc.chrome_trace(st)


def _random_dumps(seed: int) -> list:
    """Four nodes' and a broker's dumps of the same seeded transfers,
    with clock offsets, stragglers, dropped stages and unfinished ones."""
    rng = np.random.default_rng(seed)
    stages = ["ingress", "echoed", "ready", "delivered", "committed"]
    senders = [rng.bytes(32).hex() for _ in range(3)]
    dumps = [_dump(f"n{i}", []) for i in range(4)] + [_dump("broker:127.0.0.1:5", [])]
    offsets = [float(rng.uniform(-5, 5)) for _ in range(4)]
    for k in range(24):
        sender, seq = senders[k % 3], 1 + k // 3
        origin = int(rng.integers(0, 4))
        t0 = 100.0 + k * 0.01
        if rng.random() < 0.6:
            rx = t0 - float(rng.uniform(0.01, 0.05))
            dumps[4]["completed"].append(_rec(seq, False, [["broker_rx", 0.0, rx],
                                                           ["broker_flush", 0.01, rx + 0.01]],
                                              terminal="broker_flush", sender=sender))
        for i in range(4):
            if rng.random() < 0.15:
                continue
            keep = [s for s in stages if s != "ingress" or i == origin]
            if rng.random() < 0.2:
                keep = keep[:-1]
            rel, t, out = offsets[i], t0, []
            for s in keep:
                t += float(rng.uniform(0.001, 0.02))
                out.append([s, round(t - 100.0 + rel, 6), round(t, 6)])
            term = "committed" if keep[-1] == "committed" else "expired"
            dumps[i]["completed"].append(_rec(seq, i == origin, out, terminal=term, sender=sender))
    return dumps


@pytest.mark.parametrize("seed", [61, 62, 63])
def test_stitch_and_chrome_trace_equal_on_seeded_dumps(seed):
    dumps = _random_dumps(seed)
    st = port_tc.stitch(dumps)
    assert json.dumps(st, sort_keys=True) == json.dumps(ref_tc.stitch(dumps), sort_keys=True)
    assert st["coverage"]["txs"] == 24
    assert port_tc.chrome_trace(st) == ref_tc.chrome_trace(st)
    assert port_tc.render_summary(st) == ref_tc.render_summary(st)
    overlap = port_tc.phase_overlap(st)
    assert overlap == ref_tc.phase_overlap(st)
    assert port_tc.render_overlap(overlap) == ref_tc.render_overlap(overlap)


def test_top_tracez_tail_dedups_alike():
    dump = _dump("n0", [_rec(3, True, [["ingress", 0.0, 100.0], ["committed", 0.05, 100.05]])])
    mine, theirs = set(), set()
    first = port_top.render_trace_lines("127.0.0.1:7001", dump, mine)
    assert first == ref_top.render_trace_lines("127.0.0.1:7001", dump, theirs)
    assert len(first) == 1 and "committed" in first[0] and "50.00" in first[0]
    assert port_top.render_trace_lines("127.0.0.1:7001", dump, mine) == []


async def test_top_renders_nodes_and_a_broker_as_the_reference_does():
    """``render_frame`` and the ``--once`` gate over a finality node, a
    plain node, a broker and a node that is down (the build blocks
    dropped: the port's names torch where the reference's names jax)."""
    from at2_node_tpu_torch.node.config import FinalityConfig

    cfgs = make_net_configs(2, iter(chip_smoke.free_ports(4)), seed=64, verifier=VerifierConfig(kind="cpu"))
    cfgs[0].finality = FinalityConfig(enabled=True, quorum=1)
    services = [await Service.start(c) for c in cfgs]
    broker_addr = f"127.0.0.1:{chip_smoke.free_ports(1)[0]}"
    broker = await Broker.start(f"http://{cfgs[0].rpc_address}", broker_addr, window=60.0)
    try:
        rows = []
        for addr, sz in [(c.rpc_address, s.statusz()) for c, s in zip(cfgs, services)] + [
                (broker_addr, json.loads(broker.obs_http("/statusz")[2]))]:
            sz.pop("build", None)
            rows.append((addr, json.loads(json.dumps(sz, default=float))))
        rows.append(("127.0.0.1:1", ConnectionRefusedError("down")))
        assert port_top.render_frame(rows, 10.0, {}) == ref_top.render_frame(rows, 10.0, {})
        assert "final" in port_top.render_frame(rows, 10.0, {})
        for kw in ({}, {"cert_lag_deadline": 0}, {"lag_deadline": 1e9}):
            assert port_top.once_verdict(rows, 120.0, **kw) == ref_top.once_verdict(rows, 120.0, **kw)
        assert port_top.once_verdict(rows[:3], 120.0, cert_lag_deadline=0) == []
    finally:
        await broker.close()
        for s in services:
            await s.close()

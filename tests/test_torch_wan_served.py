"""Phase 15 of ``chip_smoke.py``: the served ``[wan]`` levers, a node's
rejoin from its own ``[checkpoint]`` with ``verify_ahead``, and a
``[membership]`` epoch change.

One case runs the phase with the host verifier at a toy size (two nets of
four ``server run`` nodes and a broker each, a rejoin, four in-process
nodes); the others hold the port against the reference package on the
same seeded inputs: the region-aware fanout order, a mixed fleet with
every ``[wan]`` lever on, the rejoin through catch-up with
``verify_ahead``, its occupancy gate, and a ``ConfigTx`` sequence. The
sim ``[wan]`` cells, the sim reconfiguration and the rejoin past the
horizon have twins already (``test_torch_scenarios.py``,
``test_torch_sim_campaigns.py``, ``test_torch_faults.py``).
"""

import asyncio
import dataclasses
import itertools

import numpy as np
import pytest

import chip_smoke
from at2_node_tpu.broadcast import messages as ref_messages
from at2_node_tpu.broadcast.messages import ConfigTx as RefConfigTx
from at2_node_tpu.crypto.keys import ExchangeKeyPair as RefExchangeKeyPair
from at2_node_tpu.crypto.keys import SignKeyPair as RefSignKeyPair
from at2_node_tpu.net.peers import Mesh as RefMesh
from at2_node_tpu.net.peers import Peer as RefPeer
from at2_node_tpu.node.config import Config as RefConfig
from at2_node_tpu.node.service import Service as RefService
from at2_node_tpu_torch.broadcast import messages
from at2_node_tpu_torch.broadcast.messages import (
    BATCH_ECHO,
    BATCH_READY,
    ECHO,
    READY,
    Attestation,
    BatchAttestation,
    ConfigTx,
)
from at2_node_tpu_torch.client import Client
from at2_node_tpu_torch.crypto.keys import ExchangeKeyPair, SignKeyPair
from at2_node_tpu_torch.net.peers import Mesh, Peer
from at2_node_tpu_torch.node.config import (
    CatchupConfig,
    CheckpointConfig,
    MembershipConfig,
    VerifierConfig,
    WanConfig,
)
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.tools._common import make_net_configs as _make_net_configs

from conftest import wait_until

_ports = itertools.count(32600)
REGIONS = ("eu", "eu", "us", "us")
LEVERS = dict(overlap_ready=True, region_fanout=True, verify_ahead=True, eager_broker=True)


def make_configs(n, **overrides):
    """Port Configs of an ``n``-node net on the host verifier."""
    return _make_net_configs(n, _ports, verifier=VerifierConfig(kind="cpu"), **overrides)


def with_wan(cfgs):
    """Every lever on, node i in REGIONS[i], the hints on every peer entry."""
    region = {c.sign_key.public: REGIONS[i] for i, c in enumerate(cfgs)}
    for i, cfg in enumerate(cfgs):
        cfg.wan = WanConfig(region=REGIONS[i], **LEVERS)
        cfg.nodes = [dataclasses.replace(p, region=region[p.sign_public]) for p in cfg.nodes]
    return cfgs


async def start(cfg, reference: bool):
    """A Service of either package from the port's Config."""
    if reference:
        return await RefService.start(RefConfig.loads(cfg.dumps()))
    return await Service.start(cfg)


async def test_chip_smoke_phase15_runs_with_the_cpu_kind(capsys):
    """15a-15c on the host verifier: every gate the host kind can hold
    holds inside the phase, which raises otherwise."""
    out = await chip_smoke.wan_path(9, "cpu", kind="cpu", paced_s=3.0, broker_per=4, burst_per=16,
                                    tail_per=16, m_clients=4, m_per=4)
    text = capsys.readouterr().out
    off, on, rejoin, member = out["wan_off"], out["wan_on"], out["rejoin"], out["membership"]
    assert off["broker_eager_flushes"] == 0 < on["broker_eager_flushes"]
    assert on["echo_ready_frames"] == on["echo_frames"] > 0
    assert on["ready_before_echo_quorum"] > off["ready_before_echo_quorum"]
    assert off["paced_committed"] == on["paced_committed"] > 0
    assert rejoin["tail"] == 16 * chip_smoke.WAN_BURST_CLIENTS
    assert rejoin["tail"] <= rejoin["catchup_applied"] <= rejoin["tail"] + rejoin["nudges"]
    assert rejoin["nudges"] == (chip_smoke.WAN_BURST_CLIENTS if rejoin["short_at_live"] else 0)
    assert rejoin["catchup_preverified"] > 0 and rejoin["states"][-1] == "live"
    assert all(p["dropped"] >= p["held"] for p in rejoin["pushed_out"].values())
    assert member["thresholds"] == (2, 2)
    assert [s["epoch"] for s in member["membership"]] == [1] * 4
    assert [s["evicted_final"] for s in member["membership"][:3]] == [1, 1, 1]
    assert member["membership"][0]["rejected"] == 1 and member["membership"][3]["evicted_self"]
    assert out["launches"] == 0  # the host kind launches no kernel
    assert "overlap_ready:" in text and "rejoins from its [checkpoint]" in text


def test_piggybacked_frames_decode_alike_in_both_packages():
    """``chip_smoke.piggybacked`` counts a frame once when it holds an
    Echo and a Ready of one slot, content and origin; the reference's
    parser reads the same frames as the same messages."""
    rng = np.random.default_rng(15)
    origin, sender, other = (rng.bytes(32) for _ in range(3))
    chash, sig = rng.bytes(32), rng.bytes(64)

    def att(phase, who=origin, h=chash):
        return Attestation(phase, who, sender, 7, h, sig)

    def batt(phase, who=origin):
        return BatchAttestation(phase, who, other, 3, chash, b"\x0f", sig)

    frames = [
        att(ECHO).encode() + att(READY).encode(),  # the piggyback
        att(ECHO).encode(),  # an Echo alone
        att(ECHO).encode() + att(READY, h=rng.bytes(32)).encode(),  # another content
        att(ECHO).encode() + att(READY, who=other).encode(),  # another origin
        batt(BATCH_ECHO).encode() + batt(BATCH_READY).encode(),  # the batched plane's
        att(READY).encode(),
    ]
    dump = {"records": [[0, origin.hex(), f[0], f.hex()] for f in frames]}
    assert chip_smoke.piggybacked(dump) == (5, 2)
    for f in frames:
        assert [m.encode() for m in messages.parse_frame(f)] == [m.encode() for m in ref_messages.parse_frame(f)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_fanout_order_is_the_references(seed):
    """The same peers, region hints and injected RTT EWMAs give the same
    nearest-first order in both packages, with unhinted peers, unmeasured
    peers and ties among them."""
    rng = np.random.default_rng([15, seed])
    n = 9
    signs = [rng.bytes(32) for _ in range(n)]
    exch_seeds = [rng.bytes(32) for _ in range(n)]
    regions = [["", "eu", "us", "ap"][int(rng.integers(0, 4))] for _ in range(n)]
    # RTTs from a small set (ties), some peers unmeasured
    rtts = [None if rng.random() < 0.3 else float(rng.choice([0.001, 0.002, 0.002, 0.05])) for _ in range(n)]
    own = ["eu", "us", ""][seed % 3]
    orders = []
    for peer_cls, mesh_cls, exch_cls in ((Peer, Mesh, ExchangeKeyPair), (RefPeer, RefMesh, RefExchangeKeyPair)):
        exch = [exch_cls(s) for s in exch_seeds]
        peers = [peer_cls(f"127.0.0.1:{40000 + j}", exch[j].public, signs[j], regions[j]) for j in range(1, n)]

        async def on_frame(peer, frame):
            return None

        mesh = mesh_cls("127.0.0.1:40000", exch[0], peers, on_frame, region_fanout=True, region=own)
        for j, p in enumerate(peers, start=1):
            if rtts[j] is not None:
                mesh._rtt_ewma[p.exchange_public] = rtts[j]
        orders.append([p.exchange_public for p in mesh._fanout_order()])
    assert orders[0] == orders[1]
    # the port's order itself: same-region peers first (when both hints are set)
    pubs = [ExchangeKeyPair(s).public for s in exch_seeds]
    near = {pubs[j] for j in range(1, n) if own and regions[j] == own}
    assert set(orders[0][:len(near)]) == near and len(orders[0]) == n - 1


async def test_mixed_fleet_with_every_wan_lever_commits_alike():
    """Two reference and two port nodes, every ``[wan]`` lever on and
    each node in its region, commit the same transfers with equal
    ledgers; the Ready piggybacked on the Echo reaches each package from
    the other (each node's capture holds such frames from a node of the
    other package)."""
    rng = np.random.default_rng(1515)
    cfgs = with_wan(make_configs(4))
    services = [await start(c, reference=i < 2) for i, c in enumerate(cfgs)]
    senders = [SignKeyPair(rng.bytes(32)) for _ in range(8)]
    transfers = chip_smoke.more_transfers(rng, senders, 1, 6)
    try:
        async def send(c):
            async with Client(f"http://{cfgs[c % 4].rpc_address}") as conn:
                for seq, recipient, amount in transfers[c]:
                    await conn.send_asset(senders[c], seq, recipient, amount)

        await asyncio.gather(*(send(c) for c in range(len(senders))))

        async def all_committed():
            return all(s.committed >= 48 for s in services)

        await wait_until(all_committed, what="every transfer on all four nodes")
        ledgers = [await s.accounts.export_state() for s in services]
        replay = chip_smoke.replay_ledger([(kp.public, *t) for kp, ts in zip(senders, transfers) for t in ts])
        assert ledgers == [replay] * 4
        for i, s in enumerate(services):
            from_other = {c.sign_key.public.hex() for j, c in enumerate(cfgs) if (j < 2) != (i < 2)}
            dump = s.mesh.capture_dump()
            kept = {"records": [r for r in dump["records"] if r[1] in from_other]}
            assert chip_smoke.piggybacked(kept)[1] > 0, f"node {i} saw no piggybacked Ready from the other package"
    finally:
        for s in services:
            await s.close()


def _drop_gossip_replay(service, msgs, late_peer=None):
    """The victim's ingress drops replayed gossip content (the survivors'
    queued frames, as a long absence would have lost them): the tail can
    only come back through catch-up (as the reference's
    ``TestBeyondHorizonRejoin`` does). With ``late_peer``, that peer's
    history replies to the first session that asks for history are
    dropped too, as if they came after the session's window. Returns
    the ingress it replaced."""
    original = service.mesh.on_frame
    late_nonce = []

    def late(peer, m) -> bool:
        if late_peer is None or peer.sign_public != late_peer or not isinstance(m, msgs.HistoryBatch):
            return False
        if not late_nonce:
            late_nonce.append(m.nonce)
        return m.nonce == late_nonce[0]

    async def no_gossip_replay(peer, frame):
        kept = [m for m in msgs.parse_frame(frame)
                if not isinstance(m, (msgs.Payload, msgs.TxBatch)) and not late(peer, m)]
        if kept:
            await original(peer, b"".join(m.encode() for m in kept))

    service.mesh.on_frame = no_gossip_replay
    return original


async def _rejoin(reference: bool, tmp_path, quorum: int = 1, late: bool = False) -> dict:
    """Three nodes of one package; node 2 with ``[checkpoint]``,
    ``overlap_ready`` and ``verify_ahead``; 4 senders commit 1-3
    everywhere, node 2 stops, 4-7 commit on the others, node 2 restarts
    from its snapshot and catches up (with ``late``, node 0's history
    replies to its first history request are lost). Once its catch-up
    runner has ended: whether node 2 holds the tail; with ``late``, then
    an 8th transfer of each sender through node 0. At the end: node 2's
    counters and recovery state, and every ledger."""
    rng = np.random.default_rng(1516)
    cfgs = make_configs(3, echo_threshold=1, ready_threshold=1,
                        catchup=CatchupConfig(quorum=quorum, after=0.3))
    cfgs[2].wan = WanConfig(verify_ahead=True, overlap_ready=True)
    cfgs[2].checkpoint = CheckpointConfig(path=str(tmp_path / f"node2-{int(reference)}.ckpt"), interval=0)
    senders = [SignKeyPair(rng.bytes(32)) for _ in range(4)]
    transfers = chip_smoke.more_transfers(rng, senders, 1, 8)
    services = [await start(c, reference) for c in cfgs]
    msgs = ref_messages if reference else messages
    try:
        async def send(lo, hi, to):
            async with Client(f"http://{cfgs[to].rpc_address}") as conn:
                for kp, ts in zip(senders, transfers):
                    for seq, recipient, amount in ts[lo:hi]:
                        await conn.send_asset(kp, seq, recipient, amount)

        async def at(nodes, seq):
            for s in nodes:
                for kp in senders:
                    if await s.accounts.get_last_sequence(kp.public) < seq:
                        return False
            return True

        await send(0, 3, 0)
        await wait_until(lambda: at(services, 3), what="1-3 everywhere")
        await services[2].close()
        await send(3, 7, 1)
        await wait_until(lambda: at(services[:2], 7), what="4-7 on the survivors")
        services[2] = await start(cfgs[2], reference)
        ingress = _drop_gossip_replay(services[2], msgs, cfgs[0].sign_key.public if late else None)
        victim = services[2]

        async def runner_ended():
            return victim._catchup_task.done()

        await wait_until(runner_ended, timeout=60.0, what="the catch-up runner ended")
        caught_up = await at(services, 7)
        last = 7
        if late:  # the absence is over: new traffic reaches node 2 whole
            victim.mesh.on_frame = ingress
            await send(7, 8, 0)
            last = 8
            await wait_until(lambda: at(services, 8), what="node 2 level after the 8th transfer")
        return {
            "caught_up": caught_up,
            "applied": victim.catchup_stats["catchup_applied"],
            "preverified": victim.catchup_stats["catchup_preverified"],
            "state": victim.recovery.state,
            "ledgers": [await s.accounts.export_state() for s in services],
            "replay": chip_smoke.replay_ledger([(kp.public, *t) for kp, ts in zip(senders, transfers)
                                                for t in ts[:last]]),
        }
    finally:
        for s in services:
            await s.close()


async def test_rejoin_from_checkpoint_preverifies_like_the_reference(tmp_path):
    """A port node and a reference node, each restored from its own
    checkpoint after the same gap among peers of its own package, apply
    the same tail by catch-up, pre-verify all of it during the quorum
    wait and reach the replay's ledger. The port's node reports
    ``catchup`` then ``live`` on its recovery block; the reference's
    stays ``cold`` (it walks the machine under ``[store]`` only)."""
    port = await _rejoin(False, tmp_path)
    ref = await _rejoin(True, tmp_path)
    tail = 4 * 4
    assert port["caught_up"] and ref["caught_up"]
    assert port["applied"] == ref["applied"] == tail
    assert port["preverified"] == ref["preverified"] == tail
    assert port["ledgers"] == [port["replay"]] * 3 and ref["ledgers"] == [ref["replay"]] * 3
    assert port["replay"] == ref["replay"]
    assert port["state"] == "live" and ref["state"] == "cold"


async def test_rejoin_session_short_of_its_quorum_ends_catchup_alike(tmp_path):
    """Catch-up quorum 2 of 2 peers, and node 0's history replies to the
    first session that asks for history are lost: that session applies
    nothing though its peers reported the node behind. The catch-up
    runner (the reference's, which the port keeps: the sim's pinned
    campaign hashes replay it) takes the answered session for caught up
    and ends with the node behind, in both packages; an 8th transfer of
    each sender parks on the node's sequence gate, kicks a new catch-up
    and brings it level, the tail applied by catch-up."""
    port = await _rejoin(False, tmp_path, quorum=2, late=True)
    ref = await _rejoin(True, tmp_path, quorum=2, late=True)
    assert not port["caught_up"] and not ref["caught_up"]
    for run in (port, ref):
        assert 16 <= run["applied"] <= 16 + 4
        assert run["ledgers"] == [run["replay"]] * 3
    assert port["replay"] == ref["replay"] and port["state"] == "live" and ref["state"] == "cold"


class _StubVerifier:
    """Every signature valid; ``stats()`` reports a queue depth; counts
    what it was asked to verify."""

    def __init__(self, depth: int) -> None:
        self.depth = depth
        self.verified = 0

    async def verify_many(self, items):
        self.verified += len(items)
        return [True] * len(items)

    def stats(self) -> dict:
        return {"queue_depth": self.depth}


class _ServingMesh:
    """Peers that answer catch-up requests at once from ``history``."""

    def __init__(self, svc, peers, msgs, history):
        self.svc, self.peers, self.msgs, self.history = svc, peers, msgs, history
        self.frontier = {}
        for p in history:
            self.frontier[p.sender] = max(self.frontier.get(p.sender, 0), p.sequence)

    def send(self, peer, frame):
        pass

    def broadcast(self, frame, exclude=()):
        m = self.msgs
        for msg in m.parse_frame(frame):
            for peer in self.peers:
                if isinstance(msg, m.HistoryIndexRequest):
                    self.svc._on_catchup(peer, m.HistoryIndex(msg.nonce, tuple(self.frontier.items())))
                elif isinstance(msg, m.HistoryRequest):
                    rows = tuple(p for p in self.history if p.sender == msg.sender
                                 and msg.from_seq <= p.sequence <= msg.to_seq)
                    self.svc._on_catchup(peer, m.HistoryBatch(msg.nonce, rows))


@pytest.mark.parametrize("depth", [0, 3])
async def test_verify_ahead_gate_reads_the_queue_depth_alike(depth):
    """One catch-up session with ``verify_ahead`` against peers that hold
    12 payloads this node lacks, the verifier a stub: idle (depth 0),
    every payload is pre-verified during the quorum wait and none after
    it; busy (depth 3), the gate skips every slice and the post-quorum
    check verifies every payload. Both packages alike."""
    results = []
    for reference in (False, True):
        msgs = ref_messages if reference else messages
        skp = RefSignKeyPair if reference else SignKeyPair
        rng = np.random.default_rng(1517)
        cfg = make_configs(3, catchup=CatchupConfig(quorum=2, window=0.02))[0]
        cfg.wan = WanConfig(verify_ahead=True)
        svc = RefService(RefConfig.loads(cfg.dumps())) if reference else Service(cfg)
        senders = [skp(rng.bytes(32)) for _ in range(3)]
        history = [msgs.Payload.create(kp, seq, msgs.ThinTransaction(rng.bytes(32), int(rng.integers(1, 51))))
                   for kp in senders for seq in range(1, 5)]
        svc.mesh = _ServingMesh(svc, cfg.nodes, msgs, history)
        svc.verifier = _StubVerifier(depth)
        responses, applied = await svc._catchup_once()
        results.append((responses, applied, svc.catchup_stats["catchup_preverified"], svc.verifier.verified,
                        [await svc.accounts.get_last_sequence(kp.public) for kp in senders]))
    assert results[0] == results[1]
    responses, applied, pre, verified, seqs = results[0]
    assert (responses, applied, verified, seqs) == (2, 12, 12, [4, 4, 4])
    assert pre == (12 if depth == 0 else 0)


async def _membership_run(reference: bool) -> list:
    """Three nodes of one package with ``[membership]``; at node 0: epoch 1
    (remove node 2, thresholds 1), epoch 1 again, epoch 5, an epoch 2
    signed by another key, then, once node 2's eviction is final, a
    valid epoch 2 (thresholds 1 again). Each node's epoch, thresholds
    and membership stats."""
    rng = np.random.default_rng(1518)
    skp, ctx = (RefSignKeyPair, RefConfigTx) if reference else (SignKeyPair, ConfigTx)
    admin, forger = skp(rng.bytes(32)), skp(rng.bytes(32))
    cfgs = make_configs(3, membership=MembershipConfig(admin_public=admin.public.hex(), grace=0.3))
    services = [await start(c, reference) for c in cfgs]
    try:
        async def meshed():
            return all(s.mesh.stats()["channels"] >= 4 for s in services)

        await wait_until(meshed, what="the mesh")
        evict = cfgs[2].sign_key.public.hex()
        s0 = services[0]
        s0._on_config_tx(None, ctx.create(admin, 1, {"remove": [evict], "echo_threshold": 1,
                                                      "ready_threshold": 1, "grace": 0.3}))

        async def at_epoch_1():
            return all(s.membership.epoch == 1 for s in services)

        await wait_until(at_epoch_1, what="epoch 1 everywhere")
        s0._on_config_tx(None, ctx.create(admin, 1, {"remove": [evict]}))
        s0._on_config_tx(None, ctx.create(admin, 5, {"echo_threshold": 2}))
        s0._on_config_tx(None, ctx.create(forger, 2, {"echo_threshold": 2}))

        async def final():
            return all(services[i].membership.stats()["evicted_final"] == 1 for i in (0, 1))

        await wait_until(final, what="node 2's eviction final on nodes 0-1")
        s0._on_config_tx(None, ctx.create(admin, 2, {"echo_threshold": 1, "ready_threshold": 1}))

        async def at_epoch_2():
            return all(services[i].membership.epoch == 2 for i in (0, 1))

        await wait_until(at_epoch_2, what="epoch 2 on nodes 0-1")
        await asyncio.sleep(0.3)
        return [(s.membership.epoch, s.broadcast.echo_threshold, s.broadcast.ready_threshold,
                 s.membership.stats()) for s in services]
    finally:
        for s in services:
            await s.close()


async def test_configtx_sequence_lands_alike_in_both_packages():
    """The same ConfigTx sequence gives equal epochs, thresholds and
    ``membership.stats()`` on every node of a port net and of a
    reference net: a duplicate is not counted, a gapped epoch and a
    forged signature are rejected, the evicted node stays at epoch 1."""
    port = await _membership_run(False)
    ref = await _membership_run(True)
    assert port == ref
    assert [p[0] for p in port] == [2, 2, 1]
    assert port[0][3]["rejected"] == 2 and port[0][3]["applied"] == 2
    assert port[2][3]["evicted_self"] and port[0][3]["evicted_final"] == 1

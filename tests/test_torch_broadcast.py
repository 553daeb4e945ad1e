"""The port's three-phase broadcast state machine
(``at2_node_tpu_torch/broadcast/stack.py``) against the JAX package's:

* the state-machine cases of the reference's own broadcast tests, driven
  through an in-memory mesh, run on both stacks;
* the same injected messages fed to a reference stack and a port stack
  with the same keys give the same delivered payloads and the same
  outbound frames, byte for byte (ed25519 signs deterministically);
* a seeded in-memory adversarial net (reordering, duplication, loss, a
  byzantine client equivocating across both planes) of port nodes, and of
  port and reference nodes mixed, keeps consistency and, without loss,
  totality.

Every key and schedule is seeded."""

import asyncio
import random
from types import SimpleNamespace

import numpy as np
import pytest

from at2_node_tpu.broadcast import messages as ref_msgs
from at2_node_tpu.broadcast import shards as ref_shards
from at2_node_tpu.broadcast import stack as ref_stack
from at2_node_tpu.crypto import keys as ref_keys
from at2_node_tpu.crypto import verifier as ref_verifier
from at2_node_tpu.net import peers as ref_peers
from at2_node_tpu_torch.broadcast import messages as port_msgs
from at2_node_tpu_torch.broadcast import shards as port_shards
from at2_node_tpu_torch.broadcast import stack as port_stack
from at2_node_tpu_torch.crypto import keys as port_keys
from at2_node_tpu_torch.crypto import verifier as port_verifier
from at2_node_tpu_torch.net import peers as port_peers

IMPLS = {
    "ref": SimpleNamespace(m=ref_msgs, stack=ref_stack, shards=ref_shards, SK=ref_keys.SignKeyPair,
                           Peer=ref_peers.Peer, verifier=ref_verifier.CpuVerifier),
    "port": SimpleNamespace(m=port_msgs, stack=port_stack, shards=port_shards, SK=port_keys.SignKeyPair,
                            Peer=port_peers.Peer, verifier=port_verifier.CpuVerifier),
}


class FakeMesh:
    """In-memory mesh: records outbound frames, exposes peer maps."""

    def __init__(self, peers):
        self.peers = peers
        self.by_sign = {p.sign_public: p for p in peers}
        self.by_exchange = {p.exchange_public: p for p in peers}
        self.sent = []
        self.unicast = []

    def broadcast(self, frame, exclude=()):
        self.sent.append(frame)

    def send(self, peer, frame):
        self.unicast.append((peer, frame))


class Net:
    """A broadcast endpoint of one implementation plus n_peers seeded
    signing identities, and seeded clients. With ``shards`` the endpoint
    is the sharded plane (``ShardedPlane``) under ``executor``, else the
    monolithic ``Broadcast``."""

    def __init__(self, impl: str, n_peers: int, seed: int = 0, workers: int = 4,
                 shards: int = 0, executor: str = "inline"):
        self.x = x = IMPLS[impl]
        self.rng = np.random.default_rng(seed)
        self.peer_keys = [x.SK(self.rng.bytes(32)) for _ in range(n_peers)]
        peers = [x.Peer(f"127.0.0.1:{9000 + i}", bytes([i + 1]) * 32, kp.public)
                 for i, kp in enumerate(self.peer_keys)]
        self.mesh = FakeMesh(peers)
        self.node_key = x.SK(self.rng.bytes(32))
        if shards:
            self.bcast = x.shards.ShardedPlane(self.node_key, self.mesh, x.verifier(mode="per_sig"),
                                               shards=shards, executor=executor, workers=workers)
        else:
            self.bcast = x.stack.Broadcast(self.node_key, self.mesh, x.verifier(mode="per_sig"),
                                           workers=workers)

    def client(self):
        return self.x.SK(self.rng.bytes(32))

    def payload(self, kp, seq=1, amount=10, recipient=b"r" * 32):
        return self.x.m.Payload.create(kp, seq, self.x.m.ThinTransaction(recipient, amount))

    def vote(self, peer_kp, payload, phase, chash=None):
        m = self.x.m
        chash = payload.content_hash() if chash is None else chash
        sig = peer_kp.sign(m.Attestation.signing_bytes(phase, payload.sender, payload.sequence, chash))
        return m.Attestation(phase, peer_kp.public, payload.sender, payload.sequence, chash, sig)

    def batch_vote(self, peer_kp, batch, phase, bits):
        m = self.x.m
        bitmap = bits.to_bytes((batch.count + 7) // 8, "little")
        sig = peer_kp.sign(m.BatchAttestation.signing_bytes(
            phase, batch.origin, batch.batch_seq, batch.content_hash(), bitmap))
        return m.BatchAttestation(phase, peer_kp.public, batch.origin, batch.batch_seq,
                                  batch.content_hash(), bitmap, sig)

    def sent_messages(self):
        return [msg for f in self.mesh.sent for msg in self.x.m.parse_frame(f)]

    async def inject(self, msg, peer=None):
        await self.bcast._inbox.put((peer, msg))

    async def settle(self, timeout=2.0):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while loop.time() < deadline:
            if self.bcast._inbox.empty():
                await asyncio.sleep(0.05)
                if self.bcast._inbox.empty():
                    return
            await asyncio.sleep(0.01)

    async def delivered_one(self):
        return await asyncio.wait_for(self.bcast.delivered.get(), 2)

    async def __aenter__(self):
        await self.bcast.start()
        return self

    async def __aexit__(self, *exc):
        await self.bcast.close()
        await self.bcast.verifier.close()


both = pytest.mark.parametrize("impl", ["ref", "port"])


# -- the reference's state-machine cases, on both stacks --------------------


@both
async def test_single_node_delivers_immediately(impl):
    async with Net(impl, 0) as net:  # no peers: thresholds 0
        sender = net.client()
        await net.bcast.broadcast(net.payload(sender))
        assert (await net.delivered_one()).sender == sender.public


@both
async def test_full_quorum_delivers(impl):
    async with Net(impl, 3) as net:
        p = net.payload(net.client())
        await net.bcast.broadcast(p)
        for phase in (net.x.m.ECHO, net.x.m.READY):
            for kp in net.peer_keys:
                await net.inject(net.vote(kp, p, phase))
        assert await net.delivered_one() == p
        kinds = [type(msg).__name__ for msg in net.sent_messages()]
        assert "Payload" in kinds
        phases = [msg.phase for msg in net.sent_messages() if hasattr(msg, "phase")]
        assert net.x.m.ECHO in phases and net.x.m.READY in phases


@both
async def test_below_threshold_does_not_deliver(impl):
    async with Net(impl, 3) as net:
        p = net.payload(net.client())
        await net.bcast.broadcast(p)
        for kp in net.peer_keys[:2]:
            await net.inject(net.vote(kp, p, net.x.m.ECHO))
        await net.settle()
        assert net.bcast.delivered.empty()


@both
async def test_invalid_payload_signature_dropped(impl):
    async with Net(impl, 0) as net:
        sender = net.client()
        bad = net.x.m.Payload(sender.public, 1, net.x.m.ThinTransaction(b"r" * 32, 10), b"\x01" * 64)
        await net.bcast.broadcast(bad)
        await net.settle()
        assert net.bcast.delivered.empty()
        assert net.bcast.stats["invalid_sig"] == 1


@both
async def test_attestation_from_unknown_origin_ignored(impl):
    async with Net(impl, 1) as net:
        p = net.payload(net.client())
        await net.bcast.broadcast(p)
        outsider = net.client()
        await net.inject(net.vote(outsider, p, net.x.m.ECHO))
        await net.inject(net.vote(outsider, p, net.x.m.READY))
        await net.settle()
        assert net.bcast.delivered.empty()


@both
async def test_duplicate_votes_count_once(impl):
    async with Net(impl, 2) as net:
        p = net.payload(net.client())
        await net.bcast.broadcast(p)
        for _ in range(3):
            await net.inject(net.vote(net.peer_keys[0], p, net.x.m.ECHO))
        await net.settle()
        assert net.bcast.delivered.empty()


@both
async def test_equivocating_sender_delivers_at_most_one(impl):
    async with Net(impl, 2) as net:
        sender = net.client()
        a, b = net.payload(sender, amount=10), net.payload(sender, amount=99)
        await net.bcast.broadcast(a)
        await net.bcast.broadcast(b)
        await net.settle()
        echoes = [msg for msg in net.sent_messages()
                  if isinstance(msg, net.x.m.Attestation) and msg.phase == net.x.m.ECHO]
        assert len(echoes) == 1
        for phase in (net.x.m.ECHO, net.x.m.READY):
            for kp in net.peer_keys:
                await net.inject(net.vote(kp, a, phase))
        assert await net.delivered_one() == a
        await net.settle()
        assert net.bcast.delivered.empty()


@both
async def test_ready_amplification_totality(impl):
    async with Net(impl, 2) as net:
        p = net.payload(net.client())
        await net.bcast.broadcast(p)
        for kp in net.peer_keys:
            await net.inject(net.vote(kp, p, net.x.m.READY))
        assert await net.delivered_one() == p
        phases = [msg.phase for msg in net.sent_messages() if hasattr(msg, "phase")]
        assert net.x.m.READY in phases


@both
async def test_forged_attestation_does_not_shadow_real_vote(impl):
    async with Net(impl, 1) as net:
        p = net.payload(net.client())
        await net.bcast.broadcast(p)
        m = net.x.m
        forged = m.Attestation(m.ECHO, net.peer_keys[0].public, p.sender, p.sequence,
                               p.content_hash(), b"\x02" * 64)
        await net.inject(forged)
        await net.settle()
        await net.inject(net.vote(net.peer_keys[0], p, m.ECHO))
        await net.inject(net.vote(net.peer_keys[0], p, m.READY))
        assert await net.delivered_one() == p


@both
async def test_missing_content_pulled_on_ready_quorum(impl):
    async with Net(impl, 2) as net:
        p = net.payload(net.client())
        for kp in net.peer_keys:
            await net.inject(net.vote(kp, p, net.x.m.READY))
        await net.settle()
        assert net.bcast.delivered.empty()
        requests = [msg for _, f in net.mesh.unicast for msg in net.x.m.parse_frame(f)
                    if isinstance(msg, net.x.m.ContentRequest)]
        assert requests, "node never requested the missing content"
        assert (requests[0].sender, requests[0].content_hash) == (p.sender, p.content_hash())
        await net.inject(p, peer=net.mesh.peers[0])
        assert await net.delivered_one() == p


@both
async def test_equivocating_peer_votes_count_for_one_content_only(impl):
    async with Net(impl, 2) as net:
        sender = net.client()
        a, b = net.payload(sender, amount=1), net.payload(sender, amount=2)
        await net.bcast.broadcast(a)
        await net.bcast.broadcast(b)
        await net.settle()
        echo = net.x.m.ECHO
        await net.inject(net.vote(net.peer_keys[0], a, echo))
        await net.inject(net.vote(net.peer_keys[0], b, echo))
        await net.inject(net.vote(net.peer_keys[1], a, echo))
        await net.settle()
        state = net.bcast._slots[a.slot]
        assert len(state.echoes[a.content_hash()]) == 2
        assert len(state.echoes[b.content_hash()]) == 0


@both
async def test_replayed_attestation_not_reverified(impl):
    async with Net(impl, 2) as net:
        p = net.payload(net.client())
        att = net.vote(net.peer_keys[0], p, net.x.m.ECHO)
        for _ in range(5):
            await net.inject(att)
        await net.settle()
        assert net.bcast.verifier.signatures_verified == 1


@both
async def test_delivered_slot_gossip_suppressed_after_compaction(impl):
    async with Net(impl, 0) as net:
        p = net.payload(net.client())
        await net.bcast.broadcast(p)
        await net.delivered_one()
        net.bcast._delivered_slots.add(p.slot)
        del net.bcast._slots[p.slot]
        await net.inject(p)
        await net.settle()
        assert p.slot not in net.bcast._slots and net.bcast.delivered.empty()


@both
async def test_quorate_content_admitted_past_content_cap(impl):
    async with Net(impl, 2) as net:
        sender = net.client()
        for i in range(net.x.stack.MAX_CONTENTS_PER_SLOT):
            await net.inject(net.payload(sender, amount=100 + i))
        await net.settle()
        target = net.payload(sender, amount=999)
        for kp in net.peer_keys:
            await net.inject(net.vote(kp, target, net.x.m.READY))
        await net.settle()
        assert net.bcast.delivered.empty()
        await net.inject(target, peer=net.mesh.peers[0])
        assert await net.delivered_one() == target


@both
async def test_content_request_served_from_held_content(impl):
    async with Net(impl, 2) as net:
        p = net.payload(net.client())
        await net.bcast.broadcast(p)
        await net.settle()
        await net.inject(net.x.m.ContentRequest(p.sender, p.sequence, p.content_hash()),
                         peer=net.mesh.peers[1])
        await net.settle()
        served = [(peer, msg) for peer, f in net.mesh.unicast for msg in net.x.m.parse_frame(f)
                  if isinstance(msg, net.x.m.Payload)]
        assert served and served[0] == (net.mesh.peers[1], p)
        assert net.bcast.stats["content_served"] == 1


@both
async def test_batch_slot_delivers_endorsed_entries_only(impl):
    """The batched plane: a peer's batch with one badly signed entry; the
    node endorses the others, and per-entry quorums deliver exactly them."""
    async with Net(impl, 3) as net:
        m = net.x.m
        clients = [net.client() for _ in range(4)]
        entries = [net.payload(kp, seq=1, amount=5 + i) for i, kp in enumerate(clients)]
        bad = m.Payload(entries[2].sender, 1, entries[2].transaction, b"\x03" * 64)
        entries[2] = bad
        batch = m.TxBatch.create(net.peer_keys[0], 1, b"".join(p.encode()[1:] for p in entries))
        await net.inject(batch, peer=net.mesh.peers[0])
        await net.settle()
        own = [msg for msg in net.sent_messages()
               if isinstance(msg, m.BatchAttestation) and msg.phase == m.BATCH_ECHO]
        assert len(own) == 1 and int.from_bytes(own[0].bitmap, "little") == 0b1011
        assert net.bcast.stats["invalid_sig"] == 1
        for phase in (m.BATCH_ECHO, m.BATCH_READY):
            for kp in net.peer_keys:
                await net.inject(net.batch_vote(kp, batch, phase, 0b1011))
        got = {(await net.delivered_one()).encode() for _ in range(3)}
        assert got == {entries[i].encode() for i in (0, 1, 3)}
        await net.settle()
        assert net.bcast.delivered.empty()


# -- the same messages through both stacks -----------------------------------


async def _scripted_run(impl: str, seed: int, shards: int = 0, executor: str = "inline"):
    """A fixed script of local submissions and peer messages (both
    planes, an equivocating client, a tampered entry, a content pull);
    returns what the node delivered and sent (``sent_in_order``: the
    broadcast frames in the order the node sent them)."""
    net = Net(impl, 3, seed=seed, shards=shards, executor=executor)
    m = net.x.m
    async with net:
        clients = [net.client() for _ in range(4)]
        pays = [net.payload(kp, seq=s, amount=3 * s + c) for c, kp in enumerate(clients)
                for s in (1, 2)]
        for p in pays:
            await net.bcast.broadcast(p)
        await net.settle()
        equiv = net.client()
        first, second = net.payload(equiv, amount=1), net.payload(equiv, amount=2)
        await net.bcast.broadcast(first)
        await net.settle()
        await net.bcast.broadcast(second)
        await net.settle()
        for phase in (m.ECHO, m.READY):
            for kp in net.peer_keys:
                for p in pays + [first]:
                    await net.inject(net.vote(kp, p, phase))
            await net.settle()
        # a payload known only through its Ready quorum: pulled, then served
        late = net.payload(net.client(), amount=77)
        for kp in net.peer_keys:
            await net.inject(net.vote(kp, late, m.READY))
        await net.settle()
        await net.inject(late, peer=net.mesh.peers[1])
        await net.settle()
        # the batched plane: a peer's batch with one tampered entry
        entries = [net.payload(net.client(), seq=1, amount=40 + i) for i in range(5)]
        entries[3] = m.Payload(entries[3].sender, 1, entries[3].transaction, b"\x05" * 64)
        batch = m.TxBatch.create(net.peer_keys[1], 9, b"".join(p.encode()[1:] for p in entries))
        await net.inject(batch, peer=net.mesh.peers[1])
        await net.settle()
        for phase in (m.BATCH_ECHO, m.BATCH_READY):
            for kp in net.peer_keys:
                await net.inject(net.batch_vote(kp, batch, phase, 0b10111))
            await net.settle()
        delivered = []
        while not net.bcast.delivered.empty():
            delivered.append(net.bcast.delivered.get_nowait().encode())
        return {
            "delivered": sorted(delivered),
            "sent_in_order": list(net.mesh.sent),
            "sent": sorted(net.mesh.sent),
            "unicast": sorted((peer.address, f) for peer, f in net.mesh.unicast),
            "stats": net.bcast.stats.as_dict(),
        }


@pytest.mark.parametrize("seed", [0, 1, 2])
async def test_same_messages_same_deliveries_and_frames(seed):
    ref = await _scripted_run("ref", seed)
    port = await _scripted_run("port", seed)
    assert len(port["delivered"]) == 8 + 1 + 1 + 4
    assert port["delivered"] == ref["delivered"]
    assert port["sent"] == ref["sent"]
    assert port["unicast"] == ref["unicast"]
    assert port["stats"] == ref["stats"]


# -- an adversarial in-memory net ---------------------------------------------


class _CountingVerifier:
    """A CPU verifier that tracks in-flight calls, so quiescence detection
    cannot race a worker parked inside an executor round-trip."""

    def __init__(self, impl: str):
        self.inner = IMPLS[impl].verifier(mode="per_sig")
        self.inflight = 0

    async def verify_many(self, items):
        self.inflight += 1
        try:
            return await self.inner.verify_many(items)
        finally:
            self.inflight -= 1

    async def close(self):
        await self.inner.close()


class _RoutedMesh:
    def __init__(self, net, index, peers):
        self.net, self.index, self.peers = net, index, peers
        self.by_sign = {p.sign_public: p for p in peers}
        self.by_exchange = {p.exchange_public: p for p in peers}

    def broadcast(self, frame, exclude=()):
        for p in self.peers:
            if p.exchange_public not in exclude:
                self.net.route(self.index, p, frame)

    def send(self, peer, frame):
        self.net.route(self.index, peer, frame)


class AdversarialNet:
    """N Broadcast endpoints (node i of implementation ``impls[i]``)
    joined by a network the test schedules: seeded reordering,
    duplication and loss."""

    def __init__(self, impls, rng, dup=0.2, drop=0.0):
        self.rng, self.dup, self.drop, self.n = rng, dup, drop, len(impls)
        seeds = [bytes([7, i]) * 16 for i in range(self.n)]
        self.impls = [IMPLS[i] for i in impls]
        self.keys = [x.SK(s) for x, s in zip(self.impls, seeds)]
        self.pending = []
        self.bcasts = []
        for i, x in enumerate(self.impls):
            peers = [x.Peer(f"sim{j}", bytes([j + 1]) * 32, self.keys[j].public)
                     for j in range(self.n) if j != i]
            self.bcasts.append(x.stack.Broadcast(self.keys[i], _RoutedMesh(self, i, peers),
                                                 _CountingVerifier(impls[i]), workers=2))

    def route(self, src, dst_peer, frame):
        dst = next(i for i, k in enumerate(self.keys) if k.public == dst_peer.sign_public)
        if self.rng.random() < self.drop:
            return
        # the sender as the destination's own package sees it
        src_as_seen = next(p for p in self.bcasts[dst].mesh.peers
                           if p.sign_public == self.keys[src].public)
        self.pending.append((dst, src_as_seen, frame))
        if self.rng.random() < self.dup:
            self.pending.append((dst, src_as_seen, frame))

    def _idle(self):
        return all(b._inbox.empty() and b.verifier.inflight == 0 for b in self.bcasts)

    async def run_to_quiescence(self, max_steps=1000):
        for _ in range(max_steps):
            if self.pending:
                self.rng.shuffle(self.pending)
                k = self.rng.randrange(1, len(self.pending) + 1)
                batch, self.pending = self.pending[:k], self.pending[k:]
                for dst, peer, frame in batch:
                    await self.bcasts[dst].on_frame(peer, frame)
            for _ in range(1000):
                if self._idle():
                    break
                await asyncio.sleep(0.005)
            if self._idle() and not self.pending:
                await asyncio.sleep(0.01)
                if self._idle() and not self.pending:
                    return
        raise AssertionError("network never quiesced")

    def delivered(self, i):
        q = self.bcasts[i].delivered
        return [q.get_nowait().encode() for _ in range(q.qsize())]

    async def __aenter__(self):
        for b in self.bcasts:
            await b.start()
        return self

    async def __aexit__(self, *exc):
        for b in self.bcasts:
            await b.close()
            await b.verifier.close()


def _wire_payload(kp, seq, amount):
    """A client-signed payload's wire bytes (the same in both packages)."""
    m = port_msgs
    return m.Payload.create(kp, seq, m.ThinTransaction(b"r" * 32, amount)).encode()


def _as(x, wire: bytes):
    return x.m.Payload.decode_body(wire[1:])


def _check_safety(deliveries, honest):
    """No double delivery, only client-signed payloads, and at most one
    content per (sender, sequence) across the net."""
    chosen = {}
    for node, wires in enumerate(deliveries):
        slots = set()
        for w in wires:
            p = port_msgs.Payload.decode_body(w[1:])
            assert p.slot not in slots, f"node {node} delivered {p.slot} twice"
            slots.add(p.slot)
            assert w in honest, f"node {node} delivered an unsigned payload"
            assert chosen.setdefault(p.slot, w) == w, f"two contents delivered for {p.slot}"


NETS = {"port": ["port"] * 4, "mixed": ["ref", "port", "ref", "port"]}


@pytest.mark.parametrize("layout", ["port", "mixed"])
@pytest.mark.parametrize("seed", [1, 7, 23, 51])
async def test_totality_and_consistency_lossless(layout, seed):
    rng = random.Random(seed)
    async with AdversarialNet(NETS[layout], rng, dup=0.25) as net:
        clients = [port_keys.SignKeyPair(bytes([seed, c]) * 16) for c in range(2)]
        slots, honest = set(), set()
        for client in clients:
            for seq in rng.sample(range(1, 4), 3):
                w = _wire_payload(client, seq, seq)
                honest.add(w)
                slots.add((client.public, seq))
                node = rng.randrange(net.n)
                await net.bcasts[node].broadcast(_as(net.impls[node], w))
        await net.run_to_quiescence()
        deliveries = [net.delivered(i) for i in range(net.n)]
        _check_safety(deliveries, honest)
        for node, wires in enumerate(deliveries):
            got = {port_msgs.Payload.decode_body(w[1:]).slot for w in wires}
            assert got == slots, f"node {node} missed {slots - got}"


@pytest.mark.parametrize("layout", ["port", "mixed"])
@pytest.mark.parametrize("seed", [3, 13, 37, 91])
async def test_consistency_under_loss_and_equivocation(layout, seed):
    rng = random.Random(seed)
    async with AdversarialNet(NETS[layout], rng, dup=0.2, drop=0.15) as net:
        honest_kp = port_keys.SignKeyPair(bytes([seed, 1]) * 16)
        byz = port_keys.SignKeyPair(bytes([seed, 2]) * 16)
        honest = set()
        for seq in (1, 2):
            w = _wire_payload(honest_kp, seq, 5)
            honest.add(w)
            node = rng.randrange(net.n)
            await net.bcasts[node].broadcast(_as(net.impls[node], w))
        for amount, node in ((111, 0), (222, 2)):
            w = _wire_payload(byz, 1, amount)
            honest.add(w)
            await net.bcasts[node].broadcast(_as(net.impls[node], w))
        await net.run_to_quiescence()
        _check_safety([net.delivered(i) for i in range(net.n)], honest)


@pytest.mark.parametrize("layout", ["port", "mixed"])
@pytest.mark.parametrize("seed", [7, 29, 61, 83])
async def test_batch_plane_consistency_under_loss_and_equivocation(layout, seed):
    """Conflicting (byz, 1) entries ride two nodes' batch slots and a third
    content the per-tx plane; the cross-plane entry registry keeps at most
    one content per slot network-wide."""
    rng = random.Random(seed)
    async with AdversarialNet(NETS[layout], rng, dup=0.2, drop=0.15) as net:
        honest_kp = port_keys.SignKeyPair(bytes([seed, 3]) * 16)
        byz = port_keys.SignKeyPair(bytes([seed, 4]) * 16)
        honest = {_wire_payload(honest_kp, seq, 5) for seq in (1, 2, 3)}
        raw = b"".join(sorted(w[1:] for w in honest))
        x0 = net.impls[0]
        await net.bcasts[0].broadcast_batch(x0.m.TxBatch.create(net.keys[0], 1, raw))
        for amount, node in ((111, 1), (222, 2)):
            w = _wire_payload(byz, 1, amount)
            honest.add(w)
            x = net.impls[node]
            await net.bcasts[node].broadcast_batch(x.m.TxBatch.create(net.keys[node], 7, w[1:]))
        w = _wire_payload(byz, 1, 333)
        honest.add(w)
        await net.bcasts[3].broadcast(_as(net.impls[3], w))
        await net.run_to_quiescence()
        _check_safety([net.delivered(i) for i in range(net.n)], honest)

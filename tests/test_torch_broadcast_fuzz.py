"""Randomized-schedule broadcast fuzz: safety under adversarial delivery.

The targeted state-machine tests (test_broadcast.py) pin known scenarios;
this tier drives FULL Broadcast instances for every node of a simulated
net through a seeded adversarial network — arbitrary interleaving,
duplication, and (in the consistency runs) message loss — and asserts the
AT2 safety invariants that must hold under ANY schedule:

* **consistency** (sieve): no two nodes ever deliver different contents
  for one (sender, sequence) slot, even when a byzantine client
  equivocates two signed contents for the same slot;
* **no double delivery**: a node delivers a slot at most once;
* **validity**: only client-signed payloads are ever delivered;
* **totality** (loss-free runs): every node delivers every honest slot.

The reference never tests these (its thresholds=n config sidesteps
faults entirely — SURVEY.md §7 hard part 3)."""

import asyncio
import random

import numpy as np
import pytest

from at2_node_tpu_torch.broadcast.messages import Payload, TxBatch
from at2_node_tpu_torch.broadcast.stack import Broadcast
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.crypto.verifier import CpuVerifier
from at2_node_tpu_torch.net.peers import Peer
from at2_node_tpu_torch.types import ThinTransaction


class _CountingVerifier:
    """A package's CpuVerifier that tracks in-flight verifications, so
    quiescence detection can't race a worker parked inside an executor
    round-trip."""

    def __init__(self, inner=None):
        self.inner = CpuVerifier() if inner is None else inner
        self.inflight = 0

    async def verify_many(self, items):
        self.inflight += 1
        try:
            return await self.inner.verify_many(items)
        finally:
            self.inflight -= 1

    async def close(self):
        await self.inner.close()


def _package(pkg):
    """The modules a net is made of, from the port (None) or ``pkg``."""
    import importlib
    import types

    if pkg is None:
        return types.SimpleNamespace(Broadcast=Broadcast, Peer=Peer, SignKeyPair=SignKeyPair,
                                     CpuVerifier=CpuVerifier)
    return types.SimpleNamespace(
        Broadcast=importlib.import_module(f"{pkg}.broadcast.stack").Broadcast,
        Peer=importlib.import_module(f"{pkg}.net.peers").Peer,
        SignKeyPair=importlib.import_module(f"{pkg}.crypto.keys").SignKeyPair,
        CpuVerifier=importlib.import_module(f"{pkg}.crypto.verifier").CpuVerifier,
    )


class AdversarialNet:
    """N Broadcast endpoints joined by a network the test schedules."""

    def __init__(self, n, rng, dup=0.2, drop=0.0, threshold=None, pkg=None, keys=None):
        """``pkg`` (default: the port's modules) names the package whose
        Broadcast, Peer, keys and verifier make the net; ``keys`` seeds
        the nodes' signing keys."""
        mods = _package(pkg)
        self.rng = rng
        self.dup = dup
        self.drop = drop
        self.n = n
        self.keys = [mods.SignKeyPair.random() if keys is None else mods.SignKeyPair(keys[i])
                     for i in range(n)]
        exchange = [bytes([i + 1]) * 32 for i in range(n)]
        self.all_peers = [
            mods.Peer(f"sim{i}", exchange[i], self.keys[i].public) for i in range(n)
        ]
        self.pending = []  # (dst_node, src_peer_as_seen_by_dst, frame)
        self.sent = [set() for _ in range(n)]  # the distinct frames each node sent
        self.bcasts = []
        for i in range(n):
            peers = [p for j, p in enumerate(self.all_peers) if j != i]
            mesh = _RoutedMesh(self, i, peers)
            self.bcasts.append(
                mods.Broadcast(
                    self.keys[i],
                    mesh,
                    _CountingVerifier(mods.CpuVerifier()),
                    echo_threshold=threshold,
                    ready_threshold=threshold,
                    workers=2,
                )
            )

    def route(self, src: int, dst_peer: Peer, frame: bytes) -> None:
        dst = next(
            i for i, p in enumerate(self.all_peers) if p is dst_peer
        )
        self.sent[src].add(frame)
        if self.rng.random() < self.drop:
            return
        src_as_seen = self.all_peers[src]
        self.pending.append((dst, src_as_seen, frame))
        if self.rng.random() < self.dup:
            self.pending.append((dst, src_as_seen, frame))

    async def start(self):
        for b in self.bcasts:
            await b.start()

    async def close(self):
        for b in self.bcasts:
            await b.close()
            await b.verifier.close()

    def _endpoints_idle(self) -> bool:
        """Every inbox drained and no worker parked inside a verifier
        executor round-trip. A worker holds its chunk synchronously from
        inbox-get to the verify await (no other awaits between, single
        event loop), so inbox-empty + inflight==0 cannot race a chunk
        into invisibility. The routed-frame queue (self.pending) is NOT
        part of this check — relays refill it by design; the outer loop
        consumes it."""
        return all(b._inbox.empty() for b in self.bcasts) and all(
            b.verifier.inflight == 0 for b in self.bcasts
        )

    async def run_to_quiescence(self, max_steps=1000):
        """Deliver pending frames in seeded-random order (relays refill
        the queue) until the network and every endpoint are drained."""
        for _ in range(max_steps):
            if self.pending:
                self.rng.shuffle(self.pending)
                k = self.rng.randrange(1, len(self.pending) + 1)
                batch, self.pending = self.pending[:k], self.pending[k:]
                for dst, peer, frame in batch:
                    await self.bcasts[dst].on_frame(peer, frame)
            # let workers drain what they have (they may emit new frames)
            for _ in range(1000):
                if self._endpoints_idle():
                    break
                await asyncio.sleep(0.005)
            if self._endpoints_idle() and not self.pending:
                await asyncio.sleep(0.01)
                if self._endpoints_idle() and not self.pending:
                    return
        raise AssertionError("network never quiesced")

    def delivered(self, i):
        out = []
        q = self.bcasts[i].delivered
        while not q.empty():
            out.append(q.get_nowait())
        return out


class _RoutedMesh:
    def __init__(self, net, index, peers):
        self.net = net
        self.index = index
        self.peers = peers
        self.by_sign = {p.sign_public: p for p in peers}
        self.by_exchange = {p.exchange_public: p for p in peers}

    def broadcast(self, frame, exclude=()):
        for p in self.peers:
            if p.exchange_public not in exclude:
                self.net.route(self.index, p, frame)

    def send(self, peer, frame):
        self.net.route(self.index, peer, frame)


def _signed_payload(client, seq, amount=5):
    return Payload.create(client, seq, ThinTransaction(b"r" * 32, amount))


def _check_safety(per_node_deliveries, honest_sigs):
    """The invariants that must hold under EVERY schedule."""
    chosen = {}  # slot -> content hash the network agreed on
    for node, payloads in enumerate(per_node_deliveries):
        seen_slots = set()
        for p in payloads:
            slot = (p.sender, p.sequence)
            assert slot not in seen_slots, f"node {node} delivered {slot} twice"
            seen_slots.add(slot)
            assert p.signature in honest_sigs[p.sender], (
                f"node {node} delivered an unsigned payload"
            )
            agreed = chosen.setdefault(slot, p.content_hash())
            assert agreed == p.content_hash(), (
                f"consistency violation at {slot}: two contents delivered"
            )


@pytest.mark.parametrize("seed", [1, 7, 23, 51])
async def test_totality_and_consistency_lossless_schedules(seed):
    """Dup + arbitrary reordering, no loss: every node must deliver every
    honest slot exactly once, with network-wide agreement. async-def so
    conftest's hang watchdog (with task-stack dumps) covers a wedge."""
    if True:
        rng = random.Random(seed)
        net = AdversarialNet(4, rng, dup=0.25, drop=0.0)
        await net.start()
        clients = [SignKeyPair.random() for _ in range(2)]
        slots = []
        honest_sigs = {}
        try:
            for client in clients:
                for seq in rng.sample(range(1, 4), 3):  # out-of-order seqs
                    p = _signed_payload(client, seq, amount=seq)
                    honest_sigs.setdefault(client.public, set()).add(p.signature)
                    slots.append((client.public, seq))
                    # submission lands at a random node
                    await net.bcasts[rng.randrange(net.n)].broadcast(p)
            await net.run_to_quiescence()
            deliveries = [net.delivered(i) for i in range(net.n)]
            _check_safety(deliveries, honest_sigs)
            for node, payloads in enumerate(deliveries):
                got = {(p.sender, p.sequence) for p in payloads}
                assert got == set(slots), (
                    f"node {node} missed slots: {set(slots) - got}"
                )
        finally:
            await net.close()


@pytest.mark.parametrize("seed", [3, 13, 37, 91])
async def test_consistency_under_loss_and_equivocation(seed):
    """Random loss + a byzantine client equivocating two contents for the
    SAME slot: totality is forfeit (loss), but consistency and validity
    must survive every schedule."""
    if True:
        rng = random.Random(seed)
        # default thresholds (= all peers): echo quorums must intersect, so
        # consistency is a real guarantee of this config — threshold 2 of
        # 3 peers would permit disjoint echo quorums and the invariant
        # would be violable by schedule, not by bug
        net = AdversarialNet(4, rng, dup=0.2, drop=0.15, threshold=None)
        await net.start()
        honest = SignKeyPair.random()
        byz = SignKeyPair.random()
        honest_sigs = {}
        try:
            for seq in (1, 2):
                p = _signed_payload(honest, seq)
                honest_sigs.setdefault(honest.public, set()).add(p.signature)
                await net.bcasts[rng.randrange(net.n)].broadcast(p)
            # equivocation: two validly-signed contents, one slot,
            # submitted at different nodes
            for amount, node in ((111, 0), (222, 2)):
                p = Payload.create(byz, 1, ThinTransaction(b"r" * 32, amount))
                honest_sigs.setdefault(byz.public, set()).add(p.signature)
                await net.bcasts[node].broadcast(p)
            await net.run_to_quiescence()
            _check_safety(
                [net.delivered(i) for i in range(net.n)], honest_sigs
            )
        finally:
            await net.close()


@pytest.mark.parametrize("seed", [7, 29, 61, 83])
async def test_batch_plane_consistency_under_loss_and_equivocation(seed):
    """The batched plane under the same adversarial schedules: random
    loss + dup, a byzantine client racing conflicting same-(sender, seq)
    entries through TWO different nodes' batch slots AND a third
    conflicting content over the per-tx plane. The cross-plane entry
    registry + per-entry quorum counting must keep consistency (at most
    one content per slot network-wide) under every schedule; totality is
    forfeit to loss by design."""
    if True:
        rng = random.Random(seed)
        net = AdversarialNet(4, rng, dup=0.2, drop=0.15, threshold=None)
        await net.start()
        honest = SignKeyPair.random()
        byz = SignKeyPair.random()
        honest_sigs = {}
        try:
            # an honest 3-entry batch slot from node 0
            entries = []
            for seq in (1, 2, 3):
                p = _signed_payload(honest, seq)
                honest_sigs.setdefault(honest.public, set()).add(p.signature)
                entries.append(p)
            raw = b"".join(p.encode()[1:] for p in entries)
            await net.bcasts[0].broadcast_batch(
                TxBatch.create(net.keys[0], 1, raw)
            )
            # byzantine client: conflicting (byz, 1) entries ride two
            # different honest nodes' batch slots
            for amount, node in ((111, 1), (222, 2)):
                p = Payload.create(byz, 1, ThinTransaction(b"r" * 32, amount))
                honest_sigs.setdefault(byz.public, set()).add(p.signature)
                await net.bcasts[node].broadcast_batch(
                    TxBatch.create(net.keys[node], 7, p.encode()[1:])
                )
            # ...and a third conflicting content over the per-tx plane
            p = Payload.create(byz, 1, ThinTransaction(b"r" * 32, 333))
            honest_sigs[byz.public].add(p.signature)
            await net.bcasts[3].broadcast(p)
            await net.run_to_quiescence()
            _check_safety(
                [net.delivered(i) for i in range(net.n)], honest_sigs
            )
        finally:
            await net.close()


@pytest.mark.parametrize("seed", [5, 19])
async def test_frames_and_deliveries_equal_the_reference(seed):
    """Differential: the same seeded nodes, clients and submissions on a
    lossless schedule through the reference's Broadcast and the port's:
    every node sends the same distinct frames (payloads, echoes, readies,
    batch frames: byte for byte) and delivers the same slots and
    contents."""
    import importlib

    results = []
    for pkg in ("at2_node_tpu", "at2_node_tpu_torch"):
        keys_rng = np.random.default_rng(seed)
        node_keys = [keys_rng.bytes(32) for _ in range(4)]
        client_keys = [keys_rng.bytes(32) for _ in range(3)]
        messages = importlib.import_module(f"{pkg}.broadcast.messages")
        types = importlib.import_module(f"{pkg}.types")
        mods = _package(pkg)
        net = AdversarialNet(4, random.Random(seed), dup=0.2, drop=0.0, pkg=pkg, keys=node_keys)
        await net.start()
        try:
            clients = [mods.SignKeyPair(k) for k in client_keys]
            for seq in (1, 2):
                for c, client in enumerate(clients[:2]):
                    p = messages.Payload.create(client, seq, types.ThinTransaction(b"r" * 32, 10 * seq + c))
                    await net.bcasts[(seq + c) % 4].broadcast(p)
            entries = [messages.Payload.create(clients[2], seq, types.ThinTransaction(b"s" * 32, seq))
                       for seq in (1, 2, 3)]
            await net.bcasts[1].broadcast_batch(
                messages.TxBatch.create(net.keys[1], 1, b"".join(p.encode()[1:] for p in entries)))
            await net.run_to_quiescence()
            delivered = [sorted((p.sender, p.sequence, p.content_hash()) for p in net.delivered(i))
                         for i in range(net.n)]
            results.append((net.sent, delivered))
        finally:
            await net.close()
    (ref_sent, ref_delivered), (port_sent, port_delivered) = results
    assert all(len(d) == 7 for d in port_delivered)
    assert port_delivered == ref_delivered
    assert port_sent == ref_sent

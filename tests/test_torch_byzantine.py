"""Live byzantine NODE test (SURVEY.md §7 hard part 3): a real hostile
peer speaking the real encrypted transport against a net of real
`Service` processes.

The broadcast fuzz tier covers equivocation at the state-machine and
schedule level (tests/test_broadcast_fuzz.py); here the adversary is a
live wire-level participant: it is listed in every correct node's config
(so its channels authenticate and its attestations verify — byzantine,
not Sybil), dials them over the real X25519/ChaCha20 transport, and

* gossips two CONFLICTING client-signed payloads for one slot to
  different subsets of the net (a double-spend attempt by an
  equivocating client, amplified by a colluding node);
* double-echoes: votes content A to some peers and content B to others
  for the same slot — the attack sieve's per-origin single-vote rule
  exists for;
* replays its own signed attestations verbatim (dedup must absorb);
* sends Ready votes for a fabricated content hash on a fresh slot.

Threshold math (this build counts votes over PEERS, self excluded —
broadcast/stack.py module docstring): for two correct nodes to deliver
CONFLICTING contents, each needs an echo quorum of t among its
n_peers = n-1 peers, and the two vote sets intersect in at least
2t - (n-1) peers; every correct peer echoes ONE content to everyone, so
each shared voter backing both quorums must be byzantine. Safety against
f byzantine therefore needs 2t - (n-1) > f. With n=5, t=3, f=1:
intersection >= 2 > 1 — equivocation cannot double-commit. Liveness
needs t reachable from correct peers alone: each correct node has
(n-1) - f = 3 = t correct peers. (A 4-node/t=2 config would NOT be
f=1-safe here: 2t - 3 = 1 quorum overlap can be exactly the byzantine
double-voter — one node more than classic BFT is the price of
self-excluded counting.)

The reference never exercises its stack against a byzantine peer (its
full-quorum config sidesteps faults entirely — rpc.rs:112-120); this
build's thresholds are configurable, so the tolerance is testable.
"""

import itertools

import pytest

from at2_node_tpu_torch.broadcast.messages import ECHO, READY, Attestation, Payload
from at2_node_tpu_torch.client import Client
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.net import transport
from at2_node_tpu_torch.node.config import Config, VerifierConfig
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.types import ThinTransaction
from at2_node_tpu_torch.tools._common import make_net_configs as _make_net_configs

from conftest import wait_until

_ports = itertools.count(31200)


def make_net_configs(n, ports, **overrides):
    """The reference conftest's ``make_net_configs`` on the port's tools,
    every node on the host verifier (the port's default kind is "cuda")."""
    return _make_net_configs(n, ports, verifier=VerifierConfig(kind="cpu"), **overrides)


FAUCET = 100_000


class _HostileNode:
    """The byzantine participant: authenticated channels to every correct
    node, crafted frames instead of a broadcast state machine."""

    def __init__(self, config: Config):
        self.sign = config.sign_key
        self.network = config.network_key
        self.channels = {}

    async def dial(self, cfgs):
        for i, cfg in enumerate(cfgs):
            host, _, port = cfg.node_address.rpartition(":")
            self.channels[i] = await transport.connect(
                host, int(port), self.network
            )

    async def send(self, node: int, *msgs) -> None:
        await self.channels[node].send(b"".join(m.encode() for m in msgs))

    def attest(self, phase, sender, sequence, chash) -> Attestation:
        sig = self.sign.sign(
            Attestation.signing_bytes(phase, sender, sequence, chash)
        )
        return Attestation(phase, self.sign.public, sender, sequence, chash, sig)

    def close(self):
        for ch in self.channels.values():
            ch.close()


class TestByzantineNode:
    @pytest.mark.asyncio
    async def test_equivocation_double_echo_replay_fabricated_ready(self):
        # n=5, f=1: 4 correct Services + the hostile node, thresholds 3
        # (see module docstring for why 3-of-4-peers is the f=1-safe
        # configuration under self-excluded vote counting)
        cfgs = make_net_configs(5, _ports, echo_threshold=3, ready_threshold=3)
        services = [await Service.start(c) for c in cfgs[:4]]
        hostile = _HostileNode(cfgs[4])
        equivocator = SignKeyPair.random()
        r1 = SignKeyPair.random().public
        r2 = SignKeyPair.random().public
        honest = SignKeyPair.random()
        honest_rcpt = SignKeyPair.random().public
        try:
            await hostile.dial(cfgs[:4])

            # -- attack 1: client equivocation amplified by the hostile
            # node: conflicting payloads for slot (equivocator, 1) —
            # A to nodes 0-2, B to node 3
            tx_a = ThinTransaction(r1, 10)
            tx_b = ThinTransaction(r2, 99)
            pay_a = Payload.create(equivocator, 1, tx_a)
            pay_b = Payload.create(equivocator, 1, tx_b)
            for i in range(3):
                await hostile.send(i, pay_a)
            await hostile.send(3, pay_b)

            # -- attack 2: double-echo — A to nodes 0/1, B to nodes 2/3
            echo_a = hostile.attest(
                ECHO, equivocator.public, 1, pay_a.content_hash()
            )
            echo_b = hostile.attest(
                ECHO, equivocator.public, 1, pay_b.content_hash()
            )
            await hostile.send(0, echo_a)
            await hostile.send(1, echo_a)
            await hostile.send(2, echo_b)
            await hostile.send(3, echo_b)

            # -- attack 3: replay the same signed attestation verbatim
            for _ in range(3):
                await hostile.send(0, echo_a)

            # -- attack 4: Ready votes for a fabricated content on a
            # fresh slot (equivocator, 2) nobody gossiped — one origin's
            # vote stays far below the ready threshold
            fake_ready = hostile.attest(READY, equivocator.public, 2, b"\x42" * 32)
            for i in range(4):
                await hostile.send(i, fake_ready)

            # -- liveness: honest traffic keeps committing on the
            # correct nodes (echo quorum 3 = the 3 correct peers each
            # node has; the byzantine node contributes nothing)
            async with Client(f"http://{cfgs[0].rpc_address}") as client:
                await client.send_asset(honest, 1, honest_rcpt, 25)

                async def honest_committed():
                    for s in services:
                        if await s.accounts.get_last_sequence(honest.public) < 1:
                            return False
                    return True

                await wait_until(honest_committed, what="honest tx on correct nodes")

                # the equivocated slot settles: content A deterministically
                # wins (B's echo votes at any correct node top out at
                # {node3, hostile} = 2 < 3, while A gathers the other
                # three correct echoes everywhere; node3 itself
                # sieve-delivers A from {node0,node1,node2} and the Ready
                # quorum {node0,node1,node2,node3} amplifies the rest)
                async def slot_settled():
                    for s in services:
                        if await s.accounts.get_last_sequence(
                            equivocator.public
                        ) < 1:
                            return False
                    return True

                await wait_until(slot_settled, what="equivocated slot settles")

            # -- safety: every correct node committed the SAME content
            seqs = {
                await s.accounts.get_last_sequence(equivocator.public)
                for s in services
            }
            assert seqs == {1}, seqs
            for s in services:
                assert await s.accounts.get_balance(r1) == FAUCET + 10
                assert await s.accounts.get_balance(r2) == FAUCET
                assert await s.accounts.get_balance(honest_rcpt) == FAUCET + 25
            # the fabricated-content slot (equivocator, 2) was never
            # DELIVERED anywhere: each node delivered exactly the honest
            # slot and the equivocated slot
            for s in services:
                assert s.broadcast.stats["delivered"] == 2, (
                    s.broadcast.stats
                )
        finally:
            hostile.close()
            for s in services:
                await s.close()


class TestMixedFleet:
    @pytest.mark.asyncio
    async def test_reference_and_port_nodes_settle_the_attack_alike(self):
        """Differential: the same attack (equivocation amplified by the
        hostile node, a double echo, a fabricated ready) on a fleet of
        two reference nodes and two port nodes, meshed with each other
        over the one wire protocol: every node, of either package,
        commits the same content for the equivocated slot and the honest
        transfer, and delivers the same two slots."""
        import numpy as np

        from at2_node_tpu.node.config import Config as RefConfig
        from at2_node_tpu.node.service import Service as RefService

        rng = np.random.default_rng(12)
        cfgs = make_net_configs(5, _ports, echo_threshold=3, ready_threshold=3)
        services = [await Service.start(c) for c in cfgs[:2]]
        services += [await RefService.start(RefConfig.loads(c.dumps())) for c in cfgs[2:4]]
        hostile = _HostileNode(cfgs[4])
        equivocator, honest = SignKeyPair(rng.bytes(32)), SignKeyPair(rng.bytes(32))
        r1, r2, honest_rcpt = rng.bytes(32), rng.bytes(32), rng.bytes(32)
        try:
            await hostile.dial(cfgs[:4])
            pay_a = Payload.create(equivocator, 1, ThinTransaction(r1, 10))
            pay_b = Payload.create(equivocator, 1, ThinTransaction(r2, 99))
            for i in range(3):
                await hostile.send(i, pay_a)
            await hostile.send(3, pay_b)
            echo_a = hostile.attest(ECHO, equivocator.public, 1, pay_a.content_hash())
            echo_b = hostile.attest(ECHO, equivocator.public, 1, pay_b.content_hash())
            for i, echo in enumerate((echo_a, echo_a, echo_b, echo_b)):
                await hostile.send(i, echo)
            fake_ready = hostile.attest(READY, equivocator.public, 2, b"\x42" * 32)
            for i in range(4):
                await hostile.send(i, fake_ready)
            async with Client(f"http://{cfgs[2].rpc_address}") as client:  # through a reference node
                await client.send_asset(honest, 1, honest_rcpt, 25)

            async def settled():
                for s in services:
                    for kp in (honest, equivocator):
                        if await s.accounts.get_last_sequence(kp.public) < 1:
                            return False
                return True

            await wait_until(settled, what="the honest transfer and the equivocated slot on every node")
            ledgers = [[await s.accounts.get_balance(k) for k in (r1, r2, honest_rcpt, equivocator.public)]
                       for s in services]
            assert ledgers[0] == [FAUCET + 10, FAUCET, FAUCET + 25, FAUCET - 10]
            assert ledgers[:2] == ledgers[2:]
            assert [s.broadcast.stats["delivered"] for s in services] == [2] * 4
        finally:
            hostile.close()
            for s in services:
                await s.close()

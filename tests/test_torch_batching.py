"""Batched-broadcast-plane tests (broadcast/stack.py module docstring).

One broadcast slot carries many client transactions; these tests pin the
properties the design argues for:

* per-entry quorum counting — an entry delivers exactly when enough
  distinct nodes endorsed IT (bitmaps, not whole batches);
* the cross-plane entry registry — a byzantine client racing conflicting
  same-(sender, sequence) transfers into two different honest nodes'
  batches (or one batch + the per-tx plane) can never get both contents
  echo-endorsed by one honest node, so with intersecting quorums at most
  one content commits network-wide;
* one conflicting/invalid entry never poisons its batch siblings;
* batch content pull (totality when the batch gossip is lost);
* the ingress batcher's size/window flush and the single-tx parity path
  (`batching.enabled = false` restores the reference surface,
  `at2-node/src/bin/server/rpc.rs:275-284`).
"""

import asyncio
import itertools

import pytest

from at2_node_tpu_torch.broadcast.messages import (
    BATCH_ECHO,
    BATCH_READY,
    BatchAttestation,
    BatchContentRequest,
    MAX_BATCH_ENTRIES,
    Payload,
    TxBatch,
    WireError,
    parse_frame,
)
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.node.config import BatchingConfig, VerifierConfig
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.types import ThinTransaction
from at2_node_tpu_torch.tools._common import make_net_configs as _make_net_configs

from conftest import wait_until

_ports = itertools.count(30000)


def make_net_configs(n, ports, **overrides):
    """The reference conftest's ``make_net_configs`` on the port's tools,
    every node on the host verifier (the port's default kind is "cuda")."""
    return _make_net_configs(n, ports, verifier=VerifierConfig(kind="cpu"), **overrides)


FAUCET = 100_000


def make_payload(keypair, seq=1, amount=10, recipient=b"r" * 32):
    return Payload.create(keypair, seq, ThinTransaction(recipient, amount))


def make_batch(origin_kp, payloads, batch_seq=1):
    raw = b"".join(p.encode()[1:] for p in payloads)
    return TxBatch.create(origin_kp, batch_seq, raw)


class TestWire:
    def test_batch_roundtrip(self):
        node = SignKeyPair.random()
        client = SignKeyPair.random()
        batch = make_batch(
            node, [make_payload(client, seq=s) for s in (1, 2, 3)], batch_seq=42
        )
        [decoded] = parse_frame(batch.encode())
        assert decoded == batch
        assert decoded.count == 3
        assert decoded.content_hash() == batch.content_hash()
        assert decoded.entries()[2].sequence == 3

    def test_attestation_roundtrip_and_domain_separation(self):
        kp = SignKeyPair.random()
        bm = bytes([0b101])
        args = (kp.public, 7, b"h" * 32, bm)
        sig = kp.sign(BatchAttestation.signing_bytes(BATCH_ECHO, *args))
        att = BatchAttestation(BATCH_ECHO, kp.public, *args[:3], bm, sig)
        [decoded] = parse_frame(att.encode())
        assert decoded == att
        # an echo signature can never be replayed as a ready (and the
        # bitmap is inside the signed bytes, so bits can't be forged on)
        assert BatchAttestation.signing_bytes(
            BATCH_ECHO, *args
        ) != BatchAttestation.signing_bytes(BATCH_READY, *args)
        assert BatchAttestation.signing_bytes(
            BATCH_ECHO, kp.public, 7, b"h" * 32, bytes([0b111])
        ) != BatchAttestation.signing_bytes(BATCH_ECHO, *args)

    def test_content_request_roundtrip(self):
        req = BatchContentRequest(b"o" * 32, 9, b"h" * 32)
        assert parse_frame(req.encode()) == [req]

    def test_oversized_batch_rejected(self):
        node = SignKeyPair.random()
        client = SignKeyPair.random()
        batch = make_batch(node, [make_payload(client)])
        # forge the count field beyond the cap
        enc = bytearray(batch.encode())
        enc[41:45] = (MAX_BATCH_ENTRIES + 1).to_bytes(4, "little")
        with pytest.raises(WireError):
            parse_frame(bytes(enc))

    def test_native_parser_parity(self):
        from at2_node_tpu_torch.native import ingest_available
        from at2_node_tpu_torch.native.ingest import parse_frames_native

        if not ingest_available():
            pytest.skip("native ingest unavailable")
        node = SignKeyPair.random()
        client = SignKeyPair.random()
        batch = make_batch(
            node, [make_payload(client, seq=s) for s in (1, 2)], batch_seq=5
        )
        bm = bytes([0b11])
        sig = node.sign(
            BatchAttestation.signing_bytes(
                BATCH_READY, node.public, 5, batch.content_hash(), bm
            )
        )
        att = BatchAttestation(
            BATCH_READY, node.public, node.public, 5, batch.content_hash(), bm, sig
        )
        req = BatchContentRequest(node.public, 5, batch.content_hash())
        frame = batch.encode() + att.encode() + req.encode()
        msgs, frame_ok = parse_frames_native([frame])
        assert list(frame_ok) == [True]
        assert [m for _, m in msgs] == parse_frame(frame) == [batch, att, req]
        # malformed batch (count overflows the cap) drops the whole frame
        bad = bytearray(batch.encode())
        bad[41:45] = (MAX_BATCH_ENTRIES + 1).to_bytes(4, "little")
        msgs2, frame_ok2 = parse_frames_native([bytes(bad), att.encode()])
        assert list(frame_ok2) == [False, True]
        assert [m for _, m in msgs2] == [att]


def make_configs(n, **kwargs):
    return make_net_configs(n, _ports, **kwargs)


async def start_net(n, **kwargs):
    cfgs = make_configs(n, **kwargs)
    services = []
    for c in cfgs:
        services.append(await Service.start(c))
    return cfgs, services


async def close_all(services):
    for s in services:
        await s.close()


async def submit(service, payload):
    """Feed one client payload through the node's ingress batcher."""
    await service.recent.put(payload.sender, payload.sequence, payload.transaction)
    service._batch_buf.append(payload)


class TestBatchDelivery:
    @pytest.mark.asyncio
    async def test_one_slot_commits_many_txs_on_all_nodes(self):
        cfgs, services = await start_net(4)
        try:
            sender = SignKeyPair.random()
            recipient = SignKeyPair.random().public
            for seq in range(1, 51):
                await submit(
                    services[0], make_payload(sender, seq=seq, recipient=recipient)
                )
            await services[0]._flush_batch()

            async def all_committed():
                return all(s.committed >= 50 for s in services)

            await wait_until(all_committed, what="batch entries commit")
            for s in services:
                assert await s.accounts.get_balance(recipient) == FAUCET + 500
                assert await s.accounts.get_last_sequence(sender.public) == 50
            # ONE slot: a handful of protocol messages, not 50 x 9
            st = services[0].broadcast.stats
            assert st["batch_rx"] >= 1
            assert st["batch_entries_delivered"] == 50
            assert st["gossip_rx"] == 0  # nothing rode the per-tx plane
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_invalid_entry_does_not_poison_siblings(self):
        cfgs, services = await start_net(3)
        try:
            sender = SignKeyPair.random()
            recipient = SignKeyPair.random().public
            good1 = make_payload(sender, seq=1, recipient=recipient)
            bad = Payload(  # garbage client signature
                sender.public,
                2,
                ThinTransaction(recipient, 10),
                b"\x01" * 64,
            )
            good2 = make_payload(sender, seq=3, recipient=recipient)
            for p in (good1, bad, good2):
                await submit(services[0], p)
            await services[0]._flush_batch()

            # seq 1 commits everywhere; seq 3 stays gap-blocked in the
            # heap (seq 2 never delivers) — the commit FRONTIER is 1
            async def seq1_committed():
                seqs = [
                    await s.accounts.get_last_sequence(sender.public)
                    for s in services
                ]
                return all(q >= 1 for q in seqs)

            await wait_until(seq1_committed, what="good sibling commits")
            await asyncio.sleep(0.2)
            for s in services:
                assert await s.accounts.get_last_sequence(sender.public) == 1
                # the invalid entry was never endorsed anywhere
                assert s.broadcast.stats["invalid_sig"] >= 1
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_standalone_invalid_entry_never_commits(self):
        """Degenerate thresholds (0) must NOT bypass client-signature
        verification: with no peer quorum to carry the argument, the
        delivery gate is the node's OWN endorsement bits — a forged
        entry in a standalone node's batch stays out of the ledger."""
        cfgs, services = await start_net(1)
        try:
            sender = SignKeyPair.random()
            recipient = SignKeyPair.random().public
            forged = Payload(
                sender.public, 1, ThinTransaction(recipient, 1000), b"\x03" * 64
            )
            good = make_payload(sender, seq=2, recipient=recipient, amount=7)
            for p in (forged, good):
                await submit(services[0], p)
            await services[0]._flush_batch()
            await asyncio.sleep(0.5)
            # the forged transfer never committed; seq 2 is gap-blocked
            # behind it (exactly like the per-tx plane would behave)
            assert await services[0].accounts.get_last_sequence(sender.public) == 0
            assert await services[0].accounts.get_balance(recipient) == FAUCET
            assert services[0].broadcast.stats["invalid_sig"] >= 1
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_single_node_standalone_batch(self):
        # degenerate net (no peers, thresholds 0) — mirrors the
        # reference's standalone-node shape
        # (at2-node/tests/server-config-resolve-addrs)
        cfgs, services = await start_net(1)
        try:
            sender = SignKeyPair.random()
            recipient = SignKeyPair.random().public
            for seq in (1, 2):
                await submit(
                    services[0], make_payload(sender, seq=seq, recipient=recipient)
                )
            await services[0]._flush_batch()

            async def committed():
                return services[0].committed >= 2

            await wait_until(committed, what="standalone batch commit")
            assert await services[0].accounts.get_balance(recipient) == FAUCET + 20
        finally:
            await close_all(services)


class TestByzantineClientConflicts:
    @pytest.mark.asyncio
    async def test_conflicting_entries_in_two_nodes_batches(self):
        """The attack the per-entry registry exists for: one byzantine
        client races two conflicting seq-1 transfers into two different
        honest ingress nodes. With echo_threshold = 3 (> n/2 of the 3
        peers each node counts), the two contents' Echo quorums must
        intersect in an honest node, which endorses only its first-bound
        content — so at most ONE of the transfers commits, identically
        on every node."""
        cfgs, services = await start_net(4)
        try:
            byz = SignKeyPair.random()
            alice = SignKeyPair.random().public
            bob = SignKeyPair.random().public
            pay_a = make_payload(byz, seq=1, amount=100, recipient=alice)
            pay_b = make_payload(byz, seq=1, amount=100, recipient=bob)
            await submit(services[0], pay_a)
            await submit(services[1], pay_b)
            await asyncio.gather(
                services[0]._flush_batch(), services[1]._flush_batch()
            )

            async def resolved():
                # every node must converge on the same outcome for seq 1
                seqs = [
                    await s.accounts.get_last_sequence(byz.public)
                    for s in services
                ]
                return all(q == 1 for q in seqs) or all(q == 0 for q in seqs)

            # give the net a moment; then assert NO divergence
            await asyncio.sleep(1.0)
            assert await resolved(), "nodes diverged on the conflicting slot"
            bal_a = [await s.accounts.get_balance(alice) for s in services]
            bal_b = [await s.accounts.get_balance(bob) for s in services]
            assert len(set(bal_a)) == 1, f"alice balances diverged: {bal_a}"
            assert len(set(bal_b)) == 1, f"bob balances diverged: {bal_b}"
            # at most one of the conflicting transfers landed
            assert not (
                bal_a[0] == FAUCET + 100 and bal_b[0] == FAUCET + 100
            ), "both conflicting transfers committed"
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_cross_plane_conflict_batch_vs_single_tx(self):
        """Same attack across PLANES: content X rides a batch from node
        0, conflicting content Y rides the per-tx plane via node 1. The
        shared entry registry must keep honest nodes from endorsing
        both."""
        cfgs, services = await start_net(4)
        try:
            byz = SignKeyPair.random()
            alice = SignKeyPair.random().public
            bob = SignKeyPair.random().public
            pay_x = make_payload(byz, seq=1, amount=50, recipient=alice)
            pay_y = make_payload(byz, seq=1, amount=50, recipient=bob)
            await submit(services[0], pay_x)
            await asyncio.gather(
                services[0]._flush_batch(),
                services[1].broadcast.broadcast(pay_y),  # per-tx plane
            )
            await asyncio.sleep(1.0)
            bal_a = [await s.accounts.get_balance(alice) for s in services]
            bal_b = [await s.accounts.get_balance(bob) for s in services]
            assert len(set(bal_a)) == 1, f"alice balances diverged: {bal_a}"
            assert len(set(bal_b)) == 1, f"bob balances diverged: {bal_b}"
            assert not (
                bal_a[0] == FAUCET + 50 and bal_b[0] == FAUCET + 50
            ), "both conflicting transfers committed"
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_byzantine_origin_batch_equivocation(self):
        """A byzantine NODE gossips two different batches under one
        (origin, batch_seq) slot. Node-level sieve (first content echoed
        per slot) keeps honest nodes split across at most the two
        contents; entries of at most one batch can quorate, and no node
        diverges."""
        cfgs, services = await start_net(4)
        try:
            byz_node_key = cfgs[0].sign_key  # node 0 plays byzantine
            client = SignKeyPair.random()
            alice = SignKeyPair.random().public
            bob = SignKeyPair.random().public
            batch_a = make_batch(
                byz_node_key,
                [make_payload(client, seq=1, recipient=alice)],
                batch_seq=777,
            )
            batch_b = make_batch(
                byz_node_key,
                [make_payload(client, seq=1, recipient=bob)],
                batch_seq=777,
            )
            # ship conflicting batches to different peers directly
            services[0].mesh.send(services[0].mesh.peers[0], batch_a.encode())
            services[0].mesh.send(services[0].mesh.peers[1], batch_b.encode())
            services[0].mesh.send(services[0].mesh.peers[2], batch_a.encode())
            await asyncio.sleep(1.0)
            bal_a = [await s.accounts.get_balance(alice) for s in services[1:]]
            bal_b = [await s.accounts.get_balance(bob) for s in services[1:]]
            assert len(set(bal_a)) == 1, f"alice balances diverged: {bal_a}"
            assert len(set(bal_b)) == 1, f"bob balances diverged: {bal_b}"
            assert not (
                bal_a[0] == FAUCET + 10 and bal_b[0] == FAUCET + 10
            ), "both equivocated batches committed"
        finally:
            await close_all(services)


class TestBatchContentPull:
    @pytest.mark.asyncio
    async def test_lost_batch_gossip_recovered_via_pull(self):
        # same shape as the per-tx pull fault test, batched plane:
        # thresholds let quorums form without the starved node
        cfgs, services = await start_net(3, echo_threshold=1, ready_threshold=2)
        victim = services[2]
        dropped = 0
        original = victim.mesh.on_frame

        async def lossy(peer, frame):
            nonlocal dropped
            msgs = parse_frame(frame)
            kept = []
            for m in msgs:
                if isinstance(m, TxBatch) and dropped < 2:
                    dropped += 1
                    continue
                kept.append(m)
            if kept:
                await original(peer, b"".join(m.encode() for m in kept))

        victim.mesh.on_frame = lossy
        try:
            sender = SignKeyPair.random()
            recipient = SignKeyPair.random().public
            await submit(services[0], make_payload(sender, recipient=recipient, amount=25))
            await services[0]._flush_batch()

            async def all_committed():
                for s in services:
                    if await s.accounts.get_last_sequence(sender.public) < 1:
                        return False
                return True

            await wait_until(all_committed, what="starved node pulls the batch")
            assert dropped == 2, "the fault never actually fired"
            assert victim.broadcast.stats["content_req_tx"] >= 1
            assert await victim.accounts.get_balance(recipient) == FAUCET + 25
        finally:
            await close_all(services)


class TestIngressBatcher:
    @pytest.mark.asyncio
    async def test_window_flush_and_size_flush(self):
        cfgs, services = await start_net(
            1, batching=BatchingConfig(enabled=True, max_entries=4, window=0.02)
        )
        svc = services[0]
        try:
            from at2_node_tpu_torch.client import Client

            sender = SignKeyPair.random()
            recipient = SignKeyPair.random().public
            async with Client(f"http://{cfgs[0].rpc_address}") as client:
                # below max_entries: the WINDOW must flush it
                await client.send_asset(sender, 1, recipient, 5)

                async def committed_one():
                    return svc.committed >= 1

                await wait_until(committed_one, what="window flush commits")
                # exactly max_entries: the SIZE trigger flushes immediately
                for seq in range(2, 6):
                    await client.send_asset(sender, seq, recipient, 5)

                async def committed_all():
                    return svc.committed >= 5

                await wait_until(committed_all, what="size flush commits")
            assert await svc.accounts.get_balance(recipient) == FAUCET + 25
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_mixed_net_interop(self):
        """A net where only SOME nodes batch at their ingress: batching
        is a per-node ingress choice, not a protocol version — every
        node understands relayed batches and per-tx payloads alike, and
        traffic entering through either kind of ingress commits
        everywhere."""
        cfgs = make_configs(3)
        cfgs[1].batching = BatchingConfig(enabled=False)
        services = []
        try:
            for c in cfgs:
                services.append(await Service.start(c))
            from at2_node_tpu_torch.client import Client

            a = SignKeyPair.random()
            b = SignKeyPair.random()
            rcpt = SignKeyPair.random().public
            # a's txs enter through the BATCHING node 0; b's through the
            # per-tx node 1
            async with Client(f"http://{cfgs[0].rpc_address}") as c0:
                await c0.send_asset(a, 1, rcpt, 5)
            async with Client(f"http://{cfgs[1].rpc_address}") as c1:
                await c1.send_asset(b, 1, rcpt, 7)

            async def all_committed():
                for s in services:
                    if await s.accounts.get_last_sequence(a.public) < 1:
                        return False
                    if await s.accounts.get_last_sequence(b.public) < 1:
                        return False
                return True

            await wait_until(all_committed, what="mixed-plane commits")
            for s in services:
                assert await s.accounts.get_balance(rcpt) == FAUCET + 12
            # each plane actually carried its tx
            st = services[2].broadcast.stats
            assert st["batch_entries_delivered"] >= 1
            assert st["gossip_rx"] >= 1
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_batching_disabled_uses_per_tx_plane(self):
        cfgs, services = await start_net(
            3, batching=BatchingConfig(enabled=False)
        )
        try:
            from at2_node_tpu_torch.client import Client

            sender = SignKeyPair.random()
            recipient = SignKeyPair.random().public
            async with Client(f"http://{cfgs[0].rpc_address}") as client:
                await client.send_asset(sender, 1, recipient, 30)

                async def all_committed():
                    return all(s.committed >= 1 for s in services)

                await wait_until(all_committed, what="per-tx plane commit")
            st = services[1].broadcast.stats
            assert st["gossip_rx"] >= 1  # rode the reference-parity plane
            assert st["batch_rx"] == 0
        finally:
            await close_all(services)


class TestSendAssetBatchRpc:
    """The beyond-parity bulk-ingress RPC (at2.proto SendAssetBatch):
    semantically one SendAsset per entry, one round-trip."""

    @pytest.mark.asyncio
    async def test_bulk_submit_commits_everywhere(self):
        cfgs, services = await start_net(3)
        try:
            from at2_node_tpu_torch.client import Client

            sender = SignKeyPair.random()
            rcpt = SignKeyPair.random().public
            async with Client(f"http://{cfgs[0].rpc_address}") as client:
                await client.send_asset_many(
                    sender, [(s, rcpt, 2) for s in range(1, 101)]
                )

                async def all_committed():
                    seqs = [
                        await s.accounts.get_last_sequence(sender.public)
                        for s in services
                    ]
                    return all(q == 100 for q in seqs)

                await wait_until(all_committed, what="bulk RPC commits")
            for s in services:
                assert await s.accounts.get_balance(rcpt) == FAUCET + 200
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_validation_all_or_nothing(self):
        import grpc

        from at2_node_tpu_torch.proto import at2_pb2 as pb
        from at2_node_tpu_torch.proto.rpc import At2Stub

        cfgs, services = await start_net(1)
        try:
            sender = SignKeyPair.random()
            rcpt = SignKeyPair.random().public
            good = pb.SendAssetRequest(
                sender=sender.public, sequence=1, recipient=rcpt,
                amount=5, signature=b"s" * 64,
            )
            bad = pb.SendAssetRequest(  # 31-byte recipient
                sender=sender.public, sequence=2, recipient=b"x" * 31,
                amount=5, signature=b"s" * 64,
            )
            channel = grpc.aio.insecure_channel(cfgs[0].rpc_address)
            stub = At2Stub(channel)
            with pytest.raises(grpc.aio.AioRpcError) as exc:
                await stub.SendAssetBatch(
                    pb.SendAssetBatchRequest(transactions=[good, bad])
                )
            assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
            assert "entry 1" in exc.value.details()
            with pytest.raises(grpc.aio.AioRpcError):
                await stub.SendAssetBatch(pb.SendAssetBatchRequest())
            # nothing was admitted from the failed batch
            await asyncio.sleep(0.1)
            assert services[0].committed == 0
            assert not services[0]._batch_buf
            await channel.close()
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_oversized_rpc_batch_rejected(self):
        import grpc

        from at2_node_tpu_torch.proto import at2_pb2 as pb
        from at2_node_tpu_torch.proto.rpc import At2Stub

        cfgs, services = await start_net(1)
        try:
            sender = SignKeyPair.random()
            rcpt = SignKeyPair.random().public
            reqs = [
                pb.SendAssetRequest(
                    sender=sender.public, sequence=s, recipient=rcpt,
                    amount=1, signature=b"s" * 64,
                )
                for s in range(1, MAX_BATCH_ENTRIES + 2)
            ]
            channel = grpc.aio.insecure_channel(cfgs[0].rpc_address)
            stub = At2Stub(channel)
            with pytest.raises(grpc.aio.AioRpcError) as exc:
                await stub.SendAssetBatch(
                    pb.SendAssetBatchRequest(transactions=reqs)
                )
            assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
            await channel.close()
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_client_chunks_past_server_cap(self, monkeypatch):
        """send_asset_many transparently splits lists beyond the server's
        per-request cap into multiple RPCs, in order."""
        import at2_node_tpu_torch.client as client_mod

        monkeypatch.setattr(client_mod, "_RPC_BATCH_CAP", 10)
        cfgs, services = await start_net(1)
        try:
            sender = SignKeyPair.random()
            rcpt = SignKeyPair.random().public
            async with client_mod.Client(f"http://{cfgs[0].rpc_address}") as c:
                await c.send_asset_many(
                    sender, [(s, rcpt, 1) for s in range(1, 26)]
                )

                async def committed():
                    return services[0].committed >= 25

                await wait_until(committed, what="chunked client commits")
            assert (
                await services[0].accounts.get_last_sequence(sender.public)
                == 25
            )
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_flush_chunks_respect_wire_cap(self):
        """An ingress burst larger than max_entries flushes as MULTIPLE
        slots, none exceeding the wire cap."""
        cfgs, services = await start_net(
            1, batching=BatchingConfig(enabled=True, max_entries=16)
        )
        svc = services[0]
        try:
            from at2_node_tpu_torch.client import Client

            sender = SignKeyPair.random()
            rcpt = SignKeyPair.random().public
            async with Client(f"http://{cfgs[0].rpc_address}") as client:
                await client.send_asset_many(
                    sender, [(s, rcpt, 1) for s in range(1, 41)]
                )

                async def committed():
                    return svc.committed >= 40

                await wait_until(committed, what="chunked flush commits")
            # 40 entries / cap 16 => at least 3 slots
            assert svc.broadcast.stats["batch_rx"] >= 3
        finally:
            await close_all(services)


class TestSlotLifecycle:
    @pytest.mark.asyncio
    async def test_batch_slots_compact_and_counters_balance(self, monkeypatch):
        """GC lifecycle of the batched plane: delivered batch slots
        compact into the bounded delivered-set after retention, the
        undelivered counter returns to zero (its imbalance would
        eventually wedge the MAX_LIVE_SLOTS admission cap), and the
        commit heap fully drains."""
        import at2_node_tpu_torch.broadcast.stack as stack_mod

        monkeypatch.setattr(stack_mod, "GC_INTERVAL", 0.2)
        monkeypatch.setattr(stack_mod, "DELIVERED_RETENTION", 0.3)
        cfgs, services = await start_net(3)
        try:
            sender = SignKeyPair.random()
            recipient = SignKeyPair.random().public
            # several flushes => several batch slots per node
            seq = 0
            for _ in range(5):
                for _ in range(20):
                    seq += 1
                    await submit(
                        services[0],
                        make_payload(sender, seq=seq, recipient=recipient),
                    )
                await services[0]._flush_batch()

            async def all_committed():
                return all(s.committed >= seq for s in services)

            await wait_until(all_committed, what="soak commits")

            async def compacted():
                for s in services:
                    b = s.broadcast
                    if b._batch_slots or b._undelivered != 0:
                        return False
                    if len(b._delivered_batch_slots) < 5:
                        return False
                return True

            await wait_until(compacted, what="batch slots compact")
            for s in services:
                assert not s._heap and not s._heap_keys
                assert await s.accounts.get_balance(recipient) == FAUCET + 10 * seq
        finally:
            await close_all(services)


class TestConfig:
    def test_toml_roundtrip(self):
        cfg = make_configs(1)[0]
        cfg.batching = BatchingConfig(enabled=True, max_entries=64, window=0.01)
        text = cfg.dumps()
        assert "[batching]" in text
        from at2_node_tpu_torch.node.config import Config

        loaded = Config.loads(text)
        assert loaded.batching == cfg.batching

    def test_default_omitted_from_toml(self):
        cfg = make_configs(1)[0]
        assert "[batching]" not in cfg.dumps()

    def test_max_entries_validated(self):
        with pytest.raises(ValueError):
            BatchingConfig(max_entries=MAX_BATCH_ENTRIES + 1)
        with pytest.raises(ValueError):
            BatchingConfig(max_entries=0)


class TestAgainstTheReference:
    """Differential: the same seeded keys and transfers through the
    reference's wire module and the port's."""

    @staticmethod
    def _frames(pkg, seed):
        import importlib

        import numpy as np

        m = importlib.import_module(f"{pkg}.broadcast.messages")
        keys = importlib.import_module(f"{pkg}.crypto.keys")
        types = importlib.import_module(f"{pkg}.types")
        rng = np.random.default_rng(seed)
        node, client = keys.SignKeyPair(rng.bytes(32)), keys.SignKeyPair(rng.bytes(32))
        payloads = [m.Payload.create(client, s, types.ThinTransaction(rng.bytes(32), int(rng.integers(1, 10**6))))
                    for s in range(1, 1 + int(rng.integers(2, 40)))]
        batch = m.TxBatch.create(node, int(rng.integers(1, 1000)), b"".join(p.encode()[1:] for p in payloads))
        bm = rng.bytes((batch.count + 7) // 8)
        atts = [m.BatchAttestation(kind, node.public, node.public, batch.batch_seq, batch.content_hash(), bm,
                                   node.sign(m.BatchAttestation.signing_bytes(
                                       kind, node.public, batch.batch_seq, batch.content_hash(), bm)))
                for kind in (m.BATCH_ECHO, m.BATCH_READY)]
        req = m.BatchContentRequest(node.public, batch.batch_seq, batch.content_hash())
        return [batch.encode(), *(a.encode() for a in atts), req.encode(), payloads[0].encode(),
                batch.encode() + atts[0].encode()]

    @pytest.mark.parametrize("seed", [1, 17, 99])
    def test_wire_bytes_and_parses_equal_the_reference(self, seed):
        from at2_node_tpu.broadcast import messages as ref_messages
        from at2_node_tpu.native import ingest as ref_ingest
        from at2_node_tpu_torch.native import ingest as port_ingest

        frames = self._frames("at2_node_tpu_torch", seed)
        assert frames == self._frames("at2_node_tpu", seed)
        for frame in frames:
            port = [x.encode() for x in parse_frame(frame)]
            assert port == [x.encode() for x in ref_messages.parse_frame(frame)]
            assert b"".join(port) == frame
        assert port_ingest.ingest_available() and ref_ingest.ingest_available()
        port_msgs, port_ok = port_ingest.parse_frames_native(frames)
        ref_msgs, ref_ok = ref_ingest.parse_frames_native(frames)
        assert list(port_ok) == list(ref_ok) == [1] * len(frames)
        def rows(msgs):
            return [(i, type(m).__name__, m.encode(), m.content_hash() if hasattr(m, "content_hash") else None)
                    for i, m in msgs]

        assert len(port_msgs) == len(frames) + 1
        assert rows(port_msgs) == rows(ref_msgs)

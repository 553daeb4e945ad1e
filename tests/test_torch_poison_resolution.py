"""Poison-entry resolution, ingress pre-verification, and stall-storm
damping (broadcast/stack.py + node/service.py, the robustness PR).

The amplification being closed: pre-fix, one never-deliverable entry
(bad client signature or equivocation-registry conflict) held its batch
slot "undelivered" for SLOT_MAX_AGE — burning retransmission budget and
firing a network-wide catchup kick every GC pass. These tests pin the
three independent defenses:

* slot RETIREMENT — a slot whose ready-quorate entries are delivered and
  whose remaining entries are locally resolved-rejected leaves the
  undelivered population and compacts like a delivered one (and a late
  Ready quorum on a rejected entry still delivers it while retained);
* ingress PRE-VERIFICATION ([admission]) — bad client signatures are
  rejected at the RPC boundary via one bulk verify_many, with a
  per-source token bucket charged only for FAILED entries;
* stall-kick HYSTERESIS — poison-blocked slots never classify as
  stalled, and genuine stalls fire the catchup kick through a min
  interval + exponential backoff instead of once per GC pass.
"""

import asyncio
import itertools
import time

import grpc
import pytest

from at2_node_tpu_torch.broadcast.messages import (
    BATCH_ECHO,
    BATCH_READY,
    BatchAttestation,
    Payload,
    TxBatch,
)
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.crypto.verifier import make_verifier
from at2_node_tpu_torch.node.config import AdmissionConfig, VerifierConfig
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.proto import at2_pb2 as pb
from at2_node_tpu_torch.types import ThinTransaction, transfer_signing_bytes
from at2_node_tpu_torch.tools._common import make_net_configs as _make_net_configs

from conftest import wait_until

_ports = itertools.count(30300)


def make_net_configs(n, ports, **overrides):
    """The reference conftest's ``make_net_configs`` on the port's tools,
    every node on the host verifier (the port's default kind is "cuda")."""
    return _make_net_configs(n, ports, verifier=VerifierConfig(kind="cpu"), **overrides)


FAUCET = 100_000


def make_payload(keypair, seq=1, amount=10, recipient=b"r" * 32):
    return Payload.create(keypair, seq, ThinTransaction(recipient, amount))


def bad_payload(public, seq=1, amount=10, recipient=b"r" * 32):
    """A transfer whose client signature can never verify."""
    return Payload(public, seq, ThinTransaction(recipient, amount), b"\x01" * 64)


def make_configs(n, **kwargs):
    return make_net_configs(n, _ports, **kwargs)


async def start_net(n, **kwargs):
    cfgs = make_configs(n, **kwargs)
    services = [await Service.start(c) for c in cfgs]
    return cfgs, services


async def close_all(services):
    for s in services:
        await s.close()


async def submit(service, payload):
    """Feed one payload straight into the ingress batcher — bypasses the
    RPC admission layer, i.e. models a byzantine/lenient ingress node."""
    await service.recent.put(payload.sender, payload.sequence, payload.transaction)
    service._batch_buf.append(payload)


def _count_stall_kicks(services):
    """Replace each node's stall handler with a counter (the real handler
    starts catchup sessions; counting is what these tests need)."""
    counts = {id(s): 0 for s in services}
    for s in services:

        def bump(_s=s):
            counts[id(_s)] += 1

        s.broadcast.stall_handler = bump
    return counts


class _StubMesh:
    """Minimal mesh for unit-level Broadcast tests: records frames."""

    def __init__(self, n_peers=0):
        self.peers = [object() for _ in range(n_peers)]
        self.by_sign = {}
        self.sent = []

    def broadcast(self, frame):
        self.sent.append((None, frame))

    def send(self, peer, frame):
        self.sent.append((peer, frame))


def make_batch(origin_kp, payloads, batch_seq=1):
    raw = b"".join(p.encode()[1:] for p in payloads)
    return TxBatch.create(origin_kp, batch_seq, raw)


def batch_att(kp, phase, slot, chash, bitmap):
    sig = kp.sign(
        BatchAttestation.signing_bytes(phase, slot[0], slot[1], chash, bitmap)
    )
    return BatchAttestation(phase, kp.public, slot[0], slot[1], chash, bitmap, sig)


class TestSlotRetirement:
    @pytest.mark.asyncio
    async def test_poison_slot_retires_and_compacts(self, monkeypatch):
        """One bad-sig entry no longer pins its slot for SLOT_MAX_AGE:
        the slot retires once the good siblings deliver, stops consuming
        retransmission budget, never classifies as stalled, and compacts
        after the normal retention."""
        import at2_node_tpu_torch.broadcast.stack as stack_mod

        monkeypatch.setattr(stack_mod, "GC_INTERVAL", 0.2)
        monkeypatch.setattr(stack_mod, "DELIVERED_RETENTION", 0.4)
        monkeypatch.setattr(stack_mod, "RETRANSMIT_AFTER", 1.0)
        monkeypatch.setattr(stack_mod, "STALLED_CATCHUP_AFTER", 1.0)
        cfgs, services = await start_net(3)
        kicks = _count_stall_kicks(services)
        try:
            sender = SignKeyPair.random()
            poisoner = SignKeyPair.random()
            recipient = SignKeyPair.random().public
            for seq in range(1, 6):
                await submit(
                    services[0], make_payload(sender, seq=seq, recipient=recipient)
                )
            await submit(services[0], bad_payload(poisoner.public, seq=1))
            await services[0]._flush_batch()

            async def good_committed():
                return all(s.committed >= 5 for s in services)

            await wait_until(good_committed, what="good siblings commit")

            async def all_retired_and_compacted():
                for s in services:
                    st = s.broadcast.stats
                    if st["slots_retired"] < 1 or st["poison_resolved"] < 1:
                        return False
                    if s.broadcast._batch_slots or s.broadcast._undelivered:
                        return False
                return True

            await wait_until(
                all_retired_and_compacted, what="poison slot retires + compacts"
            )
            for s in services:
                # retired slots are excluded from retransmission and from
                # the stall classification — kicks must never have fired
                assert s.broadcast.stats["retransmits"] == 0
                assert kicks[id(s)] == 0
                assert s.catchup_stats["catchup_sessions"] == 0
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_all_rejected_batch_retires_standalone(self, monkeypatch):
        """Degenerate single-node net: a batch that is 100% poison still
        resolves (no quorum will ever arrive to deliver anything)."""
        import at2_node_tpu_torch.broadcast.stack as stack_mod

        monkeypatch.setattr(stack_mod, "GC_INTERVAL", 0.2)
        cfgs, services = await start_net(1)
        try:
            await submit(services[0], bad_payload(SignKeyPair.random().public))
            await services[0]._flush_batch()

            async def retired():
                st = services[0].broadcast.stats
                return st["slots_retired"] >= 1 and st["poison_resolved"] >= 1

            await wait_until(retired, what="all-poison slot retires")
            assert services[0].committed == 0
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_late_quorum_on_rejected_entry_still_delivers(self):
        """Retirement is a GC/stats state, not a delivery gate: our local
        rejection is not the network's verdict. If a Ready quorum for a
        rejected entry lands while the slot is retained, the entry
        delivers through the normal path."""
        kp = SignKeyPair.random()
        peers = [SignKeyPair.random() for _ in range(2)]
        mesh = _StubMesh(n_peers=2)
        bcast = __import__(
            "at2_node_tpu_torch.broadcast.stack", fromlist=["Broadcast"]
        ).Broadcast(
            kp, mesh, make_verifier("cpu"), echo_threshold=2, ready_threshold=2
        )
        client = SignKeyPair.random()
        good = make_payload(client, seq=1)
        bad = bad_payload(SignKeyPair.random().public, seq=1)
        origin = SignKeyPair.random()
        batch = make_batch(origin, [good, bad], batch_seq=7)
        slot = (origin.public, 7)
        chash = batch.content_hash()
        # echo verdicts: entry 0 ok, entry 1 rejected
        bcast._post_batch(batch, [True, False])
        state = bcast._batch_slots[slot]
        assert state.rejected_bits[chash] == 0b10
        # both peers endorse only entry 0 through Echo AND Ready
        for peer in peers:
            bcast._post_batch_attestation(
                batch_att(peer, BATCH_ECHO, slot, chash, bytes([0b01]))
            )
        for peer in peers:
            bcast._post_batch_attestation(
                batch_att(peer, BATCH_READY, slot, chash, bytes([0b01]))
            )
        assert state.delivered_bits[chash] == 0b01
        bcast._maybe_retire_batch(slot, state)
        assert state.retired and not state.delivered_all
        retired_undelivered = bcast._undelivered
        # LATE full-width quorum (the network out-voted our rejection)
        for peer in peers:
            bcast._post_batch_attestation(
                batch_att(peer, BATCH_READY, slot, chash, bytes([0b11]))
            )
        assert state.delivered_bits[chash] == 0b11
        assert state.delivered_all
        # the undelivered population was decremented exactly once
        assert bcast._undelivered == retired_undelivered
        assert bcast.delivered.qsize() == 2

    @pytest.mark.asyncio
    async def test_no_retire_while_quorate_entry_undelivered(self):
        """A slot with a ready-quorate but undelivered entry (content
        still missing, say) is genuinely in progress — it must NOT
        retire, even if the echoed content is fully resolved."""
        kp = SignKeyPair.random()
        peers = [SignKeyPair.random() for _ in range(2)]
        mesh = _StubMesh(n_peers=2)
        bcast = __import__(
            "at2_node_tpu_torch.broadcast.stack", fromlist=["Broadcast"]
        ).Broadcast(
            kp, mesh, make_verifier("cpu"), echo_threshold=2, ready_threshold=2
        )
        origin = SignKeyPair.random()
        slot = (origin.public, 3)
        other_hash = b"\x55" * 32  # an equivocating sibling content
        # a full Ready quorum for a content we never saw arrives FIRST
        for peer in peers:
            bcast._post_batch_attestation(
                batch_att(peer, BATCH_READY, slot, other_hash, bytes([0b01]))
            )
        # then our copy of the (all-rejected) echoed content lands
        bcast._post_batch(
            make_batch(origin, [bad_payload(SignKeyPair.random().public)], 3),
            [False],
        )
        state = bcast._batch_slots[slot]
        bcast._maybe_retire_batch(slot, state)
        assert not state.retired, "quorate undelivered entry must block retirement"
        assert bcast._poison_blocked_only(state) is False


class TestBitmapClamp:
    def _bcast(self, n=2):
        kp = SignKeyPair.random()
        mesh = _StubMesh(n_peers=n)
        return kp, __import__(
            "at2_node_tpu_torch.broadcast.stack", fromlist=["Broadcast"]
        ).Broadcast(
            kp, mesh, make_verifier("cpu"), echo_threshold=n, ready_threshold=n
        )

    @pytest.mark.asyncio
    async def test_oversized_bitmap_clamped_to_entry_count(self):
        """An attestation claiming 1024 entries for a 2-entry batch must
        not inflate nbits past the real count (phantom positions used to
        spuriously quorate and drive endless content pulls)."""
        kp, bcast = self._bcast()
        origin = SignKeyPair.random()
        client = SignKeyPair.random()
        batch = make_batch(origin, [make_payload(client, seq=s) for s in (1, 2)])
        slot = (origin.public, 1)
        chash = batch.content_hash()
        bcast._post_batch(batch, [True, True])
        state = bcast._batch_slots[slot]
        assert state.nbits == 2
        wide = (1 << 1024) - 1  # every bit set, 128-byte bitmap
        att = batch_att(
            kp=SignKeyPair.random(),
            phase=BATCH_ECHO,
            slot=slot,
            chash=chash,
            bitmap=wide.to_bytes(128, "little"),
        )
        bcast._post_batch_attestation(att)
        assert state.nbits == 2, "phantom positions grew nbits"
        votes = state.echo_votes[chash]
        assert votes.by_origin[att.origin] == 0b11  # clamped to the count

    @pytest.mark.asyncio
    async def test_phantom_only_bitmap_ignored(self):
        """Bits exclusively at positions >= count carry no information
        after the clamp — the attestation is dropped entirely."""
        kp, bcast = self._bcast()
        origin = SignKeyPair.random()
        client = SignKeyPair.random()
        batch = make_batch(origin, [make_payload(client, seq=1)])
        slot = (origin.public, 1)
        chash = batch.content_hash()
        bcast._post_batch(batch, [True])
        state = bcast._batch_slots[slot]
        phantom = batch_att(
            SignKeyPair.random(),
            BATCH_ECHO,
            slot,
            chash,
            (0b10).to_bytes(1, "little"),  # only bit 1, count is 1
        )
        bcast._post_batch_attestation(phantom)
        votes = state.echo_votes.get(chash)
        assert votes is None or phantom.origin not in votes.by_origin

    @pytest.mark.asyncio
    async def test_content_arrival_clamps_preexisting_width(self):
        """Attestations can precede the batch gossip; once the content
        lands, nbits snaps to the real entry count."""
        kp, bcast = self._bcast()
        origin = SignKeyPair.random()
        client = SignKeyPair.random()
        batch = make_batch(origin, [make_payload(client, seq=1)])
        slot = (origin.public, 1)
        chash = batch.content_hash()
        wide = batch_att(
            SignKeyPair.random(),
            BATCH_ECHO,
            slot,
            chash,
            ((1 << 64) - 1).to_bytes(8, "little"),
        )
        bcast._post_batch_attestation(wide)
        assert bcast._batch_slots[slot].nbits == 64
        bcast._post_batch(batch, [True])
        assert bcast._batch_slots[slot].nbits == 1


class TestStallDamping:
    @pytest.mark.asyncio
    async def test_kick_hysteresis_and_rearm(self, monkeypatch):
        """A persistently stalled slot fires the catchup kick through
        exponential backoff — not once per GC pass — and a healthy pass
        re-arms the minimum interval."""
        import at2_node_tpu_torch.broadcast.stack as stack_mod

        monkeypatch.setattr(stack_mod, "GC_INTERVAL", 0.05)
        monkeypatch.setattr(stack_mod, "STALLED_CATCHUP_AFTER", 0.0)
        monkeypatch.setattr(stack_mod, "RETRANSMIT_AFTER", 3600.0)
        kp = SignKeyPair.random()
        bcast = stack_mod.Broadcast(
            kp, _StubMesh(1), make_verifier("cpu"), 1, 1, workers=1
        )
        bcast._stall_backoff = 0.4
        monkeypatch.setattr(stack_mod, "STALL_KICK_MIN_INTERVAL", 0.4)
        monkeypatch.setattr(stack_mod, "STALL_KICK_MAX_INTERVAL", 0.8)
        kicks = []
        bcast.stall_handler = lambda: kicks.append(time.monotonic())
        # one genuinely stalled per-tx slot (no content, no quorum)
        state = bcast._new_or_existing_slot((b"s" * 32, 1))
        state.created -= 10.0
        await bcast.start()
        try:
            await asyncio.sleep(1.5)
            # ~30 GC passes happened; undamped this would be ~30 kicks.
            # Damped: first kick immediate, then 0.4s, then 0.8s ... => <= 4
            assert 1 <= len(kicks) <= 4, kicks
            assert bcast.stats["stall_kicks_suppressed"] > 0
            gaps = [b - a for a, b in zip(kicks, kicks[1:])]
            assert all(g >= 0.35 for g in gaps), gaps
            # heal the slot: backoff re-arms to the minimum
            del bcast._slots[(b"s" * 32, 1)]
            bcast._undelivered -= 1
            await asyncio.sleep(0.3)
            assert bcast._stall_backoff == 0.4
        finally:
            await bcast.close()


class TestRegistryRelease:
    @pytest.mark.asyncio
    async def test_commit_releases_entry_binding(self):
        """The ledger gate subsumes the equivocation registry once a
        sequence commits — the binding is dropped eagerly so the
        registry's working set tracks in-flight entries only."""
        cfgs, services = await start_net(1)
        try:
            sender = SignKeyPair.random()
            p = make_payload(sender, seq=1)
            await submit(services[0], p)
            await services[0]._flush_batch()

            async def committed():
                return services[0].committed >= 1

            await wait_until(committed, what="entry commits")
            reg = services[0].broadcast._entry_registry
            assert reg.get((sender.public, 1)) is None
        finally:
            await close_all(services)


class TestCommitTailShield:
    @pytest.mark.asyncio
    async def test_cancellation_cannot_split_commit_from_record(self):
        """Satellite: a cancellation landing mid-commit-pass must not
        leave the accounts mutated but history/ring unrecorded — the
        tail is shielded and runs to completion."""
        cfg = make_configs(1)[0]
        svc = Service(cfg)  # no start(): unit-level, no net
        sender = SignKeyPair.random()
        p = make_payload(sender, seq=1)
        await svc.recent.put(p.sender, p.sequence, p.transaction)
        svc._push_pending(p, time.monotonic())
        release = asyncio.Event()
        started = asyncio.Event()
        orig = svc.recent.apply_many

        async def gated(ops):
            started.set()
            await release.wait()
            await orig(ops)

        svc.recent.apply_many = gated
        task = asyncio.create_task(svc._drain_to_fixpoint())
        await asyncio.wait_for(started.wait(), 5)
        task.cancel()
        release.set()
        with pytest.raises(asyncio.CancelledError):
            await task
        # the shielded tail still completed: commit recorded everywhere
        await asyncio.sleep(0.1)
        assert svc.committed == 1
        assert len(svc.history) == 1
        from at2_node_tpu_torch.types import TransactionState

        txs = await svc.recent.get_all()
        assert [t.state for t in txs] == [TransactionState.SUCCESS]


class TestAdmission:
    @pytest.mark.asyncio
    async def test_bad_signature_rejected_at_rpc_boundary(self):
        """With [admission] preverify on (the default), a forged client
        signature never reaches the gossip plane: the RPC fails with
        INVALID_ARGUMENT and the broadcast stack sees nothing."""
        cfgs, services = await start_net(1)
        try:
            async with grpc.aio.insecure_channel(cfgs[0].rpc_address) as ch:
                stub = _stub(ch)
                with pytest.raises(grpc.aio.AioRpcError) as exc:
                    await stub.SendAsset(_bad_request(), timeout=10)
                assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
                assert "signature" in exc.value.details()
            await asyncio.sleep(0.2)
            snap = services[0].snapshot_stats()
            assert snap["rejected_at_ingress"] == 1
            assert services[0].broadcast.stats["invalid_sig"] == 0
            assert services[0].committed == 0
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_batch_rejection_names_entries(self):
        """Per-entry status: the rejection detail names exactly the
        failing entry indices, so a client can drop them and retry."""
        cfgs, services = await start_net(1)
        try:
            sender = SignKeyPair.random()
            reqs = []
            for i, seq in enumerate((1, 2, 3)):
                sig = (
                    b"\x02" * 64
                    if i == 1
                    else sender.sign(
                        transfer_signing_bytes(
                            sender.public, seq, b"r" * 32, 10
                        )
                    )
                )
                reqs.append(
                    pb.SendAssetRequest(
                        sender=sender.public,
                        sequence=seq,
                        recipient=b"r" * 32,
                        amount=10,
                        signature=sig,
                    )
                )
            async with grpc.aio.insecure_channel(cfgs[0].rpc_address) as ch:
                stub = _stub(ch)
                with pytest.raises(grpc.aio.AioRpcError) as exc:
                    await stub.SendAssetBatch(
                        pb.SendAssetBatchRequest(transactions=reqs), timeout=10
                    )
                assert exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
                assert "[1]" in exc.value.details()
            await asyncio.sleep(0.2)
            assert services[0].committed == 0  # all-or-nothing admission
            assert services[0].snapshot_stats()["rejected_at_ingress"] == 1
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_fail_token_bucket_throttles_source(self):
        """The bucket is charged only for FAILED entries; once spent, the
        source is refused with RESOURCE_EXHAUSTED before any verifier
        work."""
        cfgs, services = await start_net(
            1, admission=AdmissionConfig(fail_limit=2, fail_window=3600.0)
        )
        try:
            async with grpc.aio.insecure_channel(cfgs[0].rpc_address) as ch:
                stub = _stub(ch)
                for _ in range(2):
                    with pytest.raises(grpc.aio.AioRpcError) as exc:
                        await stub.SendAsset(_bad_request(), timeout=10)
                    assert (
                        exc.value.code() == grpc.StatusCode.INVALID_ARGUMENT
                    )
                with pytest.raises(grpc.aio.AioRpcError) as exc:
                    await stub.SendAsset(_bad_request(), timeout=10)
                assert exc.value.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
                # valid traffic from the same connection was never charged
                # — but this source is now refused outright until refill
                snap = services[0].snapshot_stats()
                assert snap["admission_throttled"] == 1
                assert snap["rejected_at_ingress"] == 2
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_honest_client_pays_zero_tokens(self):
        """Valid entries cost nothing: an honest client can push far more
        than fail_limit entries through one source."""
        cfgs, services = await start_net(
            1, admission=AdmissionConfig(fail_limit=2, fail_window=3600.0)
        )
        try:
            sender = SignKeyPair.random()
            from at2_node_tpu_torch.client import Client

            async with Client(f"http://{cfgs[0].rpc_address}") as client:
                await client.send_asset_many(
                    sender, [(s, b"r" * 32, 1) for s in range(1, 21)]
                )

            async def committed():
                return services[0].committed >= 20

            await wait_until(committed, what="honest batch commits")
            snap = services[0].snapshot_stats()
            assert snap["rejected_at_ingress"] == 0
            assert snap["admission_throttled"] == 0
        finally:
            await close_all(services)

    @pytest.mark.asyncio
    async def test_preverify_false_restores_old_behavior(self):
        """[admission] preverify = false: everything is admitted and the
        broadcast workers' bulk verification is the (only) gate again."""
        cfgs, services = await start_net(
            1, admission=AdmissionConfig(preverify=False)
        )
        try:
            async with grpc.aio.insecure_channel(cfgs[0].rpc_address) as ch:
                stub = _stub(ch)
                await stub.SendAsset(_bad_request(), timeout=10)  # accepted
            await services[0]._flush_batch()

            async def plane_rejected():
                return services[0].broadcast.stats["invalid_sig"] >= 1

            await wait_until(plane_rejected, what="broadcast-plane rejection")
            assert services[0].snapshot_stats()["rejected_at_ingress"] == 0
            assert services[0].committed == 0
        finally:
            await close_all(services)


def _stub(channel):
    from at2_node_tpu_torch.proto.rpc import At2Stub

    return At2Stub(channel)


def _bad_request():
    kp = SignKeyPair.random()
    return pb.SendAssetRequest(
        sender=kp.public,
        sequence=1,
        recipient=b"r" * 32,
        amount=10,
        signature=b"\x07" * 64,
    )


class TestAgainstTheReference:
    """Differential: the same seeded slot, verdicts and attestations
    through the reference's Broadcast and the port's give the same
    retire, delivery and rejection decisions and send the same frames.
    Seeds 1 and 8 retire the slot; under seed 3 every entry delivers."""

    @staticmethod
    async def _trace(pkg, seed):
        import importlib

        import numpy as np

        m = importlib.import_module(f"{pkg}.broadcast.messages")
        stack = importlib.import_module(f"{pkg}.broadcast.stack")
        keys = importlib.import_module(f"{pkg}.crypto.keys")
        types = importlib.import_module(f"{pkg}.types")
        verifier = importlib.import_module(f"{pkg}.crypto.verifier")
        rng = np.random.default_rng(seed)
        kp, origin, client = (keys.SignKeyPair(rng.bytes(32)) for _ in range(3))
        peers = [keys.SignKeyPair(rng.bytes(32)) for _ in range(3)]
        mesh = _StubMesh(n_peers=3)
        bcast = stack.Broadcast(kp, mesh, verifier.make_verifier("cpu"), echo_threshold=2, ready_threshold=2)
        n = int(rng.integers(2, 9))
        good = rng.random(n) < 0.6
        entries = [m.Payload.create(client, s + 1, types.ThinTransaction(b"r" * 32, 10)) if ok else
                   m.Payload(rng.bytes(32), 1, types.ThinTransaction(b"r" * 32, 10), b"\x01" * 64)
                   for s, ok in enumerate(good)]
        batch = m.TxBatch.create(origin, 7, b"".join(p.encode()[1:] for p in entries))
        slot, chash = (origin.public, 7), batch.content_hash()
        bcast._post_batch(batch, [bool(g) for g in good])
        state = bcast._batch_slots[slot]
        trace = []
        for _ in range(12):
            peer = peers[int(rng.integers(3))]
            phase = (m.BATCH_ECHO, m.BATCH_READY)[int(rng.integers(2))]
            width = int(rng.integers(1, 3)) * ((n + 7) // 8)  # sometimes wider than the count
            if rng.random() < 0.7:  # an honest peer endorses the entries that verify
                bitmap = sum(1 << i for i in range(n) if good[i]).to_bytes(width, "little")
            else:
                bitmap = bytes(int(b) for b in rng.integers(0, 256, size=width))
            sig = peer.sign(m.BatchAttestation.signing_bytes(phase, slot[0], slot[1], chash, bitmap))
            bcast._post_batch_attestation(m.BatchAttestation(phase, peer.public, slot[0], slot[1], chash,
                                                             bitmap, sig))
            bcast._maybe_retire_batch(slot, state)
            trace.append((state.nbits, dict(state.rejected_bits), dict(state.delivered_bits), state.retired,
                          state.delivered_all, bcast._poison_blocked_only(state), bcast._undelivered,
                          bcast.delivered.qsize()))
        delivered = []
        while not bcast.delivered.empty():
            p = bcast.delivered.get_nowait()
            delivered.append((p.sender, p.sequence, p.content_hash()))
        await bcast.verifier.close()
        return trace, delivered, [frame for _, frame in mesh.sent]

    @pytest.mark.parametrize("seed", [1, 3, 8])
    async def test_retire_and_delivery_decisions_equal_the_reference(self, seed):
        port = await self._trace("at2_node_tpu_torch", seed)
        ref = await self._trace("at2_node_tpu", seed)
        assert port == ref
        assert port[1]  # entries delivered

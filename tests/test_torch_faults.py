"""Fault-injection tier: the recovery paths under real failures.

The reference leaves recovery as roadmap items ("TODO readd connections
if dropped", `at2-node/src/bin/server/rpc.rs:87`; TTL drop at
`rpc.rs:35`; "catchup mechanism", `at2-node/README.md:53`); this
build implements them, and these tests pin the implementations under
REAL faults on real localhost nets:

* kill one node of a 3-node net under traffic, restart it, assert the
  peers' redial/backoff loop re-converges the net (net/peers.py
  `_outbound_loop`);
* the deliberately-kept TTL quirk: a payload that outlives
  TRANSACTION_TTL is recorded Failure yet still processes and can flip
  to Success (node/service.py `_drain_to_fixpoint`, mirroring the
  reference's missing `continue`, rpc.rs:183-205);
* a partition that loses a payload's gossip entirely: the node still
  reaches Ready quorum via attestations and pulls the content from the
  quorum (broadcast/stack.py `_request_content` — exercised here over
  real sockets, not state-machine calls);
* SIGKILL a CLI server mid-commit-stream with [checkpoint] enabled,
  restart it, assert no double-apply (per-account sequence gate) and
  re-convergence for new traffic.
"""

import asyncio
import itertools
import os
import signal
import subprocess
import sys
import time

import pytest

from at2_node_tpu_torch.broadcast.messages import Payload, TxBatch, parse_frame
from at2_node_tpu_torch.types import TransactionState
from at2_node_tpu_torch.client import Client
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.node.config import CatchupConfig, CheckpointConfig, VerifierConfig
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.tools._common import make_net_configs as _make_net_configs

from conftest import wait_until

_ports = itertools.count(30900)


def make_net_configs(n, ports, **overrides):
    """The reference conftest's ``make_net_configs`` on the port's tools,
    every node on the host verifier (the port's default kind is "cuda")."""
    return _make_net_configs(n, ports, verifier=VerifierConfig(kind="cpu"), **overrides)


FAUCET = 100_000


def make_configs(n, **kwargs):
    return make_net_configs(n, _ports, **kwargs)


class TestKillRestartRedial:
    @pytest.mark.asyncio
    async def test_node_killed_and_restarted_reconverges(self):
        # f=1-tolerant thresholds: with one node down the other two can
        # still commit (default reference thresholds are n_peers, which
        # has zero fault tolerance — the knobs exist for exactly this).
        # Catchup quorum 2 = BOTH survivors must agree on each historical
        # slot's content before the restarted node applies it.
        cfgs = make_configs(
            3,
            echo_threshold=1,
            ready_threshold=1,
            catchup=CatchupConfig(quorum=2, after=0.5, window=0.3),
        )
        services = [await Service.start(c) for c in cfgs]
        sender = SignKeyPair.random()
        recipient = SignKeyPair.random().public
        try:
            async with Client(f"http://{cfgs[0].rpc_address}") as client:
                await client.send_asset(sender, 1, recipient, 10)
                await wait_until(
                    lambda: _committed_on(services, 1, sender.public),
                    what="tx1 on all nodes",
                )

                # kill node 2 (connections drop; peers enter redial)
                await services[2].close()

                # the surviving majority keeps committing under traffic
                await client.send_asset(sender, 2, recipient, 10)
                await wait_until(
                    lambda: _committed_on(services[:2], 2, sender.public),
                    what="tx2 on survivors",
                )

                # restart node 2 on the same addresses; peers redial it.
                # It missed seq 1-2 entirely (no checkpoint — full state
                # loss): tx3 parks on its sequence gate until the ledger
                # catchup pulls the missed history from the survivors and
                # replays it — then ALL THREE nodes commit everything.
                services[2] = await Service.start(cfgs[2])
                await client.send_asset(sender, 3, recipient, 10)
                await wait_until(
                    lambda: _committed_on(services, 3, sender.public),
                    what="full commit parity after restart",
                )
            # the restarted node's broadcast saw tx3 via redialed links,
            # recovered the missed history via the catchup protocol, and
            # its ledger fully re-converged. catchup_applied counts only
            # NEWLY-enqueued payloads: part of the gap can
            # arrive via the survivors' queued send backlog on redial
            # (tx2's frames were parked in their bounded send queues
            # while the node was down), so the catchup's own share is
            # >= 1, not necessarily the whole gap.
            assert services[2].broadcast.stats["delivered"] >= 1
            assert services[2].catchup_stats["catchup_applied"] >= 1
            for s in services:
                assert await s.accounts.get_balance(sender.public) == FAUCET - 30
                assert await s.accounts.get_balance(recipient) == FAUCET + 30
            # and the survivors actually served it from their history
            served = sum(
                s.catchup_stats["catchup_served"] for s in services[:2]
            )
            assert served >= 2
        finally:
            for s in services:
                await s.close()


async def _committed_on(services, seq, sender_pub):
    for s in services:
        if await s.accounts.get_last_sequence(sender_pub) < seq:
            return False
    return True


class TestTtlQuirk:
    @pytest.mark.asyncio
    async def test_expired_payload_marked_failure_then_flips_success(
        self, monkeypatch
    ):
        from at2_node_tpu_torch.node import service as service_mod

        monkeypatch.setattr(service_mod, "TRANSACTION_TTL", 0.3)
        cfg = make_configs(1)[0]
        svc = await Service.start(cfg)
        sender = SignKeyPair.random()
        recipient = SignKeyPair.random().public
        try:
            async with Client(f"http://{cfg.rpc_address}") as client:
                # seq 2 first: gap-blocked, parks in the retry heap
                await client.send_asset(sender, 2, recipient, 10)
                await asyncio.sleep(0.5)  # outlive the 0.3s TTL

                # a second gapped payload triggers a drain pass that must
                # record the expired seq-2 as FAILURE (and still retry it)
                await client.send_asset(sender, 3, recipient, 10)

                async def seq2_failed():
                    txs = await client.get_latest_transactions()
                    return any(
                        t.sender_sequence == 2 and t.state.name == "FAILURE"
                        for t in txs
                    )

                await wait_until(seq2_failed, what="seq2 FAILURE record")

                # gap-filling seq 1 lets the EXPIRED payloads commit: the
                # reference quirk — no `continue` after the TTL branch —
                # means expiry does not drop them
                await client.send_asset(sender, 1, recipient, 10)

                async def all_success():
                    if await client.get_last_sequence(sender.public) != 3:
                        return False
                    txs = await client.get_latest_transactions()
                    states = {
                        t.sender_sequence: t.state.name
                        for t in txs
                        if t.sender == sender.public
                    }
                    return states == {1: "SUCCESS", 2: "SUCCESS", 3: "SUCCESS"}

                await wait_until(all_success, what="expired payloads flip to SUCCESS")
                assert await client.get_balance(sender.public) == FAUCET - 30
        finally:
            await svc.close()


class TestPartitionHealContentPull:
    @pytest.mark.asyncio
    async def test_lost_gossip_recovered_via_content_request(self):
        # Thresholds such that Echo/Ready quorums can form WITHOUT the
        # starved node's echo (it has no content, so it cannot echo):
        # with the reference's defaults (= all peers) a single lost
        # gossip stalls the slot net-wide — the exact fragility the
        # pull-based catch-up exists to break out of. The victim still
        # needs a full Ready quorum (2) before it pulls.
        # Batching OFF: this test faults the PER-TX gossip/pull plane
        # (the batched plane's pull twin is tests/test_batching.py).
        from at2_node_tpu_torch.node.config import BatchingConfig

        cfgs = make_configs(
            3,
            echo_threshold=1,
            ready_threshold=2,
            batching=BatchingConfig(enabled=False),
        )
        services = [await Service.start(c) for c in cfgs]
        victim = services[2]

        # fault injection at the wire boundary: strip the first two
        # Payload copies addressed to node 2 (the gossip relays from each
        # peer), let everything else — echoes, readies, and the later
        # content-pull response — through untouched
        dropped = 0
        original = victim.mesh.on_frame

        async def lossy(peer, frame):
            nonlocal dropped
            msgs = parse_frame(frame)
            kept = []
            for m in msgs:
                if isinstance(m, Payload) and dropped < 2:
                    dropped += 1
                    continue
                kept.append(m)
            if kept:
                await original(peer, b"".join(m.encode() for m in kept))

        victim.mesh.on_frame = lossy

        sender = SignKeyPair.random()
        recipient = SignKeyPair.random().public
        try:
            async with Client(f"http://{cfgs[0].rpc_address}") as client:
                await client.send_asset(sender, 1, recipient, 25)

                async def all_committed():
                    for s in services:
                        if await s.accounts.get_last_sequence(sender.public) < 1:
                            return False
                    return True

                await wait_until(
                    all_committed, what="commit on the gossip-starved node"
                )
            assert dropped == 2, "the fault never actually fired"
            # the victim pulled the content after observing the quorum
            assert victim.broadcast.stats["content_req_tx"] >= 1
            served = sum(
                s.broadcast.stats["content_served"] for s in services[:2]
            )
            assert served >= 1
            assert await victim.accounts.get_balance(recipient) == FAUCET + 25
        finally:
            for s in services:
                await s.close()


class TestStalledSlotRetransmission:
    """Liveness under message loss: the planes are best-effort
    (bounded queues drop under overload) and with thresholds = n_peers a
    single lost attestation gap-blocks its slot network-wide — burst
    measurements caught exactly that (BENCH_E2E.json batched_plane
    burst_robustness). A slot still undelivered after RETRANSMIT_AFTER
    re-broadcasts the node's content + own attestations (dedup absorbs
    them wherever they already landed)."""

    @staticmethod
    def _speed_up(monkeypatch):
        import at2_node_tpu_torch.broadcast.stack as stack_mod

        monkeypatch.setattr(stack_mod, "GC_INTERVAL", 0.3)
        monkeypatch.setattr(stack_mod, "RETRANSMIT_AFTER", 0.5)
        monkeypatch.setattr(stack_mod, "RETRANSMIT_EVERY", 0.5)

    @staticmethod
    def _drop_first(victim, pred):
        """Drop the first message matching pred arriving at victim."""
        state = {"dropped": 0}
        original = victim.mesh.on_frame

        async def lossy(peer, frame):
            kept = []
            for m in parse_frame(frame):
                if state["dropped"] < 1 and pred(m):
                    state["dropped"] += 1
                    continue
                kept.append(m)
            if kept:
                await original(peer, b"".join(m.encode() for m in kept))

        victim.mesh.on_frame = lossy
        return state

    # The stalling shape (a single lost ECHO heals for free via Ready
    # amplification): the FIRST Ready arriving at nodes 0 and 1 is
    # dropped. Each then holds 1 of 2 required readies — permanently
    # stalled pre-fix — while node 2 reaches its quorum and DELIVERS, so
    # node 2 never retransmits. Recovery: the stalled nodes' periodic
    # retransmission of their own attestations reaches node 2 as
    # duplicates for a delivered slot (a straggler beacon), and node 2
    # answers with its content + attestations (_help_straggler).

    @pytest.mark.asyncio
    async def test_lost_ready_recovered_per_tx(self, monkeypatch):
        from at2_node_tpu_torch.broadcast.messages import READY, Attestation
        from at2_node_tpu_torch.node.config import BatchingConfig

        self._speed_up(monkeypatch)
        cfgs = make_configs(3, batching=BatchingConfig(enabled=False))
        services = [await Service.start(c) for c in cfgs]

        def is_ready(m):
            return isinstance(m, Attestation) and m.phase == READY

        drops = [
            self._drop_first(services[0], is_ready),
            self._drop_first(services[1], is_ready),
        ]
        sender = SignKeyPair.random()
        recipient = SignKeyPair.random().public
        try:
            async with Client(f"http://{cfgs[0].rpc_address}") as client:
                await client.send_asset(sender, 1, recipient, 10)

                async def all_committed():
                    for s in services:
                        if await s.accounts.get_last_sequence(sender.public) < 1:
                            return False
                    return True

                await wait_until(
                    all_committed, what="slot heals via retransmission"
                )
            assert all(d["dropped"] == 1 for d in drops), "fault never fired"
            assert (
                sum(s.broadcast.stats["retransmits"] for s in services) >= 1
            )
        finally:
            for s in services:
                await s.close()

    @pytest.mark.asyncio
    async def test_lost_batch_ready_recovered(self, monkeypatch):
        from at2_node_tpu_torch.broadcast.messages import (
            BATCH_READY,
            BatchAttestation,
        )

        self._speed_up(monkeypatch)
        cfgs = make_configs(3)  # batching default-on
        services = [await Service.start(c) for c in cfgs]

        def is_bready(m):
            return isinstance(m, BatchAttestation) and m.phase == BATCH_READY

        drops = [
            self._drop_first(services[0], is_bready),
            self._drop_first(services[1], is_bready),
        ]
        sender = SignKeyPair.random()
        recipient = SignKeyPair.random().public
        try:
            async with Client(f"http://{cfgs[0].rpc_address}") as client:
                await client.send_asset(sender, 1, recipient, 10)

                async def all_committed():
                    for s in services:
                        if await s.accounts.get_last_sequence(sender.public) < 1:
                            return False
                    return True

                await wait_until(
                    all_committed, what="batch slot heals via retransmission"
                )
            assert all(d["dropped"] == 1 for d in drops), "fault never fired"
            assert (
                sum(s.broadcast.stats["retransmits"] for s in services) >= 1
            )
        finally:
            for s in services:
                await s.close()


class TestBeyondHorizonRejoin:
    """The rejoin story when the gap EXCEEDS peers'
    bounded history horizon (ledger/history.py retention). Two halves:

    * the documented operator path WORKS: a node restoring from its own
      stale local checkpoint only needs the tail within the horizon —
      tested end-to-end with a tiny history_cap;
    * without a checkpoint the gap is genuinely unrecoverable via
      catchup (the docstring's honest limit) — and the node must
      DEGRADE SOUNDLY: no livelock (catchup progress counted honestly,
      sessions back off), and no recent-ring FAILURE record for slots
      the network committed.
    """

    @pytest.mark.asyncio
    async def test_stale_checkpoint_plus_catchup_tail_converges(
        self, tmp_path
    ):
        cfgs = make_configs(
            3,
            echo_threshold=1,
            ready_threshold=1,
            catchup=CatchupConfig(
                quorum=2, after=0.3, window=0.3, history_cap=4
            ),
        )
        # node2 snapshots on graceful shutdown (interval<=0: final only)
        cfgs[2].checkpoint = CheckpointConfig(
            path=str(tmp_path / "node2.ckpt"), interval=0
        )
        services = [await Service.start(c) for c in cfgs]
        sender = SignKeyPair.random()
        recipient = SignKeyPair.random().public
        try:
            async with Client(f"http://{cfgs[0].rpc_address}") as client:
                for seq in range(1, 7):
                    await client.send_asset(sender, seq, recipient, 10)
                await wait_until(
                    lambda: _committed_on(services, 6, sender.public),
                    what="seqs 1-6 everywhere",
                )
                # node2 leaves gracefully -> checkpoint at frontier 6
                await services[2].close()
                # the network moves on; peers' history_cap=4 retains
                # only seqs 7-10 — seqs 1-6 fall past the horizon
                for seq in range(7, 11):
                    await client.send_asset(sender, seq, recipient, 10)
                await wait_until(
                    lambda: _committed_on(services[:2], 10, sender.public),
                    what="seqs 7-10 on survivors",
                )
                # rejoin: checkpoint restores frontier 6; catchup pulls
                # exactly the in-horizon tail 7-10 and re-converges
                services[2] = await Service.start(cfgs[2])
                # Simulate a LONG absence at the wire boundary: on a
                # short outage the survivors' outbound loops replay
                # their in-flight batch on redial (bounded queues +
                # retained `pending`), which would hand node2 the tail
                # for free; over a multi-day gap that replay holds only
                # unrelated recent traffic. Drop replayed gossip at the
                # victim's ingress so convergence must come from the
                # CATCHUP protocol (HistoryBatch passes untouched).
                original = services[2].mesh.on_frame

                async def no_gossip_replay(peer, frame, _orig=original):
                    kept = [
                        m
                        for m in parse_frame(frame)
                        if not isinstance(m, (Payload, TxBatch))
                    ]
                    if kept:
                        await _orig(
                            peer, b"".join(m.encode() for m in kept)
                        )

                services[2].mesh.on_frame = no_gossip_replay
                await wait_until(
                    lambda: _committed_on(services, 10, sender.public),
                    what="full re-convergence from stale checkpoint + tail",
                )
            for s in services:
                assert await s.accounts.get_balance(recipient) == FAUCET + 100
                assert await s.accounts.get_balance(sender.public) == FAUCET - 100
            assert services[2].catchup_stats["catchup_applied"] >= 1
        finally:
            for s in services:
                await s.close()

    @pytest.mark.asyncio
    async def test_no_checkpoint_degrades_soundly(self, monkeypatch):
        import at2_node_tpu_torch.node.service as service_mod

        # short TTL so the gap-blocked entries expire several times
        # within the test window (the FAILURE-suppression path)
        monkeypatch.setattr(service_mod, "TRANSACTION_TTL", 0.3)
        cfgs = make_configs(
            3,
            echo_threshold=1,
            ready_threshold=1,
            catchup=CatchupConfig(
                quorum=2, after=0.3, window=0.3, history_cap=4
            ),
        )
        services = [await Service.start(c) for c in cfgs]
        sender = SignKeyPair.random()
        recipient = SignKeyPair.random().public
        try:
            async with Client(f"http://{cfgs[0].rpc_address}") as client:
                for seq in range(1, 11):
                    await client.send_asset(sender, seq, recipient, 10)
                await wait_until(
                    lambda: _committed_on(services, 10, sender.public),
                    what="seqs 1-10 everywhere",
                )
                # node2 dies with TOTAL state loss (no checkpoint) and
                # rejoins: it needs 1-10 but peers retain only 7-10
                await services[2].close()
                services[2] = await Service.start(cfgs[2])
                victim = services[2]

                async def sessions_ran():
                    return victim.catchup_stats["catchup_sessions"] >= 2

                await wait_until(sessions_ran, what="catchup sessions ran")
                # the network-committed tail is re-submitted through the
                # VICTIM's ingress (deterministic ed25519 -> identical
                # content): it lands in its recent ring as Pending and
                # gap-blocks — the exact shape where the old code wrote
                # FAILURE for a transfer every peer calls SUCCESS
                async with Client(f"http://{cfgs[2].rpc_address}") as c2:
                    await c2.send_asset(sender, 8, recipient, 10)
                await asyncio.sleep(1.2)  # > several TTLs and sessions
                applied_then = victim.catchup_stats["catchup_applied"]
                # honest progress counting: the in-horizon tail entered
                # the heap ONCE; later sessions are dedup hits, not
                # "progress" (a livelock would show applied never 0)
                assert 1 <= applied_then <= 4
                await asyncio.sleep(1.0)
                assert victim.catchup_stats["catchup_applied"] == applied_then
                # the gap is genuinely unrecoverable: frontier stays 0
                assert (
                    await victim.accounts.get_last_sequence(sender.public)
                ) == 0
                # ...and the ring NEVER contradicts the network: seq 8 is
                # committed everywhere else; locally it must still read
                # PENDING (gap-blocked), not FAILURE
                ring = await victim.recent.get_all()
                states = {
                    t.sender_sequence: t.state
                    for t in ring
                    if t.sender == sender.public
                }
                assert states.get(8) == TransactionState.PENDING, states
        finally:
            for s in services:
                await s.close()


class TestCrashConsistency:
    def _spawn_server(self, toml: str, log):
        proc = subprocess.Popen(
            [sys.executable, "-m", "at2_node_tpu_torch.cli.server", "run"],
            stdin=subprocess.PIPE,
            stdout=log,
            stderr=log,
            text=True,
        )
        proc.stdin.write(toml)
        proc.stdin.close()
        return proc

    @pytest.mark.asyncio
    async def test_sigkill_midstream_restart_no_double_apply(self, tmp_path):
        """kill -9 (not a graceful stop): restart must not double-apply
        what the snapshot already holds, and the node must serve and
        commit new traffic afterwards."""
        cfg = make_configs(1)[0]
        cfg.checkpoint = CheckpointConfig(
            path=str(tmp_path / "ledger.ckpt"), interval=0.2
        )
        toml = cfg.dumps()
        log = open(tmp_path / "server.log", "w")
        proc = self._spawn_server(toml, log)
        sender = SignKeyPair.random()
        recipient = SignKeyPair.random().public
        try:
            async with Client(f"http://{cfg.rpc_address}") as client:
                await wait_until(
                    lambda: _rpc_up(client, sender.public), what="server up"
                )
                # commit a stream, give the periodic snapshot a beat
                for seq in range(1, 6):
                    await client.send_asset(sender, seq, recipient, 10)
                await wait_until(
                    lambda: _seq_is(client, sender.public, 5),
                    what="pre-kill commits",
                )
                await asyncio.sleep(0.5)  # >= 2 checkpoint intervals

            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=5)

            proc = self._spawn_server(toml, log)
            async with Client(f"http://{cfg.rpc_address}") as client:
                await wait_until(
                    lambda: _rpc_up(client, sender.public), what="restarted"
                )
                # no double-apply: balances/sequence match the committed
                # stream exactly (the snapshot held them; replays would
                # break the sequence gate or inflate balances)
                assert await client.get_last_sequence(sender.public) == 5
                assert await client.get_balance(sender.public) == FAUCET - 50
                assert await client.get_balance(recipient) == FAUCET + 50

                # and the node still commits new traffic
                await client.send_asset(sender, 6, recipient, 10)
                await wait_until(
                    lambda: _seq_is(client, sender.public, 6),
                    what="post-restart commit",
                )
                assert await client.get_balance(recipient) == FAUCET + 60
        finally:
            log.close()
            if proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()


async def _rpc_up(client, user) -> bool:
    try:
        await asyncio.wait_for(client.get_balance(user), timeout=1.0)
        return True
    except Exception:
        return False


async def _seq_is(client, user, seq) -> bool:
    return await client.get_last_sequence(user) == seq


class TestPoisonChaos:
    """The poison-storm episode the resolution machinery exists for
    (robustness PR acceptance): a byzantine client salts EVERY ingress
    batch with one bad-signature entry on a 4-node net. Pre-fix, each
    poisoned slot stayed "undelivered" for SLOT_MAX_AGE — burning the
    retransmission budget and kicking a network-wide catchup session per
    GC pass. Post-fix the episode must be boring: throughput within 10%
    of a clean run, zero catchup sessions, zero stall kicks, and no
    retransmissions at all (slots retire before the retransmit horizon)."""

    ROUNDS = 6
    GOOD_PER_ROUND = 25

    @staticmethod
    async def _submit(service, payload):
        await service.recent.put(
            payload.sender, payload.sequence, payload.transaction
        )
        service._batch_buf.append(payload)

    async def _episode(self, poison: bool):
        from at2_node_tpu_torch.types import ThinTransaction

        # catchup.after far past the episode length: the drain loop's
        # ordinary transient-gap kick (single-flight, delayed) can never
        # mature into a session here, so any session observed could only
        # come from the stall-storm path under test
        cfgs = make_configs(4, catchup=CatchupConfig(after=30.0))
        services = [await Service.start(c) for c in cfgs]
        kicks = [0]
        for s in services:
            orig = s.broadcast.stall_handler

            def wrapped(_orig=orig):
                kicks[0] += 1
                if _orig is not None:
                    _orig()

            s.broadcast.stall_handler = wrapped
        try:
            sender = SignKeyPair.random()
            recipient = SignKeyPair.random().public
            total = self.ROUNDS * self.GOOD_PER_ROUND
            seq = 0
            t0 = time.monotonic()
            for _ in range(self.ROUNDS):
                for _ in range(self.GOOD_PER_ROUND):
                    seq += 1
                    thin = ThinTransaction(recipient, 1)
                    await self._submit(
                        services[0],
                        Payload.create(sender, seq, thin),
                    )
                if poison:
                    # fresh forged sender each round: a bad-sig entry in
                    # every single batch slot, never gap-blocking the
                    # honest sender
                    await self._submit(
                        services[0],
                        Payload(
                            SignKeyPair.random().public,
                            1,
                            ThinTransaction(recipient, 1),
                            b"\x0b" * 64,
                        ),
                    )
                await services[0]._flush_batch()

            async def all_committed():
                return all(s.committed >= total for s in services)

            await wait_until(all_committed, what="episode commits")
            elapsed = time.monotonic() - t0
            # settle: several GC passes classify/retire what is left;
            # long enough that the first rounds' slots age past the
            # stall horizon — a pre-fix stuck poison slot WOULD kick here
            await asyncio.sleep(2.0)
            stats = [s.snapshot_stats() for s in services]
            return elapsed, stats, kicks[0]
        finally:
            for s in services:
                await s.close()

    @pytest.mark.asyncio
    async def test_poison_storm_is_boring(self, monkeypatch):
        import at2_node_tpu_torch.broadcast.stack as stack_mod

        monkeypatch.setattr(stack_mod, "GC_INTERVAL", 0.2)
        monkeypatch.setattr(stack_mod, "STALLED_CATCHUP_AFTER", 4.0)
        monkeypatch.setattr(stack_mod, "RETRANSMIT_AFTER", 1.5)
        clean_t, clean_stats, clean_kicks = await self._episode(poison=False)
        dirty_t, dirty_stats, dirty_kicks = await self._episode(poison=True)
        # throughput within 10% of the clean episode (+0.75s absorbs
        # scheduler noise on runs this short)
        assert dirty_t <= clean_t * 1.10 + 0.75, (clean_t, dirty_t)
        for snap in dirty_stats:
            assert snap["catchup_sessions"] == 0
        # FLAT retransmits: pre-fix every poisoned slot re-broadcast its
        # content once past the horizon (+ROUNDS per node); post-fix the
        # retired slots are excluded, so the poison adds nothing beyond
        # the clean episode's ordinary backlog stragglers
        clean_rtx = sum(s["retransmits"] for s in clean_stats)
        dirty_rtx = sum(s["retransmits"] for s in dirty_stats)
        assert dirty_rtx <= clean_rtx + 2, (clean_rtx, dirty_rtx)
        assert dirty_kicks == 0 and clean_kicks == 0
        # every poisoned slot resolved by local rejection on every node
        assert all(
            snap["poison_resolved"] >= self.ROUNDS for snap in dirty_stats
        ), [s["poison_resolved"] for s in dirty_stats]
        assert all(snap["slots_retired"] >= self.ROUNDS for snap in dirty_stats)


class TestMixedFleetRecovery:
    @pytest.mark.asyncio
    async def test_port_node_recovers_from_reference_peers(self):
        """Differential: a port node killed and restarted with full state
        loss in a fleet of two reference nodes recovers the history it
        missed through the catch-up protocol the reference nodes serve;
        afterwards its ledger equals theirs, account by account, and the
        reference nodes did the serving."""
        import numpy as np

        from at2_node_tpu.node.config import Config as RefConfig
        from at2_node_tpu.node.service import Service as RefService

        rng = np.random.default_rng(31)
        cfgs = make_configs(3, echo_threshold=1, ready_threshold=1,
                            catchup=CatchupConfig(quorum=2, after=0.5, window=0.3))
        services = [await RefService.start(RefConfig.loads(c.dumps())) for c in cfgs[:2]]
        services.append(await Service.start(cfgs[2]))
        senders = [SignKeyPair(rng.bytes(32)) for _ in range(3)]
        recipient = rng.bytes(32)
        try:
            async with Client(f"http://{cfgs[0].rpc_address}") as client:
                for kp in senders:
                    await client.send_asset(kp, 1, recipient, 10)
                await wait_until(lambda: _all_committed(services, senders, 1), what="seq 1 on all nodes")
                await services[2].close()
                for kp in senders:
                    await client.send_asset(kp, 2, recipient, 10)
                await wait_until(lambda: _all_committed(services[:2], senders, 2), what="seq 2 on the survivors")
                services[2] = await Service.start(cfgs[2])
                for kp in senders:
                    await client.send_asset(kp, 3, recipient, 10)
                await wait_until(lambda: _all_committed(services, senders, 3), what="parity after the restart")
            ledgers = [[await s.accounts.get_balance(k) for k in [recipient] + [kp.public for kp in senders]]
                       for s in services]
            assert ledgers == [[FAUCET + 90] + [FAUCET - 30] * 3] * 3
            assert services[2].catchup_stats["catchup_applied"] >= 1
            assert sum(s.catchup_stats["catchup_served"] for s in services[:2]) >= 1
        finally:
            for s in services:
                await s.close()


async def _all_committed(services, senders, seq):
    for kp in senders:
        if not await _committed_on(services, seq, kp.public):
            return False
    return True

"""The port's deterministic simulator (``at2_node_tpu_torch/sim``) against
the JAX package's.

* A copy of the reference's ``tests/test_sim.py`` on the port's modules:
  virtual time, the inline executor and the deadlock guard of
  ``SimScheduler``; the fabric's delivery, partitions, loss, duplication,
  interposition and ``SimChannel``; same-seed episodes and grid cells;
  a seeded campaign; the stalled-slot overload; the planted threshold bug
  caught and minimized; the flight-recorder capture; ``Service`` under the
  sim; the fleet auditor and the capture replay.
* Port against reference, on the same seeds: whole episodes give the same
  wire-trace hash; ``HostileFrameGen``, ``SaltingClientGen``,
  ``CertAdversary``, ``mutate_cert_frame`` and ``mutate_distilled_frame``
  emit the same bytes; the five event generators the same schedules; the
  three planted episodes the same violations and the same attribution.

Every test is synchronous: each owns a ``SimScheduler`` (a virtual-time
asyncio loop) and drives it itself. Both packages run in this process,
under one hash seed, so their schedules may be compared exactly.
"""

import asyncio
import random

import pytest

from at2_node_tpu_torch.node.config import BatchingConfig
from at2_node_tpu_torch.sim.campaign import (
    apply_events,
    minimize_events,
    planted_breach_episode,
    run_campaign,
    run_episode,
)
from at2_node_tpu_torch.sim.fabric import LinkModel, SimChannel, SimFabric
from at2_node_tpu_torch.sim.net import SimNet, sim_client, sim_keypairs
from at2_node_tpu_torch.sim.scheduler import (
    SIM_START,
    SimClock,
    SimDeadlockError,
    SimScheduler,
)


class TestScheduler:
    def test_virtual_sleep_advances_no_wall_time(self):
        loop = SimScheduler()
        try:
            t0 = loop.time()
            assert t0 == SIM_START

            async def nap():
                await asyncio.sleep(3600.0)
                return loop.time()

            import time

            wall0 = time.monotonic()
            end = loop.run_until_complete(nap())
            assert end == pytest.approx(t0 + 3600.0)
            assert time.monotonic() - wall0 < 1.0  # an hour in an instant
        finally:
            loop.close()

    def test_timer_ordering_is_schedule_order(self):
        loop = SimScheduler()
        try:
            order = []
            loop.call_later(0.3, order.append, "c")
            loop.call_later(0.1, order.append, "a")
            loop.call_later(0.2, order.append, "b")
            loop.call_later(0.2, order.append, "b2")  # tie: insertion order
            loop.run_for(1.0)
            assert order == ["a", "b", "b2", "c"]
        finally:
            loop.close()

    def test_executor_runs_inline(self):
        loop = SimScheduler()
        try:
            import threading

            main = threading.get_ident()

            async def offload():
                return await loop.run_in_executor(
                    None, lambda: threading.get_ident()
                )

            assert loop.run_until_complete(offload()) == main
        finally:
            loop.close()

    def test_lost_wakeup_deadlocks_loudly(self):
        loop = SimScheduler()
        try:
            with pytest.raises(SimDeadlockError):
                loop.run_until_complete(asyncio.Event().wait())
        finally:
            loop.close()

    def test_clock_binds_to_loop(self):
        loop = SimScheduler()
        try:
            clock = SimClock(loop)
            w0, m0 = clock.wall(), clock.monotonic()
            loop.run_for(12.5)
            assert clock.monotonic() - m0 == pytest.approx(12.5)
            assert clock.wall() - w0 == pytest.approx(12.5)
        finally:
            loop.close()


class TestFabric:
    def _fabric(self, seed=0, **link):
        loop = SimScheduler()
        asyncio.set_event_loop(loop)
        fabric = SimFabric(loop, seed=seed, default_link=LinkModel(**link))
        return loop, fabric

    def _mesh_pair(self, loop, fabric):
        from at2_node_tpu_torch.net.peers import Peer
        from at2_node_tpu_torch.sim.fabric import SimMesh

        ka, xa = sim_keypairs(0, 0)
        kb, xb = sim_keypairs(0, 1)
        pa = Peer("sim-a:0", xa.public, ka.public)
        pb = Peer("sim-b:0", xb.public, kb.public)
        got_a, got_b = [], []

        async def on_a(peer, frame):
            got_a.append(frame)

        async def on_b(peer, frame):
            got_b.append(frame)

        mesh_a = SimMesh(fabric, ka.public, [pb], on_a)
        mesh_b = SimMesh(fabric, kb.public, [pa], on_b)
        return mesh_a, mesh_b, pa, pb, got_a, got_b

    def test_delivery_and_partition(self):
        loop, fabric = self._fabric()
        try:
            mesh_a, mesh_b, pa, pb, got_a, got_b = self._mesh_pair(loop, fabric)
            mesh_a.send(pb, b"\x01hello")
            loop.run_for(1.0)
            assert got_b == [b"\x01hello"]
            fabric.partition(pa.sign_public, pb.sign_public)
            mesh_a.send(pb, b"\x01cut")
            loop.run_for(1.0)
            assert got_b == [b"\x01hello"]  # blackholed
            fabric.heal(pa.sign_public, pb.sign_public)
            mesh_b.send(pa, b"\x01back")
            loop.run_for(1.0)
            assert got_a == [b"\x01back"]
        finally:
            loop.close()
            asyncio.set_event_loop(None)

    def test_loss_and_duplication_are_seeded(self):
        loop, fabric = self._fabric(seed=3, loss=0.5, dup=0.3)
        try:
            mesh_a, mesh_b, pa, pb, _, got_b = self._mesh_pair(loop, fabric)
            for i in range(40):
                mesh_a.send(pb, bytes([1, i]))
            loop.run_for(2.0)
            # lossy and duplicating: SOME dropped, SOME duplicated, and
            # the exact counts are a pure function of the seed
            assert 0 < len(got_b) != 40
            assert fabric.dropped > 0
        finally:
            loop.close()
            asyncio.set_event_loop(None)

    def test_interposer_drops_by_kind(self):
        loop, fabric = self._fabric()
        try:
            mesh_a, mesh_b, pa, pb, _, got_b = self._mesh_pair(loop, fabric)
            fabric.interposer = (
                lambda src, dst, frame: [] if frame[0] == 2 else None
            )
            mesh_a.send(pb, b"\x01keep")
            mesh_a.send(pb, b"\x02drop")
            mesh_a.send(pb, b"\x03keep")
            loop.run_for(1.0)
            assert sorted(got_b) == [b"\x01keep", b"\x03keep"]
        finally:
            loop.close()
            asyncio.set_event_loop(None)

    def test_sim_channel_surface(self):
        from at2_node_tpu_torch.net.transport import ChannelClosed

        loop = SimScheduler()
        asyncio.set_event_loop(loop)
        try:
            a_end, b_end = SimChannel.pair(loop, b"A" * 32, b"B" * 32, 0.01)
            assert a_end.peer_public == b"B" * 32
            assert b_end.peer_public == b"A" * 32

            async def roundtrip():
                await a_end.send(b"ping")
                got = await b_end.recv()
                await b_end.send(b"pong")
                return got, await a_end.recv()

            assert loop.run_until_complete(roundtrip()) == (b"ping", b"pong")
            a_end.close()
            with pytest.raises(ChannelClosed):
                loop.run_until_complete(b_end.recv())
        finally:
            loop.close()
            asyncio.set_event_loop(None)


class TestDeterminism:
    def test_same_seed_same_trace_hash(self):
        results = [
            run_episode(77, n_events=12, duration=6.0, settle_horizon=45.0)
            for _ in range(2)
        ]
        assert results[0].trace_hash == results[1].trace_hash
        assert results[0].committed == results[1].committed
        assert results[0].events == results[1].events

    def test_different_seeds_diverge(self):
        a = run_episode(1, n_events=8, duration=4.0, settle_horizon=30.0)
        b = run_episode(2, n_events=8, duration=4.0, settle_horizon=30.0)
        assert a.trace_hash != b.trace_hash


class TestScenarioGrid:
    def test_same_seed_same_cell(self):
        """A WAN grid cell is pure in (seed, params): same wire-trace
        hash AND byte-identical measurement JSON on re-run."""
        import json

        from at2_node_tpu_torch.sim.scenarios import run_cell

        kw = dict(nodes=3, n_clients=3, n_tx=8, duration=3.0,
                  settle_horizon=60.0)
        a = run_cell(31, "wan3", "flash_crowd", "none", **kw)
        b = run_cell(31, "wan3", "flash_crowd", "none", **kw)
        assert a["trace_hash"] == b["trace_hash"]
        a.pop("wall_seconds"), b.pop("wall_seconds")
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
        # the cell is also a valid measurement: clean commits, SLO
        # verdict attached, fairness in (0, 1]
        assert a["violations"] == []
        assert a["committed"] == a["offered"]
        assert 0.0 < a["fairness"] <= 1.0
        assert a["slo"]["ok"] is True
        assert a["latency_p99_ms"] >= a["latency_p50_ms"] > 0.0

    def test_different_topologies_diverge(self):
        from at2_node_tpu_torch.sim.scenarios import run_cell

        kw = dict(nodes=3, n_clients=3, n_tx=6, duration=2.0,
                  settle_horizon=60.0)
        lan = run_cell(32, "lan", "steady", "none", **kw)
        wan = run_cell(32, "wan3", "steady", "none", **kw)
        assert lan["trace_hash"] != wan["trace_hash"]
        # regional long-haul links must show up in the tail
        assert wan["latency_p99_ms"] > lan["latency_p99_ms"]


class TestInvariantCampaign:
    def test_seeded_campaign_stays_green(self):
        """4-node f=1, hostile identity live, equivocation + partitions
        + drop windows: every episode's invariants must hold."""
        campaign = run_campaign(20260805, 3, n_events=18, duration=10.0)
        assert campaign["failures"] == 0, campaign["results"]
        # and the campaign fingerprint replays
        again = run_campaign(20260805, 3, n_events=18, duration=10.0)
        assert campaign["campaign_hash"] == again["campaign_hash"]


class TestScenarios:
    def test_stalled_slot_overload_heals(self):
        """Round-5 regression shape, from a fixed seed: a burst lands
        while every batch-echo attestation is being dropped — all slots
        stall; once the blackout lifts, budgeted retransmission heals
        every slot without client retries."""
        net = SimNet(n=4, f=1, seed=5).start()
        try:
            clients = [sim_client(5, i) for i in range(2)]
            events = [[0.0, "drop", {"src": None, "kinds": [10], "duration": 8.0}]]
            events += [
                [
                    0.5 + 0.05 * i,
                    "tx",
                    {"node": i % 4, "client": 0, "seq": i + 1, "to": 1, "amount": 1},
                ]
                for i in range(10)
            ]
            apply_events(net, events, clients, None)
            net.run_for(6.0)  # deep inside the blackout
            assert [s.committed for s in net.services] == [0, 0, 0, 0]
            net.run_for(10.0)  # blackout ends at t=8; retransmit heals
            assert [s.committed for s in net.services] == [10, 10, 10, 10]
            net.settle(horizon=40.0)
            assert net.check_invariants() == []
        finally:
            net.close()

    def test_injected_threshold_bug_caught_and_minimized(self):
        """Safety-bug detection end to end: thresholds forced to 1
        (below the quorum-intersection bound), per-tx plane, honest
        attestations between the two target nodes suppressed — an
        equivocating client splits the net into divergent commits. The
        invariant checker must flag it, replay must reproduce it, and
        minimization must shrink the schedule to a few events."""
        from at2_node_tpu_torch.broadcast.messages import (
            ECHO,
            READY,
            Attestation,
            Payload,
        )
        from at2_node_tpu_torch.types import ThinTransaction

        seed = 20260805
        clients = [sim_client(seed, i) for i in range(4)]
        hostile_sign, _ = sim_keypairs(seed, 4)  # identity 4: hostile peer

        def payload(to_i, amount):
            tx = ThinTransaction(clients[to_i].public, amount)
            return Payload.create(clients[0], 1, tx)

        def att_frames(chash):
            out = []
            for phase in (ECHO, READY):
                sig = hostile_sign.sign(
                    Attestation.signing_bytes(
                        phase, clients[0].public, 1, chash
                    )
                )
                out.append(
                    Attestation(
                        phase,
                        hostile_sign.public,
                        clients[0].public,
                        1,
                        chash,
                        sig,
                    ).encode().hex()
                )
            return out

        echo_a, ready_a = att_frames(payload(1, 5).content_hash())
        echo_b, ready_b = att_frames(payload(2, 6).content_hash())

        # honest attestations suppressed net-wide; the hostile peer then
        # hand-delivers a split vote: content A's quorum to node 0,
        # content B's quorum to node 1
        events = [
            [0.0, "drop", {"src": s, "kinds": [2, 3], "duration": 60.0}]
            for s in range(4)
        ] + [
            [
                0.2,
                "equiv",
                {
                    "node_a": 0,
                    "node_b": 1,
                    "client": 0,
                    "seq": 1,
                    "to_a": 1,
                    "to_b": 2,
                    "amount_a": 5,
                    "amount_b": 6,
                },
            ],
            [0.6, "inject", {"src_hostile": 1, "target": 0, "frame": echo_a}],
            [0.6, "inject", {"src_hostile": 1, "target": 0, "frame": ready_a}],
            [0.6, "inject", {"src_hostile": 1, "target": 1, "frame": echo_b}],
            [0.6, "inject", {"src_hostile": 1, "target": 1, "frame": ready_b}],
        ]

        def run(evs):
            return run_episode(
                seed,
                events=evs,
                echo_threshold=1,
                ready_threshold=1,
                config_overrides={"batching": BatchingConfig(enabled=False)},
                settle_horizon=40.0,
            )

        first = run(events)
        assert first.violations, "threshold bug must violate agreement"
        assert any("sieve violation" in v for v in first.violations)
        # exact replay: same violations, same wire trace
        again = run(events)
        assert again.violations == first.violations
        assert again.trace_hash == first.trace_hash
        # minimization: down to a <= 25-event (here: tiny) schedule
        minimal = minimize_events(
            events, lambda evs: bool(run(evs).violations)
        )
        assert len(minimal) <= 25
        assert len(minimal) < len(events)
        assert run(minimal).violations

    def test_correct_thresholds_survive_the_same_schedule(self):
        """The counterfactual: the same suppression + equivocation
        shape, with the real f=1-safe thresholds, commits at most one
        content — invariants green. The bug, not the schedule, was the
        problem."""
        events = [
            [0.0, "drop", {"src": s, "kinds": [2, 3], "duration": 60.0}]
            for s in range(4)
        ] + [
            [
                0.2,
                "equiv",
                {
                    "node_a": 0,
                    "node_b": 1,
                    "client": 0,
                    "seq": 1,
                    "to_a": 1,
                    "to_b": 2,
                    "amount_a": 5,
                    "amount_b": 6,
                },
            ]
        ]
        result = run_episode(
            20260805,
            events=events,
            config_overrides={"batching": BatchingConfig(enabled=False)},
            settle_horizon=40.0,
        )
        assert result.violations == []


class TestObsCapture:
    def test_episode_stitches_deterministically(self):
        """Fleet tracing acceptance: a 4-node honest episode stitches
        every sampled committed tx across multiple nodes with straggler
        attribution, and two same-seed runs produce a byte-identical
        stitched artifact (virtual clocks make the join exact)."""
        import json

        def go():
            return run_episode(
                7, nodes=4, hostile=0, n_events=20, duration=10.0,
                capture_obs=True,
            )

        a, b = go(), go()
        assert a.violations == []
        cov = a.obs["stitched"]["coverage"]
        assert cov["committed"] > 0
        assert cov["stitched_committed"] / cov["committed"] >= 0.95
        assert cov["with_origin"] == cov["txs"]
        # straggler attribution names a node for every delivered stage
        for tx in a.obs["stitched"]["txs"]:
            if tx["terminal"] == "committed":
                assert "ready_quorum" in tx["stragglers"]
        assert json.dumps(a.obs, sort_keys=True) == json.dumps(
            b.obs, sort_keys=True
        )

    def test_planted_breach_attaches_recorder_and_timeline(self):
        """Failing episodes carry their black box: per-node flight
        recorder dumps plus the stitched cross-node timeline of the
        offending tx (the artifact scripts/ci.sh gates on)."""
        r = planted_breach_episode()
        assert r.violations
        assert any("sieve violation" in v for v in r.violations)
        obs = r.obs
        assert obs is not None
        assert len(obs["recorders"]) == 4
        for dump in obs["recorders"]:
            rec = dump["recorder"]
            assert rec["recorded"] > 0 and rec["events"]
            assert rec["snapshots"]  # episode capture froze the ring
        offending = [
            tx for tx in obs["stitched"]["txs"] if tx["seq"] == 1
        ]
        assert offending, "the equivocated tx must appear in the timeline"
        assert offending[0]["nodes"] >= 2  # genuinely cross-node
        assert offending[0]["stragglers"]
        # the artifact round-trips through to_dict (banked as JSON by
        # tools/sim_run.py next to the minimized schedule)
        import json

        blob = json.loads(json.dumps(r.to_dict()))
        assert blob["obs"]["stitched"]["coverage"]["txs"] >= 1


class TestServiceInSim:
    def test_health_and_stats_surface(self):
        """The real observability surface works under the sim mesh."""
        net = SimNet(n=4, f=1, seed=11).start()
        try:
            net.run_for(1.0)
            for s in net.services:
                verdict = s.health_verdict()
                assert verdict["status"] == "ok", verdict
                snap = s.snapshot_stats()
                assert snap["mesh_channels"] == 3
        finally:
            net.close()

    def test_admission_runs_in_sim(self):
        """A bad client signature is rejected at the real admission
        gate, never reaching the gossip plane."""
        net = SimNet(n=4, f=1, seed=13).start()
        try:
            client = sim_client(13, 0)
            rcpt = sim_client(13, 1).public
            err = net.submit(0, client, 1, rcpt, 5, good_sig=False)
            assert err is not None  # SimRpcError from context.abort
            net.settle(horizon=30.0)
            assert [s.committed for s in net.services] == [0, 0, 0, 0]
            assert (
                net.services[0].snapshot_stats()["rejected_at_ingress"] == 1
            )
        finally:
            net.close()


class TestFleetAuditSim:
    """Episode-level contracts for the fleet consistency auditor
    (obs/audit.py) and the capture->replay bridge: detection +
    attribution on a planted corruption, digest invariance across the
    sharded plane and the [wan] levers, and deterministic replay."""

    def test_planted_divergence_detected_and_attributed(self):
        from at2_node_tpu_torch.sim.campaign import planted_divergence_episode

        seed = 20260805
        r = planted_divergence_episode(seed)
        # the fork is real, so the invariant sweep fails by design
        assert r.violations
        culprit = sim_keypairs(seed, 0)[0].public.hex()
        victim_lane = sim_client(seed, 1).public[0] >> 4
        assert r.audit is not None
        for a in r.audit[1:]:  # both honest nodes latch it
            d = a["divergence"]
            assert d is not None
            assert d["peer"] == culprit
            assert victim_lane in d["ranges"]
            # caught within two audit_every=8 beacon intervals of the
            # corruption (armed just before commit ~6)
            assert d["detected_commits"] - 6 <= 16, d
        # the culprit symmetrically sees itself diverged from a peer
        assert r.audit[0]["divergence"] is not None

    def test_digests_invariant_across_plane_shards(self):
        from at2_node_tpu_torch.node.config import ObservabilityConfig

        kw = dict(
            n_events=10,
            duration=8.0,
            settle_horizon=60.0,
            config_overrides={
                "observability": ObservabilityConfig(audit_every=8)
            },
        )
        mono = run_episode(13, **kw)
        shard = run_episode(
            13,
            **{
                **kw,
                "config_overrides": {
                    **kw["config_overrides"],
                    "plane_shards": 4,
                },
            },
        )
        assert mono.trace_hash == shard.trace_hash
        for a, b in zip(mono.audit, shard.audit):
            assert a["wm"] == b["wm"]
            assert a["ranges"] == b["ranges"]
            assert a["divergence"] is None and b["divergence"] is None

    def test_digests_invariant_across_wan_levers(self):
        """Digest equality under [wan] on/off needs a schedule where
        both runs commit the same SET (the digest is a pure function of
        committed state, not of timing) — so: serialized benign
        traffic. Adversarial schedules can commit different sets under
        the wan timing levers (TTL races), which is a scheduling
        difference, not a digest defect."""
        from at2_node_tpu_torch.node.config import ObservabilityConfig, WanConfig

        events = [
            [0.5 + 0.4 * k, "tx",
             {"node": k % 3, "client": 0, "seq": k + 1, "to": 1,
              "amount": 1}]
            for k in range(24)
        ]
        obs = ObservabilityConfig(audit_every=8)
        base = dict(
            nodes=3, f=0, hostile=0, events=events, settle_horizon=60.0
        )
        off = run_episode(
            17, **base, config_overrides={"observability": obs}
        )
        on = run_episode(
            17,
            **base,
            config_overrides={
                "observability": obs,
                "wan": WanConfig(overlap_ready=True, region_fanout=True),
            },
        )
        assert not off.violations and not on.violations
        assert off.committed == on.committed == [24, 24, 24]
        for a, b in zip(off.audit, on.audit):
            assert a["wm"] == b["wm"]
            assert a["ranges"] == b["ranges"]
            assert a["dir"] == b["dir"]
            assert a["divergence"] is None and b["divergence"] is None

    def test_capture_replay_verdict_is_deterministic(self):
        from at2_node_tpu_torch.broadcast.messages import StateBeacon
        from at2_node_tpu_torch.crypto.keys import SignKeyPair
        from at2_node_tpu_torch.tools.capture_replay import (
            replay_capture,
            verdict_hash,
        )

        # a synthetic capture: one well-formed signed beacon from a key
        # the sim fleet does not know, plus junk — the bridge must
        # replay hostile/unknown bytes, not only friendly traffic
        kp = SignKeyPair.from_hex("aa" * 32)
        beacon = StateBeacon.create(
            kp, 0, 3, (99).to_bytes(16, "little"), b"\x01" * 128,
            b"\x02" * 8, b"\x03" * 32,
        )
        doc = {
            "cap": 16,
            "captured": 3,
            "records": [
                [1_000_000, "ab" * 32, 15, beacon.encode().hex()],
                [51_000_000, "ab" * 32, 222, "deadbeef"],
                [101_000_000, "ab" * 32, 0, "00" * 40],
            ],
        }
        v1 = replay_capture(doc, 7, nodes=4)
        v2 = replay_capture(doc, 7, nodes=4)
        assert verdict_hash(v1) == verdict_hash(v2)
        assert v1["injected"] == 3
        assert not v1["violations"]


# -- port against reference ------------------------------------------------


def _ref():
    from at2_node_tpu.sim import campaign, hostile

    return campaign, hostile


class TestParityEpisodes:
    @pytest.mark.parametrize("seed", [7, 77])
    def test_episode_trace_hash_equals_reference(self, seed):
        ref_campaign, _ = _ref()
        kw = dict(n_events=12, duration=6.0, settle_horizon=45.0)
        mine = run_episode(seed, **kw)
        ref = ref_campaign.run_episode(seed, **kw)
        assert mine.violations == ref.violations == []
        assert mine.events == ref.events
        assert mine.committed == ref.committed
        assert mine.delivered == ref.delivered
        assert mine.trace_hash == ref.trace_hash

    def test_sim_nodes_name_the_host_verifier(self):
        """The port's verifier kind defaults to "cuda"; a sim node runs
        the shared host ``CpuVerifier`` and its config says so."""
        from at2_node_tpu_torch.crypto.verifier import CpuVerifier
        from at2_node_tpu_torch.node.config import VerifierConfig

        net = SimNet(n=4, f=1, seed=3).start()
        try:
            assert all(c.verifier.kind == "cpu" for c in net.configs)
            assert isinstance(net.verifier, CpuVerifier)
        finally:
            net.close()
        own = SimNet(n=2, f=0, seed=3, verifier=VerifierConfig(kind="cpu", batch_size=64))
        assert [c.verifier.batch_size for c in own.configs] == [64, 64]


class TestParityHostile:
    def _frame_gen(self, pkg_hostile, pkg_keys, seed):
        key = pkg_keys.SignKeyPair(bytes(range(32)))
        return pkg_hostile.HostileFrameGen(key, random.Random(seed))

    @pytest.mark.parametrize("seed", [1, 20260731])
    def test_hostile_frame_gen_bytes_equal(self, seed):
        from at2_node_tpu.crypto import keys as ref_keys
        from at2_node_tpu_torch.crypto import keys
        from at2_node_tpu_torch.sim import hostile

        _, ref_hostile = _ref()
        mine = self._frame_gen(hostile, keys, seed)
        ref = self._frame_gen(ref_hostile, ref_keys, seed)
        assert [c.public for c in mine.clients] == [c.public for c in ref.clients]
        assert mine.recipients == ref.recipients
        frames = [mine.next_frame() for _ in range(300)]
        assert frames == [ref.next_frame() for _ in range(300)]
        assert len({f[0] for f in frames}) >= 8  # many kinds, not one
        assert mine.rng.getstate() == ref.rng.getstate()

    def test_salting_and_cert_adversaries_equal(self):
        from at2_node_tpu.crypto import keys as ref_keys
        from at2_node_tpu_torch.crypto import keys
        from at2_node_tpu_torch.sim import hostile

        _, ref_hostile = _ref()
        mine = hostile.SaltingClientGen(random.Random(4), k_bad=3)
        ref = ref_hostile.SaltingClientGen(random.Random(4), k_bad=3)
        assert mine.key.public == ref.key.public
        for size in (1, 2, 7, 128, 300):
            assert mine.positions(size) == ref.positions(size)
            assert mine.next_flush(size) == ref.next_flush(size)
        adv = hostile.CertAdversary(keys.SignKeyPair(b"\x05" * 32), random.Random(6))
        ref_adv = ref_hostile.CertAdversary(ref_keys.SignKeyPair(b"\x05" * 32), random.Random(6))
        for _ in range(8):
            assert adv.equivocating_pair(0) == ref_adv.equivocating_pair(0)
            assert adv.off_epoch(3) == ref_adv.off_epoch(3)
            assert adv.forged(1) == ref_adv.forged(1)
            assert adv.mutant(0) == ref_adv.mutant(0)

    def test_frame_mutators_equal(self):
        import numpy as np

        from at2_node_tpu_torch.sim.hostile import mutate_cert_frame, mutate_distilled_frame

        _, ref_hostile = _ref()
        gen = np.random.default_rng(10)
        for n in (0, 1, 5, 64, 265, 900):
            frame = gen.integers(0, 256, n, dtype=np.uint8).tobytes()
            seed = int(gen.integers(1 << 31))
            for mine_fn, ref_fn in ((mutate_cert_frame, ref_hostile.mutate_cert_frame),
                                    (mutate_distilled_frame, ref_hostile.mutate_distilled_frame)):
                a, b = random.Random(seed), random.Random(seed)
                assert [mine_fn(frame, a) for _ in range(64)] == [ref_fn(frame, b) for _ in range(64)]


class TestParityGenerators:
    @pytest.mark.parametrize(
        "name",
        ["generate_events", "generate_durability_events", "generate_broker_events",
         "generate_salting_events", "generate_cert_events"],
    )
    def test_generator_schedules_equal(self, name):
        from at2_node_tpu_torch.sim import campaign

        ref_campaign, _ = _ref()
        for seed in (0, 1, 13, 20260805):
            for kw in ({}, {"n_events": 12, "nodes": 3, "hostile": False}):
                a = getattr(campaign, name)(random.Random(seed), **kw)
                b = getattr(ref_campaign, name)(random.Random(seed), **kw)
                assert a == b, (name, seed, kw)
                assert a  # a schedule, not nothing


class TestParityPlanted:
    def test_planted_breach_equal(self):
        ref_campaign, _ = _ref()
        mine = planted_breach_episode(20260805)
        ref = ref_campaign.planted_breach_episode(20260805)
        assert mine.violations and mine.violations == ref.violations
        assert mine.trace_hash == ref.trace_hash
        offending = [
            [(tx["seq"], tx["nodes"], sorted(tx["stragglers"])) for tx in r.obs["stitched"]["txs"] if tx["seq"] == 1]
            for r in (mine, ref)
        ]
        assert offending[0] and offending[0] == offending[1]
        assert len(mine.obs["recorders"]) == len(ref.obs["recorders"]) == 4

    def test_planted_divergence_equal(self):
        from at2_node_tpu_torch.sim.campaign import planted_divergence_episode

        ref_campaign, _ = _ref()
        mine = planted_divergence_episode(20260805)
        ref = ref_campaign.planted_divergence_episode(20260805)
        assert mine.violations and mine.violations == ref.violations
        assert mine.trace_hash == ref.trace_hash
        assert [a["divergence"] for a in mine.audit] == [a["divergence"] for a in ref.audit]
        culprit = sim_keypairs(20260805, 0)[0].public.hex()
        assert all(a["divergence"]["peer"] == culprit for a in mine.audit[1:])

    def test_planted_cert_equivocation_equal(self):
        from at2_node_tpu_torch.sim.campaign import planted_cert_equivocation_episode

        ref_campaign, _ = _ref()
        seed = 20260807
        mine = planted_cert_equivocation_episode(seed)
        ref = ref_campaign.planted_cert_equivocation_episode(seed)
        assert mine.violations == ref.violations == []
        assert mine.trace_hash == ref.trace_hash
        culprit = sim_keypairs(seed, 4)[0].public.hex()
        for a, b in zip(mine.audit, ref.audit):
            assert a["finality"] == b["finality"]
            assert a["finality"]["equivocation"]["origin"] == culprit
            assert a["finality"]["epoch_skew"] > 0 and a["finality"]["bad_sig"] > 0

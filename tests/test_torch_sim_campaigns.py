"""The port's sim campaigns against the JAX package's, and the reference's
sim tests that earlier slices of the port could not copy.

* ``run_campaign`` at the seeds of the short sim gates of the reference's
  ``scripts/ci.sh`` (determinism, byzantine broker, restart, salting)
  gives the same campaign hash, failures and per-episode results in both
  packages (one process, one hash seed).
* Copies on the port's modules of the reference's ``tests/test_restart_sim.py``
  (crash/restart on real sharded stores, reconfiguration, the durability
  campaign, top's recovery surface), the sim tests of
  ``tests/test_plane_shards.py`` (the campaign hash across shard counts and
  executors, the flash crowd on real shards, a sharded crash and restart),
  ``tests/test_obs_shipping.py`` (the hash with the obs tier on),
  ``tests/test_finality.py`` (the sim's finality lane),
  ``tests/test_distill.py`` (the byzantine-broker campaign) and the sim half
  of ``tests/test_byzantine_fuzz.py`` (the 24-episode hostile-frame
  campaign).

Synchronous tests: each owns a ``SimNet`` and its virtual-time loop.
"""

import os
import random

import pytest

from at2_node_tpu_torch.broadcast.messages import CERT_SIG, CertSig
from at2_node_tpu_torch.broadcast.shards import ShardedPlane, shard_of
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.finality import LightVerifier, verify_chain
from at2_node_tpu_torch.finality.light import default_threshold
from at2_node_tpu_torch.sim.campaign import apply_events, run_campaign, run_episode
from at2_node_tpu_torch.sim.hostile import HostileFrameGen
from at2_node_tpu_torch.sim.net import SimNet, sim_client
from at2_node_tpu_torch.sim.scenarios import flash_crowd_workload
from at2_node_tpu_torch.tools.top import once_verdict, render_frame

SHARDS = 4
N_EPISODES = 24  # the hostile-frame campaign
FRAMES_PER_EPISODE = 40


def _keypairs(n: int, seed: int = 0):
    rng = random.Random(seed)
    return [SignKeyPair(bytes(rng.getrandbits(8) for _ in range(32))) for _ in range(n)]


def _digests(seed: int = 1):
    rng = random.Random(seed)
    wm = bytes(rng.getrandbits(8) for _ in range(16))
    ranges = bytes(rng.getrandbits(8) for _ in range(128))
    dird = bytes(rng.getrandbits(8) for _ in range(8))
    return wm, ranges, dird


# -- port against reference: the short gates' campaigns ---------------------


@pytest.mark.parametrize(
    "seed,episodes,mode",
    [(7, 3, None), (11, 5, "broker"), (13, 4, "durability"), (7, 3, "salting")],
    ids=["determinism", "broker", "restart", "salting"],
)
def test_campaign_hash_equals_reference(seed, episodes, mode):
    from at2_node_tpu.sim.campaign import run_campaign as ref_run_campaign

    kw = {mode: True} if mode else {}
    mine = run_campaign(seed, episodes, **kw)
    ref = ref_run_campaign(seed, episodes, **kw)
    assert mine["failures"] == ref["failures"] == 0
    assert mine["campaign_hash"] == ref["campaign_hash"]
    for a, b in zip(mine["results"], ref["results"]):
        for key in ("seed", "trace_hash", "committed", "delivered", "violations", "events"):
            assert a[key] == b[key], key


# -- tests/test_restart_sim.py ----------------------------------------------


class TestCrashRestart:
    def test_kill_restart_under_load_stays_green(self):
        net = SimNet(n=4, f=1, seed=101, durable=True).start()
        try:
            clients = [sim_client(101, i) for i in range(3)]
            for c in clients:
                net.submit(0, c, 1, clients[0].public, 5)
            net.run_for(3.0)
            net.crash(2)
            for c in clients:
                net.submit(0, c, 2, clients[1].public, 3)
            net.run_for(3.0)
            net.restart(2)
            net.settle(horizon=60.0)

            net.assert_invariants()
            assert net.attest_violations == []
            # the invariant actually observed signatures across both
            # incarnations, it did not pass vacuously
            assert any(key[0] == 2 for key in net._attest)
            svc = net.services[2]
            assert svc.recovery.state == "live"
            # ledger state (not the per-incarnation committed counter):
            # every node holds every client's seq-2 commit
            for s in net.services:
                state = s.store.accounts_state()
                for c in clients:
                    assert state[c.public.hex()][0] == 2
        finally:
            net.close()

    def test_restart_loads_segments_then_replays_wal(self):
        net = SimNet(n=4, f=1, seed=102, durable=True).start()
        try:
            c = sim_client(102, 0)
            net.submit(0, c, 1, sim_client(102, 1).public, 7)
            net.settle(horizon=30.0)
            net.flush_store(3)  # segments hold seq 1
            net.submit(0, c, 2, sim_client(102, 1).public, 7)
            net.settle(horizon=30.0)  # seq 2 only in node 3's WAL
            net.crash(3)
            svc = net.restart(3)

            assert svc.store.segments_loaded > 0
            assert svc.store.wal_replayed > 0
            assert svc.recovery.segments_loaded > 0
            assert svc.recovery.wal_records_replayed > 0
            # the restart restored both slots from disk alone — neither
            # catchup nor re-delivery has anything left to transfer
            # (svc.committed counts THIS incarnation's commits only)
            assert svc.store.accounts_state()[c.public.hex()][0] == 2
            assert svc.store.history_count() == 2
            net.settle(horizon=30.0)
            assert svc.committed == 0
            net.assert_invariants()
            assert svc.recovery.state == "live"
        finally:
            net.close()

    def test_parked_payload_survives_restart(self):
        """Seq 2 delivered while seq 1 is still unsent parks at the
        sequence gate; the parked record must survive the crash because
        the broadcast will never retransmit a delivered slot."""
        net = SimNet(n=4, f=1, seed=103, durable=True).start()
        try:
            c = sim_client(103, 0)
            net.submit(0, c, 2, sim_client(103, 1).public, 9)
            net.run_for(5.0)  # delivered fleet-wide, committed nowhere
            assert [s.committed for s in net.services] == [0, 0, 0, 0]
            assert net.services[1].store.parked_count() == 1

            net.crash(1)
            svc = net.restart(1)
            assert svc.store.parked_count() == 1  # restored from WAL

            net.submit(0, c, 1, sim_client(103, 1).public, 9)
            net.settle(horizon=60.0)
            net.assert_invariants()
            assert [s.committed for s in net.services] == [2, 2, 2, 2]
            # committing pruned the parked set everywhere
            assert all(s.store.parked_count() == 0 for s in net.services)
        finally:
            net.close()


class TestReconfiguration:
    def test_remove_hostile_reweights_and_evicts(self):
        net = SimNet(
            n=4, f=1, seed=104, hostile=1, durable=True,
            membership_grace=1.0,
        ).start()
        try:
            evicted = net.hostile_configs[0].sign_key.public
            # n_peers drops 4 -> 3; crash-fault thresholds for f=1
            tx = net.reconfig(0, {
                "remove": [evicted.hex()],
                "echo_threshold": 2,
                "ready_threshold": 2,
            })
            assert tx.epoch == 1
            net.settle(horizon=30.0)  # gossip + grace expiry + sweep

            for s in net.services:
                assert s.membership.epoch == 1
                assert s.broadcast.ready_threshold == 2
                # post-grace: the identity is out of the mesh, so its
                # frames die at the fabric's by_sign lookup
                assert evicted not in s.mesh.by_sign
                assert s.membership.stats()["evicted_final"] == 1

            # traffic still flows at the re-weighted quorum
            c = sim_client(104, 0)
            net.submit(0, c, 1, sim_client(104, 1).public, 4)
            net.settle(horizon=30.0)
            net.assert_invariants()
            assert [s.committed for s in net.services] == [1, 1, 1, 1]
        finally:
            net.close()

    def test_stale_epoch_config_rejected(self):
        net = SimNet(
            n=4, f=1, seed=105, durable=True, membership_grace=1.0
        ).start()
        try:
            net.reconfig(0, {})  # epoch 0 -> 1
            svc = net.services[0]
            assert svc.membership.epoch == 1
            before = svc.membership.stats()["rejected"]
            # a replayed epoch is normal gossip echo: ignored, not
            # counted; a GAPPED future epoch is rejected outright
            net.reconfig(0, {}, epoch=1)
            net.reconfig(0, {}, epoch=5)
            assert svc.membership.epoch == 1
            assert svc.membership.stats()["applied"] == 1
            assert svc.membership.stats()["rejected"] == before + 1
        finally:
            net.close()

    def test_epoch_persists_across_restart(self):
        net = SimNet(
            n=4, f=1, seed=106, durable=True, membership_grace=1.0
        ).start()
        try:
            net.reconfig(0, {})
            net.settle(horizon=20.0)
            for i in range(4):
                net.flush_store(i)
            net.crash(2)
            svc = net.restart(2)
            assert svc.store.epoch == 1
            assert svc.membership.epoch == 1  # seeded from the manifest
            assert svc.health_verdict()["epoch"] == 1
            net.settle(horizon=20.0)
            net.assert_invariants()
        finally:
            net.close()


class TestDurabilityCampaign:
    def test_durability_episode_green(self):
        r = run_episode(3, durability=True, n_events=20, duration=18.0)
        assert r.ok, r.violations
        assert sum(r.committed) > 0

    def test_same_seed_same_campaign_hash(self):
        kw = dict(durability=True, n_events=15, duration=15.0)
        a = run_campaign(7, 2, **kw)
        b = run_campaign(7, 2, **kw)
        assert a["failures"] == 0
        assert a["campaign_hash"] == b["campaign_hash"]
        assert a["durability"] is True


class TestTopRecoverySurface:
    """tools/top.py renders the recovery machine and gates --once on
    the recovering deadline (pure-function tests, no sockets)."""

    def _row(self, status, recovery):
        return ("n1:1", {
            "health": {
                "status": status, "epoch": 3, "committed": 10,
                "peers_connected": 3, "peers_configured": 3,
            },
            "recovery": recovery,
            "stats": {}, "tx_lifecycle": {}, "verifier_stages": {},
        })

    def test_frame_shows_recovery_progress_and_epoch(self):
        frame = render_frame(
            [self._row("recovering",
                       {"state": "catchup", "catchup_lag": 7})],
            1.0, {},
        )
        assert "recovering" in frame
        assert "catchup lag 7" in frame
        assert "epoch" in frame.splitlines()[0]

    def test_once_tolerates_recovering_within_deadline(self):
        rows = [self._row("recovering",
                          {"state": "replaying_wal", "elapsed_s": 30.0})]
        assert once_verdict(rows, 120.0) == []

    def test_once_fails_recovering_past_deadline(self):
        rows = [self._row("recovering",
                          {"state": "catchup", "elapsed_s": 500.0})]
        bad = once_verdict(rows, 120.0)
        assert len(bad) == 1 and "deadline" in bad[0]

    def test_once_still_fails_down_and_degraded(self):
        rows = [
            ("dead:1", ConnectionRefusedError("nope")),
            self._row("degraded", {"state": "live"}),
            self._row("ok", {"state": "live"}),
        ]
        bad = once_verdict(rows, 120.0)
        assert len(bad) == 2
        assert any("down" in b for b in bad)
        assert any("degraded" in b for b in bad)


# -- tests/test_plane_shards.py: the sim ------------------------------------


class TestCampaignShardInvariance:
    @pytest.mark.parametrize("seed", [0, 7])
    def test_same_seed_same_hash_shards_1_vs_4(self, seed):
        """The whole determinism story in one assert: a full episode
        (clients, hostile traffic, settle, invariants) produces the SAME
        wire-trace hash whether the plane runs monolithic or split
        across 4 inline shards."""
        kw = dict(n_events=10, duration=8.0, settle_horizon=60.0)
        mono = run_episode(seed, **kw)
        sharded = run_episode(
            seed, config_overrides={"plane_shards": SHARDS}, **kw
        )
        assert mono.violations == []
        assert sharded.violations == []
        assert sharded.trace_hash == mono.trace_hash
        assert sharded.committed == mono.committed
        assert sharded.delivered == mono.delivered

    def test_sharded_episode_is_self_deterministic(self):
        kw = dict(n_events=8, duration=6.0, settle_horizon=45.0)
        a = run_episode(11, config_overrides={"plane_shards": SHARDS}, **kw)
        b = run_episode(11, config_overrides={"plane_shards": SHARDS}, **kw)
        assert a.trace_hash == b.trace_hash
        assert a.committed == b.committed


# ---------------------------------------------------------------------------
# flash crowd: conservation + commit ordering, non-vacuously sharded


class TestFlashCrowdSharded:
    def test_flash_crowd_conserves_across_real_shards(self):
        nodes, n_clients, n_tx, duration = 4, 6, 40, 8.0
        seed = 5
        net = SimNet(nodes, 1, seed, hostile=0, plane_shards=SHARDS)
        net.start()
        try:
            clients = [sim_client(seed, i) for i in range(n_clients)]
            rng = random.Random(seed)
            events = flash_crowd_workload(
                rng, nodes=nodes, n_clients=n_clients, n_tx=n_tx,
                duration=duration,
            )
            events.sort(key=lambda e: (e[0], e[1]))
            apply_events(net, events, clients, None)
            last_t = max(e[0] for e in events)
            net.run_for(last_t + 1.0)

            # mid-run, before settle compacts everything: every slot a
            # core holds must be the one shard_of names, and the load
            # must genuinely span cores
            occupied = set()
            for svc in net.services:
                cores = svc.broadcast._cores
                assert len(cores) == SHARDS
                for sid, core in enumerate(cores):
                    for (sender, _seq) in core._slots:
                        assert shard_of(sender, SHARDS) == sid
                    for (origin, _bseq) in core._batch_slots:
                        assert shard_of(origin, SHARDS) == sid
                    if core._slots or core._batch_slots or core._delivered_slots:
                        occupied.add(sid)
            assert len(occupied) >= 2, (
                "flash crowd collapsed onto one shard — test is vacuous"
            )

            net.settle(horizon=90.0)
            net.assert_invariants()
            committed = [s.committed for s in net.services]
            assert min(committed) > 0
            # commit-tail totality: every correct node commits the same
            # count once settled (ordering divergence would show up as
            # an invariant violation above, count divergence here)
            assert len(set(committed)) == 1
        finally:
            net.close()


class TestFlashCrowdSharded:
    def test_flash_crowd_conserves_across_real_shards(self):
        nodes, n_clients, n_tx, duration = 4, 6, 40, 8.0
        seed = 5
        net = SimNet(nodes, 1, seed, hostile=0, plane_shards=SHARDS)
        net.start()
        try:
            clients = [sim_client(seed, i) for i in range(n_clients)]
            rng = random.Random(seed)
            events = flash_crowd_workload(
                rng, nodes=nodes, n_clients=n_clients, n_tx=n_tx,
                duration=duration,
            )
            events.sort(key=lambda e: (e[0], e[1]))
            apply_events(net, events, clients, None)
            last_t = max(e[0] for e in events)
            net.run_for(last_t + 1.0)

            # mid-run, before settle compacts everything: every slot a
            # core holds must be the one shard_of names, and the load
            # must genuinely span cores
            occupied = set()
            for svc in net.services:
                cores = svc.broadcast._cores
                assert len(cores) == SHARDS
                for sid, core in enumerate(cores):
                    for (sender, _seq) in core._slots:
                        assert shard_of(sender, SHARDS) == sid
                    for (origin, _bseq) in core._batch_slots:
                        assert shard_of(origin, SHARDS) == sid
                    if core._slots or core._batch_slots or core._delivered_slots:
                        occupied.add(sid)
            assert len(occupied) >= 2, (
                "flash crowd collapsed onto one shard — test is vacuous"
            )

            net.settle(horizon=90.0)
            net.assert_invariants()
            committed = [s.committed for s in net.services]
            assert min(committed) > 0
            # commit-tail totality: every correct node commits the same
            # count once settled (ordering divergence would show up as
            # an invariant violation above, count divergence here)
            assert len(set(committed)) == 1
        finally:
            net.close()


class TestShardedCrashRestart:
    def test_kill_midstream_replays_wal_and_converges(self):
        net = SimNet(
            n=4, f=1, seed=13, hostile=0, durable=True, plane_shards=SHARDS
        )
        net.start()
        try:
            clients = [sim_client(13, i) for i in range(3)]
            recipient = SignKeyPair.random().public
            seq = {i: 0 for i in range(3)}

            def burst(target):
                for ci, client in enumerate(clients):
                    seq[ci] += 1
                    net.submit(target, client, seq[ci], recipient, 3)

            burst(0)
            net.run_for(2.0)
            net.flush_store(2)
            net.crash(2)
            # traffic keeps flowing while node 2 is down — these slots
            # are in flight across the survivors' shards
            burst(1)
            burst(0)
            net.run_for(3.0)
            svc = net.restart(2)
            assert isinstance(svc.broadcast, ShardedPlane)
            # the pre-crash flush put burst 1 in segments; restart loads
            # them back through the store
            assert svc.store.segments_loaded > 0
            burst(3)
            net.settle(horizon=120.0)
            net.assert_invariants()
            # `committed` is per-incarnation; convergence is LEDGER
            # state — every node (including the restarted one) holds
            # every client's final sequence
            for s in net.services:
                state = s.store.accounts_state()
                for client in clients:
                    assert state[client.public.hex()][0] == 4
            assert net.services[2].recovery.state == "live"
        finally:
            net.close()


class TestExecutorHashSweep:
    @pytest.mark.parametrize("seed", [0, 7])
    def test_campaign_hash_identical_across_executors(self, seed):
        """`[plane] executor` is a RUNTIME placement choice, never a
        protocol change: under the sim clock the service forces inline
        execution whatever the config says, so one monolithic episode
        and three sharded episodes configured inline/thread/process must
        produce the identical wire-trace hash. This is the seam the CI
        multiprocess-plane gate pins."""
        kw = dict(n_events=8, duration=6.0, settle_horizon=45.0)
        mono = run_episode(seed, **kw)
        assert mono.violations == []
        hashes = {"mono1": mono.trace_hash}
        for ex in ("inline", "thread", "process"):
            ep = run_episode(
                seed,
                config_overrides={
                    "plane_shards": SHARDS,
                    "plane_executor": ex,
                },
                **kw,
            )
            assert ep.violations == []
            assert ep.committed == mono.committed
            assert ep.delivered == mono.delivered
            hashes[ex] = ep.trace_hash
        assert len(set(hashes.values())) == 1, hashes


# -- tests/test_obs_shipping.py: the sim -------------------------------------


class TestExecutorHashWithObs:
    def test_campaign_hash_invariant_with_obs_tier_on(self):
        """The sim forces inline execution under a non-system clock, so
        the obs shipping lane never engages and the campaign hash stays
        executor-invariant WITH the full observability tier enabled
        (the sim default) — the same seam TestExecutorHashSweep pins,
        re-asserted here because this PR grew what executor=process
        would otherwise do."""
        kw = dict(n_events=6, duration=5.0, settle_horizon=40.0)
        mono = run_episode(3, **kw)
        assert mono.violations == []
        proc = run_episode(
            3,
            config_overrides={
                "plane_shards": 2,
                "plane_executor": "process",
            },
            **kw,
        )
        assert proc.violations == []
        assert proc.trace_hash == mono.trace_hash


# -- tests/test_finality.py: the sim lane -----------------------------------


def test_finality_disabled_is_inert():
    from at2_node_tpu_torch.sim.net import SimNet

    net = SimNet(3, 0, 5).start()
    try:
        for svc in net.services:
            assert svc.certs is None
            assert svc._finality_status() == {"enabled": False}
    finally:
        net.close()


def test_sim_fleet_produces_verifiable_chain():
    from at2_node_tpu_torch.node.config import FinalityConfig, ObservabilityConfig
    from at2_node_tpu_torch.sim.net import SimNet, sim_client, sim_keypairs

    seed, nodes = 7, 4
    net = SimNet(
        nodes, 1, seed,
        finality=FinalityConfig(enabled=True),
        observability=ObservabilityConfig(audit_every=8),
    ).start()
    try:
        client = sim_client(seed, 0)
        recipient = sim_client(seed, 1).public
        for k in range(16):
            net.submit(k % nodes, client, k + 1, recipient, 1)
        net.settle(horizon=60.0)
        for svc in net.services:
            svc._emit_beacon()
        net.settle(horizon=10.0)
        keys = [sim_keypairs(seed, i)[0].public for i in range(nodes)]
        # stateless client: all genesis keys known, f+1 valid co-signers
        # required (a 2f+1 cert only guarantees ONE overlap with an
        # arbitrary f+1 key subset — the signer set is arrival-order)
        subset = LightVerifier(keys, total=nodes)
        assert subset.threshold == default_threshold(nodes)
        for svc in net.services:
            chain = list(svc.certs.chain)
            assert chain, svc.certs.status()
            assert verify_chain(chain, subset)["ok"]
            assert svc.certs.equivocation is None
        assert not net.check_invariants()
    finally:
        net.close()


def test_capture_replay_fuzzes_kind16_frames():
    """Hostile certificate frames ride the capture→replay bridge like
    any other wire kind: a synthetic capture of valid + mutated kind-16
    frames must replay to the same verdict hash twice, crash-free."""
    from at2_node_tpu_torch.sim.hostile import mutate_cert_frame
    from at2_node_tpu_torch.tools.capture_replay import replay_capture, verdict_hash

    kp = _keypairs(1)[0]
    wm, ranges, dird = _digests()
    good = CertSig.create(kp, 0, 7, wm, ranges, dird).encode()
    rng = random.Random(23)
    records = []
    for i in range(24):
        frame = good if i % 4 == 0 else mutate_cert_frame(good, rng)
        records.append([i * 5_000_000, "fuzz", CERT_SIG, frame.hex()])
    doc = {"cap": 256, "captured": len(records), "records": records}
    v1 = replay_capture(doc, 9)
    v2 = replay_capture(doc, 9)
    assert verdict_hash(v1) == verdict_hash(v2)
    assert not v1["violations"], v1["violations"]


def test_mutate_cert_frame_deterministic():
    from at2_node_tpu_torch.sim.hostile import mutate_cert_frame

    kp = _keypairs(1)[0]
    wm, ranges, dird = _digests()
    good = CertSig.create(kp, 0, 7, wm, ranges, dird).encode()
    a = [mutate_cert_frame(good, random.Random(3)) for _ in range(16)]
    b = [mutate_cert_frame(good, random.Random(3)) for _ in range(16)]
    assert a == b
    assert all(m != good for m in a)


def test_generate_cert_events_shape():
    from at2_node_tpu_torch.sim.campaign import generate_cert_events

    events = generate_cert_events(random.Random(1), n_events=20)
    kinds = [e[1] for e in events]
    assert kinds.count("cert_equiv") == 3
    assert kinds.count("cert_stale") == 2
    assert kinds.count("cert_forge") == 2
    assert [e[0] for e in events] == sorted(e[0] for e in events)
    assert generate_cert_events(random.Random(1), n_events=20) == events

def test_late_quorum_keeps_the_chain_ordered():
    """A quorum for an older audit point that completes after a newer one
    (co-signatures reach a node in any order over real sockets) goes into
    the chain in order: the served chain never rolls back, as the sim's
    certificate sweep requires of every node. The reference's assembler
    appends it, and its own ``verify_chain`` then refuses the chain."""
    from at2_node_tpu.broadcast.messages import CertSig as RefCertSig
    from at2_node_tpu.crypto.keys import SignKeyPair as RefSignKeyPair
    from at2_node_tpu.finality import CertAssembler as RefAssembler
    from at2_node_tpu.finality import LightVerifier as RefLightVerifier
    from at2_node_tpu.finality import verify_chain as ref_verify_chain
    from at2_node_tpu_torch.finality import CertAssembler

    seeds = [bytes([i + 1]) * 32 for i in range(4)]
    points = [(256, *_digests(1)), (512, *_digests(2)), (768, *_digests(3))]
    order = [1, 0, 2]  # the 256 quorum completes after the 512 one
    chains = []
    for asm_cls, key_cls, sig_cls in ((CertAssembler, SignKeyPair, CertSig),
                                      (RefAssembler, RefSignKeyPair, RefCertSig)):
        kps = [key_cls(s) for s in seeds]
        asm = asm_cls([kp.public for kp in kps])
        for p in order:
            commits, wm, ranges, dird = points[p]
            for kp in kps[:3]:
                asm.add(sig_cls.create(kp, 0, commits, wm, ranges, dird))
        chains.append(asm)
    mine, ref = chains
    assert [c.commits for c in mine.chain] == [256, 512, 768]
    assert mine.latest.commits == 768
    assert verify_chain(mine.chain, LightVerifier([], members=mine.members))["ok"]
    assert [c.commits for c in ref.chain] == [512, 256, 768]
    verdict = ref_verify_chain(ref.chain, RefLightVerifier([], members=ref.members))
    assert not verdict["ok"] and verdict["reason"] == "chain progress rolled back"
    # the same certificates, only their order differs
    assert sorted(c.encode() for c in mine.chain) == sorted(c.encode() for c in ref.chain)


# -- tests/test_distill.py: the byzantine-broker campaign -------------------


class TestByzantineBrokerCampaign:
    def test_campaign_green_and_replays(self):
        from at2_node_tpu_torch.sim.campaign import run_episode

        first = run_episode(
            424, broker=True, n_events=12, duration=8.0, settle_horizon=60.0
        )
        assert first.violations == []
        assert sum(first.committed) > 0, "no distilled traffic committed"
        again = run_episode(
            424, broker=True, n_events=12, duration=8.0, settle_horizon=60.0
        )
        assert again.trace_hash == first.trace_hash  # exact-seed replay
        assert again.committed == first.committed

    def test_generator_covers_mutations(self):
        from at2_node_tpu_torch.sim.campaign import (
            BROKER_MUTATIONS,
            generate_broker_events,
        )

        rng = random.Random(5)
        seen = set()
        for _ in range(30):
            for t, kind, args in generate_broker_events(rng, n_events=20):
                if kind == "bsub":
                    seen.add(args["mutation"])
        assert seen == set(BROKER_MUTATIONS)

# -- tests/test_byzantine_fuzz.py: the sim half -----------------------------


async def _agreement(services, identities):
    """All correct nodes agree on frontier and balance for every key."""
    for key in identities:
        seqs = {await s.accounts.get_last_sequence(key) for s in services}
        assert len(seqs) == 1, f"frontier divergence for {key.hex()[:16]}: {seqs}"
        bals = {await s.accounts.get_balance(key) for s in services}
        assert len(bals) == 1, f"balance divergence for {key.hex()[:16]}: {bals}"


class TestByzantineWireFuzzSim:
    def test_seeded_campaign_sim_fabric(self):
        """The full 24-episode campaign on the deterministic simulated
        fabric: virtual time, seeded delivery jitter, exact replay from
        (AT2_FUZZ_SEED). SYNC test: it owns the virtual event loop."""
        campaign_seed = int(os.environ.get("AT2_FUZZ_SEED", "20260731"))
        rng = random.Random(campaign_seed)
        net = SimNet(
            n=4,
            f=1,
            seed=campaign_seed,
            hostile=1,
            echo_threshold=3,
            ready_threshold=3,
        ).start()
        honest = sim_client(campaign_seed, 100)
        honest_rcpt = sim_client(campaign_seed, 101).public
        try:
            hostile = HostileFrameGen(net.hostile_configs[0].sign_key, rng)
            node_signs = [c.sign_key.public for c in net.configs[:4]]

            def frontier(key):
                return [
                    net.loop.run_until_complete(
                        s.accounts.get_last_sequence(key)
                    )
                    for s in net.services
                ]

            for ep in range(N_EPISODES):
                ep_seed = rng.getrandbits(32)
                hostile.rng.seed(ep_seed)
                try:
                    for _ in range(FRAMES_PER_EPISODE):
                        frame = hostile.next_frame()
                        targets = hostile.rng.sample(
                            range(4), hostile.rng.randint(1, 4)
                        )
                        for t in targets:
                            net.fabric.inject(
                                hostile.sign.public, node_signs[t], frame
                            )
                        net.run_for(0.02)
                    # liveness: honest traffic commits everywhere
                    seq = ep + 1
                    err = net.submit(0, honest, seq, honest_rcpt, 1)
                    assert err is None, f"honest tx rejected: {err}"
                    for _ in range(240):
                        net.run_for(0.5)
                        if all(fr >= seq for fr in frontier(honest.public)):
                            break
                    else:
                        raise AssertionError(
                            "honest tx did not commit on all nodes: "
                            f"{frontier(honest.public)}"
                        )
                    # agreement on everything the episode touched
                    touched = (
                        [c.public for c in hostile.clients]
                        + list(hostile.recipients)
                        + [honest.public, honest_rcpt]
                    )
                    net.loop.run_until_complete(
                        _agreement(net.services, touched)
                    )
                except AssertionError as exc:
                    raise AssertionError(
                        f"episode {ep} (seed {ep_seed}, campaign "
                        f"{campaign_seed}): {exc}"
                    ) from exc
            # hostile frames never killed a correct node's inbound plane
            for s in net.services:
                assert s.broadcast.stats["delivered"] >= N_EPISODES
            # beyond the live test: settle and sweep the FULL invariant
            # set (agreement + sieve consistency + totality +
            # conservation) across everything the campaign committed
            net.settle(horizon=90.0)
            violations = net.check_invariants()
            assert violations == [], violations
        finally:
            net.close()

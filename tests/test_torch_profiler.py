"""Continuous-profiler tier tests (obs/profiler.py + /profilez), the
port's twin of tests/test_profiler.py; that file's regress.py tier has
its twin in tests/test_torch_regress.py.

Four tiers:

* PhaseAccounting — counter exactness under thread concurrency (the
  decomposition shares are only trustworthy if concurrent markers never
  lose a nanosecond), chained-segment disjointness, and the free ride
  through Registry.snapshot();
* StackSampler — start/stop/restart hygiene, duration self-stop, the
  bounded tree's ``(truncated)`` collapse, and byte-identical folded
  output regardless of insertion order (the CI determinism contract);
* EventLoopLagProbe — exact-zero lag under the sim virtual clock driven
  via probe_once (no standing timer, no SimScheduler deadlock), real
  measurements on a live loop;
* e2e — /profilez through the real PortMux (start/stop/folded/kill-
  switch) and the /statusz build block;

and a differential: the same seeded phase marks and stacks through the
reference's PhaseAccounting and StackSampler give the same counters,
exposition and folded profile.
"""

import asyncio
import itertools
import json
import threading

import pytest

from at2_node_tpu_torch.crypto.keys import ExchangeKeyPair, SignKeyPair
from at2_node_tpu_torch.net.peers import Peer
from at2_node_tpu_torch.node.config import Config, ObservabilityConfig, VerifierConfig
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.obs import Registry
from at2_node_tpu_torch.obs.profiler import (
    PHASES,
    PLANE_LEAF_PHASES,
    EventLoopLagProbe,
    PhaseAccounting,
    StackSampler,
    build_info,
)
from at2_node_tpu_torch.sim.scheduler import SimClock, SimScheduler

_ports = itertools.count(32400)


def make_configs(n, **overrides):
    cfgs = [
        Config(
            node_address=f"127.0.0.1:{next(_ports)}",
            rpc_address=f"127.0.0.1:{next(_ports)}",
            sign_key=SignKeyPair.random(),
            network_key=ExchangeKeyPair.random(),
            verifier=VerifierConfig(kind="cpu"),
            **overrides,
        )
        for _ in range(n)
    ]
    for i, cfg in enumerate(cfgs):
        cfg.nodes = [
            Peer(o.node_address, o.network_key.public, o.sign_key.public)
            for j, o in enumerate(cfgs)
            if j != i
        ]
    return cfgs


# ------------------------------------------------------- phase accounting


class TestPhaseAccounting:
    def test_counters_exact_across_threads(self):
        reg = Registry()
        ph = PhaseAccounting(reg)
        threads, per = 8, 5000

        def work():
            for _ in range(per):
                ph.add_ns("rx_decode", 1)

        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert ph.totals()["rx_decode"] == threads * per
        snap = reg.snapshot()
        assert snap["phase_rx_decode_ns"] == threads * per
        # the histogram splays into snapshot() too (per-segment latency)
        assert snap["phase_rx_decode_count"] == threads * per

    def test_add_chains_disjoint_segments(self):
        reg = Registry()
        ph = PhaseAccounting(reg)
        t0 = ph.t()
        t1 = ph.add("echo_apply", t0)
        t2 = ph.add("ready_deliver", t1)
        assert t0 <= t1 <= t2
        totals = ph.totals()
        # chained segments: each add() closes against a FRESH timestamp,
        # so the two accounts cover disjoint time
        assert totals["echo_apply"] + totals["ready_deliver"] <= t2 - t0
        assert totals["quorum_bitmap"] == 0

    def test_vocabulary_covers_the_planes(self):
        assert set(PLANE_LEAF_PHASES) < set(PHASES)
        assert "plane_total" in PHASES
        for off_plane in ("slot_gc", "commit_tail", "verifier_flush"):
            assert off_plane in PHASES
            assert off_plane not in PLANE_LEAF_PHASES

    def test_plane_total_reentrancy_accounts_once(self):
        """A drain cycle that re-enters the plane in-context (e.g. an
        rlc_ready_or_kick fallback driving another drain) must account
        its span ONCE: the nested begin_plane returns the -1 sentinel
        and its end_plane adds nothing."""
        reg = Registry()
        ph = PhaseAccounting(reg)
        t_outer = ph.begin_plane()
        assert t_outer >= 0
        t_inner = ph.begin_plane()  # re-entrant: must not double-count
        assert t_inner == -1
        ph.end_plane(t_inner)  # no-op account
        assert ph.totals()["plane_total"] == 0
        ph.end_plane(t_outer)
        outer_total = ph.totals()["plane_total"]
        assert outer_total > 0
        # fully unwound: the next cycle accounts again, from zero depth
        t2 = ph.begin_plane()
        assert t2 >= 0
        ph.end_plane(t2)
        assert ph.totals()["plane_total"] > outer_total

    def test_plane_total_depth_is_thread_local(self):
        """Shard executor threads each carry their own re-entrancy depth
        (contextvars): one thread's open plane span must not turn
        another thread's begin_plane into the nested sentinel."""
        reg = Registry()
        ph = PhaseAccounting(reg)
        t_outer = ph.begin_plane()
        assert t_outer >= 0
        seen = []

        def shard_cycle():
            t = ph.begin_plane()
            seen.append(t)
            ph.end_plane(t)

        th = threading.Thread(target=shard_cycle)
        th.start()
        th.join()
        assert seen and seen[0] >= 0  # NOT the nested sentinel
        ph.end_plane(t_outer)

    def test_shard_view_dual_writes(self):
        """ShardPhaseView: leaf marks land in BOTH the base aggregate
        (decomposition shares stay plane-wide) and the per-shard
        counter (phase_<p>_shard<i>_ns) on the plane registry."""
        base_reg = Registry()
        ph = PhaseAccounting(base_reg)
        plane_reg = Registry()
        v0 = ph.shard_view(0, plane_reg)
        v1 = ph.shard_view(1, plane_reg)
        v0.add_ns("echo_apply", 7)
        v1.add_ns("echo_apply", 5)
        v1.add_ns("ready_deliver", 3)
        assert ph.totals()["echo_apply"] == 12  # aggregate spans shards
        snap = plane_reg.snapshot()
        assert snap["phase_echo_apply_shard0_ns"] == 7
        assert snap["phase_echo_apply_shard1_ns"] == 5
        assert snap["phase_ready_deliver_shard1_ns"] == 3
        # begin/end_plane delegate to the base accounting (plane_total
        # stays an owner-loop aggregate, never per-shard)
        t = v0.begin_plane()
        assert v1.begin_plane() == -1  # same context: depth is shared
        v0.end_plane(t)
        assert ph.totals()["plane_total"] > 0


# ------------------------------------------------------------ stack sampler


def _stack(*labels, lineno=7):
    """Synthetic root-first stack from bare frame names."""
    return [(f"/x/{name}.py", name, lineno) for name in labels]


class TestStackSampler:
    def test_start_stop_restart_hygiene(self):
        s = StackSampler(hz=500.0)
        assert not s.running
        assert s.start() is True
        assert s.start() is False  # already running: no-op
        assert s.running
        s.stop()
        s.stop()  # idempotent
        assert not s.running
        assert s.start() is True  # restartable
        s.stop()

    def test_duration_self_stop(self):
        s = StackSampler(hz=500.0)
        assert s.start(duration=0.05) is True
        deadline = 5.0
        while s.running and deadline > 0:
            import time

            time.sleep(0.02)
            deadline -= 0.02
        assert not s.running
        assert s.stats()["samples"] > 0

    def test_sampling_captures_live_threads(self):
        s = StackSampler(hz=500.0)
        stop = threading.Event()

        def spin_target_fn():
            while not stop.is_set():
                sum(range(100))

        t = threading.Thread(target=spin_target_fn, daemon=True)
        t.start()
        try:
            s.start()
            import time

            time.sleep(0.3)
            s.stop()
        finally:
            stop.set()
            t.join()
        assert s.stats()["samples"] > 0
        assert "spin_target_fn" in s.folded()

    def test_bounded_tree_collapses_to_truncated(self):
        s = StackSampler(max_nodes=20)
        s.ingest([_stack(f"fn{i}") for i in range(100)])
        st = s.stats()
        # root + 19 distinct leaves + the (truncated) child
        assert st["nodes"] <= 21
        assert st["truncated_paths"] > 0
        assert "(truncated)" in s.folded()
        # reset() reclaims the budget
        s.reset()
        assert s.stats() == {
            "running": False, "samples": 0, "nodes": 1,
            "truncated_paths": 0, "hz": 97.0, "duration": None,
        }

    def test_folded_deterministic_across_insertion_order(self):
        stacks = [
            _stack("main", "worker", "decode"),
            _stack("main", "worker", "verify"),
            _stack("main", "gc"),
            _stack("main", "worker", "verify"),
        ]
        a, b = StackSampler(), StackSampler()
        for st in stacks:
            a.ingest([st])
        for st in reversed(stacks):
            b.ingest([st])
        assert a.folded() == b.folded()
        folded = a.folded()
        # leaf frames carry file:func:line, interior frames don't
        assert "main.py:main;worker.py:worker;verify.py:verify:7 2" in folded
        assert folded.splitlines()[0].endswith(" 2")  # count-descending
        # tree view is deterministic too and roots at the shared frame
        assert a.tree() == b.tree()
        assert a.tree()["children"][0]["name"] == "main.py:main"

    def test_folded_limit_and_validation(self):
        s = StackSampler()
        s.ingest([_stack("a"), _stack("b")])
        assert len(s.folded(limit=1).splitlines()) == 1
        with pytest.raises(ValueError):
            StackSampler(hz=0)
        with pytest.raises(ValueError):
            StackSampler(max_nodes=0)


# ------------------------------------------------------------- lag probe


class TestEventLoopLagProbe:
    def test_probe_once_exact_zero_under_sim_clock(self):
        loop = SimScheduler()
        try:
            clock = SimClock(loop)
            reg = Registry()
            probe = EventLoopLagProbe(reg, clock, interval=0.05)
            lag = loop.run_until_complete(probe.probe_once())
            # virtual sleeps are exact: zero overshoot, and the probe
            # never parks a standing timer that would blunt the
            # scheduler's deadlock detection
            assert lag == 0.0
            snap = reg.snapshot()
            assert snap["event_loop_lag_count"] == 1
            assert snap["event_loop_lag_p99_ms"] == 0.0
        finally:
            loop.close()

    async def test_standing_loop_measures_real_lag(self):
        from at2_node_tpu_torch.clock import SYSTEM_CLOCK

        reg = Registry()
        probe = EventLoopLagProbe(reg, SYSTEM_CLOCK, interval=0.01)
        probe.start()
        await asyncio.sleep(0.08)
        await probe.stop()
        await probe.stop()  # idempotent
        count = reg.snapshot()["event_loop_lag_count"]
        assert count >= 1
        # stopped: no further observations accrue
        await asyncio.sleep(0.03)
        assert reg.snapshot()["event_loop_lag_count"] == count

    def test_interval_validation(self):
        with pytest.raises(ValueError):
            EventLoopLagProbe(Registry(), None, interval=0.0)


# ------------------------------------------------------------------- e2e


async def _get(addr, path):
    host, _, port = addr.rpartition(":")
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        writer.write(
            f"GET {path} HTTP/1.1\r\nHost: n\r\nConnection: close\r\n\r\n"
            .encode()
        )
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    status = int(head.split(b"\r\n", 1)[0].split(b" ")[1])
    ctype = ""
    for ln in head.split(b"\r\n")[1:]:
        if ln.lower().startswith(b"content-type:"):
            ctype = ln.split(b":", 1)[1].strip().decode()
    return status, ctype, body


class _Node:
    def __init__(self, **overrides):
        self.config = make_configs(1, **overrides)[0]

    async def __aenter__(self):
        self.service = await Service.start(self.config)
        return self

    async def __aexit__(self, *exc):
        await self.service.close()


class TestProfilezEndpoint:
    async def test_capture_cycle_through_real_mux(self):
        async with _Node() as node:
            addr = node.config.rpc_address

            # idle dump: JSON shape with build + phases + empty capture
            status, ctype, body = await _get(addr, "/profilez")
            assert status == 200 and ctype.startswith("application/json")
            doc = json.loads(body)
            assert set(doc) >= {
                "node", "build", "sampler", "phases", "folded", "tree",
            }
            assert set(doc["phases"]) == set(PHASES)
            assert doc["build"]["python"] == build_info()["python"]

            # start a long capture, confirm running, then stop it
            status, _, body = await _get(addr, "/profilez?start&duration=30")
            assert status == 200
            started = json.loads(body)
            assert started["started"] is True and started["running"]
            assert node.service.sampler.running
            # second start while running is a no-op
            _, _, body = await _get(addr, "/profilez?start")
            assert json.loads(body)["started"] is False
            await asyncio.sleep(0.05)
            status, _, body = await _get(addr, "/profilez?stop")
            assert status == 200
            stopped = json.loads(body)
            assert not stopped["running"] and stopped["samples"] > 0

            # folded text view of the finished capture
            status, ctype, body = await _get(addr, "/profilez?fmt=folded")
            assert status == 200 and ctype.startswith("text/plain")
            assert b" " in body  # "stack count" lines

    async def test_kill_switch_404s(self):
        async with _Node(
            observability=ObservabilityConfig(profilez=False)
        ) as node:
            status, _, body = await _get(
                node.config.rpc_address, "/profilez"
            )
            assert status == 404 and body == b"not found"

    async def test_statusz_build_block(self):
        async with _Node() as node:
            status, _, body = await _get(node.config.rpc_address, "/statusz")
            assert status == 200
            build = json.loads(body)["build"]
            assert build["python"] == build_info()["python"]
            assert len(build["config_hash"]) == 12
            assert build["uptime_s"] >= 0.0
            # the lag probe is live on a served node: its histogram
            # splays into stats once the first interval elapses
            await asyncio.sleep(0.15)
            _, _, body = await _get(node.config.rpc_address, "/statusz")
            stats = json.loads(body)["stats"]
            assert stats.get("event_loop_lag_count", 0) >= 1


# ------------------------------------------------ differential vs the reference


@pytest.mark.parametrize("seed", [2, 22])
def test_phase_decomposition_and_folded_profile_equal_the_reference(seed):
    """The same seeded phase marks (leaf phases, plane spans, two shard
    views) and the same synthetic stacks through the reference's
    PhaseAccounting and StackSampler and the port's: equal phase totals,
    registry snapshots and exposition (every phase counter and segment
    histogram), and byte-identical folded profiles and trees."""
    import numpy as np

    from at2_node_tpu import obs as ref_obs

    def drive(obs_pkg):
        rng = np.random.default_rng(seed)
        reg, plane_reg = obs_pkg.Registry(), obs_pkg.Registry()
        ph = obs_pkg.PhaseAccounting(reg)
        views = [ph.shard_view(i, plane_reg) for i in range(2)]
        for _ in range(300):
            phase = obs_pkg.PHASES[int(rng.integers(len(obs_pkg.PHASES)))]
            ns = int(rng.integers(1, 10_000_000))
            if phase in obs_pkg.PLANE_LEAF_PHASES and rng.random() < 0.5:
                views[int(rng.integers(2))].add_ns(phase, ns)
            else:
                ph.add_ns(phase, ns)
        sampler = obs_pkg.StackSampler(max_nodes=64)
        names = ["main", "worker", "decode", "verify", "gc", "flush", "drain", "wait"]
        for _ in range(200):
            depth = int(rng.integers(1, 6))
            sampler.ingest([_stack(*(names[int(i)] for i in rng.integers(len(names), size=depth)),
                                   lineno=int(rng.integers(1, 40)))])
        return (ph.totals(), reg.snapshot(), reg.render_prometheus(), plane_reg.snapshot(),
                sampler.folded(), sampler.tree(), sampler.stats())

    from at2_node_tpu_torch import obs as port_obs

    port, ref = drive(port_obs), drive(ref_obs)
    assert port[0]["plane_total"] >= 0 and "(truncated)" in port[4]
    assert port == ref

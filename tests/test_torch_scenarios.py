"""The port's scenario grid, WAN cells and overload A/B against the JAX
package's.

* Port against reference, in one process: the smoke grid of the
  reference's ``scripts/ci.sh`` (seed 7, 24 transfers, 8 s) and its two WAN
  replays give the same grid and trace hashes, p99 and SLO verdicts; the
  overload A/B at the gate's settings the same ``ab_hash`` and arms; an
  all-defaults ``[overload]`` table leaves the wire trace as it is.
* ``ModeledVerifier``: FIFO service, ``n / sigs_per_sec`` of virtual time a
  call, the queue depth and queue-wait surfaces the overload controller
  samples, real verdicts from the wrapped verifier.
* Copies on the port's modules of the reference's ``tests/test_wan.py`` and
  of the sim part of ``tests/test_overload.py`` (a shed charges nothing).
"""

from __future__ import annotations

import asyncio
import json

import grpc
import pytest

from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.node.config import Config, OverloadConfig, WanConfig
from at2_node_tpu_torch.node.overload import parse_retry_after_ms
from at2_node_tpu_torch.sim.net import SimNet, SimRpcError
from at2_node_tpu_torch.sim.scenarios import (
    SMOKE,
    ModeledVerifier,
    _seed_int,
    run_cell,
    run_grid,
    run_overload_ab,
)
from at2_node_tpu_torch.sim.scheduler import SimClock, SimScheduler
from at2_node_tpu_torch.tools._common import make_net_configs, port_counter
from at2_node_tpu_torch.tools.trace_collect import phase_overlap

# the CLI's cell size (tools/scenario_grid.py defaults) at the gate's cut
GRID_KW = dict(nodes=4, f=1, n_clients=6, n_tx=24, duration=8.0)


def _configs(n: int):
    return make_net_configs(n, port_counter(29700), seed=n)


def _strip(doc: dict) -> str:
    """A cell or grid as canonical JSON without its wall-clock fields."""

    def drop(x):
        if isinstance(x, dict):
            return {k: drop(v) for k, v in x.items() if k != "wall_seconds"}
        if isinstance(x, list):
            return [drop(v) for v in x]
        return x

    return json.dumps(drop(doc), sort_keys=True)


# -- port against reference ------------------------------------------------


class TestParity:
    def test_smoke_grid_equals_reference(self):
        from at2_node_tpu.sim.scenarios import SMOKE as REF_SMOKE
        from at2_node_tpu.sim.scenarios import run_grid as ref_run_grid

        assert SMOKE == REF_SMOKE
        mine = run_grid(7, SMOKE, **GRID_KW)
        ref = ref_run_grid(7, REF_SMOKE, **GRID_KW)
        assert mine["breaching"] == ref["breaching"] == []
        assert mine["grid_hash"] == ref["grid_hash"]
        assert _strip(mine) == _strip(ref)

    @pytest.mark.parametrize("faults", ["none", "cut"])
    def test_wan_replay_equals_reference(self, faults):
        from at2_node_tpu.sim.scenarios import run_cell as ref_run_cell

        seed = _seed_int("grid", 7, "wan3", "steady", faults, "wan") % (1 << 32)
        kw = {k: v for k, v in GRID_KW.items()}
        mine = run_cell(seed, "wan3", "steady", faults, wan=True, **kw)
        ref = ref_run_cell(seed, "wan3", "steady", faults, wan=True, **kw)
        assert mine["trace_hash"] == ref["trace_hash"]
        assert mine["latency_p99_ms"] == ref["latency_p99_ms"]
        assert mine["committed"] == mine["offered"]
        assert not mine["violations"] and mine["slo"]["ok"]
        assert _strip(mine) == _strip(ref)
        if faults == "none":
            assert mine["latency_p99_ms"] < 1000.0  # sub-second WAN finality

    def test_overload_ab_equals_reference(self):
        from at2_node_tpu.sim.scenarios import run_overload_ab as ref_run_overload_ab

        kw = dict(workloads=("flash_crowd",), n_clients=60, crowd=40, n_tx=80)
        mine = run_overload_ab(5, **kw)
        ref = ref_run_overload_ab(5, **kw)
        assert mine["ok"] and ref["ok"]
        assert mine["ab_hash"] == ref["ab_hash"]
        assert _strip(mine) == _strip(ref)
        arms = {c["arm"]: c for c in mine["cells"]}
        assert not arms["uncontrolled"]["slo_ok"]
        assert arms["controlled"]["slo_ok"] and arms["controlled"]["fairness_ok"]

    def test_overload_off_table_is_wire_invisible(self):
        kw = dict(n_tx=24, duration=8.0)
        plain = run_cell(7, "lan", "steady", "none", **kw)
        tabled = run_cell(7, "lan", "steady", "none", overload=OverloadConfig(), **kw)
        assert plain["trace_hash"] == tabled["trace_hash"]


# -- ModeledVerifier --------------------------------------------------------


class _Inner:
    def __init__(self):
        self.calls = []

    async def verify_many(self, items):
        self.calls.append(list(items))
        return [i % 3 != 0 for i in items]

    def stats(self):
        return {"inner": 1}

    def warmup(self):
        return "warm"


class TestModeledVerifier:
    def test_fifo_service_charges_virtual_time(self):
        loop = SimScheduler()
        asyncio.set_event_loop(loop)
        try:
            clock = SimClock(loop)
            inner = _Inner()
            mv = ModeledVerifier(inner, clock, sigs_per_sec=100.0)
            done = []

            async def call(tag, n):
                got = await mv.verify_many(list(range(n)))
                done.append((tag, round(clock.monotonic() - t0, 6), got))

            t0 = clock.monotonic()
            depths = []

            async def main():
                tasks = [asyncio.ensure_future(call(t, n)) for t, n in (("a", 50), ("b", 20), ("c", 30))]
                await asyncio.sleep(0)
                depths.append(mv.stats()["queue_depth"])
                await asyncio.gather(*tasks)

            loop.run_until_complete(main())
            # one server, FIFO: 0.5 s, then 0.2 s, then 0.3 s of service
            assert [(t, s) for t, s, _ in done] == [("a", 0.5), ("b", 0.7), ("c", 1.0)]
            assert depths == [100]
            # verdicts are the wrapped verifier's, in call order
            assert [len(c) for c in inner.calls] == [50, 20, 30]
            assert done[1][2] == [i % 3 != 0 for i in range(20)]
            st = mv.stats()
            assert st["queue_depth"] == 0 and st["inner"] == 1
            assert st["modeled_sigs_per_sec"] == 100.0 and st["modeled_total_sigs"] == 100
            qw = mv.stage_histograms()["queue_wait"]
            # b waited 0.5 s, c 0.7 s, a not at all
            assert qw == {"count": 3, "sum_ms": 1200.0}
            assert mv.warmup() == "warm"  # everything else delegates
        finally:
            loop.close()
            asyncio.set_event_loop(None)

    def test_equals_reference(self):
        from at2_node_tpu.sim.scenarios import ModeledVerifier as RefModeledVerifier
        from at2_node_tpu.sim.scheduler import SimClock as RefSimClock
        from at2_node_tpu.sim.scheduler import SimScheduler as RefSimScheduler

        def drive(mv_cls, loop_cls, clock_cls):
            loop = loop_cls()
            asyncio.set_event_loop(loop)
            try:
                clock = clock_cls(loop)
                mv = mv_cls(_Inner(), clock, sigs_per_sec=37.0)
                log = []

                async def call(n, delay):
                    await asyncio.sleep(delay)
                    got = await mv.verify_many(list(range(n)))
                    log.append((n, round(clock.monotonic(), 9), got, mv.stats()["queue_depth"]))

                async def main():
                    await asyncio.gather(*(call(n, d) for n, d in ((5, 0.0), (64, 0.01), (1, 0.02), (33, 2.5))))

                loop.run_until_complete(main())
                return log, mv.stats(), mv.stage_histograms()
            finally:
                loop.close()
                asyncio.set_event_loop(None)

        assert drive(ModeledVerifier, SimScheduler, SimClock) == drive(
            RefModeledVerifier, RefSimScheduler, RefSimClock
        )


# -- tests/test_wan.py -------------------------------------------------------


# small wan3 cell: 3 nodes over the 3-region latency matrix, enough
# traffic for batched and per-tx paths both to fire, fast enough for
# the fast tier
_CELL = dict(
    nodes=3, n_clients=3, n_tx=8, duration=3.0, settle_horizon=60.0,
)


def _cell(*, wan: bool, shards: int = 1, seed: int = 21) -> dict:
    return run_cell(
        seed, "wan3", "steady", "none",
        wan=wan, plane_shards=shards, **_CELL,
    )


class TestWanConfig:
    def test_toml_roundtrip(self):
        import dataclasses

        cfg = _configs(2)[0]
        cfg.wan = WanConfig(
            overlap_ready=True, region_fanout=True, region="eu-west",
            verify_ahead=True, eager_broker=True,
        )
        cfg.nodes[0] = dataclasses.replace(cfg.nodes[0], region="us-east")
        text = cfg.dumps()
        assert "[wan]" in text
        loaded = Config.loads(text)
        assert loaded.wan == cfg.wan
        assert loaded.nodes[0].region == "us-east"

    def test_default_omitted_from_toml(self):
        cfg = _configs(1)[0]
        assert "[wan]" not in cfg.dumps()

    def test_region_validated(self):
        with pytest.raises(ValueError):
            WanConfig(region=3)  # type: ignore[arg-type]


class TestWanDeterminism:
    def test_off_is_the_default_schedule(self):
        # wan=False must not merely be self-consistent: it must be THE
        # default schedule, indistinguishable from a node that never
        # heard of the [wan] table
        base = _cell(wan=False)
        again = _cell(wan=False)
        assert base["trace_hash"] == again["trace_hash"]
        assert base["committed"] == base["offered"]
        assert not base["violations"]

    def test_on_deterministic_shards1(self):
        one = _cell(wan=True)
        two = _cell(wan=True)
        assert one["trace_hash"] == two["trace_hash"]
        assert one["committed"] == one["offered"]
        assert not one["violations"]
        assert one["slo"]["ok"]

    def test_on_deterministic_shards4(self):
        one = _cell(wan=True, shards=4)
        two = _cell(wan=True, shards=4)
        assert one["trace_hash"] == two["trace_hash"]
        assert one["committed"] == one["offered"]
        assert not one["violations"]

    def test_off_deterministic_shards4(self):
        one = _cell(wan=False, shards=4)
        two = _cell(wan=False, shards=4)
        assert one["trace_hash"] == two["trace_hash"]
        assert one["committed"] == one["offered"]

    def test_knobs_change_the_schedule(self):
        # region fanout reorders sends and overlap adds frames: the ON
        # trace must differ from OFF (this is exactly why the knobs
        # default off — hash compatibility is a property of the default
        # path, not of the feature)
        assert (
            _cell(wan=False)["trace_hash"] != _cell(wan=True)["trace_hash"]
        )


class TestPhaseOverlap:
    def test_overlap_piggybacks_ready(self):
        cell = run_cell(
            21, "wan3", "steady", "none",
            wan=True, capture_trace=True, **_CELL,
        )
        report = phase_overlap(cell["stitched"])
        assert report["piggybacked"] > 0
        assert report["gap_min_ms"] < 0.0

    def test_serial_path_never_negative(self):
        cell = run_cell(
            21, "wan3", "steady", "none",
            wan=False, capture_trace=True, **_CELL,
        )
        report = phase_overlap(cell["stitched"])
        assert report["spans"] > 0
        assert report["piggybacked"] == 0
        assert report["gap_min_ms"] >= 0.0

    def test_wan_cell_latency_beats_serial(self):
        # the levers must MEASURABLY move commit latency on the WAN
        # topology, not just reorder frames
        off = _cell(wan=False)
        on = _cell(wan=True)
        assert on["latency_p99_ms"] < off["latency_p99_ms"]


# -- tests/test_overload.py: the sim ---------------------------------------


def _cfg(**kw) -> OverloadConfig:
    """Enabled config with a small, test-legible ladder: ramp over
    [0.5, 0.9], instant EWMA, zero-rate-limit sampling."""
    base = dict(
        enabled=True,
        sample_interval=1e-9,
        smoothing=1.0,
        queue_target=10,
        sojourn_target_ms=100.0,
        sojourn_arm_s=1.0,
        shed_start=0.5,
        shed_full=0.9,
        registered_grace=0.2,
        retry_after_ms=100,
        retry_after_max_ms=1000,
    )
    base.update(kw)
    return OverloadConfig(**base)


class TestShedChargesNothing:
    """Sim-backed: a shed aborts RESOURCE_EXHAUSTED with a parseable
    hint, counts in overload_stats, and never charges the sender's
    [admission] fail bucket — refusing valid work under pressure is the
    node's state, not evidence against the sender."""

    def test_shed_typed_and_fail_bucket_untouched(self):
        net = SimNet(
            2,
            0,
            seed=5,
            overload=_cfg(sample_interval=1000.0),
        )
        try:
            net.start()
            svc = net.services[0]
            ov = svc.overload
            # force saturation and freeze the sampler (the huge
            # sample_interval keeps maybe_sample from overwriting it)
            ov.pressure = 2.0
            ov._signals = {"occupancy": 2.0}
            ov.draining = False
            ov._last_sample = net.clock.monotonic()
            kp = SignKeyPair.random()
            err = net.submit(0, kp, 1, b"r" * 32, 1)
            assert isinstance(err, SimRpcError)
            assert err.code == grpc.StatusCode.RESOURCE_EXHAUSTED
            hint = parse_retry_after_ms(err.details)
            assert hint is not None and hint >= ov.cfg.retry_after_ms
            assert svc.overload_stats["overload_shed_requests"] == 1
            assert svc.overload_stats["overload_shed_entries"] == 1
            # the shed aborted BEFORE admission: no bucket was created,
            # no signature rejection was recorded
            assert svc._admission_buckets == {}
            snap = svc.snapshot_stats()
            assert snap["rejected_at_ingress"] == 0
            assert snap["admission_throttled"] == 0
            # pressure drains: the very same sender is admitted — a shed
            # left no throttling state behind
            ov.pressure = 0.0
            ov._signals = {}
            assert net.submit(0, kp, 1, b"r" * 32, 1) is None
        finally:
            net.close()

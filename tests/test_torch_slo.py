"""SLO burn-rate engine unit tests (obs/slo.py): window edges, empty
snapshots, flap suppression via the multi-window AND, idle guards, and
the offline single-point evaluation the scenario grid banks."""

import numpy as np
import pytest

from at2_node_tpu_torch.obs.slo import (
    BURN_CAP,
    Objective,
    SloEngine,
    default_objectives,
    evaluate_point,
)


def _lat(pairs, count):
    """Histogram.buckets() shape: (cumulative (le, cum) pairs incl +Inf,
    sum_seconds, count)."""
    return (pairs, 0.0, count)


def _sample(t, committed=0, rejected=0, pending=0, stalled=False,
            latency=None):
    return {
        "t": t,
        "committed": committed,
        "rejected": rejected,
        "pending": pending,
        "stalled": stalled,
        "latency": latency,
    }


class TestObjective:
    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError):
            Objective("x", "latency_p42", 1.0)

    def test_nonpositive_target_rejected(self):
        with pytest.raises(ValueError):
            Objective("x", "latency_p99", 0.0)

    def test_default_objectives_disable_on_nonpositive(self):
        kinds = {o.kind for o in default_objectives()}
        # the throughput floor defaults OFF (0.0): an idle node has no
        # committed rate to hold
        assert kinds == {"latency_p99", "rejection_ratio", "stall_budget"}
        kinds = {o.kind for o in default_objectives(latency_p99_ms=0.0)}
        assert "latency_p99" not in kinds
        kinds = {o.kind for o in default_objectives(throughput_floor_tps=2.0)}
        assert "throughput_floor" in kinds


class TestEngineWindows:
    def test_bad_windows_rejected(self):
        with pytest.raises(ValueError):
            SloEngine([], windows=(0.0, 30.0))
        with pytest.raises(ValueError):
            SloEngine([], windows=())

    def test_empty_engine_reports_no_data_and_never_breaches(self):
        e = SloEngine(default_objectives(), windows=(30.0, 300.0))
        ev = e.evaluate(now=1000.0)
        assert ev["samples"] == 0 and ev["breaching"] == []
        assert {o["status"] for o in ev["objectives"]} == {"no_data"}
        # one sample is still not a window: deltas need two endpoints
        e.observe(_sample(999.0))
        assert {o["status"] for o in e.evaluate(now=1000.0)["objectives"]} \
            == {"no_data"}

    def test_window_edge_is_inclusive(self):
        obj = [Objective("lat", "latency_p99", 150.0)]
        e = SloEngine(obj, windows=(30.0, 300.0))
        empty = _lat([(0.05, 0), (0.1, 0), (float("inf"), 0)], 0)
        ten = _lat([(0.05, 0), (0.1, 10), (float("inf"), 10)], 10)
        # old sample sits EXACTLY on the fast-window cutoff (100 - 30):
        # it must count, so the fast window has a valid delta
        e.observe(_sample(70.0, latency=empty))
        e.observe(_sample(100.0, committed=10, latency=ten))
        (o,) = e.evaluate(now=100.0)["objectives"]
        fast, slow = o["windows"]
        assert fast["status"] == "ok"
        # all 10 completions landed in the 0.1s bucket: windowed p99 is
        # that bucket's upper bound, in ms
        assert fast["value"] == 100.0
        assert fast["burn"] == round(100.0 / 150.0, 6)
        assert slow["status"] == "ok"
        assert o["status"] == "ok"

    def test_sample_just_outside_window_reports_no_data(self):
        obj = [Objective("lat", "latency_p99", 150.0)]
        e = SloEngine(obj, windows=(30.0, 300.0))
        e.observe(_sample(69.9, latency=_lat([(float("inf"), 0)], 0)))
        e.observe(
            _sample(100.0, latency=_lat([(0.1, 5), (float("inf"), 5)], 5))
        )
        (o,) = e.evaluate(now=100.0)["objectives"]
        fast, slow = o["windows"]
        assert fast["status"] == "no_data"  # one sample inside the window
        assert slow["status"] == "ok"
        # any-window no_data dominates: a half-blind verdict is not ok
        assert o["status"] == "no_data"
        assert e.evaluate(now=100.0)["breaching"] == []

    def test_empty_histogram_snapshots_read_idle(self):
        obj = [Objective("lat", "latency_p99", 150.0)]
        e = SloEngine(obj, windows=(30.0, 300.0))
        # latency=None (tracer off) and zero-count buckets both mean "no
        # completions this window" — idle, never breaching
        e.observe(_sample(70.0))
        e.observe(_sample(100.0))
        (o,) = e.evaluate(now=100.0)["objectives"]
        assert o["status"] == "idle"
        empty = _lat([(0.05, 0), (float("inf"), 0)], 0)
        e2 = SloEngine(obj, windows=(30.0, 300.0))
        e2.observe(_sample(70.0, latency=empty))
        e2.observe(_sample(100.0, latency=empty))
        (o2,) = e2.evaluate(now=100.0)["objectives"]
        assert o2["status"] == "idle"

    def test_overflow_bucket_p99_doubles_last_finite_bound(self):
        obj = [Objective("lat", "latency_p99", 150.0)]
        e = SloEngine(obj, windows=(30.0, 300.0))
        e.observe(_sample(70.0, latency=_lat([(0.05, 0), (float("inf"), 0)], 0)))
        e.observe(
            _sample(
                100.0,
                committed=5,
                latency=_lat([(0.05, 0), (float("inf"), 5)], 5),
            )
        )
        (o,) = e.evaluate(now=100.0)["objectives"]
        # every completion overflowed the finite buckets: report 2x the
        # last finite bound (conservative, JSON-safe)
        assert o["windows"][0]["value"] == 100.0

    def test_samples_pruned_past_slow_window(self):
        e = SloEngine([], windows=(30.0, 300.0))
        for t in range(0, 1000, 10):
            e.observe(_sample(float(t)))
        # bounded by slow window span / probe interval (+1s slack)
        assert e.sample_count <= 32


class TestFlapSuppression:
    def test_fast_spike_alone_does_not_breach(self):
        obj = [Objective("floor", "throughput_floor", 0.5)]
        e = SloEngine(obj, windows=(30.0, 300.0))
        e.observe(_sample(0.0, committed=0))
        e.observe(_sample(60.0, committed=100))
        # commits stopped with work pending: the fast window burns...
        e.observe(_sample(75.0, committed=100, pending=5))
        e.observe(_sample(99.0, committed=100, pending=5))
        (o,) = e.evaluate(now=100.0)["objectives"]
        fast, slow = o["windows"]
        assert fast["status"] == "breaching" and fast["burn"] == BURN_CAP
        # ...but the slow window still shows healthy rate: no alert
        assert slow["status"] == "ok"
        assert o["status"] == "ok"
        assert e.evaluate(now=100.0)["breaching"] == []

    def test_sustained_degradation_trips_both_windows(self):
        obj = [Objective("floor", "throughput_floor", 0.5)]
        e = SloEngine(obj, windows=(30.0, 300.0))
        for t in (0.0, 150.0, 280.0, 299.0):
            e.observe(_sample(t, committed=0, pending=5))
        ev = e.evaluate(now=300.0)
        (o,) = ev["objectives"]
        assert [w["status"] for w in o["windows"]] == [
            "breaching", "breaching",
        ]
        assert o["status"] == "breaching"
        assert ev["breaching"] == ["floor"]

    def test_idle_node_never_burns_the_floor(self):
        obj = [Objective("floor", "throughput_floor", 0.5)]
        e = SloEngine(obj, windows=(30.0, 300.0))
        e.observe(_sample(70.0))
        e.observe(_sample(100.0))
        (o,) = e.evaluate(now=100.0)["objectives"]
        assert o["status"] == "idle"


class TestRatioAndStall:
    def test_rejection_ratio_idle_under_min_events(self):
        obj = [Objective("rej", "rejection_ratio", 0.95)]
        e = SloEngine(obj, windows=(30.0, 300.0))
        e.observe(_sample(70.0))
        # 1 reject out of 1 attempt is one unlucky request, not a
        # 100%-rejection incident
        e.observe(_sample(100.0, rejected=1))
        (o,) = e.evaluate(now=100.0)["objectives"]
        assert o["status"] == "idle"

    def test_rejection_ratio_breaches_when_everything_bounces(self):
        obj = [Objective("rej", "rejection_ratio", 0.95)]
        e = SloEngine(obj, windows=(30.0, 300.0))
        e.observe(_sample(70.0))
        e.observe(_sample(100.0, rejected=20))
        (o,) = e.evaluate(now=100.0)["objectives"]
        assert o["status"] == "breaching"
        fast = o["windows"][0]
        assert fast["value"] == 1.0
        assert fast["burn"] == round(1.0 / 0.95, 6)

    def test_stall_budget_counts_flagged_samples(self):
        obj = [Objective("stall", "stall_budget", 0.5)]
        e = SloEngine(obj, windows=(30.0, 300.0))
        for t, stalled in ((72.0, True), (80.0, True), (90.0, True),
                           (99.0, False)):
            e.observe(_sample(t, stalled=stalled))
        (o,) = e.evaluate(now=100.0)["objectives"]
        assert o["status"] == "breaching"
        assert o["windows"][0]["value"] == 0.75
        assert o["windows"][0]["burn"] == 1.5


class TestEvaluatePoint:
    def test_clean_cell_reads_ok(self):
        objs = default_objectives(
            latency_p99_ms=500.0, throughput_floor_tps=0.2,
            rejection_ratio_max=0.02, stall_budget=0.25,
        )
        res = evaluate_point(
            objs,
            {
                "throughput_tps": 2.5,
                "latency_p99_ms": 120.0,
                "rejection_ratio": 0.0,
                "stall_fraction": 0.0,
            },
        )
        assert res["ok"] and res["breaching"] == []
        assert {o["status"] for o in res["objectives"]} == {"ok"}

    def test_breaches_and_burns(self):
        objs = default_objectives(
            latency_p99_ms=500.0, throughput_floor_tps=0.2,
        )
        res = evaluate_point(
            objs,
            {
                "throughput_tps": 0.0,
                "latency_p99_ms": 750.0,
                "rejection_ratio": 0.0,
                "stall_fraction": 0.0,
            },
        )
        assert not res["ok"]
        assert set(res["breaching"]) == {
            "commit_latency_p99", "throughput_floor",
        }
        by_name = {o["name"]: o for o in res["objectives"]}
        assert by_name["commit_latency_p99"]["burn"] == 1.5
        # zero rate against a floor is a capped burn, not a ZeroDivision
        assert by_name["throughput_floor"]["burn"] == BURN_CAP

    def test_missing_measure_is_no_data_not_breach(self):
        objs = default_objectives(latency_p99_ms=500.0)
        res = evaluate_point(objs, {"rejection_ratio": 0.0})
        by_kind = {o["kind"]: o for o in res["objectives"]}
        assert by_kind["latency_p99"]["status"] == "no_data"
        assert res["ok"]


class TestAgainstTheReference:
    """Differential: the same seeded probe series through the reference's
    engine and the port's, and the same measures through both
    ``evaluate_point``s: equal bodies."""

    @staticmethod
    def _series(seed, n=240):
        rng = np.random.default_rng(seed)
        les = [0.001 * 2 ** k for k in range(12)] + [float("inf")]
        counts = np.zeros(len(les), dtype=np.int64)
        committed = rejected = 0
        out = []
        for i in range(n):
            committed += int(rng.integers(0, 400))
            rejected += int(rng.integers(0, 12))
            counts += rng.multinomial(int(rng.integers(0, 300)), np.full(len(les), 1 / len(les)))
            cum = np.cumsum(counts)
            latency = ([(le, int(c)) for le, c in zip(les, cum)], float(rng.uniform(0, 50)), int(cum[-1]))
            out.append(_sample(float(i), committed, rejected, int(rng.integers(0, 50)),
                               bool(rng.random() < 0.1), latency if rng.random() < 0.9 else None))
        return out

    @pytest.mark.parametrize("seed", [4, 44])
    def test_engine_and_point_evaluation_equal_the_reference(self, seed):
        from at2_node_tpu.obs import slo as ref_slo

        objectives = dict(latency_p99_ms=20.0, throughput_floor_tps=50.0, rejection_ratio_max=0.02,
                          stall_budget=0.05)
        port = SloEngine(default_objectives(**objectives), windows=(30.0, 120.0))
        ref = ref_slo.SloEngine(ref_slo.default_objectives(**objectives), windows=(30.0, 120.0))
        seen = set()
        for i, sample in enumerate(self._series(seed)):
            port.observe(sample)
            ref.observe(sample)
            if i % 17 == 0:
                assert port.evaluate(now=sample["t"]) == ref.evaluate(now=sample["t"])
                assert port.breaching(now=sample["t"]) == ref.breaching(now=sample["t"])
                seen.update(port.breaching(now=sample["t"]))
        assert seen  # the series breaches: the verdicts compared are not all "ok"
        rng = np.random.default_rng(seed + 1)
        for _ in range(20):
            measures = {"throughput_tps": float(rng.uniform(0, 200)), "latency_p99_ms": float(rng.uniform(0, 60)),
                        "rejection_ratio": float(rng.uniform(0, 0.05))}
            if rng.random() < 0.5:
                measures["stall_fraction"] = float(rng.uniform(0, 0.1))
            assert evaluate_point(default_objectives(**objectives), measures) == ref_slo.evaluate_point(
                ref_slo.default_objectives(**objectives), measures)

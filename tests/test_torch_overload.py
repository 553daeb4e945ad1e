"""[overload] closed-loop control: the port's twin of ``tests/test_overload.py``.

Every pure case of the reference's file (token buckets under clock skew,
the ``OverloadController`` ladder, the typed ``retry_after_ms`` hints and
the client ``RetryPolicy``) runs the same clock, signal sequence or
injected rng through the reference's code and the port's, requires the
two to be equal (levels, pressures exactly: both are plain Python floats,
shed decisions, debts, hints and delays) and then the reference's
expectation on the port. ``TestShedChargesNothing`` has its twin in
``test_torch_scenarios.py``. One case runs ``chip_smoke.py``'s phase 13
(the served overload A/B) with the host verifier at a toy size, and
three hold the helpers it reads the card's run through.
"""

import asyncio
import json
import types

import grpc
import numpy as np
import pytest

import chip_smoke
from at2_node_tpu import client as ref_client
from at2_node_tpu.node import config as ref_config
from at2_node_tpu.node import overload as ref_overload
from at2_node_tpu.node import service as ref_service
from at2_node_tpu_torch import client as port_client
from at2_node_tpu_torch.node import config as port_config
from at2_node_tpu_torch.node import overload as port_overload
from at2_node_tpu_torch.node import service as port_service

PORT = types.SimpleNamespace(name="port", ov=port_overload, config=port_config,
                             Service=port_service.Service, RetryPolicy=port_client.RetryPolicy)
REF = types.SimpleNamespace(name="ref", ov=ref_overload, config=ref_config,
                            Service=ref_service.Service, RetryPolicy=ref_client.RetryPolicy)


def both(script):
    """``script(pkg)`` for the port and the reference; the two results must
    be equal; the port's is returned."""
    port, ref = script(PORT), script(REF)
    assert port == ref
    return port


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t


def _cfg(pkg, **kw):
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
    return pkg.config.OverloadConfig(**base)


def _ctl(pkg, cfg=None, depth=0, **kw):
    box = {"queue_depth": depth}
    ctl = pkg.ov.OverloadController(cfg or _cfg(pkg), FakeClock(), verifier_stats=lambda: box, **kw)
    ctl._depth_box = box  # test handle, not API
    return ctl


def _state(ctl) -> tuple:
    """Everything a controller decides from: pressure, level, signals,
    arming, drain, debts, sojourn reading and samples."""
    return (ctl.pressure, ctl.level, dict(ctl._signals), ctl.armed, ctl.draining, dict(ctl._debt),
            ctl._sojourn_ms, ctl.samples)


class TestBucketClockSkew:
    """Service._bucket_refill: the shared token-bucket primitive behind
    the [admission] fail and register buckets. limit=4 over window=4s
    (rate 1 token/s) throughout."""

    @staticmethod
    def _refill(pkg, buckets, now, limit=4.0, window=4.0):
        return list(pkg.Service._bucket_refill(buckets, "src", now, limit, window))

    def test_burst_at_window_edge_never_exceeds_limit(self):
        def script(pkg):
            b = {}
            first = self._refill(pkg, b, 0.0)
            b["src"][0] = 0.0  # fully drained by failures at t=0
            return first[0], self._refill(pkg, b, 3.0)[0], self._refill(pkg, b, 400.0)[0]

        fresh, partial, capped = both(script)
        assert fresh == 4.0  # fresh bucket starts full
        # continuous refill: 3s elapsed -> 3 tokens, not a cliff at the
        # window edge
        assert partial == pytest.approx(3.0)
        # an arbitrarily long gap caps at the limit
        assert capped == 4.0

    def test_refill_after_idle_resumes_from_the_spend(self):
        def script(pkg):
            b = {}
            self._refill(pkg, b, 0.0)
            self._refill(pkg, b, 100.0)  # long idle, pinned at the cap
            b["src"][0] = 1.0  # then a spend
            return self._refill(pkg, b, 101.5)[0]

        # refill resumes at the configured rate from the spend point
        assert both(script) == pytest.approx(2.5)

    def test_backwards_clock_neither_mints_nor_drains(self):
        def script(pkg):
            b = {}
            self._refill(pkg, b, 100.0)
            b["src"][0] = 1.0
            back = self._refill(pkg, b, 50.0)  # the clock steps back 50s
            return back, self._refill(pkg, b, 102.0)[0]

        back, later = both(script)
        # a negative delta must not drain tokens, and the stamp must hold
        assert back[0] == pytest.approx(1.0)
        assert back[1] == 100.0
        # once the clock catches up, refill credits only the time past
        # the held stamp: 2 real seconds -> 2 tokens, not 52
        assert later == pytest.approx(3.0)


class TestControllerLadder:
    def test_shed_fraction_linear_ramp(self):
        def script(pkg):
            ctl = _ctl(pkg)
            ctl._signals = {"occupancy": 2.0}
            out = []
            for p in (0.4, 0.5, 0.7, 0.9, 2.0):
                ctl.pressure = p
                out.append(ctl.shed_fraction(registered=False))
            return out

        assert both(script) == pytest.approx([0.0, 0.0, 0.5, 1.0, 1.0])

    def test_registered_grace_shifts_the_ramp(self):
        def script(pkg):
            ctl = _ctl(pkg)
            # queue past target and growing: the registered exemption is off
            ctl._signals = {"occupancy": 1.5}
            ctl.draining = False
            ctl.pressure = 0.8  # grace 0.2: registered ramp starts at 0.7
            return ctl.shed_fraction(registered=False), ctl.shed_fraction(registered=True)

        assert both(script) == pytest.approx((0.75, 0.25))

    def test_registered_exempt_unless_queue_growing_past_target(self):
        def script(pkg):
            ctl = _ctl(pkg)
            ctl.pressure = 2.0  # saturated
            out = []
            # sub-target queue, draining queue, growing past target
            for occupancy, draining in ((0.9, False), (2.0, True), (2.0, False)):
                ctl._signals = {"occupancy": occupancy}
                ctl.draining = draining
                out.append(ctl.shed_fraction(registered=True))
            ctl.draining = True
            out.append(ctl.shed_fraction(registered=False))  # the crowd never had the exemption
            return out

        assert both(script) == [0.0, 0.0, 1.0, 1.0]

    def test_debt_accumulator_is_exact_and_deterministic(self):
        # depth 6 / target 10 -> raw 0.6 every sample; smoothing 1.0 pins
        # pressure at 0.6 -> new-tier shed fraction 0.25
        def script(pkg):
            ctl = _ctl(pkg, depth=6)
            return [ctl.admit(registered=False, now=float(i)) for i in range(100)], dict(ctl._debt)

        decisions, _ = both(script)
        shed = [i for i, r in enumerate(decisions) if r is not None]
        # the long-run rate is exact up to fp rounding of the fraction,
        # and the cadence is periodic: one shed every 4 decisions
        assert len(shed) == 24
        assert {b - a for a, b in zip(shed, shed[1:])} == {4}

    def test_retry_after_scales_with_pressure_and_clamps(self):
        def script(pkg):
            ctl = _ctl(pkg)
            out = []
            for p in (0.5, 0.9, 2.0):
                ctl.pressure = p
                out.append(ctl.retry_after_ms())
            ctl.cfg.retry_after_max_ms = 500
            out.append(ctl.retry_after_ms())
            return out

        # base at the ramp start; 100 * (1 + 4 * 0.4); 100 * (1 + 4 * 1.5);
        # then clamped to the 500 cap
        assert both(script) == [100, 260, 700, 500]

    def test_registered_hint_stays_flat(self):
        def script(pkg):
            ctl = _ctl(pkg)
            ctl.pressure = 2.0
            return ctl.retry_after_ms(registered=True)

        assert both(script) == 100

    def test_broker_hint_same_ladder_shape(self):
        def script(pkg):
            cfg = _cfg(pkg)
            return [pkg.ov.broker_retry_after_ms(cfg, r) for r in (0.0, 0.5, 1.0, 5.0)]

        assert both(script) == [100, 300, 500, 500]  # the ratio clamped

    def test_disabled_controller_is_inert(self):
        def script(pkg):
            ctl = _ctl(pkg, cfg=_cfg(pkg, enabled=False), depth=1000)
            decisions = [ctl.admit(registered=False, now=float(i)) for i in range(50)]
            ctl.maybe_sample(99.0)
            return decisions, ctl.samples, ctl.pressure, ctl.overloaded

        decisions, samples, pressure, overloaded = both(script)
        assert decisions == [None] * 50
        assert (samples, pressure, overloaded) == (0, 0.0, False)

    def test_maybe_sample_rate_limit(self):
        def script(pkg):
            ctl = _ctl(pkg, cfg=_cfg(pkg, sample_interval=1.0))
            out = []
            for t in (0.0, 0.5, 1.0):
                ctl.maybe_sample(t)
                out.append(ctl.samples)
            return out

        assert both(script) == [1, 1, 2]

    def test_level_transitions_fire_callback(self):
        def script(pkg):
            seen = []
            ctl = _ctl(pkg, on_transition=lambda old, new, p: seen.append((old, new, p)))
            levels = []
            for depth in (0, 4, 6, 10, 10):
                ctl._depth_box["queue_depth"] = depth
                ctl.sample(float(len(seen)))
                levels.append(pkg.ov.LEVELS[ctl.level])
            return levels, seen, ctl.overloaded

        levels, seen, overloaded = both(script)
        assert levels == ["normal", "elevated", "shedding", "saturated", "saturated"]
        assert [(old, new) for old, new, _ in seen] == [
            ("normal", "elevated"),
            ("elevated", "shedding"),
            ("shedding", "saturated"),
        ]
        assert overloaded  # level >= shedding

    def test_fast_attack_slow_release(self):
        def script(pkg):
            ctl = _ctl(pkg, cfg=_cfg(pkg, smoothing=0.5), depth=20)  # occupancy 2.0
            out = []
            ctl.sample(0.0)
            out.append(ctl.pressure)
            ctl.sample(1.0)
            out.append(ctl.pressure)
            ctl._depth_box["queue_depth"] = 0  # load vanishes
            ctl.sample(2.0)
            return out + [ctl.pressure, ctl.draining]

        attack, again, release, draining = both(script)
        assert attack == pytest.approx(1.0)  # attack at full alpha
        assert again == pytest.approx(1.5)
        # release runs at a quarter of the attack rate
        assert release == pytest.approx(1.5 * (1 - 0.5 * 0.25))
        assert draining

    def test_codel_arming_and_empty_queue_disarm(self):
        def script(pkg):
            hist = {"count": 0.0, "sum_ms": 0.0}
            depth = {"queue_depth": 5}
            ctl = pkg.ov.OverloadController(
                _cfg(pkg), FakeClock(), verifier_stats=lambda: depth,
                stage_hists=lambda: {"queue_wait": dict(hist)})
            out = []
            ctl.sample(0.0)  # primes the histogram snapshot
            out.append((ctl.armed, ctl._signals["sojourn"]))
            # sustained 500ms sojourn (target 100): over, not yet armed
            hist.update(count=10.0, sum_ms=5000.0)
            ctl.sample(0.5)
            out.append((ctl.armed, ctl._signals["sojourn"]))
            # still over after sojourn_arm_s of continuous breach: armed
            hist.update(count=20.0, sum_ms=10000.0)
            ctl.sample(1.6)
            out.append((ctl.armed, ctl._signals["sojourn"]))
            # queue drained, no completions: the stale reading disarms
            depth["queue_depth"] = 0
            ctl.sample(2.0)
            out.append((ctl.armed, ctl._signals["sojourn"]))
            return out

        assert both(script) == [(False, 0.0), (False, 0.0), (True, 2.0), (False, 0.0)]

    def test_standing_queue_keeps_last_reading(self):
        def script(pkg):
            hist = {"count": 10.0, "sum_ms": 5000.0}
            depth = {"queue_depth": 5}
            ctl = pkg.ov.OverloadController(
                _cfg(pkg, sojourn_arm_s=0.0), FakeClock(), verifier_stats=lambda: depth,
                stage_hists=lambda: {"queue_wait": dict(hist)})
            ctl.sample(0.0)
            hist.update(count=20.0, sum_ms=10000.0)
            ctl.sample(1.0)
            armed = ctl.armed
            # no completions but work still queued: the armed reading holds
            ctl.sample(2.0)
            return armed, ctl.armed, ctl._signals["sojourn"]

        assert both(script) == (True, True, 2.0)

    @pytest.mark.parametrize("seed", [1, 2, 3])
    def test_seeded_signal_streams_give_equal_decisions(self, seed):
        """A seeded stream of every signal (queue depth, queue-wait
        histogram, backlog, tail age, burns) sampled at irregular times,
        with admissions of both classes between samples, at the
        reference's defaults: every state, decision, hint, transition
        and snapshot equal."""

        def script(pkg):
            rng = np.random.default_rng(seed)
            sig = {"depth": 0, "count": 0.0, "sum_ms": 0.0, "backlog": 0.0, "tail": 0.0, "burn": 0.0}
            seen = []
            ctl = pkg.ov.OverloadController(
                pkg.config.OverloadConfig(enabled=True), FakeClock(),
                verifier_stats=lambda: {"queue_depth": sig["depth"]},
                stage_hists=lambda: {"queue_wait": {"count": sig["count"], "sum_ms": sig["sum_ms"]}},
                backlog=lambda: sig["backlog"], tail_age=lambda: sig["tail"],
                burns=lambda: {"commit_latency_p99": sig["burn"]},
                on_transition=lambda old, new, p: seen.append((old, new, p)))
            out, t = [], 0.0
            for _ in range(400):
                t += float(rng.uniform(0.0, 0.6))
                sig["depth"] = int(rng.integers(0, 9000))
                done = float(rng.integers(0, 40))
                sig["count"] += done
                sig["sum_ms"] += done * float(rng.uniform(0.0, 600.0))
                sig["backlog"] = float(rng.uniform(0.0, 2500.0))
                sig["tail"] = float(rng.uniform(0.0, 12.0))
                sig["burn"] = float(rng.uniform(0.0, 2.5))
                decisions = [ctl.admit(registered=bool(r), now=t + 1e-3 * k)
                             for k, r in enumerate(rng.integers(0, 2, size=int(rng.integers(1, 6))))]
                out.append((_state(ctl), decisions, ctl.retry_after_ms(), ctl.snapshot(), ctl.overloaded))
            return out, seen

        out, seen = both(script)
        assert any(d is not None for _, ds, _, _, _ in out for d in ds)  # the stream sheds
        assert seen  # and the ladder moved


class TestTypedHints:
    def test_format_parse_round_trip(self):
        def script(pkg):
            details = pkg.ov.format_shed_details("ingress shed under overload", 260)
            return details, pkg.ov.parse_retry_after_ms(details)

        details, hint = both(script)
        assert details.endswith("retry_after_ms=260")
        assert hint == 260

    def test_parse_tolerates_hintless_details(self):
        def script(pkg):
            return [pkg.ov.parse_retry_after_ms(d) for d in (None, "", "too many invalid signatures")]

        assert both(script) == [None, None, None]


class TestRetryPolicy:
    def test_delay_math_with_injected_rng(self):
        def script(pkg):
            p = pkg.RetryPolicy(budget=4, base_ms=100.0, max_ms=5000.0, multiplier=2.0, jitter=0.5,
                                rng=lambda: 0.5)
            return [p.delay_s(a) for a in (0, 2, 10)]

        # rng 0.5 makes the jitter spread exactly 1.0; the last is capped
        assert both(script) == pytest.approx([0.1, 0.4, 5.0])

    def test_server_hint_raises_the_floor(self):
        def script(pkg):
            p = pkg.RetryPolicy(jitter=0.5, rng=lambda: 0.5)
            return p.delay_s(0, hint_ms=1000), p.delay_s(6, hint_ms=1000)

        first, later = both(script)
        assert first == pytest.approx(1.0)
        # the hint is a floor, not a ceiling: a longer backoff stands
        assert later >= 1.0

    def test_jitter_spread_bounds(self):
        def script(pkg):
            lo = pkg.RetryPolicy(base_ms=100.0, jitter=0.5, rng=lambda: 0.0)
            hi = pkg.RetryPolicy(base_ms=100.0, jitter=0.5, rng=lambda: 1.0)
            return lo.delay_s(0), hi.delay_s(0)

        assert both(script) == pytest.approx((0.075, 0.125))

    @pytest.mark.parametrize("refusals", [3, 8, 9])
    def test_run_retries_then_stops_alike(self, refusals):
        """``run`` against a call refused ``refusals`` times (hints from a
        seeded stream) then answered: the same sleeps, attempts and
        outcome in both packages; a ninth refusal spends a budget of 8 and
        reaches the caller."""

        def script(pkg):
            rng = np.random.default_rng(refusals)
            hints = [int(h) for h in rng.integers(250, 5000, size=refusals)]
            jitter = iter(rng.uniform(0.0, 1.0, size=16).tolist())
            slept, calls = [], []

            async def sleep(s):
                slept.append(s)

            async def attempt():
                calls.append(len(calls))
                if len(calls) <= refusals:
                    raise grpc.aio.AioRpcError(
                        grpc.StatusCode.RESOURCE_EXHAUSTED, grpc.aio.Metadata(), grpc.aio.Metadata(),
                        details=pkg.ov.format_shed_details("ingress shed under overload",
                                                            hints[len(calls) - 1]))
                return "ok"

            policy = pkg.RetryPolicy(budget=8, rng=lambda: next(jitter), sleep=sleep)
            try:
                outcome = asyncio.run(policy.run(attempt))
            except grpc.aio.AioRpcError as exc:
                outcome = (exc.code(), exc.details())
            return slept, len(calls), outcome

        slept, calls, outcome = both(script)
        assert len(slept) == min(refusals, 8)
        assert calls == min(refusals, 8) + 1
        assert (outcome == "ok") == (refusals <= 8)

    def test_other_codes_are_not_retried(self):
        def script(pkg):
            slept = []

            async def sleep(s):
                slept.append(s)

            async def attempt():
                raise grpc.aio.AioRpcError(grpc.StatusCode.INVALID_ARGUMENT, grpc.aio.Metadata(),
                                           grpc.aio.Metadata(), details="client signature verification failed")

            try:
                asyncio.run(pkg.RetryPolicy(budget=8, sleep=sleep).run(attempt))
            except grpc.aio.AioRpcError as exc:
                return exc.code(), slept

        assert both(script) == (grpc.StatusCode.INVALID_ARGUMENT, [])


async def test_chip_smoke_phase13_runs_with_the_cpu_kind(capsys):
    """Phase 13's arms with the host verifier: 4 nodes, 4 steady and
    8 crowd clients x 16 transfers, both arms, checks 1-6 held inside
    (the crowd here is too small for the controller to shed, so the
    strict checks 6 and 7 hold here too), and
    every steady transfer carries a commit stamp on every node."""
    out = await chip_smoke.overload_path(9, None, None, "cpu", kind="cpu", n_steady=4, n_crowd=8,
                                         crowd_per=16, chunk=8, tail_s=2.0)
    text = capsys.readouterr().out
    for arm in ("overload_off", "overload_on"):
        a = out[arm]
        assert a["crowd_committed"] + a["crowd_refused"] == 8 * 16
        assert a["steady_committed"] > 0 and len(a["nodes"]) == 4
        assert a["steady_partly_stamped"] == 0 and a["steady_stamped_on"] == {4: a["steady_committed"]}
        # a miss names what the polls saw: a 503 for an SLO breach or an
        # unanswered poll, beside the slowest answer (a stalled host)
        assert a["strict_check6_held"], [(p["healthz_not_ok"], p["healthz_slowest_answer_s"]) for p in a["nodes"]]
        assert a["trace"]["k1_events"] == 0  # the host verifier launches no kernel
    # a miss names the signal that held a node above level 0 (on a
    # starved host: burn, the SLO's ingress-to-commit p99 over 2,000 ms)
    assert out["overload_on"]["strict_check7_held"], [
        (p["level0_after_crowd_s"], p["dominant_signal"], p["burn_at_end"]) for p in out["overload_on"]["nodes"]]
    assert out["overload_off"]["strict_check7_held"] is None
    assert "over 0 refusals: held vacuously" in text
    assert out["overload_off"]["crowd_refused"] == 0
    assert all(p["shed_requests"] == 0 and p["peak_level"] == 0 for p in out["overload_off"]["nodes"])
    assert "4 steady clients registered" in text
    assert "Register of each key at every node answered the id it was given" in text
    assert "(printed, not gated on)" in text


class TestPhase13Readings:
    """The helpers phase 13 reads the card's run through, on made-up
    inputs: the trace's K1 count and busy union, the signals' release and
    lead, the /healthz reason, the ledgers against the replay."""

    async def test_check_replay_takes_a_client_that_committed_nothing(self):
        """A crowd sender the controller refused throughout has no transfer
        in the replay: the check holds its ledger to a fresh account's, and
        still fails a ledger the replay does not give."""
        from at2_node_tpu_torch.client import Client
        from at2_node_tpu_torch.crypto.keys import ExchangeKeyPair, SignKeyPair
        from at2_node_tpu_torch.node.config import Config, VerifierConfig
        from at2_node_tpu_torch.node.service import Service

        ports = chip_smoke.free_ports(2)
        service = await Service.start(Config(
            node_address=f"127.0.0.1:{ports[0]}", rpc_address=f"127.0.0.1:{ports[1]}",
            sign_key=SignKeyPair.random(), network_key=ExchangeKeyPair.random(),
            verifier=VerifierConfig(kind="cpu")))
        try:
            sender, idle, recipient = SignKeyPair.random(), SignKeyPair.random(), SignKeyPair.random()
            async with Client(f"http://127.0.0.1:{ports[1]}") as client:
                await client.send_asset(sender, 1, recipient.public, 3)
                deadline = asyncio.get_running_loop().time() + 30.0
                while await client.get_last_sequence(sender.public) != 1:
                    assert asyncio.get_running_loop().time() < deadline
                    await asyncio.sleep(0.05)
            net = types.SimpleNamespace(rpc_ports=[ports[1]])
            await chip_smoke.check_replay(net, [sender, idle], [[(1, recipient.public, 3)], []])
            with pytest.raises(RuntimeError, match="the replay says"):
                await chip_smoke.check_replay(net, [sender, idle],
                                              [[(1, recipient.public, 3)], [(1, recipient.public, 3)]])
        finally:
            await service.close()

    def test_trace_kernels_counts_k1_and_the_device_union(self, tmp_path):
        k1 = "ed25519_verify_kernel(unsigned char const*, int, unsigned int const*, unsigned char*)"
        events = [
            {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 0.0, "dur": 50.0},
            {"ph": "X", "cat": "kernel", "name": k1, "ts": 100.0, "dur": 400.0},
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 450.0, "dur": 100.0},
            {"ph": "X", "cat": "kernel", "name": k1, "ts": 900.0, "dur": 100.0},
            {"ph": "X", "cat": "kernel", "name": "other_kernel", "ts": 950.0, "dur": 100.0},
            {"ph": "M", "name": "process_name"},
        ]
        path = tmp_path / "t.json"
        path.write_text(json.dumps({"traceEvents": events}))
        got = chip_smoke.trace_kernels(str(path))
        assert got["k1_events"] == 2 and got["events"] == 5
        assert got["k1_ms"] == pytest.approx(0.5)
        # [100, 550] and [900, 1050]: 600 us busy of a 1,050 us window
        assert got["device_busy_ms"] == pytest.approx(0.6)
        assert got["window_ms"] == pytest.approx(1.05)

    def test_drained_after_and_dominant_signal(self):
        def block(pressure, samples, **signals):
            return {"pressure": pressure, "samples": samples, "signals": signals}

        blocks = [(1.0, block(0.2, 1, occupancy=0.2, burn=0.0)),
                  (2.0, block(1.6, 2, occupancy=1.0, burn=1.6)),
                  (3.0, block(1.7, 3, occupancy=0.5, burn=1.7)),
                  (4.0, block(1.7, 4, occupancy=0.1, burn=1.7))]
        # from t = 2: occupancy last at or over 0.375 at t = 3, under it from t = 4
        assert chip_smoke.drained_after(blocks, 2.0, 0.375) == (2.0, True)
        assert chip_smoke.drained_after(blocks[:3], 2.0, 0.375) == (float("inf"), True)
        assert chip_smoke.drained_after(blocks, 5.0, 0.375) == (float("inf"), False)
        top, led = chip_smoke.dominant_signal(blocks)
        assert top == "burn" and led == {"occupancy": 1, "burn": 3}

    def test_steady_latencies_only_from_transfers_stamped_on_every_node(self):
        class Key:
            def __init__(self, public):
                self.public = public

        keys = [Key(b"\x01" * 32), Key(b"\x02" * 32)]

        def rec(key, seq, *stamps):
            return {"sender": key.public.hex(), "seq": seq, "stages": [[s, t, 0.0] for s, t in stamps]}

        # node 0 stamps everything; node 1 misses client 1's seq 3 and has
        # client 0's seq 2 still live; node 2 stamps nothing of seq 3
        traces = [
            {"completed": [rec(keys[0], 2, ("admitted", 1.0), ("committed", 1.1)),
                           rec(keys[1], 2, ("committed", 1.3)), rec(keys[1], 3, ("committed", 2.0))], "live": []},
            {"completed": [rec(keys[1], 2, ("committed", 1.4))],
             "live": [rec(keys[0], 2, ("echoed", 1.0), ("committed", 1.2))]},
            {"completed": [rec(keys[0], 2, ("committed", 1.15)), rec(keys[1], 2, ("committed", 1.35))],
             "live": []},
        ]
        acks = [[(2, None, 1, 1.0)], [(2, None, 1, 1.0), (3, None, 1, 1.5)]]
        lats, stamped_on, short = chip_smoke.steady_latencies(traces, keys, acks)
        assert lats == pytest.approx([0.2, 0.4])  # the latest of the three nodes' stamps
        assert stamped_on == {3: 2, 1: 1}
        assert short == [(keys[1].public.hex(), 3)]

    def test_health_reason_names_what_decided_the_verdict(self):
        assert chip_smoke.health_reason({"status": "ok", "quorum_ok": True}) == "ok"
        assert chip_smoke.health_reason(
            {"status": "degraded", "slo_breach": ["commit_latency_p99"], "quorum_ok": True}
        ) == "degraded+slo:commit_latency_p99"
        assert chip_smoke.health_reason(
            {"status": "degraded", "stalled": True, "slo_breach": ["x"], "quorum_ok": False}
        ) == "degraded+stalled+slo:x+quorum_lost"
        assert chip_smoke.health_reason({}) == "None"  # no answer

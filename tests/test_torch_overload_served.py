"""Phase 14 of ``chip_smoke.py``: the reference's overload A/B bench
(``sim/scenarios.py::run_overload_ab``) on four served nodes a net.

One case runs the phase with the host verifier at a toy size (4 nodes, 12
clients, a crowd of 8, a given C_tx, 3 s schedules, both workloads); the
others hold its helpers against the reference package on made-up inputs:
the schedule and its seed derivation, the sizing and the controlled arm's
table, the offered-time latency and the fairness, the expected-transfer
rule and the replay of a node's ledger in its own commit order.
"""

import json
import random

import pytest

import chip_smoke
from at2_node_tpu.node.config import Config as RefConfig
from at2_node_tpu.sim import scenarios as ref_scenarios
from at2_node_tpu.tools.trace_collect import _pctl as ref_pctl
from at2_node_tpu_torch.ledger.account import INITIAL_BALANCE
from at2_node_tpu_torch.node.config import Config, OverloadConfig
from at2_node_tpu_torch.sim import scenarios as port_scenarios

# the keys of the reference cell's row that a served run cannot have: the
# modeled verifier's count, the virtual clock, the sim's trace hash and its
# invariant checker
SIM_ONLY = {"modeled_sigs", "virtual_time", "wall_seconds", "trace_hash", "violations"}


@pytest.fixture(scope="module")
def reference_cell_keys() -> set:
    """The keys of a reference cell's row (a toy cell of the sim, run
    outside the test's event loop) that a served run can have."""
    cell = ref_scenarios.run_overload_cell(3, "flash_crowd", controlled=True, n_clients=6, crowd=2, n_tx=8)
    return set(cell) - SIM_ONLY


async def test_chip_smoke_phase14_runs_with_the_cpu_kind(tmp_path, capsys, reference_cell_keys):
    """Four cells on the host verifier: every gate the host kind can hold
    ((a) the ledgers, (b) the uncontrolled arms shed nothing, (d) K1
    launches 0 on the host kind, (e) the senders on time) holds inside the
    phase, which raises otherwise; each row carries the reference cell's
    keys and the rows are written where asked."""
    out = await chip_smoke.overload_ab_path(9, "cpu", kind="cpu", c_tx=100.0, n_clients=12, crowd=8,
                                            duration=3.0, out_dir=str(tmp_path))
    text = capsys.readouterr().out
    rows = out["rows"]
    assert [(r["workload"], r["arm"]) for r in rows] == [
        (w, a) for w in ("flash_crowd", "hot_account") for a in ("uncontrolled", "controlled")]
    want = reference_cell_keys | {"card", "c_tx", "sigs_per_tx", "kernel_launches", "peak_level",
                                    "peak_signal", "burn_end", "level0_s"}
    for r in rows:
        assert want <= set(r), want - set(r)
        assert r["card"] == "cpu" and r["kernel_launches"] == [0, 0, 0, 0]
        assert r["offered"] == r["n_tx"] == chip_smoke.ab_n_tx(100.0, 0.9 if r["workload"] == "flash_crowd"
                                                              else 0.68, 3.0 * chip_smoke.AB_DEPTH[r["workload"]])
        assert r["expected"] + r["parked"] <= r["acked"] == r["offered"] - r["refused"]
        assert r["lateness_p99_s"] < chip_smoke.AB_LATENESS_P99_S
        assert r["committed_steady"] > 0 and r["stamped_on"].get(4, 0) > 0
    for r in rows[0::2]:  # (b) and the parked count of an arm that refused nothing
        assert r["shed"] == r["shed_events"] == r["refusals"] == r["parked"] == 0
        assert r["expected"] == r["offered"] and r["peak_level"] == 0
    for r in rows:  # when each node admitted the crowd, beside its first level-2 reading
        admitted = [p["crowd_admitted_s"] for p in r["nodes_detail"]]
        if r["workload"] == "flash_crowd":
            assert any(a is not None and 0.0 <= a[0] <= a[1] for a in admitted), admitted
        else:
            assert admitted == [None] * 4
    assert text.count("the crowd admitted from") == 8
    assert out["calibration"] is None and "C_tx 100.0 tx/s (given)" in text
    doc = json.loads((tmp_path / "overload_ab_served.json").read_text())
    assert doc["bench"] == "overload_ab_served" and len(doc["cells"]) == 4
    assert set(doc["bars"]) == {"flash_crowd", "hot_account"}
    assert text.count("the reference's bar (run_overload_ab's ok") == 2


class TestPhase14AgainstTheReference:
    """Phase 14's helpers against the reference package's code on the same
    numbers."""

    @pytest.mark.parametrize("workload,seed,n_tx", [("flash_crowd", 2026, 30000), ("flash_crowd", 9, 333),
                                                    ("hot_account", 2026, 40000), ("hot_account", 7, 441)])
    def test_schedule_is_the_reference_cells(self, workload, seed, n_tx):
        rng = random.Random(ref_scenarios._seed_int("overload", seed, workload, 120, 80, n_tx))
        fn = getattr(ref_scenarios, f"{workload}_workload")
        kw = {"crowd": 80} if workload == "flash_crowd" else {}
        want = fn(rng, nodes=4, n_clients=120, n_tx=n_tx, duration=12.0, **kw)
        assert chip_smoke.ab_schedule(seed, workload, 4, 120, 80, n_tx, 12.0) == want

    def test_steady_tiers_are_the_reference_cells(self):
        assert chip_smoke.ab_steady_ids("flash_crowd", 120, 80) == list(range(40))
        assert chip_smoke.ab_steady_ids("hot_account", 120, 80) == list(range(1, 120))

    @pytest.mark.parametrize("c_tx", [85.5, 1234.0, 2718.3])
    def test_sizing_gives_the_reference_its_capacity_back(self, monkeypatch, c_tx):
        """The reference bench sizes its modeled verifier from n_tx; the
        n_tx phase 14 sizes from C_tx must hand the reference back C_tx's
        signature rate, to the rounding of one transfer."""
        seen = {}

        def cell(seed, w, *, controlled, capacity_sigs_per_sec, n_tx, **kw):
            seen.setdefault(w, (capacity_sigs_per_sec, n_tx))
            return {"arm": "controlled" if controlled else "uncontrolled", "slo_ok": True, "fairness_ok": True,
                    "violations": [], "trace_hash": ""}

        monkeypatch.setattr(ref_scenarios, "run_overload_cell", cell)
        for w, tune in port_scenarios._OVERLOAD_WORKLOADS.items():
            n_tx = chip_smoke.ab_n_tx(c_tx, tune["capacity_frac"], 12.0)
            ref_scenarios.run_overload_ab(1, workloads=(w,), n_tx=n_tx, duration=12.0)
            cap, got_n = seen[w]
            assert got_n == n_tx
            one_tx = ref_scenarios._OVERLOAD_SIGS_PER_TX * tune["capacity_frac"] / 12.0
            assert abs(cap - ref_scenarios._OVERLOAD_SIGS_PER_TX * c_tx) <= one_tx / 2 + 1e-3

    @pytest.mark.parametrize("cap", [5.0, 2056.7, 31337.25])
    def test_table_is_the_reference_objectives_and_parses_in_both(self, cap):
        ov = port_scenarios.overload_objectives(cap)
        ref = ref_scenarios.overload_objectives(cap)
        assert vars(ov) == vars(ref)
        toml = chip_smoke.ab_table(ov, 8192)
        node = ('[addresses]\nnode = "127.0.0.1:1"\nrpc = "127.0.0.1:2"\n[keys]\n'
                f'sign = "{"11" * 32}"\nnetwork = "{"22" * 32}"\n')
        port, ref_cfg = Config.loads(node + toml), RefConfig.loads(node + toml)
        assert port.overload == ov and vars(ref_cfg.overload) == vars(ref)
        assert port.observability.trace_done_cap == port.observability.recorder_cap == 8192
        assert Config.loads(node + chip_smoke.ab_table(None, 4096)).overload == OverloadConfig()


def _dump(records):
    return {"completed": [{"sender": s, "seq": q, "terminal": "committed",
                           "stages": [["ingress", t - 0.5, 0.0], ["committed", t, 0.0]]} for s, q, t in records],
            "live": []}


class TestPhase14Readings:
    def test_latency_and_fairness_are_the_reference_formulas(self):
        """Offered time to the latest of the nodes' committed stamps (the
        reference cell's latency), only over transfers stamped on every
        node; Jain's index over the steady senders' frontier/offered."""
        a, b, c = "aa" * 32, "bb" * 32, "cc" * 32
        offered_at = {(a, 1): 10.0, (a, 2): 10.5, (b, 1): 11.0, (c, 1): 12.0}
        traces = [_dump([(a, 1, 10.2), (a, 2, 11.5), (b, 1, 11.4), (c, 1, 12.9)]),
                  _dump([(a, 1, 10.3), (a, 2, 11.0), (b, 1, 13.0), (c, 1, 12.1)]),
                  _dump([(a, 1, 10.25), (b, 1, 11.2), (c, 1, 12.2)])]  # (a, 2) not stamped here
        steady, all_, on = chip_smoke.ab_latencies(traces, offered_at, {a, b})
        # the reference: max over the nodes' commit stamps minus the offered time
        assert steady == pytest.approx(sorted([10.3 - 10.0, 13.0 - 11.0]))
        assert all_ == pytest.approx(sorted([0.3, 2.0, 12.9 - 12.0]))
        assert on == {3: 3, 2: 1}
        assert ref_pctl(steady, 0.99) == steady[-1]
        pubs = [bytes.fromhex(x) for x in (a, b, c)]
        frontier = {pubs[0]: 2, pubs[1]: 1}
        got = chip_smoke.ab_fairness(frontier, [4, 2, 5], [0, 1], pubs)
        assert got == round(ref_scenarios.jain_index([2 / 4, 1 / 2]), 6) == 1.0
        got = chip_smoke.ab_fairness(frontier, [2, 4, 5], [0, 1, 2], pubs)
        assert got == round(ref_scenarios.jain_index([1.0, 0.25, 0.0]), 6)

    def test_stages_split_the_latency_at_the_admitting_node(self):
        a = "aa" * 32

        def rec(seq, origin, stamps, terminal="committed"):
            return {"sender": a, "seq": seq, "origin": origin, "terminal": terminal,
                    "stages": [[st, t, 0.0] for st, t in stamps]}

        full = [("ingress", 1.1), ("admitted", 1.2), ("delivered", 1.5), ("committed", 1.6)]
        traces = [{"completed": [rec(1, False, [("ingress", 0.9)], "rejected"), rec(1, True, full)], "live": []},
                  {"completed": [rec(1, False, [("echoed", 1.3), ("committed", 1.9)])], "live": []},
                  {"completed": [rec(1, False, [("delivered", 1.4), ("committed", 1.7)]),
                                 rec(2, True, full)], "live": []}]  # seq 2 committed on one node only
        got = chip_smoke.ab_stages(traces, {(a, 1): 1.0, (a, 2): 1.0}, {(a, 1), (a, 2)})
        want = {"offered_to_ingress": 100.0, "ingress_to_admitted": 100.0, "admitted_to_delivered": 300.0,
                "delivered_to_last_commit": 400.0}
        assert {k: v[0] for k, v in got.items()} == pytest.approx(want)
        assert {k: v[1] for k, v in got.items()} == pytest.approx(want)

    def test_expected_transfers_stop_at_a_senders_first_gap(self):
        offered = {"x": {1, 2, 3, 4, 5}, "y": {1, 2, 3}, "z": {1, 2}}
        acked = {"x": {1, 2, 4, 5}, "y": {1, 2, 3}}
        last, parked = chip_smoke.ab_expected(acked, offered)
        assert last == {"x": 2, "y": 3, "z": 0}
        assert parked == {"x": [4, 5]}

    def test_replay_applies_the_ledgers_rule_in_commit_order(self):
        """A sender near empty: a debit above its balance fails (its
        sequence consumed, no money moved) unless a credit landed first;
        the same transfers in another commit order give another ledger,
        each the ledger's own rule."""
        hot, other = b"\x01" * 32, b"\x02" * 32
        transfers = {(hot, 1): (other, 95), (hot, 2): (other, 10), (hot, 3): (other, 3),
                     (other, 1): (hot, 8)}
        last = {hot: 3, other: 1}
        # the credit lands after hot/2 was attempted: hot/2 fails, hot/3 commits
        state, over, faults = chip_smoke.ab_replay([(hot, 1), (hot, 3), (other, 1)], transfers, last, 100)
        assert not faults and over == [(hot, 2)]
        assert state == {hot: [3, 100 - 95 - 3 + 8], other: [1, 100 + 95 + 3 - 8]}
        # the credit lands first: every debit commits
        state, over, faults = chip_smoke.ab_replay([(hot, 1), (other, 1), (hot, 2), (hot, 3)], transfers, last, 100)
        assert not faults and not over
        assert state == {hot: [3, 100 - 95 + 8 - 10 - 3], other: [1, 100 + 95 - 8 + 10 + 3]}

    def test_replay_names_what_breaks_the_rule(self):
        a, b = b"\x03" * 32, b"\x04" * 32
        transfers = {(a, 1): (b, 5), (a, 2): (b, 5), (a, 3): (b, 500), (b, 1): (b, 1)}
        # a/1 affordable and never committed; a/3 committed past the balance;
        # b/1 (to itself, moves nothing) never committed; b/2 not expected
        _, over, faults = chip_smoke.ab_replay([(a, 2), (a, 3), (b, 2)], transfers, {a: 3, b: 1}, 100)
        assert over == []
        assert len(faults) == 4
        assert any(f.startswith(a.hex()[:12] + "/1") and "expected and affordable" in f for f in faults)
        assert any(f.startswith(a.hex()[:12] + "/3") and "against a balance" in f for f in faults)
        assert any(f.startswith(b.hex()[:12] + "/2") and "not an expected" in f for f in faults)
        assert any(f.startswith(b.hex()[:12] + "/1") and "affordable" in f for f in faults)
        state, _, faults = chip_smoke.ab_replay([(a, 1), (a, 2), (b, 1)], transfers, {a: 3, b: 1},
                                                INITIAL_BALANCE)
        assert faults == [f"{a.hex()[:12]}/3: expected and affordable (500 against {INITIAL_BALANCE - 10}), "
                          f"not committed"]

    def test_level0_after(self):
        h = [(0.0, 200, "ok", 0), (1.0, 200, "overloaded", 2), (2.0, 200, "ok", 1), (3.0, 200, "ok", 0),
             (4.0, None, None, None), (5.0, 200, "ok", 0)]
        assert chip_smoke.level0_after(h, 0.5) == 2.5
        assert chip_smoke.level0_after(h, 3.5) == 0.0
        assert chip_smoke.level0_after(h[:3], 0.5) is None

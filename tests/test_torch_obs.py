"""Observability subsystem tests (obs/ package + GET endpoints).

Three tiers, mirroring how the subsystem is layered:

* registry unit tests — instrument semantics (monotonicity, histogram
  bucket math, percentile interpolation), thread + asyncio concurrency
  exactness (the verifier bumps histograms from worker threads while the
  broadcast plane bumps counters on the event loop), CounterGroup
  dict-compat;
* TxTrace behavior — sampling lottery, cardinality cap eviction,
  idempotent / order-tolerant stamps;
* endpoint e2e — raw HTTP/1.1 GETs against the same public PortMux port
  that serves native gRPC and grpc-web, validating the Prometheus
  exposition format, the JSON bodies, 404 routing, the config
  kill-switch, and keep-alive reuse (the endpoints ride the grpc-web
  HTTP/1 loop, so they inherit its connection accounting).
"""

import asyncio
import itertools
import json
import math
import threading

import pytest

from at2_node_tpu_torch.client import Client
from at2_node_tpu_torch.crypto.keys import ExchangeKeyPair, SignKeyPair
from at2_node_tpu_torch.net.peers import Peer
from at2_node_tpu_torch.node.config import Config, ObservabilityConfig, VerifierConfig
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.obs import (
    REJECTED,
    STAGES,
    Counter,
    CounterGroup,
    FlightRecorder,
    Gauge,
    Histogram,
    Registry,
    TxTrace,
)

_ports = itertools.count(32000)

TICK = 0.1
TIMEOUT = 10.0


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


# ---------------------------------------------------------------- registry


class TestInstruments:
    def test_counter_monotonic(self):
        c = Counter("events")
        c.inc()
        c.inc(41)
        assert c.value == 42
        with pytest.raises(ValueError):
            c.inc(-1)
        with pytest.raises(ValueError):
            c.set(41)  # set() exists for CounterGroup but stays monotonic
        c.set(50)
        assert c.value == 50

    def test_gauge_set_and_fn(self):
        g = Gauge("depth")
        g.set(7)
        assert g.value == 7
        backing = [3]
        g2 = Gauge("lazy", fn=lambda: backing[0])
        assert g2.value == 3 and isinstance(g2.value, int)
        backing[0] = 9
        assert g2.value == 9
        with pytest.raises(RuntimeError):
            g2.set(1)  # callback-backed gauges are read-only

    def test_gauge_fn_exception_reads_zero(self):
        def boom():
            raise RuntimeError("dead component")

        g = Gauge("broken", fn=boom)
        assert g.value == 0.0  # a dead provider must not take stats down

    def test_histogram_exact_count_sum_max(self):
        h = Histogram("lat")
        for v in (0.001, 0.002, 0.004, 0.100):
            h.observe(v)
        h.observe(-1.0)  # negative (clock skew): dropped
        h.observe(float("nan"))  # dropped
        snap = h.snapshot()
        assert snap["count"] == 4
        assert snap["sum_ms"] == pytest.approx(107.0, abs=0.01)
        assert snap["max_ms"] == pytest.approx(100.0, abs=0.01)

    def test_histogram_bucket_math(self):
        # bounds 1,2,4: values land in the right bucket, cumulative
        # counts are monotone, +Inf equals the total count
        h = Histogram("b", bounds=(1.0, 2.0, 4.0))
        for v in (0.5, 1.0, 1.5, 3.0, 100.0):
            h.observe(v)
        pairs, total, count = h.buckets()
        assert [(le, c) for le, c in pairs] == [
            (1.0, 2),  # 0.5, 1.0 (le is inclusive)
            (2.0, 3),  # + 1.5
            (4.0, 4),  # + 3.0
            (math.inf, 5),  # + 100.0 overflow
        ]
        assert count == 5 and total == pytest.approx(106.0)

    def test_histogram_percentiles_interpolated_and_capped(self):
        h = Histogram("p", bounds=(1.0, 2.0, 4.0, 8.0))
        for _ in range(100):
            h.observe(3.0)
        snap = h.snapshot()
        # all mass in one bucket: percentiles interpolate inside (2,3]
        # (capped at the observed max), so p50 < p99 <= max
        assert 2000.0 < snap["p50_ms"] <= 3000.0
        assert snap["p50_ms"] < snap["p99_ms"] <= snap["max_ms"]

    def test_histogram_rejects_bad_bounds(self):
        with pytest.raises(ValueError):
            Histogram("bad", bounds=(2.0, 1.0))

    def test_counter_group_dict_compat(self):
        r = Registry()
        g = r.counter_group(("rx", "tx"))
        g["rx"] += 1  # the migrated call-site surface
        g["rx"] += 2
        assert g["rx"] == 3 and g["tx"] == 0
        assert "rx" in g and "nope" not in g
        assert sorted(g.keys()) == ["rx", "tx"]
        assert dict(g.items()) == {"rx": 3, "tx": 0}
        assert g.as_dict() == {"rx": 3, "tx": 0}
        assert g.get("nope", 7) == 7
        assert len(g) == 2 and set(g) == {"rx", "tx"}
        with pytest.raises(KeyError):
            g["typo"] += 1  # fixed key set, like the old literal dicts

    def test_registry_get_or_create_and_kind_check(self):
        r = Registry()
        assert r.counter("x") is r.counter("x")
        with pytest.raises(TypeError):
            r.gauge("x")  # same name, different kind

    def test_registry_snapshot_merges_providers(self):
        r = Registry()
        r.counter("a").inc(2)
        r.histogram("h").observe(0.001)
        r.register_provider("vrf_", lambda: {"batches": 5})
        r.register_provider("dead_", lambda: 1 / 0)  # swallowed
        snap = r.snapshot()
        assert snap["a"] == 2
        assert snap["vrf_batches"] == 5
        assert snap["h_count"] == 1 and "h_p99_ms" in snap
        assert not any(k.startswith("dead_") for k in snap)

    def test_prometheus_exposition_format(self):
        r = Registry()
        r.counter("commits", "total commits").inc(3)
        r.gauge("depth").set(2)
        r.histogram("lat", bounds=(0.001, 0.01)).observe(0.005)
        r.register_provider("vrf_", lambda: {"occ": 0.5, "skip": "str"})
        text = r.render_prometheus()
        assert text.endswith("\n")
        lines = text.splitlines()
        assert "# TYPE at2_commits_total counter" in lines
        assert "at2_commits_total 3" in lines
        assert "at2_depth 2" in lines
        assert '''at2_lat_seconds_bucket{le="0.001"} 0''' in lines
        assert '''at2_lat_seconds_bucket{le="+Inf"} 1''' in lines
        assert "at2_lat_seconds_count 1" in lines
        assert "at2_vrf_occ 0.5" in lines
        assert not any("skip" in ln for ln in lines)  # non-numeric dropped
        # every sample line is `name{labels}? value` with a float value
        for ln in lines:
            if ln.startswith("#"):
                continue
            name, _, value = ln.rpartition(" ")
            assert name and float(value) is not None


class TestConcurrency:
    def test_threaded_counter_and_histogram_exact(self):
        # the verifier contract: worker threads bump instruments while
        # the event loop reads them — totals must come out exact
        r = Registry()
        c = r.counter("hits")
        h = r.histogram("lat")
        n_threads, per_thread = 8, 5000

        def worker():
            for _ in range(per_thread):
                c.inc()
                h.observe(0.001)

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert c.value == n_threads * per_thread
        assert h.snapshot()["count"] == n_threads * per_thread

    async def test_asyncio_tasks_counter_exact(self):
        r = Registry()
        c = r.counter("ticks")

        async def bump():
            for _ in range(1000):
                c.inc()
                if _ % 100 == 0:
                    await asyncio.sleep(0)  # interleave tasks

        await asyncio.gather(*(bump() for _ in range(10)))
        assert c.value == 10_000


# ----------------------------------------------------------------- TxTrace


class TestTxTrace:
    def test_full_lifecycle_feeds_histograms(self):
        r = Registry()
        tr = TxTrace(r, sample_every=1)
        key = (b"s" * 32, 1)
        tr.begin(key, now=100.0)
        for i, stage in enumerate(STAGES[1:], start=1):
            tr.stamp(key, stage, now=100.0 + i * 0.01)
        assert tr.live == 0  # committed removes the live record
        snap = tr.snapshot()
        for stage in STAGES[1:]:
            assert snap[f"ingress_to_{stage}"]["count"] == 1
        assert snap[f"ingress_to_{STAGES[-1]}"]["max_ms"] == pytest.approx(
            50.0, abs=0.5
        )
        stats = r.snapshot()
        assert stats["tx_traced"] == 1
        assert stats["tx_trace_completed"] == 1

    def test_sampling_every_nth(self):
        r = Registry()
        tr = TxTrace(r, sample_every=3)
        for seq in range(1, 10):  # 9 ingresses -> 3 traced
            tr.begin((b"s" * 32, seq))
        assert r.counter("tx_traced").value == 3

    def test_disabled_traces_nothing(self):
        r = Registry()
        tr = TxTrace(r, sample_every=0)
        assert not tr.enabled
        tr.begin((b"s" * 32, 1))
        assert tr.live == 0 and r.counter("tx_traced").value == 0

    def test_cap_evicts_oldest(self):
        r = Registry()
        tr = TxTrace(r, sample_every=1, cap=4)
        for seq in range(1, 7):
            tr.begin((b"s" * 32, seq))
        assert tr.live == 4
        assert r.counter("tx_trace_evicted").value == 2
        # the evicted (oldest) trace no longer stamps
        tr.stamp((b"s" * 32, 1), "committed")
        assert r.counter("tx_trace_completed").value == 0

    def test_stamps_idempotent_and_order_tolerant(self):
        r = Registry()
        tr = TxTrace(r, sample_every=1)
        key = (b"s" * 32, 1)
        tr.begin(key, now=0.0)
        tr.stamp(key, "delivered", now=1.0)
        tr.stamp(key, "echoed", now=2.0)  # backwards: ignored
        tr.stamp(key, "delivered", now=3.0)  # duplicate: ignored
        snap = tr.snapshot()
        assert snap["ingress_to_delivered"]["count"] == 1
        assert snap["ingress_to_echoed"]["count"] == 0
        tr.stamp((b"x" * 32, 9), "committed")  # untraced key: no-op
        assert r.counter("tx_trace_completed").value == 0

    def test_bad_params_rejected(self):
        r = Registry()
        with pytest.raises(ValueError):
            TxTrace(r, sample_every=-1)
        with pytest.raises(ValueError):
            TxTrace(r, cap=0)
        with pytest.raises(ValueError):
            TxTrace(r, done_cap=0)

    def test_stamps_carry_mono_and_wall_timestamps(self):
        # every stage retains BOTH clocks: monotonic for local deltas,
        # wall for the cross-node join (tools/trace_collect.py)
        r = Registry()
        tr = TxTrace(r, sample_every=1)
        key = (b"s" * 32, 1)
        tr.begin(key)
        tr.stamp(key, "admitted")
        rec = tr.tracez()["live"][0]
        assert rec["sender"] == (b"s" * 32).hex() and rec["seq"] == 1
        assert rec["origin"] is True and rec["terminal"] is None
        assert [s[0] for s in rec["stages"]] == ["ingress", "admitted"]
        for _stage, mono, wall in rec["stages"]:
            assert isinstance(mono, float) and isinstance(wall, float)

    def test_committed_retires_into_completed_ring(self):
        r = Registry()
        tr = TxTrace(r, sample_every=1)
        key = (b"s" * 32, 1)
        tr.begin(key, now=0.0)
        for i, stage in enumerate(STAGES[1:], start=1):
            tr.stamp(key, stage, now=float(i))
        z = tr.tracez()
        assert z["live"] == []
        (rec,) = z["completed"]
        assert rec["terminal"] == "committed"
        assert [s[0] for s in rec["stages"]] == list(STAGES)

    def test_rejected_is_terminal_and_feeds_histogram(self):
        r = Registry()
        tr = TxTrace(r, sample_every=1)
        key = (b"s" * 32, 1)
        tr.begin(key, now=10.0)
        tr.stamp(key, REJECTED, now=10.5)
        assert tr.live == 0
        (rec,) = tr.tracez()["completed"]
        assert rec["terminal"] == REJECTED
        snap = tr.snapshot()
        assert snap["ingress_to_rejected"]["count"] == 1
        assert snap["ingress_to_rejected"]["max_ms"] == pytest.approx(
            500.0, abs=1.0
        )
        assert r.counter("tx_trace_rejected").value == 1
        # rejection never resurrects: later stamps on the key are no-ops
        tr.stamp(key, "committed", now=11.0)
        assert r.counter("tx_trace_completed").value == 0

    def test_completed_ring_bounded_by_done_cap(self):
        r = Registry()
        tr = TxTrace(r, sample_every=1, done_cap=3)
        for seq in range(1, 6):
            key = (b"s" * 32, seq)
            tr.begin(key)
            tr.stamp(key, "committed")
        done = tr.tracez()["completed"]
        assert [rec["seq"] for rec in done] == [3, 4, 5]
        # limit keeps the NEWEST n; 0 keeps none
        assert [r_["seq"] for r_ in tr.tracez(limit=2)["completed"]] == [4, 5]
        assert tr.tracez(limit=0)["completed"] == []

    def test_limit_past_the_ring_keeps_every_record(self):
        # ``limit`` larger than the completed ring returns all of it. The
        # reference slices from ``len - limit``, which goes negative there
        # and counts from the end: 5 records under limit=8 give its newest
        # 3; the port repairs that (a steady sender's oldest transfers
        # vanished from /tracez?limit=65536 once a node held over 32,768)
        from at2_node_tpu.obs.registry import Registry as RefRegistry
        from at2_node_tpu.obs.trace import TxTrace as RefTxTrace

        def seqs(tr_cls, reg, limit):
            tr = tr_cls(reg, sample_every=1, done_cap=16)
            for seq in range(1, 6):
                key = (b"s" * 32, seq)
                tr.begin(key, now=float(seq))
                tr.stamp(key, "committed", now=seq + 0.5)
            return [r_["seq"] for r_ in tr.tracez(limit=limit)["completed"]]

        for limit in (5, 6, 8, 10, 16, 65536):
            assert seqs(TxTrace, Registry(), limit) == [1, 2, 3, 4, 5]
        assert seqs(TxTrace, Registry(), 3) == seqs(RefTxTrace, RefRegistry(), 3) == [3, 4, 5]
        assert seqs(RefTxTrace, RefRegistry(), 8) == [3, 4, 5]

    def test_relay_records_join_without_feeding_histograms(self):
        # a stamp for a key never seen at ingress opens a RELAY span:
        # counted separately, kept out of the latency histograms (no
        # ingress t0 to measure from), exported for the stitcher
        r = Registry()
        tr = TxTrace(r, sample_every=1)
        key = (b"r" * 32, 7)
        tr.stamp(key, "echoed")
        assert tr.live == 1
        assert r.counter("tx_traced").value == 0
        assert r.counter("tx_trace_relayed").value == 1
        tr.stamp(key, "committed")
        (rec,) = tr.tracez()["completed"]
        assert rec["origin"] is False
        assert [s[0] for s in rec["stages"]] == ["echoed", "committed"]
        snap = tr.snapshot()
        assert snap["ingress_to_committed"]["count"] == 0

    def test_relay_lottery_is_key_based(self):
        # sample_every=2: relay records open for the same HALF of the
        # key space on every node (key-hash, not arrival order), so
        # sampled spans join across the fleet
        r = Registry()
        tr = TxTrace(r, sample_every=2)
        for seq in range(1, 9):
            tr.stamp((bytes([0]) * 32, seq), "echoed")
        assert tr.live == 4  # even (0 + seq) % 2 == 0 keys only
        assert r.counter("tx_trace_relayed").value == 4


# ------------------------------------------------------- flight recorder


class TestFlightRecorder:
    def test_ring_bounded_with_drop_accounting(self):
        rec = FlightRecorder(cap=4)
        for i in range(10):
            rec.record("rx", (i,))
        d = rec.dump()
        assert d["cap"] == 4 and d["recorded"] == 10 and d["dropped"] == 6
        assert len(d["events"]) == 4
        # ring keeps the NEWEST cap events, oldest first
        assert [e[2][0] for e in d["events"]] == [6, 7, 8, 9]
        assert [e[1] for e in d["events"]] == ["rx"] * 4
        # paired clock readings for wall alignment at the consumer
        assert d["now_monotonic"] > 0 and d["now_wall"] > 0

    def test_cap_zero_disables(self):
        rec = FlightRecorder(cap=0)
        assert not rec.enabled
        rec.record("rx", (1,))
        rec.snapshot("anomaly")
        d = rec.dump()
        assert d["recorded"] == 0 and d["events"] == []
        assert d["snapshots"] == []

    def test_snapshots_survive_rollover_and_stay_bounded(self):
        rec = FlightRecorder(cap=2, max_snapshots=2)
        rec.record("a", (1,))
        rec.snapshot("first")
        for i in range(5):
            rec.record("b", (i,))
        # the frozen copy still shows the pre-rollover ring
        d = rec.dump()
        assert len(d["snapshots"]) == 1
        assert [e[1] for e in d["snapshots"][0]["events"]] == ["a"]
        # a flapping anomaly cannot grow the snapshot list unboundedly
        for n in range(5):
            rec.snapshot(f"flap{n}")
        d = rec.dump()
        assert len(d["snapshots"]) == 2
        assert rec.snapshots_taken == 6
        assert [s["reason"] for s in d["snapshots"]] == ["flap3", "flap4"]

    def test_thread_safety_exact_total(self):
        rec = FlightRecorder(cap=256)
        n_threads, per = 8, 500

        def hammer(t):
            for i in range(per):
                rec.record("t", (t, i))

        threads = [
            threading.Thread(target=hammer, args=(t,))
            for t in range(n_threads)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        d = rec.dump()
        assert d["recorded"] == n_threads * per
        assert len(d["events"]) == 256

    def test_bad_params_rejected(self):
        with pytest.raises(ValueError):
            FlightRecorder(cap=-1)
        with pytest.raises(ValueError):
            FlightRecorder(max_snapshots=0)


# ------------------------------------------------- stitch + tail (pure)


class TestTraceTools:
    def _dump(self, node, records):
        return {"node": node, "live": [], "completed": records}

    def _rec(self, seq, origin, stages, terminal="committed"):
        return {
            "sender": "aa" * 32,
            "seq": seq,
            "origin": origin,
            "terminal": terminal,
            "stages": stages,
        }

    def test_stitch_joins_and_attributes_stragglers(self):
        from at2_node_tpu_torch.tools.trace_collect import stitch

        origin = self._dump("n0", [self._rec(
            1, True,
            [["ingress", 0.0, 100.0], ["echoed", 0.01, 100.01],
             ["committed", 0.05, 100.05]],
        )])
        relay = self._dump("n1", [self._rec(
            1, False,
            [["echoed", 7.02, 100.02], ["committed", 7.09, 100.09]],
        )])
        st = stitch([relay, origin])  # polling order must not matter
        assert st["coverage"] == {
            "txs": 1, "committed": 1,
            "stitched_committed": 1, "with_origin": 1,
            "with_broker": 0,
        }
        (tx,) = st["txs"]
        assert tx["origin_node"] == "n0" and tx["nodes"] == 2
        # times normalize to the ORIGIN ingress wall stamp (t=0)
        n1 = [s for s in tx["spans"] if s["node"] == "n1"][0]
        assert n1["stages"] == [["echoed", 0.02], ["committed", 0.09]]
        # n1 was last into both stages: it is the straggler
        assert tx["stragglers"]["committed"] == ["n1", 0.09]
        assert st["straggler_counts"]["echoed"] == {"n1": 1}
        # pure: same dumps in, byte-identical JSON out
        assert json.dumps(st, sort_keys=True) == json.dumps(
            stitch([relay, origin]), sort_keys=True
        )

    def test_stitch_broker_hop_decomposition(self):
        from at2_node_tpu_torch.tools.trace_collect import stitch

        # the broker saw the tx first (rx at t=-0.04 relative to node
        # ingress), flushed at -0.01; the node committed at +0.05 — the
        # hop decomposes into queue 30ms, handoff 10ms, plane 50ms
        broker = self._dump("broker:127.0.0.1:9", [self._rec(
            1, False,
            [["broker_rx", 0.0, 99.96], ["broker_flush", 0.03, 99.99]],
            terminal="broker_flush",
        )])
        node = self._dump("n0", [self._rec(
            1, True,
            [["ingress", 0.0, 100.0], ["committed", 0.05, 100.05]],
        )])
        st = stitch([node, broker])
        assert st["coverage"]["with_broker"] == 1
        (tx,) = st["txs"]
        hop = tx["broker_hop"]
        # rels normalize to the ORIGIN ingress stamp: the broker stages
        # land at negative offsets (custody precedes node ingress)
        assert hop["rx"] == -0.04 and hop["flush"] == -0.01
        assert hop["queue_ms"] == 30.0
        assert hop["handoff_ms"] == 10.0
        assert hop["plane_ms"] == 50.0
        assert hop["total_ms"] == 90.0
        assert hop["bottleneck"] == "plane_ms"
        seg = st["broker_hop"]["segments"]
        assert seg["total_ms"]["count"] == 1
        assert seg["total_ms"]["p99_ms"] == 90.0
        assert st["broker_hop"]["bottleneck_counts"] == {"plane_ms": 1}
        # pure: same dumps in, byte-identical JSON out
        assert json.dumps(st, sort_keys=True) == json.dumps(
            stitch([node, broker]), sort_keys=True
        )

    def test_chrome_trace_shape(self):
        from at2_node_tpu_torch.tools.trace_collect import chrome_trace, stitch

        st = stitch([self._dump("n0", [self._rec(
            1, True,
            [["ingress", 0.0, 100.0], ["committed", 0.05, 100.05]],
        )])])
        ev = chrome_trace(st)["traceEvents"]
        (x,) = [e for e in ev if e["ph"] == "X"]
        assert x["name"] == "ingress→committed"
        assert x["ts"] == 0 and x["dur"] == 50_000  # µs
        assert any(e["ph"] == "M" for e in ev)  # process/thread names
        assert any(e["ph"] == "i" for e in ev)  # terminal instant

    def test_top_tracez_tail_dedups(self):
        from at2_node_tpu_torch.tools.top import render_trace_lines

        dump = self._dump("n0", [self._rec(
            3, True,
            [["ingress", 0.0, 100.0], ["committed", 0.05, 100.05]],
        )])
        seen: set = set()
        first = render_trace_lines("127.0.0.1:7001", dump, seen)
        assert len(first) == 1
        assert "committed" in first[0] and "50.00" in first[0]
        # second poll with the same ring: nothing new to print
        assert render_trace_lines("127.0.0.1:7001", dump, seen) == []


# ----------------------------------------------------- endpoints over mux


async def _http_get(reader, writer, path, keep=False):
    """One GET on an open connection; returns (status, headers, body).
    Reads exactly Content-Length so the connection survives keep-alive."""
    conn = "keep-alive" if keep else "close"
    writer.write(
        f"GET {path} HTTP/1.1\r\nHost: n\r\nConnection: {conn}\r\n\r\n".encode()
    )
    await writer.drain()
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split(" ")[1])
    headers = {}
    for ln in lines[1:]:
        if ":" in ln:
            k, v = ln.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    body = await reader.readexactly(int(headers["content-length"]))
    return status, headers, body


async def _get(addr, path):
    host, _, port = addr.rpartition(":")
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        return await _http_get(reader, writer, path)
    finally:
        writer.close()


class _Node:
    def __init__(self, **overrides):
        self.config = make_configs(1, **overrides)[0]

    async def __aenter__(self):
        self.service = await Service.start(self.config)
        return self

    async def __aexit__(self, *exc):
        await self.service.close()


class TestEndpoints:
    async def test_metrics_healthz_statusz_after_commit(self):
        async with _Node() as node:
            addr = node.config.rpc_address
            async with Client(f"http://{addr}") as client:
                sender, recipient = SignKeyPair.random(), SignKeyPair.random()
                await client.send_asset(sender, 1, recipient.public, 5)
                deadline = asyncio.get_event_loop().time() + TIMEOUT
                while await client.get_last_sequence(sender.public) != 1:
                    assert asyncio.get_event_loop().time() < deadline
                    await asyncio.sleep(TICK)

            # /metrics: Prometheus text exposition on the public RPC port
            status, headers, body = await _get(addr, "/metrics")
            assert status == 200
            assert headers["content-type"].startswith("text/plain")
            text = body.decode()
            lines = text.splitlines()
            assert "at2_committed 1" in lines
            assert any(
                ln.startswith("# TYPE at2_tx_ingress_to_committed_seconds")
                for ln in lines
            )
            # bucket series are cumulative and close with +Inf == count
            buckets = [
                ln for ln in lines
                if ln.startswith("at2_tx_ingress_to_committed_seconds_bucket")
            ]
            counts = [int(ln.rpartition(" ")[2]) for ln in buckets]
            assert counts == sorted(counts) and counts[-1] == 1
            assert 'le="+Inf"' in buckets[-1]
            for ln in lines:  # every sample parses as `name value`
                if not ln.startswith("#"):
                    float(ln.rpartition(" ")[2])

            # /healthz: liveness + quorum verdict (single node: trivially ok)
            status, headers, body = await _get(addr, "/healthz")
            assert status == 200
            health = json.loads(body)
            assert health["status"] == "ok"
            assert health["committed"] == 1

            # /statusz: the operator JSON the top.py dashboard polls
            status, headers, body = await _get(addr, "/statusz")
            assert status == 200
            assert headers["content-type"].startswith("application/json")
            sz = json.loads(body)
            assert set(sz) >= {
                "node", "rpc_address", "health", "stats",
                "tx_lifecycle", "verifier_stages",
            }
            life = sz["tx_lifecycle"]["ingress_to_committed"]
            assert life["count"] == 1 and life["p99_ms"] > 0.0
            assert sz["stats"]["committed"] == 1

            # unknown GET path routes to 404, connection still usable
            status, _, body = await _get(addr, "/nope")
            assert status == 404 and body == b"not found"

    async def test_keep_alive_reuses_one_connection(self):
        async with _Node() as node:
            addr = node.config.rpc_address
            host, _, port = addr.rpartition(":")
            reader, writer = await asyncio.open_connection(host, int(port))
            try:
                for path in ("/healthz", "/metrics", "/statusz"):
                    status, headers, _ = await _http_get(
                        reader, writer, path, keep=True
                    )
                    assert status == 200
                    assert headers["connection"] == "keep-alive"
            finally:
                writer.close()

    async def test_endpoints_disabled_by_config(self):
        async with _Node(
            observability=ObservabilityConfig(endpoints=False)
        ) as node:
            for path in (
                "/metrics", "/healthz", "/statusz", "/tracez", "/debugz",
                "/sloz",
            ):
                status, _, _ = await _get(node.config.rpc_address, path)
                assert status == 404

    async def test_tracez_and_debugz_after_commit(self):
        async with _Node() as node:
            addr = node.config.rpc_address
            async with Client(f"http://{addr}") as client:
                sender = SignKeyPair.random()
                await client.send_asset(
                    sender, 1, SignKeyPair.random().public, 5
                )
                deadline = asyncio.get_event_loop().time() + TIMEOUT
                while await client.get_last_sequence(sender.public) != 1:
                    assert asyncio.get_event_loop().time() < deadline
                    await asyncio.sleep(TICK)

            # /tracez: the committed tx sits in the completed ring with
            # the full stage ladder and a paired clock reading
            status, headers, body = await _get(addr, "/tracez")
            assert status == 200
            assert headers["content-type"].startswith("application/json")
            z = json.loads(body)
            assert set(z) >= {"node", "clock", "live", "completed"}
            (rec,) = [
                r_ for r_ in z["completed"]
                if r_["sender"] == sender.public.hex()
            ]
            assert rec["origin"] is True
            assert rec["terminal"] == "committed"
            stages = [s[0] for s in rec["stages"]]
            assert stages[0] == "ingress" and stages[-1] == "committed"

            # ?limit= bounds the completed list (0 = none)
            status, _, body = await _get(addr, "/tracez?limit=0")
            assert status == 200
            assert json.loads(body)["completed"] == []

            # /debugz: the flight-recorder ring saw the protocol run
            status, headers, body = await _get(addr, "/debugz")
            assert status == 200
            assert headers["content-type"].startswith("application/json")
            d = json.loads(body)
            rec = d["recorder"]
            assert rec["cap"] == 2048 and rec["recorded"] > 0
            codes = {e[1] for e in rec["events"]}
            # single node, default (batched) plane: the slot crossed
            # its echo decision and ready-quorum delivery edge, and the
            # attestation send path fired
            assert {"batch_echo", "batch_deliver", "tx"} <= codes

    async def test_sloz_serves_burn_rate_verdicts(self):
        async with _Node() as node:
            addr = node.config.rpc_address
            async with Client(f"http://{addr}") as client:
                sender = SignKeyPair.random()
                await client.send_asset(
                    sender, 1, SignKeyPair.random().public, 5
                )
                deadline = asyncio.get_event_loop().time() + TIMEOUT
                while await client.get_last_sequence(sender.public) != 1:
                    assert asyncio.get_event_loop().time() < deadline
                    await asyncio.sleep(TICK)
            # two direct probes bracket the commit so the engine holds a
            # window regardless of the probe loop's own cadence
            node.service.slo_probe()
            await asyncio.sleep(0.01)
            node.service.slo_probe()

            status, headers, body = await _get(addr, "/sloz")
            assert status == 200
            assert headers["content-type"].startswith("application/json")
            z = json.loads(body)
            assert set(z) >= {
                "node", "windows_s", "samples", "objectives", "breaching",
            }
            assert z["samples"] >= 2
            # the default throughput floor is 0.0 = disabled (an idle
            # node has no committed rate to hold)
            kinds = {o["kind"] for o in z["objectives"]}
            assert kinds == {
                "latency_p99", "rejection_ratio", "stall_budget",
            }
            for o in z["objectives"]:
                assert {"name", "kind", "target", "status", "windows"} <= set(o)
                assert len(o["windows"]) == 2
            # one committed tx in milliseconds on localhost: a healthy
            # idle-ish node must NOT breach the default objectives
            assert z["breaching"] == []

            # the degradation verdict folds the SLO state in
            status, _, body = await _get(addr, "/healthz")
            assert status == 200
            health = json.loads(body)
            assert health["status"] == "ok"
            assert health["slo_breach"] == []

            # /statusz carries the same evaluation for the dashboard
            status, _, body = await _get(addr, "/statusz")
            assert json.loads(body)["slo"]["breaching"] == []

    async def test_recorder_disabled_by_cap_zero(self):
        async with _Node(
            observability=ObservabilityConfig(recorder_cap=0)
        ) as node:
            addr = node.config.rpc_address
            assert not node.service.recorder.enabled
            status, _, body = await _get(addr, "/debugz")
            assert status == 200
            assert json.loads(body)["recorder"]["recorded"] == 0

    async def test_snapshot_stats_key_set_stable(self):
        # the registry view must not grow/shrink keys between scrapes
        # (dashboards and the bench JSON diff on the key set)
        async with _Node() as node:
            first = set(node.service.snapshot_stats())
            async with Client(f"http://{node.config.rpc_address}") as client:
                sender = SignKeyPair.random()
                await client.send_asset(
                    sender, 1, SignKeyPair.random().public, 5
                )
                deadline = asyncio.get_event_loop().time() + TIMEOUT
                while await client.get_last_sequence(sender.public) != 1:
                    assert asyncio.get_event_loop().time() < deadline
                    await asyncio.sleep(TICK)
            after = set(node.service.snapshot_stats())
            assert first == after
            # the legacy ad-hoc dict keys all survived the migration
            assert after >= {
                "committed", "pending", "history_retained",
                "catchup_served", "rejected_at_ingress",
            }
            assert "tx_ingress_to_committed_p50_ms" in after


# ------------------------------------------------------------- fleet audit


class TestFleetAudit:
    """Unit tier for obs/audit.py: contribution rules, order
    independence, the zero-false-positive compare, and attribution."""

    def test_initial_balance_pinned_to_ledger(self):
        # obs/ is a leaf package, so audit.py duplicates the ledger's
        # INITIAL_BALANCE instead of importing it; this pin is the
        # compile-time guard that the copies never drift (a drift would
        # silently break the virgin-row rule below)
        from at2_node_tpu_torch.ledger.account import INITIAL_BALANCE as ledger_ib
        from at2_node_tpu_torch.obs.audit import INITIAL_BALANCE as audit_ib

        assert audit_ib == ledger_ib

    def test_virgin_row_contributes_zero(self):
        from at2_node_tpu_torch.obs.audit import (
            INITIAL_BALANCE,
            account_contrib,
            watermark_contrib,
        )

        key = bytes(range(32))
        # row creation timing differs across nodes (failed applies make
        # rows as a side effect), so an untouched row must be invisible
        assert account_contrib(key, 0, INITIAL_BALANCE) == 0
        assert watermark_contrib(key, 0) == 0
        # any observable state change shows
        assert account_contrib(key, 1, INITIAL_BALANCE) != 0
        assert account_contrib(key, 0, INITIAL_BALANCE - 1) != 0
        assert watermark_contrib(key, 1) != 0

    def test_digest_is_order_independent(self):
        from at2_node_tpu_torch.obs.audit import LedgerDigest

        moves = [
            (bytes([i]) * 32, s, 100_000 + d, s + 1, 100_000 + d - 7)
            for i in (3, 200, 77)
            for s, d in ((0, 0), (1, -7), (2, -14))
        ]
        a, b = LedgerDigest(), LedgerDigest()
        for m in moves:
            a.touch(*m)
        for m in reversed(moves):
            b.touch(*m)
        assert a.ranges == b.ranges
        assert a.wm == b.wm
        # reseed from the final rows reproduces the incremental digest
        c = LedgerDigest()
        c.reseed((bytes([i]) * 32, 3, 100_000 - 21) for i in (3, 200, 77))
        assert c.ranges == a.ranges and c.wm == a.wm

    @staticmethod
    def _beacon_fields(point):
        return {
            "epoch": point["epoch"],
            "commits": point["commits"],
            "wm": point["wm"],
            "ranges": point["ranges"],
            "dir": point["dir"],
            "chain": point["chain"],
        }

    def test_matching_peers_never_diverge(self):
        from at2_node_tpu_torch.obs.audit import FleetAuditor, LedgerDigest

        da, db = LedgerDigest(), LedgerDigest()
        key = bytes([16]) * 32
        for d in (da, db):
            d.touch(key, 0, 100_000, 1, 99_000)
        a, b = FleetAuditor(da), FleetAuditor(db)
        a.note_commit()
        b.note_commit()
        pb = b.snapshot(0, 0)
        assert a.observe("bb", self._beacon_fields(pb)) is None  # parked
        a.snapshot(0, 0)  # local point lands -> parked beacon settles
        assert a.counters["compared"] == 1
        assert a.counters["matched"] == 1
        assert a.divergence is None
        # chain heads are order-dependent local evidence, never compared
        assert a.chain != b.chain or a.chain == b.chain  # both legal

    def test_divergence_detected_and_attributed(self):
        from at2_node_tpu_torch.obs.audit import FleetAuditor, LedgerDigest

        da, db = LedgerDigest(), LedgerDigest()
        key = bytes([0x42]) * 32  # lane 4
        for d in (da, db):
            d.touch(key, 0, 100_000, 1, 99_000)
        # same watermark, corrupted balance on b: the only digest
        # coordinate where a mismatch is a REAL divergence
        db.touch(key, 1, 99_000, 1, 99_007)
        a, b = FleetAuditor(da), FleetAuditor(db)
        a.note_commit()
        b.note_commit()
        pa = a.snapshot(3, 0)
        rec = b.observe("aa", self._beacon_fields(pa))
        assert rec is None  # parked until b folds the same watermark
        b.snapshot(3, 0)
        assert b.divergence is not None
        assert b.divergence["peer"] == "aa"
        assert b.divergence["ranges"] == [4]
        assert b.divergence["epoch"] == 3
        assert b.counters["diverged"] == 1
        # latched: a later matching beacon does not clear the record
        first = dict(b.divergence)
        assert b.divergence == first

    def test_epoch_and_dir_skew_are_informational(self):
        from at2_node_tpu_torch.obs.audit import FleetAuditor, LedgerDigest

        d = LedgerDigest()
        d.touch(bytes([1]) * 32, 0, 100_000, 1, 99_000)
        a = FleetAuditor(d)
        p = a.snapshot(1, 7)
        # same wm, different epoch: incomparable, never divergence
        other = dict(self._beacon_fields(p), epoch=2)
        assert a.observe("bb", other) is None
        assert a.counters["epoch_skew"] == 1
        assert a.counters["compared"] == 0
        # same wm + ranges, different dir: eventual-consistency skew
        skew = dict(self._beacon_fields(p), dir=b"\x09" * 8)
        assert a.observe("cc", skew) is None
        assert a.counters["dir_skew"] == 1
        assert a.divergence is None

    def test_restore_folds_restart_marker(self):
        from at2_node_tpu_torch.obs.audit import FleetAuditor, LedgerDigest

        a = FleetAuditor(LedgerDigest())
        a.note_commit(5)
        a.snapshot(0, 0)
        doc = a.export()
        b = FleetAuditor(LedgerDigest())
        b.restore(doc)
        assert b.commits == 5
        # a restarted chain is tamper-evidently distinct from the
        # continuous one it resumed
        assert b.chain != bytes.fromhex(doc["chain"])
        c = FleetAuditor(LedgerDigest())
        c.restore({})  # no persisted chain: fresh start stays fresh
        assert c.chain == bytes(32)


# --------------------------------------------------------- incident bundles


class TestIncidentBundle:
    _DUMPS = {
        "nodes": {
            "127.0.0.1:9101": {
                "statusz": {"health": {"status": "ok"}, "stats": {"c": 1}},
                "healthz": {"status": "ok"},
                "tracez": {"traces": [{"seq": 1}]},
                "debugz": {"snapshots": []},
            },
            "127.0.0.1:9102": {
                "statusz": {"health": {"status": "degraded"}},
                "healthz": {"status": "degraded"},
                "capturez": {"cap": 8, "captured": 2, "records": []},
            },
        }
    }

    def test_bundle_is_byte_identical(self):
        import copy

        from at2_node_tpu_torch.tools.incident import build_bundle

        b1 = build_bundle(copy.deepcopy(self._DUMPS), reason="slo:breach")
        b2 = build_bundle(copy.deepcopy(self._DUMPS), reason="slo:breach")
        assert b1["files"] == b2["files"]
        assert b1["manifest"] == b2["manifest"]
        # every dump surface landed as a file, hashed in the manifest
        assert set(b1["manifest"]["files"]) == set(b1["files"])
        assert len(b1["files"]) == 7

    def test_bundle_hash_tracks_content_and_reason_is_unhashed(self):
        import copy

        from at2_node_tpu_torch.tools.incident import build_bundle

        base = build_bundle(copy.deepcopy(self._DUMPS), reason="a")
        mutated = copy.deepcopy(self._DUMPS)
        mutated["nodes"]["127.0.0.1:9101"]["statusz"]["stats"]["c"] = 2
        changed = build_bundle(mutated, reason="a")
        assert (
            changed["manifest"]["bundle_sha256"]
            != base["manifest"]["bundle_sha256"]
        )
        # two collectors racing the same incident may name the trigger
        # differently; the bundle hash covers the EVIDENCE, not the label
        relabeled = build_bundle(copy.deepcopy(self._DUMPS), reason="b")
        assert (
            relabeled["manifest"]["bundle_sha256"]
            == base["manifest"]["bundle_sha256"]
        )

    def test_write_bundle_matches_manifest(self, tmp_path):
        import copy
        import hashlib
        import json as _json

        from at2_node_tpu_torch.tools.incident import build_bundle, write_bundle

        bundle = build_bundle(copy.deepcopy(self._DUMPS))
        manifest_path = write_bundle(str(tmp_path / "b"), bundle)
        with open(manifest_path) as fp:
            manifest = _json.load(fp)
        assert manifest == bundle["manifest"]
        for rel, digest in manifest["files"].items():
            data = (tmp_path / "b" / rel).read_bytes()
            assert hashlib.sha256(data).hexdigest() == digest

    def test_edge_triggering(self):
        from at2_node_tpu_torch.tools.incident import _edges

        ok = {
            "nodes": {
                "a:1": {
                    "statusz": {
                        "health": {"status": "ok"},
                        "stats": {"recorder_snapshots": 2},
                    }
                }
            }
        }
        bad = {
            "nodes": {
                "a:1": {
                    "statusz": {
                        "health": {
                            "status": "diverged",
                            "slo_breach": ["latency_p99"],
                            "divergence": {"peer": "ff"},
                        },
                        "stats": {"recorder_snapshots": 3},
                    }
                }
            }
        }
        assert _edges(None, bad) == []  # first poll is baseline only
        assert _edges(ok, ok) == []
        reasons = _edges(ok, bad)
        assert any("health:diverged" in r for r in reasons)
        assert any("slo:" in r for r in reasons)
        assert any("divergence" in r for r in reasons)
        assert any("anomaly_snapshot" in r for r in reasons)
        # level-hold: staying degraded is NOT a fresh incident
        assert _edges(bad, bad) == []


# ------------------------------------------------------- wire-capture ring


class TestWireCapture:
    def _mesh(self, cap):
        from at2_node_tpu_torch.net.peers import Mesh

        kp = ExchangeKeyPair.random()
        return Mesh(
            "127.0.0.1:0",
            kp,
            [],
            on_frame=None,
            capture_cap=cap,
        )

    def test_ring_bounded_and_cumulative(self):
        mesh = self._mesh(4)
        peer = Peer(
            "127.0.0.1:1",
            ExchangeKeyPair.random().public,
            SignKeyPair.random().public,
        )
        for i in range(6):
            mesh._capture_frame(peer, bytes([15, i]))
        dump = mesh.capture_dump()
        assert dump["cap"] == 4
        assert dump["captured"] == 6  # cumulative, past the ring
        assert len(dump["records"]) == 4  # ring keeps the newest
        mono, peer_hex, kind, frame = dump["records"][-1]
        assert peer_hex == peer.sign_public.hex()
        assert kind == 15
        assert frame == bytes([15, 5]).hex()
        assert mesh.stats()["captured"] == 6

    def test_kill_switch_cap_zero(self):
        mesh = self._mesh(0)
        assert mesh._capture is None  # hot path: one attribute check
        assert mesh.stats()["captured"] == 0

    def test_capture_to_events_normalizes_time(self):
        from at2_node_tpu_torch.tools.capture_replay import capture_to_events

        doc = {
            "records": [
                [2_000_000_000, "aa", 1, "02"],
                [1_000_000_000, "aa", 1, "01"],  # out of order on wire
                [1_500_000_000, "aa", 1, "03"],
            ]
        }
        events = capture_to_events(doc, target=2, speed=2.0, start=0.5)
        # sorted by capture time, re-anchored to virtual start, spacing
        # compressed by speed
        assert [e[2]["frame"] for e in events] == ["01", "03", "02"]
        assert [round(e[0], 3) for e in events] == [0.5, 0.75, 1.0]
        assert all(e[1] == "inject" for e in events)
        assert all(e[2]["target"] == 2 for e in events)
        assert capture_to_events({"records": []}) == []


# --------------------------------------------- differential vs the reference


@pytest.mark.parametrize("seed", [6, 60])
def test_exposition_and_snapshot_equal_the_reference(seed):
    """The same seeded registry operations (counters, a counter group's
    ``+=``, gauges set and lazy, histograms with default and custom
    bounds, a stats and a histogram provider) on the reference's Registry
    and the port's: byte-identical Prometheus text and equal snapshots."""
    import numpy as np

    from at2_node_tpu import obs as ref_obs
    from at2_node_tpu_torch import obs as port_obs

    def drive(obs_pkg):
        rng = np.random.default_rng(seed)
        reg = obs_pkg.Registry()
        group = reg.counter_group(["rx", "tx", "dropped"], "plane counters")
        hists = [reg.histogram("verify_wait", "s"), reg.histogram("rtt", "s", bounds=(0.001, 0.01, 0.1, 1.0))]
        gauges = [reg.gauge(f"depth_{i}", "queue depth") for i in range(3)]
        lazy = {"v": 0.0}
        reg.gauge("lazy_level", "a callback gauge", fn=lambda: lazy["v"])
        ext = obs_pkg.Histogram("stage", "s")
        reg.register_provider("stats_", lambda: {"pending": int(lazy["v"]) % 7, "ratio": lazy["v"] / 3})
        reg.register_histogram_provider("verifier_", lambda: {"prep": ext})
        for _ in range(400):
            op = int(rng.integers(6))
            if op == 0:
                reg.counter(f"events_{int(rng.integers(4))}", "events").inc(int(rng.integers(1, 5)))
            elif op == 1:
                group[["rx", "tx", "dropped"][int(rng.integers(3))]] += int(rng.integers(1, 9))
            elif op == 2:
                hists[int(rng.integers(2))].observe(float(rng.exponential(0.05)))
            elif op == 3:
                gauges[int(rng.integers(3))].set(float(rng.integers(0, 1000)))
            elif op == 4:
                lazy["v"] = float(rng.uniform(0, 100))
            else:
                ext.observe(float(rng.exponential(0.002)))
        return reg.render_prometheus(), reg.snapshot()

    port_text, port_snap = drive(port_obs)
    ref_text, ref_snap = drive(ref_obs)
    assert "at2_verify_wait_seconds_bucket" in port_text and "at2_events_0_total" in port_text
    assert port_text == ref_text
    assert port_snap == ref_snap

"""The benchmark's arithmetic on fixed numbers: the frozen roofline, the
trace clipping and union, the wire codec, and every metric reader."""

import json

import pytest

from benchmark.harness import chrome, manifest, wire, yardstick
from benchmark.harness.window import Window, occupancy_pct

H100 = "NVIDIA H100 80GB HBM3"


def test_frozen_work_of_a_signature():
    assert yardstick.FIELD_MULS_PER_SIG == 3439
    assert yardstick.FIELD_SQUARES_PER_SIG == 1550
    assert yardstick.INT32_MULADD_SLOTS_PER_SIG == 548_300
    ops, bw = yardstick.ceilings(H100)
    assert ops == pytest.approx(132 * 64 * 1.98e9)
    assert bw == 3.35e12


def test_least_time_matches_the_ports_bounds():
    # the port's ops/roofline.py bound_ms: 2.148 ms at 65,536 lanes, 0.134 at 4,096
    assert 1e3 * yardstick.least_seconds(65536, H100) == pytest.approx(2.1482, abs=1e-3)
    assert 1e3 * yardstick.least_seconds(4096, H100) == pytest.approx(0.13426, abs=1e-4)


def test_roofline_pct():
    least = yardstick.least_seconds(4096, H100)
    assert yardstick.roofline_pct(4096, 4 * least, H100) == pytest.approx(25.0)
    assert yardstick.roofline_pct(0, 1.0, H100) is None
    assert yardstick.roofline_pct(10, 0.0, H100) is None
    with pytest.raises(ValueError):
        yardstick.ceilings("NVIDIA A100-SXM4-80GB")


def test_interval_arithmetic():
    assert chrome.union([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == [(0, 2.5), (3, 4)]
    assert chrome.length([(0, 2.5), (3, 4)]) == 3.5
    assert chrome.gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]


def _trace(tmp_path, name, base_ns, events):
    path = tmp_path / name
    path.write_text(json.dumps({"baseTimeNanoseconds": base_ns, "traceEvents": events}))
    return str(path)


def test_trace_window(tmp_path):
    base = 1_000_000_000_000_000_000  # ns
    ev = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    a = _trace(tmp_path, "a.json", base, [
        ev("ed25519_verify_kernel", "kernel", 1_000_000, 400_000),     # 1.0-1.4 s
        ev("Memcpy HtoD", "gpu_memcpy", 1_300_000, 200_000),           # 1.3-1.5 s
        ev("aten::copy_", "cpu_op", 1_500_000, 1_000_000),             # host 1.5-2.5 s
        ev("ed25519_verify_kernel", "kernel", 2_900_000, 300_000),     # 2.9-3.2 s, clipped to 3.0
        {"ph": "i", "name": "marker", "ts": 5},
    ])
    b = _trace(tmp_path, "b.json", base, [ev("ed25519_verify_kernel", "kernel", 500_000, 700_000)])  # 0.5-1.2 s
    lo = base / 1e9 + 1.0
    w = chrome.DeviceWindow.from_events(chrome.load(a) + chrome.load(b), lo, lo + 2.0)
    assert w.busy_s() == pytest.approx(0.5 + 0.1)
    assert w.kernel_s("ed25519_verify_kernel") == pytest.approx(0.4 + 0.2 + 0.1)
    assert [name for name, _ in w.top_ops()] == ["ed25519_verify_kernel", "Memcpy HtoD"]
    gaps = w.idle_gaps()
    assert gaps[0][1] == pytest.approx(1.4)
    assert "aten::copy_" in gaps[0][0] and "ed25519_verify_kernel" in gaps[0][0]


def test_occupancy():
    w = Window(0.0, 10.0, H100, counters=[
        ({"s": 100.0, "o": 0.5}, {"s": 300.0, "o": 0.6}),  # lanes 200 -> 500: 200 of 300
        ({"s": 0.0, "o": 0.0}, {"s": 100.0, "o": 1.0}),    # lanes 0 -> 100
    ])
    assert occupancy_pct(w, "s", "o") == pytest.approx(100.0 * 300 / 400)


def _net_window(device=None):
    m0 = {"at2_verifier_signatures": 1000.0, "at2_verifier_batch_occupancy": 0.25,
          "at2_gossip_rx_total": 10.0, "at2_batch_echo_rx_total": 5.0,
          "at2_tx_ingress_to_admitted_seconds_sum": 2.0, "at2_tx_ingress_to_admitted_seconds_count": 500.0}
    m1 = {"at2_verifier_signatures": 5000.0, "at2_verifier_batch_occupancy": 0.5,
          "at2_gossip_rx_total": 110.0, "at2_batch_echo_rx_total": 105.0,
          "at2_tx_ingress_to_admitted_seconds_sum": 3.5, "at2_tx_ingress_to_admitted_seconds_count": 800.0}
    calls = [(float(t), t + 0.010 * (t + 1), 64, "", 0) for t in range(10)] + [(20.0, 21.0, 1, "", 0)]
    return Window(0.0, 10.0, H100, calls=calls, committed=400, counters=[(m0, m1)] * 2, device=device)


def _read(name, w):
    return manifest.reader(name)(w)


def test_net_readers():
    w = _net_window()
    # 1.5 s over 300 admissions a node, the same on both nodes
    assert _read("ingress_admit_ms.net4", w) == pytest.approx(1e3 * 3.0 / 600)
    assert _read("msgs_per_tx.net4", w) == pytest.approx(2 * 200 / 400)
    # lanes 4,000 -> 10,000 a node: 4,000 signatures over 6,000 lanes
    assert _read("verifier_occupancy.net4", w) == pytest.approx(100 * 4000 / 6000)
    assert _read("k1_roofline.net4", w) is None and _read("device_idle_pct.net4", w) is None
    dev = chrome.DeviceWindow(0.0, 10.0, device=[chrome.Event("ed25519_verify_kernel", "kernel", 1.0, 1.5)])
    w = _net_window(dev)
    assert _read("device_idle_pct.net4", w) == pytest.approx(95.0)
    assert _read("k1_roofline.net4", w) == pytest.approx(100 * yardstick.least_seconds(8000, H100) / 0.5)
    assert _read("msgs_per_tx.net4", Window(0.0, 1.0, H100, committed=0)) is None
    assert _read("ingress_admit_ms.net4", Window(0.0, 1.0, H100, counters=[({}, {})])) is None


def test_replay_readers():
    s0 = {"signatures": 40960.0, "batch_occupancy": 1.0}
    s1 = {"signatures": 81920.0, "batch_occupancy": 0.8}
    h0 = {"prep": {"sum_ms": 100.0}}
    h1 = {"prep": {"sum_ms": 304.8}}
    dev = chrome.DeviceWindow(0.0, 2.0, device=[chrome.Event("ed25519_verify_kernel", "kernel", 0.0, 0.2)])
    w = Window(0.0, 2.0, H100, counters=[(s0, s1)], stages=(h0, h1), device=dev)
    assert _read("verifier_occupancy.replay", w) == pytest.approx(100 * 40960 / (102400 - 40960))
    assert _read("prep_us_per_sig.replay", w) == pytest.approx(1e3 * 204.8 / 40960)
    assert _read("device_idle_pct.replay", w) == pytest.approx(90.0)
    assert _read("k1_roofline.replay", w) == pytest.approx(100 * yardstick.least_seconds(40960, H100) / 0.2)
    assert _read("prep_us_per_sig.replay", Window(0.0, 1.0, H100, counters=[(s0, s0)])) is None


def test_codec_round_trip_and_wire_bytes():
    codec = wire.Codec()
    req = {"sender": b"\x01" * 32, "sequence": 300, "recipient": b"\x02" * 32, "amount": 2**40,
           "signature": b"\x03" * 64}
    raw = codec.encode("SendAssetRequest", req)
    assert codec.decode("SendAssetRequest", raw) == req
    # field 2 (sequence) is a varint: tag 0x10, 300 = 0xac 0x02
    assert raw[34:37] == b"\x10\xac\x02"
    batch = codec.encode("SendAssetBatchRequest", {"transactions": [req, req]})
    assert codec.decode("SendAssetBatchRequest", batch) == {"transactions": [req, req]}
    assert codec.decode("GetLastSequenceReply", b"") == {}
    assert codec.decode("GetLastSequenceReply", b"\x08\x07") == {"sequence": 7}


def test_codec_matches_protobuf():
    pytest.importorskip("google.protobuf")
    from at2_node_tpu_torch.proto import at2_pb2 as pb

    codec = wire.Codec()
    req = dict(sender=b"\x05" * 32, sequence=9, recipient=b"\x06" * 32, amount=12345, signature=b"\x07" * 64)
    assert codec.encode("SendAssetRequest", req) == pb.SendAssetRequest(**req).SerializeToString()
    both = pb.SendAssetBatchRequest(transactions=[pb.SendAssetRequest(**req)] * 2).SerializeToString()
    assert codec.encode("SendAssetBatchRequest", {"transactions": [req, req]}) == both
    reply = pb.GetBalanceReply(amount=99999).SerializeToString()
    assert codec.decode("GetBalanceReply", reply) == {"amount": 99999}

"""The readers of the seam's and the event loop's counters on fixed windows,
and a node's program spans beside the device's work in a trace: they name
the idle gaps and leave the device's readings as they were."""

import json

import pytest

from benchmark.harness import chrome, manifest
from benchmark.harness.window import Window

H100 = "NVIDIA H100 80GB HBM3"


def _trace(tmp_path, name, base_ns, events):
    path = tmp_path / name
    path.write_text(json.dumps({"baseTimeNanoseconds": base_ns, "traceEvents": events}))
    return str(path)


def _read(name, w):
    return manifest.reader(name)(w)


def test_seam_and_loop_readers():
    m0 = {"at2_verifier_seam_queue_s": 10.0, "at2_verifier_seam_taken": 1000.0,
          "at2_verifier_seam_pipeline_s": 20.0, "at2_verifier_seam_resolved": 1000.0,
          "at2_verifier_seam_handback_s": 1.0, "at2_verifier_seam_calls": 100.0,
          "at2_event_loop_busy_ns": 5e9}
    m1 = {"at2_verifier_seam_queue_s": 16.0, "at2_verifier_seam_taken": 3000.0,
          "at2_verifier_seam_pipeline_s": 44.0, "at2_verifier_seam_resolved": 2900.0,
          "at2_verifier_seam_handback_s": 1.5, "at2_verifier_seam_calls": 350.0,
          "at2_event_loop_busy_ns": 11e9}
    m2 = dict(m1, at2_event_loop_busy_ns=9e9)
    w = Window(0.0, 10.0, H100, counters=[(m0, m1), (m0, m2)])
    # 2 x 6 s over 2 x 2,000 taken; 2 x 24 s over 2 x 1,900 resolved; 2 x 0.5 s over 2 x 250 calls
    assert _read("seam_queue_ms.net4", w) == pytest.approx(1e3 * 12.0 / 4000)
    assert _read("seam_pipeline_ms.net4", w) == pytest.approx(1e3 * 48.0 / 3800)
    assert _read("seam_handback_ms.net4", w) == pytest.approx(1e3 * 1.0 / 500)
    # 6 s and 4 s of 10 s busy: the mean of 60% and 40%
    assert _read("loop_busy_pct.net4", w) == pytest.approx(50.0)


@pytest.mark.parametrize("name", ["seam_queue_ms.net4", "seam_pipeline_ms.net4", "seam_handback_ms.net4",
                                  "loop_busy_pct.net4"])
def test_seam_and_loop_readers_without_their_counters(name):
    # the host verifier's nodes (the CPU control) and a parent without the
    # counters export none of them; a window that took nothing reads None too
    cpu = {"at2_verifier_signatures": 100.0}
    assert _read(name, Window(0.0, 10.0, H100, counters=[(cpu, cpu)] * 4)) is None
    idle = {"at2_verifier_seam_taken": 5.0, "at2_verifier_seam_resolved": 5.0, "at2_verifier_seam_calls": 5.0}
    if name != "loop_busy_pct.net4":
        assert _read(name, Window(0.0, 10.0, H100, counters=[(idle, idle)])) is None


def test_program_spans_leave_the_device_reading_and_name_the_gaps(tmp_path):
    base = 1_000_000_000_000_000_000  # ns
    ev = lambda name, cat, ts, dur, tid=1: {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    device = [
        ev("ed25519_verify_kernel", "kernel", 1_000_000, 400_000),     # 1.0-1.4 s
        ev("Memcpy HtoD", "gpu_memcpy", 1_300_000, 200_000),           # 1.3-1.5 s
        ev("ed25519_verify_kernel", "kernel", 2_600_000, 100_000),     # 2.6-2.7 s
    ]
    host = [
        ev("cudaLaunchKernel", "cuda_runtime", 1_550_000, 50_000),     # 1.55-1.6 s
        ev("cudaEventQuery", "cuda_runtime", 1_700_000, 100_000),      # 1.7-1.8 s
    ]
    spans = [
        ev("at2.broadcast.apply", "user_annotation", 1_500_000, 600_000, 2),     # 1.5-2.1 s
        ev("at2.verifier.launch", "user_annotation", 1_540_000, 80_000),         # 1.54-1.62 s
        ev("at2.verifier.launch", "gpu_user_annotation", 1_000_000, 400_000, 7),  # on the device's row
        ev("at2.rpc.gate", "user_annotation", 2_200_000, 100_000, 2),            # 2.2-2.3 s
    ]
    lo = base / 1e9 + 1.0
    plain = chrome.DeviceWindow.from_events(chrome.load(_trace(tmp_path, "p.json", base, device + host)), lo, lo + 2.0)
    traced = chrome.DeviceWindow.from_events(
        chrome.load(_trace(tmp_path, "t.json", base, device + host + spans)), lo, lo + 2.0)
    assert traced.busy_s() == plain.busy_s() == pytest.approx(0.5 + 0.1)
    assert traced.kernel_s("ed25519_verify_kernel") == plain.kernel_s("ed25519_verify_kernel")
    assert traced.top_ops() == plain.top_ops()
    # the 1.5-2.6 s gap was the host's CUDA calls; now the broadcast's span
    assert "cudaEventQuery" in plain.idle_gaps()[0][0]
    gap, seconds = traced.idle_gaps()[0]
    assert seconds == pytest.approx(1.1)
    assert gap.startswith("host: at2.broadcast.apply;") and "ed25519_verify_kernel" in gap
    # the window's tail after the last kernel has no host op at all
    assert any(g.startswith("host: no traced host op;") for g, _ in traced.idle_gaps())

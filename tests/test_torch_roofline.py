"""The Hopper roofline (``ops/roofline.py``): its counts track the port's
kernels, its bounds are the ones ``chip_smoke.py``'s kernels line has
always carried, it scores only a card it has ceilings for, and
``verify_bench`` writes its block on the card and never on the host.
Twin of ``tests/test_roofline.py``, rewritten for the port's counts."""

import contextlib
import os
import re

import numpy as np
import pytest
import torch

from at2_node_tpu.ops import roofline as ref_roofline
from at2_node_tpu_torch.ops import cuda_rlc, cuda_verify, roofline
from at2_node_tpu_torch.ops.aggregate import RLC_PACKED_WIDTH
from at2_node_tpu_torch.ops.ed25519 import PACKED_WIDTH
from at2_node_tpu_torch.tools import _common, verify_bench

H100 = "NVIDIA H100 80GB HBM3"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def h100():
    return roofline.ceilings(H100, 132)


def test_counts_track_kernel_constants():
    # the model derives from the counts the g++ build of the kernels' math
    # is held to (tests/test_torch_kernel_host.py); if the kernel's work
    # changes, the model moves with it (this test is the tripwire)
    assert roofline.FMUL_PER_SIG == cuda_verify.FIELD_MULS_PER_LANE == 3439
    assert cuda_verify.FIELD_SQUARES_PER_LANE == 1550
    assert roofline.INT32_MULADD_SLOTS_PER_SIG == 548_300
    assert roofline.RLC_FMUL_PER_SIG == cuda_rlc.FIELD_MULS_PER_LANE[cuda_rlc.WHOLE] == 8534
    assert cuda_rlc.FIELD_SQUARES_PER_LANE[cuda_rlc.WHOLE] == 3582
    assert roofline.PACKED_ROW_BYTES == PACKED_WIDTH
    assert roofline.RLC_ROW_BYTES == RLC_PACKED_WIDTH
    assert roofline.POINT_BYTES == 160


def test_model_shape_and_sanity(h100):
    m = roofline.model(13_200_000.0, h100)  # K1's device-only rate at 65,536 lanes on the H100
    for key in ("chip_model", "fmul_per_sig", "int32_muladd_slots_per_sig", "achieved_int32_muladd_tops",
                "int32_muladd_peak_tops", "roofline_pct", "int32_muladd_bound_sigs_per_sec",
                "hbm_bound_sigs_per_sec", "compute_vs_memory_bound_ratio"):
        assert key in m
    assert m["chip_model"] == H100 and m["sm_count"] == 132
    assert m["int32_muladd_peak_tops"] == 16.727
    assert 0 < m["roofline_pct"] < 100
    assert m["roofline_pct"] == 43.3
    # operations bound by orders of magnitude: 129 bytes against 548,300
    # issue slots a signature
    assert m["compute_vs_memory_bound_ratio"] > 500
    # the score is linear in the rate (tolerance absorbs rounding)
    assert abs(roofline.model(2 * 13_200_000.0, h100)["roofline_pct"] - 2 * m["roofline_pct"]) < 0.2
    r = roofline.model_rlc(65536 / 11.341e-3, h100)
    assert r["rlc_vs_per_sig_op_ratio"] == 2.52
    assert r["roofline_pct"] == 47.8


def test_bounds_are_the_kernels_lines(h100):
    """The numbers chip_smoke.py's kernels line has carried since PR 7."""
    ms, by = roofline.bound_ms(65536, h100)
    assert (round(ms, 3), by) == (2.148, "operations")
    assert [round(roofline.bound_ms(n, h100)[0], 4) for n in (8192, 4096, 1024, 256, 64)] == [
        0.2685, 0.1343, 0.0336, 0.0084, 0.0021]
    b = roofline.rlc_bounds(65536, 4096, h100)
    assert round(b["ed25519_rlc_lanes"][0], 3) == 5.431
    assert round(b["ed25519_rlc_fold"][0], 4) == 0.0004
    assert b["ed25519_rlc_lanes"][1] == b["ed25519_rlc_fold"][1] == "operations"
    # the bound is the larger of the two: with no issue rate to speak of
    # the bytes bound it
    slow_bytes = roofline.Card(H100, 132, 1.98e9, 1e6)
    assert roofline.bound_ms(64, slow_bytes)[1] == "bytes"


def test_chip_smoke_keeps_no_ceiling_of_its_own():
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        text = f.read()
    assert not re.search(r"H100_\w+\s*=|3\.35e12|132 \* 64|def bound_ms|def rlc_bounds", text)
    assert "roofline.bound_ms(" in text and "roofline.rlc_bounds(" in text


def test_a_card_without_ceilings_raises(monkeypatch):
    with pytest.raises(ValueError, match="no roofline ceilings"):
        roofline.ceilings("NVIDIA A100-SXM4-80GB", 108)

    class Props:
        name, multi_processor_count = "NVIDIA A100-SXM4-80GB", 108

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda dev: Props)
    with pytest.raises(ValueError, match="no roofline ceilings"):
        roofline.card_of("cuda:0")
    with pytest.raises(ValueError, match="CUDA device"):
        roofline.card_of("cpu")
    Props.name, Props.multi_processor_count = H100, 132
    card = roofline.card_of("cuda:0")
    assert card.sm_count == 132 and card.int32_muladd_per_s == pytest.approx(16.727e12, rel=1e-4)


def _fake_bucket(bucket, dev, trials, card, workers):
    line = {"bucket": bucket, "device_only": 13_200_000.0, "pipelined": 1_400_000.0,
            "device": dev.type, "card": card}
    return line, np.full((bucket + 7) // 8, 0xFF, dtype=np.uint8)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_verify_bench_writes_the_roofline_block_only_on_the_card(device, monkeypatch):
    """On the card the result carries ``roofline`` = the model of the
    headline bucket's device-only rate on the card's ceilings; on the host
    no such block. The measurement is stubbed: what is tested is the
    result's assembly."""
    monkeypatch.setattr(verify_bench, "measure_bucket", _fake_bucket)
    if device == "cuda":
        monkeypatch.setattr(_common, "tool_device", lambda d, flag="--device cpu": torch.device("cuda", 0))
        monkeypatch.setattr(_common, "card_stamp", lambda d: f"{H100}, 700.00 W")
        monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
        monkeypatch.setattr(roofline, "card_of", lambda d=None: roofline.ceilings(H100, 132))
    result, _ = verify_bench.run(device, grid=(65536, 1024), trials=1)
    if device == "cuda":
        assert result["roofline"] == roofline.model(13_200_000.0, roofline.ceilings(H100, 132))
        assert result["roofline"]["roofline_pct"] == 43.3
    else:
        assert "roofline" not in result


def test_both_models_read_the_same_rows_and_scale_alike(h100):
    """Differential against the reference's model on the same seeded rates:
    the same rows are charged (129 bytes in, 161 for RLC), the keys that
    mean the same thing are in both, both scores are linear in the rate,
    and both put the RLC lane above the per-signature lane's work."""
    assert ref_roofline.BYTES_PER_SIG - 1 == roofline.PACKED_ROW_BYTES
    assert ref_roofline.RLC_BYTES_PER_SIG - 1 == roofline.RLC_ROW_BYTES
    rates = np.random.default_rng(12).uniform(1e5, 2e7, size=8)
    shared = {"chip_model", "fmul_per_sig", "roofline_pct", "hbm_bound_sigs_per_sec",
              "compute_vs_memory_bound_ratio"}
    for rate in rates:
        mine, ref = roofline.model(rate, h100), ref_roofline.model(rate)
        assert shared <= set(mine) & set(ref)
        for model, base in ((roofline.model(2 * rate, h100), mine), (ref_roofline.model(2 * rate), ref)):
            assert abs(model["roofline_pct"] - 2 * base["roofline_pct"]) < 0.2
        assert "rlc_vs_per_sig_op_ratio" in roofline.model_rlc(rate, h100)
    assert roofline.model_rlc(1.0, h100)["rlc_vs_per_sig_op_ratio"] > 1
    assert ref_roofline.model_rlc(1.0)["rlc_vs_per_sig_op_ratio"] > 1

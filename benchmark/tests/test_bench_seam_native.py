"""The reader of the native seam's share of a window's batches."""

import pytest

from benchmark.harness import manifest
from benchmark.harness.window import Window

H100 = "NVIDIA H100 80GB HBM3"


def _read(w):
    return manifest.reader("seam_native_pct.net4")(w)


def test_seam_native_share_sums_the_nodes():
    m0 = {"at2_verifier_batches": 100.0, "at2_verifier_native_batches": 90.0}
    m1 = {"at2_verifier_batches": 1100.0, "at2_verifier_native_batches": 1090.0}
    m2 = {"at2_verifier_batches": 600.0, "at2_verifier_native_batches": 540.0}
    # 1,000 of 1,000 and 450 of 500 batches: 1,450 of 1,500
    w = Window(0.0, 10.0, H100, counters=[(m0, m1), (m0, m2)])
    assert _read(w) == pytest.approx(100.0 * 1450 / 1500)


def test_seam_native_share_without_its_counter():
    # the parent and the host verifier's nodes export batches, not the native counter
    parent0, parent1 = {"at2_verifier_batches": 10.0}, {"at2_verifier_batches": 500.0}
    assert _read(Window(0.0, 10.0, H100, counters=[(parent0, parent1)] * 4)) is None
    # a window that resolved no batch
    idle = {"at2_verifier_batches": 7.0, "at2_verifier_native_batches": 7.0}
    assert _read(Window(0.0, 10.0, H100, counters=[(idle, idle)] * 4)) is None

"""Differential tests: the port's Edwards point arithmetic (plain PyTorch)
against the JAX package's ``ops.edwards`` and its python-int oracle.
Points are compared as affine python ints: exact."""

import numpy as np
import pytest
import torch

import jax

from at2_node_tpu.ops import ed25519 as ref_v
from at2_node_tpu.ops import edwards as ref
from at2_node_tpu.ops import field as ref_fe
from at2_node_tpu_torch import convert
from at2_node_tpu_torch.ops import ed25519 as v
from at2_node_tpu_torch.ops import edwards as ed
from at2_node_tpu_torch.ops import field as fe

# These tensors are small: more intra-op threads only spin, and take
# cores from the tests that run beside these in other processes.
torch.set_num_threads(1)

RNG = np.random.default_rng(0xED7)
B = (ref.BX_INT, ref.BY_INT)


def scalar_mult_ints(k, point):
    acc = (0, 1)
    while k:
        if k & 1:
            acc = ref.affine_add_ints(acc, point)
        point = ref.affine_add_ints(point, point)
        k >>= 1
    return acc


def port_affine(t):
    return [ed.point_to_ints(row) for row in t.numpy()]


def ref_affine(a):
    a = np.asarray(a)
    return [ref.point_to_ints(a[i]) for i in range(a.shape[0])]


def compress(x, y):
    return np.frombuffer((y | ((x & 1) << 255)).to_bytes(32, "little"), np.uint8)


KS = [1, 2, 5, 77, 2**31, ref_v.L - 1]
PTS = [scalar_mult_ints(k, B) for k in KS]


def test_base_point_and_constants_match_reference():
    assert (ed.BX_INT, ed.BY_INT) == B
    assert ed.point_to_ints(ed.BASE) == ref.point_to_ints(ref.BASE) == B
    assert ed.point_to_ints(ed.IDENTITY) == (0, 1)


def test_base_table_matches_reference():
    assert ed.BASE_TABLE.shape == (16, 4, fe.N_LIMBS)
    from_ref = convert.points_from_reference(ref.BASE_TABLE)
    for k in range(16):
        assert ed.point_to_ints(ed.BASE_TABLE[k]) == ref.point_to_ints(ref.BASE_TABLE[k])
        assert ed.point_to_ints(from_ref[k].numpy()) == scalar_mult_ints(k, B)


def test_add_double_negate_match_reference():
    port = torch.from_numpy(np.stack([ed.point_from_ints(*p) for p in PTS]))
    refp = np.stack([ref.point_from_ints(*p) for p in PTS])
    assert port_affine(ed.double(port)) == ref_affine(jax.jit(ref.double)(refp)) == [
        ref.affine_add_ints(p, p) for p in PTS
    ]
    base = torch.from_numpy(ed.BASE)
    assert port_affine(ed.add(port, base)) == ref_affine(jax.jit(ref.add)(refp, ref.BASE)) == [
        ref.affine_add_ints(p, B) for p in PTS
    ]
    assert port_affine(ed.add(port, torch.from_numpy(ed.IDENTITY))) == PTS
    neg = ed.negate(port)
    assert port_affine(neg) == ref_affine(jax.jit(ref.negate)(refp)) == [
        ((-x) % fe.P, y) for x, y in PTS
    ]
    assert port_affine(ed.add(port, neg)) == [(0, 1)] * len(PTS)


def test_decompress_valid_points():
    raw = np.stack([compress(*p) for p in PTS])
    point, ok = ed.decompress(torch.from_numpy(raw))
    ref_point, ref_ok = jax.jit(ref.decompress)(raw)
    assert ok.all() and np.asarray(ref_ok).all()
    assert port_affine(point) == ref_affine(ref_point) == PTS


def _bad_encodings():
    bad = np.zeros((6, 32), dtype=np.uint8)
    bad[0] = np.frombuffer(fe.P.to_bytes(32, "little"), np.uint8)  # y = p
    bad[1] = np.frombuffer(((1 << 255) - 1).to_bytes(32, "little"), np.uint8)
    bad[1, 31] &= 0x7F  # y = 2^255 - 1 >= p, sign 0
    bad[2, 0] = 2  # y = 2: x^2 is not a square
    bad[3] = np.frombuffer((fe.P + 1).to_bytes(32, "little"), np.uint8)  # y = p + 1
    bad[4, 0] = 1
    bad[4, 31] = 0x80  # y = 1 (x = 0) with the sign bit set
    bad[5, 0] = 1  # y = 1, sign 0: the identity, valid
    return bad


def test_decompress_rejections_match_reference():
    bad = _bad_encodings()
    point, ok = ed.decompress(torch.from_numpy(bad))
    ref_point, ref_ok = jax.jit(ref.decompress)(bad)
    assert ok.tolist() == np.asarray(ref_ok).tolist()
    y = 2
    x2 = (y * y - 1) * pow(fe.D_INT * y * y + 1, fe.P - 2, fe.P) % fe.P
    y2_square = pow(x2, (fe.P - 1) // 2, fe.P) == 1
    assert ok.tolist() == [False, False, y2_square, False, False, True]
    # rejected lanes carry the base point, so downstream math stays finite
    for i, good in enumerate(ok.tolist()):
        if not good:
            assert ed.point_to_ints(point[i].numpy()) == B
    assert port_affine(point) == ref_affine(ref_point)


def test_build_table_multiples():
    port = torch.from_numpy(np.stack([ed.point_from_ints(*p) for p in PTS[:3]]))
    table = ed.build_table(port)
    assert table.shape == (3, 16, 4, fe.N_LIMBS)
    for i, p in enumerate(PTS[:3]):
        assert port_affine(table[i]) == [scalar_mult_ints(k, p) for k in range(16)]


def test_double_scalar_mul_vs_base_8_lanes():
    a_ks = [int.from_bytes(RNG.bytes(32), "little") % ref_v.L for _ in range(8)]
    b_ks = [int.from_bytes(RNG.bytes(32), "little") % ref_v.L for _ in range(8)]
    a_ks[0], b_ks[0] = 0, 0
    a_pts = [scalar_mult_ints(int(RNG.integers(1, 1000)), B) for _ in range(8)]
    a = torch.from_numpy(np.stack([ed.point_from_ints(*p) for p in a_pts]))

    def windows(ks):
        raw = np.stack([np.frombuffer(k.to_bytes(32, "little"), np.uint8) for k in ks])
        port_w = v.windows_msb_first(torch.from_numpy(raw))
        assert port_w.numpy().tolist() == ref_v._windows_msb_first(raw).tolist()
        return port_w

    out = ed.double_scalar_mul_vs_base(a, windows(a_ks), windows(b_ks))
    assert port_affine(out) == [
        ref.affine_add_ints(scalar_mult_ints(ka, p), scalar_mult_ints(kb, B))
        for ka, kb, p in zip(a_ks, b_ks, a_pts)
    ]


def test_equals_affine():
    port = torch.from_numpy(np.stack([ed.point_from_ints(*p) for p in PTS]))
    projective = ed.double(ed.add(port, torch.from_numpy(ed.IDENTITY)))  # Z != 1
    doubled = [ref.affine_add_ints(p, p) for p in PTS]
    xs = torch.from_numpy(np.stack([fe.int_to_limbs(x) for x, _ in doubled]))
    ys = torch.from_numpy(np.stack([fe.int_to_limbs(y) for _, y in doubled]))
    assert ed.equals_affine(projective, xs, ys).all()
    assert not ed.equals_affine(projective, ys, xs).any()


def test_points_from_reference_checks_shape():
    with pytest.raises(ValueError):
        convert.points_from_reference(np.zeros((16, 4, 10), np.int32))
    pts = convert.points_from_reference(np.stack([ref.BASE, ref.IDENTITY]))
    assert port_affine(pts) == [B, (0, 1)]
    assert ref_fe.limbs_to_int(convert.limbs_to_reference(pts[0, 0])) == B[0]

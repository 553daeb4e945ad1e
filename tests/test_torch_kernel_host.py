"""The CUDA kernel's math, built with g++ and run on the CPU.

``csrc/ed25519_lane.cuh`` is what every kernel thread runs; here the same
header is compiled by g++ (``csrc/ed25519_lane_host.cpp``) into a ctypes
library, with a host quad running the four thread roles of a signature in
lockstep, and held against the port's plain PyTorch version and the JAX
package: verdicts, field operations and point operations must agree, and
the operations it counts must be the ones the kernel's bound charges. The
``__global__`` wrapper and its bitmask epilogue need the card and are
checked by ``chip_smoke.py``.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from at2_node_tpu.ops import ed25519 as ref_v
from at2_node_tpu_torch.crypto import _fallback as fb
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.native._build import compile_lib
from at2_node_tpu_torch.ops import aggregate as agg
from at2_node_tpu_torch.ops import cuda_rlc, cuda_verify
from at2_node_tpu_torch.ops import ed25519 as v
from at2_node_tpu_torch.ops import edwards as ed
from at2_node_tpu_torch.ops import field as fe

# These tensors are small: more intra-op threads only spin, and take
# cores from the tests that run beside these in other processes.
torch.set_num_threads(1)

RNG = np.random.default_rng(0xC0DA)
OPS = {"mul": 0, "add": 1, "sub": 2, "canonical": 3, "pow22523": 4, "sq": 5}
POINT_OPS = {"double": 0, "add_cached": 1}


@pytest.fixture(scope="module")
def lane_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the lane math cannot be built on the host")
    return _lane_lib()


def _lane_lib():
    path, _ = compile_lib(
        ("g++", "-O2", "-shared", "-fPIC", "-std=c++17"),
        ["csrc/ed25519_lane_host.cpp"],
        "libed25519_lane_host.so",
        ["csrc/ed25519_lane.cuh"],
    )
    lib = ctypes.CDLL(path)
    lib.ed25519_lane_verify_rows.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    lib.ed25519_lane_verify_rows.restype = None
    lib.ed25519_lane_fe_op.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
    ]
    lib.ed25519_lane_fe_op.restype = None
    lib.ed25519_quad_point_op.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p,
    ]
    lib.ed25519_quad_point_op.restype = None
    lib.ed25519_lane_take_counts.argtypes = [ctypes.c_void_p]
    lib.ed25519_lane_take_counts.restype = None
    lib.ed25519_lane_recode.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    lib.ed25519_lane_recode.restype = None
    lib.ed25519_lane_rlc_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.ed25519_lane_rlc_rows.restype = None
    return lib


def _take_counts(lib):
    """(field multiplications, squarings, 32x32->64-bit products) counted
    since the last take."""
    out = np.zeros(3, dtype=np.int64)
    lib.ed25519_lane_take_counts(out.ctypes.data)
    return tuple(int(x) for x in out)


def _host_verdicts(lib, rows):
    got = np.zeros(len(rows), dtype=np.uint8)
    consts = cuda_verify.lane_consts()
    lib.ed25519_lane_verify_rows(rows.ctypes.data, len(rows), consts.ctypes.data, got.ctypes.data)
    return got


def _lanes(n=64):
    """n seeded lanes: valid transfers-like messages and every tamper kind."""
    items, names = [], []
    for i in range(n):
        kp = SignKeyPair(RNG.bytes(32))
        msg = RNG.bytes(int(RNG.integers(0, 80)))
        sig = kp.sign(msg)
        kind = i % 8
        if kind == 1:
            sig = bytes([sig[0] ^ 1]) + sig[1:]
        elif kind == 2:
            sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
        elif kind == 3:
            msg = msg + b"!"
        elif kind == 4:  # small-order A: canonical (verifies), y = p + 1, x = 0 with sign
            r = int.from_bytes(RNG.bytes(32), "little") % v.L
            enc = [(1).to_bytes(32, "little"), (fe.P + 1).to_bytes(32, "little"),
                   (1 | 1 << 255).to_bytes(32, "little")][(i // 8) % 3]
            items.append((enc, msg, fb._pt_compress(fb._pt_mul(r, fb._BASE)) + r.to_bytes(32, "little")))
            names.append(kind)
            continue
        elif kind == 5:
            kp = SignKeyPair(RNG.bytes(32))  # wrong key
        items.append((kp.public, msg, sig))
        names.append(kind)
    return items


ITEMS = _lanes(64)


def _rows(items):
    rows = np.empty((len(items), v.PACKED_WIDTH), dtype=np.uint8)
    v.fill_packed(*[list(x) for x in zip(*items)], rows)
    return rows


def test_lane_verdicts_match_plain_version(lane_lib):
    """The host quad's verdicts equal the plain version's on 64 seeded
    lanes of every tamper kind, a padding lane among them."""
    rows = _rows(ITEMS)
    rows[7, 128] = 0  # a padding lane
    got = _host_verdicts(lane_lib, rows)
    plain = np.unpackbits(v.verify_packed(torch.from_numpy(rows)).numpy(), count=len(ITEMS))
    assert got.tolist() == plain.tolist()
    assert got[7] == 0
    assert 20 < int(got.sum()) < 50


def test_quad_verdicts_match_reference():
    """The host quad's verdicts equal the JAX package's verify_batch on the
    same 64 lanes (its 64-lane bucket, so the compile is shared)."""
    pytest.importorskip("jax")
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the lane math cannot be built on the host")
    lib = _lane_lib()
    got = _host_verdicts(lib, _rows(ITEMS))
    want = ref_v.verify_batch(*[list(x) for x in zip(*ITEMS)])
    assert got.astype(bool).tolist() == np.asarray(want).tolist()


def test_operation_counts_follow_the_kernel(lane_lib):
    """The field multiplications, squarings and products one signature's
    verification uses in the kernel, as the g++ build counts them, are the
    constants the bound charges."""
    rows = _rows(ITEMS[:1])
    _take_counts(lane_lib)
    _host_verdicts(lane_lib, rows)
    muls, squares, products = _take_counts(lane_lib)
    assert muls == cuda_verify.FIELD_MULS_PER_LANE == 3439
    assert squares == cuda_verify.FIELD_SQUARES_PER_LANE == 1550
    assert 2 * products == cuda_verify.INT32_MULADD_SLOTS_PER_LANE


def _limbs(n):
    vals = [int.from_bytes(RNG.bytes(40), "little") % fe.P for _ in range(n - 3)]
    vals += [0, fe.P - 1, 1]
    arr = np.stack([fe.int_to_limbs(x) for x in vals])
    arr[-1] = [(1 << int(w)) + (1 << 18) for w in fe.WIDTHS]  # the top of invariant W
    return arr


@pytest.mark.parametrize("op", list(OPS))
def test_field_ops_match_plain_version(lane_lib, op):
    a, b = _limbs(40), _limbs(40)[::-1].copy()
    out = np.zeros_like(a, dtype=np.int32)
    a32, b32 = a.astype(np.int32), b.astype(np.int32)
    lane_lib.ed25519_lane_fe_op(OPS[op], a32.ctypes.data, b32.ctypes.data, len(a), out.ctypes.data)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    plain = {
        "mul": lambda: fe.mul(ta, tb),
        "add": lambda: fe.add(ta, tb),
        "sub": lambda: fe.sub(ta, tb),
        "canonical": lambda: fe.canonical(ta),
        "pow22523": lambda: fe.pow22523(ta),
        "sq": lambda: fe.square(ta),
    }[op]().numpy()
    # same formulas, same carries: the limbs themselves agree, not only mod p
    assert out.astype(np.int64).tolist() == plain.tolist()


LAZY_OPS = {
    6: lambda a, b: (a - b) * (b - a), 7: lambda a, b: (a + b) ** 2,
    8: lambda a, b: (a + b) * (a - b), 9: lambda a, b: a, 10: lambda a, b: a + b,
}


@pytest.mark.parametrize("op", list(LAZY_OPS))
def test_uncarried_operands_stay_exact(lane_lib, op):
    """Products of uncarried sums and differences, inputs at the top of
    invariant W among them, are exact mod p and come back inside W."""
    a, b = _limbs(40), _limbs(40)[::-1].copy()
    a[0] = b[0] = a[-1]  # both operands at the top of W
    out = np.zeros_like(a, dtype=np.int32)
    a32, b32 = a.astype(np.int32), b.astype(np.int32)
    lane_lib.ed25519_lane_fe_op(op, a32.ctypes.data, b32.ctypes.data, len(a), out.ctypes.data)
    for x, y, z in zip(a, b, out):
        assert fe.limbs_to_int(z) == LAZY_OPS[op](fe.limbs_to_int(x), fe.limbs_to_int(y)) % fe.P
        assert all(0 <= int(z[i]) <= (1 << int(fe.WIDTHS[i])) + (1 << 18) for i in range(fe.N_LIMBS))


def test_fe_sq_is_fe_mul_limb_for_limb(lane_lib):
    """fe_sq's 55 products give the limbs of fe_mul(a, a) and of the plain
    fe.square exactly, inputs at the top of invariant W included."""
    a = _limbs(64).astype(np.int32)
    sq, mul = np.zeros_like(a), np.zeros_like(a)
    _take_counts(lane_lib)
    lane_lib.ed25519_lane_fe_op(OPS["sq"], a.ctypes.data, a.ctypes.data, 1, sq.ctypes.data)
    assert _take_counts(lane_lib) == (1, 1, 55)
    lane_lib.ed25519_lane_fe_op(OPS["mul"], a.ctypes.data, a.ctypes.data, 1, mul.ctypes.data)
    assert _take_counts(lane_lib) == (1, 0, 100)
    lane_lib.ed25519_lane_fe_op(OPS["sq"], a.ctypes.data, a.ctypes.data, len(a), sq.ctypes.data)
    lane_lib.ed25519_lane_fe_op(OPS["mul"], a.ctypes.data, a.ctypes.data, len(a), mul.ctypes.data)
    assert sq.tolist() == mul.tolist()
    assert sq.astype(np.int64).tolist() == fe.square(torch.from_numpy(a.astype(np.int64))).tolist()


def _points(n):
    """n extended points (python ints), random multiples of B with a random
    projective scale, the identity and B among them."""
    pts = [fb._IDENT, fb._BASE]
    for _ in range(n - 2):
        p = fb._pt_mul(int.from_bytes(RNG.bytes(32), "little") % v.L, fb._BASE)
        z = int.from_bytes(RNG.bytes(32), "little") % (fe.P - 1) + 1
        pts.append(tuple(c * z % fe.P for c in p))
    return np.stack([np.stack([fe.int_to_limbs(c) for c in p]) for p in pts])


@pytest.mark.parametrize("op", list(POINT_OPS))
def test_quad_point_ops_match_plain_version(lane_lib, op):
    """Quad doubling and cached addition equal ops/edwards.py's double and
    add after canonical reduction of X/Z and Y/Z."""
    p, q = _points(24), _points(24)[::-1].copy()
    out = np.zeros_like(p, dtype=np.int32)
    p32, q32 = p.astype(np.int32), q.astype(np.int32)
    consts = cuda_verify.lane_consts()
    lane_lib.ed25519_quad_point_op(POINT_OPS[op], p32.ctypes.data, q32.ctypes.data,
                                   consts.ctypes.data, len(p), out.ctypes.data)
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    plain = (ed.double(tp) if op == "double" else ed.add(tp, tq)).numpy()
    assert [ed.point_to_ints(x) for x in out] == [ed.point_to_ints(x) for x in plain]


@pytest.mark.parametrize("bits", [4, 8])
def test_signed_recoding_reconstructs_scalars(lane_lib, bits):
    """h (radix 16) and S (radix 256) recode into signed digits in
    [-2^(bits-1), 2^(bits-1) - 1] and a carry that give back the scalar
    exactly, up to L - 1 with a zero carry, and every 256-bit value with
    the carry."""
    small = [0, 1, 8, 0x88, v.L - 1, 1 << 252, (1 << 253) - 1]
    small += [int.from_bytes(RNG.bytes(32), "little") % v.L for _ in range(32)]
    big = [(1 << 256) - 1, (1 << 255) + 7, int.from_bytes(RNG.bytes(32), "little")]
    vals = small + big
    raw = np.frombuffer(b"".join(x.to_bytes(32, "little") for x in vals), dtype=np.uint8)
    m, half = 256 // bits, 1 << (bits - 1)
    out = np.zeros((len(vals), m + 1), dtype=np.int16)
    lane_lib.ed25519_lane_recode(raw.ctypes.data, len(vals), bits, out.ctypes.data)
    for x, d in zip(vals, out.astype(int)):
        assert d[:m].min() >= -half and d[:m].max() < half and d[m] in (0, 1)
        assert sum(int(di) << (bits * i) for i, di in enumerate(d)) == x
    assert not out[: len(small), m].any()


def test_lane_consts_layout():
    consts = cuda_verify.lane_consts()
    assert consts.dtype == np.int32 and consts.shape == (50 + 129 * 4 * fe.N_LIMBS,)
    assert fe.limbs_to_int(consts[0:10]) == fe.D_INT
    assert fe.limbs_to_int(consts[10:20]) == 2 * fe.D_INT % fe.P
    assert fe.limbs_to_int(consts[20:30]) == fe.SQRT_M1_INT
    assert (fe.limbs_to_int(consts[30:40]), fe.limbs_to_int(consts[40:50])) == (ed.BX_INT, ed.BY_INT)
    # the base table in cached form, limb-major: (entry, limb, component)
    table = consts[50:].reshape(129, fe.N_LIMBS, 4)
    for e in (0, 1, 7, 15, 128):
        big_x, big_y, big_z, _ = fb._pt_mul(e, fb._BASE)
        zinv = pow(big_z, fe.P - 2, fe.P)
        x, y = big_x * zinv % fe.P, big_y * zinv % fe.P
        comps = [fe.limbs_to_int(table[e, :, k]) for k in range(4)]
        assert comps == [(y - x) % fe.P, (y + x) % fe.P, 2, 2 * fe.D_INT * x * y % fe.P]


# -- the RLC lane (csrc/ed25519_lane.cuh quad_rlc) --------------------------


def _torsion_point():
    """An extended point of order 8: [L]Q for a curve point Q off the
    subgroup."""
    for y in range(2, 60):
        try:
            q = fb._pt_decompress(y.to_bytes(32, "little"))
        except Exception:
            continue
        t = fb._pt_mul(v.L, q)
        if not fb._pt_equal(t, fb._IDENT):
            return t
    raise AssertionError("no torsion point found")


def _rlc_lanes():
    """ITEMS' first 16 lanes (every tamper kind, the crafted encodings of A
    among them) and four torsion lanes: R = [r]B + T with S = r + h a (code
    0), and A' = [a]B + T (code 2), two of each."""
    items = list(ITEMS[:16])
    t = _torsion_point()
    for i in range(4):
        a, r = (int.from_bytes(RNG.bytes(32), "little") % v.L for _ in range(2))
        big_a, big_r = fb._pt_mul(a, fb._BASE), fb._pt_mul(r, fb._BASE)
        if i % 2:
            big_a = fb._pt_add(big_a, t)
        else:
            big_r = fb._pt_add(big_r, t)
        a_enc, r_enc, msg = fb._pt_compress(big_a), fb._pt_compress(big_r), b"torsion %d" % i
        s = (r + fb._sha512_int(r_enc, a_enc, msg) % v.L * a) % v.L
        items.append((a_enc, msg, r_enc + s.to_bytes(32, "little")))
    return items


def _rlc_rows(items, bucket):
    z = [int.from_bytes(RNG.bytes(16), "little") | 1 for _ in range(bucket)]
    return agg.rlc_prep(*[list(x) for x in zip(*items)], bucket, _z_override=z).numpy().copy()


def _host_rlc(lib, rows):
    codes = np.zeros(len(rows), dtype=np.uint8)
    residuals = np.zeros((len(rows), 4, fe.N_LIMBS), dtype=np.int32)
    consts = cuda_verify.lane_consts()  # held: ctypes takes only its address
    lib.ed25519_lane_rlc_rows(rows.ctypes.data, len(rows), consts.ctypes.data,
                              codes.ctypes.data, residuals.ctypes.data)
    return codes, residuals


def test_rlc_lane_codes_and_residuals_match_plain_version(lane_lib):
    """The host quad's RLC lane gives the plain version's codes on 20 lanes
    of every tamper kind and both torsion kinds, two padding lanes among
    them, and its residual [z]R + [zh]A - [zs]B (unmasked) equals the plain
    rlc_residuals after canonical reduction on every lane."""
    rows = _rlc_rows(_rlc_lanes(), 22)
    codes, residuals = _host_rlc(lane_lib, rows)
    t = torch.from_numpy(rows)
    _, plain_codes = agg.rlc_graph_packed_plain(t)
    assert codes.tolist() == plain_codes.tolist()
    assert codes[16:20].tolist() == [0, 2, 0, 2] and codes[20:].tolist() == [0, 0]
    assert sorted(set(codes.tolist())) == [0, 1, 2]
    a_point, _ = ed.decompress(t[:, :32])
    r_point, _ = ed.decompress(t[:, 32:64])
    w = [v.windows_msb_first(t[:, o:o + 32]) for o in (64, 96, 128)]
    plain = agg.rlc_residuals(r_point, a_point, *w).numpy()
    assert [ed.point_to_ints(x) for x in residuals] == [ed.point_to_ints(x) for x in plain]
    # a valid signature's residual is the identity, a tampered one's is not
    ok = np.unpackbits(v.verify_packed(torch.from_numpy(_rows(ITEMS[:16]))).numpy(), count=16)
    for i in range(16):
        assert (ed.point_to_ints(residuals[i]) == (0, 1)) == bool(ok[i]) or codes[i] != 1


def test_rlc_operation_counts_follow_the_kernel(lane_lib):
    """The field multiplications, squarings and products one RLC lane uses
    in the kernel, as the g++ build counts them, are the constants the
    bound charges."""
    rows = _rlc_rows(ITEMS[:1], 1)
    _take_counts(lane_lib)
    _host_rlc(lane_lib, rows)
    muls, squares, products = _take_counts(lane_lib)
    assert muls == cuda_rlc.FIELD_MULS_PER_LANE == 8534
    assert squares == cuda_rlc.FIELD_SQUARES_PER_LANE == 3582
    assert 2 * products == cuda_rlc.INT32_MULADD_SLOTS_PER_LANE


def test_l_digits_and_the_torsion_check(lane_lib):
    """[L] of the kernel's Horner: a lane whose R is a pure 8-torsion point
    (order 8, so [L]R = [5]R is not the identity) gets code 0, and one whose
    R is the identity encoding (torsion-free) does not."""
    t = _torsion_point()
    base = ITEMS[0]
    r_torsion = fb._pt_compress(t) + base[2][32:]
    r_ident = (1).to_bytes(32, "little") + base[2][32:]
    rows = _rlc_rows([(base[0], base[1], r_torsion), (base[0], base[1], r_ident)], 2)
    codes, _ = _host_rlc(lane_lib, rows)
    assert codes.tolist() == [0, 1]

"""Differential tests: the port's GF(2^255-19) (10 x 25.5-bit int64 limbs,
plain PyTorch) against the JAX package's field (20 x 13-bit limbs) and
python ints. Integer math: every value must match exactly."""

import numpy as np
import pytest
import torch

import jax

from at2_node_tpu.ops import field as ref
from at2_node_tpu_torch import convert
from at2_node_tpu_torch.ops import field as fe

# These tensors are small: more intra-op threads only spin, and take
# cores from the tests that run beside these in other processes.
torch.set_num_threads(1)

RNG = np.random.default_rng(0x70F1E1D)
P = fe.P
N = 64
EDGES = [0, 1, P - 1, P, 2**255 - 1, 2**255 - 20, 19, P + 1]


def rand_ints(n):
    return [int.from_bytes(RNG.bytes(40), "little") % P for _ in range(n)]


def port_batch(ints):
    return torch.from_numpy(np.stack([fe.int_to_limbs(x) for x in ints]))


def ref_batch(ints):
    return np.stack([ref.int_to_limbs(x) for x in ints])


def port_ints(t):
    return [fe.limbs_to_int(row) for row in t.numpy()]


def ref_ints(a):
    a = np.asarray(a)
    return [ref.limbs_to_int(a[i]) for i in range(a.shape[0])]


def limbs_value(row):
    """The exact (unreduced) integer a port limb vector holds."""
    return sum(int(row[i]) << int(fe.OFFSETS[i]) for i in range(fe.N_LIMBS))


XS = rand_ints(N) + EDGES
YS = rand_ints(N + len(EDGES))

_REF_BINARY = {"add": ref.add, "sub": ref.sub, "mul": ref.mul}
_INT_BINARY = {
    "add": lambda x, y: (x + y) % P,
    "sub": lambda x, y: (x - y) % P,
    "mul": lambda x, y: x * y % P,
}


def test_layout_spans_255_bits():
    assert int(fe.WIDTHS.sum()) == 255
    assert list(fe.OFFSETS) == [-(-51 * i // 2) for i in range(fe.N_LIMBS)]  # ceil(25.5 i)


def test_limb_roundtrip():
    assert port_ints(port_batch(XS)) == [x % P for x in XS]


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops_match_reference(op):
    got = port_ints(getattr(fe, op)(port_batch(XS), port_batch(YS)))
    want = ref_ints(jax.jit(_REF_BINARY[op])(ref_batch(XS), ref_batch(YS)))
    assert got == want == [_INT_BINARY[op](x, y) for x, y in zip(XS, YS)]


@pytest.mark.parametrize("op", ["neg", "square"])
def test_unary_ops_match_reference(op):
    got = port_ints(getattr(fe, op)(port_batch(XS)))
    want = ref_ints(jax.jit(getattr(ref, op))(ref_batch(XS)))
    expect = [(-x) % P if op == "neg" else x * x % P for x in XS]
    assert got == want == expect


@pytest.mark.parametrize("op", ["invert", "pow22523"])
def test_exponent_chains_match_reference(op):
    xs = XS[:16] + EDGES
    got = port_ints(getattr(fe, op)(port_batch(xs)))
    want = ref_ints(jax.jit(getattr(ref, op))(ref_batch(xs)))
    exp = P - 2 if op == "invert" else (P - 5) // 8
    assert got == want == [pow(x, exp, P) for x in xs]


def test_canonical_matches_reference_limbs():
    # non-canonical inputs: sums of two values stay unreduced until canonical
    s_port = fe.add(port_batch(XS), port_batch(YS))
    got = fe.canonical(s_port).numpy()
    want = np.asarray(jax.jit(ref.canonical)(jax.jit(ref.add)(ref_batch(XS), ref_batch(YS))))
    for row_port, row_ref, x, y in zip(got, want, XS, YS):
        assert limbs_value(row_port) == (x + y) % P
        assert all(0 <= int(v) < (1 << int(w)) for v, w in zip(row_port, fe.WIDTHS))
        assert convert.limbs_to_reference(torch.from_numpy(row_port)).tolist() == row_ref.tolist()


def test_canonical_at_the_invariant_bound():
    """Every limb at the top of invariant W (2^w + 2^18): the largest value
    any operation hands on; canonical and mul must still be exact."""
    top = np.array([(1 << int(w)) + (1 << 18) for w in fe.WIDTHS], np.int64)
    low = np.zeros(fe.N_LIMBS, np.int64)
    t = torch.from_numpy(np.stack([top, low, top]))
    v = limbs_value(top)
    assert [limbs_value(r) for r in fe.canonical(t).numpy()] == [v % P, 0, v % P]
    assert port_ints(fe.mul(t, t)) == [v * v % P, 0, v * v % P]
    assert port_ints(fe.sub(torch.from_numpy(low[None]), t[:1])) == [(-v) % P]


def test_eq_is_zero():
    a = port_batch(XS)
    b = fe.add(fe.sub(a, port_batch(YS)), port_batch(YS))  # same values, other limbs
    assert fe.eq(a, b).all()
    assert not fe.eq(a, fe.add(a, port_batch([1] * len(XS)))).any()
    zero = fe.is_zero(port_batch(XS)).tolist()
    want = np.asarray(jax.jit(ref.is_zero)(ref_batch(XS))).tolist()
    assert zero == want == [x % P == 0 for x in XS]


def _encodings():
    vals = [int.from_bytes(RNG.bytes(32), "little") for _ in range(16)]
    vals += [P, P + 1, P + 18, 2**255 - 1, 2**256 - 1, 2**255, 0, 1]  # non-canonical included
    return np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in vals]), vals


def test_bytes_to_limbs_matches_reference():
    raw, vals = _encodings()
    got = fe.bytes_to_limbs(torch.from_numpy(raw)).numpy()
    want = np.asarray(jax.jit(ref.bytes_to_limbs)(raw))
    for row, ref_row, v in zip(got, want, vals):
        assert limbs_value(row) == v  # the full 256-bit value, bit 255 kept
        assert ref.limbs_to_int(ref_row) == v % P == limbs_value(row) % P


def test_limbs_to_bytes_matches_reference():
    raw, vals = _encodings()
    got = fe.limbs_to_bytes(fe.bytes_to_limbs(torch.from_numpy(raw))).numpy()
    want = np.asarray(jax.jit(ref.limbs_to_bytes)(jax.jit(ref.bytes_to_limbs)(raw)))
    assert got.tolist() == want.tolist()
    assert [int.from_bytes(r.tobytes(), "little") for r in got] == [v % P for v in vals]


def test_constants_match_reference():
    for name in ("D", "D2", "SQRT_M1", "ONE", "ZERO"):
        assert fe.limbs_to_int(getattr(fe, name)) == ref.limbs_to_int(getattr(ref, name))
    assert fe.D_INT == ref.D_INT and fe.SQRT_M1_INT == ref.SQRT_M1_INT
    assert limbs_value(fe.BIAS_4P) == 4 * P


def test_convert_roundtrip():
    ref_limbs = np.asarray(jax.jit(ref.add)(ref_batch(XS), ref_batch(YS)))  # weakly reduced
    port = convert.limbs_from_reference(ref_limbs)
    assert port.dtype == torch.int64 and port.shape == (len(XS), fe.N_LIMBS)
    assert port_ints(port) == ref_ints(ref_limbs)
    back = convert.limbs_to_reference(port)
    assert back.dtype == np.int32
    assert back.tolist() == np.asarray(jax.jit(ref.canonical)(ref_limbs)).tolist()
    with pytest.raises(ValueError):
        convert.limbs_from_reference(np.zeros((2, 10), np.int32))

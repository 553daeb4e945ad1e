"""The CUDA kernel's per-lane math, built with g++ and run on the CPU.

``csrc/ed25519_lane.cuh`` is what every kernel thread runs; here the same
header is compiled by g++ (``csrc/ed25519_lane_host.cpp``) into a ctypes
library and held against the port's plain PyTorch version: per-lane
verdicts and field operations must agree exactly. The ``__global__``
wrapper and its bitmask epilogue need the card and are checked by
``chip_smoke.py``.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from at2_node_tpu_torch.crypto import _fallback as fb
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.native._build import compile_lib
from at2_node_tpu_torch.ops import cuda_verify
from at2_node_tpu_torch.ops import ed25519 as v
from at2_node_tpu_torch.ops import field as fe

# These tensors are small: more intra-op threads only spin, and take
# cores from the tests that run beside these in other processes.
torch.set_num_threads(1)

RNG = np.random.default_rng(0xC0DA)
OPS = {"mul": 0, "add": 1, "sub": 2, "canonical": 3, "pow22523": 4}


@pytest.fixture(scope="module")
def lane_lib():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the lane math cannot be built on the host")
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
    return lib


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


def test_lane_verdicts_match_plain_version(lane_lib):
    items = _lanes(64)
    rows = np.empty((len(items), v.PACKED_WIDTH), dtype=np.uint8)
    v.fill_packed(*[list(x) for x in zip(*items)], rows)
    rows[7, 128] = 0  # a padding lane
    consts = cuda_verify.lane_consts()
    got = np.zeros(len(items), dtype=np.uint8)
    lane_lib.ed25519_lane_verify_rows(rows.ctypes.data, len(items), consts.ctypes.data, got.ctypes.data)
    plain = np.unpackbits(v.verify_packed(torch.from_numpy(rows)).numpy(), count=len(items))
    assert got.tolist() == plain.tolist()
    assert 20 < int(got.sum()) < 50


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
    }[op]().numpy()
    # same formulas, same carries: the limbs themselves agree, not only mod p
    assert out.astype(np.int64).tolist() == plain.tolist()


def test_lane_consts_layout():
    consts = cuda_verify.lane_consts()
    assert consts.dtype == np.int32 and consts.shape == (30 + 16 * 4 * fe.N_LIMBS,)
    assert fe.limbs_to_int(consts[0:10]) == fe.D_INT
    assert fe.limbs_to_int(consts[10:20]) == 2 * fe.D_INT % fe.P
    assert fe.limbs_to_int(consts[20:30]) == fe.SQRT_M1_INT

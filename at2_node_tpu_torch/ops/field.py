"""GF(2^255 - 19) arithmetic in plain PyTorch, vectorized over batches.

Counterpart of ``at2_node_tpu/ops/field.py``. It is the plain version that
the CUDA kernel (``csrc/ed25519_lane.cuh``) is held against, and the path
the port's entry points take for tensors that lie on the CPU.

Representation
--------------
A field element is 10 limbs in the ref10 layout, 25.5 bits each: limb ``i``
sits at bit ``ceil(25.5 * i)`` and holds 26 bits when ``i`` is even and 25
when it is odd, so the ten limbs span exactly 255 bits. Limbs are held in
``int64`` tensors along the trailing axis (shape ``(..., 10)``), so a
product of two limbs and a sum of ten such products fit without overflow.
The JAX package's 20 x 13-bit int32 limbs exist only because the TPU vector
unit has no 64-bit multiply; the port does not carry that over.

Invariant W, kept by every operation below: every limb lies in
``[0, 2^w + 2^18]`` where ``w`` is the limb's width. Subtraction adds a
limb-wise bias of 4p (as ``_biased_4p`` does in the reference) so limbs
never go negative, and one parallel carry round restores W after an add or
a subtraction. In :func:`mul` a schoolbook product of two W inputs stays
below ``10 * 38 * (2^26 + 2^18)^2 < 2^62`` per output limb, and two
parallel carry rounds restore W.

All functions broadcast over leading batch axes and run on whatever device
their inputs lie on. There is no data-dependent control flow: invalid
encodings are carried as masks, never branches.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

N_LIMBS = 10
P = (1 << 255) - 19

WIDTHS = np.array([26 if i % 2 == 0 else 25 for i in range(N_LIMBS)], np.int64)
OFFSETS = np.concatenate([[0], np.cumsum(WIDTHS)[:-1]]).astype(np.int64)
MASKS = (1 << WIDTHS) - 1


def int_to_limbs(x: int) -> np.ndarray:
    """Host-side: python int -> canonical limb vector (numpy int64)."""
    x %= P
    out = np.zeros(N_LIMBS, dtype=np.int64)
    for i in range(N_LIMBS):
        out[i] = (x >> int(OFFSETS[i])) & int(MASKS[i])
    return out


def limbs_to_int(limbs) -> int:
    """Host-side: one limb vector -> python int mod p."""
    limbs = np.asarray(limbs)
    return sum(int(limbs[..., i]) << int(OFFSETS[i]) for i in range(N_LIMBS)) % P


ZERO = int_to_limbs(0)
ONE = int_to_limbs(1)

D_INT = (-121665 * pow(121666, P - 2, P)) % P  # Edwards d
SQRT_M1_INT = pow(2, (P - 1) // 4, P)  # sqrt(-1)

D = int_to_limbs(D_INT)
D2 = int_to_limbs(2 * D_INT % P)
SQRT_M1 = int_to_limbs(SQRT_M1_INT)

# 4p limb by limb: p's limbs are [2^26-19, 2^25-1, 2^26-1, ...], so every
# limb of 4p is at least 2^27 - 76, above any W limb of the subtrahend.
BIAS_4P = 4 * np.array(
    [int(MASKS[0]) - 18] + [int(m) for m in MASKS[1:]], dtype=np.int64
)
assert sum(int(BIAS_4P[i]) << int(OFFSETS[i]) for i in range(N_LIMBS)) == 4 * P

# A carry out of limb 9 has weight 2^255 = 19 (mod p) and lands in limb 0.
_CARRY_FOLD = np.array([1] * (N_LIMBS - 1) + [19], dtype=np.int64)


def _product_layout() -> tuple[np.ndarray, np.ndarray]:
    """Where product f_i * g_j lands and with what factor: output limb
    (i + j) mod 10, doubled when i and j are both odd (their bit offsets
    round up twice), times 19 when i + j >= 10 (weight 2^255 = 19)."""
    gather = np.zeros((N_LIMBS, N_LIMBS), np.int64)
    coef = np.zeros((N_LIMBS, N_LIMBS), np.int64)
    for k in range(N_LIMBS):
        for i in range(N_LIMBS):
            j = (k - i) % N_LIMBS
            gather[k, i] = i * N_LIMBS + j
            coef[k, i] = (2 if i % 2 and j % 2 else 1) * (19 if i + j >= N_LIMBS else 1)
    return gather, coef


_GATHER, _COEF = _product_layout()

_HOST_CONSTS = {
    "widths": WIDTHS,
    "masks": MASKS,
    "carry_fold": _CARRY_FOLD,
    "gather": _GATHER,
    "coef": _COEF,
    "bias": BIAS_4P,
    "one": ONE,
    "d": D,
    "d2": D2,
    "sqrt_m1": SQRT_M1,
}


@functools.lru_cache(maxsize=None)
def const(name: str, device: torch.device) -> torch.Tensor:
    """A module constant as an int64 tensor on ``device`` (one copy per
    device; the set of names is fixed, so the cache stays small)."""
    return torch.as_tensor(_HOST_CONSTS[name], dtype=torch.int64, device=device)


def _carry(h: torch.Tensor) -> torch.Tensor:
    """One parallel carry round: every limb keeps its low ``w`` bits and
    passes the rest to the next limb; limb 9's carry folds into limb 0."""
    dev = h.device
    c = h >> const("widths", dev)
    h = h & const("masks", dev)
    return h + torch.roll(c * const("carry_fold", dev), 1, dims=-1)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _carry(a - b + const("bias", a.device))


def neg(a: torch.Tensor) -> torch.Tensor:
    return _carry(const("bias", a.device) - a)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook 10 x 10 product with the 19-fold, then two carry rounds."""
    dev = a.device
    prod = (a.unsqueeze(-1) * b.unsqueeze(-2)).flatten(-2)  # (..., 100)
    h = (prod[..., const("gather", dev)] * const("coef", dev)).sum(-1)
    return _carry(_carry(h))


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def _pow2k(x: torch.Tensor, k: int) -> torch.Tensor:
    for _ in range(k):
        x = square(x)
    return x


def _pow_t250(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x^(2^250 - 1), x^11): the shared prefix of the addition chains for
    inversion and for the square root exponent."""
    z2 = square(x)
    z9 = mul(x, _pow2k(z2, 2))
    z11 = mul(z2, z9)
    z_5_0 = mul(z9, square(z11))
    z_10_0 = mul(_pow2k(z_5_0, 5), z_5_0)
    z_20_0 = mul(_pow2k(z_10_0, 10), z_10_0)
    z_40_0 = mul(_pow2k(z_20_0, 20), z_20_0)
    z_50_0 = mul(_pow2k(z_40_0, 10), z_10_0)
    z_100_0 = mul(_pow2k(z_50_0, 50), z_50_0)
    z_200_0 = mul(_pow2k(z_100_0, 100), z_100_0)
    z_250_0 = mul(_pow2k(z_200_0, 50), z_50_0)
    return z_250_0, z11


def invert(x: torch.Tensor) -> torch.Tensor:
    """x^(p-2) (Fermat). invert(0) == 0."""
    z_250_0, z11 = _pow_t250(x)
    return mul(_pow2k(z_250_0, 5), z11)


def pow22523(x: torch.Tensor) -> torch.Tensor:
    """x^((p-5)/8) = x^(2^252 - 3), the square-root exponent (RFC 8032)."""
    z_250_0, _ = _pow_t250(x)
    return mul(_pow2k(z_250_0, 2), x)


def canonical(x: torch.Tensor) -> torch.Tensor:
    """The unique representative in [0, p), limbs exact.

    ref10's ``fe_tobytes`` reduction: for W input, q = floor(x / p) is 0 or
    1 and is found by running the carry of x + 19 through every limb; then
    x + 19q, carried exactly and cut to 255 bits, is x - qp. Two carry
    rounds first bring any non-negative limbs below 2^40 (raw bytes with
    bit 255 set, sums of W values) into W."""
    widths = [int(w) for w in WIDTHS]
    limbs = list(_carry(_carry(x)).unbind(-1))
    q = (19 * limbs[9] + (1 << 24)) >> 25
    for i in range(N_LIMBS):
        q = (limbs[i] + q) >> widths[i]
    limbs[0] = limbs[0] + 19 * q
    for i in range(N_LIMBS - 1):
        c = limbs[i] >> widths[i]
        limbs[i] = limbs[i] & int(MASKS[i])
        limbs[i + 1] = limbs[i + 1] + c
    limbs[9] = limbs[9] & int(MASKS[9])
    return torch.stack(limbs, dim=-1)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Field equality -> bool of the batch shape."""
    return (canonical(a) == canonical(b)).all(-1)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (canonical(a) == 0).all(-1)


def bytes_to_limbs(b: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 little-endian -> (..., 10) int64 limbs.

    Bit 255 (the ed25519 sign bit) is NOT masked: limb 9 keeps bits 230-255,
    so the limbs hold the full 256-bit value. Callers that parse compressed
    points clear it first."""
    b = b.to(torch.int64)
    limbs = []
    for i in range(N_LIMBS):
        off = int(OFFSETS[i])
        width = int(WIDTHS[i]) if i < N_LIMBS - 1 else 256 - off
        v = torch.zeros_like(b[..., 0])
        for k in range(off // 8, min(32, (off + width + 7) // 8)):
            shift = 8 * k - off
            v = v | (b[..., k] << shift if shift >= 0 else b[..., k] >> -shift)
        limbs.append(v & ((1 << width) - 1))
    return torch.stack(limbs, dim=-1)


def limbs_to_bytes(x: torch.Tensor) -> torch.Tensor:
    """Field element -> (..., 32) uint8 little-endian canonical encoding."""
    limbs = canonical(x).unbind(-1)
    out = []
    for k in range(32):
        bit = 8 * k
        j = int(np.searchsorted(OFFSETS, bit, side="right")) - 1
        v = limbs[j] >> (bit - int(OFFSETS[j]))
        if j + 1 < N_LIMBS:
            v = v | (limbs[j + 1] << (int(OFFSETS[j + 1]) - bit))
        out.append(v & 0xFF)
    return torch.stack(out, dim=-1).to(torch.uint8)

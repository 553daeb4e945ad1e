"""Batched twisted-Edwards (ed25519) point arithmetic in plain PyTorch.

Counterpart of ``at2_node_tpu/ops/edwards.py``. Curve: -x^2 + y^2 = 1 +
d x^2 y^2 over GF(2^255-19) (a = -1). Points are in extended homogeneous
coordinates (X : Y : Z : T) with T = XY/Z, stacked as one ``(..., 4, 10)``
int64 tensor (4 coordinates x 10 limbs of ``field``).

The formulas are the complete a=-1 addition and the unified doubling
(Hisil-Wong-Carter-Dawson 2008): no special cases and no branches, the same
operations for every batch lane. ``csrc/ed25519_lane.cuh`` runs the same
formulas per lane on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from . import field as fe

# Point layout indices
X, Y, Z, T = 0, 1, 2, 3

# Base point B (RFC 8032): y = 4/5, x recovered with even sign.
_BY = (4 * pow(5, fe.P - 2, fe.P)) % fe.P


def _recover_x(y: int, sign: int) -> int:
    x2 = (y * y - 1) * pow(fe.D_INT * y * y + 1, fe.P - 2, fe.P) % fe.P
    x = pow(x2, (fe.P + 3) // 8, fe.P)
    if (x * x - x2) % fe.P != 0:
        x = x * fe.SQRT_M1_INT % fe.P
    if (x * x - x2) % fe.P != 0:
        raise ValueError("not a square")
    if x & 1 != sign:
        x = fe.P - x
    return x


BX_INT = _recover_x(_BY, 0)
BY_INT = _BY


def point_from_ints(x: int, y: int) -> np.ndarray:
    """Host-side: affine python ints -> extended-coordinate limb array."""
    return np.stack(
        [
            fe.int_to_limbs(x),
            fe.int_to_limbs(y),
            fe.int_to_limbs(1),
            fe.int_to_limbs(x * y % fe.P),
        ]
    )


def point_to_ints(pt) -> tuple[int, int]:
    """Host-side: one extended point -> affine (x, y) python ints."""
    pt = np.asarray(pt)
    x = fe.limbs_to_int(pt[..., X, :])
    y = fe.limbs_to_int(pt[..., Y, :])
    z = fe.limbs_to_int(pt[..., Z, :])
    zinv = pow(z, fe.P - 2, fe.P)
    return x * zinv % fe.P, y * zinv % fe.P


IDENTITY = point_from_ints(0, 1)
BASE = point_from_ints(BX_INT, BY_INT)


def _coords(p: torch.Tensor) -> tuple[torch.Tensor, ...]:
    return p[..., X, :], p[..., Y, :], p[..., Z, :], p[..., T, :]


def _finish(e, f, g, h) -> torch.Tensor:
    return torch.stack([fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h)], dim=-2)


def add(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete extended addition (a=-1), 8M + 1 constant mul."""
    px, py, pz, pt = _coords(p)
    qx, qy, qz, qt = _coords(q)
    a = fe.mul(fe.sub(py, px), fe.sub(qy, qx))
    b = fe.mul(fe.add(py, px), fe.add(qy, qx))
    c = fe.mul(fe.mul(pt, fe.const("d2", p.device)), qt)
    d = fe.mul(fe.add(pz, pz), qz)
    return _finish(fe.sub(b, a), fe.sub(d, c), fe.add(d, c), fe.add(b, a))


def double(p: torch.Tensor) -> torch.Tensor:
    """Unified doubling, 4M + 4S."""
    px, py, pz, _ = _coords(p)
    a = fe.square(px)
    b = fe.square(py)
    zz = fe.square(pz)
    c = fe.add(zz, zz)
    h = fe.add(a, b)
    e = fe.sub(h, fe.square(fe.add(px, py)))
    g = fe.sub(a, b)
    return _finish(e, fe.add(c, g), g, h)


def negate(p: torch.Tensor) -> torch.Tensor:
    """-(X:Y:Z:T) = (-X:Y:Z:-T)."""
    px, py, pz, pt = _coords(p)
    return torch.stack([fe.neg(px), py, pz, fe.neg(pt)], dim=-2)


def decompress(y_bytes: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """RFC 8032 §5.1.3 point decompression, batched and branch-free.

    ``y_bytes``: (..., 32) uint8 little-endian compressed points.
    Returns (point (..., 4, 10), ok (...,) bool). Invalid encodings
    (non-canonical y, non-square x^2, x=0 with sign 1) give ok=False and
    the base point, so the math downstream stays finite and the lane is
    masked out by its ``ok`` bit.
    """
    dev = y_bytes.device
    b = y_bytes.to(torch.int64)
    sign = (b[..., 31] >> 7) & 1
    b = torch.cat([b[..., :31], (b[..., 31:] & 0x7F)], dim=-1)
    y = fe.bytes_to_limbs(b)

    # canonical check: y < p  <=>  y + 19 does not reach bit 255. The limbs
    # of raw bytes are exact, so one sequential carry decides it.
    y19 = y.clone()
    y19[..., 0] += 19
    carry = torch.zeros_like(sign)
    for i in range(fe.N_LIMBS):
        carry = (y19[..., i] + carry) >> int(fe.WIDTHS[i])
    y_canonical = carry == 0

    one = fe.const("one", dev)
    yy = fe.square(y)
    u = fe.sub(yy, one)  # y^2 - 1
    v = fe.add(fe.mul(yy, fe.const("d", dev)), one)  # d y^2 + 1

    # x = u v^3 (u v^7)^((p-5)/8)
    v3 = fe.mul(fe.square(v), v)
    v7 = fe.mul(fe.square(v3), v)
    x = fe.mul(fe.mul(u, v3), fe.pow22523(fe.mul(u, v7)))

    vxx = fe.mul(v, fe.square(x))
    root_ok = fe.eq(vxx, u)
    flipped_ok = fe.eq(vxx, fe.neg(u))
    x = torch.where(root_ok[..., None], x, fe.mul(x, fe.const("sqrt_m1", dev)))
    is_square = root_ok | flipped_ok

    x_can = fe.canonical(x)
    x_is_zero = (x_can == 0).all(-1)
    # x = 0 with sign bit set is invalid (RFC 8032 step 4)
    ok = y_canonical & is_square & ~(x_is_zero & (sign == 1))

    flip = (x_can[..., 0] & 1) != sign
    x = torch.where(flip[..., None], fe.neg(x), x)

    point = torch.stack([x, y, one.expand_as(x), fe.mul(x, y)], dim=-2)
    base = torch.as_tensor(BASE, device=dev)
    return torch.where(ok[..., None, None], point, base), ok


def build_table(p: torch.Tensor) -> torch.Tensor:
    """Multiples 0..15 of p: (..., 16, 4, 10). Evens by doubling, odds by
    one addition (2k = double(k), 2k+1 = 2k + p), as the TPU kernel builds
    its table: 7 doublings and 7 additions."""
    entries = [torch.as_tensor(IDENTITY, device=p.device).expand_as(p), p] + [None] * 14
    for k in range(1, 8):
        entries[2 * k] = double(entries[k])
        entries[2 * k + 1] = add(entries[2 * k], p)
    return torch.stack(entries, dim=-3)


def affine_add_ints(p: tuple[int, int], q: tuple[int, int]) -> tuple[int, int]:
    """Host-side affine twisted-Edwards addition (a=-1) on python ints."""
    (x1, y1), (x2, y2) = p, q
    k = fe.D_INT * x1 % fe.P * x2 % fe.P * y1 % fe.P * y2 % fe.P
    x3 = (x1 * y2 + y1 * x2) * pow(1 + k, fe.P - 2, fe.P) % fe.P
    y3 = (y1 * y2 + x1 * x2) * pow(1 - k, fe.P - 2, fe.P) % fe.P
    return x3, y3


def _base_table() -> np.ndarray:
    acc = (0, 1)
    out = []
    for _ in range(16):
        out.append(point_from_ints(*acc))
        acc = affine_add_ints(acc, (BX_INT, BY_INT))
    return np.stack(out)


BASE_TABLE = _base_table()  # (16, 4, 10): multiples 0..15 of B


def _lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[..., idx, :, :] per batch lane: (..., 16, 4, 10) by (...,)."""
    index = idx[..., None, None, None].expand(*idx.shape, 1, *table.shape[-2:])
    return torch.gather(table, -3, index).squeeze(-3)


def double_scalar_mul_vs_base(
    a_point: torch.Tensor, a_windows: torch.Tensor, b_windows: torch.Tensor
) -> torch.Tensor:
    """[a]A + [b]B by interleaved Straus with 4-bit windows.

    ``a_windows``/``b_windows``: (..., 64) integer tensors, most significant
    window first (window w holds scalar bits [252-4w, 256-4w)). Per window:
    4 doublings, 2 table lookups and 2 additions.
    """
    table_a = build_table(a_point)
    table_b = torch.as_tensor(BASE_TABLE, device=a_point.device)
    acc = torch.as_tensor(IDENTITY, device=a_point.device).expand_as(a_point)
    for w in range(a_windows.shape[-1]):
        acc = double(double(double(double(acc))))
        acc = add(acc, _lookup(table_a, a_windows[..., w]))
        acc = add(acc, table_b[b_windows[..., w]])
    return acc


def equals_affine(p: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Projective point == affine (x, y): X == x*Z and Y == y*Z."""
    px, py, pz, _ = _coords(p)
    return fe.eq(px, fe.mul(x, pz)) & fe.eq(py, fe.mul(y, pz))

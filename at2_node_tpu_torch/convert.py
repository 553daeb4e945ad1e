"""Carry values between the JAX package's layouts and the port's.

The JAX package holds a field element as 20 int32 limbs of 13 bits; the
port holds it as 10 int64 limbs in the ref10 layout (``ops/field.py``). The
same value is meant when the two agree mod p, so conversion goes through
the integer value and lands canonical. Points are (..., 4, limbs) in both
packages. A ledger needs no converter: ``Accounts.import_state`` takes the
dict that the JAX package's ``Accounts.export_state()`` returns, as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import field as fe

REF_LIMBS = 20
REF_LIMB_BITS = 13


def _ref_value(limbs: np.ndarray) -> int:
    return sum(int(v) << (REF_LIMB_BITS * j) for j, v in enumerate(limbs))


def limbs_from_reference(a: np.ndarray) -> torch.Tensor:
    """(..., 20) int32 13-bit limbs -> (..., 10) int64 port limbs (CPU),
    canonical, same value mod p."""
    a = np.asarray(a)
    if a.shape[-1] != REF_LIMBS:
        raise ValueError(f"expected (..., {REF_LIMBS}) limbs, got {a.shape}")
    flat = a.reshape(-1, REF_LIMBS)
    out = np.stack([fe.int_to_limbs(_ref_value(row)) for row in flat]) if len(flat) else (
        np.zeros((0, fe.N_LIMBS), np.int64)
    )
    return torch.from_numpy(out.reshape(a.shape[:-1] + (fe.N_LIMBS,)))


def limbs_to_reference(t: torch.Tensor) -> np.ndarray:
    """(..., 10) port limbs -> (..., 20) int32 13-bit limbs, canonical."""
    arr = t.detach().cpu().numpy()
    flat = arr.reshape(-1, fe.N_LIMBS)
    out = np.zeros((len(flat), REF_LIMBS), np.int32)
    mask = (1 << REF_LIMB_BITS) - 1
    for i, row in enumerate(flat):
        x = fe.limbs_to_int(row)
        for j in range(REF_LIMBS):
            out[i, j] = (x >> (REF_LIMB_BITS * j)) & mask
    return out.reshape(arr.shape[:-1] + (REF_LIMBS,))


def points_from_reference(points: np.ndarray) -> torch.Tensor:
    """(..., 4, 20) reference points (e.g. its (16, 4, 20) ``BASE_TABLE``)
    -> (..., 4, 10) port points, coordinate by coordinate."""
    points = np.asarray(points)
    if points.shape[-2:] != (4, REF_LIMBS):
        raise ValueError(f"expected (..., 4, {REF_LIMBS}) points, got {points.shape}")
    return limbs_from_reference(points)

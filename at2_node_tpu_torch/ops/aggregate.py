"""Random-linear-combination (RLC) batch verification: the classified check
the CUDA verifier runs in ``mode="rlc"``, and the one-equation certificate
verify.

Counterpart of ``at2_node_tpu/ops/aggregate.py``. For signatures (A_i, R_i,
S_i) with challenges h_i and fresh random 128-bit z_i, every signature is
valid only if

    sum_i [z_i] R_i + [z_i h_i] A_i - [z_i S_i] B  ==  identity,

and a set with a bad signature passes with probability at most 2^-124 over
the z_i, provided every R_i and A_i is torsion-free: a signer who plants
8-torsion components in R or A makes small-order residuals that can cancel
across lanes, and a cofactorless per-signature verifier rejects what the
naive sum would accept. So every lane is classified on the device first
(:func:`rlc_graph_packed_plain`, and ``csrc/ed25519_rlc.cu`` on the card):

* code 2 (reroute): A is undecodable or carries torsion. Its cofactorless
  verdict can differ from any batched check, so the caller resolves the
  flush with the exact per-signature kernel.
* code 0: the row is invalid (padding, bad lengths, S >= L), or R is
  undecodable or carries torsion with a clean A, which the per-signature
  check provably rejects.
* code 1: the lane enters the equation. Its residual [z]R + [zh]A - [zs]B
  (zh = z h mod L, zs = z S mod L) is folded with every other code-1 lane's;
  every other lane adds the identity. ``eq_ok`` says the fold is the
  identity, so a batch with no code-1 lane gives True.

Verdict (:func:`rlc_verify_batch`, ``CudaBatchVerifier._resolve_rlc``):
when ``eq_ok`` holds and no lane has code 2, the verdicts are ``codes ==
1``; otherwise one exact per-signature pass over the same flush.

**The certificate (X3) is X2 with a host epilogue, exactly.** The
reference's ``_aggregate_graph`` decodes and torsion-checks every lane and
tests [sum z_i S_i mod L]B == sum [z_i]R_i + [z_i h_i mod L]A_i, returning
``eq & subgroup_ok & all(a_ok) & all(r_ok)``. :func:`aggregate_verify`
packs the same lanes with per-lane zs_i = z_i S_i mod L, runs X2 and
returns ``eq_ok and all(codes == 1)``. The two agree:

* a lane whose A or R is undecodable or carries torsion has code 0 or 2,
  and the reference's ``a_ok``, ``r_ok`` or ``subgroup_ok`` is False: both
  return False;
* when every code is 1, both test the same equation over the same lanes:
  B has order L, so sum_i [zs_i]B = [sum_i z_i S_i mod L]B, and A_i, R_i
  are torsion-free, so reducing z_i h_i mod L changes nothing.

The fold order differs from the reference's halving tree; a sum in the
group does not depend on it, and the identity test is exact on canonical
values.

Stages (mirroring ``ops/ed25519.py``): :func:`rlc_prep` packs one
``RLC_PACKED_WIDTH`` row per lane into a pooled staging buffer,
:func:`rlc_upload` copies it on a copy stream, :func:`rlc_launch` runs both
kernels on a compute stream and starts the copy back of B + 1 bytes (the
codes and eq_ok), and :func:`rlc_finish` waits for its completion event.
On a CPU tensor :func:`rlc_graph_packed_plain` runs in the kernels' place.
"""

from __future__ import annotations

import contextlib
import secrets
from typing import Optional, Sequence

import numpy as np
import torch

from . import edwards as ed
from . import field as fe
from .ed25519 import L, StagingPool, prepare_batch, upload_packed, windows_msb_first

Z_BITS = 128

# a(32) | r(32) | z(32) | zh(32) | zs(32) | valid(1)
RLC_PACKED_WIDTH = 161


def _windows_from_int(k: int) -> np.ndarray:
    le = np.frombuffer(k.to_bytes(32, "little"), dtype=np.uint8)
    return windows_msb_first(torch.from_numpy(le.copy())).numpy()


# L as 4-bit windows, most significant first: the torsion check multiplies
# every lane by the same scalar.
L_WINDOWS = _windows_from_int(L)


def _neg_base_table() -> np.ndarray:
    """Multiples 0..15 of -B, (16, 4, 10): the third table of the residual's
    Straus loop, shared by every lane."""
    acc = (0, 1)
    out = []
    for _ in range(16):
        out.append(ed.point_from_ints((-acc[0]) % fe.P, acc[1]))
        acc = ed.affine_add_ints(acc, (ed.BX_INT, ed.BY_INT))
    return np.stack(out)


NEG_BASE_TABLE = _neg_base_table()


def _straus(tables: Sequence[torch.Tensor], windows: Sequence[torch.Tensor]) -> torch.Tensor:
    """sum_t [k_t]P_t by interleaved Straus: ``tables[t]`` holds multiples
    0..15 of P_t, (..., 16, 4, 10); ``windows[t]`` k_t's 64 4-bit windows,
    most significant first. Per window: 4 doublings, then one addition per
    table, in order."""
    acc = torch.as_tensor(ed.IDENTITY, device=tables[0].device).expand(
        *windows[0].shape[:-1], 4, fe.N_LIMBS
    )
    for w in range(windows[0].shape[-1]):
        acc = ed.double(ed.double(ed.double(ed.double(acc))))
        for table, win in zip(tables, windows):
            acc = ed.add(acc, ed._lookup(table, win[..., w]))
    return acc


def double_scalar_mul(p_point, p_windows, q_point, q_windows) -> torch.Tensor:
    """[a]P + [b]Q with both points variable (batched Straus, 4-bit
    windows); ``edwards.double_scalar_mul_vs_base`` is the case Q = B."""
    return _straus((ed.build_table(p_point), ed.build_table(q_point)), (p_windows, q_windows))


def mul_by_L(points: torch.Tensor) -> torch.Tensor:
    """[L]P for a (..., 4, 10) stack of points."""
    windows = torch.as_tensor(L_WINDOWS, device=points.device).expand(*points.shape[:-2], 64)
    return _straus((ed.build_table(points),), (windows,))


def is_identity(p: torch.Tensor) -> torch.Tensor:
    """Projective check P == (0 : 1 : 1): x == 0 and y == z (the 2-torsion
    point (0, -1) fails the second clause)."""
    return fe.is_zero(p[..., ed.X, :]) & fe.eq(p[..., ed.Y, :], p[..., ed.Z, :])


def tree_reduce_points(pts: torch.Tensor) -> torch.Tensor:
    """Sum a (B, 4, 10) stack of points (B >= 1) into one point with
    ceil(log2(B)) halving rounds of batched additions; an odd round carries
    its unpaired last point into the next."""
    n = pts.shape[0]
    while n > 1:
        half = n // 2
        folded = ed.add(pts[:half], pts[half:2 * half])
        if n % 2:
            folded = torch.cat([folded, pts[2 * half:]], dim=0)
        pts = folded
        n = pts.shape[0]
    return pts[0]


def rlc_residuals(r_point, a_point, z_win, zh_win, zs_win) -> torch.Tensor:
    """Per-lane residual [z]R + [zh]A - [zs]B: one triple-scalar Straus
    loop, the -B table shared by every lane."""
    nb = torch.as_tensor(NEG_BASE_TABLE, device=r_point.device).expand(
        *z_win.shape[:-1], 16, 4, fe.N_LIMBS
    )
    return _straus(
        (ed.build_table(r_point), ed.build_table(a_point), nb), (z_win, zh_win, zs_win)
    )


def rlc_graph_packed_plain(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the RLC kernels: (B, 161) uint8 rows ->
    (eq_ok, a 0-dim bool tensor; codes, (B,) uint8), on the rows' device."""
    n = packed.shape[0]
    if n == 0:
        return torch.ones((), dtype=torch.bool, device=packed.device), packed.new_zeros((0,))
    valid = packed[:, 160] != 0
    a_point, a_ok = ed.decompress(packed[:, :32])
    r_point, r_ok = ed.decompress(packed[:, 32:64])
    # exact [L]P per lane; an undecodable point is the base point, so its
    # check passes and its ok bit carries the rejection
    torsion_free = is_identity(mul_by_L(torch.cat([r_point, a_point], dim=0)))
    r_tf, a_tf = torsion_free[:n], torsion_free[n:]

    a_tainted = valid & ~(a_ok & a_tf)
    active = valid & ~a_tainted & r_ok & r_tf

    t = rlc_residuals(
        r_point, a_point, windows_msb_first(packed[:, 64:96]),
        windows_msb_first(packed[:, 96:128]), windows_msb_first(packed[:, 128:160]),
    )
    ident = torch.as_tensor(ed.IDENTITY, device=packed.device)
    t = torch.where(active[:, None, None], t, ident)
    eq_ok = is_identity(tree_reduce_points(t))
    codes = torch.where(
        a_tainted, torch.full_like(packed[:, 160], 2), active.to(torch.uint8)
    )
    return eq_ok, codes


# -- pipeline stages -------------------------------------------------------


class _RlcInFlight:
    """Launch output: the host buffer of B + 1 bytes (codes, then eq_ok)
    the result is copied into, the event recorded after that copy (None on
    the CPU), and the staging buffer to give back at finish."""

    __slots__ = ("out", "done", "host_buf")

    def __init__(self, out, done, host_buf) -> None:
        self.out = out
        self.done = done
        self.host_buf = host_buf


def _pack(a, r, z_le, zh_le, zs_le, valid, out: np.ndarray) -> None:
    out[:, :32] = a
    out[:, 32:64] = r
    out[:, 64:96] = z_le
    out[:, 96:128] = zh_le
    out[:, 128:160] = zs_le
    out[:, 160] = valid


def rlc_prep(
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
    batch_size: int | None = None,
    pool: Optional[StagingPool] = None,
    _z_override: Sequence[int] | None = None,
) -> torch.Tensor:
    """Stage 1 (host): batch prep and fresh random coefficients, one
    (bucket, RLC_PACKED_WIDTH) row per lane, into a buffer of ``pool`` when
    given. ``batch_size`` need not be a power of two. ``_z_override`` fixes
    the coefficients (tests only: with known z the soundness argument does
    not hold); padding lanes then take z = 1."""
    from ..native.rlc import make_scalars

    n = len(public_keys)
    bucket = batch_size if batch_size is not None else n
    a, r, s_le, h_le, valid = prepare_batch(public_keys, messages, signatures, bucket)
    zo = None
    if _z_override is not None:
        zo = list(_z_override) + [1] * (bucket - len(_z_override))
    z_le, zh_le, zs_le = make_scalars(s_le, h_le, z_override=zo)
    if pool is None:
        buf = torch.empty((bucket, RLC_PACKED_WIDTH), dtype=torch.uint8)
    else:
        buf = pool.acquire(bucket)
    try:
        _pack(a, r, z_le, zh_le, zs_le, valid, buf.numpy())
    except BaseException:
        if pool is not None:
            pool.release(buf)
        raise
    return buf


def rlc_upload(host_buf: torch.Tensor, device: torch.device, stream=None):
    """Host -> device copy of the rows (``ops.ed25519.upload_packed``)."""
    return upload_packed(host_buf, device, stream)


def rlc_launch(staged, stream=None) -> _RlcInFlight:
    """Stage 2 (device): the compute stream waits for the upload, runs both
    RLC kernels, and copies the codes and eq_ok (B + 1 bytes) into pinned
    host memory; returns without waiting for any of it."""
    from . import cuda_rlc

    rows = staged.rows
    if rows.device.type == "cpu":
        eq, codes = cuda_rlc.rlc_packed(rows)
        return _RlcInFlight(torch.cat([codes, eq]), None, staged.host_buf)
    stream = stream if stream is not None else torch.cuda.current_stream(rows.device)
    with torch.cuda.stream(stream):
        if staged.ready is not None:
            stream.wait_event(staged.ready)
        rows.record_stream(stream)
        eq, codes = cuda_rlc.rlc_packed(rows)
        n = codes.shape[0]
        out = torch.empty((n + 1,), dtype=torch.uint8, pin_memory=True)
        out[:n].copy_(codes, non_blocking=True)
        out[n:].copy_(eq, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return _RlcInFlight(out, done, staged.host_buf)


def rlc_finish(handle: _RlcInFlight, n: int, pool: Optional[StagingPool] = None):
    """Stage 3: wait for the batch's completion event; ``(eq_ok,
    codes[:n])``; only then give the staging buffer back."""
    if handle.done is not None:
        handle.done.synchronize()
    out = handle.out.numpy()
    eq_ok, codes = bool(out[-1]), out[:n].copy()
    if pool is not None and handle.host_buf is not None:
        pool.release(handle.host_buf)
    return eq_ok, codes


def _run(rows: torch.Tensor, dev: torch.device, n: int):
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        return rlc_finish(rlc_launch(rlc_upload(rows, dev)), n)


def rlc_verify_batch(
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
    batch_size: int | None = None,
    _z_override: Sequence[int] | None = None,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """The RLC stages with exact resolution: reroutes and a failed equation
    fall back to the per-signature kernel, so the (n,) verdicts always equal
    ``ops.ed25519.verify_batch``'s. ``device`` as for ``verify_batch``."""
    from .cuda_verify import resolve_device
    from .ed25519 import verify_batch

    n = len(public_keys)
    if n == 0:
        return np.zeros(0, dtype=bool)
    dev = resolve_device(device)
    rows = rlc_prep(public_keys, messages, signatures, batch_size, _z_override=_z_override)
    eq_ok, codes = _run(rows, dev, n)
    if eq_ok and not (codes == 2).any():
        return codes == 1
    return verify_batch(public_keys, messages, signatures, batch_size, device=dev)


def aggregate_verify(
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
    _z_override: Sequence[int] | None = None,
    device: str | torch.device | None = None,
) -> bool:
    """One-equation verification of a whole certificate (True = all valid):
    X2's kernels and the epilogue ``eq_ok and all(codes == 1)`` (module
    docstring). ``_z_override`` fixes the coefficients (tests only)."""
    from .cuda_verify import resolve_device

    n = len(public_keys)
    if n == 0:
        return True
    dev = resolve_device(device)
    z = list(_z_override) if _z_override is not None else [
        secrets.randbits(Z_BITS) | 1 for _ in range(n)
    ]
    rows = rlc_prep(public_keys, messages, signatures, _z_override=z)
    if not rows.numpy()[:, 160].all():
        return False  # malformed input can never verify
    eq_ok, codes = _run(rows, dev, n)
    return bool(eq_ok and (codes == 1).all())


def verify_certificate(
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Certificate verification; returns (n,) bool. On the card the
    per-signature kernel answers directly, as the reference's Pallas branch
    does; on the CPU the aggregate equation runs first and falls back to
    per-signature verification to find the culprits."""
    from .cuda_verify import resolve_device
    from .ed25519 import verify_batch

    dev = resolve_device(device)
    if dev.type == "cuda":
        return verify_batch(public_keys, messages, signatures, device=dev)
    if aggregate_verify(public_keys, messages, signatures, device=dev):
        return np.ones(len(public_keys), dtype=bool)
    return verify_batch(public_keys, messages, signatures, device=dev)

"""Batched ed25519 verification: host prep, the plain verify, and the
prep/upload/launch/finish pipeline stages on CUDA streams.

Counterpart of ``at2_node_tpu/ops/ed25519.py``.

* **Host**: SHA-512 challenge ``h = H(R || A || M) mod L`` and the ``S < L``
  check (``native/at2_prep.cpp`` when it builds, else :func:`prepare_batch_py`),
  packed one 129-byte row per lane: ``A(32) | R(32) | S(32) | h(32) | valid(1)``.
* **Device**: decompress A and R, Straus interleaved double-scalar
  multiplication ``[S]B + [h](-A)``, projective compare against R; the
  verdicts leave the device as a packed MSB-first bitmask. On a CUDA tensor
  that is the hand-written kernel (``ops/cuda_verify.py``); on a CPU tensor
  it is :func:`verify_packed` below, the plain version.

Batches are padded to a bucket of the ``BUCKETS`` ladder; padding rows
carry valid=0 and verify False. There is no rounding to a tile: the kernel
bounds-checks a ragged tail itself.
"""

from __future__ import annotations

import contextlib
import hashlib
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from . import edwards as ed

# ed25519 group order L = 2^252 + 27742317777372353535851937790883648493
L = (1 << 252) + 27742317777372353535851937790883648493

BUCKETS = (64, 256, 1024, 4096, 8192, 65536)

# One packed row per lane: a(32) | r(32) | s(32) | h(32) | valid(1).
PACKED_WIDTH = 129


def bucket_for(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


# -- host side ------------------------------------------------------------


def prepare_batch_py(
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
    size: int,
):
    """Pure-Python prep: the fallback when the native library does not
    build, and the differential reference for it. Returns ``(a, r, s_le,
    h_le, valid)`` numpy arrays padded to ``size``; ``valid`` is False for
    bad lengths, S >= L and padding."""
    n = len(public_keys)
    a_bytes = np.zeros((size, 32), dtype=np.uint8)
    r_bytes = np.zeros((size, 32), dtype=np.uint8)
    s_le = np.zeros((size, 32), dtype=np.uint8)
    h_le = np.zeros((size, 32), dtype=np.uint8)
    valid = np.zeros((size,), dtype=bool)

    for i in range(n):
        pk, msg, sig = public_keys[i], messages[i], signatures[i]
        if len(pk) != 32 or len(sig) != 64:
            continue
        r, s_raw = sig[:32], sig[32:]
        if int.from_bytes(s_raw, "little") >= L:  # RFC 8032 §5.1.7
            continue
        h = int.from_bytes(hashlib.sha512(r + pk + msg).digest(), "little") % L
        a_bytes[i] = np.frombuffer(pk, dtype=np.uint8)
        r_bytes[i] = np.frombuffer(r, dtype=np.uint8)
        s_le[i] = np.frombuffer(s_raw, dtype=np.uint8)
        h_le[i] = np.frombuffer(h.to_bytes(32, "little"), dtype=np.uint8)
        valid[i] = True

    return (a_bytes, r_bytes, s_le, h_le, valid)


def pack_prepared(a, r, s_le, h_le, valid) -> np.ndarray:
    """Fuse the five prepared arrays into one (B, 129) uint8 array."""
    return np.concatenate([a, r, s_le, h_le, valid[:, None].astype(np.uint8)], axis=1)


def fill_packed(
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
    out: np.ndarray,
) -> None:
    """Write every row of ``out`` (bucket, 129): one prepared row per item,
    then zero rows of padding, so a reused buffer never leaks old lanes."""
    from ..native.prep import native_available, prep_packed_native

    if len(public_keys) > out.shape[0]:
        raise ValueError(f"batch of {len(public_keys)} exceeds bucket size {out.shape[0]}")
    if native_available():
        prep_packed_native(public_keys, messages, signatures, out)
    else:
        out[:] = pack_prepared(
            *prepare_batch_py(public_keys, messages, signatures, out.shape[0])
        )


def prepare_batch(
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
    batch_size: int | None = None,
):
    """``(a, r, s_le, h_le, valid)`` padded to ``batch_size``, through the
    native prep when it builds (same contract as :func:`prepare_batch_py`)."""
    size = batch_size if batch_size is not None else len(public_keys)
    rows = np.empty((size, PACKED_WIDTH), dtype=np.uint8)
    fill_packed(public_keys, messages, signatures, rows)
    return (
        rows[:, :32], rows[:, 32:64], rows[:, 64:96], rows[:, 96:128],
        rows[:, 128].astype(bool),
    )


# -- the plain device function -------------------------------------------


def windows_msb_first(scalars_le: torch.Tensor) -> torch.Tensor:
    """(..., 32) uint8 little-endian scalars -> (..., 64) int64 4-bit
    windows, most significant first: window w is nibble 63 - w."""
    b = scalars_le.to(torch.int64)
    inter = torch.stack([b & 0x0F, b >> 4], dim=-1).flatten(-2)
    return inter.flip(-1)


def verify_kernel(a_bytes, r_bytes, s_le, h_le, valid) -> torch.Tensor:
    """(B,) bool verdicts of ``[S]B + [h](-A) == R`` (the RFC 8032
    cofactorless check), with every invalid lane masked to False."""
    a_point, a_ok = ed.decompress(a_bytes)
    r_point, r_ok = ed.decompress(r_bytes)
    q = ed.double_scalar_mul_vs_base(
        ed.negate(a_point), windows_msb_first(h_le), windows_msb_first(s_le)
    )
    matches = ed.equals_affine(q, r_point[..., ed.X, :], r_point[..., ed.Y, :])
    return valid & a_ok & r_ok & matches


def packbits(bits: torch.Tensor) -> torch.Tensor:
    """(B,) bool -> (ceil(B/8),) uint8, MSB-first like ``np.packbits``:
    lane i is bit 7 - i % 8 of byte i // 8, the tail is zero."""
    n = bits.shape[0]
    padded = torch.zeros(((n + 7) // 8) * 8, dtype=torch.int64, device=bits.device)
    padded[:n] = bits.to(torch.int64)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=bits.device)
    return (padded.view(-1, 8) * weights).sum(-1).to(torch.uint8)


def verify_packed(packed: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel: (B, 129) uint8 rows -> (ceil(B/8),)
    uint8 MSB-first verdict bitmask, on the rows' device."""
    ok = verify_kernel(
        packed[:, :32], packed[:, 32:64], packed[:, 64:96], packed[:, 96:128],
        packed[:, 128] != 0,
    )
    return packbits(ok)


# -- persistent host staging ----------------------------------------------


class StagingPool:
    """A small ring of (bucket, width) host buffers per bucket, pinned when
    the batches go to a CUDA device so the upload can be asynchronous.
    A buffer is taken in prep and given back in :func:`finish_packed`,
    after its batch's completion event, so reuse never races a copy.
    ``width`` is the row's: 129 here, 161 for ``ops.aggregate``'s rows."""

    CAP_PER_BUCKET = 8  # > the verifier's pipeline depth

    def __init__(self, pinned: bool, width: int = PACKED_WIDTH) -> None:
        self.pinned = pinned
        self.width = width
        self._free: dict[int, list[torch.Tensor]] = {}
        self._lock = threading.Lock()

    def acquire(self, bucket: int) -> torch.Tensor:
        with self._lock:
            pool = self._free.get(bucket)
            if pool:
                return pool.pop()
        return torch.empty(
            (bucket, self.width), dtype=torch.uint8, pin_memory=self.pinned
        )

    def release(self, buf: torch.Tensor) -> None:
        with self._lock:
            pool = self._free.setdefault(buf.shape[0], [])
            if len(pool) < self.CAP_PER_BUCKET:
                pool.append(buf)

    def free_count(self, bucket: int) -> int:
        with self._lock:
            return len(self._free.get(bucket, ()))


class _Uploaded:
    """Upload output: the device rows, the staging buffer they came from,
    and the event that marks the copy done (None on the CPU)."""

    __slots__ = ("rows", "host_buf", "ready")

    def __init__(self, rows, host_buf, ready) -> None:
        self.rows = rows
        self.host_buf = host_buf
        self.ready = ready


class _InFlight:
    """Launch output: the host bitmask buffer the result is copied into,
    the event recorded after that copy (None on the CPU), and the staging
    buffer to give back at finish."""

    __slots__ = ("bits", "done", "host_buf")

    def __init__(self, bits, done, host_buf) -> None:
        self.bits = bits
        self.done = done
        self.host_buf = host_buf


# -- pipeline stages -------------------------------------------------------


def prep_packed(
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
    batch_size: int | None,
    pool: StagingPool,
) -> torch.Tensor:
    """Stage 1 (host): bucket policy and prep into a pooled staging buffer."""
    bucket = bucket_for(len(public_keys)) if batch_size is None else batch_size
    buf = pool.acquire(bucket)
    try:
        fill_packed(public_keys, messages, signatures, buf.numpy())
    except BaseException:
        pool.release(buf)
        raise
    return buf


def upload_packed(
    host_buf: torch.Tensor,
    device: torch.device,
    stream: Optional["torch.cuda.Stream"] = None,
) -> _Uploaded:
    """Host -> device copy, asynchronous from pinned memory on ``stream``
    (a copy stream), with an event recorded after it. On the CPU the rows
    stay where they are."""
    if device.type == "cpu":
        return _Uploaded(host_buf, host_buf, None)
    stream = stream if stream is not None else torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        rows = torch.empty(host_buf.shape, dtype=torch.uint8, device=device)
        rows.copy_(host_buf, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(stream)
    return _Uploaded(rows, host_buf, ready)


def launch_packed(
    staged: _Uploaded, stream: Optional["torch.cuda.Stream"] = None
) -> _InFlight:
    """Stage 2 (device): the compute stream waits for the upload, runs the
    verify, and copies the bitmask into pinned host memory; returns without
    waiting for any of it."""
    from . import cuda_verify

    rows = staged.rows
    if rows.device.type == "cpu":
        return _InFlight(cuda_verify.verify_packed(rows), None, staged.host_buf)
    stream = stream if stream is not None else torch.cuda.current_stream(rows.device)
    with torch.cuda.stream(stream):
        if staged.ready is not None:
            stream.wait_event(staged.ready)
        # rows were allocated on the copy stream: keep the allocator from
        # reusing them before this stream is done with them
        rows.record_stream(stream)
        bits_dev = cuda_verify.verify_packed(rows)
        bits = torch.empty(bits_dev.shape, dtype=torch.uint8, pin_memory=True)
        bits.copy_(bits_dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record(stream)
    return _InFlight(bits, done, staged.host_buf)


def finish_packed(handle: _InFlight, n: int, pool: Optional[StagingPool] = None) -> np.ndarray:
    """Stage 3: wait for the batch's completion event, unpack the first
    ``n`` verdicts, and only then give the staging buffer back."""
    if handle.done is not None:
        handle.done.synchronize()
    out = np.unpackbits(handle.bits.numpy(), count=n).astype(bool)
    if pool is not None and handle.host_buf is not None:
        pool.release(handle.host_buf)
    return out


def verify_batch(
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
    batch_size: int | None = None,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """End-to-end batched verify; returns (len(public_keys),) bool.

    ``device`` None means the first CUDA device and raises without one;
    ``device="cpu"`` runs the plain version."""
    from .cuda_verify import resolve_device

    dev = resolve_device(device)
    pool = StagingPool(pinned=dev.type == "cuda")
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        host = prep_packed(public_keys, messages, signatures, batch_size, pool)
        return finish_packed(launch_packed(upload_packed(host, dev)), len(public_keys))

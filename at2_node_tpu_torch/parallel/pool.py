"""The device pool: one batch of signatures split over a list of devices.

Counterpart of ``at2_node_tpu/parallel/pool.py`` (BASELINE config 5: a
verifier pool behind 32 nodes). The reference shards one batch over a 1-D
device mesh along the batch axis (``_verify_fn``, and ``_pallas_fn``, a
``shard_map`` of the Pallas verify graph) and sums the verdicts into one
replicated count (``_count_fn``, a psum). The work is embarrassingly
parallel, so the port has no collective on the device path at all:

* :func:`verify_sharded_packed` cuts the (B, 129) packed rows into
  ``len(devices)`` equal contiguous shards; each shard is uploaded on its
  own copy stream, the hand-written verify kernel (``ops/cuda_verify.py``,
  ``csrc/ed25519_verify.cu``) is launched once on it on its own compute
  stream, and its MSB-first bitmask is copied back into pinned memory.
  A shard is a multiple of 8 lanes (:func:`_pool_quantum`), so the shards'
  bitmasks, end to end, are the batch's bitmask.
* :func:`verify_and_count` adds the valid count, summed on the host; with
  a ``torch.distributed`` group it is summed across ranks by one
  ``all_reduce`` of an int64 CPU tensor (gloo: only a scalar travels, and
  NCCL cannot run two ranks on one card).

A device may repeat in the list: every shard gets its own streams, so a
pool of ``["cuda:0"] * k`` drives the split on one card, and a pool of
``["cpu"] * k`` runs each shard's plain PyTorch version (the tests).
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import numpy as np
import torch

from ..crypto.verifier import CudaBatchVerifier
from ..ops import cuda_verify
from ..ops import ed25519 as kernel

# lanes per byte of the verdict bitmask: a shard of a multiple of this many
# lanes has a bitmask of whole bytes
BITMASK_LANES = 8


def make_pool_devices(devices: Sequence | None = None) -> List[torch.device]:
    """The pool's devices, the counterpart of ``make_mesh``. By default
    every CUDA device of this process (local devices only, also when
    ``torch.distributed`` spans several processes); it raises without one.
    An explicit list may repeat a device, and "cpu" entries select the
    plain version; CUDA and CPU devices do not mix."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=['cpu'] * k to run "
                "the plain version"
            )
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = [cuda_verify.resolve_device(d) for d in devices]
    if not out:
        raise ValueError("a pool needs at least one device")
    if len({d.type for d in out}) != 1:
        raise ValueError(f"a pool's devices are all CUDA devices or all 'cpu': {out}")
    return out


def pool_bucket_for(n: int, n_devices: int, quantum: int | None = None) -> int:
    """Smallest bucket that fits n and splits evenly across the pool:
    each bucket of the ladder is rounded up to a multiple of ``quantum``
    (default: the device count), so the set of launch shapes stays fixed
    for a pool size."""
    q = quantum if quantum is not None else n_devices
    for b in kernel.BUCKETS:
        b = ((b + q - 1) // q) * q
        if n <= b:
            return b
    top = max(kernel.BUCKETS[-1], n)
    return ((top + q - 1) // q) * q


def _pool_quantum(n_devices: int) -> int:
    """The divisor of every pool bucket: a whole bitmask byte a shard."""
    return BITMASK_LANES * n_devices


def _device_ctx(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def shard_streams(devices: Sequence[torch.device]) -> list:
    """One (copy, compute) stream pair per shard, also where a device
    repeats; (None, None) for a CPU shard."""
    out = []
    for dev in devices:
        if dev.type == "cuda":
            out.append((torch.cuda.Stream(dev), torch.cuda.Stream(dev)))
        else:
            out.append((None, None))
    return out


def _as_rows(rows) -> torch.Tensor:
    if isinstance(rows, np.ndarray):
        rows = torch.from_numpy(rows)
    if rows.dtype != torch.uint8 or rows.dim() != 2 or rows.shape[1] != kernel.PACKED_WIDTH:
        raise ValueError(
            f"rows must be (B, {kernel.PACKED_WIDTH}) uint8, got {rows.dtype} {tuple(rows.shape)}"
        )
    if rows.device.type != "cpu":
        raise ValueError("rows are host rows; the pool uploads each shard itself")
    return rows


def upload_sharded(rows: torch.Tensor, devices: Sequence[torch.device], streams: list) -> list:
    """Each shard's host -> device copy on its own copy stream (from pinned
    memory, asynchronous); returns without waiting."""
    n_dev = len(devices)
    if rows.shape[0] % _pool_quantum(n_dev):
        raise ValueError(
            f"{rows.shape[0]} rows do not split into {n_dev} shards of whole "
            f"bitmask bytes (quantum {_pool_quantum(n_dev)})"
        )
    per = rows.shape[0] // n_dev
    uploaded = []
    for i, (dev, (copy_stream, _)) in enumerate(zip(devices, streams)):
        with _device_ctx(dev):
            uploaded.append(kernel.upload_packed(rows[i * per:(i + 1) * per], dev, copy_stream))
    return uploaded


def launch_sharded(uploaded: list, devices: Sequence[torch.device], streams: list) -> list:
    """The verify kernel once a shard, each on its compute stream after its
    upload, and each bitmask's copy back; returns without waiting."""
    handles = []
    for up, dev, (_, compute_stream) in zip(uploaded, devices, streams):
        with _device_ctx(dev):
            handles.append(kernel.launch_packed(up, compute_stream))
    return handles


def finish_sharded(handles: list) -> np.ndarray:
    """Wait for every shard's completion event; the batch's MSB-first
    bitmask, the shards' bitmasks end to end."""
    for h in handles:
        if h.done is not None:
            h.done.synchronize()
    return np.concatenate([h.bits.numpy() for h in handles])


def verify_sharded_packed(rows, devices: Sequence[torch.device], streams: list | None = None) -> list:
    """The counterpart of ``_verify_fn`` / ``_pallas_fn``: (B, 129) host
    rows, B a multiple of :func:`_pool_quantum`, split over ``devices``;
    each shard uploaded, verified by the kernel (the plain version on a CPU
    shard) and copied back on its own streams. Returns the in-flight
    handles without blocking (:func:`finish_sharded` waits)."""
    rows = _as_rows(rows)
    if streams is None:
        streams = shard_streams(devices)
    if devices[0].type == "cuda" and not rows.is_pinned():
        rows = rows.pin_memory()
    return launch_sharded(upload_sharded(rows, devices, streams), devices, streams)


def verify_and_count(rows, devices: Sequence[torch.device], streams: list | None = None,
                     group=None) -> tuple:
    """The counterpart of ``_count_fn``: ((B,) bool verdicts, valid count).
    Rows past a multiple of the quantum are padded with zero rows (valid
    byte 0: False). The count is summed on the host; with ``group`` (an
    initialized ``torch.distributed`` group) it is summed across its ranks
    by one ``all_reduce`` of an int64 CPU tensor, so every rank must call
    this, each with its own rows."""
    rows = _as_rows(rows)
    n = rows.shape[0]
    q = _pool_quantum(len(devices))
    padded = -(-n // q) * q
    if padded != n:
        rows = torch.cat([rows, torch.zeros((padded - n, kernel.PACKED_WIDTH), dtype=torch.uint8)])
    bits = finish_sharded(verify_sharded_packed(rows, devices, streams))
    ok = np.unpackbits(bits, count=n).astype(bool)
    count = int(ok.sum())
    if group is not None:
        import torch.distributed as dist

        total = torch.tensor([count], dtype=torch.int64)
        dist.all_reduce(total, group=group)
        count = int(total.item())
    return ok, count


def verify_batch_sharded(
    public_keys: Sequence[bytes],
    messages: Sequence[bytes],
    signatures: Sequence[bytes],
    devices: Sequence | None = None,
    batch_size: int | None = None,
) -> np.ndarray:
    """Verify one batch across every device of the pool; (n,) bool.
    ``devices`` None means every CUDA device (raises without one)."""
    devs = make_pool_devices(devices)
    n_dev = len(devs)
    quantum = _pool_quantum(n_dev)
    if batch_size is None:
        batch_size = pool_bucket_for(len(public_keys), n_dev, quantum)
    if batch_size % quantum != 0:
        raise ValueError(
            f"batch_size {batch_size} not divisible by pool quantum {quantum}"
            f" ({n_dev} devices)"
        )
    staging = kernel.StagingPool(pinned=devs[0].type == "cuda")
    host = kernel.prep_packed(public_keys, messages, signatures, batch_size, staging)
    bits = finish_sharded(verify_sharded_packed(host, devs))
    return np.unpackbits(bits, count=len(public_keys)).astype(bool)


class _PoolInFlight:
    """A pool batch past a stage: the shards' handles and the whole
    staging buffer, given back once every shard has finished."""

    __slots__ = ("shards", "host_buf")

    def __init__(self, shards: list, host_buf: torch.Tensor) -> None:
        self.shards = shards
        self.host_buf = host_buf


class PoolVerifier(CudaBatchVerifier):
    """Async verifier backed by the whole pool (config: ``[verifier] kind =
    "pool"``). The accumulate/pad/dispatch discipline, the pipeline,
    backpressure, stats and warm-up are :class:`CudaBatchVerifier`'s; each
    flushed batch is split over every device of the pool by the overridden
    stages. The router is pinned to per-signature verification: the pool
    shards the verify kernel only. Behind many nodes it is BASELINE config
    5's shared verifier (``Service.start(config, verifier=pool)``)."""

    def __init__(
        self,
        batch_size: int = 1024,
        max_delay: float = 0.002,
        devices: Sequence | None = None,
    ) -> None:
        self.devices = make_pool_devices(devices)
        # every bucket (and the batch_size the base class unions in) splits
        # into whole bitmask bytes a shard: round up to a quantum multiple
        q = _pool_quantum(len(self.devices))
        batch_size = ((batch_size + q - 1) // q) * q
        super().__init__(batch_size=batch_size, max_delay=max_delay, mode="per_sig",
                         device=self.devices[0])
        self._streams = shard_streams(self.devices)

    # the staged pipeline (the base class overlaps these stages across
    # consecutive batches)

    def _prep(self, pks, msgs, sigs, bucket):
        """Host prep into one staging buffer, then each shard's upload on
        its own copy stream (which refuses a bucket that does not split
        into whole bitmask bytes a shard)."""
        host = kernel.prep_packed(pks, msgs, sigs, bucket, self._staging)
        try:
            return _PoolInFlight(upload_sharded(host, self.devices, self._streams), host)
        except BaseException:
            self._staging.release(host)
            raise

    def _launch(self, prepared: _PoolInFlight) -> _PoolInFlight:
        """The verify kernel once a shard; returns without blocking."""
        return _PoolInFlight(
            launch_sharded(prepared.shards, self.devices, self._streams), prepared.host_buf
        )

    def _finish(self, handle: _PoolInFlight, n: int) -> np.ndarray:
        """Wait on every shard's event, unpack the joined bitmask, and give
        the staging buffer back."""
        try:
            bits = finish_sharded(handle.shards)
        finally:
            self._staging.release(handle.host_buf)
        return np.unpackbits(bits, count=n).astype(bool)

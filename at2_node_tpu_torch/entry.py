"""Entry points: the one-device check and the multi-device dry run.

Counterpart of the repository's root ``__graft_entry__.py``. The system's
"model" is the batched ed25519 verify; its one step over several devices
is a sharded verify-and-count (``parallel/pool.py``): the batch split
along its only axis, one valid count summed. There is no virtual device
mesh here: without the devices asked for, the dry run raises.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def _example_rows(n: int, batch_size: int) -> np.ndarray:
    """(batch_size, 129) packed rows: n real signatures of one seeded key,
    lane 1 tampered, the rest padding."""
    from .crypto.keys import SignKeyPair
    from .ops import ed25519 as kernel

    kp = SignKeyPair.from_hex("42" * 32)
    pks, msgs, sigs = [], [], []
    for i in range(n):
        msg = b"graft entry message %d" % i
        sig = kp.sign(msg)
        if i == 1:  # one bad lane: the verdict mask is part of the check
            sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
        pks.append(kp.public)
        msgs.append(msg)
        sigs.append(sig)
    rows = np.empty((batch_size, kernel.PACKED_WIDTH), dtype=np.uint8)
    kernel.fill_packed(pks, msgs, sigs, rows)
    return rows


def _expected(n_real: int, batch_size: int) -> np.ndarray:
    expected = np.zeros(batch_size, dtype=bool)
    expected[:n_real] = True
    expected[1] = False  # the tampered lane
    return expected


def entry(device: str | torch.device | None = None):
    """(fn, example_args) for the one-device check: the verify kernel's
    wrapper (``ops.cuda_verify.verify_packed``; on a CPU tensor it runs the
    plain ``ops.ed25519.verify_packed``) on 8 real lanes, lane 1 tampered,
    in a 64-row bucket. ``device`` None means the first CUDA device and
    raises without one."""
    from .ops import cuda_verify

    dev = cuda_verify.resolve_device(device)
    rows = torch.from_numpy(_example_rows(8, 64)).to(dev)
    return cuda_verify.verify_packed, (rows,)


def dryrun_multichip(n_devices: int, devices: Sequence | None = None) -> None:
    """Run the sharded verify-and-count over ``n_devices`` devices and check
    the verdicts and the count, as the pool runs a batch. ``devices`` None
    takes the first ``n_devices`` CUDA devices and raises when there are
    fewer; a list may repeat a device (``["cuda:0"] * n`` drives the split
    on one card, ``["cpu"] * n`` the plain version)."""
    from .parallel import pool

    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) needs {n_devices} CUDA devices, "
                f"found {have}; pass devices= to name them"
            )
        devices = [f"cuda:{i}" for i in range(n_devices)]
    devs = pool.make_pool_devices(devices)
    if len(devs) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {len(devs)}")
    # one bitmask byte a device; the last device's shard half real lanes
    batch = pool._pool_quantum(n_devices)
    n_real = batch - 4
    ok, count = pool.verify_and_count(_example_rows(n_real, batch), devs)
    expected = _expected(n_real, batch)
    if not (ok == expected).all():
        raise RuntimeError("sharded verify produced a wrong bitmap")
    if count != int(expected.sum()):
        raise RuntimeError(f"sharded count {count}, expected {int(expected.sum())}")

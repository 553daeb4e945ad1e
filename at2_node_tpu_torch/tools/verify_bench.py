"""Headline benchmark: batched ed25519 verifies/sec on one card.

Counterpart of the repo's root ``bench.py``: BASELINE config 2's
1k/8k/64k grid through the port's verify kernel, on ``cuda:0`` unless
``--device cpu`` asks for the plain version on the host (without a card
and without that flag it raises).

What is measured, per bucket:

* ``device_only`` — back-to-back kernel launches on rows already on the
  card (CUDA events around the launches): the kernel's compute ceiling.
* ``pipelined`` — the verifier's production shape: host prep and upload
  on worker threads (``ops.ed25519.prep_packed`` / ``upload_packed`` on a
  copy stream), two preps ahead, ``launch_packed`` / ``finish_packed``
  with at most ``DEPTH`` batches in flight — the stages
  ``CudaBatchVerifier`` runs under sustained load.

Each config reports the best of ``--trials`` trials. The result is ONE
JSON line on stdout in the reference's schema (``metric``, ``value``,
``unit``, ``vs_baseline`` against BASELINE.json's 50,000 verifies/s, the
``grid``), with the card's stamp (name and power limit, ``card``) beside
every value; the per-bucket lines go to stderr as they complete, and the
document goes to ``--out`` only when that is given.

The reference's tunnel machinery is not copied: no probe child, no
last-good re-emission, no OpenSSL fallback grid. If the card fails, the
run fails.

Usage:
    python -m at2_node_tpu_torch.tools.verify_bench [--device cuda|cpu]
        [--grid 65536,8192,1024] [--trials 3] [--out PATH]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

TARGET_PER_CHIP = 50_000.0
GRID = (65536, 8192, 1024)  # headline bucket first
TRIALS = 3
DEPTH = 4  # outstanding batches in the async chain


def _make_batch(n: int):
    from ..crypto.keys import SignKeyPair

    kp = SignKeyPair.from_hex("5a" * 32)
    pk = kp.public
    msgs = [b"bench message %08d" % i for i in range(n)]
    sigs = [kp.sign(m) for m in msgs]
    return [pk] * n, msgs, sigs


def _rounds_for(bucket: int) -> int:
    # ~0.5M lanes per trial keeps every config's trial a few seconds
    return max(4, min(16, (1 << 19) // bucket))


def measure_bucket(bucket: int, dev, trials: int, card: str, workers) -> tuple:
    """One bucket's row and the kernel's bitmask of its batch (all valid),
    as a (ceil(bucket/8),) uint8 array."""
    import torch

    from ..ops import cuda_verify
    from ..ops import ed25519 as v
    from ._common import device_seconds

    pks, msgs, sigs = _make_batch(bucket)
    cuda = dev.type == "cuda"
    staging = v.StagingPool(pinned=cuda)
    copy_stream = torch.cuda.Stream(dev) if cuda else None
    rounds = _rounds_for(bucket)
    rows = v.upload_packed(v.prep_packed(pks, msgs, sigs, bucket, staging), dev).rows

    # warm-up: one launch of each shape, checked
    bits = cuda_verify.verify_packed(rows).cpu().numpy()
    assert np.unpackbits(bits, count=bucket).all(), "warm-up failed to verify"
    warm = v.finish_packed(v.launch_packed(v.upload_packed(
        v.prep_packed(pks, msgs, sigs, bucket, staging), dev, copy_stream)), bucket, staging)
    assert warm.all(), "pipelined warm-up failed to verify"

    def prep_upload():
        return v.upload_packed(v.prep_packed(pks, msgs, sigs, bucket, staging), dev, copy_stream)

    def device_rounds():
        for _ in range(rounds):
            out = cuda_verify.verify_packed(rows)
        return out

    best_device, best_pipe = 0.0, 0.0
    for _ in range(trials):
        best_device = max(best_device, rounds * bucket / device_seconds(dev, device_rounds))

        preps: deque = deque(workers.submit(prep_upload) for _ in range(2))
        inflight: deque = deque()
        t0 = time.perf_counter()
        for _ in range(rounds):
            staged = preps.popleft().result()
            preps.append(workers.submit(prep_upload))
            inflight.append(v.launch_packed(staged))
            if len(inflight) >= DEPTH:
                v.finish_packed(inflight.popleft(), bucket, staging)
        while inflight:
            out_ok = v.finish_packed(inflight.popleft(), bucket, staging)
        best_pipe = max(best_pipe, rounds * bucket / (time.perf_counter() - t0))
        assert out_ok.all(), "pipelined trial failed to verify"
        # consume the dangling prep futures so they cannot steal CPU from
        # the next trial's timed sections
        for f in preps:
            staging.release(f.result().host_buf)
    line = {
        "bucket": bucket,
        "device_only": round(best_device, 1),
        "pipelined": round(best_pipe, 1),
        "device": dev.type,
        "card": card,
    }
    return line, bits


def run(device: str = "cuda", grid=None, trials: int = TRIALS, log=None) -> tuple:
    """The grid (``GRID`` when None) on ``device``; returns ``(result,
    bitmasks)``, the result in bench.py's schema and ``bitmasks[bucket]``
    the kernel's bitmask of that bucket's batch. ``log`` gets each
    bucket's line as it completes."""
    import torch

    from ..crypto.keys import verify_one
    from ..ops import ed25519 as v
    from ._common import card_stamp, tool_device

    grid = GRID if grid is None else tuple(grid)
    dev = tool_device(device)
    card = card_stamp(dev)
    buckets: dict = {}
    bitmasks: dict = {}
    with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
        with ThreadPoolExecutor(max_workers=2) as workers:
            for bucket in grid:
                line, bits = measure_bucket(bucket, dev, trials, card, workers)
                buckets[bucket] = line
                bitmasks[bucket] = bits
                if log is not None:
                    log(line)

    # host prep rate (one thread) + the host's per-signature OpenSSL rate
    pks, msgs, sigs = _make_batch(8192)
    t0 = time.perf_counter()
    v.prepare_batch(pks, msgs, sigs, 8192)
    prep_rate = 8192 / (time.perf_counter() - t0)
    n_cpu = 2000
    t0 = time.perf_counter()
    for i in range(n_cpu):
        verify_one(pks[i], msgs[i], sigs[i])
    cpu_rate = n_cpu / (time.perf_counter() - t0)

    headline = buckets[grid[0]]
    value = headline["pipelined"]
    result = {
        "metric": "ed25519_verifies_per_sec_per_chip",
        "value": round(value, 1),
        "unit": "sigs/s",
        "vs_baseline": round(value / TARGET_PER_CHIP, 3),
        "device": dev.type,
        "bucket": headline["bucket"],
        "grid": {
            str(k): {
                "device_only": row["device_only"],
                "pipelined": row["pipelined"],
                "pipelined_vs_device_pct": round(
                    100.0 * row["pipelined"] / row["device_only"], 1
                ) if row["device_only"] else 0.0,
                "card": card,
            }
            for k, row in sorted(buckets.items())
        },
        "device_only_rate": headline["device_only"],
        "host_prep_rate": round(prep_rate, 1),
        "cpu_openssl_1core_rate": round(cpu_rate, 1),
        "card": card,
    }
    return result, bitmasks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda (cuda:0, the kernel; the default) or cpu "
                    "(the plain version on the host)")
    ap.add_argument("--grid", default=",".join(map(str, GRID)),
                    help="comma-separated buckets, headline first "
                    "(default %(default)s)")
    ap.add_argument("--trials", type=int, default=TRIALS)
    ap.add_argument("--out", default=None,
                    help="also write the result line to this file")
    args = ap.parse_args(argv)
    grid = tuple(int(x) for x in args.grid.split(","))
    result, _ = run(
        args.device, grid, args.trials,
        log=lambda line: print(json.dumps(line), file=sys.stderr, flush=True),
    )
    blob = json.dumps(result)
    print(blob)
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(blob + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

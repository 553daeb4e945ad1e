#!/usr/bin/env python3
"""Time the port node's delivery drain with payloads pending behind lost
sequences, on the host's CPU.

    python3 scripts/drain_bench.py [--tree DIR] [--reps N] [--parked N ...]

For each count, a Service's commit heap first takes that many payloads of
80 senders whose first sequence never arrives, and one drain parks them;
then each of ``--reps`` drains takes 8 fresh senders' first transfers,
which commit. Prints the median seconds of those drains, a line a count.
``--tree`` imports ``at2_node_tpu_torch`` from another checkout (its
parent, say), so that two trees are timed by one script.
"""

import argparse
import asyncio
import os
import sys
import time
import types


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parked", type=int, nargs="+", default=[0, 1000, 4000, 8000])
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np

    from at2_node_tpu_torch.broadcast.messages import Payload
    from at2_node_tpu_torch.ledger.accounts import Accounts
    from at2_node_tpu_torch.node.service import Service
    from at2_node_tpu_torch.types import ThinTransaction

    rng = np.random.default_rng(2026)

    def key() -> bytes:
        return bytes(rng.integers(0, 256, 32, dtype=np.uint8))

    async def drains(parked: int) -> float:
        svc = Service.__new__(Service)  # only what the drain reads
        svc.accounts = Accounts()
        svc.clock = types.SimpleNamespace(monotonic=time.monotonic)
        svc.store, svc.ledger_failpoint, svc.mesh, svc._closing = None, None, None, False
        svc.config = types.SimpleNamespace(catchup=types.SimpleNamespace(enabled=False))
        svc._heap, svc._heap_keys, svc._push_count, svc._catchup_keys = [], set(), 0, set()
        svc._parked, svc._parked_n = {}, 0  # read by trees that park, unused by others
        svc._drain_lock = asyncio.Lock()

        async def commit_tail(commits, ring_ops) -> None:
            return None

        svc._commit_tail = commit_tail
        to, senders = key(), [key() for _ in range(80)]
        for i in range(parked):
            p = Payload(senders[i % 80], 2 + i // 80, ThinTransaction(to, 1), bytes(64))
            svc._push_pending(p, time.monotonic())
        await svc._drain_to_fixpoint()
        seconds = []
        for _ in range(args.reps):
            for _ in range(8):
                svc._push_pending(Payload(key(), 1, ThinTransaction(to, 1), bytes(64)), time.monotonic())
            t0 = time.perf_counter()
            await svc._drain_to_fixpoint()
            seconds.append(time.perf_counter() - t0)
        return sorted(seconds)[len(seconds) // 2]

    for parked in args.parked:
        print(f"{parked} payloads pending behind lost sequences: a drain of 8 arrivals "
              f"{1e3 * asyncio.run(drains(parked)):.2f} ms (median of {args.reps}; {args.tree})")


if __name__ == "__main__":
    main()

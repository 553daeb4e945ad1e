#!/usr/bin/env python3
"""Run host-heavy phases of ``chip_smoke.py`` again and again in one call on
the card, to tell a fault of the port from a stall of the host.

    python3 chip_loop.py [--reps N] [--seed S] PHASE...

PHASE is ``12c`` (plane_bench's three smokes), ``13`` or ``14``. The phases
run in the order given, each ``--reps`` times, after phase 1, the build and
phase 3 at 256 lanes (phase 13 reads that time). A repetition whose phase
raises is recorded as missed and the loop goes on; ``chip_smoke``'s stall
sentinel gives the longest overshoot of its 50 ms sleeps in each
repetition. One line a repetition starts ``LOOP``; the rows go to
``chiprun_out/chip_loop.json``; the exit code is 1 if any repetition
missed. To loop another tree, run that tree's own ``chip_loop.py``.
"""

import argparse
import asyncio
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("phases", nargs="+", choices=("12c", "13", "14"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=2026)
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    out_path = os.path.join(here, "chiprun_out", "chip_loop.json")
    sys.path.insert(0, here)
    import numpy as np
    import torch

    import chip_smoke as cs
    from at2_node_tpu_torch import prebuild
    from at2_node_tpu_torch.tools import plane_bench as pb

    cs.SENTINEL = cs.StallSentinel()
    card = cs.device_report(torch)
    prebuild.build_all(cs.log)
    cs.KERNEL_LANES = (256,)
    kp = cs.kernel_vs_plain(torch, cs.Material(args.seed), np.random.default_rng(args.seed))
    times = {"ed25519_verify": kp["by_lanes"]}
    name = torch.cuda.get_device_name(0)

    def smokes():
        for shards, executor in ((1, "thread"), (2, "thread"), (2, "process")):
            res = pb.smoke_profile(3, 200, 120.0, shards=shards, executor=executor, verifier="cuda")
            cs.check(res["ok"], f"smoke {executor}/{shards}: zero {res['zero_phases']}, worker-side "
                     f"{res['shard_zero_phases']}, folded {res['folded_lines']}, frames "
                     f"{res['worker_folded_frames']}, timed out {res['timed_out']}")

    phases = {
        "12c": smokes,
        "13": lambda: asyncio.run(cs.overload_path(args.seed, times, name, card)),
        "14": lambda: asyncio.run(cs.overload_ab_path(args.seed, card)),
    }
    rows = []
    for phase in args.phases:
        for rep in range(args.reps):
            cs.SENTINEL.take()
            t0 = time.perf_counter()
            error = ""
            try:
                phases[phase]()
            except Exception as exc:  # a miss is recorded and the loop goes on
                error = str(exc)[-4000:]
            row = {"phase": phase, "rep": rep, "held": not error, "seconds": round(time.perf_counter() - t0, 1),
                   "sentinel_max_ms": round(1e3 * cs.SENTINEL.take(), 1), "error": error, "card": card}
            rows.append(row)
            cs.log(f"LOOP {phase} #{rep}: {'held' if row['held'] else 'MISSED'} {row['seconds']} s, sentinel "
                   f"max {row['sentinel_max_ms']} ms" + (f"; {error[-1500:]}" if error else ""))
            os.makedirs(os.path.dirname(out_path), exist_ok=True)
            with open(out_path, "w") as f:
                json.dump({"rows": rows}, f, indent=1)
    return 0 if all(r["held"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())

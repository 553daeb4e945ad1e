"""Deterministic simulation campaigns from the command line.

Counterpart of ``at2_node_tpu/tools/sim_run.py``.

Runs seeded adversarial episodes of the REAL AT2 stack (see
`at2_node_tpu_torch/sim/`) — no sockets, no wall-clock waits — checks the
safety invariants after every episode, and banks the results as JSON.
The campaign hash (sha256 over per-episode wire-trace hashes) is the
determinism fingerprint: the same ``--seed`` with the same parameters
must reproduce it byte-identically on any host (CI gates on this).

Usage:
    python -m at2_node_tpu_torch.tools.sim_run --seed 1 --episodes 50
        [--nodes 4] [--faults 1] [--hostile 1] [--events 30]
        [--broker] [--durability] [--salting] [--minimize]
        [--trace-out results.json] [--quiet]

Exit status: 0 if every episode's invariants held, 1 if any violated
(the banked JSON then carries each failure's exact replay recipe —
episode seed + event list + minimized schedule with ``--minimize``).

Determinism note: the process re-executes itself with PYTHONHASHSEED=0
when hash randomization is active — set iteration order feeds the
schedule, and a randomized hash seed would make same-seed runs diverge
across processes.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time


def _pin_hashseed(argv=None) -> None:
    """Re-exec under PYTHONHASHSEED=0 unless already pinned: trace
    hashes must not depend on the interpreter's hash randomization.
    ``argv`` is the re-exec command tail (defaults to ``sys.argv``,
    right for script execution; module execution must pass its ``-m``
    form, a script path cannot resolve the package-relative imports)."""
    if os.environ.get("PYTHONHASHSEED", "") != "0":
        env = dict(os.environ, PYTHONHASHSEED="0")
        cmd = [sys.executable] + (argv if argv is not None else sys.argv)
        os.execve(sys.executable, cmd, env)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="sim_run", description=__doc__.splitlines()[0]
    )
    parser.add_argument("--seed", type=int, default=1,
                        help="campaign seed (default 1)")
    parser.add_argument("--episodes", type=int, default=50,
                        help="episodes to run (default 50)")
    parser.add_argument("--nodes", type=int, default=4,
                        help="correct nodes per episode (default 4)")
    parser.add_argument("--faults", type=int, default=1,
                        help="tolerated faults f (default 1)")
    parser.add_argument("--hostile", type=int, default=1,
                        help="byzantine identities injecting frames (default 1)")
    parser.add_argument("--events", type=int, default=30,
                        help="events per episode (default 30)")
    parser.add_argument("--duration", type=float, default=20.0,
                        help="virtual seconds of event injection (default 20)")
    parser.add_argument("--broker", action="store_true",
                        help="byzantine-broker campaign: distilled-frame "
                        "ingress with broker mutations (dup / reorder / "
                        "garbage / withhold) plus a forged-commit sweep")
    parser.add_argument("--durability", action="store_true",
                        help="durability campaign: nodes run on sharded "
                        "stores and the schedule injects crash/restart "
                        "cycles, flushes (stale-checkpoint restarts), "
                        "catchup partitions, and membership reconfigs; "
                        "invariants add no-post-restart-equivocation")
    parser.add_argument("--salting", action="store_true",
                        help="batch-poisoning campaign: one byzantine "
                        "client salts bad signatures into bulk flushes "
                        "while the shared verifier runs amortized (RLC) "
                        "verification; invariants add bounded "
                        "amortization loss + router convergence")
    parser.add_argument("--plane-shards", type=int, default=1,
                        metavar="N",
                        help="run every episode with the broadcast plane "
                        "sharded N ways (inline executor; the campaign "
                        "hash must match the shards=1 hash — shard count "
                        "is unobservable on the sim wire)")
    parser.add_argument("--minimize", action="store_true",
                        help="greedily minimize each failing schedule")
    parser.add_argument("--trace-out", metavar="PATH",
                        help="bank full campaign results as JSON")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress per-episode progress lines")
    args = parser.parse_args(argv)

    # node-internal warnings (hostile frames, timeouts) are episode
    # noise here, not operator signal
    logging.disable(logging.WARNING)

    from ..sim.campaign import run_campaign

    wall0 = time.monotonic()

    def progress(ep: int, result) -> None:
        if args.quiet:
            return
        status = "ok" if result.ok else f"VIOLATED: {result.violations[0]}"
        print(
            f"episode {ep:3d} seed {result.seed:>10d}  "
            f"committed {result.committed}  "
            f"virtual {result.virtual_time:6.1f}s  "
            f"wall {result.wall_seconds:5.2f}s  {status}",
            flush=True,
        )

    campaign = run_campaign(
        args.seed,
        args.episodes,
        nodes=args.nodes,
        f=args.faults,
        hostile=args.hostile,
        n_events=args.events,
        duration=args.duration,
        minimize=args.minimize,
        progress=progress,
        broker=args.broker,
        durability=args.durability,
        salting=args.salting,
        config_overrides=(
            {"plane_shards": args.plane_shards}
            if args.plane_shards > 1
            else None
        ),
    )
    campaign["wall_seconds"] = round(time.monotonic() - wall0, 2)
    campaign["argv"] = sys.argv[1:]

    if args.trace_out:
        with open(args.trace_out, "w") as fp:
            json.dump(campaign, fp, indent=1)
        print(f"banked {args.trace_out}", file=sys.stderr)

    print(
        f"campaign seed {args.seed}: {args.episodes} episodes, "
        f"{campaign['failures']} failures, "
        f"hash {campaign['campaign_hash']}, "
        f"{campaign['wall_seconds']}s wall"
    )
    for r in campaign["results"]:
        if not r["ok"]:
            print(
                f"  FAILING episode seed {r['seed']}: {r['violations']}"
                + (
                    f" (minimized to {len(r['minimized'])} events)"
                    if r.get("minimized")
                    else ""
                )
            )
    return 0 if campaign["failures"] == 0 else 1


if __name__ == "__main__":
    _pin_hashseed(["-m", "at2_node_tpu_torch.tools.sim_run"] + sys.argv[1:])
    sys.exit(main())

"""Run the overload-control A/B bench from the command line.

Counterpart of ``at2_node_tpu/tools/overload_ab.py``.

Each workload (scaled flash_crowd, hot_account) runs TWICE against a
finite modeled verifier pool (sim/scenarios.ModeledVerifier) with the
identical offered schedule: once with the [overload] table off — the
collapse baseline — and once with the closed-loop controller on. The
bench's claim is the pair: the uncontrolled arm must breach the
steady-tier latency SLO, the controlled arm must hold it while keeping
Jain fairness for the steady (pre-registered) senders above the floor.
Latency is client-perceived (offered time → fleet commit, retry
hold-offs included).

Results bank as BENCH_OVERLOAD.json; ``ab_hash`` (sha256 over per-cell
wire-trace hashes) is the determinism fingerprint — same ``--seed``,
same parameters, same hash on any host (the ci.sh ``overload`` gate
runs it twice and compares).

Usage:
    python -m at2_node_tpu_torch.tools.overload_ab --seed 11 \\
        [--clients 120] [--crowd 80] [--txs 160] [--duration 12] \\
        [--workload flash_crowd] [--out BENCH_OVERLOAD.json] [--json]

Exit status: 0 when every pair held its A/B claim and the AT2
invariants, 1 otherwise.

Determinism note: re-executes itself with PYTHONHASHSEED=0 when hash
randomization is active, same as sim_run — set iteration order feeds
the schedule.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="overload_ab", description=__doc__.splitlines()[0]
    )
    parser.add_argument("--seed", type=int, default=11,
                        help="bench seed (default 11)")
    parser.add_argument("--workload", action="append",
                        choices=("flash_crowd", "hot_account"),
                        help="run only this workload (repeatable; "
                        "default: both)")
    parser.add_argument("--clients", type=int, default=120,
                        help="client identities per cell (default 120)")
    parser.add_argument("--crowd", type=int, default=80,
                        help="flash-crowd newcomer senders — the last "
                        "CROWD client indices (default 80)")
    parser.add_argument("--txs", type=int, default=160,
                        help="transactions per cell (default 160)")
    parser.add_argument("--duration", type=float, default=12.0,
                        help="virtual seconds of injection (default 12)")
    parser.add_argument("--retry-budget", type=int, default=4,
                        help="client retries per shed tx (default 4)")
    parser.add_argument("--out", metavar="PATH",
                        help="bank the A/B results as JSON")
    parser.add_argument("--json", action="store_true",
                        help="print full JSON instead of the summary")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress per-cell progress lines")
    args = parser.parse_args(argv)

    # node-internal warnings (self-transfers, shed noise) are cell
    # noise here, not operator signal
    logging.disable(logging.WARNING)

    from ..sim.scenarios import run_overload_ab
    from ._common import host_context

    def progress(cell: dict) -> None:
        if args.quiet:
            return
        want_breach = cell["arm"] == "uncontrolled"
        held = (not cell["slo_ok"]) if want_breach else (
            cell["slo_ok"] and cell["fairness_ok"]
        )
        verdict = "ok" if held else "A/B CLAIM FAILED"
        if cell["violations"]:
            verdict = f"VIOLATED: {cell['violations'][0]}"
        print(
            f"{cell['workload']:<12} {cell['arm']:<13}"
            f"committed {cell['committed']:4d}/{cell['offered']:4d}  "
            f"shed {cell['shed']:4d}  "
            f"steady p99 {cell['steady_p99_ms']:8.1f}ms "
            f"(slo {cell['latency_slo_ms']:.0f})  "
            f"fair {cell['fairness']:.3f}  "
            f"wall {cell['wall_seconds']:5.1f}s  {verdict}",
            flush=True,
        )

    wall0 = time.monotonic()
    doc = run_overload_ab(
        args.seed,
        workloads=tuple(args.workload or ("flash_crowd", "hot_account")),
        n_clients=args.clients,
        crowd=args.crowd,
        n_tx=args.txs,
        duration=args.duration,
        retry_budget=args.retry_budget,
        progress=progress,
    )
    doc["wall_seconds"] = round(time.monotonic() - wall0, 2)
    doc["generated_by"] = "at2_node_tpu_torch.tools.overload_ab"
    doc["argv"] = sys.argv[1:]
    doc["host_context"] = host_context()

    if args.out:
        with open(args.out, "w") as fp:
            json.dump(doc, fp, indent=1, sort_keys=True)
        print(f"banked {args.out}", file=sys.stderr)

    if args.json:
        print(json.dumps(doc, sort_keys=True, indent=1))
    else:
        print(
            f"overload A/B seed {args.seed}: {len(doc['cells'])} cells, "
            f"{'ok' if doc['ok'] else 'FAILED'}, hash {doc['ab_hash']}, "
            f"{doc['wall_seconds']}s wall"
        )
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    from .sim_run import _pin_hashseed

    _pin_hashseed(["-m", "at2_node_tpu_torch.tools.overload_ab"] + sys.argv[1:])
    sys.exit(main())

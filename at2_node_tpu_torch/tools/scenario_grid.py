"""Run the WAN scenario observability grid from the command line.

Counterpart of ``at2_node_tpu/tools/scenario_grid.py``.

Each cell of the (topology × workload × fault-mix) matrix runs the real
node stack on the deterministic simulator (sim/scenarios.py), measures
throughput / commit latency / fairness from the fleet's own
observability surfaces, and evaluates the cell's service-level
objectives with the same burn-rate machinery a live node serves on
``/sloz``. Results bank as JSON; the grid hash (sha256 over per-cell
wire-trace hashes) is the determinism fingerprint — same ``--seed``,
same parameters, same hash on any host (CI gates on this).

Usage:
    python -m at2_node_tpu_torch.tools.scenario_grid --seed 1
        [--smoke] [--nodes 4] [--clients 6] [--txs 48] [--duration 12]
        [--out BENCH_SCENARIOS.json] [--quiet]
    python -m at2_node_tpu_torch.tools.scenario_grid --seed 1 \\
        --replay wan3/flash_crowd/none [--json]

``--smoke`` runs the 2×2 CI slice (LAN/WAN × steady/flash-crowd, no
faults). ``--replay T/W/F`` re-runs exactly one cell — its seed derives
from the grid seed and the cell coordinates, so the printed trace hash
must match the banked cell's byte-for-byte.

Exit status: 0 when every cell met its SLOs and held the AT2
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
        prog="scenario_grid", description=__doc__.splitlines()[0]
    )
    parser.add_argument("--seed", type=int, default=1,
                        help="grid seed (default 1)")
    parser.add_argument("--smoke", action="store_true",
                        help="2x2 CI slice: LAN/WAN x steady/flash-crowd, "
                        "no faults")
    parser.add_argument("--replay", metavar="TOPO/WORKLOAD/FAULTS[+wan]",
                        help="re-run exactly one cell and print it "
                        "(+wan replays the [wan]-knobs-on variant)")
    parser.add_argument("--nodes", type=int, default=4,
                        help="correct nodes per cell (default 4)")
    parser.add_argument("--faults", type=int, default=1,
                        help="tolerated faults f (default 1)")
    parser.add_argument("--clients", type=int, default=6,
                        help="client identities per cell (default 6)")
    parser.add_argument("--txs", type=int, default=48,
                        help="transactions per cell (default 48)")
    parser.add_argument("--duration", type=float, default=12.0,
                        help="virtual seconds of injection (default 12)")
    parser.add_argument("--out", metavar="PATH",
                        help="bank the grid results as JSON")
    parser.add_argument("--json", action="store_true",
                        help="print full JSON instead of the summary")
    parser.add_argument("--quiet", action="store_true",
                        help="suppress per-cell progress lines")
    args = parser.parse_args(argv)

    # node-internal warnings (gap timeouts during partitions) are cell
    # noise here, not operator signal
    logging.disable(logging.WARNING)

    from ..sim.scenarios import GRID, SMOKE, _seed_int, run_cell, run_grid
    from ._common import host_context

    kw = dict(
        nodes=args.nodes, f=args.faults, n_clients=args.clients,
        n_tx=args.txs, duration=args.duration,
    )

    if args.replay:
        # a trailing "+wan" replays the WAN_GRID variant of the cell:
        # [wan] knobs on, and "wan" folded into the seed derivation the
        # same way run_grid does it
        spec, _, variant = args.replay.partition("+")
        wan = variant == "wan"
        if variant and not wan:
            parser.error(f"unknown cell variant {variant!r}")
        try:
            topology, workload, faults = spec.split("/")
        except ValueError:
            parser.error("--replay wants TOPOLOGY/WORKLOAD/FAULTS[+wan]")
        seed_parts = ("grid", args.seed, topology, workload, faults) + (
            ("wan",) if wan else ()
        )
        cell_seed = _seed_int(*seed_parts) % (1 << 32)
        cell = run_cell(cell_seed, topology, workload, faults, wan=wan, **kw)
        if args.json:
            print(json.dumps(cell, sort_keys=True, indent=1))
        else:
            print(
                f"cell {args.replay} seed {cell['seed']}: "
                f"committed {cell['committed']}/{cell['offered']}, "
                f"p99 {cell['latency_p99_ms']}ms, "
                f"fairness {cell['fairness']}, "
                f"{'ok' if cell['ok'] else 'BREACHING'}, "
                f"hash {cell['trace_hash']}"
            )
        return 0 if cell["ok"] else 1

    def progress(cell: dict) -> None:
        if args.quiet:
            return
        verdict = "ok"
        if cell["violations"]:
            verdict = f"VIOLATED: {cell['violations'][0]}"
        elif not cell["slo"]["ok"]:
            verdict = "SLO BREACH: " + ",".join(cell["slo"]["breaching"])
        tag = "+wan" if cell.get("wan") else ""
        print(
            f"{cell['topology']:>5}/{cell['workload']:<12}"
            f"faults={cell['faults'] + tag:<9} "
            f"committed {cell['committed']:3d}/{cell['offered']:3d}  "
            f"tput {cell['throughput_tps']:6.2f}tps  "
            f"p99 {cell['latency_p99_ms']:8.1f}ms  "
            f"fair {cell['fairness']:.3f}  "
            f"wall {cell['wall_seconds']:5.2f}s  {verdict}",
            flush=True,
        )

    wall0 = time.monotonic()
    grid = run_grid(
        args.seed, SMOKE if args.smoke else GRID, progress=progress, **kw
    )
    grid["wall_seconds"] = round(time.monotonic() - wall0, 2)
    grid["generated_by"] = "at2_node_tpu_torch.tools.scenario_grid"
    grid["argv"] = sys.argv[1:]
    grid["host_context"] = host_context()

    if args.out:
        with open(args.out, "w") as fp:
            json.dump(grid, fp, indent=1, sort_keys=True)
        print(f"banked {args.out}", file=sys.stderr)

    if args.json:
        print(json.dumps(grid, sort_keys=True, indent=1))
    else:
        n_bad = len(grid["breaching"])
        print(
            f"grid seed {args.seed}: {len(grid['cells'])} cells, "
            f"{n_bad} breaching, hash {grid['grid_hash']}, "
            f"{grid['wall_seconds']}s wall"
        )
        for name in grid["breaching"]:
            print(f"  BREACHING cell {name}")
    return 0 if not grid["breaching"] else 1


if __name__ == "__main__":
    from .sim_run import _pin_hashseed

    _pin_hashseed(["-m", "at2_node_tpu_torch.tools.scenario_grid"] + sys.argv[1:])
    sys.exit(main())

"""Fleet plane-time decomposition: profile every node, name the serial term.

Counterpart of ``at2_node_tpu/tools/profile_collect.py``: the same
decomposition and report, the collector's build line naming ``torch=``.
It polls nodes over HTTP and touches no device itself.

The continuous-profiler companion to trace_collect: for each
node it snapshots the phase-accounting counters from /statusz, starts a
sampling capture via /profilez?start&duration=D, waits out the window,
snapshots the counters again, and pulls the folded stacks. The counter
*deltas* over the window give an exact per-phase time decomposition of
the broadcast planes (shares of plane_total), and the hottest folded
stack attributes the top serial term to a file:line.

Usage:
    python -m at2_node_tpu_torch.tools.profile_collect HOST:PORT [HOST:PORT ...]
        [--duration 5.0] [--min-coverage 0.0] [--json] [--out FILE]

Per node the report shows:
  - the phase table: share of plane_total per leaf phase (rx decode,
    verify wait, echo apply, quorum bitmap, ready/deliver, entry
    registry) plus the off-plane accounts (slot gc, commit tail,
    verifier flush) as absolute ms,
  - coverage: how much of plane wall time the leaf phases explain
    (sum of leaf shares; the remainder is unmarked glue),
  - the top serial term: the largest leaf share, attributed to the
    hottest sampled stack's leaf frame (file:line),
  - the node's build block (git SHA, Python/torch versions, config hash)
    so reports are comparable across fleet versions,
  - in process mode, a per-shard row per worker (its plane wall time and
    hottest leaf phase from the ``phase_*_shardN_ns`` fold); the
    coverage denominator is the MERGED plane total — owner
    ``phase_plane_total_ns`` delta plus every worker's
    ``phase_plane_total_shardN_ns`` delta — so coverage stays honest
    when most plane time runs inside worker processes.

``--min-coverage PCT`` makes the exit code a gate: nonzero when any
node's leaf phases explain less than PCT% of its plane wall time —
that means a new serial term appeared that nothing accounts for.
Unreachable nodes always fail the run.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import re
import sys

from ..obs.profiler import PLANE_LEAF_PHASES, PHASES, build_info
from ._common import fetch_json, parse_addr as _parse_addr

_OFF_PLANE = tuple(
    p for p in PHASES if p not in PLANE_LEAF_PHASES and p != "plane_total"
)

# process-mode fold keys (broadcast/shards.py): per-shard phase counters
_SHARD_KEY = re.compile(r"^phase_([a-z_]+)_shard(\d+)_ns$")


def _phase_deltas(stats0: dict, stats1: dict) -> dict:
    """ns spent per phase over the capture window, from the exact
    counters the hot paths bump (phase_<name>_ns in /statusz stats)."""
    out = {}
    for p in PHASES:
        key = f"phase_{p}_ns"
        v0, v1 = stats0.get(key, 0), stats1.get(key, 0)
        if isinstance(v0, (int, float)) and isinstance(v1, (int, float)):
            out[p] = max(0, int(v1) - int(v0))
        else:
            out[p] = 0
    return out


def _shard_deltas(stats0: dict, stats1: dict) -> dict:
    """Per-shard phase ns deltas, ``{shard_id: {phase: ns}}``, from the
    ``phase_<p>_shard<k>_ns`` counters the process-mode obs fold
    maintains (broadcast/shards.py). Empty in thread/inline mode —
    those counters simply never exist there."""
    out: dict = {}
    for key, v1 in stats1.items():
        m = _SHARD_KEY.match(key) if isinstance(key, str) else None
        if not m or not isinstance(v1, (int, float)):
            continue
        v0 = stats0.get(key, 0)
        if not isinstance(v0, (int, float)):
            v0 = 0
        out.setdefault(int(m.group(2)), {})[m.group(1)] = max(
            0, int(v1) - int(v0)
        )
    return out


def _top_folded_leaf(folded_lines) -> str:
    """file:line attribution from the hottest sampled stack: the leaf
    frame of the highest-count folded line (labels are
    ``basename:func`` interior, ``basename:func:lineno`` leaf)."""
    best, best_count = None, -1
    for line in folded_lines or ():
        stack, _, count = line.rpartition(" ")
        if not stack or not count.isdigit():
            continue
        if int(count) > best_count:
            best_count = int(count)
            best = stack.rsplit(";", 1)[-1]
    return best or "(no samples)"


def decompose(stats0: dict, stats1: dict, profile: dict) -> dict:
    """One node's plane decomposition from two /statusz snapshots and
    the /profilez dump. Pure function of its inputs — unit-testable."""
    deltas = _phase_deltas(stats0, stats1)
    shard = _shard_deltas(stats0, stats1)
    # merged denominator: worker leaf time folds into the base counters,
    # but worker plane_total lives ONLY under the shard keys — counting
    # just the owner's plane_total would overstate coverage in process
    # mode (leaves from N workers over one owner's wall time)
    total = deltas.get("plane_total", 0) + sum(
        d.get("plane_total", 0) for d in shard.values()
    )
    shares = {
        p: (deltas[p] / total if total else 0.0) for p in PLANE_LEAF_PHASES
    }
    coverage = sum(shares.values())
    top_phase = max(
        PLANE_LEAF_PHASES, key=lambda p: shares[p]
    ) if total else None
    shards_out = {}
    for sid in sorted(shard):
        d = shard[sid]
        st = d.get("plane_total", 0)
        leaf = {p: d.get(p, 0) for p in PLANE_LEAF_PHASES}
        top = max(leaf, key=lambda p: leaf[p]) if any(leaf.values()) else None
        shards_out[sid] = {
            "plane_total_ms": st / 1e6,
            "phase_ms": {p: leaf[p] / 1e6 for p in PLANE_LEAF_PHASES},
            "shares": {
                p: (leaf[p] / st if st else 0.0) for p in PLANE_LEAF_PHASES
            },
            "top_phase": top,
        }
    return {
        "plane_total_ms": total / 1e6,
        "owner_plane_total_ms": deltas.get("plane_total", 0) / 1e6,
        "phase_ms": {p: deltas[p] / 1e6 for p in PHASES},
        "shares": shares,
        "shards": shards_out,
        "off_plane_ms": {p: deltas[p] / 1e6 for p in _OFF_PLANE},
        "coverage": coverage,
        "top_serial": {
            "phase": top_phase,
            "share": shares[top_phase] if top_phase else 0.0,
            "site": _top_folded_leaf(profile.get("folded")),
        },
        "sampler": profile.get("sampler", {}),
        "build": profile.get("build", {}),
    }


async def collect_node(host: str, port: int, duration: float) -> dict:
    """statusz -> start capture -> wait -> statusz + profilez."""
    sz0 = await fetch_json(host, port, "/statusz")
    started = await fetch_json(
        host, port, f"/profilez?start&duration={duration:g}"
    )
    # +0.5s slack so the sampler's own deadline stop lands first and
    # the folded dump covers the full window
    await asyncio.sleep(duration + 0.5)
    sz1 = await fetch_json(host, port, "/statusz")
    profile = await fetch_json(host, port, "/profilez")
    rec = decompose(sz0.get("stats", {}), sz1.get("stats", {}), profile)
    rec["capture_started"] = bool(started.get("started"))
    rec["node"] = sz1.get("node")
    return rec


def render(results, duration: float, min_coverage: float, out) -> int:
    """The human report; returns the exit code (the gate)."""
    info = build_info()
    print(
        f"profile_collect  duration={duration:g}s  "
        f"collector git={info['git_sha']} python={info['python']} "
        f"torch={info['torch']}",
        file=out,
    )
    rc = 0
    for addr, rec in results:
        if isinstance(rec, Exception):
            print(f"\n{addr}  DOWN {type(rec).__name__}: {rec}", file=out)
            rc = 1
            continue
        build = rec.get("build", {})
        print(
            f"\n{addr}  node={rec.get('node')}  "
            f"git={build.get('git_sha')} cfg={build.get('config_hash')} "
            f"uptime={build.get('uptime_s')}s",
            file=out,
        )
        total = rec["plane_total_ms"]
        shards = rec.get("shards") or {}
        if shards:
            print(
                f"  plane_total {total:.1f} ms over the window "
                f"(owner {rec.get('owner_plane_total_ms', 0.0):.1f} ms + "
                f"{len(shards)} worker shard"
                f"{'s' if len(shards) != 1 else ''})",
                file=out,
            )
        else:
            print(f"  plane_total {total:.1f} ms over the window", file=out)
        for p in PLANE_LEAF_PHASES:
            print(
                f"    {p:<16}{rec['phase_ms'][p]:>10.1f} ms"
                f"{100.0 * rec['shares'][p]:>8.1f} %",
                file=out,
            )
        cov = 100.0 * rec["coverage"]
        print(f"    {'coverage':<16}{'':>10}   {cov:>6.1f} %", file=out)
        off = "  ".join(
            f"{p}={rec['off_plane_ms'][p]:.1f}ms" for p in _OFF_PLANE
        )
        print(f"  off-plane: {off}", file=out)
        for sid in sorted(shards, key=int):
            srec = shards[sid]
            top = srec.get("top_phase")
            top_s = (
                f"{top} {100.0 * srec['shares'][top]:.1f}%"
                if top else "(idle)"
            )
            print(
                f"  shard{sid}: plane {srec['plane_total_ms']:>8.1f} ms"
                f"  top {top_s}",
                file=out,
            )
        top = rec["top_serial"]
        print(
            f"  top serial term: {top['phase']} "
            f"({100.0 * top['share']:.1f}% of plane) at {top['site']}",
            file=out,
        )
        samples = rec.get("sampler", {}).get("samples", 0)
        print(f"  sampler: {samples} samples", file=out)
        if min_coverage and cov < min_coverage:
            print(
                f"  COVERAGE BELOW GATE: {cov:.1f}% < {min_coverage:g}% "
                "— an unmarked serial term is eating plane time",
                file=out,
            )
            rc = 1
    return rc


async def run(addrs, duration: float) -> list:
    results = await asyncio.gather(
        *(collect_node(h, p, duration) for h, p in addrs),
        return_exceptions=True,
    )
    return [(f"{h}:{p}", r) for (h, p), r in zip(addrs, results)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("nodes", nargs="+", metavar="HOST:PORT")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="sampling window per node in seconds (default 5)")
    ap.add_argument("--min-coverage", type=float, default=0.0,
                    metavar="PCT",
                    help="fail (nonzero exit) when leaf phases explain "
                         "less than PCT%% of plane wall time")
    ap.add_argument("--json", action="store_true",
                    help="dump the raw per-node decompositions as JSON")
    ap.add_argument("--out", default=None,
                    help="also write the JSON report to this file")
    args = ap.parse_args(argv)
    addrs = [_parse_addr(a) for a in args.nodes]
    results = asyncio.run(run(addrs, args.duration))
    doc = {
        "collector_build": build_info(),
        "duration": args.duration,
        "nodes": {
            a: (str(r) if isinstance(r, Exception) else r)
            for a, r in results
        },
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True, default=float)
            fh.write("\n")
    if args.json:
        print(json.dumps(doc, indent=2, sort_keys=True, default=float))
        return render(results, args.duration, args.min_coverage,
                      out=sys.stderr)
    return render(results, args.duration, args.min_coverage,
                  out=sys.stdout)


if __name__ == "__main__":
    sys.exit(main())

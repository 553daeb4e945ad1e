"""Fleet-wide causal trace stitching: poll /tracez, join spans, emit

Counterpart of ``at2_node_tpu/tools/trace_collect.py``.

operator summaries + Chrome trace JSON.

Every node's lifecycle tracer (obs/trace.py) keeps per-stage wall +
monotonic stamps for the transactions it saw — origin records where the
tx entered through that node's RPC ingress, relay records everywhere
else. Trace keys are ``(sender, sequence)``, the identity the broadcast
plane itself dedups on, so they are globally unique: joining records by
key across nodes reconstructs the full causal timeline of a transfer
through the fleet (Dapper's join, without propagated span ids — AT2's
keys already are the trace ids).

Clock normalization: every stamp is re-expressed relative to the ORIGIN
node's ingress wall stamp (t=0 = the moment the client hit the fleet).
Under the deterministic simulator all nodes share one virtual clock, so
stitched timelines are exact and byte-identical for a seed; on real
hosts the residual error is the NTP skew between machines, which is the
standard tracing caveat and fine at the millisecond scales that matter
here.

Three consumers:

* ``stitch(dumps)`` — the pure join; returns a JSON-able dict with
  per-tx multi-node timelines, per-stage straggler attribution (which
  peer was last into the echo/ready quorum), per-stage cross-node
  p50/p99, and coverage accounting. sim/campaign.py calls this directly
  to attach stitched timelines to failing episodes.
* ``render_summary(stitched)`` — the operator text.
* ``chrome_trace(stitched)`` — Chrome trace-event JSON: open it in
  Perfetto (ui.perfetto.dev) or chrome://tracing; one process row per
  node, one thread row per transaction.

Usage:
    python -m at2_node_tpu_torch.tools.trace_collect HOST:PORT [HOST:PORT ...]
        [--limit N] [--chrome trace.json] [--stitched stitched.json]
        [--json] [--overlap]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import sys

from ._common import fetch_json, parse_addr as _parse_addr

# ladder order for sorting stages within a (tx, node) span; the broker
# hop precedes node ingress on the distilled path; rejected sits past
# committed (both are terminal, a record holds at most one).
# echo_quorum / ready_sent are the [wan] overlap markers: they sort at
# their SEMANTIC position (quorum observed, ready emitted) even though
# overlap_ready makes ready_sent fire temporally first.
_STAGE_ORDER = {
    s: i
    for i, s in enumerate(
        (
            "broker_rx",
            "broker_flush",
            "ingress",
            "admitted",
            "echoed",
            "echo_quorum",
            "ready_sent",
            "ready_quorum",
            "delivered",
            "committed",
            "rejected",
        )
    )
}
# the broker-hop latency decomposition: queue = sitting in the broker's
# pending buffer + distillation, handoff = flush → first node ingress
# (RPC + node-side verify/expand), plane = ingress → fleet-wide commit
_BROKER_SEGMENTS = ("queue_ms", "handoff_ms", "plane_ms", "total_ms")
# quorum stages: the LAST node to reach one is the straggler that
# bounded the fleet-wide latency of that phase
_STRAGGLER_STAGES = ("echoed", "ready_quorum", "delivered", "committed")


def _pctl(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile over an ascending list (deterministic)."""
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, max(0, math.ceil(q * len(sorted_vals)) - 1))
    return sorted_vals[i]


def stitch(dumps: list) -> dict:
    """Join per-node /tracez dumps (Service.tracez() shape) by
    (sender, seq). Pure function of its inputs — no wall-clock reads —
    so same dumps ⇒ byte-identical output."""
    # (sender_hex, seq) -> node -> record
    txs: dict = {}
    for dump in dumps:
        node = dump.get("node", "?")
        for rec in list(dump.get("completed", ())) + list(
            dump.get("live", ())
        ):
            key = (rec["sender"], rec["seq"])
            txs.setdefault(key, {})[node] = rec
    out_txs = []
    stage_rel: dict = {}  # stage -> [relative seconds across (tx, node)]
    straggler_counts: dict = {}  # stage -> node -> times it was last
    n_committed = n_stitched_committed = n_with_origin = 0
    n_with_broker = 0
    broker_seg: dict = {s: [] for s in _BROKER_SEGMENTS}
    broker_bottlenecks: dict = {}
    for key in sorted(txs):
        per_node = txs[key]
        origin_node = None
        t0 = None
        for node in sorted(per_node):
            rec = per_node[node]
            if rec.get("origin"):
                for s, _m, w in rec["stages"]:
                    if s == "ingress":
                        origin_node, t0 = node, w
                        break
            if origin_node is not None:
                break
        if t0 is None:
            # origin node not polled (or its record evicted): anchor on
            # the earliest wall stamp we do have — the timeline is still
            # internally consistent, just not client-relative
            t0 = min(
                w
                for rec in per_node.values()
                for _s, _m, w in rec["stages"]
            )
        committed = any(
            rec.get("terminal") == "committed" for rec in per_node.values()
        )
        terminal = None
        for rec in per_node.values():
            if rec.get("terminal"):
                terminal = rec["terminal"] if not committed else "committed"
                if committed:
                    break
        spans = []
        last_at: dict = {}  # stage -> (rel, node), max rel wins
        for node in sorted(per_node):
            rec = per_node[node]
            stages = sorted(
                rec["stages"], key=lambda s: _STAGE_ORDER.get(s[0], 99)
            )
            span_stages = []
            for s, _m, w in stages:
                rel = round(w - t0, 9)
                span_stages.append([s, rel])
                stage_rel.setdefault(s, []).append(rel)
                prev = last_at.get(s)
                if prev is None or rel > prev[0]:
                    last_at[s] = (rel, node)
            spans.append(
                {
                    "node": node,
                    "origin": bool(rec.get("origin")),
                    "terminal": rec.get("terminal"),
                    "stages": span_stages,
                }
            )
        stragglers = {}
        for s in _STRAGGLER_STAGES:
            hit = last_at.get(s)
            if hit is not None:
                stragglers[s] = [hit[1], hit[0]]
                straggler_counts.setdefault(s, {}).setdefault(hit[1], 0)
                straggler_counts[s][hit[1]] += 1
        # broker-hop decomposition: txs whose span set includes a broker
        # relay record get their end-to-end latency split into
        # queue (broker_rx→broker_flush), handoff (flush→first node
        # ingress), plane (ingress→fleet-wide commit). The dominant
        # segment is the hop's straggler attribution.
        broker_hop = None
        rx = flush = ingress_rel = commit_rel = None
        for rec in per_node.values():
            for s, _m, w in rec["stages"]:
                rel = w - t0
                if s == "broker_rx":
                    rx = rel if rx is None else min(rx, rel)
                elif s == "broker_flush":
                    flush = rel if flush is None else min(flush, rel)
                elif s == "ingress":
                    ingress_rel = (
                        rel if ingress_rel is None else min(ingress_rel, rel)
                    )
                elif s == "committed":
                    commit_rel = (
                        rel if commit_rel is None else max(commit_rel, rel)
                    )
        if rx is not None:
            n_with_broker += 1
            broker_hop = {"rx": round(rx, 9)}
            segs = {}
            if flush is not None:
                broker_hop["flush"] = round(flush, 9)
                segs["queue_ms"] = round((flush - rx) * 1e3, 6)
                if ingress_rel is not None:
                    segs["handoff_ms"] = round(
                        (ingress_rel - flush) * 1e3, 6
                    )
            if ingress_rel is not None and commit_rel is not None:
                segs["plane_ms"] = round(
                    (commit_rel - ingress_rel) * 1e3, 6
                )
            if commit_rel is not None:
                segs["total_ms"] = round((commit_rel - rx) * 1e3, 6)
            broker_hop.update(segs)
            for seg, v in segs.items():
                broker_seg[seg].append(v)
            ranked_segs = [
                (seg, segs[seg])
                for seg in ("queue_ms", "handoff_ms", "plane_ms")
                if seg in segs
            ]
            if ranked_segs and "total_ms" in segs:
                bottleneck = max(ranked_segs, key=lambda kv: kv[1])[0]
                broker_hop["bottleneck"] = bottleneck
                broker_bottlenecks.setdefault(bottleneck, 0)
                broker_bottlenecks[bottleneck] += 1
        if committed:
            n_committed += 1
            if len(per_node) > 1:
                n_stitched_committed += 1
        if origin_node is not None:
            n_with_origin += 1
        tx_out = {
            "sender": key[0],
            "seq": key[1],
            "origin_node": origin_node,
            "terminal": terminal,
            "nodes": len(per_node),
            "spans": spans,
            "stragglers": stragglers,
        }
        if broker_hop is not None:
            tx_out["broker_hop"] = broker_hop
        out_txs.append(tx_out)
    summary_stages = {}
    for s in sorted(stage_rel):
        vals = sorted(stage_rel[s])
        summary_stages[s] = {
            "count": len(vals),
            "p50_ms": round(1e3 * _pctl(vals, 0.50), 6),
            "p99_ms": round(1e3 * _pctl(vals, 0.99), 6),
            "max_ms": round(1e3 * vals[-1], 6) if vals else 0.0,
        }
    broker_summary = {
        "txs": n_with_broker,
        "segments": {
            seg: {
                "count": len(vals),
                "p50_ms": round(_pctl(sorted(vals), 0.50), 6),
                "p99_ms": round(_pctl(sorted(vals), 0.99), 6),
                "max_ms": round(max(vals), 6) if vals else 0.0,
            }
            for seg, vals in broker_seg.items()
            if vals
        },
        "bottleneck_counts": dict(sorted(broker_bottlenecks.items())),
    }
    return {
        "nodes": sorted(d.get("node", "?") for d in dumps),
        "coverage": {
            "txs": len(out_txs),
            "committed": n_committed,
            "stitched_committed": n_stitched_committed,
            "with_origin": n_with_origin,
            "with_broker": n_with_broker,
        },
        "stages": summary_stages,
        "straggler_counts": {
            s: dict(sorted(c.items()))
            for s, c in sorted(straggler_counts.items())
        },
        "broker_hop": broker_summary,
        "txs": out_txs,
    }


def phase_overlap(stitched: dict) -> dict:
    """Per-(tx, node) echo→ready phase gap from the overlap markers:
    ``gap_ms = ready_sent − echo_quorum``. Positive means Ready waited
    on the echo quorum (the serial two-round schedule), zero means both
    fired in the same advance, and NEGATIVE means Ready rode the same
    frame as the Echo — the [wan] overlap_ready piggyback that removes
    one long-haul round from the commit path. Spans missing either
    marker (captures predating the markers, relay records that never
    reached quorum) are skipped but counted."""
    rows = []
    skipped = 0
    for tx in stitched["txs"]:
        for span in tx["spans"]:
            marks = {s: rel for s, rel in span["stages"]}
            if "echo_quorum" not in marks or "ready_sent" not in marks:
                skipped += 1
                continue
            rows.append(
                {
                    "sender": tx["sender"],
                    "seq": tx["seq"],
                    "node": span["node"],
                    "gap_ms": round(
                        (marks["ready_sent"] - marks["echo_quorum"]) * 1e3,
                        6,
                    ),
                }
            )
    gaps = sorted(r["gap_ms"] for r in rows)
    return {
        "spans": len(rows),
        "skipped_spans": skipped,
        "piggybacked": sum(1 for g in gaps if g < 0.0),
        "gap_p50_ms": round(_pctl(gaps, 0.50), 6),
        "gap_p99_ms": round(_pctl(gaps, 0.99), 6),
        "gap_min_ms": round(gaps[0], 6) if gaps else 0.0,
        "gap_max_ms": round(gaps[-1], 6) if gaps else 0.0,
        "rows": rows,
    }


def render_overlap(report: dict) -> str:
    """Operator text for :func:`phase_overlap`."""
    return "\n".join(
        [
            f"phase overlap: {report['spans']} spans with both markers "
            f"({report['skipped_spans']} without), "
            f"{report['piggybacked']} piggybacked (gap < 0)",
            "  echo_quorum→ready_sent gap ms: "
            f"p50 {report['gap_p50_ms']:.3f}  "
            f"p99 {report['gap_p99_ms']:.3f}  "
            f"min {report['gap_min_ms']:.3f}  "
            f"max {report['gap_max_ms']:.3f}",
        ]
    )


def render_summary(stitched: dict) -> str:
    """Operator text: coverage, per-stage cross-node percentiles,
    straggler attribution."""
    cov = stitched["coverage"]
    lines = [
        f"nodes polled: {', '.join(stitched['nodes'])}",
        f"transactions: {cov['txs']} "
        f"(committed {cov['committed']}, "
        f"stitched across >1 node {cov['stitched_committed']}, "
        f"with origin ingress {cov['with_origin']}, "
        f"via broker {cov.get('with_broker', 0)})",
        "",
        f"{'stage':<14}{'spans':>7}{'p50 ms':>10}{'p99 ms':>10}"
        f"{'max ms':>10}",
    ]
    for s, row in stitched["stages"].items():
        lines.append(
            f"{s:<14}{row['count']:>7}{row['p50_ms']:>10.3f}"
            f"{row['p99_ms']:>10.3f}{row['max_ms']:>10.3f}"
        )
    sc = stitched.get("straggler_counts", {})
    if sc:
        lines.append("")
        lines.append("straggler attribution (node slowest into stage):")
        for s, counts in sc.items():
            ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
            lines.append(
                f"  {s:<13}"
                + "  ".join(f"{n}×{c}" for n, c in ranked)
            )
    bh = stitched.get("broker_hop", {})
    if bh.get("txs"):
        lines.append("")
        lines.append(
            f"broker hop ({bh['txs']} txs, "
            "queue = broker buffer+distill, handoff = flush→ingress, "
            "plane = ingress→commit):"
        )
        lines.append(
            f"  {'segment':<12}{'txs':>7}{'p50 ms':>10}{'p99 ms':>10}"
            f"{'max ms':>10}"
        )
        for seg in _BROKER_SEGMENTS:
            row = bh["segments"].get(seg)
            if row is None:
                continue
            lines.append(
                f"  {seg:<12}{row['count']:>7}{row['p50_ms']:>10.3f}"
                f"{row['p99_ms']:>10.3f}{row['max_ms']:>10.3f}"
            )
        bn = bh.get("bottleneck_counts", {})
        if bn:
            ranked = sorted(bn.items(), key=lambda kv: (-kv[1], kv[0]))
            lines.append(
                "  dominant segment: "
                + "  ".join(f"{s}×{c}" for s, c in ranked)
            )
    return "\n".join(lines)


def chrome_trace(stitched: dict) -> dict:
    """Chrome trace-event JSON (Perfetto / chrome://tracing): one
    process per node, one thread per transaction, one complete ("X")
    event per stage-to-stage hop plus an instant at the terminal."""
    pids = {n: i for i, n in enumerate(stitched["nodes"])}
    events = []
    for i, n in enumerate(stitched["nodes"]):
        events.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": i,
                "tid": 0,
                "args": {"name": f"node {n}"},
            }
        )
    for tid, tx in enumerate(stitched["txs"], start=1):
        label = f"{tx['sender'][:12]}#{tx['seq']}"
        for span in tx["spans"]:
            pid = pids.get(span["node"], len(pids))
            events.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": pid,
                    "tid": tid,
                    "args": {"name": label},
                }
            )
            stages = span["stages"]
            for (s1, t1), (s2, t2) in zip(stages, stages[1:]):
                events.append(
                    {
                        "ph": "X",
                        "name": f"{s1}→{s2}",
                        "cat": "at2",
                        "pid": pid,
                        "tid": tid,
                        "ts": int(round(t1 * 1e6)),
                        "dur": max(0, int(round((t2 - t1) * 1e6))),
                    }
                )
            if span["terminal"] and stages:
                events.append(
                    {
                        "ph": "i",
                        "name": span["terminal"],
                        "cat": "at2",
                        "pid": pid,
                        "tid": tid,
                        "ts": int(round(stages[-1][1] * 1e6)),
                        "s": "t",
                    }
                )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- CLI ------------------------------------------------------------------


async def collect(addrs, limit, timeout: float = 5.0) -> list:
    path = "/tracez" + (f"?limit={limit}" if limit is not None else "")
    results = await asyncio.gather(
        *(fetch_json(h, p, path, timeout) for h, p in addrs),
        return_exceptions=True,
    )
    dumps = []
    for (h, p), r in zip(addrs, results):
        if isinstance(r, Exception):
            print(f"warn: {h}:{p} unreachable: {r}", file=sys.stderr)
        else:
            dumps.append(r)
    return dumps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("nodes", nargs="+", metavar="HOST:PORT",
                    help="rpc addresses of the nodes to poll")
    ap.add_argument("--limit", type=int, default=None,
                    help="newest N completed traces per node")
    ap.add_argument("--chrome", metavar="PATH",
                    help="write Chrome trace-event JSON (open in Perfetto)")
    ap.add_argument("--stitched", metavar="PATH",
                    help="write the full stitched JSON")
    ap.add_argument("--json", action="store_true",
                    help="print stitched JSON instead of the summary")
    ap.add_argument("--overlap", action="store_true",
                    help="append the echo→ready phase-overlap report "
                    "(negative gap = Ready piggybacked on the Echo)")
    ap.add_argument("--timeout", type=float, default=5.0)
    args = ap.parse_args(argv)
    addrs = [_parse_addr(a) for a in args.nodes]
    dumps = asyncio.run(collect(addrs, args.limit, args.timeout))
    if not dumps:
        print("no node answered /tracez", file=sys.stderr)
        return 1
    stitched = stitch(dumps)
    if args.stitched:
        with open(args.stitched, "w") as fp:
            json.dump(stitched, fp, sort_keys=True, indent=1)
        print(f"wrote {args.stitched}", file=sys.stderr)
    if args.chrome:
        with open(args.chrome, "w") as fp:
            json.dump(chrome_trace(stitched), fp)
        print(
            f"wrote {args.chrome} — open at ui.perfetto.dev",
            file=sys.stderr,
        )
    if args.json:
        if args.overlap:
            stitched = dict(stitched, phase_overlap=phase_overlap(stitched))
        print(json.dumps(stitched, sort_keys=True, indent=1))
    else:
        print(render_summary(stitched))
        if args.overlap:
            print()
            print(render_overlap(phase_overlap(stitched)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

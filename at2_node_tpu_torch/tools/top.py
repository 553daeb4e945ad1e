"""Live operator dashboard: poll N nodes' /statusz and render a table.

Counterpart of ``at2_node_tpu/tools/top.py``.

The operator view for every load run: tx/s (committed delta
between refreshes), ingress→commit latency percentiles, verifier
occupancy and queue-wait, broadcast slot backlog, [overload] pressure
and shed rate, and per-node health —
straight from the observability endpoints the mux serves, no RPC stubs
and no dependencies beyond the stdlib. When a node runs process-mode
plane shards, the ``hot shard`` column names its busiest worker shard
phase since the last frame (largest ``phase_*_shardN_ns`` delta, as a
share of that shard's plane time) and the shards cell grows an ``obs!``
marker while the cross-process obs lane is dropping delta records.

Usage:
    python -m at2_node_tpu_torch.tools.top HOST:PORT [HOST:PORT ...]
        [--interval 2.0] [--once] [--recovery-deadline 120]
        [--no-clear] [--json] [--tracez] [--limit N]

``--once`` renders a single frame and exits — nonzero when any polled
node is down or reports degraded health, so scripts and CI can gate on
fleet health. A node reporting ``recovering`` (store-backed restart
walking loading_segments -> replaying_wal -> catchup, see
store/recovery.py) is healthy-but-behind: it passes the gate while its
recovery ``elapsed_s`` is within ``--recovery-deadline`` seconds and
fails it after — a restart that never reaches live IS a fleet problem.
``--json`` dumps the raw per-node /statusz snapshots instead of the
table. In watch mode a node that fails to answer renders as DOWN and
keeps the loop alive — mid-restart nodes are exactly when you want the
dashboard up.

Broker addresses can be polled alongside nodes: a /statusz that reports
``role: broker`` renders a broker-shaped row (forwarded transfers/s,
flush-build latency, pending buffer against PENDING_CAP with a ``!``
backpressure marker, dedup/overflow/forward-error drops) and its
health verdict participates in ``--once`` gating like any node's.

``--tracez`` switches the whole tool into a tail: it polls each node's
/tracez and prints every NEWLY completed lifecycle trace (one line per
tx: terminal, total latency, per-stage offsets) — `tail -f` for the
protocol. Use tools/trace_collect.py when you want the cross-node
stitched view instead of the per-node stream.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import re
import sys
import time

# The raw-HTTP polling primitives live in tools/_common.py (shared with
# trace_collect, profile_collect, and the incident collector); re-
# exported here because external scripts import them from tools.top.
from ._common import _GET_TIMEOUT, fetch_json, fetch_statusz
from ._common import parse_addr as _parse_addr


def _num(snapshot: dict, key: str, default=0):
    v = snapshot.get(key, default)
    return v if isinstance(v, (int, float)) else default


def _shed_basis(sz: dict) -> int:
    """Cumulative shed count backing the ``shed/s`` rate column:
    [overload] admission sheds (unary entries + distilled entries) for
    nodes, pre-buffer brownout/backpressure refusals for brokers. All
    zero while the [overload] table is off."""
    stats = sz.get("stats", {})
    if sz.get("role") == "broker":
        return _num(stats, "broker_refusals")
    return _num(stats, "overload_shed_entries") + _num(
        stats, "overload_shed_distilled"
    )


# process-mode obs fold keys (broadcast/shards.py): per-shard phase
# counters shipped from the plane worker processes
_SHARD_PHASE = re.compile(r"^phase_([a-z_]+)_shard(\d+)_ns$")


def _shard_phase_basis(sz: dict) -> dict:
    """Cumulative per-shard phase counters from /statusz stats — the
    rate basis for the ``hot shard`` column. Empty outside process mode
    (the fold keys don't exist there)."""
    out = {}
    for k, v in sz.get("stats", {}).items():
        if isinstance(k, str) and isinstance(v, (int, float)):
            if _SHARD_PHASE.match(k):
                out[k] = int(v)
    return out


def _hot_shard_cell(addr: str, sz: dict, prev) -> str:
    """The ``hot shard`` column: the worker shard phase with the largest
    ns delta since the previous frame, as ``N:phase share%`` where the
    share is of that shard's plane_total delta. "-" outside process
    mode; blank on the first frame; "idle" when no worker phase moved."""
    cur = _shard_phase_basis(sz)
    if not cur:
        return "-"
    seen = prev.get(addr)
    if seen is None or len(seen) < 5:
        return ""
    base = seen[4] or {}
    per: dict = {}
    for k, v in cur.items():
        m = _SHARD_PHASE.match(k)
        per.setdefault(int(m.group(2)), {})[m.group(1)] = max(
            0, v - base.get(k, 0)
        )
    cell, best = "idle", 0
    for sid in sorted(per):
        phases = per[sid]
        total = phases.get("plane_total", 0) or sum(
            d for p, d in phases.items() if p != "plane_total"
        )
        for p, d in phases.items():
            if p == "plane_total" or d <= best:
                continue
            best = d
            share = d / total if total else 0.0
            cell = f"{sid}:{p[:8]} {100.0 * share:.0f}%"
    return cell


def _pressure_cell(sz: dict) -> str:
    """The ``press`` column: smoothed pressure score from the /statusz
    ``pressure`` block (buffer-fill ratio for brokers). "-" for nodes
    predating the block or with [overload] absent."""
    block = sz.get("pressure")
    if not isinstance(block, dict):
        return "-"
    p = block.get("pressure")
    if not isinstance(p, (int, float)):
        return "-"
    cell = f"{p:.2f}"
    level = block.get("level")
    if isinstance(level, str) and level not in ("normal", "off"):
        cell += "!"
    return cell


def _shed_rate(addr: str, sz: dict, now: float, prev) -> str:
    """shed/s delta against the previous frame; blank on the first
    frame (or against a pre-column 2-tuple basis)."""
    seen = prev.get(addr)
    if seen is None or len(seen) < 3 or now <= seen[0]:
        return ""
    return f"{(_shed_basis(sz) - seen[2]) / (now - seen[0]):.1f}"


def _finality_cell(sz: dict) -> str:
    """The ``final`` column: latest certified commit watermark plus its
    lag behind the node's own commit frontier, as ``certified~lag``; a
    trailing ``!`` flags a lag beyond twice the beacon stride
    (``audit_every``) — certificates should trail by at most one
    frontier, so 2x means the lane is stalled (no quorum of
    co-signatures arriving, e.g. a partitioned or equivocating fleet).
    ``-`` when the node runs without a [finality] table."""
    fin = sz.get("finality", {})
    if not fin.get("enabled"):
        return "-"
    certified = _num(fin, "certified")
    lag = _num(fin, "lag")
    cell = f"{certified}~{lag}"
    stride = _num(fin, "audit_every", 0)
    if stride and lag > 2 * stride:
        cell += "!"
    return cell


def _recovery_cell(recovery: dict) -> str:
    """Compact progress for the ``recovery`` column: the live stage plus
    the one counter that says how far along it is."""
    state = recovery.get("state", "live")
    if state in ("live", "cold"):
        return "-"
    if state == "loading_segments":
        return (
            f"seg {recovery.get('segments_loaded', 0)}"
            f"/{recovery.get('segments_total', 0)}"
        )
    if state == "replaying_wal":
        return f"wal {recovery.get('wal_records_replayed', 0)}"
    return f"catchup lag {recovery.get('catchup_lag', 0)}"


def render_frame(rows, now: float, prev) -> str:
    """One table frame. ``rows`` is [(addr, statusz-or-exception)];
    ``prev`` maps addr -> (t, committed) from the previous frame for the
    tx/s delta. Pure function of its inputs — unit-testable."""
    cols = (
        f"{'node':<22}{'health':<11}{'tx/s':>8}{'committed':>11}"
        f"{'p50 ms':>9}{'p99 ms':>9}{'dlv p99':>9}{'live tr':>9}"
        f"{'rej':>6}{'vrf occ':>9}{'vmode':>10}{'q-wait p99':>12}"
        f"{'lag p99':>9}"
        f"{'backlog':>9}{'press':>7}{'shed/s':>8}"
        f"{'dstl rx/ms/dd':>15}{'peers':>7}"
        f"{'shards':>8}{'hot shard':>17}{'final':>11}{'epoch':>7}  "
        f"{'recovery':<16}"
    )
    lines = []
    # fleet build line: every distinct (git SHA, config hash) the nodes
    # report — one entry when the fleet is homogeneous, more when a
    # rollout is in flight and you want to see the split at a glance
    builds = []
    for _addr, sz in rows:
        if isinstance(sz, Exception):
            continue
        b = sz.get("build", {})
        if not b:  # brokers / older nodes don't report one
            continue
        cell = (
            f"git={b.get('git_sha', '?')} cfg={b.get('config_hash', '?')} "
            f"py={b.get('python', '?')} torch={b.get('torch', '?')}"
        )
        if cell not in builds:
            builds.append(cell)
    if builds:
        lines.append("build: " + " | ".join(builds))
    lines += [cols, "-" * len(cols)]
    for addr, sz in rows:
        if isinstance(sz, Exception):
            lines.append(f"{addr:<22}{'DOWN':<9}{type(sz).__name__}: {sz}")
            continue
        if sz.get("role") == "broker":
            # broker-shaped row: no quorum, no ledger — what matters is
            # the pending buffer against its cap, flush-build latency,
            # and the forward/drop counters
            health = sz.get("health", {})
            stats = sz.get("stats", {})
            flush = sz.get("flush", {})
            fwd = _num(stats, "broker_entries_tx")
            rate = ""
            seen = prev.get(addr)
            if seen is not None and now > seen[0]:
                rate = f"{(fwd - seen[1]) / (now - seen[0]):.1f}"
            pend = (
                f"{_num(health, 'pending')}/{_num(health, 'pending_cap')}"
                + ("!" if health.get("backpressure") else "")
            )
            drops = (
                f"{_num(stats, 'broker_dedup_drops')}/"
                f"{_num(stats, 'broker_overflow_drops')}/"
                f"{_num(stats, 'broker_forward_errors')}"
            )
            lines.append(
                f"{addr:<22}"
                f"{health.get('status', '?'):<11}"
                f"{rate:>8}"
                f"{fwd:>11}"
                f"{_num(flush, 'p50_ms'):>9.1f}"
                f"{_num(flush, 'p99_ms'):>9.1f}"
                f"{'broker':>9}"
                f"{_num(stats, 'broker_batches_tx'):>9}"
                f"{'':>6}"
                f"{'-':>9}"
                f"{'-':>10}"
                f"{'-':>12}"
                f"{'-':>9}"
                f"{pend:>9}"
                f"{_pressure_cell(sz):>7}"
                f"{_shed_rate(addr, sz, now, prev):>8}"
                f"{drops:>15}"
                f"{_num(stats, 'broker_registrations'):>7}"
                f"{'-':>8}"
                f"{'-':>17}"
                f"{'-':>11}"
                f"{'-':>7}  {'-':<16}"
            )
            continue
        stats = sz.get("stats", {})
        health = sz.get("health", {})
        lifecycle = sz.get("tx_lifecycle", {})
        life = lifecycle.get("ingress_to_committed", {})
        dlv = lifecycle.get("ingress_to_delivered", {})
        rej = lifecycle.get("ingress_to_rejected", {})
        vstages = sz.get("verifier_stages", {})
        committed = _num(health, "committed")
        rate = ""
        seen = prev.get(addr)
        if seen is not None and now > seen[0]:
            rate = f"{(committed - seen[1]) / (now - seen[0]):.1f}"
        occ = stats.get("verifier_batch_occupancy")
        occ_s = f"{occ:.2f}" if isinstance(occ, float) else "-"
        # verifier mode + the LIVE routing decision:
        # "auto/rlc" means auto mode whose last flush went amortized;
        # a trailing ! counts bisection/kernel fallbacks so salting
        # shows up at a glance
        routing = sz.get("verifier_routing", {})
        if routing:
            vmode_s = (
                f"{routing.get('mode', '?')[:4]}/"
                f"{routing.get('route_last', '?')[:3]}"
            )
            fb = _num(stats, "verifier_rlc_fallbacks")
            if fb:
                vmode_s += f"!{fb}"
        else:
            vmode_s = "-"
        qw = vstages.get("queue_wait", {}).get("p99_ms")
        qw_s = f"{qw:.2f}" if isinstance(qw, (int, float)) else "-"
        # event-loop lag p99 from the continuous lag probe:
        # a loaded loop shows up here before tx latency degrades
        lag = stats.get("event_loop_lag_p99_ms")
        lag_s = f"{lag:.2f}" if isinstance(lag, (int, float)) else "-"
        # broker-ingress tier: distilled batches received / directory
        # misses / cross-frame dedup drops, one compact cell
        dstl_s = (
            f"{_num(stats, 'distilled_batches_rx')}/"
            f"{_num(stats, 'directory_misses')}/"
            f"{_num(stats, 'dedup_drops')}"
        )
        # broadcast-plane sharding (statusz "plane" block): shard count
        # plus executor initial — "1/l" is the monolithic loop plane,
        # "4/t" four shard threads, "4/p" four worker processes
        # (broadcast/shards.py). A trailing ! counts dropped effect
        # records (full handoff ring/queue — the plane is shedding), a
        # trailing X flags crashed shard workers (process mode), a
        # trailing obs! means the obs shipping lane is dropping delta
        # records (phase/recorder/trace data is lossy right now — the
        # protocol itself is unaffected).
        plane = sz.get("plane", {})
        if plane:
            shards_s = (
                f"{_num(plane, 'shards')}/{str(plane.get('executor', '?'))[:1]}"
            )
            eff_drop = _num(plane, "effects_dropped")
            if eff_drop:
                shards_s += f"!{eff_drop}"
            if plane.get("worker_crashed"):
                shards_s += f"X{len(plane['worker_crashed'])}"
            od = _num(stats, "obs_records_dropped")
            prev_od = seen[3] if seen is not None and len(seen) >= 4 else 0
            if od > prev_od:
                shards_s += "obs!"
        else:
            shards_s = "-"
        lines.append(
            f"{addr:<22}"
            f"{health.get('status', '?'):<11}"
            f"{rate:>8}"
            f"{committed:>11}"
            f"{_num(life, 'p50_ms'):>9.1f}"
            f"{_num(life, 'p99_ms'):>9.1f}"
            f"{_num(dlv, 'p99_ms'):>9.1f}"
            f"{_num(lifecycle, 'live_traces'):>9}"
            f"{_num(rej, 'count'):>6}"
            f"{occ_s:>9}"
            f"{vmode_s:>10}"
            f"{qw_s:>12}"
            f"{lag_s:>9}"
            f"{_num(stats, 'slots_undelivered'):>9}"
            f"{_pressure_cell(sz):>7}"
            f"{_shed_rate(addr, sz, now, prev):>8}"
            f"{dstl_s:>15}"
            f"{_num(health, 'peers_connected'):>4}/"
            f"{_num(health, 'peers_configured'):<2}"
            f"{shards_s:>8}"
            f"{_hot_shard_cell(addr, sz, prev):>17}"
            f"{_finality_cell(sz):>11}"
            f"{_num(health, 'epoch'):>7}  "
            f"{_recovery_cell(sz.get('recovery', {})):<16}"
        )
    return "\n".join(lines)


def render_trace_lines(addr: str, dump: dict, seen: set) -> list:
    """Format NEWLY completed traces from one node's /tracez dump as
    tail lines; ``seen`` tracks (sender, seq) already printed for that
    node. Pure function of its inputs — unit-testable."""
    lines = []
    for rec in dump.get("completed", ()):
        key = (rec["sender"], rec["seq"])
        if key in seen:
            continue
        seen.add(key)
        stages = rec.get("stages", ())
        t0 = stages[0][2] if stages else 0.0
        total_ms = 1e3 * (stages[-1][2] - t0) if len(stages) > 1 else 0.0
        hops = " ".join(
            f"{s}+{1e3 * (w - t0):.2f}" for s, _m, w in stages[1:]
        )
        lines.append(
            f"{addr:<22}{rec['sender'][:12]}#{rec['seq']:<6}"
            f"{rec.get('terminal') or '?':<10}{total_ms:>9.2f}ms  {hops}"
        )
    return lines


async def run_tracez(addrs, interval: float, once: bool, limit,
                     out=None) -> int:
    """Tail mode: stream completed lifecycle traces as they retire."""
    out = out or sys.stdout
    seen: dict = {}
    path = "/tracez" + (f"?limit={limit}" if limit is not None else "")
    while True:
        results = await asyncio.gather(
            *(fetch_json(h, p, path, min(_GET_TIMEOUT, max(interval, 0.5)))
              for h, p in addrs),
            return_exceptions=True,
        )
        for (h, p), r in zip(addrs, results):
            addr = f"{h}:{p}"
            if isinstance(r, Exception):
                print(f"{addr:<22}DOWN {type(r).__name__}: {r}",
                      file=out, flush=True)
                continue
            for line in render_trace_lines(
                addr, r, seen.setdefault(addr, set())
            ):
                print(line, file=out, flush=True)
        if once:
            return 0
        await asyncio.sleep(interval)


async def _poll(addrs, timeout: float):
    results = await asyncio.gather(
        *(fetch_statusz(h, p, timeout) for h, p in addrs),
        return_exceptions=True,
    )
    return [(f"{h}:{p}", r) for (h, p), r in zip(addrs, results)]


def once_verdict(rows, recovery_deadline: float,
                 lag_deadline: float = None,
                 cert_lag_deadline: float = None) -> list:
    """The ``--once`` gate: addresses (with reasons) that fail it.
    Down and degraded always fail; ``recovering`` fails only past
    ``recovery_deadline`` seconds of recovery elapsed time; with
    ``lag_deadline`` set, an otherwise-healthy node whose event-loop
    lag p99 exceeds it (ms) fails too; with ``cert_lag_deadline`` set,
    a finality-enabled node whose certified watermark trails its commit
    frontier by more than that many commits fails (nodes without a
    [finality] table are exempt — the gate judges the lane only where
    it exists). Pure function of its inputs — unit-testable."""
    bad = []
    for addr, sz in rows:
        if isinstance(sz, Exception):
            bad.append(f"{addr} (down)")
            continue
        status = sz.get("health", {}).get("status")
        # "overloaded" is load shedding doing its job, not a fault: the
        # node answers, commits, and will grade back to ok when pressure
        # drains — failing the gate on it would page on every flash crowd
        if status in ("ok", "overloaded"):
            if lag_deadline is not None:
                lag = sz.get("stats", {}).get("event_loop_lag_p99_ms")
                if isinstance(lag, (int, float)) and lag > lag_deadline:
                    bad.append(f"{addr} (event-loop lag p99 {lag:.2f}ms > "
                               f"{lag_deadline:g}ms deadline)")
            if cert_lag_deadline is not None:
                fin = sz.get("finality", {})
                clag = fin.get("lag")
                if fin.get("enabled") and isinstance(
                    clag, (int, float)
                ) and clag > cert_lag_deadline:
                    bad.append(
                        f"{addr} (certificate lag {clag:g} commits > "
                        f"{cert_lag_deadline:g} deadline)"
                    )
            continue
        if status == "recovering":
            elapsed = sz.get("recovery", {}).get("elapsed_s", 0.0)
            if (
                isinstance(elapsed, (int, float))
                and elapsed <= recovery_deadline
            ):
                continue
            bad.append(f"{addr} (recovering {elapsed}s > "
                       f"{recovery_deadline}s deadline)")
            continue
        bad.append(f"{addr} ({status})")
    return bad


async def run_profilez(addrs, duration: float, limit: int = 10,
                       out=None) -> int:
    """One-shot sampling capture: start each node's sampler via
    /profilez?start, wait out the window, print the top ``limit``
    folded stacks per node. Nonzero when any node is unreachable or
    has the profiler kill-switched off."""
    out = out or sys.stdout
    rc = 0
    started = await asyncio.gather(
        *(fetch_json(h, p, f"/profilez?start&duration={duration:g}")
          for h, p in addrs),
        return_exceptions=True,
    )
    await asyncio.sleep(duration + 0.5)
    dumps = await asyncio.gather(
        *(fetch_json(h, p, "/profilez") for h, p in addrs),
        return_exceptions=True,
    )
    for (h, p), st, dump in zip(addrs, started, dumps):
        addr = f"{h}:{p}"
        if isinstance(st, Exception) or isinstance(dump, Exception):
            err = st if isinstance(st, Exception) else dump
            print(f"{addr}  DOWN {type(err).__name__}: {err}",
                  file=out, flush=True)
            rc = 1
            continue
        b = dump.get("build", {})
        samples = dump.get("sampler", {}).get("samples", 0)
        print(
            f"{addr}  node={dump.get('node')} git={b.get('git_sha')} "
            f"cfg={b.get('config_hash')}  {samples} samples "
            f"over {duration:g}s",
            file=out,
        )
        for line in (dump.get("folded") or [])[:limit]:
            print(f"  {line}", file=out)
        print("", file=out, flush=True)
    return rc


async def run(addrs, interval: float, once: bool, clear: bool,
              as_json: bool, out=None,
              recovery_deadline: float = 120.0,
              lag_deadline: float = None,
              cert_lag_deadline: float = None) -> int:
    out = out or sys.stdout
    prev: dict = {}
    while True:
        now = time.monotonic()
        rows = await _poll(addrs, min(_GET_TIMEOUT, max(interval, 0.5)))
        if as_json:
            print(
                json.dumps(
                    {a: (str(r) if isinstance(r, Exception) else r)
                     for a, r in rows},
                    sort_keys=True,
                ),
                file=out,
            )
        else:
            frame = render_frame(rows, now, prev)
            if clear:
                print("\x1b[2J\x1b[H", end="", file=out)
            print(frame, file=out, flush=True)
        for addr, sz in rows:
            if not isinstance(sz, Exception):
                # the rate basis: commits for nodes, forwarded transfers
                # for broker rows
                basis = (
                    _num(sz.get("stats", {}), "broker_entries_tx")
                    if sz.get("role") == "broker"
                    else _num(sz.get("health", {}), "committed")
                )
                prev[addr] = (
                    now, basis, _shed_basis(sz),
                    _num(sz.get("stats", {}), "obs_records_dropped"),
                    _shard_phase_basis(sz),
                )
        if once:
            # scripting/CI contract: nonzero when ANY polled node is
            # unreachable or self-reports degraded health — a fleet
            # where one node answers is not a healthy fleet. Recovering
            # nodes pass within the deadline (see once_verdict).
            bad = once_verdict(rows, recovery_deadline, lag_deadline,
                               cert_lag_deadline)
            if bad:
                print(f"unhealthy: {', '.join(bad)}", file=sys.stderr)
            return 1 if bad else 0
        await asyncio.sleep(interval)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("nodes", nargs="+", metavar="HOST:PORT",
                    help="rpc addresses of the nodes to watch")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (nonzero if any node "
                         "is down, degraded, or still recovering past "
                         "the recovery deadline)")
    ap.add_argument("--recovery-deadline", type=float, default=120.0,
                    metavar="SECONDS",
                    help="with --once: how long a node may report "
                         "'recovering' before it fails the gate "
                         "(default 120)")
    ap.add_argument("--no-clear", action="store_true",
                    help="append frames instead of clearing the screen")
    ap.add_argument("--json", action="store_true",
                    help="dump raw /statusz snapshots instead of the table")
    ap.add_argument("--tracez", action="store_true",
                    help="tail completed lifecycle traces from /tracez "
                         "instead of rendering the dashboard")
    ap.add_argument("--limit", type=int, default=None,
                    help="with --tracez: newest N completed traces per poll")
    ap.add_argument("--profilez", action="store_true",
                    help="one-shot sampling capture: start each node's "
                         "profiler, wait --duration, print its top-10 "
                         "folded stacks")
    ap.add_argument("--duration", type=float, default=5.0,
                    help="with --profilez: capture window in seconds "
                         "(default 5)")
    ap.add_argument("--lag-deadline", type=float, default=None,
                    metavar="MS",
                    help="with --once: fail the gate when any node's "
                         "event-loop lag p99 exceeds this many ms")
    ap.add_argument("--cert-lag-deadline", type=float, default=None,
                    metavar="COMMITS",
                    help="with --once: fail the gate when a "
                         "finality-enabled node's certified watermark "
                         "trails its commit frontier by more than this "
                         "many commits")
    args = ap.parse_args(argv)
    addrs = [_parse_addr(a) for a in args.nodes]
    try:
        if args.profilez:
            return asyncio.run(
                run_profilez(addrs, args.duration,
                             args.limit if args.limit is not None else 10)
            )
        if args.tracez:
            return asyncio.run(
                run_tracez(addrs, args.interval, args.once, args.limit)
            )
        return asyncio.run(
            run(addrs, args.interval, args.once,
                clear=not args.no_clear, as_json=args.json,
                recovery_deadline=args.recovery_deadline,
                lag_deadline=args.lag_deadline,
                cert_lag_deadline=args.cert_lag_deadline)
        )
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())

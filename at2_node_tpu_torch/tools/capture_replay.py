"""Wire-capture → sim replay bridge: re-run a node's inbound traffic.

Counterpart of ``at2_node_tpu/tools/capture_replay.py``.

The capture ring (net/peers.py, ``[observability] capture_cap``) records
every inbound frame a node delivered — ``(mono_ns, peer, kind, frame)``
— and serves it on /capturez. This tool turns that capture into a sim
inject schedule (sim/campaign.py ``inject`` events) and replays it
under VIRTUAL time against a fresh simulated fleet: the relative
inter-frame timing is preserved, the wall-clock is not needed, and the
whole replay — delivery order, invariant sweep, fleet-audit verdict —
is a pure function of (capture, seed, knobs). Replaying the same
capture twice yields a byte-identical verdict, which is exactly what
the CI gate asserts.

What a replay is and is not: the simulated nodes have FRESH keys, so
signed traffic from the real fleet arrives as what it really is to an
outside observer — frames from an unknown origin. That exercises every
inbound defense (parse, signature, origin checks, quota, the fleet
auditor's beacon validation) against real-world bytes, making this a
deterministic fuzz-corpus bridge: any capture that crashes or diverges
a node becomes a seedable, minimizable sim reproducer.

``--minimize`` shrinks a failing replay to the shortest inject schedule
that still fails (sim/campaign.py minimize_events), turning a
thousand-frame capture into a handful-of-frames bug report.

Usage:
    python -m at2_node_tpu_torch.tools.capture_replay CAPTURE.json
        [--seed 1] [--nodes 4] [--target 0] [--speed 1.0]
        [--repeat 2] [--minimize] [--json]
    python -m at2_node_tpu_torch.tools.capture_replay --fetch HOST:PORT ...

CAPTURE.json is a /capturez dump (``{"cap", "captured", "records"}``,
with or without the route's ``node`` wrapper key) — e.g. the
``<node>/capturez.json`` file inside an incident bundle (the JAX
package's tools/incident.py), or a port node's /capturez fetched with
``--fetch``.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import sys
from typing import List, Optional

from ._common import fetch_json, parse_addr


def capture_to_events(
    doc: dict,
    *,
    target: int = 0,
    speed: float = 1.0,
    start: float = 0.5,
) -> List[list]:
    """Convert a /capturez dump into a sim inject schedule.

    Frames keep their relative spacing (``mono_ns`` deltas over
    ``speed``), re-anchored to virtual ``start``; all are injected into
    node ``target`` from the sim's hostile identity — the sim fleet has
    fresh keys, so to it the captured origin IS an unknown outsider.
    Pure in its inputs; ties on mono_ns keep capture order (stable
    sort), so the schedule — and the replay — is deterministic."""
    records = doc.get("records", [])
    if not records:
        return []
    ordered = sorted(records, key=lambda r: int(r[0]))
    t0 = int(ordered[0][0])
    events = []
    for mono_ns, _peer, _kind, frame_hex in ordered:
        t = start + (int(mono_ns) - t0) / 1e9 / max(speed, 1e-9)
        events.append(
            [t, "inject",
             {"src_hostile": 1, "target": target, "frame": frame_hex}]
        )
    return events


def replay_capture(
    doc: dict,
    seed: int = 1,
    *,
    nodes: int = 4,
    target: int = 0,
    speed: float = 1.0,
    events: Optional[List[list]] = None,
    settle_horizon: float = 60.0,
) -> dict:
    """Replay a capture in the sim and return the verdict.

    The verdict is every deterministic observable that matters:
    invariant violations, the episode trace hash, per-node committed
    counts, and the quiescent fleet-audit state (divergence + counters).
    Pure in (doc, seed, knobs) — hash it and compare across runs.
    ``events`` overrides the schedule derived from ``doc`` (used by
    minimization to replay candidate subsets)."""
    from ..sim.campaign import run_episode

    if events is None:
        events = capture_to_events(doc, target=target, speed=speed)
    result = run_episode(
        seed,
        nodes=nodes,
        f=1 if nodes >= 4 else 0,
        hostile=1,  # the hostile identity is the injected frames' source
        events=events,
        settle_horizon=settle_horizon,
        capture_obs=False,
    )
    return {
        "seed": seed,
        "nodes": nodes,
        "target": target,
        "injected": len(events),
        "violations": result.violations,
        "trace_hash": result.trace_hash,
        "committed": result.committed,
        "delivered": result.delivered,
        "audit": [
            {
                "divergence": a.get("divergence"),
                "counters": a.get("counters"),
            }
            for a in (result.audit or [])
        ],
    }


def verdict_hash(verdict: dict) -> str:
    """sha256 over the canonical-JSON verdict — the replay's identity."""
    return hashlib.sha256(
        json.dumps(
            verdict, sort_keys=True, separators=(",", ":"), default=str
        ).encode()
    ).hexdigest()


def minimize_capture(
    doc: dict,
    seed: int,
    *,
    nodes: int = 4,
    target: int = 0,
    speed: float = 1.0,
) -> Optional[List[list]]:
    """Shrink a failing capture to the shortest inject schedule that
    still fails invariants. Returns None when the replay passes (nothing
    to minimize)."""
    from ..sim.campaign import minimize_events

    events = capture_to_events(doc, target=target, speed=speed)

    def failing(candidate: List[list]) -> bool:
        v = replay_capture(
            doc, seed, nodes=nodes, target=target, events=candidate
        )
        return bool(v["violations"])

    if not failing(events):
        return None
    return minimize_events(events, failing)


def load_capture(path: str) -> dict:
    """Read a capture JSON file; tolerates the obs route's ``node``
    wrapper and an incident bundle's capturez.json equally."""
    with open(path) as fp:
        doc = json.load(fp)
    if "records" not in doc:
        raise ValueError(f"{path}: not a /capturez dump (no 'records')")
    return doc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("capture", nargs="?", default=None,
                    metavar="CAPTURE.json",
                    help="a /capturez dump (e.g. from an incident bundle)")
    ap.add_argument("--fetch", default=None, metavar="HOST:PORT",
                    help="fetch the capture live from a node's /capturez "
                         "instead of a file")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--target", type=int, default=0,
                    help="sim node index the frames are injected into")
    ap.add_argument("--speed", type=float, default=1.0,
                    help="replay time compression (2.0 = twice as fast)")
    ap.add_argument("--repeat", type=int, default=2,
                    help="replay N times and compare verdict hashes "
                         "(default 2: the determinism check)")
    ap.add_argument("--minimize", action="store_true",
                    help="if the replay fails invariants, shrink the "
                         "schedule to the shortest failing subset")
    ap.add_argument("--json", action="store_true",
                    help="dump the verdict JSON to stdout")
    args = ap.parse_args(argv)
    if args.fetch:
        host, port = parse_addr(args.fetch)
        doc = asyncio.run(fetch_json(host, port, "/capturez"))
    elif args.capture:
        doc = load_capture(args.capture)
    else:
        print("pass CAPTURE.json or --fetch HOST:PORT", file=sys.stderr)
        return 2
    if not doc.get("records"):
        print("capture is empty (capture_cap=0 on the node?)",
              file=sys.stderr)
        return 2

    verdicts = [
        replay_capture(
            doc, args.seed, nodes=args.nodes, target=args.target,
            speed=args.speed,
        )
        for _ in range(max(args.repeat, 1))
    ]
    hashes = [verdict_hash(v) for v in verdicts]
    v = verdicts[0]
    deterministic = len(set(hashes)) == 1
    print(
        f"replayed {v['injected']} frames into node {args.target} "
        f"(seed {args.seed}, {args.nodes} nodes) x{len(verdicts)}",
        file=sys.stderr,
    )
    print(
        f"verdict {hashes[0][:16]}  violations={len(v['violations'])}  "
        f"committed={v['committed']}  "
        f"deterministic={'yes' if deterministic else 'NO'}",
        file=sys.stderr,
    )
    rc = 0
    if not deterministic:
        print(f"NON-DETERMINISTIC REPLAY: hashes {hashes}", file=sys.stderr)
        rc = 1
    if v["violations"]:
        for viol in v["violations"]:
            print(f"  violation: {viol}", file=sys.stderr)
        if args.minimize:
            minimized = minimize_capture(
                doc, args.seed, nodes=args.nodes, target=args.target,
                speed=args.speed,
            )
            if minimized is not None:
                v["minimized"] = minimized
                print(
                    f"minimized to {len(minimized)} frame(s)",
                    file=sys.stderr,
                )
    if args.json:
        v["verdict_sha256"] = hashes[0]
        v["deterministic"] = deterministic
        print(json.dumps(v, sort_keys=True, indent=1, default=str))
    return rc


if __name__ == "__main__":
    sys.exit(main())

"""Incident bundles: one-command (or edge-triggered) fleet snapshots.

Counterpart of ``at2_node_tpu/tools/incident.py``: the same dumps give the
reference's byte-identical bundle and bundle hash. Bundles go under
``--out``, by default the package's git-ignored ``build/bench/incidents``.
It polls nodes over HTTP and touches no device itself.

When something goes wrong in a live fleet the evidence is spread across
every node's observability surfaces and decays fast (bounded rings,
rolling windows). This tool freezes all of it into ONE bundle
directory: per-node /statusz + /healthz + /tracez + /debugz, the wire
capture ring (/capturez, when [observability] capture_cap > 0), and
optionally a bounded /profilez window — plus a manifest with a sha256
per file and a bundle hash over the sorted (path, sha256) pairs.

Bundle construction is a PURE function of the collected dumps — no
wall-clock reads, canonical JSON (sorted keys, fixed separators) — so
the same dumps produce a byte-identical bundle: two collectors racing
the same incident converge on the same bundle hash, and a test can
assert determinism (tests/test_torch_obs_tools.py). The collection itself
is of course a snapshot of a moving fleet; determinism is a property of
the stitch, not the scrape.

``--watch`` polls the fleet and triggers a bundle on the edges that
matter (same edge set node-side health uses, node/service.py):

* any node's health status leaving ok/recovering (degraded or
  diverged),
* an SLO breach appearing (``health.slo_breach`` non-empty),
* a fleet-audit divergence latching (``health.divergence`` non-None),
* a flight-recorder anomaly snapshot landing (``recorder_snapshots``
  counter bump — stall kicks, equivocation, catchup anomalies).

Edge-triggered means ONE bundle per incident transition, not one per
poll while the fleet stays degraded. ``--now`` forces a bundle
immediately and exits.

Usage:
    python -m at2_node_tpu_torch.tools.incident HOST:PORT [HOST:PORT ...]
        [--out DIR] [--now] [--watch] [--interval 2.0]
        [--profile-window 0] [--timeout 5.0]
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

from ._common import OUT_DIR, fetch_json, parse_addr, poll_fleet

DEFAULT_OUT = os.path.join(OUT_DIR, "incidents")

# every JSON surface a bundle snapshots per node; /capturez and
# /profilez are optional (404 when their kill-switch is off)
_SURFACES = ("/statusz", "/healthz", "/tracez", "/debugz")
_OPTIONAL = ("/capturez",)


async def collect(
    addrs: List[Tuple[str, int]],
    *,
    profile_window: float = 0.0,
    timeout: float = 5.0,
) -> dict:
    """Scrape every node's surfaces concurrently. Returns
    ``{"nodes": {"host:port": {surface_name: doc_or_error}}}``; a dead
    node contributes error entries, never aborts the bundle — an
    incident collector that needs the whole fleet healthy is useless."""
    dumps: Dict[str, dict] = {}
    for path in _SURFACES + _OPTIONAL:
        results = await poll_fleet(addrs, path, timeout)
        for (h, p), doc in zip(addrs, results):
            node = dumps.setdefault(f"{h}:{p}", {})
            name = path.lstrip("/")
            if path in _OPTIONAL and "error" in doc and " 404 " in str(
                doc.get("error", "")
            ):
                continue  # kill-switched surface: absent, not an error
            node[name] = doc
    if profile_window > 0:
        # bounded profiler window from every node that serves /profilez:
        # start, wait the window out, fetch the tree. Nodes with the
        # profiler kill-switched (404) just skip the key.
        async def window(h: str, p: int) -> Optional[dict]:
            try:
                await fetch_json(
                    h, p, f"/profilez?start&duration={profile_window}",
                    timeout,
                )
                await asyncio.sleep(profile_window + 0.5)
                return await fetch_json(h, p, "/profilez", timeout)
            except Exception:
                return None

        results = await asyncio.gather(*(window(h, p) for h, p in addrs))
        for (h, p), doc in zip(addrs, results):
            if doc is not None:
                dumps[f"{h}:{p}"]["profilez"] = doc
    return {"nodes": dumps}


def build_bundle(dumps: dict, reason: str = "manual") -> dict:
    """Stitch collected dumps into bundle files + manifest.

    Pure function of ``(dumps, reason)`` — no wall-clock reads, no
    environment, canonical JSON throughout — so the same inputs yield a
    byte-identical bundle (same per-file bytes, same bundle hash). The
    caller stamps any wall time into the bundle DIRECTORY name, never
    into the hashed content. Returns ``{"files": {relpath: bytes},
    "manifest": dict}``; the manifest itself is written as
    ``manifest.json`` by :func:`write_bundle` and carries every file's
    sha256 plus ``bundle_sha256`` over the sorted (path, sha256) pairs.
    """
    files: Dict[str, bytes] = {}
    for node in sorted(dumps.get("nodes", {})):
        surfaces = dumps["nodes"][node]
        safe = node.replace(":", "_").replace("/", "_")
        for name in sorted(surfaces):
            files[f"{safe}/{name}.json"] = (
                json.dumps(
                    surfaces[name], sort_keys=True,
                    separators=(",", ":"), default=str,
                ).encode() + b"\n"
            )
    digests = {
        path: hashlib.sha256(data).hexdigest()
        for path, data in files.items()
    }
    h = hashlib.sha256()
    for path in sorted(digests):
        h.update(path.encode() + b"\x00" + digests[path].encode() + b"\x00")
    manifest = {
        "reason": reason,
        "nodes": sorted(dumps.get("nodes", {})),
        "files": digests,
        "bundle_sha256": h.hexdigest(),
    }
    return {"files": files, "manifest": manifest}


def write_bundle(out_dir: str, bundle: dict) -> str:
    """Materialize a built bundle under ``out_dir``; returns the path of
    the manifest. Atomic enough for an operator tool: files first,
    manifest last, so a manifest's presence means the bundle is whole."""
    os.makedirs(out_dir, exist_ok=True)
    for rel, data in sorted(bundle["files"].items()):
        path = os.path.join(out_dir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as fp:
            fp.write(data)
    manifest_path = os.path.join(out_dir, "manifest.json")
    with open(manifest_path, "w") as fp:
        json.dump(bundle["manifest"], fp, sort_keys=True, indent=1)
        fp.write("\n")
    return manifest_path


def _edges(prev: Optional[dict], cur: dict) -> List[str]:
    """Incident transitions between two watch polls (per node). ``prev``
    None means first poll: baseline only, nothing triggers."""
    if prev is None:
        return []
    reasons = []
    for node, doc in cur.get("nodes", {}).items():
        sz = doc.get("statusz", {})
        if "error" in sz:
            continue  # a down node is top.py's beat; bundles need a fleet
        before = prev.get("nodes", {}).get(node, {}).get("statusz", {})
        if "error" in before:
            before = {}
        h0, h1 = before.get("health", {}), sz.get("health", {})
        s0 = h0.get("status", "ok")
        s1 = h1.get("status", "ok")
        if s1 in ("degraded", "diverged") and s0 not in (
            "degraded", "diverged"
        ):
            reasons.append(f"{node}:health:{s1}")
        if h1.get("slo_breach") and not h0.get("slo_breach"):
            reasons.append(
                f"{node}:slo:{','.join(h1['slo_breach'])}"
            )
        if h1.get("divergence") and not h0.get("divergence"):
            reasons.append(f"{node}:divergence")
        c0 = before.get("stats", {}).get("recorder_snapshots", 0)
        c1 = sz.get("stats", {}).get("recorder_snapshots", 0)
        if isinstance(c1, (int, float)) and c1 > (c0 or 0):
            reasons.append(f"{node}:anomaly_snapshot")
    return reasons


async def watch(
    addrs: List[Tuple[str, int]],
    out_root: str,
    *,
    interval: float = 2.0,
    profile_window: float = 0.0,
    timeout: float = 5.0,
    max_bundles: int = 0,
) -> int:
    """Poll statusz; on an incident edge, collect + write one bundle.
    ``max_bundles`` > 0 exits after that many (tests / bounded ops)."""
    prev: Optional[dict] = None
    written = 0
    while True:
        docs = await poll_fleet(addrs, "/statusz", timeout)
        cur = {
            "nodes": {
                f"{h}:{p}": {"statusz": doc}
                for (h, p), doc in zip(addrs, docs)
            }
        }
        reasons = _edges(prev, cur)
        prev = cur
        if reasons:
            dumps = await collect(
                addrs, profile_window=profile_window, timeout=timeout
            )
            bundle = build_bundle(dumps, reason=";".join(sorted(reasons)))
            out_dir = os.path.join(
                out_root,
                "incident-%s-%s"
                % (
                    time.strftime("%Y%m%d-%H%M%S", time.gmtime()),
                    bundle["manifest"]["bundle_sha256"][:8],
                ),
            )
            path = write_bundle(out_dir, bundle)
            print(
                f"incident bundle: {path} ({bundle['manifest']['reason']})",
                file=sys.stderr,
            )
            written += 1
            if max_bundles and written >= max_bundles:
                return 0
        await asyncio.sleep(interval)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("nodes", nargs="+", metavar="HOST:PORT",
                    help="rpc addresses of the nodes to bundle")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="bundle root directory (default %(default)s)")
    ap.add_argument("--now", action="store_true",
                    help="collect one bundle immediately and exit")
    ap.add_argument("--watch", action="store_true",
                    help="poll and bundle on incident edges")
    ap.add_argument("--interval", type=float, default=2.0)
    ap.add_argument("--profile-window", type=float, default=0.0,
                    help="seconds of /profilez capture per node to "
                         "include (0 = skip the profiler window)")
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--max-bundles", type=int, default=0,
                    help="with --watch: exit after N bundles (0 = run "
                         "forever)")
    args = ap.parse_args(argv)
    addrs = [parse_addr(a) for a in args.nodes]
    if args.watch:
        return asyncio.run(
            watch(
                addrs, args.out, interval=args.interval,
                profile_window=args.profile_window, timeout=args.timeout,
                max_bundles=args.max_bundles,
            )
        )
    if not args.now:
        print("pick --now or --watch", file=sys.stderr)
        return 2
    dumps = asyncio.run(
        collect(addrs, profile_window=args.profile_window,
                timeout=args.timeout)
    )
    bundle = build_bundle(dumps, reason="manual")
    out_dir = os.path.join(
        args.out,
        "incident-%s-%s"
        % (
            time.strftime("%Y%m%d-%H%M%S", time.gmtime()),
            bundle["manifest"]["bundle_sha256"][:8],
        ),
    )
    path = write_bundle(out_dir, bundle)
    print(f"wrote {path}", file=sys.stderr)
    print(json.dumps(bundle["manifest"], sort_keys=True, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

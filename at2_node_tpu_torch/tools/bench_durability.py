"""Durable-store benchmark: restart cost and the delta-bound flush.

Counterpart of ``at2_node_tpu/tools/bench_durability.py``: the same
measurements and document, plus the ``verifier`` the restarted node ran
and its ``card`` stamp. The node verifies on ``cuda:0`` unless
``--verifier cpu`` asks for the host; without a card and without that
flag the tool raises before it seeds anything. The document goes to
``--out``, by default ``BENCH_DURABILITY.json`` in the package's
git-ignored ``build/bench``.

The acceptance numbers, measured end to end:

* **restart at scale** — a store seeded with >= 100k accounts is opened
  the way a rebooting node opens it (load segments -> replay WAL), then
  a REAL Service is started on it and walked to a healthy verdict. No
  full-state transfer happens anywhere: the node's ledger comes off its
  own disk, catchup only reconciles the live frontier.
* **delta-bound flush** — after the initial full flush, an incremental
  flush's cost (segments written, bytes, wall time) must track the
  DELTA committed since the last flush, not the account count. Measured
  at two delta sizes so the scaling is visible in the artifact, with
  the full-flush cost alongside for the ratio.

Accounts are seeded through the legacy-migration path (a synthetic
monolithic checkpoint document) — the same code a real upgrade runs —
and the deltas are real signed payloads through ``note_commit``.

Usage:
    python -m at2_node_tpu_torch.tools.bench_durability [--accounts 100000]
        [--shards 64] [--deltas 256,1024] [--verifier cuda|cpu] [--out PATH]
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import json
import os
import shutil
import sys
import tempfile
import time

from ..broadcast.messages import Payload
from ..crypto.keys import ExchangeKeyPair, SignKeyPair
from ..node.config import Config, StoreConfig, VerifierConfig
from ..node.service import Service
from ..store import ShardedStore
from ..types import ThinTransaction
from ._common import OUT_DIR, card_stamp, listen_ports, tool_device

_ports = listen_ports()


def _synthetic_accounts(n: int) -> dict:
    """n deterministic account rows in legacy-checkpoint form. Keys are
    sha256-derived so they spread across shards like real ed25519 keys."""
    return {
        hashlib.sha256(f"bench-acct-{i}".encode()).hexdigest(): [1, 100_000]
        for i in range(n)
    }


def _delta_commits(store: ShardedStore, senders: list, count: int,
                   seq0: int) -> None:
    for k in range(count):
        kp = senders[k % len(senders)]
        seq = seq0 + k // len(senders)
        p = Payload.create(kp, seq, ThinTransaction(b"r" * 32, 1))
        store.note_commit(p, seq, 100_000 - seq, 100_000 + seq)


async def _service_restart(store_dir: str, shards: int, verifier: str) -> dict:
    """Start a real node on the pre-populated store and time the walk
    to a healthy verdict. Peerless on purpose: with nobody to transfer
    state FROM, reaching healthy proves the ledger came off disk."""
    cfg = Config(
        node_address=f"127.0.0.1:{next(_ports)}",
        rpc_address=f"127.0.0.1:{next(_ports)}",
        sign_key=SignKeyPair.random(),
        network_key=ExchangeKeyPair.random(),
        store=StoreConfig(dir=store_dir, shards=shards),
        verifier=VerifierConfig(kind=verifier),
    )
    t0 = time.monotonic()
    service = await Service.start(cfg)
    try:
        verdict = service.health_verdict()
        deadline = time.monotonic() + 30.0
        while (
            verdict["status"] != "ok" and time.monotonic() < deadline
        ):
            await asyncio.sleep(0.05)
            verdict = service.health_verdict()
        elapsed = time.monotonic() - t0
        return {
            "healthy_after_s": round(elapsed, 3),
            "status": verdict["status"],
            "recovery": service.recovery.to_dict(
                service.clock.monotonic()
            ),
            "accounts": service.store.account_count(),
            "catchup_transfers": service._catchup_commits,
        }
    finally:
        await service.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--accounts", type=int, default=100_000)
    ap.add_argument("--shards", type=int, default=64)
    ap.add_argument("--deltas", default="256,1024",
                    help="comma-separated incremental delta sizes")
    ap.add_argument("--verifier", default="cuda", choices=("cuda", "cpu"),
                    help="the restarted node's verifier (default cuda: "
                    "cuda:0, raising without a card)")
    ap.add_argument("--out", default=None,
                    help="output path ('-' for stdout; default "
                    "BENCH_DURABILITY.json under the package's build/bench)")
    args = ap.parse_args(argv)
    deltas = [int(d) for d in args.deltas.split(",") if d]
    device = tool_device(args.verifier, "--verifier cpu")
    out = args.out
    if out is None:
        os.makedirs(OUT_DIR, exist_ok=True)
        out = os.path.join(OUT_DIR, "BENCH_DURABILITY.json")

    root = tempfile.mkdtemp(prefix="at2-bench-store-")
    store_dir = os.path.join(root, "node")
    result = {
        "accounts": args.accounts,
        "shards": args.shards,
        "host_cpus": os.cpu_count(),
        "verifier": args.verifier,
        "card": card_stamp(device),
    }
    try:
        # -- seed via the migration path, then the initial FULL flush
        legacy = {
            "version": 1,
            "accounts": _synthetic_accounts(args.accounts),
            "recent": [],
        }
        t0 = time.monotonic()
        store = ShardedStore.open(
            store_dir, n_shards=args.shards, legacy_checkpoint=legacy
        )
        migrate_s = time.monotonic() - t0
        # a LOCALIZED delta: two senders + one recipient touch at most
        # three shards, so the incremental flush's dirty-shard cost is
        # visibly decoupled from the 100k-account total
        senders = [
            SignKeyPair(hashlib.sha256(f"bench-sender-{i}".encode()).digest())
            for i in range(2)
        ]
        # a second full flush: every shard dirty (worst case), for the
        # incremental ratio's denominator
        _delta_commits(store, senders, args.accounts // 1000, seq0=1)
        for shard in range(args.shards):
            store._dirty.add(shard)
        t0 = time.monotonic()
        full = store.flush(force=True)
        full_s = time.monotonic() - t0
        result["migrate_s"] = round(migrate_s, 3)
        result["full_flush"] = {
            "segments_written": full["segments_written"],
            "bytes": full["segment_bytes"],
            "wall_s": round(full_s, 3),
        }

        # -- incremental flushes at increasing delta sizes
        result["incremental_flush"] = []
        seq0 = 1000
        for delta in deltas:
            wal_before = os.path.getsize(store._wal.path)
            t_commit = time.monotonic()
            _delta_commits(store, senders, delta, seq0=seq0)
            commit_s = time.monotonic() - t_commit
            wal_bytes = os.path.getsize(store._wal.path) - wal_before
            seq0 += delta
            t0 = time.monotonic()
            stats = store.flush()
            wall = time.monotonic() - t0
            result["incremental_flush"].append({
                "delta_commits": delta,
                "segments_written": stats["segments_written"],
                "bytes": stats["segment_bytes"],
                "wall_s": round(wall, 3),
                "bytes_vs_full": round(
                    stats["segment_bytes"] / max(1, full["segment_bytes"]), 4
                ),
                # the strictly delta-sized durability cost: WAL append
                # bytes per commit, independent of account count
                "wal_bytes": wal_bytes,
                "wal_bytes_per_commit": round(wal_bytes / delta, 1),
                "commit_wall_s": round(commit_s, 3),
            })
        store.close()

        # -- the restart: open timing at store level, then a real node
        t0 = time.monotonic()
        reopened = ShardedStore.open(store_dir, n_shards=args.shards)
        result["store_open"] = {
            "wall_s": round(time.monotonic() - t0, 3),
            "segments_loaded": reopened.segments_loaded,
            "wal_replayed": reopened.wal_replayed,
            "accounts": reopened.account_count(),
        }
        reopened.close()
        result["service_restart"] = asyncio.run(
            _service_restart(store_dir, args.shards, args.verifier)
        )
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the acceptance claims, asserted so the bench doubles as a gate
    inc = result["incremental_flush"]
    ok = (
        result["service_restart"]["status"] == "ok"
        and result["service_restart"]["catchup_transfers"] == 0
        and result["store_open"]["accounts"] >= args.accounts
        and all(row["bytes_vs_full"] < 0.10 for row in inc)
    )
    result["delta_bounded"] = all(row["bytes_vs_full"] < 0.10 for row in inc)
    result["ok"] = ok

    blob = json.dumps(result, indent=1)
    if out == "-":
        print(blob)
    else:
        with open(out, "w") as fp:
            fp.write(blob + "\n")
        print(f"banked {out}", file=sys.stderr)
        print(blob)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

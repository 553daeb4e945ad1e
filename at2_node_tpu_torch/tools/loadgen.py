"""send-asset firehose load generator (BASELINE.json config 3).

Counterpart of ``at2_node_tpu/tools/loadgen.py``. Drives an AT2 network
the way the reference's shell tests do — real gRPC ``SendAsset`` calls from
real client identities — at benchmark intensity: K concurrent clients,
each with its own keypair, pipelining self-transfers of 1 with
incrementing sequences, spread round-robin over the node RPC endpoints.
Progress is measured by the ledger itself (polling ``GetLastSequence`` per
sender on the last endpoint, so a count only registers after broadcast
totality commits it). ``run_load(seed=...)`` draws the client keys with
numpy.

Usage:
    python -m at2_node_tpu_torch.tools.loadgen \
        --rpc http://127.0.0.1:4001 --rpc http://127.0.0.1:4003 \
        --clients 16 --tx-per-client 100 [--window 8] [--json]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from dataclasses import dataclass
from typing import List

import numpy as np

from ..client import Client, RetryPolicy
from ..crypto.keys import SignKeyPair


@dataclass
class LoadResult:
    clients: int
    tx_per_client: int
    submitted: int
    committed: int
    submit_seconds: float
    commit_seconds: float

    @property
    def committed_tx_per_sec(self) -> float:
        return self.committed / self.commit_seconds if self.commit_seconds else 0.0


def client_keys(clients: int, seed: int | None = None) -> List[SignKeyPair]:
    """The clients' keypairs: fresh, or drawn from
    ``np.random.default_rng(seed)``."""
    if seed is None:
        return [SignKeyPair.random() for _ in range(clients)]
    rng = np.random.default_rng(seed)
    return [SignKeyPair(rng.bytes(32)) for _ in range(clients)]


async def _client_worker(
    uri: str, keypair: SignKeyPair, n_tx: int, window: int, rpc_batch: int = 1,
    retry_budget: int = 0,
) -> int:
    """Issue n_tx self-transfers with sequences 1..n_tx, keeping up to
    ``window`` requests in flight (a firehose, not a lockstep loop).
    ``rpc_batch`` > 1 ships them ``rpc_batch`` per SendAssetBatch call
    instead of one per SendAsset. ``retry_budget`` > 0 arms the client's
    jittered retry policy for RESOURCE_EXHAUSTED sheds."""
    sent = 0
    window = max(window, 1)
    retry = RetryPolicy(budget=retry_budget) if retry_budget > 0 else None
    async with Client(uri, retry=retry) as client:
        pending: set = set()

        async def _drain_one():
            nonlocal pending, sent
            done, pending = await asyncio.wait(
                pending, return_when=asyncio.FIRST_COMPLETED
            )
            for t in done:
                t.result()
                sent += t.tx_count

        if rpc_batch > 1:
            for lo in range(1, n_tx + 1, rpc_batch):
                seqs = range(lo, min(lo + rpc_batch, n_tx + 1))
                if len(pending) >= window:
                    await _drain_one()
                task = asyncio.create_task(
                    client.send_asset_many(
                        keypair, [(s, keypair.public, 1) for s in seqs]
                    )
                )
                task.tx_count = len(seqs)
                pending.add(task)
        else:
            for seq in range(1, n_tx + 1):
                if len(pending) >= window:
                    await _drain_one()
                task = asyncio.create_task(
                    client.send_asset(keypair, seq, keypair.public, 1)
                )
                task.tx_count = 1
                pending.add(task)
        for t in pending:
            await t
            sent += t.tx_count
    return sent


async def _wait_committed(
    uri: str, keypairs: List[SignKeyPair], n_tx: int, timeout: float
) -> int:
    """Poll a (read-side) node until every sender's last sequence reaches
    n_tx or the timeout expires; returns total committed transactions."""
    deadline = time.monotonic() + timeout
    async with Client(uri) as client:
        remaining = {kp.public: 0 for kp in keypairs}
        while time.monotonic() < deadline:
            for pk in list(remaining):
                seq = await client.get_last_sequence(pk)
                remaining[pk] = seq
                if seq >= n_tx:
                    del remaining[pk]
            if not remaining:
                return n_tx * len(keypairs)
            await asyncio.sleep(0.1)
        done = n_tx * len(keypairs) - sum(
            n_tx - seq for seq in remaining.values()
        )
        return done


async def run_load(
    rpcs: List[str],
    clients: int = 16,
    tx_per_client: int = 100,
    window: int = 8,
    commit_timeout: float = 120.0,
    rpc_batch: int = 1,
    broker: bool = False,
    retry_budget: int = 0,
    seed: int | None = None,
) -> LoadResult:
    keypairs = client_keys(clients, seed)
    if broker:
        # Directory warmup: pre-register every client identity so the
        # measured window ships distilled frames with resolvable ids,
        # not Register round-trips. The endpoints serve the same at2.AT2
        # surface either way (the broker proxies reads through), so only
        # this warmup differs from direct-node mode.
        async def _register(uri: str, kp: SignKeyPair) -> None:
            async with Client(uri) as c:
                await c.register(kp.public)

        await asyncio.gather(
            *(
                _register(rpcs[i % len(rpcs)], kp)
                for i, kp in enumerate(keypairs)
            )
        )
    t0 = time.monotonic()
    sent = await asyncio.gather(
        *(
            _client_worker(
                rpcs[i % len(rpcs)], kp, tx_per_client, window, rpc_batch,
                retry_budget,
            )
            for i, kp in enumerate(keypairs)
        )
    )
    submit_s = time.monotonic() - t0
    # read from the LAST endpoint, round-robin ensured writes went elsewhere
    # too; totality means any node converges
    committed = await _wait_committed(
        rpcs[-1], keypairs, tx_per_client, commit_timeout
    )
    commit_s = time.monotonic() - t0
    return LoadResult(
        clients=clients,
        tx_per_client=tx_per_client,
        submitted=sum(sent),
        committed=committed,
        submit_seconds=submit_s,
        commit_seconds=commit_s,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rpc", action="append", required=True,
                    help="node RPC URL (repeat for round-robin)")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--tx-per-client", type=int, default=100)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--commit-timeout", type=float, default=120.0)
    ap.add_argument("--rpc-batch", type=int, default=1,
                    help="transfers per SendAssetBatch call (1 = unary "
                    "SendAsset, reference-parity surface)")
    ap.add_argument("--broker", action="store_true",
                    help="the --rpc endpoints are broker ingress tiers "
                    "(tools/broker.py): pre-register every client into "
                    "the directory, then fire the same load — the broker "
                    "distills it into SendDistilledBatch frames")
    ap.add_argument("--retry-budget", type=int, default=0,
                    help="retries per call for RESOURCE_EXHAUSTED sheds "
                    "(jittered exponential backoff honoring the server's "
                    "retry_after_ms hint; 0 = fail fast)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    res = asyncio.run(
        run_load(
            args.rpc,
            clients=args.clients,
            tx_per_client=args.tx_per_client,
            window=args.window,
            commit_timeout=args.commit_timeout,
            rpc_batch=args.rpc_batch,
            broker=args.broker,
            retry_budget=args.retry_budget,
        )
    )
    if args.json:
        print(json.dumps({
            "clients": res.clients,
            "submitted": res.submitted,
            "committed": res.committed,
            "submit_seconds": round(res.submit_seconds, 3),
            "commit_seconds": round(res.commit_seconds, 3),
            "committed_tx_per_sec": round(res.committed_tx_per_sec, 1),
        }))
    else:
        print(
            f"{res.committed}/{res.clients * res.tx_per_client} tx committed "
            f"in {res.commit_seconds:.2f}s -> "
            f"{res.committed_tx_per_sec:.0f} tx/s"
        )
    return 0 if res.committed == res.clients * res.tx_per_client else 1


if __name__ == "__main__":
    sys.exit(main())

"""BASELINE config 5 — the scale-out demo: a device pool behind a 32-node
network, plus a 1M-signature replay through the pool.

Counterpart of ``at2_node_tpu/tools/scale_demo.py``, its CUDA arm. Two
phases, one JSON artifact:

1. **32-node net, shared pool.** 32 in-process AT2 nodes (full encrypted
   mesh, real gRPC surfaces) all send their signature checks into ONE
   shared :class:`~at2_node_tpu_torch.parallel.pool.PoolVerifier`
   (``Service.start(config, verifier=...)``), built from the ``[verifier]
   kind = "pool"`` table. A send-asset load (``tools/loadgen.py``) is
   driven through the public RPC surface; the committed tx/s, the pool's
   occupancy and the kernel's launches are recorded, and every node's
   ledger is held to a python-int replay. Thresholds are 2f+1 peers with
   f = (n - 1) // 3.
2. **1M-signature replay.** One million signatures streamed through the
   pool in production buckets (``verify_batch_sharded``), measuring
   verifies/s on the host clock.

``--devices`` names the pool's devices (a comma list; default every local
CUDA device, and without one it fails: there is no CPU fallback).
``--devices cpu,cpu`` runs each shard's plain PyTorch version on the CPU,
at toy sizes only.

Usage:
    python -m at2_node_tpu_torch.tools.scale_demo [--nodes 32] [--clients 32]
        [--tx-per-client 25] [--replay 1000000] [--devices cuda:0,cuda:1]
        [--out SCALE.json]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import resource
import sys
import time
from typing import Iterator, List, Sequence

from ..crypto.keys import SignKeyPair
from ..node.config import VerifierConfig
from ..node.service import Service
from ._common import host_context, listen_ports, make_net_configs, port_counter
from .loadgen import client_keys, run_load

INITIAL_BALANCE = 100_000
# tries to bring the net up (see _phase_net)
NET_STARTS = 3


def open_files_needed(n_nodes: int) -> int:
    """File descriptors an in-process net of n nodes holds: both ends of
    every peer channel (2 n (n - 1)) and, per node, its listeners, its
    gRPC surface and its clients' channels, with room to spare."""
    return 2 * n_nodes * (n_nodes - 1) + 16 * n_nodes + 256


def raise_open_files(need: int) -> tuple:
    """Raise this process's soft RLIMIT_NOFILE to its hard limit; (soft,
    hard) after. Raises when even the hard limit is below ``need``: the
    net is never cut to fit."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    target = hard if hard != resource.RLIM_INFINITY else max(soft, 1 << 20)
    if soft < target:
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE, (target, hard))
        except (ValueError, OSError):
            pass
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < need:
        raise RuntimeError(
            f"open-file limit {soft} (hard {hard}) is below the {need} this net needs"
        )
    return soft, hard


def replay_ledger(transfers) -> dict:
    """The ledger rules in python ints over (sender, seq, recipient,
    amount) in order: {hex key: [last_sequence, balance]}."""
    state: dict = {}
    for sender, seq, recipient, amount in transfers:
        s = state.setdefault(sender, [0, INITIAL_BALANCE])
        if s[0] + 1 != seq:
            continue
        s[0] = seq
        if amount > s[1]:
            continue
        s[1] -= amount
        r = state.setdefault(recipient, [0, INITIAL_BALANCE])
        r[1] += amount
    return {k.hex(): v for k, v in state.items()}


async def _wait_ledgers(services: List[Service], want: dict, timeout: float) -> float:
    """Poll every node's ledger until each equals ``want``; the seconds it
    took. Raises at the timeout, naming the nodes short of it."""
    t0 = time.monotonic()
    while True:
        states = [await s.accounts.export_state() for s in services]
        short = [i for i, st in enumerate(states) if st != want]
        if not short:
            return time.monotonic() - t0
        if time.monotonic() - t0 > timeout:
            raise RuntimeError(f"nodes {short} differ from the replay after {timeout} s")
        await asyncio.sleep(0.1)


async def _settle(verifier, quiet: float = 0.5, timeout: float = 60.0) -> None:
    """Wait until the shared verifier has been idle for ``quiet`` seconds:
    nothing queued, no batch in flight, no signature verified. Nodes go on
    checking late Echo and Ready signatures after their ledgers converge;
    the pool's counters are read once that tail has drained."""
    t0 = last_change = time.monotonic()
    seen = None
    while time.monotonic() - t0 < timeout:
        stats = verifier.stats()
        now = (stats["queue_depth"], stats["signatures"], len(verifier._completions))
        if now != seen or now[0] or now[2]:
            seen, last_change = now, time.monotonic()
        elif time.monotonic() - last_change >= quiet:
            return
        await asyncio.sleep(0.05)
    raise RuntimeError(f"the shared verifier did not settle within {timeout} s")


async def _phase_net(
    n_nodes: int,
    clients: int,
    tx_per_client: int,
    threshold: int,
    pool_batch: int = 4096,
    devices: Sequence | None = None,
    ports: Iterator[int] | None = None,
    seed: int | None = None,
    commit_timeout: float = 600.0,
) -> dict:
    from ..ops import cuda_verify
    from ..parallel.pool import PoolVerifier

    # big bucket + longer flush window: occupancy beats latency here
    table = VerifierConfig(kind="pool", batch_size=pool_batch, max_delay=0.01)
    if devices is None:
        shared = table.make()
    else:
        shared = PoolVerifier(batch_size=table.batch_size, max_delay=table.max_delay,
                              devices=devices)
    ports = ports if ports is not None else listen_ports(seed)
    services: List[Service] = []
    try:
        await shared.warmup()
        # a listener's port can be taken between its draw and its node's
        # bind (by another node's outgoing connection or port-0 bind):
        # then the net starts again on fresh ports, with the same keys
        for start in range(1, NET_STARTS + 1):
            cfgs = make_net_configs(n_nodes, ports, seed=seed, echo_threshold=threshold,
                                    ready_threshold=threshold)
            try:
                for cfg in cfgs:
                    services.append(await Service.start(cfg, verifier=shared))
                break
            except OSError:
                for s in services:
                    await s.close()
                services.clear()
                if start == NET_STARTS:
                    raise
        rpcs = [f"http://{c.rpc_address}" for c in cfgs]
        load_seed = None if seed is None else seed + 1
        await _settle(shared)
        stats0 = shared.stats()
        launches0 = cuda_verify.launches
        result = await run_load(
            rpcs,
            clients=clients,
            tx_per_client=tx_per_client,
            window=8,
            commit_timeout=commit_timeout,
            seed=load_seed,
        )
        window_launches = cuda_verify.launches - launches0
        # self-transfers of 1 (loadgen's): every ledger must equal the replay
        want = replay_ledger(
            (kp.public, seq, kp.public, 1)
            for kp in client_keys(clients, load_seed)
            for seq in range(1, tx_per_client + 1)
        )
        all_nodes_s = await _wait_ledgers(services, want, commit_timeout)
        await _settle(shared)
        launches = cuda_verify.launches - launches0
        stats = shared.stats()
        return {
            "nodes": n_nodes,
            "net_starts": start,
            "echo_threshold": threshold,
            "clients": clients,
            "submitted": result.submitted,
            "committed": result.committed,
            "commit_seconds": result.commit_seconds,
            "committed_tx_per_sec": result.committed_tx_per_sec,
            "ledgers_equal_replay_on_all_nodes": True,
            "all_nodes_extra_seconds": all_nodes_s,
            "pool_devices": [str(d) for d in shared.devices],
            "pool_batches": stats["batches"] - stats0["batches"],
            "pool_signatures": stats["signatures"] - stats0["signatures"],
            "pool_batch_occupancy": stats["batch_occupancy"],
            "pool_avg_dispatch_ms": stats["avg_dispatch_ms"],
            "kernel_launches": launches,
            "kernel_launches_in_window": window_launches,
        }
    finally:
        for s in services:
            await s.close()
        await shared.close()


def _phase_replay(total: int, bucket: int = 4096, devices: Sequence | None = None) -> dict:
    """Stream ``total`` signatures through the pool in ``bucket``-lane
    batches; one key, one unique message per lane (pre-signed trace)."""
    from ..ops import cuda_verify
    from ..parallel import pool

    devs = pool.make_pool_devices(devices)
    kp = SignKeyPair.from_hex("7e" * 32)
    msgs = [b"replay tx %08d" % i for i in range(bucket)]
    sigs = [kp.sign(m) for m in msgs]
    pks = [kp.public] * bucket
    # warm-up: the kernel's build and first launch
    out = pool.verify_batch_sharded(pks, msgs, sigs, devices=devs)
    if not out.all():
        raise RuntimeError("replay warm-up batch did not verify")
    rounds = max(1, total // bucket)
    launches0 = cuda_verify.launches
    t0 = time.perf_counter()
    done = 0
    for _ in range(rounds):
        out = pool.verify_batch_sharded(pks, msgs, sigs, devices=devs)
        done += int(out.sum())
    dt = time.perf_counter() - t0
    return {
        "replayed_signatures": rounds * bucket,
        "verified_ok": done,
        "seconds": dt,
        "verifies_per_sec": rounds * bucket / dt,
        "bucket": bucket,
        "mesh_devices": len(devs),
        "kernel_launches": cuda_verify.launches - launches0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=32)
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--tx-per-client", type=int, default=25)
    ap.add_argument("--threshold", type=int, default=None,
                    help="echo/ready threshold (default: 2f+1 with f=(n-1)//3)")
    ap.add_argument("--replay", type=int, default=1_000_000)
    ap.add_argument("--replay-bucket", type=int, default=4096,
                    help="replay dispatch bucket")
    ap.add_argument("--pool-batch", type=int, default=4096)
    ap.add_argument("--skip-replay", action="store_true")
    ap.add_argument("--devices", default=None,
                    help="comma list of the pool's devices (default: every "
                    "local CUDA device); 'cpu' entries run the plain version")
    ap.add_argument("--skip-net", action="store_true")
    ap.add_argument("--budget", type=float, default=0.0,
                    help="wall-clock budget in seconds (0 = none): phases "
                    "that would start past the budget are recorded as "
                    "skipped")
    ap.add_argument("--seed", type=int, default=None,
                    help="draw node and client keys with numpy from this seed")
    ap.add_argument("--port-base", type=int, default=None,
                    help="first of the 2 x nodes consecutive ports (default: "
                    "free ports outside the ephemeral range)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    devices = args.devices.split(",") if args.devices else None
    threshold = args.threshold
    if threshold is None:
        f = (args.nodes - 1) // 3
        threshold = 2 * f + 1

    t0 = time.monotonic()

    def over_budget() -> bool:
        return args.budget > 0 and time.monotonic() - t0 > args.budget

    artifact = {
        "config": "BASELINE-5: device pool behind 32 nodes, 1M-tx replay",
        "host_context": host_context(),
    }

    def flush():
        """Incremental artifact write: a later phase failing must not lose
        a finished phase."""
        if args.out:
            with open(args.out, "w") as fp:
                fp.write(json.dumps(artifact) + "\n")

    flush()
    if not args.skip_net:
        soft, hard = raise_open_files(open_files_needed(args.nodes))
        artifact["open_files_limit"] = {"soft": soft, "hard": hard}
        artifact["net"] = asyncio.run(
            _phase_net(
                args.nodes,
                args.clients,
                args.tx_per_client,
                threshold,
                pool_batch=args.pool_batch,
                devices=devices,
                ports=None if args.port_base is None else port_counter(args.port_base),
                seed=args.seed,
            )
        )
        flush()
    if not args.skip_replay:
        if over_budget():
            artifact["replay"] = {
                "status": "skipped: wall-clock budget exhausted before the "
                "replay phase; rerun with --skip-net"
            }
        else:
            artifact["replay"] = _phase_replay(
                args.replay, bucket=args.replay_bucket, devices=devices
            )
        flush()
    print(json.dumps(artifact))
    return 0


if __name__ == "__main__":
    sys.exit(main())

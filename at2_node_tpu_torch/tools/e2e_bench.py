"""BASELINE configs 1 & 3 — 4-node end-to-end send-asset throughput.

Counterpart of ``at2_node_tpu/tools/e2e_bench.py``. The device arm is
``cuda_inprocess`` (``--skip-cuda`` skips it), on ``cuda:0`` unless
``--device cpu`` runs the verifier's plain version (without a card and
without that flag the tool raises); ``--compose`` runs the port's
``verify_bench`` in process where the reference ran ``bench.py``, and
where the reference fell back to a labelled CPU row for want of a chip,
the port raises. Rows carry ``card`` (the card's name and power limit, or
``"cpu"``). Artifacts go only where ``--out`` says, and the banked rows
to ``--bank-dir`` (by default the package's git-ignored ``build/bench``).

Two phases, one JSON artifact:

* **cpu_subprocess** (config 1, the reference's execution model): four
  REAL `server` processes bootstrapped exactly like the operator workflow
  (`config new` + concatenated `config get-node` fragments over stdin),
  CPU verifier, driven by the gRPC load generator. This is the number to
  compare against the reference's tokio/rust runtime on equal hardware.
* **cuda_inprocess** (config 3, the device model): four nodes in one
  process SHARING one `CudaBatchVerifier` (batch_size=256) — the only
  sane topology when one host owns one card — 16-client firehose; the
  artifact records the verifier's batch occupancy and dispatch latency
  alongside committed tx/s, plus per-stage broadcast counters for the
  bottleneck analysis.

The artifact also records the host context (CPU count), because the
broadcast plane is quadratic in nodes: a 4-node full-quorum commit costs
~28 signature verifications and ~44 protocol messages across the net,
all of which share this machine's core(s) with the clients and the
loadgen itself.

A third mode, ``--compose``, produces BENCH_PIPELINE.json instead: one
self-banking run that reruns the verify grid (``verify_bench`` —
pipelined vs device-only per bucket), measures the batched-plane
ceiling, then drives the composed load — SendAssetBatch ingress +
batched broadcast plane + the card's verifier — and closes with the
plane/ingress/crypto decomposition showing which term binds the
10k-tx/s target. Each phase is written to disk the moment it completes.

Usage:
    python -m at2_node_tpu_torch.tools.e2e_bench [--clients 16]
        [--tx-per-client 50] [--skip-cpu] [--skip-cuda] [--device cuda|cpu]
        [--out PATH]
    python -m at2_node_tpu_torch.tools.e2e_bench --compose [--rpc-batch 64]
        [--trials 3] [--out PATH]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List

from ._common import OUT_DIR, card_stamp, listen_ports, tool_device

REPO = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
SERVER = [sys.executable, "-m", "at2_node_tpu_torch.cli.server"]

_ports = listen_ports()


def _run_cli(argv, stdin=None) -> str:
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        argv, input=stdin, capture_output=True, text=True, env=env, timeout=60
    )
    if proc.returncode != 0:
        raise RuntimeError(f"{argv} failed: {proc.stderr}")
    return proc.stdout


def _wait_port(port: int, timeout: float = 60.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            time.sleep(0.1)
    raise TimeoutError(f"port {port} never came up")


def _phase_cpu_subprocess(
    n_nodes: int,
    clients: int,
    tx_per_client: int,
    rpc_batch: int = 1,
    window: int = 8,
) -> dict:
    from .loadgen import run_load

    ports = [(next(_ports), next(_ports)) for _ in range(n_nodes)]
    # the port's servers default to the card: the host verifier is asked
    # for in so many words ([verifier] kind = "cpu")
    configs = [
        _run_cli(SERVER + ["config", "new", "--verifier", "cpu",
                           f"127.0.0.1:{np}", f"127.0.0.1:{rp}"])
        for np, rp in ports
    ]
    fragments = [
        _run_cli(SERVER + ["config", "get-node"], stdin=cfg) for cfg in configs
    ]
    env = dict(os.environ, PYTHONPATH=REPO)
    procs: List[subprocess.Popen] = []
    try:
        for i, cfg in enumerate(configs):
            full = cfg + "\n" + "\n".join(
                f for j, f in enumerate(fragments) if j != i
            )
            p = subprocess.Popen(
                SERVER + ["run"],
                stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL,
                stderr=subprocess.DEVNULL,
                text=True,
                env=env,
            )
            p.stdin.write(full)
            p.stdin.close()
            procs.append(p)
        for np, rp in ports:
            _wait_port(np)
            _wait_port(rp)
        rpcs = [f"http://127.0.0.1:{rp}" for _, rp in ports]
        result = asyncio.run(
            run_load(
                rpcs,
                clients=clients,
                tx_per_client=tx_per_client,
                window=window,
                commit_timeout=600.0,
                rpc_batch=rpc_batch,
            )
        )
        # lifecycle percentiles come over the WIRE here — the nodes are
        # subprocesses, so /statusz is the only window into them (and
        # this doubles as an end-to-end exercise of the endpoint)
        latency: dict = {}
        try:
            from .top import fetch_statusz

            sz = asyncio.run(fetch_statusz("127.0.0.1", ports[0][1]))
            life = sz.get("tx_lifecycle", {}).get("ingress_to_committed", {})
            latency = {
                "ingress_to_commit_p50_ms": life.get("p50_ms", 0.0),
                "ingress_to_commit_p99_ms": life.get("p99_ms", 0.0),
                "traced": life.get("count", 0),
            }
        except Exception:
            pass  # older server binary / endpoint disabled: row stays honest
        return {
            "nodes": n_nodes,
            "topology": "4 server subprocesses, CPU verifier",
            "card": "cpu",
            "rpc_batch": rpc_batch,
            "window": window,
            "clients": clients,
            "submitted": result.submitted,
            "committed": result.committed,
            "commit_seconds": round(result.commit_seconds, 2),
            "committed_tx_per_sec": round(result.committed_tx_per_sec, 1),
            "latency": latency,
        }
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=5)
            except subprocess.TimeoutExpired:
                p.kill()


def _verifier_block(shared, kind: str) -> dict:
    """Pull the pipeline-health counters out of a verifier's stats() —
    everything a reader needs to judge the dispatch pipeline from the
    artifact alone (occupancy/padding for bucket shaping, per-stage ms
    for the overlap story, queue_peak for backpressure headroom)."""
    vstats = shared.stats()
    block: dict = {"kind": kind}
    for key, nd in (
        ("batches", None),
        ("signatures", None),
        ("batch_occupancy", 4),
        ("padding_ratio", 4),
        ("avg_dispatch_ms", 2),
        ("prep_ms_avg", 2),
        ("launch_ms_avg", 2),
        ("finish_ms_avg", 2),
        ("queue_peak", None),
        ("max_queue", None),
        # queue-wait distribution: the tail between enqueue
        # and dispatch, the term the stage means can't show
        ("queue_wait_p50_ms", 3),
        ("queue_wait_p99_ms", 3),
        ("queue_wait_max_ms", 3),
    ):
        if key in vstats:
            v = vstats[key]
            block[key] = round(v, nd) if nd is not None and isinstance(v, float) else v
    return block


async def _phase_cuda_inprocess(
    n_nodes: int,
    clients: int,
    tx_per_client: int,
    rpc_batch: int = 1,
    window: int = 8,
    device: str = "cuda",
    buckets: tuple | None = None,
    seed: int | None = None,
) -> dict:
    """Config 3: ``n_nodes`` in-process nodes sharing one
    ``CudaBatchVerifier`` on ``device``; ``seed`` draws the node and
    client keys with numpy (fresh keys when None). The result carries the
    ledger of every node (``ledgers``: hex account -> [sequence,
    balance])."""
    from ..crypto.verifier import CudaBatchVerifier
    from ..node.service import Service
    from ._common import make_net_configs
    from .loadgen import run_load

    dev = tool_device(device)
    shared = CudaBatchVerifier(
        batch_size=256, max_delay=0.005, buckets=buckets, device=dev
    )
    topology = f"{n_nodes} in-process nodes sharing one CudaBatchVerifier"
    await shared.warmup()

    cfgs = make_net_configs(n_nodes, _ports, seed=seed)
    services: List[Service] = []
    try:
        for cfg in cfgs:
            services.append(await Service.start(cfg, verifier=shared))
        rpcs = [f"http://{c.rpc_address}" for c in cfgs]
        result = await run_load(
            rpcs,
            clients=clients,
            tx_per_client=tx_per_client,
            window=window,
            commit_timeout=600.0,
            rpc_batch=rpc_batch,
            seed=seed,
        )
        # every node's ledger once the load has committed everywhere
        deadline = time.monotonic() + 60.0
        while (min(s.committed for s in services) < result.committed
               and time.monotonic() < deadline):
            await asyncio.sleep(0.05)
        ledgers = [await s.accounts.export_state() for s in services]
        bstats = services[0].snapshot_stats()
        out = {
            "nodes": n_nodes,
            "topology": topology,
            "rpc_batch": rpc_batch,
            "window": window,
            "clients": clients,
            "submitted": result.submitted,
            "committed": result.committed,
            "submit_seconds": round(result.submit_seconds, 2),
            # the ingress term: how fast the RPC surface swallowed the
            # load, independent of how long commit convergence took
            "ingress_tx_per_sec": round(
                result.submitted / result.submit_seconds, 1
            )
            if result.submit_seconds
            else 0.0,
            "commit_seconds": round(result.commit_seconds, 2),
            "committed_tx_per_sec": round(result.committed_tx_per_sec, 1),
            "verifier": _verifier_block(shared, "cuda"),
            "node0_broadcast_stats": {
                k: bstats[k]
                for k in ("gossip_rx", "echo_rx", "ready_rx", "delivered")
                if k in bstats
            },
            # lifecycle percentiles as node 0's tracer saw its share of
            # the ingress (BENCH_* rows carry latency)
            "latency": {
                "ingress_to_commit_p50_ms": bstats.get(
                    "tx_ingress_to_committed_p50_ms", 0.0
                ),
                "ingress_to_commit_p99_ms": bstats.get(
                    "tx_ingress_to_committed_p99_ms", 0.0
                ),
                "traced": bstats.get("tx_trace_completed", 0),
            },
            "committed_per_node": [s.committed for s in services],
            "ledgers": ledgers,
            "card": card_stamp(dev),
        }
        return out
    finally:
        for s in services:
            await s.close()
        await shared.close()


async def _phase_ingress_decomposition(
    clients: int = 16,
    per_tx_count: int = 8192,
    distilled_count: int = 32768,
    frame_entries: int = 4096,
    window: int = 64,
) -> dict:
    """Crypto-free RPC ingress ceiling, A/B: the per-tx surface (unary
    SendAsset, one proto + one handler pass per transfer) against the
    distilled broker frame (SendDistilledBatch, sorted delta-coded ids +
    columnar signatures, native bulk expand). One node, verification
    stubbed out (`_TrustAllVerifier`), requests pre-built before the
    clock starts — what's measured is purely how fast the node's RPC
    surface swallows transfers. The broker tier exists to turn client
    traffic into row B: its ratio over row A is the ingress headroom the
    distillation buys on one core (target >= 3x)."""
    from ..node.service import Service
    from ..proto import at2_pb2 as pb
    from ..proto import distill
    from ._common import make_net_configs
    from .plane_bench import _TrustAllVerifier

    async def _pipelined(calls, window):
        t0 = time.perf_counter()
        pending: set = set()
        for call in calls:
            if len(pending) >= window:
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED
                )
                for d in done:
                    d.result()
            pending.add(asyncio.ensure_future(call()))
        for d in asyncio.as_completed(pending):
            await d
        return time.perf_counter() - t0

    cfgs = make_net_configs(1, _ports)
    service = await Service.start(cfgs[0], verifier=_TrustAllVerifier())
    try:
        from ..client import Client
        from ..crypto.keys import SignKeyPair

        keypairs = [
            SignKeyPair.from_hex(f"{i + 1:02x}" * 32) for i in range(clients)
        ]
        recipient_kp = SignKeyPair.from_hex(f"{clients + 1:02x}" * 32)
        sig = b"\x11" * 64  # TrustAll: signature bytes are never inspected
        async with Client(f"http://{cfgs[0].rpc_address}") as c:
            ids = [await c.register(kp.public) for kp in keypairs]
            rcpt_id = await c.register(recipient_kp.public)
            rcpt = recipient_kp.public

            # row A: unary SendAsset, pre-built requests
            per_client = per_tx_count // clients
            reqs = [
                pb.SendAssetRequest(
                    sender=kp.public, sequence=s, recipient=rcpt,
                    amount=1, signature=sig,
                )
                for kp in keypairs
                for s in range(1, per_client + 1)
            ]
            stub = c._stub
            a_seconds = await _pipelined(
                [lambda r=r: stub.SendAsset(r) for r in reqs], window
            )
            a_rate = round(len(reqs) / a_seconds, 1)

            # drain the commit backlog so row B starts on an idle node
            deadline = time.monotonic() + 120.0
            while service.committed < len(reqs):
                await asyncio.sleep(0.05)
                if time.monotonic() > deadline:
                    break

            # row B: the same transfer stream as distilled frames
            # (sequences continue past row A's; recipient by directory id)
            per_client_b = distilled_count // clients
            entries = [
                distill.DistilledEntry(
                    ids[ci], s, rcpt_id, 1, sig
                )
                for ci in range(clients)
                for s in range(
                    per_client + 1, per_client + per_client_b + 1
                )
            ]
            frames = [
                distill.distill(entries[lo : lo + frame_entries])[0]
                for lo in range(0, len(entries), frame_entries)
            ]
            b_seconds = await _pipelined(
                [
                    lambda f=f: stub.SendDistilledBatch(
                        pb.SendDistilledBatchRequest(frame=f)
                    )
                    for f in frames
                ],
                8,
            )
            b_rate = round(len(entries) / b_seconds, 1)

        native = False
        try:
            from ..native.ingest import ingest_ready

            native = ingest_ready()
        except Exception:
            pass
        return {
            "config": (
                "1 node, crypto-free verifier: RPC ingress ceiling A/B "
                "(pre-built requests, ACK-measured)"
            ),
            "captured_at": time.strftime("%Y-%m-%d"),
            "card": "cpu",  # crypto-free: nothing runs on the card
            "clients": clients,
            "native_distill_parse": native,
            "per_tx": {
                "surface": "SendAsset (unary)",
                "submitted": len(reqs),
                "window": window,
                "submit_seconds": round(a_seconds, 3),
                "ingress_tx_per_sec": a_rate,
            },
            "distilled": {
                "surface": f"SendDistilledBatch ({frame_entries}-entry frames)",
                "submitted": len(entries),
                "frames": len(frames),
                "bytes_per_tx": round(
                    sum(len(f) for f in frames) / len(entries), 1
                ),
                "submit_seconds": round(b_seconds, 3),
                "ingress_tx_per_sec": b_rate,
            },
            "node_counters": dict(service.distill_stats.items()),
            "speedup_vs_per_tx": round(b_rate / a_rate, 2) if a_rate else None,
            # the reference's crypto-free ingress ceiling on its build
            # host (rpc-batch 128): the figure the broker tier is
            # chartered to beat 3x
            "prior_crypto_free_ceiling_tx_per_sec": 3397.0,
            "target": "distilled >= 3x the crypto-free ingress ceiling "
                      "(3.4k tx/s) AND >= 3x same-day per-tx, one core",
            "target_met": bool(
                a_rate and b_rate >= 3 * a_rate and b_rate >= 3 * 3397.0
            ),
        }
    finally:
        await service.close()


def _bank_e2e_row(bank_dir: str, key: str, block: dict) -> None:
    """Merge one labeled row into ``bank_dir``'s BENCH_E2E.json."""
    os.makedirs(bank_dir, exist_ok=True)
    path = os.path.join(bank_dir, "BENCH_E2E.json")
    doc = {}
    if os.path.exists(path):
        with open(path) as fp:
            doc = json.load(fp)
    doc[key] = block
    tmp = path + ".tmp"
    with open(tmp, "w") as fp:
        json.dump(doc, fp, indent=1)
        fp.write("\n")
    os.replace(tmp, path)


# --------------------------------------------------------------------------
# --compose: the composed 10k-tx/s story in one run -> BENCH_PIPELINE.json
# --------------------------------------------------------------------------

def _bank(path: str, artifact: dict) -> None:
    """Atomic per-phase write: the artifact on disk is always the banked
    prefix of completed phases, so a failure mid-compose still leaves
    every finished phase behind."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fp:
        json.dump(artifact, fp, indent=1)
        fp.write("\n")
    os.replace(tmp, path)


def _decompose(artifact: dict) -> dict:
    """Which term binds? plane (broadcast commit ceiling) vs ingress (RPC
    swallow rate) vs crypto (verifier sigs/s over measured sigs per
    committed tx). The composed tx/s can't beat the minimum of the three;
    the gap between min(term) and the composed figure is integration
    overhead."""
    composed = artifact.get("composed") or {}
    plane = artifact.get("plane") or {}
    grid = artifact.get("verify_grid") or {}

    committed = composed.get("committed") or 0
    sigs = (composed.get("verifier") or {}).get("signatures") or 0
    sigs_per_tx = round(sigs / committed, 2) if committed else None

    verify_rate = grid.get("value") or 0.0
    verify_src = f"{grid.get('device')} pipelined, bucket {grid.get('bucket')}"

    crypto_bound = (
        round(verify_rate / sigs_per_tx, 1) if sigs_per_tx else None
    )
    terms = {
        "plane_tx_per_sec": plane.get("committed_tx_per_sec"),
        "ingress_tx_per_sec": composed.get("ingress_tx_per_sec"),
        "crypto_bound_tx_per_sec": crypto_bound,
    }
    live_terms = {
        k: v for k, v in terms.items() if isinstance(v, (int, float)) and v > 0
    }
    composed_rate = composed.get("committed_tx_per_sec") or 0.0
    return {
        **terms,
        "sigs_per_committed_tx": sigs_per_tx,
        "verify_rate_sigs_per_sec": verify_rate,
        "verify_rate_source": verify_src,
        "binding_term": min(live_terms, key=live_terms.get)
        if live_terms
        else None,
        "composed_tx_per_sec": composed_rate,
        "target_met": composed_rate >= 10_000,
    }


def _compose(args) -> int:
    from . import plane_bench, verify_bench
    from ._common import host_context

    out_path = args.out or os.path.join(OUT_DIR, "BENCH_PIPELINE.json")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    dev = tool_device(args.device)
    artifact: dict = {
        "config": (
            "composed run: batched plane + SendAssetBatch ingress + "
            "dispatch pipeline"
        ),
        "host_context": host_context(),
        "target_tx_per_sec": 10_000,
        "card": card_stamp(dev),
        "phases_completed": [],
    }
    _bank(out_path, artifact)

    # phase 1: the verify grid — pipelined vs device-only per bucket
    artifact["verify_grid"], _ = verify_bench.run(
        args.device, trials=args.trials
    )
    artifact["phases_completed"].append("verify_grid")
    _bank(out_path, artifact)

    # phase 2: batched broadcast-plane ceiling, verification off the
    # critical path (what the plane does in front of an unbounded verifier)
    try:
        artifact["plane"] = asyncio.run(
            plane_bench.run(
                args.nodes,
                txs=512,
                verifier="plane-only",
                timeout=240.0,
                batch=max(args.rpc_batch, 1),
            )
        )
    except Exception as exc:
        artifact["plane"] = {"error": str(exc)[:300]}
    artifact["phases_completed"].append("plane")
    _bank(out_path, artifact)

    # phase 2b: crypto-free ingress ceiling A/B (per-tx vs distilled
    # broker frames); the labeled row also lands in BENCH_E2E.json
    try:
        block = asyncio.run(_phase_ingress_decomposition())
        artifact["ingress_decomposition"] = block
        _bank_e2e_row(args.bank_dir, "ingress_decomposition", block)
    except Exception as exc:
        artifact["ingress_decomposition"] = {"error": str(exc)[:300]}
    artifact["phases_completed"].append("ingress_decomposition")
    _bank(out_path, artifact)

    # phase 3: the composed run — real RPC ingress, batched plane, the
    # card's verifier end to end; a failure of the device fails the run
    composed = asyncio.run(
        _phase_cuda_inprocess(
            args.nodes,
            args.clients,
            args.tx_per_client,
            rpc_batch=args.rpc_batch,
            window=args.window,
            device=args.device,
            buckets=(64, 256, 1024),
        )
    )
    composed.pop("ledgers")
    artifact["composed"] = composed
    artifact["phases_completed"].append("composed")
    _bank(out_path, artifact)

    # phase 4: the bottleneck decomposition
    artifact["decomposition"] = _decompose(artifact)
    artifact["phases_completed"].append("decomposition")
    _bank(out_path, artifact)
    print(json.dumps(artifact))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--tx-per-client", type=int, default=50)
    ap.add_argument("--window", type=int, default=8,
                    help="in-flight RPCs per client (in-flight TRANSFERS "
                    "= window x rpc_batch; match them when A/B-ing "
                    "unary vs bulk ingress)")
    ap.add_argument("--rpc-batch", type=int, default=None,
                    help="transfers per SendAssetBatch call (1 = unary "
                    "SendAsset, the reference-parity surface; default 1, "
                    "or 64 under --compose where bulk ingress IS the "
                    "story)")
    ap.add_argument("--skip-cpu", action="store_true")
    ap.add_argument("--skip-cuda", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device arm's verifier: cuda (cuda:0, the "
                    "default; raises without a card) or cpu (its plain "
                    "version on the host)")
    ap.add_argument("--ingress", action="store_true",
                    help="run ONLY the crypto-free ingress decomposition "
                    "(per-tx SendAsset vs distilled broker frames, one "
                    "node) and bank the labeled row into BENCH_E2E.json")
    ap.add_argument("--compose", action="store_true",
                    help="run the composed-pipeline story instead of the "
                    "baseline phases: the verify grid (verify_bench), the "
                    "batched-plane ceiling, and the composed load with the "
                    "card's verifier; per-phase writes to "
                    "BENCH_PIPELINE.json (default under %s)" % OUT_DIR)
    ap.add_argument("--trials", type=int, default=3,
                    help="with --compose: verify_bench trials (default 3)")
    ap.add_argument("--bank-dir", default=OUT_DIR,
                    help="directory of the banked BENCH_E2E.json rows "
                    "(default %(default)s)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.rpc_batch is None:
        args.rpc_batch = 64 if args.compose else 1

    if args.ingress:
        block = asyncio.run(_phase_ingress_decomposition())
        _bank_e2e_row(args.bank_dir, "ingress_decomposition", block)
        print(json.dumps(block, indent=1))
        return 0 if block.get("target_met") else 1

    if args.compose:
        return _compose(args)

    from ._common import host_context

    artifact = {
        "config": "BASELINE-1/3: 4-node net under send-asset load",
        "host_context": host_context(),
        "target_tx_per_sec": 10_000,
        "card": "cpu" if args.skip_cuda else card_stamp(tool_device(args.device)),
    }
    if not args.skip_cpu:
        artifact["cpu_subprocess"] = _phase_cpu_subprocess(
            args.nodes, args.clients, args.tx_per_client, args.rpc_batch,
            args.window,
        )
    if not args.skip_cuda:
        cuda = asyncio.run(
            _phase_cuda_inprocess(
                args.nodes, args.clients, args.tx_per_client, args.rpc_batch,
                device=args.device,
            )
        )
        cuda.pop("ledgers")
        artifact["cuda_inprocess"] = cuda
    out = json.dumps(artifact)
    print(out)
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(out + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

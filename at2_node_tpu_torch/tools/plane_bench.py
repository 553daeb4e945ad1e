"""In-process broadcast-plane microbenchmark (the firehose number).

Counterpart of ``at2_node_tpu/tools/plane_bench.py``, every mode kept.
The nodes verify on ``cuda:0`` (``--verifier cuda``, the default; without
a card the tool raises) unless ``--verifier cpu`` (the host's OpenSSL),
``pool`` or ``plane-only`` says otherwise; ``--smoke-profile`` honors
``--verifier`` too. Rows carry ``card`` (the card's name and power limit,
or ``"cpu"``) where the reference's carried ``tunnel_live_at_write``, and
bank into ``--bank-dir`` (by default the package's git-ignored
``build/bench``), never the repo's root. ``--shards-grid --cores N``
gives the process its earlier CPU affinity back when the grid is done.

Measures what the broadcast plane + verifier path do when batches
actually form, WITHOUT the loadgen/gRPC/subprocess overhead of the full
e2e configs: N Services in one process over real localhost sockets, a
pre-signed burst of payloads submitted straight into node 0's broadcast,
committed-tx/s measured to full commitment on every node.

``--batch N`` groups the pre-signed firehose into TxBatch slots of N
entries (the batched broadcast plane, broadcast/stack.py); ``--batch 0``
(default) drives the per-tx plane.

``--obs off`` disables the lifecycle tracer and the protocol flight
recorder (trace_sample=0, recorder_cap=0) so the observability overhead
can be measured as the delta between two otherwise-identical runs — the
reference's budget is <5% throughput regression with both on.
``--compare-obs`` honors ``--shards``/``--executor``, so the same A/B
prices the cross-process obs shipping lane under ``--executor
process``; each measurement banks as one executor-keyed row in
BENCH_OBS_OVERHEAD.json (``--no-bank`` to skip).

``--shards N`` runs the firehose against the sharded broadcast plane
(broadcast/shards.py); ``--executor thread|process|inline`` picks where
shard work runs (process = one spawn worker per shard over
shared-memory rings, parallel/plane_worker.py — the GIL-free mode);
``--shards-grid 1,2,4`` sweeps the shard axis — optionally pinned to
``--cores N`` CPUs — and banks the scaling grid to
BENCH_PLANE_SHARDS.json (same row conventions as BENCH_AGGREGATE.json,
plus per-row ``executor``, ``host_cores`` and ``captured_at``).

``--compare-drain`` is the drain-fusion proof: phase-accounted runs
fused (at2_plane_drain) vs unfused (AT2_NO_PLANE_DRAIN=1), banking the
owner-loop serial-term share delta as a ``phase_accounting`` row.

Usage:
    python -m at2_node_tpu_torch.tools.plane_bench [--nodes 3] [--txs 300]
        [--verifier cuda] [--batch 0] [--obs on|off] [--shards 1]
        [--executor thread] [--shards-grid 1,2,4] [--cores 0]
        [--compare-drain] [--bank-dir DIR] [--out -]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

from ..broadcast.messages import Payload, TxBatch
from ..crypto.keys import SignKeyPair
from ..node.config import (
    ObservabilityConfig,
    PlaneConfig,
    SloConfig,
    VerifierConfig,
)
from ..obs.profiler import PLANE_LEAF_PHASES
from ..node.service import Service
from ..types import ThinTransaction
from ._common import (
    OUT_DIR,
    card_stamp,
    host_context,
    listen_ports,
    make_net_configs,
    tool_device,
)

_ports = listen_ports()

SHARDS_BANK_PATH = os.path.join(OUT_DIR, "BENCH_PLANE_SHARDS.json")
OBS_BANK_PATH = os.path.join(OUT_DIR, "BENCH_OBS_OVERHEAD.json")


def _bank_path(bank_dir: str | None, default: str) -> str:
    """``default``'s file name under ``bank_dir`` (created), or ``default``."""
    path = default if bank_dir is None else os.path.join(bank_dir, os.path.basename(default))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def _card(verifier: str) -> str:
    """The row's card stamp: the card's for the verifiers that run on it,
    ``"cpu"`` for the host's."""
    if verifier in ("cuda", "pool"):
        return card_stamp(tool_device("cuda", "--verifier cpu"))
    return "cpu"


class _TrustAllVerifier:
    """BENCH-ONLY plane isolation (``--verifier plane-only``): every
    signature reports valid with zero work, modeling a verifier whose
    throughput is not the constraint (what the broadcast plane sees in
    front of the card's verifier). NOT a node config option —
    injected only by this tool, so the unsafe mode cannot be deployed."""

    async def verify(self, public_key, message, signature) -> bool:
        return True

    async def verify_many(self, items):
        # yield once per dispatch like every real verifier does (executor
        # hop / device dispatch): without it the broadcast workers never
        # release the event loop mid-burst and transport tasks starve —
        # a pathology no deployable verifier exhibits
        await asyncio.sleep(0)
        return [True] * len(items)

    async def warmup(self) -> None:
        pass

    async def close(self) -> None:
        pass

    def stats(self) -> dict:
        return {}


async def run(
    nodes: int, txs: int, verifier: str, timeout: float, batch: int = 0,
    obs: bool = True, profile: bool = False, hold_until=None,
    shards: int = 1, executor: str = "thread",
) -> dict:
    """One in-process firehose. ``hold_until``, when given, is a predicate
    over node 0's ``snapshot_stats()``: after the commits the fleet stays
    up until it holds or ``timeout`` (from the first send) is spent."""
    plane_only = verifier == "plane-only"
    cfgs = make_net_configs(
        nodes,
        _ports,
        verifier=VerifierConfig(kind="cpu" if plane_only else verifier),
        plane=PlaneConfig(shards=shards, executor=executor),
        observability=(
            ObservabilityConfig()
            if obs
            # the off arm zeroes EVERY observability seam, the profiler
            # tier included: no lifecycle tracer, no flight recorder, no
            # phase accounting, no lag probe, no /profilez, no audit
            # beacons, no wire-capture ring — so the measured on-arm
            # delta prices the WHOLE tier, fleet audit included
            else ObservabilityConfig(
                trace_sample=0, recorder_cap=0, profilez=False,
                lag_probe_interval=0.0, phase_accounting=False,
                audit_every=0, audit_interval=0.0, capture_cap=0,
            )
        ),
        # the off arm silences the SLO probe loop too: "obs off" means
        # every periodic observability task, not just the tracer
        slo=SloConfig(enabled=obs),
    )
    injected = _TrustAllVerifier() if plane_only else None
    services = []
    try:
        for c in cfgs:  # start INSIDE the try: a mid-start failure must
            services.append(  # close earlier nodes
                await Service.start(c, verifier=injected)
            )
        sender = SignKeyPair.from_hex("77" * 32)
        recipient = SignKeyPair.from_hex("78" * 32).public
        payloads = []
        for seq in range(1, txs + 1):
            tx = ThinTransaction(recipient, 1)
            payloads.append(Payload.create(sender, seq, tx))
        batches = []
        if batch >= 1:  # batch=1 measures the batched plane's fixed cost
            node_key = cfgs[0].sign_key
            for i in range(0, len(payloads), batch):
                raw = b"".join(p.encode()[1:] for p in payloads[i : i + batch])
                batches.append(TxBatch.create(node_key, i + 1, raw))

        if profile and obs:
            # one sampler, node 0's: in deployment each node-process
            # runs one sampler over its own threads; here one sampler
            # walks ALL the in-process nodes' threads, which already
            # costs at least what a single node pays
            services[0].sampler.start()
            # process-mode plane: fan the capture into the shard worker
            # processes too, so the folded output carries shardN/ frames
            wp = services[0]._plane_obs()
            if wp is not None:
                wp.profiler_start()

        # this tool IS the ingress (it bypasses the RPC surface), so it
        # stamps the tracer itself — the latency block below then carries
        # real ingress->commit percentiles for the firehose
        t0 = time.perf_counter()
        for p in payloads:
            services[0].tx_trace.begin((p.sender, p.sequence))
        if batch >= 1:
            for b in batches:
                await services[0].broadcast.broadcast_batch(b)
        else:
            for p in payloads:
                await services[0].broadcast.broadcast(p)
        timed_out = False
        while any(s.committed < txs for s in services):
            await asyncio.sleep(0.02)
            if time.perf_counter() - t0 > timeout:
                timed_out = True
                break
        dt = time.perf_counter() - t0
        # keep the fleet alive past periodic maintenance (slot GC fires
        # every GC_INTERVAL) until the caller's counters have ticked
        while hold_until is not None and not hold_until(services[0].snapshot_stats()):
            if time.perf_counter() - t0 > timeout:
                break
            await asyncio.sleep(0.1)
        prof = None
        if profile and obs:
            services[0].sampler.stop()
            wp = services[0]._plane_obs()
            if wp is not None:
                wp.profiler_stop()
                # a couple of worker flush cycles so the final folded-
                # stack increments land before we read the merge
                await asyncio.sleep(0.3)
            folded = services[0]._merged_folded(wp, None).splitlines()
            prof = {
                "samples": services[0].sampler.stats()["samples"],
                "worker_samples": (
                    wp.worker_fold_samples() if wp is not None else 0
                ),
                "folded_lines": len(folded),
                "worker_folded_frames": sum(
                    1 for ln in folded if ln.startswith("shard")
                ),
                "top_folded": folded[:5],
            }
        committed = [s.committed for s in services]
        stats = services[0].snapshot_stats()
        vstats = {
            k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in sorted(
                (injected or services[0].verifier).stats().items()
            )
        }
        return {
            "config": "in-process firehose (plane microbenchmark)",
            "nodes": nodes,
            "verifier": verifier,
            "card": _card(verifier),
            "batch": batch,
            "shards": shards,
            "executor": "loop" if shards == 1 else executor,
            "obs": obs,
            "profiler": prof,
            "submitted": txs,
            "committed_per_node": committed,
            "seconds": round(dt, 3),
            # a timed-out run's rate is NOT a measurement
            "timed_out": timed_out,
            "committed_tx_per_sec": (
                round(min(committed) / dt, 1) if dt and not timed_out else 0.0
            ),
            "node0_stats": {
                k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in sorted(stats.items())
            },
            # the active verifier's own pipeline counters (occupancy,
            # padding, per-stage ms) — empty for --verifier plane-only
            "verifier_stats": vstats,
            # fleet-audit + wire-capture activity in the measured run:
            # proves the obs-on arm actually paid for beacons/capture
            # rather than idling them (audit_every=256 fires on a 300-tx
            # firehose; the off arm zeroes both)
            "audit": {
                "beacons_tx": stats.get("audit_beacons_tx", 0),
                "beacons_rx": stats.get("audit_beacons_rx", 0),
                "compared": stats.get("audit_compared", 0),
                "diverged": stats.get("audit_diverged", 0),
                "captured_frames": stats.get("mesh_captured", 0),
            },
            # headline latency row: BENCH_* files
            # carry latency, not just throughput
            "latency": {
                "ingress_to_commit_p50_ms": stats.get(
                    "tx_ingress_to_committed_p50_ms", 0.0
                ),
                "ingress_to_commit_p99_ms": stats.get(
                    "tx_ingress_to_committed_p99_ms", 0.0
                ),
                "verifier_queue_wait_p50_ms": vstats.get(
                    "queue_wait_p50_ms", 0.0
                ),
                "verifier_queue_wait_p99_ms": vstats.get(
                    "queue_wait_p99_ms", 0.0
                ),
            },
        }
    finally:
        for s in services:
            await s.close()


def compare_obs(
    nodes: int, txs: int, verifier: str, timeout: float, batch: int,
    repeat: int, budget_pct: float, shards: int = 1,
    executor: str = "thread", bank: bool = True, bank_dir: str | None = None,
) -> dict:
    """The observability-overhead assertion: interleave obs-on / obs-off
    firehose runs (alternation decorrelates thermal/scheduler drift from
    the arm), take each arm's best rate — best-of-N is the standard way
    to read a noisy 1-core host, the fastest run is the least-perturbed
    one — and check the on-arm's regression against the budget.

    With ``--executor process`` the on arm additionally prices the
    cross-process obs shipping lane (worker registry slices + delta
    records over the dedicated obs rings, broadcast/shards.py); the off
    arm's all-zero ObservabilityConfig keeps that lane entirely off, so
    the delta measures the whole tier in BOTH execution modes under the
    same budget."""
    arms: dict = {"on": [], "off": []}
    samples = 0
    worker_samples = 0
    audit_on: dict = {}
    for _ in range(repeat):
        for obs in (True, False):
            # the measured arm carries the FULL observability tier:
            # tracer, recorder, SLO probes, phase accounting, the
            # event-loop lag probe, a live stack sampler, audit
            # beacons, and the inbound wire-capture ring
            res = asyncio.run(
                run(nodes, txs, verifier, timeout, batch, obs=obs,
                    profile=obs, shards=shards, executor=executor)
            )
            if res["timed_out"]:
                raise RuntimeError(
                    f"obs={'on' if obs else 'off'} arm timed out; "
                    "no measurement"
                )
            arms["on" if obs else "off"].append(res["committed_tx_per_sec"])
            if res["profiler"]:
                samples += res["profiler"]["samples"]
                worker_samples += res["profiler"].get("worker_samples", 0)
            if obs:
                for k, v in res["audit"].items():
                    audit_on[k] = audit_on.get(k, 0) + v
    best_on, best_off = max(arms["on"]), max(arms["off"])
    overhead_pct = (
        round(100.0 * (1.0 - best_on / best_off), 2) if best_off else 0.0
    )
    row = {
        "config": "observability overhead (plane firehose, best-of-N)",
        "nodes": nodes,
        "verifier": verifier,
        "batch": batch,
        "shards": shards,
        "executor": "loop" if shards == 1 else executor,
        "submitted": txs,
        "repeat": repeat,
        "rates_on": arms["on"],
        "rates_off": arms["off"],
        "sampler_samples_on": samples,
        # on-arm folded-stack samples shipped FROM shard workers — zero
        # outside process mode, nonzero proves the obs lane was priced
        "worker_samples_on": worker_samples,
        # summed over the on-arm runs: nonzero beacons/captures prove
        # the priced tier actually included the fleet auditor + capture
        "audit_on": audit_on,
        "best_on_tx_per_sec": best_on,
        "best_off_tx_per_sec": best_off,
        "overhead_pct": overhead_pct,
        "budget_pct": budget_pct,
        "ok": overhead_pct <= budget_pct,
        "card": _card(verifier),
    }
    if bank:
        bank_obs_row(row, bank_dir)
    return row


def bank_obs_row(row: dict, bank_dir: str | None = None) -> None:
    """Upsert one compare_obs measurement into BENCH_OBS_OVERHEAD.json.

    The banked doc is ``{"config": ..., "rows": [row, ...]}`` with one
    row per (executor, shards, nodes, batch, submitted) cell — a
    process-mode capture never overwrites the loop-mode one (regress.py
    keys the series by executor too). A legacy single-doc capture is
    migrated in place as a ``"loop"`` row."""
    path = _bank_path(bank_dir, OBS_BANK_PATH)
    doc: dict = {}
    if os.path.exists(path):
        with open(path) as fp:
            doc = json.load(fp)
    if "rows" not in doc:
        rows = [dict(doc, executor=doc.get("executor", "loop"))] if (
            "overhead_pct" in doc
        ) else []
        doc = {
            "config": "observability overhead (plane firehose, "
                      "best-of-N), one row per executor cell",
            "rows": rows,
        }
    key = lambda r: (  # noqa: E731 - local row identity
        r.get("executor", "loop"), r.get("shards", 1), r.get("nodes"),
        r.get("batch"), r.get("submitted"),
    )
    doc["rows"] = [r for r in doc["rows"] if key(r) != key(row)] + [row]
    doc["rows"].sort(key=lambda r: json.dumps(key(r), default=str))
    tmp = path + ".tmp"
    with open(tmp, "w") as fp:
        json.dump(doc, fp, indent=1)
        fp.write("\n")
    os.replace(tmp, path)
    print("banked %s" % path, file=sys.stderr)


# every phase account a batched run can exercise under any verifier:
# the six plane leaves (entry_registry needs --batch >= 1), the
# per-worker plane total, the commit tail, and slot GC (the smoke run
# stays up until a GC pass, every GC_INTERVAL, has ticked it).
# verifier_flush is the CudaBatchVerifier's account and stays zero under
# the cpu verifier.
_SMOKE_PHASES = PLANE_LEAF_PHASES + ("plane_total", "commit_tail", "slot_gc")


def _zero_phases(stats: dict) -> list:
    """The ``_SMOKE_PHASES`` whose counter has not ticked."""
    return [p for p in _SMOKE_PHASES if not stats.get(f"phase_{p}_ns", 0)]


def _shard_zero_phases(stats: dict, shards: int) -> list:
    """The plane leaf phases that ticked in no shard worker."""
    return [
        p for p in PLANE_LEAF_PHASES
        if not any(
            stats.get(f"phase_{p}_shard{k}_ns", 0) for k in range(shards)
        )
    ]


def smoke_profile(
    nodes: int, txs: int, timeout: float, shards: int = 1,
    executor: str = "thread", verifier: str = "cuda",
) -> dict:
    """The profiler smoke: one short batched firehose with
    the sampler live, then assert the capture produced folded stacks and
    every exercisable phase counter actually ticked.

    With ``--shards N --executor process`` the smoke additionally
    asserts the cross-process obs lane end to end: the merged folded
    output must carry ``shardN/``-prefixed worker frames, and every
    plane leaf phase must have ticked inside SOME worker (the firehose
    has one origin key, so one shard carries the traffic — the check is
    any-shard per phase, not every-shard)."""
    proc = shards > 1 and executor == "process"

    def ticked(stats: dict) -> bool:
        return not _zero_phases(stats) and not (
            proc and _shard_zero_phases(stats, shards)
        )

    # the fleet stays up until every counter has ticked (slot GC's after
    # a GC pass, a worker's once its obs records crossed), or the timeout
    res = asyncio.run(
        run(nodes, txs, verifier, timeout, batch=16, obs=True,
            profile=True, hold_until=ticked, shards=shards,
            executor=executor)
    )
    stats = res["node0_stats"]
    zero = _zero_phases(stats)
    prof = res["profiler"] or {}
    worker_frames = prof.get("worker_folded_frames", 0)
    shard_zero = _shard_zero_phases(stats, shards) if proc else []
    ok = (
        bool(prof.get("folded_lines"))
        and not zero
        and not res["timed_out"]
        and (not proc or (worker_frames > 0 and not shard_zero))
    )
    return {
        "config": "profiler smoke (batched firehose, sampler live)",
        "nodes": nodes,
        "verifier": verifier,
        "submitted": txs,
        "shards": shards,
        "executor": res["executor"],
        "timed_out": res["timed_out"],
        "committed_tx_per_sec": res["committed_tx_per_sec"],
        "samples": prof.get("samples", 0),
        "worker_samples": prof.get("worker_samples", 0),
        "folded_lines": prof.get("folded_lines", 0),
        "worker_folded_frames": worker_frames,
        "top_folded": prof.get("top_folded", []),
        "phase_ns": {
            p: stats.get(f"phase_{p}_ns", 0) for p in _SMOKE_PHASES
        },
        "zero_phases": zero,
        "shard_zero_phases": shard_zero,
        "ok": ok,
        "card": _card(verifier),
    }


def _set_cores(cores: int) -> int:
    """Pin this process (and its children: all bench nodes are
    in-process) to the first ``cores`` CPUs, so the shard-scaling axis
    can be swept on a many-core host. Returns the EFFECTIVE core count —
    the honest number banked with each row."""
    if cores <= 0:
        return os.cpu_count() or 1
    try:
        avail = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, set(avail[:cores]))
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        # no affinity API (or denied): record what the host gives us
        return min(cores, os.cpu_count() or 1)


def shards_grid(
    nodes: int, txs: int, verifier: str, timeout: float, batch: int,
    shard_axis: list, cores: int, repeat: int,
    bank: bool = True, executor: str = "thread", bank_dir: str | None = None,
) -> dict:
    """The sharded-plane scaling grid: one firehose per shard count on a
    fixed core budget, best-of-``repeat`` per cell, banked to
    BENCH_PLANE_SHARDS.json under the BENCH_AGGREGATE.json conventions
    (per-row ``captured_at`` + ``card``, plus ``host_cores`` — a 1-core
    row CANNOT show shard speedup and must not be read as a scaling
    regression). The process's CPU affinity is given back afterwards."""
    try:
        affinity = os.sched_getaffinity(0)
    except AttributeError:
        affinity = None
    try:
        return _shards_grid(nodes, txs, verifier, timeout, batch, shard_axis,
                            cores, repeat, bank, executor, bank_dir)
    finally:
        if affinity is not None:
            os.sched_setaffinity(0, affinity)


def _shards_grid(nodes, txs, verifier, timeout, batch, shard_axis, cores,
                 repeat, bank, executor, bank_dir) -> dict:
    host_cores = _set_cores(cores)
    captured_at = time.strftime("%Y-%m-%d", time.gmtime())
    row_labels = {
        "captured_at": captured_at,
        "card": _card(verifier),
        "host_cores": host_cores,
    }

    grid = []
    base_rate = 0.0
    for shards in shard_axis:
        rates = []
        for _ in range(repeat):
            res = asyncio.run(
                run(nodes, txs, verifier, timeout, batch, obs=False,
                    shards=shards, executor=executor)
            )
            if not res["timed_out"]:
                rates.append(res["committed_tx_per_sec"])
        best = max(rates) if rates else 0.0
        if shards == 1:
            base_rate = best
        cell = {
            "shards": shards,
            "executor": "loop" if shards == 1 else executor,
            "batch": batch,
            "verifier": verifier,
            "rates": rates,
            "best_tx_per_sec": best,
            "speedup_vs_1": (
                round(best / base_rate, 2) if base_rate else 0.0
            ),
            **row_labels,
        }
        grid.append(cell)
        print(json.dumps(cell), flush=True)

    peak = max(grid, key=lambda c: c["best_tx_per_sec"])
    summary = {
        "host_cores": host_cores,
        "executor": executor,
        "shard_axis": shard_axis,
        "best_shards": peak["shards"],
        "best_tx_per_sec": peak["best_tx_per_sec"],
        "peak_speedup_vs_1": peak["speedup_vs_1"]
        if peak["shards"] != 1
        else max(c["speedup_vs_1"] for c in grid),
        "target": (
            "plane capacity ~linear in shards up to 4 cores; a 1-core "
            "host shows ~1.0x and only labels the row, it does not "
            "measure scaling"
        ),
        **row_labels,
    }
    print(json.dumps(summary), flush=True)

    if not bank:
        # CI smoke path: measure and report, never rewrite the banked
        # artifact (the tracked grid is a deliberate capture)
        return {"banked": None, "grid": grid, "summary": summary}

    label = "grid_%s_c%d" % (captured_at, host_cores)
    if executor != "thread":
        # executor is part of the machine being measured: a process-mode
        # grid must never overwrite the thread-mode capture of the same
        # day/core budget (regress.py keys rows by executor too)
        label += "_" + executor
    path = _bank_path(bank_dir, SHARDS_BANK_PATH)
    doc = {}
    if os.path.exists(path):
        with open(path) as fp:
            doc = json.load(fp)
    doc.setdefault(
        "config",
        "sharded broadcast plane scaling grid: in-process firehose "
        "tx/s vs shard count at a fixed core budget",
    )
    doc["host_context"] = host_context()
    doc.setdefault("runs", {})[label] = {
        **row_labels,
        "nodes": nodes,
        "submitted": txs,
        "repeat": repeat,
        "grid": grid,
        "summary": summary,
    }
    doc["latest"] = label
    tmp = path + ".tmp"
    with open(tmp, "w") as fp:
        json.dump(doc, fp, indent=1)
        fp.write("\n")
    os.replace(tmp, path)
    print("banked %s run %s" % (path, label), file=sys.stderr)
    return {"banked": label, "grid": grid, "summary": summary}


# the owner-loop serial term the fused native drain attacks: frame
# parse/admission (rx_decode) plus the post-verify quorum/delivery
# bookkeeping that shares the owner's drain cycle. verify_wait and
# echo_apply are excluded — the verifier seam and content inserts are
# not what at2_plane_drain fuses.
_DRAIN_SERIAL_PHASES = ("rx_decode", "quorum_bitmap", "ready_deliver")


def compare_drain(
    nodes: int, txs: int, verifier: str, timeout: float, batch: int,
    shards: int, executor: str, repeat: int, bank: bool = True,
    bank_dir: str | None = None,
) -> dict:
    """The drain-fusion phase-accounting A/B (perf_opt proof row):
    interleave fused runs (at2_plane_drain parses + routes a whole chunk
    in one GIL-released call) against unfused runs (AT2_NO_PLANE_DRAIN=1
    — same native per-frame parse, Python routing), phase accounting on,
    and compare the owner-loop serial term's share of ``plane_total``
    (rx_decode + quorum_bitmap + ready_deliver). The fused arm's share
    must come in lower — that delta IS the measured claim banked to
    BENCH_PLANE_SHARDS.json, not a narrative one."""
    arms: dict = {"fused": [], "unfused": []}
    for _ in range(repeat):
        for arm in ("fused", "unfused"):
            if arm == "unfused":
                os.environ["AT2_NO_PLANE_DRAIN"] = "1"
            try:
                res = asyncio.run(
                    run(nodes, txs, verifier, timeout, batch, obs=True,
                        shards=shards, executor=executor)
                )
            finally:
                os.environ.pop("AT2_NO_PLANE_DRAIN", None)
            if res["timed_out"]:
                continue
            st = res["node0_stats"]
            serial = sum(
                st.get(f"phase_{p}_ns", 0) for p in _DRAIN_SERIAL_PHASES
            )
            total = st.get("phase_plane_total_ns", 0)
            arms[arm].append({
                "tx_per_sec": res["committed_tx_per_sec"],
                "serial_ns": serial,
                "plane_total_ns": total,
                "serial_share": round(serial / total, 4) if total else 0.0,
            })
    if not arms["fused"] or not arms["unfused"]:
        raise RuntimeError("compare-drain: an arm produced no measurement")
    # best-of-N per arm: the least-perturbed run of each (same convention
    # as the obs A/B); the share is read from that run, not averaged
    # across runs with different scheduler luck
    best_f = max(arms["fused"], key=lambda r: r["tx_per_sec"])
    best_u = max(arms["unfused"], key=lambda r: r["tx_per_sec"])
    row = {
        "config": (
            "drain-fusion phase delta: owner-loop serial share of "
            "plane_total, fused (at2_plane_drain) vs unfused "
            "(AT2_NO_PLANE_DRAIN=1)"
        ),
        "nodes": nodes,
        "submitted": txs,
        "batch": batch,
        "shards": shards,
        "executor": executor,
        "verifier": verifier,
        "repeat": repeat,
        "serial_phases": list(_DRAIN_SERIAL_PHASES),
        "fused": best_f,
        "unfused": best_u,
        "serial_share_delta": round(
            best_u["serial_share"] - best_f["serial_share"], 4
        ),
        "serial_share_reduced": (
            best_f["serial_share"] < best_u["serial_share"]
        ),
        "host_cores": os.cpu_count() or 1,
        "captured_at": time.strftime("%Y-%m-%d", time.gmtime()),
        "card": _card(verifier),
    }
    if bank:
        path = _bank_path(bank_dir, SHARDS_BANK_PATH)
        doc = {}
        if os.path.exists(path):
            with open(path) as fp:
                doc = json.load(fp)
        doc.setdefault(
            "config",
            "sharded broadcast plane scaling grid: in-process firehose "
            "tx/s vs shard count at a fixed core budget",
        )
        # keep the doc loadable by regress.py even when the phase row is
        # banked before any scaling grid has run
        doc.setdefault("runs", {})
        doc.setdefault("latest", "")
        label = "drain_%s_c%d_%s" % (
            row["captured_at"], row["host_cores"], executor
        )
        doc.setdefault("phase_accounting", {})[label] = row
        tmp = path + ".tmp"
        with open(tmp, "w") as fp:
            json.dump(doc, fp, indent=1)
            fp.write("\n")
        os.replace(tmp, path)
        print(
            "banked %s phase_accounting %s" % (path, label),
            file=sys.stderr,
        )
        row["banked"] = label
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--txs", type=int, default=300)
    ap.add_argument(
        "--verifier",
        default="cuda",
        choices=("cuda", "cpu", "pool", "plane-only"),
        help="cuda (cuda:0, the default; raises without a card), cpu (the "
             "host's OpenSSL), pool, or plane-only (no verification)",
    )
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--shards", type=int, default=1,
                    help="broadcast-plane shard count for a single run "
                         "(1 = the monolithic production default)")
    ap.add_argument("--executor", default="thread",
                    choices=("inline", "thread", "process"),
                    help="sharded-plane executor (shards > 1): thread "
                         "(one OS thread per shard), process (one spawn "
                         "worker per shard over shared-memory rings), "
                         "or inline (synchronous, the sim mode)")
    ap.add_argument("--compare-drain", action="store_true",
                    help="phase-accounting A/B: fused at2_plane_drain vs "
                         "AT2_NO_PLANE_DRAIN=1, banks the owner-loop "
                         "serial-share delta row to "
                         "BENCH_PLANE_SHARDS.json; nonzero exit unless "
                         "the fused arm's share is lower")
    ap.add_argument("--shards-grid", default="",
                    help="comma axis, e.g. 1,2,4: run the firehose per "
                         "shard count and bank the scaling grid to "
                         "BENCH_PLANE_SHARDS.json")
    ap.add_argument("--cores", type=int, default=0,
                    help="pin the process to N CPUs for the grid (0 = "
                         "all); the EFFECTIVE count is banked per row "
                         "as host_cores")
    ap.add_argument("--grid-repeat", type=int, default=3,
                    help="with --shards-grid: runs per cell, best-of "
                         "(default 3)")
    ap.add_argument("--no-bank", action="store_true",
                    help="with --shards-grid / --compare-obs: measure + "
                         "print only, do not rewrite the banked artifact "
                         "(CI smoke)")
    ap.add_argument("--bank-dir", default=None,
                    help="directory of the banked BENCH_PLANE_SHARDS.json "
                         "/ BENCH_OBS_OVERHEAD.json (default %s)" % OUT_DIR)
    ap.add_argument("--obs", default="on", choices=("on", "off"),
                    help="lifecycle tracer + flight recorder (off: measure "
                         "the plane with zero observability overhead)")
    ap.add_argument("--compare-obs", action="store_true",
                    help="run BOTH obs arms interleaved, best-of---repeat "
                         "each, and exit nonzero when the obs-on regression "
                         "exceeds --budget percent")
    ap.add_argument("--repeat", type=int, default=3,
                    help="with --compare-obs: runs per arm (default 3)")
    ap.add_argument("--budget", type=float, default=5.0,
                    help="with --compare-obs: max tolerated overhead %% "
                         "(default 5)")
    ap.add_argument("--smoke-profile", action="store_true",
                    help="CI profiler smoke: one short batched run with "
                         "the sampler live; nonzero exit unless folded "
                         "stacks came back and every exercisable phase "
                         "counter ticked")
    ap.add_argument("--out", default="-")
    args = ap.parse_args(argv)
    if args.verifier in ("cuda", "pool"):
        tool_device("cuda", "--verifier cpu")
    if args.shards_grid:
        axis = [int(s) for s in args.shards_grid.split(",")]
        result = shards_grid(
            args.nodes, args.txs, args.verifier, args.timeout, args.batch,
            axis, args.cores, args.grid_repeat,
            bank=not args.no_bank, executor=args.executor,
            bank_dir=args.bank_dir,
        )
    elif args.compare_drain:
        result = compare_drain(
            args.nodes, args.txs, args.verifier, args.timeout, args.batch,
            max(args.shards, 2), args.executor, args.grid_repeat,
            bank=not args.no_bank, bank_dir=args.bank_dir,
        )
    elif args.smoke_profile:
        result = smoke_profile(
            args.nodes, args.txs, args.timeout,
            shards=args.shards, executor=args.executor,
            verifier=args.verifier,
        )
    elif args.compare_obs:
        result = compare_obs(
            args.nodes, args.txs, args.verifier, args.timeout, args.batch,
            args.repeat, args.budget, shards=args.shards,
            executor=args.executor, bank=not args.no_bank,
            bank_dir=args.bank_dir,
        )
    else:
        result = asyncio.run(
            run(args.nodes, args.txs, args.verifier, args.timeout,
                args.batch, obs=args.obs == "on", shards=args.shards,
                executor=args.executor)
        )
    blob = json.dumps(result, indent=1)
    if args.out == "-":
        print(blob)
    else:
        with open(args.out, "w") as f:
            f.write(blob)
        print(f"wrote {args.out}", file=sys.stderr)
    if args.smoke_profile and not result["ok"]:
        if result["zero_phases"]:
            why = f"zero phase counters {result['zero_phases']}"
        elif result["shard_zero_phases"]:
            why = (
                "worker-side phase counters never ticked "
                f"{result['shard_zero_phases']}"
            )
        elif not result["folded_lines"]:
            why = "no folded stacks captured"
        else:
            why = "no shardN/ worker frames in the merged folded output"
        print(f"profiler smoke failed: {why}", file=sys.stderr)
        return 1
    if args.compare_drain and not result["serial_share_reduced"]:
        print(
            "drain fusion did not reduce the owner-loop serial share: "
            f"fused {result['fused']['serial_share']} vs unfused "
            f"{result['unfused']['serial_share']}",
            file=sys.stderr,
        )
        return 1
    if args.compare_obs and not result["ok"]:
        print(
            f"observability overhead {result['overhead_pct']}% exceeds "
            f"the {result['budget_pct']}% budget",
            file=sys.stderr,
        )
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

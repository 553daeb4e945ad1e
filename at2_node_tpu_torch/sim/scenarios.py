"""WAN scenario grid: geo topologies × workload shapes × fault mixes,
each cell measured against its service-level objectives.

Counterpart of ``at2_node_tpu/sim/scenarios.py``.

Where campaign.py searches for *safety* violations under adversarial
schedules, this module measures *service quality* under realistic
conditions: regional WAN latency matrices on the simulated fabric,
flash-crowd and hot-account traffic shapes, and mid-run partitions.
Every cell runs the REAL node stack on the deterministic simulator —
``(seed, cell parameters)`` fully determine the wire trace, so a banked
cell's ``trace_hash`` is an exact replay receipt, not a ballpark.

A cell's measures come from the same observability surfaces operators
use live: per-tx commit latency from the stitched ``/tracez`` timelines
(tools/trace_collect.stitch), commit counts from the ledger, rejection
counts from admission stats. The SLO verdict reuses the burn-rate
engine's offline entry point (obs/slo.evaluate_point), so a cell
breaching in the grid means exactly what ``/sloz`` breaching means on a
live node.

Driven by tools/scenario_grid.py; scripts/ci.sh runs the 2×2 smoke
slice and replays one cell to assert the hash reproduces.
"""

from __future__ import annotations

import asyncio
import hashlib
import random
import time
from typing import Dict, List, Optional

from ..obs.slo import default_objectives, evaluate_point
from .campaign import Event, apply_events
from .fabric import LinkModel
from .net import SimNet, sim_client

# -- grid axes -------------------------------------------------------------

TOPOLOGIES = ("lan", "wan3")
WORKLOADS = ("steady", "flash_crowd", "hot_account")
FAULT_MIXES = ("none", "cut")

#: the full (topology × workload × faults) matrix
GRID = [
    (t, w, fx) for t in TOPOLOGIES for w in WORKLOADS for fx in FAULT_MIXES
]
#: every wan3 cell re-run with the [wan] finality knobs on (overlapped
#: quorum phases + region-aware fanout + verify-ahead). A fourth "wan"
#: coordinate keeps the default cells' derived seeds untouched and
#: shows up as a "+wan" suffix in cell names; the knobs reorder fabric
#: sends, so these cells hash differently from their defaults by design.
WAN_GRID = [
    ("wan3", w, fx, "wan") for w in WORKLOADS for fx in FAULT_MIXES
]
GRID = GRID + WAN_GRID
#: the CI smoke slice: LAN/WAN × steady/flash-crowd, no faults
SMOKE = [
    (t, w, "none") for t in TOPOLOGIES for w in ("steady", "flash_crowd")
]

# one-way inter-region latencies (seconds) for the 3-region WAN profile:
# a near pair (same continent), a transatlantic pair, and a long-haul
# pair — the 80–250 ms band real geo-replicated deployments live in
_INTER_REGION = {
    frozenset((0, 1)): 0.080,
    frozenset((0, 2)): 0.140,
    frozenset((1, 2)): 0.250,
}
_INTRA = LinkModel(latency=0.002, jitter=0.001)


def _seed_int(*parts) -> int:
    h = hashlib.sha256("\x1f".join(str(p) for p in parts).encode())
    return int.from_bytes(h.digest()[:8], "big")


def apply_topology(net: SimNet, topology: str) -> None:
    """Install the geo profile's per-link models on the net's fabric.
    ``lan`` keeps the uniform default; ``wan3`` pins node i to region
    i % 3 and gives every directed inter-region link its pair's one-way
    latency with 10% jitter (jitter is what makes equal-latency links
    reorder, so it stays proportional to the haul)."""
    if topology == "lan":
        return
    if topology != "wan3":
        raise ValueError(f"unknown topology {topology!r}")
    signs = [cfg.sign_key.public for cfg in net.configs]
    for i, a in enumerate(signs):
        for j, b in enumerate(signs):
            if i == j:
                continue
            ra, rb = i % 3, j % 3
            if ra == rb:
                model = _INTRA
            else:
                lat = _INTER_REGION[frozenset((ra, rb))]
                model = LinkModel(latency=lat, jitter=lat * 0.1)
            net.fabric.set_link(a, b, model)


# -- workload generators ---------------------------------------------------


def _finish_txs(
    rng: random.Random, raw: List[tuple], n_clients: int
) -> List[Event]:
    """Turn (t, node, client) triples into ``tx`` events: sort by time,
    then assign each sender's sequences in arrival order — a sender's
    seqs are time-ordered, so nothing parks at the sequence gate longer
    than its own pipeline depth."""
    raw = sorted(
        (round(t, 3), node, client) for t, node, client in raw
    )
    next_seq = [1] * n_clients
    events: List[Event] = []
    for t, node, client in raw:
        to = rng.randrange(n_clients)
        events.append(
            [
                t,
                "tx",
                {
                    "node": node,
                    "client": client,
                    "seq": next_seq[client],
                    "to": to,
                    "amount": rng.randint(1, 20),
                },
            ]
        )
        next_seq[client] += 1
    return events


def steady_workload(
    rng: random.Random, *, nodes: int, n_clients: int, n_tx: int,
    duration: float,
) -> List[Event]:
    """Evenly paced traffic: senders round-robin, arrival times jittered
    around a uniform schedule — the baseline every other shape is
    measured against."""
    step = duration / max(1, n_tx)
    raw = [
        (
            min(duration, max(0.0, i * step + rng.uniform(0, step * 0.5))),
            rng.randrange(nodes),
            i % n_clients,
        )
        for i in range(n_tx)
    ]
    return _finish_txs(rng, raw, n_clients)


def flash_crowd_workload(
    rng: random.Random, *, nodes: int, n_clients: int, n_tx: int,
    duration: float, crowd: Optional[int] = None,
) -> List[Event]:
    """A burst riding on baseline traffic: half the volume arrives in a
    window one-tenth of the run (a ~10× instantaneous rate spike) —
    the viral-moment shape that exposes queueing and quorum-stall
    behavior a steady offered rate never does.

    ``crowd`` splits the sender population the way real flash crowds
    look: the LAST ``crowd`` client indices originate only the burst
    (newcomers, ~1 tx each at crowd ≈ n_tx//2) while the first
    ``n_clients - crowd`` carry the baseline — the shape the overload
    cells shed against. The split changes only which client index each
    triple carries, never the rng draw sequence, so ``crowd=None``
    (the grid default) is byte-identical to the historical generator at
    any client count (the scaled 10k–100k populations included)."""
    n_burst = n_tx // 2
    n_base = n_tx - n_burst
    burst_at = duration * 0.45
    burst_len = duration * 0.10
    base_pool = n_clients if crowd is None else max(1, n_clients - crowd)
    raw = [
        (rng.uniform(0.0, duration), rng.randrange(nodes), i % base_pool)
        for i in range(n_base)
    ]
    raw += [
        (
            burst_at + rng.uniform(0.0, burst_len),
            rng.randrange(nodes),
            i % n_clients if crowd is None else base_pool + (i % crowd),
        )
        for i in range(n_burst)
    ]
    return _finish_txs(rng, raw, n_clients)


def hot_account_workload(
    rng: random.Random, *, nodes: int, n_clients: int, n_tx: int,
    duration: float,
) -> List[Event]:
    """Skewed senders: client 0 originates ~40% of all traffic. Because
    a sender's transfers serialize through its sequence gate, the hot
    account's tail latency grows with its pipeline depth while everyone
    else stays cheap — the fairness index and the p99/p50 gap are the
    signals this shape exists to produce. Scales to any population
    (the overload cells run it at thousands of clients): the hot share
    stays ~40% regardless of ``n_clients``, so skew does not dilute as
    the population grows."""
    raw = []
    for i in range(n_tx):
        client = 0 if rng.random() < 0.4 else 1 + rng.randrange(n_clients - 1)
        raw.append((rng.uniform(0.0, duration), rng.randrange(nodes), client))
    return _finish_txs(rng, raw, n_clients)


_WORKLOAD_FNS = {
    "steady": steady_workload,
    "flash_crowd": flash_crowd_workload,
    "hot_account": hot_account_workload,
}


def fault_events(
    faults: str, *, duration: float
) -> List[Event]:
    """The cell's fault mix. ``cut`` partitions nodes 0↔1 for 3 virtual
    seconds mid-run — f=1 keeps commits flowing through the remaining
    quorum, and totality after heal is part of what the invariant check
    asserts."""
    if faults == "none":
        return []
    if faults == "cut":
        return [
            [round(duration * 0.35, 3), "cut",
             {"a": 0, "b": 1, "duration": 3.0}]
        ]
    raise ValueError(f"unknown fault mix {faults!r}")


# -- SLO targets per cell --------------------------------------------------

# ingress→fleet-commit p99 ceilings (ms). WAN rounds cost 2–3 long-haul
# RTTs; hot-account tails additionally stack the hot sender's pipeline
# depth on top of the per-commit round trip. wan3/steady is the
# sub-second WAN-finality bar: with phase overlap the worst commit
# chain is gossip + one long-haul attestation round (~2×250 ms + tail),
# and the measured default-path p99 already clears it with margin.
_LATENCY_P99_MS = {
    ("lan", "steady"): 250.0,
    ("lan", "flash_crowd"): 500.0,
    ("lan", "hot_account"): 1000.0,
    ("wan3", "steady"): 1000.0,
    ("wan3", "flash_crowd"): 2500.0,
    ("wan3", "hot_account"): 5000.0,
}


def cell_objectives(topology: str, workload: str):
    """The cell's declarative objectives — same Objective/evaluate_point
    machinery a live node serves on /sloz, targets scaled to the cell's
    physics (a WAN hot-account cell is *supposed* to be slow; it is not
    supposed to reject or stall)."""
    return default_objectives(
        latency_p99_ms=_LATENCY_P99_MS[(topology, workload)],
        throughput_floor_tps=0.2,
        rejection_ratio_max=0.02,
        stall_budget=0.25,
    )


def jain_index(xs: List[float]) -> float:
    """Jain's fairness index over per-sender commit counts: 1.0 = all
    senders progressed equally, 1/n = one sender got everything."""
    total = sum(xs)
    if not xs or total <= 0:
        return 1.0
    return (total * total) / (len(xs) * sum(x * x for x in xs))


# -- the cell runner -------------------------------------------------------


def run_cell(
    seed: int,
    topology: str = "lan",
    workload: str = "steady",
    faults: str = "none",
    *,
    nodes: int = 4,
    f: int = 1,
    n_clients: int = 6,
    n_tx: int = 48,
    duration: float = 12.0,
    settle_horizon: float = 150.0,
    capture_trace: bool = False,
    wan: bool = False,
    plane_shards: int = 1,
    overload=None,
) -> dict:
    """One grid cell: fresh SimNet with the topology's link matrix, the
    workload's schedule plus the fault mix, run + settle, then measure
    throughput / latency / fairness from the fleet's own observability
    surfaces and evaluate the cell's SLOs. Pure in ``(seed, params)``.

    ``wan`` turns on the [wan] finality knobs on every node (overlapped
    quorum phases, region-aware fanout, verify-ahead) — the overlap
    levers the WAN_GRID cells exist to measure. ``capture_trace``
    attaches the full stitched timeline (big; the grid tool keeps it
    off for banked cells and on for --inspect). ``overload`` installs
    an [overload] table (node/config.OverloadConfig) on every node; a
    default (disabled) instance leaves the wire trace byte-identical to
    ``overload=None`` — the off-identity the overload CI gate asserts."""
    from ..tools.trace_collect import _pctl, stitch  # lazy: tools→sim
    # is the import direction elsewhere; avoid the cycle

    wall0 = time.monotonic()
    rng = random.Random(_seed_int("cell", seed, topology, workload, faults))
    overrides: dict = {"plane_shards": plane_shards}
    if wan:
        from ..node.config import WanConfig

        overrides["wan"] = WanConfig(
            overlap_ready=True, region_fanout=True, verify_ahead=True
        )
    if overload is not None:
        overrides["overload"] = overload
    net = SimNet(nodes, f, seed, hostile=0, link=_INTRA, **overrides)
    apply_topology(net, topology)
    net.start()
    try:
        clients = [sim_client(seed, i) for i in range(n_clients)]
        events = _WORKLOAD_FNS[workload](
            rng, nodes=nodes, n_clients=n_clients, n_tx=n_tx,
            duration=duration,
        )
        offered_by_client = [0] * n_clients
        for _t, _k, args in events:
            offered_by_client[args["client"]] += 1
        events = events + fault_events(faults, duration=duration)
        events.sort(key=lambda e: (e[0], e[1]))
        apply_events(net, events, clients, None)
        last_t = max((e[0] for e in events), default=0.0)
        net.run_for(last_t + 1.0)
        net.fabric.heal_all()
        settle_t = net.settle(horizon=settle_horizon)
        violations = net.check_invariants()

        offered = sum(offered_by_client)
        committed = min(s.committed for s in net.services)
        rejected = sum(
            s.admission_stats["rejected_at_ingress"] for s in net.services
        )
        # throughput over the ACTIVE window: injection plus settle time
        # minus the trailing stability windows settle() spends proving
        # quiescence (stable=4 × window=5.0 defaults) — idle tail is
        # proof work, not service time
        active_s = last_t + 1.0 + max(0.0, settle_t - 20.0)
        throughput = committed / active_s if active_s > 0 else 0.0

        stitched = stitch([s.tracez() for s in net.services])
        lats = []
        for tx in stitched["txs"]:
            if tx["terminal"] != "committed":
                continue
            commit_rels = [
                rel
                for span in tx["spans"]
                for s, rel in span["stages"]
                if s == "committed"
            ]
            if commit_rels:
                lats.append(max(commit_rels))
        lats.sort()
        lat_p50 = round(1e3 * _pctl(lats, 0.50), 3)
        lat_p90 = round(1e3 * _pctl(lats, 0.90), 3)
        lat_p99 = round(1e3 * _pctl(lats, 0.99), 3)

        frontier = net.services[0].accounts.frontier_nowait()
        commit_counts = [
            float(frontier.get(clients[c].public, 0))
            for c in range(n_clients)
            if offered_by_client[c] > 0
        ]
        fairness = round(jain_index(commit_counts), 6)
        rejection_ratio = round(rejected / offered, 6) if offered else 0.0
        stall_fraction = (
            1.0 if (settle_t >= settle_horizon or committed < offered)
            else 0.0
        )

        slo = evaluate_point(
            cell_objectives(topology, workload),
            {
                "throughput_tps": throughput,
                "latency_p99_ms": lat_p99,
                "rejection_ratio": rejection_ratio,
                "stall_fraction": stall_fraction,
            },
        )
        cell = {
            "topology": topology,
            "workload": workload,
            "faults": faults,
            "wan": bool(wan),
            "seed": seed,
            "nodes": nodes,
            "f": f,
            "offered": offered,
            "committed": committed,
            "rejected": rejected,
            "throughput_tps": round(throughput, 3),
            "latency_p50_ms": lat_p50,
            "latency_p90_ms": lat_p90,
            "latency_p99_ms": lat_p99,
            "fairness": fairness,
            "rejection_ratio": rejection_ratio,
            "stall_fraction": stall_fraction,
            "virtual_time": round(last_t + 1.0 + settle_t, 3),
            "wall_seconds": round(time.monotonic() - wall0, 3),
            "trace_hash": net.fabric.trace_hash(),
            "violations": violations,
            "slo": slo,
            "ok": bool(not violations and slo["ok"]),
        }
        if capture_trace:
            cell["stitched"] = stitched
        return cell
    finally:
        net.close()


def run_grid(
    seed: int,
    cells: Optional[List[tuple]] = None,
    *,
    nodes: int = 4,
    f: int = 1,
    n_clients: int = 6,
    n_tx: int = 48,
    duration: float = 12.0,
    progress=None,
) -> dict:
    """Run every (topology, workload, faults) cell — the full GRID by
    default — and fold the per-cell trace hashes into one grid hash,
    the determinism fingerprint CI compares across same-seed runs. The
    per-cell seed derives from the grid seed + the cell's coordinates,
    so any single cell replays standalone via :func:`run_cell`."""
    cells = list(GRID if cells is None else cells)
    results: List[dict] = []
    for coords in cells:
        # 3-tuples are default-path cells; a 4th "wan" coordinate turns
        # the [wan] knobs on AND feeds the seed derivation, so adding
        # WAN cells leaves every default cell's seed (and hash) intact
        topology, workload, faults = coords[:3]
        wan = len(coords) > 3 and coords[3] == "wan"
        seed_parts = ("grid", seed, topology, workload, faults) + (
            ("wan",) if wan else ()
        )
        cell_seed = _seed_int(*seed_parts) % (1 << 32)
        cell = run_cell(
            cell_seed, topology, workload, faults,
            nodes=nodes, f=f, n_clients=n_clients, n_tx=n_tx,
            duration=duration, wan=wan,
        )
        results.append(cell)
        if progress is not None:
            progress(cell)
    h = hashlib.sha256()
    for cell in results:
        h.update(cell["trace_hash"].encode())
    return {
        "grid_seed": seed,
        "nodes": nodes,
        "f": f,
        "n_clients": n_clients,
        "n_tx": n_tx,
        "duration": duration,
        "cells": results,
        "grid_hash": h.hexdigest(),
        "breaching": [
            f"{c['topology']}/{c['workload']}/{c['faults']}"
            + ("+wan" if c.get("wan") else "")
            for c in results
            if not c["ok"]
        ],
    }


# -- overload A/B cells ----------------------------------------------------
#
# The default grid has no load→latency coupling: the sim charges virtual
# time for link latency and batching windows but verification is
# instantaneous, so a 10× flash crowd cannot build the queue the
# [overload] controller exists to sense. The overload cells close that
# gap with a capacity model on the fleet's SHARED verifier (the device-pool
# semantics the real deployment has): every verify_many call FIFO-queues
# behind one modeled device and charges n/sigs_per_sec of virtual time.
# Admission sheds happen before preverify, so shed work consumes zero
# modeled capacity — exactly the feedback loop being measured.


class ModeledVerifier:
    """Sim-only finite-capacity wrapper around the net's shared verifier.

    FIFO service through one asyncio.Lock (lock wakeups are FIFO and the
    sim scheduler is deterministic, so arrival order fully determines
    service order); each ``verify_many`` charges ``n / sigs_per_sec``
    virtual seconds. Exposes the surfaces the OverloadController samples:
    ``stats()["queue_depth"]`` (signatures waiting or in service) and
    ``stage_histograms()["queue_wait"]`` (cumulative per-call wait, the
    count/sum_ms pair the sojourn signal differences). Everything else
    delegates to the wrapped verifier — verdicts stay real."""

    def __init__(self, inner, clock, sigs_per_sec: float) -> None:
        self._inner = inner
        self._clock = clock
        self._rate = float(sigs_per_sec)
        self._lock = asyncio.Lock()
        self._depth = 0
        self._qw_count = 0
        self._qw_sum_ms = 0.0
        self.total_sigs = 0

    async def verify_many(self, items):
        n = len(items)
        self._depth += n
        self.total_sigs += n
        t0 = self._clock.monotonic()
        async with self._lock:
            self._qw_count += 1
            self._qw_sum_ms += (self._clock.monotonic() - t0) * 1e3
            await self._clock.sleep(n / self._rate)
            self._depth -= n
        return await self._inner.verify_many(items)

    def stats(self) -> dict:
        fn = getattr(self._inner, "stats", None)
        base = dict(fn()) if callable(fn) else {}
        base["queue_depth"] = self._depth
        base["modeled_sigs_per_sec"] = self._rate
        base["modeled_total_sigs"] = self.total_sigs
        return base

    def stage_histograms(self) -> dict:
        return {
            "queue_wait": {
                "count": self._qw_count,
                "sum_ms": round(self._qw_sum_ms, 3),
            }
        }

    def __getattr__(self, name):
        return getattr(self._inner, name)


def overload_objectives(capacity_sigs_per_sec: float):
    """Tuned [overload] knobs for the A/B cells' controlled arm: the
    queue target is half a second of modeled capacity (queueing beyond
    that is latency the SLO can see), sampling is tightened so the
    controller reacts within a burst's first tenth, and the smoothing
    is raised to track a spike that lasts ~1 virtual second."""
    from ..node.config import OverloadConfig

    return OverloadConfig(
        enabled=True,
        sample_interval=0.1,
        smoothing=0.5,
        queue_target=max(8, int(capacity_sigs_per_sec * 0.1)),
        sojourn_target_ms=250.0,
        sojourn_arm_s=0.3,
        shed_start=0.5,
        shed_full=0.9,
        registered_grace=0.3,
        # crowd hold-offs long enough to smear a burst's retry waves
        # over the drain's headroom; registered sheds ignore the max
        # and come back at the base (see retry_after_ms in overload.py)
        retry_after_ms=250,
        retry_after_max_ms=3000,
    )


#: measured fleet-wide verification cost of one committed transfer on a
#: 4-node net (admission preverify + every node's echo/ready attestation
#: checks) — used only to size the modeled pool relative to offered load
_OVERLOAD_SIGS_PER_TX = 33.0

#: per-workload A/B tuning: the modeled pool as a fraction of the cell's
#: average offered signature rate (<1 ⇒ the cell is overcommitted and
#: the uncontrolled arm MUST queue), and the steady-tier latency SLO.
#: hot_account runs its steady tier near saturation by design, so its
#: SLO is laxer — same reasoning as the grid's per-workload ceilings.
_OVERLOAD_WORKLOADS = {
    "flash_crowd": {"capacity_frac": 0.90, "latency_slo_ms": 2500.0},
    "hot_account": {"capacity_frac": 0.68, "latency_slo_ms": 4500.0},
}


def run_overload_cell(
    seed: int,
    workload: str = "flash_crowd",
    *,
    controlled: bool,
    nodes: int = 4,
    f: int = 1,
    n_clients: int = 60,
    crowd: int = 40,
    n_tx: int = 80,
    duration: float = 12.0,
    capacity_sigs_per_sec: float = 200.0,
    settle_horizon: float = 300.0,
    latency_slo_ms: float = 2500.0,
    fairness_floor: float = 0.8,
    retry_budget: int = 4,
    overload=None,
) -> dict:
    """One overload A/B arm: scaled workload against a finite modeled
    verifier, measured on the STEADY tier (the clients the fleet knew
    before the event — registered into the directory pre-burst). Both
    arms run the identical offered schedule (same derived rng, same sim
    seed); only the [overload] table differs, so any delta is the
    controller's doing. ``controlled=False`` runs with the table off —
    the collapse baseline the bench banks alongside the controlled arm.

    Every client retries RESOURCE_EXHAUSTED sheds up to
    ``retry_budget`` times with deterministic jittered exponential
    backoff honoring the server's ``retry_after_ms`` hint — the sim
    analog of client.py's RetryPolicy, so a shed is pacing, not loss.
    Latency is CLIENT-perceived: from the tx's originally offered time
    to its last node's commit, retry hold-offs included.

    For ``flash_crowd`` the crowd is the last ``crowd`` client indices
    (never registered, ~1 tx each); for ``hot_account`` the hot sender
    (client 0) plays the newcomer and everyone else is steady."""
    import grpc

    from ..node.config import ObservabilityConfig
    from ..node.overload import parse_retry_after_ms
    from ..tools.trace_collect import _pctl

    wall0 = time.monotonic()
    # one schedule for BOTH arms: the arm must not feed the derivation
    rng = random.Random(
        _seed_int("overload", seed, workload, n_clients, crowd, n_tx)
    )
    if workload == "flash_crowd":
        steady_ids = list(range(max(1, n_clients - crowd)))
    elif workload == "hot_account":
        steady_ids = list(range(1, n_clients))
    else:
        raise ValueError(f"no overload variant for workload {workload!r}")

    cap = max(4096, 4 * n_tx)
    overrides: dict = {
        "observability": ObservabilityConfig(
            trace_cap=cap, trace_done_cap=cap, recorder_cap=cap
        )
    }
    if controlled:
        ov = overload or overload_objectives(capacity_sigs_per_sec)
        overrides["overload"] = ov
    net = SimNet(nodes, f, seed, hostile=0, link=_INTRA, **overrides)
    net.verifier = ModeledVerifier(
        net.verifier, net.clock, capacity_sigs_per_sec
    )
    net.start()
    try:
        clients = [sim_client(seed, i) for i in range(n_clients)]

        async def _register_steady():
            for i in steady_ids:
                await net.aregister(i % nodes, clients[i].public)

        net.loop.run_until_complete(_register_steady())
        net.run_for(2.0)  # let DirectoryAnnounce gossip reach every node

        if workload == "flash_crowd":
            events = flash_crowd_workload(
                rng, nodes=nodes, n_clients=n_clients, n_tx=n_tx,
                duration=duration, crowd=crowd,
            )
        else:
            events = hot_account_workload(
                rng, nodes=nodes, n_clients=n_clients, n_tx=n_tx,
                duration=duration,
            )
        offered_by_client = [0] * n_clients
        for _t, _k, args in events:
            offered_by_client[args["client"]] += 1

        # submission loop with the client-side retry budget: shed
        # responses are retried after the server's hint, scaled by a
        # hash-derived deterministic jitter (no rng draws — draw order
        # under concurrent tasks would couple the schedule to scheduler
        # internals) and an exponential per-attempt factor. Anything
        # other than RESOURCE_EXHAUSTED is terminal.
        t_base = net.clock.monotonic()
        offered_mono: Dict[tuple, float] = {}

        async def _one(ev) -> None:
            t, _kind, a = ev
            ci, seq = a["client"], a["seq"]
            offered_mono[(clients[ci].public.hex(), seq)] = t_base + t
            await net.clock.sleep(
                max(0.0, t_base + t - net.clock.monotonic())
            )
            to = clients[a["to"]].public
            for attempt in range(retry_budget + 1):
                err = await net.asubmit(
                    a["node"], clients[ci], seq, to, a["amount"]
                )
                if err is None:
                    return
                if err.code != grpc.StatusCode.RESOURCE_EXHAUSTED:
                    return
                if attempt >= retry_budget:
                    return
                hint = parse_retry_after_ms(err.details)
                base_s = (hint if hint is not None else 250) / 1e3
                jitter = (
                    (ci * 2654435761 + seq * 40503 + attempt * 97) % 1024
                ) / 1024.0
                await net.clock.sleep(
                    min(8.0, base_s * (2.0 ** attempt) * (0.5 + jitter))
                )

        async def _drive() -> None:
            await asyncio.gather(*(
                asyncio.ensure_future(_one(ev)) for ev in events
            ))

        net.loop.run_until_complete(_drive())
        last_t = max((e[0] for e in events), default=0.0)
        settle_t = net.settle(horizon=settle_horizon)
        violations = net.check_invariants()

        # client-perceived commit latency: offered time -> the LAST
        # node's committed stamp (fleet commit), straight from the
        # per-node trace rings — retry hold-offs included, which the
        # stitched per-attempt view would hide
        commit_mono: Dict[tuple, float] = {}
        for s in net.services:
            dump = s.tracez()
            for rec in list(dump.get("completed", ())) + list(
                dump.get("live", ())
            ):
                for st, m, _w in rec["stages"]:
                    if st == "committed":
                        k = (rec["sender"], rec["seq"])
                        commit_mono[k] = max(commit_mono.get(k, 0.0), m)
        steady_pubs = {clients[i].public.hex() for i in steady_ids}
        steady_lats: List[float] = []
        all_lats: List[float] = []
        for k, m in commit_mono.items():
            t0 = offered_mono.get(k)
            if t0 is None:
                continue
            lat = m - t0
            all_lats.append(lat)
            if k[0] in steady_pubs:
                steady_lats.append(lat)
        steady_lats.sort()
        all_lats.sort()

        frontier = net.services[0].accounts.frontier_nowait()
        ratios = [
            float(frontier.get(clients[i].public, 0)) / offered_by_client[i]
            for i in steady_ids
            if offered_by_client[i] > 0
        ]
        fairness = round(jain_index(ratios), 6)
        shed = sum(
            s.overload_stats["overload_shed_entries"]
            + s.overload_stats["overload_shed_distilled"]
            for s in net.services
        )
        shed_events = sum(
            1
            for s in net.services
            for ev in s.recorder.dump()["events"]
            if ev[1] in ("overload_shed", "overload_shed_distilled")
        )
        steady_p99 = round(1e3 * _pctl(steady_lats, 0.99), 3)
        slo_ok = bool(steady_lats) and steady_p99 <= latency_slo_ms
        fairness_ok = fairness >= fairness_floor
        return {
            "workload": workload,
            "arm": "controlled" if controlled else "uncontrolled",
            "seed": seed,
            "nodes": nodes,
            "f": f,
            "n_clients": n_clients,
            "crowd": crowd if workload == "flash_crowd" else 1,
            "capacity_sigs_per_sec": capacity_sigs_per_sec,
            "modeled_sigs": net.verifier.total_sigs,
            "offered": sum(offered_by_client),
            "offered_steady": sum(offered_by_client[i] for i in steady_ids),
            "committed": min(s.committed for s in net.services),
            "committed_steady": len(steady_lats),
            "shed": shed,
            "shed_events": shed_events,
            "steady_p50_ms": round(1e3 * _pctl(steady_lats, 0.50), 3),
            "steady_p99_ms": steady_p99,
            "all_p99_ms": round(1e3 * _pctl(all_lats, 0.99), 3),
            "fairness": fairness,
            "latency_slo_ms": latency_slo_ms,
            "fairness_floor": fairness_floor,
            "slo_ok": slo_ok,
            "fairness_ok": fairness_ok,
            "virtual_time": round(last_t + 1.0 + 2.0 + settle_t, 3),
            "wall_seconds": round(time.monotonic() - wall0, 3),
            "trace_hash": net.fabric.trace_hash(),
            "violations": violations,
        }
    finally:
        net.close()


def run_overload_ab(
    seed: int,
    *,
    workloads=("flash_crowd", "hot_account"),
    n_clients: int = 120,
    crowd: int = 80,
    n_tx: int = 160,
    duration: float = 12.0,
    progress=None,
    **cell_kw,
) -> dict:
    """The BENCH_OVERLOAD.json document: each workload run uncontrolled
    then controlled against the same schedule, folded into one A/B hash
    (the determinism fingerprint the overload CI gate compares across
    same-seed runs). The bench's claim is the pair: the uncontrolled
    arm must breach the steady-tier latency SLO and the controlled arm
    must hold it while keeping fairness above the floor. The modeled
    pool is sized per workload relative to the cell's offered load
    (_OVERLOAD_WORKLOADS), so the A/B dynamics are scale-invariant —
    growing ``n_clients``/``n_tx`` grows the capacity with them."""
    offered_sig_rate = _OVERLOAD_SIGS_PER_TX * n_tx / duration
    cells: List[dict] = []
    for w in workloads:
        tune = _OVERLOAD_WORKLOADS[w]
        for controlled in (False, True):
            cell = run_overload_cell(
                seed, w, controlled=controlled,
                n_clients=n_clients, crowd=crowd, n_tx=n_tx,
                duration=duration,
                capacity_sigs_per_sec=round(
                    tune["capacity_frac"] * offered_sig_rate, 3
                ),
                latency_slo_ms=tune["latency_slo_ms"],
                **cell_kw,
            )
            cells.append(cell)
            if progress is not None:
                progress(cell)
    h = hashlib.sha256()
    for cell in cells:
        h.update(cell["trace_hash"].encode())
    ok = all(
        (c["slo_ok"] and c["fairness_ok"])
        if c["arm"] == "controlled"
        else not c["slo_ok"]
        for c in cells
    ) and not any(c["violations"] for c in cells)
    return {
        "bench": "overload_ab",
        "seed": seed,
        "cells": cells,
        "ab_hash": h.hexdigest(),
        "ok": bool(ok),
    }


__all__ = [
    "FAULT_MIXES",
    "GRID",
    "SMOKE",
    "TOPOLOGIES",
    "WAN_GRID",
    "WORKLOADS",
    "ModeledVerifier",
    "apply_topology",
    "cell_objectives",
    "fault_events",
    "jain_index",
    "overload_objectives",
    "run_cell",
    "run_grid",
    "run_overload_ab",
    "run_overload_cell",
]

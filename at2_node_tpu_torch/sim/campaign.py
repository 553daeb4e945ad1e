"""Seeded schedule search: episode generation, campaign running, exact
replay, and greedy trace minimization.

Counterpart of ``at2_node_tpu/sim/campaign.py``.

An *episode* is an explicit timed event list — client transactions,
equivocating submissions, hostile frame salvos, partitions, and
kind-selective drop windows — applied to a fresh :class:`SimNet` and
run to quiescence, after which the AT2 invariants are checked. The
event list is plain JSON data: given the same ``(seed, config,
events)`` the episode replays bit-identically (same wire trace hash),
which is what makes a banked failing schedule a *reproducer*, not an
anecdote.

Minimization shrinks a failing schedule the way trace-based fuzzers
do: first the shortest failing prefix (bisection), then greedy
single-event removal to a fixpoint. The survivor is the minimal
schedule the invariant checker still rejects.
"""

from __future__ import annotations

import hashlib
import random
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..crypto.keys import verify_one
from ..proto import distill
from ..types import transfer_signing_bytes
from .fabric import LinkModel
from .hostile import (
    CertAdversary,
    HostileFrameGen,
    SaltingClientGen,
    mutate_distilled_frame,
)
from .net import SimNet, sim_client

# An event is [t, kind, args-dict] — JSON-shaped on purpose (banked by
# tools/sim_run.py, replayed byte-identically from the file).
Event = list

# frame kinds a drop window can select on (messages.py)
_DROPPABLE_KINDS = (1, 2, 3, 9, 10, 11)


def _seed_int(*parts) -> int:
    h = hashlib.sha256("\x1f".join(str(p) for p in parts).encode())
    return int.from_bytes(h.digest()[:8], "big")


def generate_events(
    rng: random.Random,
    *,
    nodes: int = 4,
    n_clients: int = 4,
    n_events: int = 30,
    duration: float = 20.0,
    hostile: bool = True,
    faults: bool = True,
) -> List[Event]:
    """A random adversarial schedule: honest traffic interleaved with
    client equivocation, hostile frame salvos, partitions (healed
    within the episode), and kind-selective drop windows."""
    events: List[Event] = []
    next_seq = [1] * n_clients
    burned: set = set()  # equivocated clients: their gate may never advance
    for _ in range(n_events):
        t = round(rng.uniform(0.0, duration), 3)
        roll = rng.random()
        usable = [c for c in range(n_clients) if c not in burned]
        if (roll < 0.55 or not (hostile or faults)) and usable:
            c = rng.choice(usable)
            events.append(
                [
                    t,
                    "tx",
                    {
                        "node": rng.randrange(nodes),
                        "client": c,
                        "seq": next_seq[c],
                        "to": rng.randrange(n_clients),
                        "amount": rng.randint(1, 50),
                    },
                ]
            )
            next_seq[c] += 1
        elif roll < 0.62 and usable and nodes >= 2:
            c = rng.choice(usable)
            a, b = rng.sample(range(nodes), 2)
            amount = rng.randint(1, 50)
            events.append(
                [
                    t,
                    "equiv",
                    {
                        "node_a": a,
                        "node_b": b,
                        "client": c,
                        "seq": next_seq[c],
                        "to_a": rng.randrange(n_clients),
                        "to_b": rng.randrange(n_clients),
                        "amount_a": amount,
                        "amount_b": amount + 1,  # contents must differ
                    },
                ]
            )
            burned.add(c)
        elif roll < 0.80 and hostile:
            events.append(
                [
                    t,
                    "hostile",
                    {
                        "targets": sorted(
                            rng.sample(range(nodes), rng.randint(1, nodes))
                        ),
                        "count": rng.randint(1, 6),
                    },
                ]
            )
        elif roll < 0.90 and faults and nodes >= 2:
            a, b = rng.sample(range(nodes), 2)
            events.append(
                [
                    t,
                    "cut",
                    {"a": a, "b": b, "duration": round(rng.uniform(0.5, 6.0), 3)},
                ]
            )
        elif faults:
            events.append(
                [
                    t,
                    "drop",
                    {
                        "src": rng.choice([None] + list(range(nodes))),
                        "kinds": sorted(
                            rng.sample(_DROPPABLE_KINDS, rng.randint(1, 3))
                        ),
                        "duration": round(rng.uniform(0.2, 3.0), 3),
                    },
                ]
            )
    events.sort(key=lambda e: (e[0], e[1]))
    return events


def generate_durability_events(
    rng: random.Random,
    *,
    nodes: int = 4,
    n_clients: int = 4,
    n_events: int = 30,
    duration: float = 24.0,
    hostile: bool = True,
    faults: bool = True,
) -> List[Event]:
    """A durability schedule: honest traffic with crash/restart cycles
    woven through it — a victim node is killed mid-load (optionally
    after a store flush, so restart covers both the segments+WAL-tail
    and the pure-WAL recovery paths), rebooted later, and sometimes
    partitioned from a peer right as its catchup starts. With
    ``hostile`` a membership reconfiguration races the in-flight slots:
    the fleet admin evicts the byzantine identity and re-weights the
    quorum thresholds, and every node flushes right after so the new
    epoch is durable across any later crash."""
    events: List[Event] = []
    next_seq = [1] * n_clients
    for _ in range(n_events):
        t = round(rng.uniform(0.0, duration), 3)
        c = rng.randrange(n_clients)
        events.append(
            [
                t,
                "tx",
                {
                    "node": rng.randrange(nodes),
                    "client": c,
                    "seq": next_seq[c],
                    "to": rng.randrange(n_clients),
                    "amount": rng.randint(1, 50),
                },
            ]
        )
        next_seq[c] += 1
    # crash/restart cycles on distinct victims, in DISJOINT downtime
    # windows: the schedule must respect the f-budget. Two nodes down at
    # once (f=1) leaves slots committed during the overlap with fewer
    # live copies than the catchup vote quorum (ready_threshold), which
    # correctly stalls recovery forever — a schedule bug, not a finding.
    n_cycles = rng.randint(1, 2) if nodes > 2 else 1
    victims = rng.sample(range(nodes), n_cycles)
    span = (duration * 0.7) / n_cycles
    for k, v in enumerate(victims):
        w0 = duration * 0.2 + k * span
        t_kill = round(w0 + rng.uniform(0.0, span * 0.25), 3)
        t_boot = round(t_kill + rng.uniform(1.5, max(1.6, span * 0.45)), 3)
        if rng.random() < 0.7:
            # flush first: restart sees segments + a WAL tail, not just
            # a WAL (the "restart from stale checkpoint" case when more
            # traffic lands between flush and kill)
            events.append(
                [
                    round(max(0.0, t_kill - rng.uniform(0.5, 3.0)), 3),
                    "flush",
                    {"node": v},
                ]
            )
        events.append([t_kill, "kill", {"node": v}])
        events.append([t_boot, "boot", {"node": v}])
        if faults and rng.random() < 0.5 and nodes >= 2:
            # partition the rebooting node from one peer while its
            # catchup runs (it must still confirm via the others)
            other = rng.choice([x for x in range(nodes) if x != v])
            events.append(
                [
                    round(t_boot + 0.1, 3),
                    "cut",
                    {
                        "a": v,
                        "b": other,
                        "duration": round(rng.uniform(1.0, 5.0), 3),
                    },
                ]
            )
    if hostile and rng.random() < 0.6:
        # reconfiguration racing in-flight slots: evict the hostile
        # identity, tighten nothing (thresholds re-derived for the
        # smaller peer set), then persist the epoch everywhere
        t = round(rng.uniform(duration * 0.1, duration * 0.8), 3)
        events.append(
            [
                t,
                "reconfig",
                {"node": rng.randrange(nodes), "change": {"remove_hostile": True}},
            ]
        )
        for i in range(nodes):
            events.append([round(t + 1.0, 3), "flush", {"node": i}])
    events.sort(key=lambda e: (e[0], e[1]))
    return events


BROKER_MUTATIONS = ("none", "dup", "reorder", "garbage", "withhold", "reseq")


def generate_broker_events(
    rng: random.Random,
    *,
    nodes: int = 4,
    n_clients: int = 4,
    n_events: int = 30,
    duration: float = 20.0,
    hostile: bool = True,
    faults: bool = True,
) -> List[Event]:
    """A byzantine-broker schedule: every client registers into the
    directory early, then distilled-batch submissions arrive with the
    broker misbehaving per frame — duplicating, reordering, corrupting
    ("garbage"), withholding entries, or replaying a captured signature
    at a shifted sequence ("reseq"). None of these may cost safety:
    entries stay client-signed over sequence-binding preimages, so a
    bad broker is a lossy wire, not a forger. Partitions and hostile salvos (which now include
    DirectoryAnnounce poisoning) interleave as in ``generate_events``."""
    events: List[Event] = []
    # registration window [0, 0.5): ids exist before the first frame
    for c in range(n_clients):
        events.append(
            [
                round(rng.uniform(0.0, 0.5), 3),
                "breg",
                {"node": rng.randrange(nodes), "client": c},
            ]
        )
    next_seq = [1] * n_clients
    for _ in range(n_events):
        t = round(rng.uniform(1.0, duration), 3)
        roll = rng.random()
        if roll < 0.70 or not (hostile or faults):
            rows = []
            for _ in range(rng.randint(1, 8)):
                c = rng.randrange(n_clients)
                rows.append(
                    [
                        c,
                        next_seq[c],
                        rng.randrange(n_clients),
                        rng.randint(1, 50),
                    ]
                )
                next_seq[c] += 1
            mutation = (
                "none"
                if rng.random() < 0.5
                else rng.choice(BROKER_MUTATIONS[1:])
            )
            events.append(
                [
                    t,
                    "bsub",
                    {
                        "node": rng.randrange(nodes),
                        "mutation": mutation,
                        "salt": rng.getrandbits(32),
                        "entries": rows,
                    },
                ]
            )
        elif roll < 0.85 and hostile:
            events.append(
                [
                    t,
                    "hostile",
                    {
                        "targets": sorted(
                            rng.sample(range(nodes), rng.randint(1, nodes))
                        ),
                        "count": rng.randint(1, 6),
                    },
                ]
            )
        elif faults and nodes >= 2:
            a, b = rng.sample(range(nodes), 2)
            events.append(
                [
                    t,
                    "cut",
                    {"a": a, "b": b, "duration": round(rng.uniform(0.5, 6.0), 3)},
                ]
            )
    events.sort(key=lambda e: (e[0], e[1]))
    return events


def generate_salting_events(
    rng: random.Random,
    *,
    nodes: int = 4,
    n_clients: int = 4,
    n_events: int = 30,
    duration: float = 20.0,
    hostile: bool = True,
    faults: bool = True,
) -> List[Event]:
    """A batch-poisoning schedule: honest traffic — including
    bulk flushes big enough for the auto router to amortize — interleaved
    with salted flushes from ONE byzantine client (``salt`` events; the
    salter identity itself lives in the episode's seeded
    :class:`SaltingClientGen`). Honest sequences are allocated in TIME
    order, so with no partitions in the schedule every honest entry is
    committable the moment it arrives — which is what lets the salting
    sweep count them as a hard bounded-loss invariant.

    Two anchors are always present regardless of the rolls: an early
    honest bulk flush (the RLC path must engage at all) and at least two
    salted flushes (the router must both fall back and converge)."""
    events: List[Event] = []
    next_seq = [1] * n_clients

    def bulk_event(t: float) -> Event:
        c = rng.randrange(n_clients)
        # above the engine's bisection leaf (16), so the flush exercises
        # the actual one-check amortized path, not the exact-leaf floor
        count = rng.randint(18, 32)
        ev = [
            t,
            "bulk",
            {
                "node": rng.randrange(nodes),
                "client": c,
                "seq0": next_seq[c],
                "count": count,
                "to": rng.randrange(n_clients),
                "amount": rng.randint(1, 20),
            },
        ]
        next_seq[c] += count
        return ev

    def salt_event(t: float) -> Event:
        return [
            t,
            "salt",
            {"node": rng.randrange(nodes), "size": rng.choice((24, 32, 40))},
        ]

    events.append(bulk_event(0.4))
    events.append(salt_event(1.0))
    events.append(salt_event(round(duration / 2, 3)))
    times = sorted(
        round(rng.uniform(1.5, duration), 3) for _ in range(n_events)
    )
    for t in times:
        roll = rng.random()
        if roll < 0.25:
            events.append(salt_event(t))
        elif roll < 0.40 and hostile:
            events.append(
                [
                    t,
                    "hostile",
                    {
                        "targets": sorted(
                            rng.sample(range(nodes), rng.randint(1, nodes))
                        ),
                        "count": rng.randint(1, 4),
                    },
                ]
            )
        elif roll < 0.65:
            events.append(bulk_event(t))
        else:
            c = rng.randrange(n_clients)
            events.append(
                [
                    t,
                    "tx",
                    {
                        "node": rng.randrange(nodes),
                        "client": c,
                        "seq": next_seq[c],
                        "to": rng.randrange(n_clients),
                        "amount": rng.randint(1, 50),
                    },
                ]
            )
            next_seq[c] += 1
    events.sort(key=lambda e: (e[0], e[1]))
    return events


def generate_cert_events(
    rng: random.Random,
    *,
    nodes: int = 4,
    n_clients: int = 4,
    n_events: int = 40,
    duration: float = 20.0,
    hostile: bool = True,
) -> List[Event]:
    """A finality-campaign schedule: serialized honest transfers (so
    the commit frontier crosses several ``audit_every`` strides and
    certificates actually assemble) with a byzantine member attacking
    the certificate lane — equivocating co-signature pairs, off-epoch
    co-signatures, forged signatures, and mutated kind-16 frames."""
    stride = max(0.2, duration / max(1, n_events))
    events: List[Event] = []
    next_seq = [1] * n_clients
    for k in range(n_events):
        c = k % n_clients
        events.append(
            [
                round(0.4 + stride * k, 3),
                "tx",
                {
                    "node": rng.randrange(nodes),
                    "client": c,
                    "seq": next_seq[c],
                    "to": (c + 1) % n_clients,
                    "amount": 1 + rng.randint(0, 9),
                },
            ]
        )
        next_seq[c] += 1
    if hostile:
        targets = list(range(nodes))
        for _ in range(3):
            events.append(
                [
                    round(rng.uniform(1.0, duration), 3),
                    "cert_equiv",
                    {"targets": targets},
                ]
            )
        for _ in range(2):
            events.append(
                [
                    round(rng.uniform(1.0, duration), 3),
                    "cert_stale",
                    {"targets": targets, "epoch": 7},
                ]
            )
        for _ in range(2):
            events.append(
                [
                    round(rng.uniform(1.0, duration), 3),
                    "cert_forge",
                    {"targets": targets, "count": 4},
                ]
            )
    events.sort(key=lambda e: (e[0], e[1]))
    return events


@dataclass
class EpisodeResult:
    seed: int
    events: List[Event]
    violations: List[str]
    trace_hash: str
    committed: List[int]
    delivered: int
    dropped: int
    virtual_time: float
    wall_seconds: float
    minimized: Optional[List[Event]] = None
    # failing episodes carry the fleet's observability state next to the
    # reproducer: per-node flight-recorder dumps + the cross-node
    # stitched timeline of every traced tx (tools/trace_collect.stitch).
    # Deterministic under sim virtual time — same seed, same artifact.
    obs: Optional[dict] = None
    # per-node fleet-audit state at quiescence (obs/audit.py): latched
    # divergence record, beacon counters, and the order-independent
    # digest coordinates — what the CI audit gate and the shard/wan
    # digest-equality tests assert on.
    audit: Optional[List[dict]] = None

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "ok": self.ok,
            "n_events": len(self.events),
            "violations": self.violations,
            "trace_hash": self.trace_hash,
            "committed": self.committed,
            "delivered": self.delivered,
            "dropped": self.dropped,
            "virtual_time": self.virtual_time,
            "wall_seconds": round(self.wall_seconds, 3),
            "events": self.events,
            "minimized": self.minimized,
            "obs": self.obs,
            "audit": self.audit,
        }


def _capture_obs(net: SimNet) -> dict:
    """Freeze the fleet's observability state while the net is still
    open: one flight-recorder dump per node plus the stitched cross-node
    timeline. Reads net.services directly — sim nodes don't serve the
    HTTP mux, and the capture must happen before net.close() tears the
    services down."""
    from ..tools.trace_collect import stitch  # tools -> sim is the
    # import direction elsewhere; keep this one lazy to avoid a cycle

    for svc in net.services:
        svc.recorder.snapshot("episode_capture")
    return {
        "recorders": [svc.debugz() for svc in net.services],
        "stitched": stitch([svc.tracez() for svc in net.services]),
    }


def _install_interposer(net: SimNet, rules: List[list]) -> None:
    """Drop-window interposer: rules are [until_t, src_sign|None, kinds]."""

    def interpose(src: bytes, dst: bytes, frame: bytes):
        if not rules:
            return None
        now = net.loop.time()
        live = [r for r in rules if r[0] >= now]
        if len(live) != len(rules):
            rules[:] = live
        for _until, src_sign, kinds in rules:
            if frame and frame[0] in kinds and (
                src_sign is None or src_sign == src
            ):
                return []
        return None

    net.fabric.interposer = interpose


def apply_events(
    net: SimNet,
    events: List[Event],
    clients: List,
    hostile_gen: Optional[HostileFrameGen],
    salting_gen: Optional[SaltingClientGen] = None,
    cert_adv: Optional[CertAdversary] = None,
) -> None:
    """Schedule every event onto the net's virtual timeline (relative to
    now). Submissions go through the real SendAsset handler; rejections
    (SimRpcError) are normal traffic in adversarial schedules."""
    loop = net.loop
    rules: List[list] = []
    _install_interposer(net, rules)

    def node_sign(i: int) -> bytes:
        return net.configs[i].sign_key.public

    def _track(task) -> None:
        net.fabric._tasks.add(task)
        task.add_done_callback(net.fabric._tasks.discard)

    def _live(node: int) -> Optional[int]:
        """The node itself, or deterministically the next live one when
        it is crashed (durability schedules keep traffic flowing)."""
        total = len(net.services)
        for k in range(total):
            cand = (node + k) % total
            if cand not in net.down:
                return cand
        return None

    def submit(node, client_i, seq, to_i, amount):
        node = _live(node)
        if node is None:
            return
        client = clients[client_i]
        task = loop.create_task(
            net.asubmit(node, client, seq, clients[to_i].public, amount)
        )
        _track(task)

    def bulk(args):
        """One honest bulk flush through SendAssetBatch: count entries
        from one client at consecutive sequences — the traffic shape the
        auto router amortizes through the RLC path."""
        node = _live(args["node"])
        if node is None:
            return
        client = clients[args["client"]]
        to = clients[args["to"]].public
        rows = [
            (args["seq0"] + j, to, args["amount"], True)
            for j in range(args["count"])
        ]
        _track(loop.create_task(net.asubmit_batch(node, client, rows)))

    def salt(args):
        """One salted flush from the byzantine client: honest-looking
        except k bad-signature entries at adversarial positions
        (SaltingClientGen). All-or-nothing admission rejects the whole
        flush; the sweep asserts the router then prices this source out
        of the RLC route."""
        if salting_gen is None:
            return
        node = _live(args["node"])
        if node is None:
            return
        rows = salting_gen.next_flush(args["size"])
        _track(
            loop.create_task(
                net.asubmit_batch(
                    node, salting_gen.key, rows, source="sim-salter"
                )
            )
        )

    # client index -> directory id, filled by "breg" events (first
    # successful registration wins; later "bsub" events read it)
    directory_ids: Dict[int, int] = {}

    def breg(args):
        async def _reg():
            cid = await net.aregister(
                args["node"], clients[args["client"]].public
            )
            if cid is not None:
                directory_ids.setdefault(args["client"], cid)

        task = loop.create_task(_reg())
        net.fabric._tasks.add(task)
        task.add_done_callback(net.fabric._tasks.discard)

    def bsub(args):
        """One broker flush, possibly byzantine. The mutation happens
        AFTER the clients signed their entries — exactly a corrupting
        collector's position: it can drop, repeat, split, or mangle
        frames, but every entry it forwards is client-signed."""
        rng = random.Random(args["salt"])
        entries = []
        for c_i, seq, to_i, amount in args["entries"]:
            cid = directory_ids.get(c_i)
            if cid is None:
                continue  # registration never landed: liveness-only loss
            to = clients[to_i].public
            entries.append(
                distill.DistilledEntry(
                    sender_id=cid,
                    sequence=seq,
                    recipient=to,
                    amount=amount,
                    signature=clients[c_i].sign(
                        transfer_signing_bytes(
                            clients[c_i].public, seq, to, amount
                        )
                    ),
                )
            )
            net.touched.add(clients[c_i].public)
            net.touched.add(to)
        mutation = args["mutation"]
        if mutation == "withhold" and len(entries) > 1:
            # censor a random proper subset: gaps park at the sequence
            # gate and time out, they never commit out of order
            keep = sorted(
                rng.sample(range(len(entries)), rng.randint(1, len(entries) - 1))
            )
            entries = [entries[i] for i in keep]
        if not entries:
            return
        if mutation == "reseq":
            # The replay forgery: re-encode a captured client signature
            # at the sender's next unused sequence. Under the v2 tagged
            # preimage (types.transfer_signing_bytes binds sender AND
            # sequence) the shifted entry's signature no longer
            # verifies, so ingress drops it; were it ever to commit,
            # _forged_commit_sweep would flag the episode.
            target = rng.choice(entries)
            victim = max(
                (e for e in entries if e.sender_id == target.sender_id),
                key=lambda e: e.sequence,
            )
            entries.append(
                distill.DistilledEntry(
                    sender_id=victim.sender_id,
                    sequence=victim.sequence + 1,
                    recipient=victim.recipient,
                    amount=victim.amount,
                    signature=victim.signature,
                )
            )
        if mutation == "dup":
            frame, _ = distill.distill(entries)
            frames = [frame, frame]
        elif mutation == "reorder" and len(entries) > 1:
            cut = rng.randint(1, len(entries) - 1)
            # later sequences ship first: the gap-fill fixpoint must
            # hold them until the earlier half lands
            frames = [
                distill.distill(half)[0]
                for half in (entries[cut:], entries[:cut])
            ]
        else:
            frame, _ = distill.distill(entries)
            if mutation == "garbage":
                frame = mutate_distilled_frame(frame, rng)
            frames = [frame]
        for frame in frames:
            task = loop.create_task(net.asubmit_distilled(args["node"], frame))
            net.fabric._tasks.add(task)
            task.add_done_callback(net.fabric._tasks.discard)

    for t, kind, args in events:
        if kind == "tx":
            loop.call_later(
                t,
                submit,
                args["node"],
                args["client"],
                args["seq"],
                args["to"],
                args["amount"],
            )
        elif kind == "equiv":

            def equiv(args=args):
                c = clients[args["client"]]
                for node, to_i, amount in (
                    (args["node_a"], args["to_a"], args["amount_a"]),
                    (args["node_b"], args["to_b"], args["amount_b"]),
                ):
                    task = loop.create_task(
                        net.asubmit(
                            node, c, args["seq"], clients[to_i].public, amount
                        )
                    )
                    net.fabric._tasks.add(task)
                    task.add_done_callback(net.fabric._tasks.discard)

            loop.call_later(t, equiv)
        elif kind == "hostile":
            if hostile_gen is None:
                continue

            def salvo(args=args):
                for _ in range(args["count"]):
                    frame = hostile_gen.next_frame()
                    for target in args["targets"]:
                        net.fabric.inject(
                            hostile_gen.sign.public, node_sign(target), frame
                        )

            loop.call_later(t, salvo)
        elif kind == "cut":

            def cut(args=args):
                a, b = node_sign(args["a"]), node_sign(args["b"])
                net.fabric.partition(a, b)
                loop.call_later(args["duration"], net.fabric.heal, a, b)

            loop.call_later(t, cut)
        elif kind == "breg":
            loop.call_later(t, breg, args)
        elif kind == "bsub":
            loop.call_later(t, bsub, args)
        elif kind == "bulk":
            loop.call_later(t, bulk, args)
        elif kind == "salt":
            loop.call_later(t, salt, args)
        elif kind == "kill":

            def kill(args=args):
                if args["node"] not in net.down:
                    _track(loop.create_task(net._acrash(args["node"])))

            loop.call_later(t, kill)
        elif kind == "boot":

            def boot(args=args):
                if args["node"] in net.down:
                    _track(loop.create_task(net.arestart(args["node"])))

            loop.call_later(t, boot)
        elif kind == "flush":

            def flush(args=args):
                if args["node"] in net.down:
                    return
                svc = net.services[args["node"]]
                if svc.store is not None:
                    _track(loop.create_task(svc._store_flush()))

            loop.call_later(t, flush)
        elif kind == "reconfig":

            def reconfig(args=args):
                node = _live(args["node"])
                if node is None:
                    return
                change = dict(args["change"])
                if change.pop("remove_hostile", None):
                    removes = [
                        c.sign_key.public.hex() for c in net.hostile_configs
                    ]
                    change["remove"] = list(change.get("remove", [])) + removes
                    # re-derive the crash-fault quorum for the smaller
                    # peer set (the byzantine margin is no longer needed)
                    n_peers = len(net.peers) - 1 - len(removes)
                    thr = max(1, n_peers - net.f)
                    change.setdefault("echo_threshold", thr)
                    change.setdefault("ready_threshold", thr)
                _track(
                    loop.create_task(
                        net.areconfig(node, change, epoch=args.get("epoch"))
                    )
                )

            loop.call_later(t, reconfig)
        elif kind == "drop":

            def drop(args=args):
                src = (
                    None if args["src"] is None else node_sign(args["src"])
                )
                rules.append(
                    [loop.time() + args["duration"], src, set(args["kinds"])]
                )

            loop.call_later(t, drop)
        elif kind == "inject":
            # raw frame injection (hex), for hand-built scenarios
            def inject(args=args):
                frame = bytes.fromhex(args["frame"])
                src = node_sign(args.get("src", 0))
                if "src_hostile" in args and hostile_gen is not None:
                    src = hostile_gen.sign.public
                net.fabric.inject(src, node_sign(args["target"]), frame)

            loop.call_later(t, inject)
        elif kind == "cert_equiv":
            # byzantine member co-signs two conflicting ledger states at
            # one (epoch, watermark): every receiver must latch the
            # culprit and neither state may reach a certificate
            if cert_adv is None:
                continue

            def cert_equiv(args=args):
                fa, fb = cert_adv.equivocating_pair(args.get("epoch", 0))
                for target in args["targets"]:
                    dst = node_sign(target)
                    net.fabric.inject(cert_adv.sign.public, dst, fa)
                    net.fabric.inject(cert_adv.sign.public, dst, fb)

            loop.call_later(t, cert_equiv)
        elif kind == "cert_stale":
            if cert_adv is None:
                continue

            def cert_stale(args=args):
                frame = cert_adv.off_epoch(args.get("epoch", 7))
                for target in args["targets"]:
                    net.fabric.inject(
                        cert_adv.sign.public, node_sign(target), frame
                    )

            loop.call_later(t, cert_stale)
        elif kind == "cert_forge":
            if cert_adv is None:
                continue

            def cert_forge(args=args):
                for _ in range(args.get("count", 1)):
                    frame = (
                        cert_adv.forged()
                        if cert_adv.rng.random() < 0.5
                        else cert_adv.mutant()
                    )
                    for target in args["targets"]:
                        net.fabric.inject(
                            cert_adv.sign.public, node_sign(target), frame
                        )

            loop.call_later(t, cert_forge)
        elif kind == "misapply":
            # arm one node's ledger failpoint (node/service.py
            # _apply_pass): the next `count` successful transfers it
            # commits misapply `delta` to the recipient's balance —
            # a silent local corruption only the fleet auditor's
            # cross-node beacon compare can catch.
            def misapply(args=args):
                svc = net.services[args["node"]]
                remaining = [int(args.get("count", 1))]
                delta = int(args["delta"])

                def failpoint(_payload, _r=remaining):
                    if _r[0] <= 0:
                        return 0
                    _r[0] -= 1
                    return delta

                svc.ledger_failpoint = failpoint

            loop.call_later(t, misapply)
        else:
            raise ValueError(f"unknown event kind: {kind}")


def _forged_commit_sweep(net: SimNet) -> List[str]:
    """Broker-campaign extra invariant: every payload any node committed
    carries a valid client signature over its own signing bytes. A
    byzantine broker (or any distilled-path bug) that smuggled an
    unsigned or altered transfer past ingress shows up here — this is
    the 'broker can censor but never forge' claim, checked at the
    ledger, not at the door."""
    violations: List[str] = []
    for si, s in enumerate(net.services):
        for sender, last_seq in sorted(s.accounts.frontier_nowait().items()):
            for p in s.history.get_range(sender, 1, last_seq + 1):
                if not verify_one(p.sender, p.to_sign(), p.signature):
                    violations.append(
                        f"forged commit on node {si}: slot "
                        f"({sender.hex()[:16]}, {p.sequence}) committed "
                        "with an invalid client signature"
                    )
    return violations


def _salting_sweep(
    net: SimNet, events: List[Event], salter_pk: bytes
) -> List[str]:
    """Batch-poisoning campaign invariants, checked against
    the shared verifier after quiescence:

    * the RLC path engaged at all (an episode that silently ran per-sig
      everywhere proves nothing),
    * amortization loss is BOUNDED: at most one RLC fallback per salted
      flush — a salter can burn the batches it is in, never more,
    * the router CONVERGED: the salter's failure EWMA prices any
      min_batch-size flush of its traffic out of the RLC route,
    * honest throughput survived: every honest scheduled entry committed
      on every live node, and no salted entry ever did."""
    violations: List[str] = []
    n_salt = sum(1 for _t, kind, _a in events if kind == "salt")
    vs = net.verifier.stats()
    if not vs.get("rlc_batches", 0):
        violations.append("salting: RLC path never engaged (rlc_batches == 0)")
    fallbacks = vs.get("rlc_fallbacks", 0)
    if n_salt and not fallbacks:
        violations.append(
            "salting: no salted flush ever reached the RLC path "
            "(rlc_fallbacks == 0)"
        )
    if fallbacks > n_salt:
        violations.append(
            f"salting: unbounded amortization loss — {fallbacks} RLC "
            f"fallbacks for {n_salt} salted flushes"
        )
    router = net.verifier.router
    if n_salt and router.expected_bad(
        [salter_pk] * router.min_batch
    ) <= router.expected_bad_budget:
        violations.append(
            "salting: router never converged — a full flush of salter "
            "traffic would still route to RLC"
        )
    expected = sum(1 for _t, k, _a in events if k == "tx") + sum(
        a["count"] for _t, k, a in events if k == "bulk"
    )
    for si, s in enumerate(net.services):
        if si in net.down:
            continue
        if s.committed < expected:
            violations.append(
                f"salting: node {si} committed {s.committed}/{expected} "
                "honest entries (unbounded throughput loss)"
            )
        if s.accounts.frontier_nowait().get(salter_pk, 0):
            violations.append(
                f"salting: node {si} committed an entry from a salted "
                "flush (all-or-nothing admission breached)"
            )
    return violations


def _cert_sweep(
    net: SimNet, events: List[Event], adversary_pk: Optional[bytes]
) -> List[str]:
    """Finality-campaign invariants (checked at quiescence):

    * certificate production is LIVE: every live node assembled at
      least one certificate over the episode's commit frontier,
    * every retained certificate passes FULL light verification
      (finality/light.py members mode — bitmap, per-rank signatures,
      quorum) and the chain never rolls progress back,
    * the planted equivocation LATCHED on every live node with culprit
      attribution (the adversary's key, both signed statements),
    * no equivocating/forged/stale co-signature ever reached a
      certificate: no two nodes hold certificates naming different
      ledger states at the same (epoch, watermark), and the adversary
      attacks show up in the defense counters, not the chain."""
    from ..finality import LightVerifier, verify_chain

    violations: List[str] = []
    n_equiv = sum(1 for _t, k, _a in events if k == "cert_equiv")
    n_stale = sum(1 for _t, k, _a in events if k == "cert_stale")
    n_forge = sum(1 for _t, k, _a in events if k == "cert_forge")
    adversary_hex = adversary_pk.hex() if adversary_pk else None
    for si, svc in enumerate(net.services):
        if si in net.down:
            continue
        certs = svc.certs
        if certs is None:
            violations.append(
                f"finality: node {si} runs without an assembler despite "
                "[finality] enabled"
            )
            continue
        if certs.latest is None:
            violations.append(
                f"finality: node {si} assembled no certificate "
                f"(commits={svc.auditor.commits}, "
                f"counters={certs.counters})"
            )
        else:
            lv = LightVerifier(
                [], members=certs.members, quorum=certs.quorum
            )
            verdict = verify_chain(certs.chain, lv)
            if not verdict["ok"]:
                violations.append(
                    f"finality: node {si} serves an unverifiable chain: "
                    f"{verdict}"
                )
        if n_equiv:
            eq = certs.equivocation
            if eq is None:
                violations.append(
                    f"finality: node {si} never latched the planted "
                    "certificate equivocation"
                )
            elif adversary_hex and eq.get("origin") != adversary_hex:
                violations.append(
                    f"finality: node {si} latched equivocation but "
                    f"attributed {eq.get('origin', '')[:16]}… instead of "
                    f"the adversary {adversary_hex[:16]}…"
                )
        if n_stale and not certs.counters.get("epoch_skew"):
            violations.append(
                f"finality: node {si} accepted or lost the off-epoch "
                "co-signatures (epoch_skew == 0)"
            )
        if n_forge and not certs.counters.get("bad_sig"):
            violations.append(
                f"finality: node {si} accepted or lost the forged "
                "co-signatures (bad_sig == 0)"
            )
    # cross-node: equal watermark digest ⇔ equal committed set, so two
    # certificates naming different (ranges, dir) at one (epoch, wm)
    # would mean an equivocating state was actually certified somewhere
    seen: Dict[tuple, tuple] = {}
    for si, svc in enumerate(net.services):
        if si in net.down or svc.certs is None:
            continue
        for cert in svc.certs.chain:
            key = (cert.epoch, cert.wm_digest)
            state = (cert.ranges, cert.dir_digest)
            prior = seen.setdefault(key, (si, state))
            if prior[1] != state:
                violations.append(
                    "finality: conflicting certificates at epoch "
                    f"{cert.epoch} wm {cert.wm_digest.hex()[:16]}… "
                    f"(nodes {prior[0]} and {si})"
                )
    return violations


def run_episode(
    seed: int,
    *,
    nodes: int = 4,
    f: int = 1,
    hostile: int = 1,
    events: Optional[List[Event]] = None,
    n_events: int = 30,
    duration: float = 20.0,
    n_clients: int = 4,
    link: Optional[LinkModel] = None,
    settle_horizon: float = 150.0,
    echo_threshold: Optional[int] = None,
    ready_threshold: Optional[int] = None,
    config_overrides: Optional[dict] = None,
    capture_obs: Optional[bool] = None,
    broker: bool = False,
    durability: bool = False,
    salting: bool = False,
    finality: bool = False,
) -> EpisodeResult:
    """One self-contained episode: fresh SimNet, (generated or given)
    events, run + settle, invariant check, teardown. Pure in
    ``(seed, parameters, events)``.

    ``capture_obs``: None (default) attaches recorder dumps + the
    stitched timeline exactly when the episode fails invariants; True
    always captures; False never does (minimization re-runs use this —
    they only need the boolean verdict).

    ``broker``: generate a byzantine-broker schedule (ingress via
    distilled frames with broker mutations) instead of the per-tx one,
    and additionally sweep every committed payload for a valid client
    signature (:func:`_forged_commit_sweep`).

    ``durability``: run every node on a durable sharded store with
    membership armed, and generate a crash/restart/reconfig schedule
    (:func:`generate_durability_events`). The invariant sweep then also
    covers no-post-restart-equivocation (recorded live by the net).

    ``salting``: run the batch-poisoning flavor — the shared verifier in
    auto mode with a sim-sized RLC threshold, a schedule from
    :func:`generate_salting_events`, and the amortized-verification
    invariant sweep (:func:`_salting_sweep`).

    ``finality``: run the certificate-lane flavor — every node with a
    ``[finality]`` table and a sim-sized ``audit_every``, a schedule
    from :func:`generate_cert_events` (honest load + a byzantine member
    attacking the certificate lane), and the certificate invariant
    sweep (:func:`_cert_sweep`)."""
    wall0 = time.monotonic()
    rng = random.Random(_seed_int("episode", seed))
    sim_kwargs = dict(config_overrides or {})
    if durability:
        sim_kwargs.setdefault("durable", True)
        sim_kwargs.setdefault("membership_grace", 1.0)
    if salting:
        sim_kwargs.setdefault("verifier_mode", "auto")
        sim_kwargs.setdefault("rlc_min_batch", 8)
    if finality:
        from ..node.config import FinalityConfig, ObservabilityConfig

        sim_kwargs.setdefault("finality", FinalityConfig(enabled=True))
        sim_kwargs.setdefault(
            "observability", ObservabilityConfig(audit_every=8)
        )
    net = SimNet(
        nodes,
        f,
        seed,
        hostile=hostile,
        link=link,
        echo_threshold=echo_threshold,
        ready_threshold=ready_threshold,
        **sim_kwargs,
    ).start()
    try:
        clients = [sim_client(seed, i) for i in range(n_clients)]
        if events is None:
            if durability:
                generate = generate_durability_events
            elif broker:
                generate = generate_broker_events
            elif salting:
                generate = generate_salting_events
            elif finality:
                generate = generate_cert_events
            else:
                generate = generate_events
            events = generate(
                rng,
                nodes=nodes,
                n_clients=n_clients,
                n_events=n_events,
                duration=duration,
                hostile=hostile > 0,
            )
        hostile_gen = (
            HostileFrameGen(
                net.hostile_configs[0].sign_key,
                random.Random(_seed_int("hostile", seed)),
            )
            if hostile > 0
            else None
        )
        salting_gen = (
            SaltingClientGen(random.Random(_seed_int("salter", seed)))
            if salting
            else None
        )
        cert_adv = (
            CertAdversary(
                net.hostile_configs[0].sign_key,
                random.Random(_seed_int("certadv", seed)),
            )
            if finality and hostile > 0
            else None
        )
        apply_events(net, events, clients, hostile_gen, salting_gen, cert_adv)
        last_t = max((e[0] for e in events), default=0.0)
        net.run_for(last_t + 1.0)
        net.fabric.heal_all()
        virtual = last_t + 1.0 + net.settle(horizon=settle_horizon)
        # fleet-audit sweep at quiescence: every live node beacons its
        # FINAL frontier (production's wall timer does this on served
        # nodes; sim schedules are timer-free), so matched-watermark
        # comparisons always happen at least once per episode no matter
        # how the mid-run commit-stride beacons interleaved.
        for i, svc in enumerate(net.services):
            if i not in net.down:
                svc._emit_beacon()
        net.settle(horizon=10.0)
        audit = [
            {
                "divergence": svc.auditor.divergence,
                "counters": svc.auditor.stats(),
                "commits": svc.auditor.commits,
                "wm": svc.accounts.digest.wm,
                "ranges": list(svc.accounts.digest.ranges),
                "dir": svc.directory.digest,
                "finality": (
                    svc.certs.status() if svc.certs is not None else None
                ),
            }
            for svc in net.services
        ]
        violations = net.check_invariants()
        if broker:
            violations += _forged_commit_sweep(net)
        if salting:
            violations += _salting_sweep(
                net, events, salting_gen.key.public
            )
        if finality:
            violations += _cert_sweep(
                net, events,
                cert_adv.sign.public if cert_adv is not None else None,
            )
        if durability and net.down:
            # a schedule must always reboot what it kills; a node still
            # down at quiescence is a schedule bug, not a safety pass
            violations.append(
                f"durability schedule left nodes down: {sorted(net.down)}"
            )
        obs = None
        if capture_obs or (capture_obs is None and violations):
            obs = _capture_obs(net)
        return EpisodeResult(
            seed=seed,
            events=events,
            violations=violations,
            trace_hash=net.fabric.trace_hash(),
            committed=[s.committed for s in net.services],
            delivered=net.fabric.delivered,
            dropped=net.fabric.dropped,
            virtual_time=virtual,
            wall_seconds=time.monotonic() - wall0,
            obs=obs,
            audit=audit,
        )
    finally:
        net.close()


def planted_breach_episode(
    seed: int = 20260805, *, capture_obs: Optional[bool] = None
) -> EpisodeResult:
    """The canonical planted safety bug, as a one-call reproducer: echo
    and ready thresholds forced to 1 (below the quorum-intersection
    bound), honest attestations suppressed net-wide, and a hostile peer
    hand-delivering a split vote for an equivocating client — nodes 0
    and 1 commit divergent contents and the invariant checker flags a
    sieve violation.

    scripts/ci.sh runs this to assert the failure artifact carries
    per-node flight-recorder dumps and the stitched cross-node timeline
    of the offending tx; tests/test_sim.py asserts the same shape."""
    from ..broadcast.messages import ECHO, READY, Attestation, Payload
    from ..node.config import BatchingConfig
    from ..types import ThinTransaction
    from .net import sim_keypairs

    clients = [sim_client(seed, i) for i in range(4)]
    hostile_sign, _ = sim_keypairs(seed, 4)  # identity 4: hostile peer

    def payload(to_i, amount):
        tx = ThinTransaction(clients[to_i].public, amount)
        return Payload.create(clients[0], 1, tx)

    def att_frames(chash):
        out = []
        for phase in (ECHO, READY):
            sig = hostile_sign.sign(
                Attestation.signing_bytes(phase, clients[0].public, 1, chash)
            )
            out.append(
                Attestation(
                    phase, hostile_sign.public, clients[0].public, 1,
                    chash, sig,
                ).encode().hex()
            )
        return out

    echo_a, ready_a = att_frames(payload(1, 5).content_hash())
    echo_b, ready_b = att_frames(payload(2, 6).content_hash())
    events = [
        [0.0, "drop", {"src": s, "kinds": [2, 3], "duration": 60.0}]
        for s in range(4)
    ] + [
        [
            0.2,
            "equiv",
            {
                "node_a": 0,
                "node_b": 1,
                "client": 0,
                "seq": 1,
                "to_a": 1,
                "to_b": 2,
                "amount_a": 5,
                "amount_b": 6,
            },
        ],
        [0.6, "inject", {"src_hostile": 1, "target": 0, "frame": echo_a}],
        [0.6, "inject", {"src_hostile": 1, "target": 0, "frame": ready_a}],
        [0.6, "inject", {"src_hostile": 1, "target": 1, "frame": echo_b}],
        [0.6, "inject", {"src_hostile": 1, "target": 1, "frame": ready_b}],
    ]
    return run_episode(
        seed,
        events=events,
        echo_threshold=1,
        ready_threshold=1,
        config_overrides={"batching": BatchingConfig(enabled=False)},
        settle_horizon=40.0,
        capture_obs=capture_obs,
    )


def planted_divergence_episode(
    seed: int = 20260805, *, capture_obs: Optional[bool] = None
) -> EpisodeResult:
    """The canonical planted STATE divergence, as a one-call reproducer:
    a clean 3-node fleet runs serialized honest traffic (client 0 pays
    client 1, one transfer settling fully before the next), and at
    t=2.6 node 0's ledger failpoint is armed to misapply a +7 balance
    delta to the recipient of its next committed transfer — a silent
    local corruption that is consistent across node 0's own WAL, ring,
    and digest, so only the fleet auditor's cross-node beacon compare
    (obs/audit.py, ``audit_every=8``) can catch it.

    The episode FAILS the invariant sweep by design (the fork is real:
    balance agreement breaks at quiescence); the point of the episode
    is what the ``audit`` block shows — both honest nodes latch a
    divergence attributing node 0, the recipient's account-range lane,
    and the first divergent watermark, within two beacon intervals of
    the corruption. scripts/ci.sh's fleet-audit gate and
    tests/test_sim.py assert exactly that."""
    from ..node.config import ObservabilityConfig

    events: List[Event] = [
        [0.5 + 0.5 * k, "tx",
         {"node": k % 3, "client": 0, "seq": k + 1, "to": 1, "amount": 1}]
        for k in range(40)
    ]
    events.append([2.6, "misapply", {"node": 0, "delta": 7, "count": 1}])
    events.sort(key=lambda e: (e[0], e[1]))
    return run_episode(
        seed,
        nodes=3,
        f=0,
        hostile=0,
        events=events,
        config_overrides={"observability": ObservabilityConfig(audit_every=8)},
        settle_horizon=60.0,
        capture_obs=capture_obs,
    )


def planted_cert_equivocation_episode(
    seed: int = 20260807, *, capture_obs: Optional[bool] = None
) -> EpisodeResult:
    """The canonical certificate-lane attack, as a one-call reproducer:
    a 4-node fleet with finality enabled runs serialized honest
    transfers, and a byzantine fleet MEMBER (its key in the epoch
    member set, so its co-signatures verify) emits equivocating
    co-signature pairs, off-epoch co-signatures, and forged frames at
    every node.

    The episode PASSES iff the defense held: honest certificates
    assembled and fully verify, every live node latched the
    equivocation with the adversary's key and both signed statements as
    evidence, the off-epoch/forged attacks landed in the
    ``epoch_skew``/``bad_sig`` counters, and no conflicting state was
    ever certified anywhere. scripts/ci.sh runs this twice and compares
    trace hashes (the determinism gate) and asserts the latch +
    attribution on every node's ``audit[i]["finality"]`` block."""
    rng = random.Random(_seed_int("cert-planted", seed))
    events = generate_cert_events(
        rng, nodes=4, n_clients=4, n_events=40, duration=16.0, hostile=True
    )
    return run_episode(
        seed,
        nodes=4,
        f=1,
        hostile=1,
        events=events,
        finality=True,
        settle_horizon=60.0,
        capture_obs=capture_obs,
    )


def minimize_events(
    events: List[Event],
    failing: Callable[[List[Event]], bool],
    *,
    max_passes: int = 3,
) -> List[Event]:
    """Shrink a failing schedule: shortest failing prefix by bisection,
    then greedy single-event removal to a fixpoint. ``failing`` must be
    deterministic (replay the same seed/config with the candidate
    list)."""
    if not failing(events):
        raise ValueError("schedule does not fail: nothing to minimize")
    # 1. shortest failing prefix
    lo, hi = 1, len(events)
    while lo < hi:
        mid = (lo + hi) // 2
        if failing(events[:mid]):
            hi = mid
        else:
            lo = mid + 1
    current = list(events[:hi])
    # 2. greedy removal to fixpoint
    for _ in range(max_passes):
        removed_any = False
        i = len(current) - 1
        while i >= 0 and len(current) > 1:
            candidate = current[:i] + current[i + 1 :]
            if failing(candidate):
                current = candidate
                removed_any = True
            i -= 1
        if not removed_any:
            break
    return current


def run_campaign(
    seed: int,
    episodes: int,
    *,
    nodes: int = 4,
    f: int = 1,
    hostile: int = 1,
    n_events: int = 30,
    duration: float = 20.0,
    minimize: bool = False,
    link: Optional[LinkModel] = None,
    progress: Optional[Callable[[int, "EpisodeResult"], None]] = None,
    broker: bool = False,
    durability: bool = False,
    salting: bool = False,
    finality: bool = False,
    config_overrides: Optional[dict] = None,
) -> dict:
    """``episodes`` independent seeded episodes; per-episode seeds derive
    from the campaign seed, failures carry their exact replay recipe
    (seed + event list), and the campaign hash — sha256 over the
    episode trace hashes — is the determinism fingerprint CI compares
    across two same-seed runs. ``broker=True`` runs the byzantine-broker
    flavor of every episode (distilled ingress + forged-commit sweep);
    ``durability=True`` the crash/restart/reconfig flavor (durable
    stores + membership + no-post-restart-equivocation);
    ``salting=True`` the batch-poisoning flavor (amortized verification
    under a salting client + bounded-loss/router-convergence sweep);
    ``finality=True`` the certificate-lane flavor (finality enabled
    fleet-wide + a byzantine member attacking the lane + the
    certificate invariant sweep)."""
    camp_rng = random.Random(_seed_int("campaign", seed))
    results: List[EpisodeResult] = []
    for ep in range(episodes):
        ep_seed = camp_rng.getrandbits(32)
        result = run_episode(
            ep_seed,
            nodes=nodes,
            f=f,
            hostile=hostile,
            n_events=n_events,
            duration=duration,
            link=link,
            broker=broker,
            durability=durability,
            salting=salting,
            finality=finality,
            config_overrides=config_overrides,
        )
        if result.violations and minimize:
            result.minimized = minimize_events(
                result.events,
                lambda evs: bool(
                    run_episode(
                        ep_seed,
                        nodes=nodes,
                        f=f,
                        hostile=hostile,
                        events=evs,
                        link=link,
                        capture_obs=False,
                        broker=broker,
                        durability=durability,
                        salting=salting,
                        finality=finality,
                        config_overrides=config_overrides,
                    ).violations
                ),
            )
        results.append(result)
        if progress is not None:
            progress(ep, result)
    h = hashlib.sha256()
    for r in results:
        h.update(r.trace_hash.encode())
    return {
        "campaign_seed": seed,
        "episodes": episodes,
        "nodes": nodes,
        "f": f,
        "hostile": hostile,
        "broker": broker,
        "durability": durability,
        "salting": salting,
        "finality": finality,
        "campaign_hash": h.hexdigest(),
        "failures": sum(1 for r in results if not r.ok),
        "results": [r.to_dict() for r in results],
    }

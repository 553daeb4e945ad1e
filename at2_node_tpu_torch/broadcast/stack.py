"""Three-phase byzantine broadcast: gossip → Echo (consistency) → Ready
(totality), with every signature routed through the pluggable Verifier.

Counterpart of ``at2_node_tpu/broadcast/stack.py``: the same state machine,
message for message, so port nodes and reference nodes form one net. Here
the bulk verify of every worker chunk goes to the port's verifier (the
CUDA batch verifier on a node).

Re-implements, as one explicit state machine, what the reference composes
from its murmur / sieve / contagion crates
(`at2-node/technical.md:7-15`, wired at
`at2-node/src/bin/server/rpc.rs:108-125`):

* **gossip (murmur)** — a new payload is relayed to every peer
  (`murmur_gossip_size` = full network, `rpc.rs:115`; AllSampler parity,
  `rpc.rs:124`) after its *client* signature verifies.
* **Echo (sieve)** — a node Echoes at most ONE payload content per
  (sender, sequence) slot — the equivocation filter — and sieve-delivers a
  content once `echo_threshold` distinct peers echoed that same content
  (`rpc.rs:113`: threshold = peer count).
* **Ready (contagion)** — on sieve-delivery a node signs a Ready; a
  content is delivered to the application once `ready_threshold` distinct
  peers sent Ready for it (`rpc.rs:120`). A node that collects a full
  Ready quorum without having sieve-delivered joins the quorum
  (amplification) so delivery is total across correct nodes.

Totality assumption: final delivery additionally requires the payload
content itself, which arrives only via gossip — a node that collects a
full Ready quorum but never received the payload pulls it from the Ready
quorum's members (content re-request, see ``_request_content``). The
re-request rides the same best-effort plane as gossip; under permanent
message loss to a node, that node may still not deliver — matching the
reference's open "catchup mechanism" roadmap item
(`at2-node/README.md:53`).

Thresholds count PEERS (self excluded — the reference's config lists the
N−1 other nodes, `at2-node/tests/cli.rs:173-184`, and sets every
threshold to that count, so an empty peer list degenerates to immediate
self-delivery, matching the reference's standalone-node test
`at2-node/tests/server-config-resolve-addrs`).

**Batched broadcast slots** (the 10k-tx/s lever): alongside the per-tx
plane above, a node may gossip a :class:`TxBatch` — ONE slot
((origin node, batch_seq)) carrying up to 1024 client transactions —
amortizing the per-slot protocol cost (1 gossip relay + n Echo + n Ready
messages and signatures) over the whole batch. The reference broadcasts
one transaction per sieve payload
(`at2-node/src/bin/server/rpc.rs:275-284`); Chop Chop (PAPERS.md)
is the public precedent for batching the broadcast unit. Chop Chop sits
on a total-order layer, where batch-level conflict resolution is free;
AT2 is consensus-free, so batch slots alone would lose sieve's
per-(sender, sequence) guarantee — a byzantine CLIENT racing conflicting
same-sequence transfers into two different honest nodes' batches could
commit differently on different correct nodes. This design closes that
hole with **per-entry endorsement bitmaps**:

* every node keeps an *entry registry* binding each (client sender,
  sequence) to the FIRST 140-byte entry content it echo-endorsed, across
  BOTH planes (per-tx echoes bind it too);
* a batch Echo/Ready is one signature over (batch hash, bitmap) where
  bit i endorses entry i — a node endorses exactly the entries whose
  client signature verified and whose registry binding is
  unbound-or-equal, so one conflicting entry never poisons its batch;
* quorum is counted PER ENTRY (vectorized: per-origin monotone bitmap
  ints, numpy unpackbits into count vectors), so an entry is delivered
  exactly when `echo/ready_threshold` distinct nodes endorsed *it* —
  with intersecting quorums (threshold > n/2) two conflicting contents
  for one (sender, sequence) can never both quorate, the same argument
  as per-tx sieve;
* Ready bitmaps are monotone (an origin re-attests with a superset as
  more entries reach Echo quorum); delivered entries feed the service's
  commit heap as ordinary Payloads, so the ledger, catchup, and history
  planes are unchanged.

Verification is the hot path (BASELINE north star): each worker drains a
CHUNK of the inbox per iteration and runs a three-stage pipeline —
(1) synchronous pre-checks (dedup, slot caps, per-origin single-vote) that
also insert into the dedup sets so no other worker double-verifies;
(2) ONE ``verifier.verify_many`` call for every signature the chunk needs
(this is what fills the GPU batch accumulator in bulk — one asyncio
future per chunk instead of per message); (3) synchronous state
transitions, re-validated against races with other workers that awaited
concurrently. State mutations stay on the single event loop — the same
single-writer argument as the reference's actors (SURVEY.md §5).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
from collections import defaultdict
from typing import TYPE_CHECKING, Dict, Optional, Set, Tuple

import numpy as np

from ..crypto.keys import SignKeyPair
from ..net.peers import Mesh, Peer
from ..obs.profiler import NO_SPANS
from .messages import (
    BATCH,
    BATCH_ECHO,
    BATCH_READY,
    ECHO,
    GOSSIP,
    MAX_BITMAP_BYTES,
    READY,
    Attestation,
    BatchAttestation,
    BatchContentRequest,
    ConfigTx,
    ContentRequest,
    DirectoryAnnounce,
    HistoryBatch,
    HistoryIndex,
    HistoryIndexRequest,
    HistoryRequest,
    Payload,
    CertSig,
    StateBeacon,
    TxBatch,
    WireError,
    parse_frame,
)

if TYPE_CHECKING:  # the verifier module imports torch; a plane worker must not
    from ..crypto.verifier import Verifier

# Catchup-plane messages are control traffic for the node service (ledger
# history catchup, ledger/history.py) — the broadcast stack just routes
# them to the registered handler; they carry no broadcast state.
_CATCHUP_KINDS = (HistoryIndexRequest, HistoryIndex, HistoryRequest, HistoryBatch)

logger = logging.getLogger(__name__)

Slot = Tuple[bytes, int]  # (sender public key, sequence)

# A byzantine sender can gossip many conflicting contents for one slot;
# only the first few are retained (one is enough for correctness — sieve
# echoes only the first — the margin just tolerates gossip races).
MAX_CONTENTS_PER_SLOT = 8

# Memory bounds: dedup sets evict FIFO at these caps, and slot states are
# garbage-collected (delivered slots after DELIVERED_RETENTION, dead slots
# after SLOT_MAX_AGE) so unauthenticated spam cannot grow RSS unboundedly.
DEDUP_CAP = 1 << 20
# Cap on undelivered slots: beyond this, new slots are dropped until
# delivery or GC frees room. Bounds RSS against spam from freshly generated
# keypairs, which pass signature verification but never reach quorum.
# Delivered slots retained for DELIVERED_RETENTION deliberately do NOT
# count: sustained legitimate throughput must never trip the cap.
MAX_LIVE_SLOTS = 1 << 17
DELIVERED_RETENTION = 120.0  # s after delivery before the slot compacts
SLOT_MAX_AGE = 3600.0  # s an undelivered slot may linger
GC_INTERVAL = 5.0
# Min seconds between content re-requests for a ready-quorate slot whose
# payload gossip never arrived (pull-based catch-up; see module docstring).
REQUEST_RETRY = 5.0
# Stalled-slot retransmission (liveness under message loss): the planes
# are best-effort (bounded queues drop under overload, burst measurements
# showed a single lost attestation gap-blocking a whole sender at
# thresholds = n_peers), so a slot still undelivered RETRANSMIT_AFTER
# seconds after creation re-broadcasts this node's content + own
# attestations, at most every RETRANSMIT_EVERY per slot. Receivers that
# already saw them dedup at the pre-verify stage for the cost of a set
# lookup (deterministic ed25519: a re-signed attestation is
# byte-identical, so _attest_seen absorbs it).
RETRANSMIT_AFTER = 5.0
RETRANSMIT_EVERY = 10.0
# Global per-GC-pass retransmission budget: after a mass stall (burst
# overflow parking thousands of slots) an unbounded pass would re-inject
# B x n_peers frames at once — re-creating the overload it heals.
# Skipped slots keep their old retransmitted_at, so subsequent passes
# rotate through them naturally.
RETRANSMIT_BUDGET_PER_PASS = 64
# An undelivered slot this old has outlived push-retransmission AND the
# helpers' delivered-state retention may be expiring: hand recovery to
# the ledger-catchup plane (stall_handler -> node.service._kick_catchup),
# which replays the committed slot from peers' history stores.
STALLED_CATCHUP_AFTER = 30.0
# Stall-storm damping (hysteresis on stall_handler): consecutive kicks
# are spaced at least STALL_KICK_MIN_INTERVAL apart, doubling up to
# STALL_KICK_MAX_INTERVAL while the stall persists, and the interval
# resets once a GC pass sees no stalled slot. Without this, ONE slot
# parked past STALLED_CATCHUP_AFTER fires a network-wide catchup kick
# every GC_INTERVAL for up to SLOT_MAX_AGE — the amplification lever the
# per-slot resolution tracking closes.
STALL_KICK_MIN_INTERVAL = 30.0
STALL_KICK_MAX_INTERVAL = 300.0
# Entry-registry bound (see Broadcast._entry_registry): sized so FIFO
# eviction cannot reopen the equivocation window for LIVE slots — see
# the safety comment at the construction site.
ENTRY_REGISTRY_CAP = 1 << 22
# Max messages one worker drains from the inbox per iteration: the unit of
# bulk verification (one verify_many call -> one slice of the GPU batch).
WORKER_CHUNK = 256
# Byte budget for undrained inbox frames. The inbox's 65536-entry bound
# alone would admit ~1 TiB of parked 16 MiB frames from an authenticated
# byzantine peer; 64 MiB is >4x the largest legitimate frame and hundreds
# of typical attestation batches — overflow drops, like the entry cap.
INBOX_MAX_BYTES = 64 * 1024 * 1024


class _BoundedSet:
    """Insertion-ordered set with FIFO eviction at a fixed capacity."""

    __slots__ = ("_cap", "_items")

    def __init__(self, cap: int) -> None:
        self._cap = cap
        self._items: Dict = {}

    def add(self, key) -> None:
        if key in self._items:
            return
        self._items[key] = None
        if len(self._items) > self._cap:
            self._items.pop(next(iter(self._items)))

    def discard(self, key) -> None:
        self._items.pop(key, None)

    def __contains__(self, key) -> bool:
        return key in self._items

    def __len__(self) -> int:
        return len(self._items)


class _BoundedDict:
    """Insertion-ordered dict with FIFO eviction at a fixed capacity
    (the mapping twin of :class:`_BoundedSet`). ``evictions`` counts
    entries shed at the cap — nonzero on the entry registry means the
    sizing argument at its construction site was violated in practice
    (surfaced as the ``entry_evictions`` gauge; the fleet-audit beacons
    are the cross-node backstop for any divergence this could cause)."""

    __slots__ = ("_cap", "_items", "evictions")

    def __init__(self, cap: int) -> None:
        self._cap = cap
        self._items: Dict = {}
        self.evictions = 0

    def get(self, key, default=None):
        return self._items.get(key, default)

    def put(self, key, value) -> None:
        if key not in self._items:
            if len(self._items) >= self._cap:
                self._items.pop(next(iter(self._items)))
                self.evictions += 1
        self._items[key] = value

    def pop(self, key, default=None):
        return self._items.pop(key, default)

    def __contains__(self, key) -> bool:
        return key in self._items

    def __len__(self) -> int:
        return len(self._items)


_EMPTY_COUNTS = np.zeros(0, dtype=np.int32)

# Below this many entries the ctypes crossing costs more than the numpy
# ops it replaces; above it the native kernel wins AND releases the GIL,
# which is what lets ThreadPlaneExecutor shards actually overlap.
_NATIVE_QUORUM_MIN = 16


def _quorate_mask(counts: np.ndarray, threshold: int, nbits: int) -> int:
    """Bitmap int of entries whose vote count reached the threshold.

    Bit-identical on the native (at2_quorum_mask, GIL released) and numpy
    paths — differential-tested in tests/test_plane_shards.py — so which
    path runs never affects wire behavior or sim hashes."""
    if nbits <= 0:
        return 0
    if threshold <= 0:
        return (1 << nbits) - 1
    n = min(len(counts), nbits)
    if n == 0:
        return 0
    if n >= _NATIVE_QUORUM_MIN:
        from ..native.ingest import ingest_ready

        if ingest_ready():
            from ..native.ingest import quorum_mask_native

            return quorum_mask_native(counts, threshold, n)
    mask = counts[:n] >= threshold
    return int.from_bytes(
        np.packbits(mask, bitorder="little").tobytes(), "little"
    )


class _BatchVotes:
    """Per-(content hash, phase) vote accumulator: per-origin MONOTONE
    endorsement bitmaps (ints) plus a vectorized per-entry count vector.
    ``add`` is the only mutator: it ORs an origin's new bitmap in and
    bumps the counts at every newly-set bit position (numpy unpackbits —
    one vectorized op per attestation, not per entry)."""

    __slots__ = ("by_origin", "counts")

    def __init__(self) -> None:
        self.by_origin: Dict[bytes, int] = {}
        self.counts = _EMPTY_COUNTS

    def add(self, origin: bytes, bits: int, nbits: int) -> bool:
        """Returns True when the origin contributed at least one new bit."""
        old = self.by_origin.get(origin, 0)
        new = bits & ~old
        if not new:
            return False
        self.by_origin[origin] = old | bits
        if len(self.counts) < nbits:
            grown = np.zeros(nbits, dtype=np.int32)
            grown[: len(self.counts)] = self.counts
            self.counts = grown
        new_bytes = new.to_bytes((nbits + 7) // 8, "little")
        if nbits >= _NATIVE_QUORUM_MIN:
            from ..native.ingest import ingest_ready

            if ingest_ready():
                from ..native.ingest import counts_add_native

                # GIL-released tally fold (at2_counts_add); arithmetic
                # identical to the unpackbits path below
                counts_add_native(new_bytes, self.counts)
                return True
        delta = np.unpackbits(
            np.frombuffer(new_bytes, dtype=np.uint8),
            bitorder="little",
        )[:nbits]
        self.counts[:nbits] += delta
        return True


class _BatchState:
    """Broadcast state of one batch slot ((origin node, batch_seq)) —
    the batched twin of :class:`_SlotState`, with per-entry vote vectors
    instead of per-slot origin sets."""

    __slots__ = (
        "created",
        "birth",
        "content_requested_at",
        "retransmitted_at",
        "helped_at",
        "contents",
        "echoed_hash",
        "echo_by_origin",
        "ready_by_origin",
        "echo_votes",
        "ready_votes",
        "own_echo_bits",
        "ready_hash",
        "ready_sent_bits",
        "delivered_bits",
        "rejected_bits",
        "delivered_all",
        "retired",
        "nbits",
        "echo_q_marked",
    )

    def __init__(self, now: float) -> None:
        self.created = now
        self.birth = 0  # plane-wide creation ordinal (stamped by creator)
        self.content_requested_at = 0.0
        self.retransmitted_at = 0.0  # last stalled-slot retransmission
        self.helped_at: Dict[bytes, float] = {}  # per-peer help pacing
        self.contents: Dict[bytes, TxBatch] = {}  # batch hash -> batch
        self.echoed_hash: Optional[bytes] = None  # first content echoed here
        # first vote per origin per phase binds that origin to ONE batch
        # content (node-level equivocation guard, like *_by_origin above)
        self.echo_by_origin: Dict[bytes, bytes] = {}
        self.ready_by_origin: Dict[bytes, bytes] = {}
        self.echo_votes: Dict[bytes, _BatchVotes] = {}  # batch hash -> votes
        self.ready_votes: Dict[bytes, _BatchVotes] = {}
        # the entries WE echo-endorsed per content (sig valid + registry
        # agreed) — the delivery gate when thresholds degenerate to 0,
        # where no peer quorum exists to carry the verification argument
        self.own_echo_bits: Dict[bytes, int] = {}
        # slot-level Ready binding, mirroring per-tx _SlotState.ready_sent:
        # this node signs Ready for at most ONE content per batch slot
        self.ready_hash: Optional[bytes] = None
        self.ready_sent_bits = 0  # our cumulative Ready bits (ready_hash)
        self.delivered_bits: Dict[bytes, int] = {}  # hash -> delivered bits
        # entries WE rejected at echo time (bad client signature or an
        # equivocation-registry conflict) — the resolution complement of
        # delivered_bits: an entry is RESOLVED when delivered or rejected
        self.rejected_bits: Dict[bytes, int] = {}
        self.delivered_all = False  # some content fully delivered
        # every ready-quorate entry delivered, every remaining entry
        # locally resolved-rejected: the slot can never progress further
        # and must not count as stalled (see _maybe_retire_batch)
        self.retired = False
        self.nbits = 0  # widest entry count seen (content or bitmap bound)
        self.echo_q_marked = 0  # entries already echo_quorum-marked (trace)


class _SlotState:
    __slots__ = (
        "contents",
        "echoed_hash",
        "echoes",
        "readies",
        "echo_by_origin",
        "ready_by_origin",
        "ready_sent",
        "ready_hash",
        "sieve_delivered",
        "delivered",
        "created",
        "birth",
        "content_requested_at",
        "retransmitted_at",
        "helped_at",
    )

    def __init__(self, now: float) -> None:
        self.created = now
        self.birth = 0  # plane-wide creation ordinal (stamped by creator)
        self.content_requested_at = 0.0  # last pull request, 0 = never
        self.retransmitted_at = 0.0  # last stalled-slot retransmission
        self.helped_at: Dict[bytes, float] = {}  # per-peer help pacing
        self.ready_hash: Optional[bytes] = None  # content our READY covers
        self.contents: Dict[bytes, Payload] = {}  # content_hash -> payload
        self.echoed_hash: Optional[bytes] = None  # sieve: first content only
        self.echoes: Dict[bytes, Set[bytes]] = defaultdict(set)  # hash -> origins
        self.readies: Dict[bytes, Set[bytes]] = defaultdict(set)
        # first VERIFIED vote per origin per phase wins — a byzantine origin
        # cannot land in two contents' quorums (echo equivocation guard)
        self.echo_by_origin: Dict[bytes, bytes] = {}
        self.ready_by_origin: Dict[bytes, bytes] = {}
        self.ready_sent = False
        self.sieve_delivered = False
        self.delivered = False


class Broadcast:
    """The node's broadcast endpoint: submit via :meth:`broadcast`, consume
    committed payloads from :attr:`delivered` (an asyncio.Queue of
    :class:`Payload`, drained in batches by the service's delivery loop)."""

    # class-level default so partially-constructed instances (tests build
    # bare objects via __new__ to unit-test single methods) read "no
    # recorder" instead of raising AttributeError
    recorder = None
    # same contract for the plane time-accounting seam (obs/profiler.py)
    phases = None
    spans = NO_SPANS
    # same contract for the [wan] echo/ready phase-piggyback knob
    overlap_ready = False

    def __init__(
        self,
        keypair: SignKeyPair,
        mesh: Mesh,
        verifier: Verifier,
        echo_threshold: Optional[int] = None,
        ready_threshold: Optional[int] = None,
        workers: int = 16,
        registry=None,
        trace=None,
        recorder=None,
        clock=None,
        phases=None,
        overlap_ready: bool = False,
    ) -> None:
        from ..clock import SYSTEM_CLOCK

        self.keypair = keypair
        self.mesh = mesh
        self.verifier = verifier
        self.clock = SYSTEM_CLOCK if clock is None else clock
        n_peers = len(mesh.peers)
        # Reference parity: every threshold defaults to the peer count
        # (rpc.rs:112-120); configurable so f>0 setups are testable
        # (SURVEY.md §5 failure-detection note).
        self.echo_threshold = n_peers if echo_threshold is None else echo_threshold
        self.ready_threshold = n_peers if ready_threshold is None else ready_threshold
        self.workers = workers
        self.delivered: asyncio.Queue = asyncio.Queue()
        self._slots: Dict[Slot, _SlotState] = {}
        # batched plane (module docstring): batch slots keyed
        # (origin node sign key, batch_seq); the entry registry binds each
        # (client sender, client seq) to the first echo-endorsed 140-byte
        # entry content ACROSS both planes — sieve's per-slot guarantee
        self._batch_slots: Dict[Tuple[bytes, int], _BatchState] = {}
        self._delivered_batch_slots = _BoundedSet(DEDUP_CAP)
        # Registry retention is scoped to LIVE (uncommitted) sequences:
        # the service drops a binding via release_entry() once its
        # sequence passes the ledger gate, where the per-account sequence
        # check subsumes the registry's job (a conflicting content for a
        # committed seq can never commit again). Safety of the FIFO cap:
        # the theoretical live bound is MAX_LIVE_SLOTS x
        # MAX_BATCH_ENTRIES (2^17 x 2^10 = 2^27) bindings, far past what
        # fits in RAM — but per-tx slots bind at most one entry each
        # (<= MAX_LIVE_SLOTS = 2^17 total) and batch slots exist only
        # under the n known node identities, so 2^22 covers the per-tx
        # worst case plus ~4000 full in-flight batches (4M entries,
        # >> any real in-flight window at the 10k tx/s target). Eviction
        # at the cap therefore only ever sheds bindings under a workload
        # that already exceeds every other resource bound; committed
        # bindings are released eagerly and cost nothing.
        self._entry_registry = _BoundedDict(ENTRY_REGISTRY_CAP)
        self._inbox: asyncio.Queue = asyncio.Queue(maxsize=65536)
        # The inbox holds RAW frames (parsed in the worker chunk stage),
        # each up to transport MAX_FRAME (16 MiB) — so the entry-count
        # bound alone would let an authenticated-but-byzantine peer (in
        # model for BFT) park ~1 TiB of undrained bytes. Bound BYTES too:
        # admission debits the budget, the worker credits it back on
        # dequeue. Single-threaded (event loop) => plain int is race-free.
        self._inbox_bytes = 0
        self._tasks: list = []
        # inflight verification dedup: messages identical to one already
        # being verified are coalesced instead of re-verified
        self._gossip_seen = _BoundedSet(DEDUP_CAP)
        self._attest_seen = _BoundedSet(DEDUP_CAP)
        # slots compacted away after delivery; membership blocks re-delivery
        self._delivered_slots = _BoundedSet(DEDUP_CAP)
        # count of slots in _slots with delivered == False (the cap metric)
        self._undelivered = 0
        # node-service hook for catchup-plane messages (sync callable
        # (peer, msg) -> None); None drops them (a stack used standalone)
        self.catchup_handler = None
        # node-service hook for client-directory announces (sync callable
        # (peer, msg) -> None; node/directory.py) — same routing shape as
        # the catchup plane; None drops them (a stack used standalone)
        self.directory_handler = None
        # node-service hook for membership config transactions (sync
        # callable (peer, msg) -> None; node/membership.py) — same shape
        # as directory_handler; None drops them
        self.config_handler = None
        # node-service hook for fleet-audit state beacons (sync callable
        # (peer, msg) -> None; obs/audit.py) — same shape as
        # directory_handler; None drops them
        self.beacon_handler = None
        # node-service hook for finality cert co-signatures (sync
        # callable (peer, msg) -> None; finality/certs.py) — same shape
        # as beacon_handler; None drops them
        self.cert_handler = None
        # sim hook fired whenever this node SIGNS an attestation (either
        # plane): callable (phase, origin_or_sender, sequence, chash).
        # The simulator's no-post-restart-equivocation invariant records
        # every signing across a node's incarnations through this.
        self.on_attest = None
        # Broadcast-safety watermarks: the highest slot this node has
        # attested per origin, per plane. Persisted in the store manifest
        # and restored as FLOORS after a crash — _send_attestation /
        # _send_batch_attestation refuse to sign any slot at or below the
        # restored floor, so a restarted node can never sign a
        # CONFLICTING echo/ready for a slot it attested pre-crash (the
        # pre-crash vote may have reached peers even if nothing else
        # survived locally). Liveness: refused slots commit through
        # peers' quorums and reach this node via ledger catchup.
        self._wm_tx: Dict[bytes, int] = {}  # client sender -> max seq
        self._wm_batch: Dict[bytes, int] = {}  # batch origin -> max seq
        self._floor_tx: Dict[bytes, int] = {}
        self._floor_batch: Dict[bytes, int] = {}
        self.floor_refusals = 0  # attestations suppressed by a floor
        # node-service hook fired (once per GC pass) when some slot has
        # been stalled past STALLED_CATCHUP_AFTER: push-retransmission
        # has failed, recovery belongs to the ledger-catchup plane.
        # Kicks are damped with hysteresis (min interval + exponential
        # backoff, STALL_KICK_*) so a persistent stall cannot storm the
        # network with catchup sessions every GC pass.
        self.stall_handler = None
        self._stall_last_kick = float("-inf")
        self._stall_backoff = STALL_KICK_MIN_INTERVAL
        # slot-creation ordinal: dict insertion order made durable, so a
        # sharded plane (broadcast/shards.py shares ONE counter across
        # its cores) can reconstruct the global GC iteration order
        self._birth_seq = itertools.count()
        # observability (SURVEY.md §5: per-stage counters). The service
        # passes its registry + tx-lifecycle tracer; a standalone stack
        # (unit tests, bench harnesses) gets a private registry and no
        # tracing. CounterGroup keeps the ``stats["k"] += 1`` surface.
        from ..obs.registry import Registry

        self.registry = Registry() if registry is None else registry
        self.trace = trace
        # protocol flight recorder (obs/recorder.py); None = not recording.
        # Sites guard with ``is not None`` so the disabled path costs one
        # attribute read.
        self.recorder = recorder
        # plane time-accounting (obs/profiler.py PhaseAccounting); same
        # ``is not None`` guard discipline at every marked segment
        self.phases = phases
        # [wan] overlap_ready: emit Ready in the SAME frame as Echo
        # (phase piggybacking) instead of waiting out the echo-quorum
        # round trip. Safety is carried by what this knob does NOT
        # change: the per-slot single-Ready binding (ready_hash is set
        # exactly once, all sends go through _send_attestation's
        # watermark floors) and the delivery gate (ready quorum AND own
        # ready sent AND content known). What it relaxes is only the
        # scheduling claim "own Ready implies a locally-observed echo
        # quorum" — an opt-in latency/ordering trade, default off so the
        # wire schedule (and every same-seed sim hash) is unchanged.
        self.overlap_ready = overlap_ready
        self.registry.gauge(
            "slots_undelivered", "live undelivered broadcast slots",
            fn=lambda: self._undelivered,
        )
        self.registry.gauge(
            "inbox_depth", "raw frames queued for the broadcast workers",
            fn=lambda: self._inbox.qsize(),
        )
        self.registry.gauge(
            "entry_evictions",
            "entry-registry bindings shed at the FIFO cap (should be 0; "
            "see the sizing argument at the registry's construction)",
            fn=lambda: self._entry_registry.evictions,
        )
        self.stats = self.registry.counter_group((
            "gossip_rx",
            "echo_rx",
            "ready_rx",
            "invalid_sig",
            "delivered",
            "slots_dropped",
            "content_req_tx",
            "content_req_rx",
            "content_served",
            "batch_rx",
            "batch_echo_rx",
            "batch_ready_rx",
            "batch_entries_delivered",
            "retransmits",
            # robustness counters (poison-entry resolution):
            # entries resolved by local rejection when their slot retired,
            # retired slots, and stall kicks absorbed by the hysteresis
            "poison_resolved",
            "slots_retired",
            "stall_kicks_suppressed",
        ))

    async def start(self) -> None:
        # Pre-build the native ingest library off-loop HERE — broadcast is
        # its consumer, so this covers every verifier configuration (the
        # lazy first-use g++ compile must never run on the event loop
        # inside a live worker chunk and freeze the node).
        from ..native.ingest import ingest_available

        await asyncio.get_running_loop().run_in_executor(None, ingest_available)
        for _ in range(self.workers):
            self._tasks.append(asyncio.create_task(self._worker()))
        self._tasks.append(asyncio.create_task(self._gc_loop()))

    async def close(self) -> None:
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()

    # -- inbound ----------------------------------------------------------

    async def on_frame(self, peer: Peer, frame: bytes) -> None:
        """Mesh callback: enqueue the RAW frame; parsing happens in the
        worker chunk stage (one native-ingest call per chunk when the C++
        library is available — frame parse + payload content hashes in
        one GIL-released pass). Drops (best-effort plane) when the inbox
        is saturated — by entry count OR byte budget — rather than
        back-pressuring the socket."""
        if self.recorder is not None and frame:
            self.recorder.record("rx", (frame[0], len(frame), peer.address))
        if self._inbox_bytes + len(frame) > INBOX_MAX_BYTES:
            logger.warning("inbox byte budget exhausted; dropping frame")
            if self.recorder is not None:
                self.recorder.record("rx_drop", ("bytes", len(frame)))
            return
        try:
            self._inbox.put_nowait((peer, frame))
        except asyncio.QueueFull:
            logger.warning("inbox overflow; dropping frame")
            if self.recorder is not None:
                self.recorder.record("rx_drop", ("depth", len(frame)))
        else:
            self._inbox_bytes += len(frame)

    async def broadcast(self, payload: Payload) -> None:
        """Local submission (the gRPC SendAsset handler calls this —
        reference: `handle.broadcast`, rpc.rs:275-284)."""
        await self._inbox.put((None, payload))

    async def broadcast_batch(self, batch: TxBatch) -> None:
        """Local submission of a signed batch slot (the service's ingress
        batcher calls this; see node/service.py `_flush_batch`)."""
        await self._inbox.put((None, batch))

    # -- workers ----------------------------------------------------------

    async def _gc_loop(self) -> None:
        """Compact delivered slots, expire dead ones (memory bound), and
        drive stalled-slot recovery (budgeted retransmission + the
        catchup-plane stall signal)."""
        while True:
            await self.clock.sleep(GC_INTERVAL)
            self._gc_pass(self.clock.monotonic())

    def _gc_pass(self, now: float) -> None:
        """One synchronous GC/recovery pass over this plane's slots.

        Split into per-slot steps (:meth:`_gc_tx_slot` /
        :meth:`_gc_batch_slot`) plus the stall-hysteresis epilogue
        (:meth:`_gc_resolve_stall`) so the sharded plane
        (broadcast/shards.py) can interleave EVERY shard's slots in
        global creation order under one shared retransmit budget — the
        exact iteration this monolithic pass performs — while this
        method keeps serving the monolithic plane and the threaded
        per-shard pass unchanged."""
        ph, sp = self.phases, self.spans
        t_gc = ph.t() if ph is not None else 0
        h = (
            sp.begin("at2.broadcast.slot_gc", len(self._slots) + len(self._batch_slots))
            if sp.on
            else None
        )
        try:
            budget = [RETRANSMIT_BUDGET_PER_PASS]
            stalled_past_horizon = False
            for slot in list(self._slots):
                if self._gc_tx_slot(slot, now, budget):
                    stalled_past_horizon = True
            for slot in list(self._batch_slots):
                if self._gc_batch_slot(slot, now, budget):
                    stalled_past_horizon = True
            self._gc_resolve_stall(now, stalled_past_horizon)
        finally:
            if h is not None:
                sp.end(h)
        if ph is not None:
            ph.add("slot_gc", t_gc)

    def _gc_tx_slot(self, slot: Slot, now: float, budget: list) -> bool:
        """GC/recovery step for ONE per-tx slot; returns True when the
        slot is stalled past the catchup horizon. ``budget`` is a
        one-element mutable cell so one retransmission budget can span a
        whole pass (and, sharded, every shard in the pass)."""
        state = self._slots.get(slot)
        if state is None:
            return False
        age = now - state.created
        if state.delivered and age > DELIVERED_RETENTION:
            self._delivered_slots.add(slot)
            del self._slots[slot]
        elif age > SLOT_MAX_AGE:
            if not state.delivered:
                self._undelivered -= 1
            del self._slots[slot]
        elif not state.delivered:
            # periodic retry of the content pull for quorate slots
            # still missing their payload (lost request/response)
            for chash, origins in state.readies.items():
                if (
                    len(origins) >= self.ready_threshold
                    and chash not in state.contents
                ):
                    self._request_content(slot, state, chash)
            if budget[0] > 0 and self._retransmit_slot(slot, state, now):
                budget[0] -= 1
            if age > STALLED_CATCHUP_AFTER:
                return True
        return False

    def _gc_batch_slot(self, slot, now: float, budget: list) -> bool:
        """Batch-plane twin of :meth:`_gc_tx_slot`."""
        bstate = self._batch_slots.get(slot)
        if bstate is None:
            return False
        age = now - bstate.created
        if not (bstate.delivered_all or bstate.retired):
            # a slot can become retire-eligible between worker
            # transitions (e.g. the last quorate entry delivered
            # via another content's votes); settle it here so it
            # never sits through a pass as a false "stall"
            self._maybe_retire_batch(slot, bstate)
        resolved = bstate.delivered_all or bstate.retired
        if resolved and age > DELIVERED_RETENTION:
            self._delivered_batch_slots.add(slot)
            del self._batch_slots[slot]
        elif age > SLOT_MAX_AGE:
            if not resolved:
                self._undelivered -= 1
            del self._batch_slots[slot]
        elif not resolved:
            # retry the batch pull when quorate entries await content
            for chash, rv in bstate.ready_votes.items():
                if chash in bstate.contents:
                    continue
                quorate = _quorate_mask(
                    rv.counts, self.ready_threshold, bstate.nbits
                )
                if quorate & ~bstate.delivered_bits.get(chash, 0):
                    self._request_batch_content(slot, bstate, chash)
            if budget[0] > 0 and self._retransmit_batch_slot(
                slot, bstate, now
            ):
                budget[0] -= 1
            # "stalled awaiting quorum" vs "stalled with
            # unresolved poison": only the former can be healed
            # by the catchup plane (the slot may be committed
            # network-wide). A slot whose only undelivered
            # entries are ones WE rejected is poison-blocked —
            # a network-wide catchup kick cannot resolve it and
            # must not be fired for it.
            if age > STALLED_CATCHUP_AFTER and not (
                self._poison_blocked_only(bstate)
            ):
                return True
        return False

    def _gc_resolve_stall(self, now: float, stalled_past_horizon: bool) -> None:
        """Stall-kick hysteresis epilogue of a GC pass. Duck-typed: the
        sharded plane calls this unbound with itself as ``self`` so ONE
        plane-level hysteresis spans all shards (matching the monolithic
        plane), with per-shard stall state never consulted."""
        if stalled_past_horizon and self.stall_handler is not None:
            # beyond push-retransmission: the slot may be committed
            # network-wide with the helpers' delivered state expiring
            # — the ledger-catchup plane replays it from history.
            # Hysteresis: consecutive kicks are spaced at least
            # _stall_backoff apart (doubling while the stall
            # persists) so one misbehaving slot cannot trigger a
            # catchup session every GC pass network-wide.
            if now - self._stall_last_kick >= self._stall_backoff:
                self._stall_last_kick = now
                self._stall_backoff = min(
                    self._stall_backoff * 2, STALL_KICK_MAX_INTERVAL
                )
                if self.recorder is not None:
                    self.recorder.record("stall_kick", ())
                try:
                    self.stall_handler()
                except Exception:
                    logger.exception("stall handler error")
            else:
                self.stats["stall_kicks_suppressed"] += 1
                if self.recorder is not None:
                    self.recorder.record("stall_kick_suppressed", ())
        elif not stalled_past_horizon:
            # healthy pass: re-arm the hysteresis for the next storm
            self._stall_backoff = STALL_KICK_MIN_INTERVAL

    def _resend_slot(
        self, slot: Slot, state: _SlotState, peer: Optional[Peer]
    ) -> bool:
        """Re-emit this node's content copy + own attestations for a
        slot — broadcast (stalled-slot retransmission) or targeted
        (straggler help). Returns True when anything went out."""
        sent = False
        if state.echoed_hash is not None:
            payload = state.contents.get(state.echoed_hash)
            if payload is not None:
                if peer is not None:
                    self.mesh.send(peer, payload.encode())
                else:
                    self.mesh.broadcast(payload.encode())
            self._send_attestation(
                ECHO, slot[0], slot[1], state.echoed_hash, peer=peer
            )
            sent = True
        if state.ready_sent and state.ready_hash is not None:
            self._send_attestation(
                READY, slot[0], slot[1], state.ready_hash, peer=peer
            )
            sent = True
        if sent:
            self.stats["retransmits"] += 1
        return sent

    def _resend_batch_slot(
        self, slot, state: _BatchState, peer: Optional[Peer]
    ) -> bool:
        """Batch-plane twin of :meth:`_resend_slot`."""
        sent = False
        if state.echoed_hash is not None:
            batch = state.contents.get(state.echoed_hash)
            if batch is not None:
                if peer is not None:
                    self.mesh.send(peer, batch.encode())
                else:
                    self.mesh.broadcast(batch.encode())
                sent = True
            bits = state.own_echo_bits.get(state.echoed_hash, 0)
            nbits = batch.count if batch is not None else state.nbits
            if bits and nbits:
                self._send_batch_attestation(
                    BATCH_ECHO, slot, state.echoed_hash, bits, nbits, peer=peer
                )
                sent = True
        if state.ready_hash is not None and state.ready_sent_bits:
            rbatch = state.contents.get(state.ready_hash)
            nbits = rbatch.count if rbatch is not None else state.nbits
            if nbits:
                self._send_batch_attestation(
                    BATCH_READY,
                    slot,
                    state.ready_hash,
                    state.ready_sent_bits,
                    nbits,
                    peer=peer,
                )
                sent = True
        if sent:
            self.stats["retransmits"] += 1
        return sent

    def _help_paced(self, state, peer: Peer, now: float) -> bool:
        """Per-(slot, peer) pacing for straggler help: two stragglers on
        one slot must not serialize behind a shared timestamp."""
        last = state.helped_at.get(peer.sign_public, 0.0)
        if now - last < RETRANSMIT_EVERY:
            return False
        state.helped_at[peer.sign_public] = now
        return True

    def _help_straggler(
        self, peer: Optional[Peer], slot: Slot, state: _SlotState
    ) -> None:
        """Targeted repair: send our content copy + own attestations for
        a DELIVERED slot directly to the peer whose duplicate attestation
        marked it as stalled (see _pre_attestation)."""
        if peer is not None and self._help_paced(state, peer, self.clock.monotonic()):
            self._resend_slot(slot, state, peer)

    def _help_batch_straggler(
        self, peer: Optional[Peer], slot, state: _BatchState
    ) -> None:
        """Batch-plane twin of :meth:`_help_straggler`."""
        if peer is not None and self._help_paced(state, peer, self.clock.monotonic()):
            self._resend_batch_slot(slot, state, peer)

    def _retransmit_slot(self, slot: Slot, state: _SlotState, now: float) -> bool:
        """Stalled-slot liveness: re-broadcast this node's content copy
        and own attestations for a slot still undelivered past
        RETRANSMIT_AFTER (a lost echo/ready has no other recovery at
        thresholds = n_peers; receivers that saw them dedup pre-verify)."""
        if now - state.created < RETRANSMIT_AFTER:
            return False
        if now - state.retransmitted_at < RETRANSMIT_EVERY:
            return False
        if not self._resend_slot(slot, state, None):
            return False
        state.retransmitted_at = now
        return True

    def _retransmit_batch_slot(self, slot, state: _BatchState, now: float) -> bool:
        """Batch-plane twin of :meth:`_retransmit_slot`."""
        if now - state.created < RETRANSMIT_AFTER:
            return False
        if now - state.retransmitted_at < RETRANSMIT_EVERY:
            return False
        if not self._resend_batch_slot(slot, state, None):
            return False
        state.retransmitted_at = now
        return True

    async def _worker(self) -> None:
        while True:
            item = await self._inbox.get()
            chunk = [item]
            while len(chunk) < WORKER_CHUNK:
                try:
                    chunk.append(self._inbox.get_nowait())
                except asyncio.QueueEmpty:
                    break
            for _, payload in chunk:
                if isinstance(payload, (bytes, bytearray, memoryview)):
                    self._inbox_bytes -= len(payload)
            # plane_total wraps the whole drain cycle (parse + process):
            # it is the denominator of the per-node plane decomposition
            # (obs/profiler.py); rx_decode covers the frame parse here,
            # the admission pre-checks inside _process_chunk chain onto
            # it. begin/end_plane (not a bare add_ns) so a cycle that
            # re-enters the plane in-context accounts its span ONCE.
            ph, sp = self.phases, self.spans
            t_plane = ph.begin_plane() if ph is not None else 0
            t0 = ph.t() if ph is not None else 0
            # at2.broadcast.rx_decode: the parse and the pre-checks, one
            # synchronous stretch that _process_chunk closes
            h = sp.begin("at2.broadcast.rx_decode", len(chunk)) if sp.on else None
            try:
                msgs = self._parse_chunk(chunk)
                if ph is not None:
                    ph.add("rx_decode", t0)
                await self._process_chunk(msgs, h)
            except Exception:
                if h is not None:
                    sp.end(h)  # a second end is a no-op
                logger.exception("broadcast worker error")
            if ph is not None:
                ph.end_plane(t_plane)

    def _parse_chunk(self, chunk) -> list:
        """Turn a drained inbox chunk into (peer, message) pairs.

        Inbox entries are raw wire frames (from the mesh) or already-built
        Payload objects (local gRPC submissions). Wire frames go through
        the native ingest library in ONE call per chunk when available
        (at2_ingest.cpp: kind dispatch, record extraction, and payload
        content hashes with the GIL released); malformed frames drop whole
        with a warning, exactly like the Python parse_frame path."""
        out = []
        frames: list = []  # parallel lists: frame bytes + source peer
        frame_peers: list = []
        for peer, item in chunk:
            if isinstance(item, (bytes, bytearray, memoryview)):
                frames.append(bytes(item))
                frame_peers.append(peer)
            else:
                out.append((peer, item))
        if not frames:
            return out
        from ..native.ingest import ingest_ready_or_kick, parse_frames_native

        # The native call has fixed setup cost (ndarray staging, one
        # ctypes crossing); it wins when a chunk actually batched. Tiny
        # chunks — one frame trickling in on an idle net — stay on the
        # Python parser, which is faster below this threshold.
        # ingest_ready_or_kick never builds: start() pre-builds off-loop,
        # a stack used without start() must not run g++ on the event loop.
        total_bytes = sum(len(f) for f in frames)
        if total_bytes >= 4096 and ingest_ready_or_kick():
            parsed, frame_ok = parse_frames_native(frames)
            for i, ok in enumerate(frame_ok):
                if not ok:
                    peer = frame_peers[i]
                    logger.warning(
                        "bad frame from %s",
                        peer.address if peer is not None else "local",
                    )
            out.extend((frame_peers[fi], msg) for fi, msg in parsed)
        else:
            for peer, frame in zip(frame_peers, frames):
                try:
                    out.extend((peer, m) for m in parse_frame(frame))
                except WireError as exc:
                    logger.warning(
                        "bad frame from %s: %s",
                        peer.address if peer is not None else "local",
                        exc,
                    )
        return out

    async def _process_chunk(self, chunk, span=None) -> None:
        """Three stages (module docstring): sync pre-checks -> one bulk
        verify -> sync state transitions (re-validated against races).
        Actions carry how many verify items they claimed: a TxBatch puts
        1 (origin) + count (client) signatures into the SAME bulk call.
        ``span`` is the caller's open rx_decode span, closed here before
        the verify; the transitions run in an at2.broadcast.apply span."""
        ph, sp = self.phases, self.spans
        t0 = ph.t() if ph is not None else 0
        to_verify = []
        actions = []  # (kind, msg, n_sigs)
        for peer, msg in chunk:
            self._pre_msg(peer, msg, to_verify, actions)
        # admission pre-checks account to rx_decode (receive-side cost)
        if ph is not None:
            t0 = ph.add("rx_decode", t0)
        if span is not None:
            sp.end(span)
        if not to_verify:
            return
        results = await self.verifier.verify_many(to_verify)
        if ph is not None:
            ph.add("verify_wait", t0)
        h = sp.begin("at2.broadcast.apply", len(actions)) if sp.on else None
        try:
            self._apply_actions(actions, results)
        finally:
            if h is not None:
                sp.end(h)

    def _pre_msg(self, peer, msg, to_verify: list, actions: list) -> None:
        """Stage 1 for ONE message: synchronous admission pre-checks and
        control-message dispatch. Verify-needing messages append their
        signature items to ``to_verify`` and an ``(kind, msg, n_sigs)``
        action; control messages (requests, catchup, directory, config)
        are handled inline and append nothing. The sharded plane calls
        this per message in ARRIVAL order (broadcast/shards.py), the
        monolithic plane from its chunk loop above — identical behavior
        either way."""
        if isinstance(msg, Payload):
            if self._pre_gossip(msg):  # noqa: SIM102 (kept parallel)
                to_verify.append(
                    (msg.sender, msg.to_sign(), msg.signature)
                )
                actions.append((GOSSIP, msg, 1))
        elif isinstance(msg, TxBatch):
            if self._pre_batch(msg):
                to_verify.append(
                    (msg.origin, msg.signing_bytes(), msg.signature)
                )
                entries = msg.entries()
                to_verify.extend(
                    (e.sender, e.to_sign(), e.signature) for e in entries
                )
                actions.append((BATCH, msg, 1 + len(entries)))
        elif isinstance(msg, BatchAttestation):
            if self._pre_batch_attestation(msg, peer):
                to_verify.append((msg.origin, msg.to_sign(), msg.signature))
                actions.append((msg.phase, msg, 1))
        elif isinstance(msg, ContentRequest):
            self._on_request(peer, msg)
        elif isinstance(msg, BatchContentRequest):
            self._on_batch_request(peer, msg)
        elif isinstance(msg, _CATCHUP_KINDS):
            # synchronous handler (service-side bookkeeping / replies
            # via mesh.send); heavy work happens in the service's
            # catchup task, never in this worker
            if self.catchup_handler is not None and peer is not None:
                try:
                    self.catchup_handler(peer, msg)
                except Exception:
                    logger.exception("catchup handler error")
        elif isinstance(msg, DirectoryAnnounce):
            # directory mappings are liveness-only service state
            # (node/directory.py); synchronous apply, bad mappings
            # are dropped by the handler's stride/conflict checks
            if self.directory_handler is not None and peer is not None:
                try:
                    self.directory_handler(peer, msg)
                except Exception:
                    logger.exception("directory handler error")
        elif isinstance(msg, ConfigTx):
            # admin-signed membership transitions (node/membership.py);
            # the handler validates the admin signature and epoch —
            # peer may be None (admin-side local injection)
            if self.config_handler is not None:
                try:
                    self.config_handler(peer, msg)
                except Exception:
                    logger.exception("config handler error")
        elif isinstance(msg, StateBeacon):
            # fleet-audit digests (obs/audit.py); the handler verifies
            # the origin signature — beacon rates are a few per second
            # per peer, so the sync verify never matters for the plane
            if self.beacon_handler is not None:
                try:
                    self.beacon_handler(peer, msg)
                except Exception:
                    logger.exception("beacon handler error")
        elif isinstance(msg, CertSig):
            # finality co-signatures (finality/certs.py); the assembler
            # verifies the scheme signature — same cadence and routing
            # shape as beacons
            if self.cert_handler is not None:
                try:
                    self.cert_handler(peer, msg)
                except Exception:
                    logger.exception("cert handler error")
        else:
            if self._pre_attestation(msg, peer):
                to_verify.append((msg.origin, msg.to_sign(), msg.signature))
                actions.append((msg.phase, msg, 1))

    def _apply_actions(self, actions, results) -> None:
        """Stage 3: walk the action list against the bulk-verify verdicts
        (each action consumed ``n_sigs`` consecutive results) and run the
        state transitions, in action order."""
        idx = 0
        for kind, msg, n_sigs in actions:
            ok = results[idx]
            entry_oks = (
                results[idx + 1 : idx + n_sigs] if kind == BATCH else None
            )
            idx += n_sigs
            self._post_action(kind, msg, ok, entry_oks)

    def _post_action(self, kind, msg, ok, entry_oks) -> None:
        """Stage 3 for ONE verified action: invalid-signature accounting
        or the kind-specific state transition."""
        if not ok:
            self.stats["invalid_sig"] += 1
            if kind == GOSSIP:
                logger.warning(
                    "invalid payload signature for slot (%s, %d)",
                    msg.sender.hex()[:16],
                    msg.sequence,
                )
            elif kind == BATCH:
                logger.warning(
                    "invalid batch origin signature from %s",
                    msg.origin.hex()[:16],
                )
            else:
                logger.warning(
                    "invalid %s signature from %s",
                    {
                        ECHO: "echo",
                        READY: "ready",
                        BATCH_ECHO: "batch-echo",
                        BATCH_READY: "batch-ready",
                    }.get(kind, "attestation"),
                    msg.origin.hex()[:16],
                )
            return
        if kind == GOSSIP:
            self._post_gossip(msg)
        elif kind == BATCH:
            self._post_batch(msg, entry_oks)
        elif kind in (BATCH_ECHO, BATCH_READY):
            self._post_batch_attestation(msg)
        else:
            self._post_attestation(msg)

    # -- stage 1: synchronous pre-checks (dedup inserts happen here, so no
    # other worker can double-verify the same message) --------------------

    def _pre_gossip(self, payload: Payload) -> bool:
        self.stats["gossip_rx"] += 1
        slot = payload.slot
        if slot in self._delivered_slots:
            return False  # already committed and compacted
        # Slot-cap check BEFORE the dedup insert and the verify stage: a
        # valid message dropped at the cap must stay retryable (its
        # deterministic retransmission would otherwise be dedup-suppressed
        # forever), and a message that will be dropped must not spend
        # verifier throughput. Concurrent workers may overshoot the cap by
        # at most the worker pool's chunk capacity — negligible vs the cap.
        if slot not in self._slots and self._undelivered >= MAX_LIVE_SLOTS:
            self.stats["slots_dropped"] += 1
            if self.recorder is not None:
                self.recorder.record("slot_drop", ("gossip", slot[1]))
            return False
        chash = payload.content_hash()
        key = (slot, chash)
        if key in self._gossip_seen:
            return False
        state = self._slots.get(slot)
        if state is not None:
            if chash in state.contents:
                return False
            # Content cap: a byzantine sender must not grow state.contents
            # unboundedly — but a content the network has already voted
            # toward quorum for is always admitted, or an equivocator
            # could fill the cap with junk contents and permanently block
            # the quorate payload (incl. the pull-based catch-up path).
            # NOTE: cap rejections deliberately do NOT enter _gossip_seen,
            # so a retransmission after the content becomes quorate (or
            # after GC) is processed, not dedup-suppressed.
            if (
                len(state.contents) >= MAX_CONTENTS_PER_SLOT
                and not self._content_wanted(state, chash)
            ):
                return False
        self._gossip_seen.add(key)
        return True

    def _content_wanted(self, state: _SlotState, chash: bytes) -> bool:
        """A content with quorum-level votes is stored regardless of the
        per-slot content cap (it may be the only deliverable content)."""
        return (
            len(state.readies.get(chash, ())) >= max(self.ready_threshold, 1)
            or len(state.echoes.get(chash, ())) >= max(self.echo_threshold, 1)
        )

    def _pre_attestation(
        self, att: Attestation, peer: Optional[Peer] = None
    ) -> bool:
        phase_key = "echo_rx" if att.phase == ECHO else "ready_rx"
        self.stats[phase_key] += 1
        if att.origin not in self.mesh.by_sign:
            logger.warning(
                "attestation from unknown origin %s", att.origin.hex()[:16]
            )
            return False
        slot = (att.sender, att.sequence)
        if slot in self._delivered_slots:
            return False
        # Slot-cap check before dedup/verify — same rationale as gossip:
        # capacity drops must not poison the dedup set or burn verifier time.
        if slot not in self._slots and self._undelivered >= MAX_LIVE_SLOTS:
            self.stats["slots_dropped"] += 1
            if self.recorder is not None:
                self.recorder.record("slot_drop", ("attestation", slot[1]))
            return False
        # Exact-duplicate suppression keyed INCLUDING the signature, so a
        # forged message can never shadow the origin's real (differently
        # signed) vote; per-origin single-vote enforcement happens after
        # verification via *_by_origin below.
        seen_key = (att.phase, att.origin, slot, att.content_hash, att.signature)
        if seen_key in self._attest_seen:
            # A DUPLICATE attestation for a slot we already delivered is
            # a straggler's retransmission beacon (_retransmit_slot): its
            # sender is stalled, and our vote may be the very one its
            # loss took out — we stopped retransmitting when we
            # delivered. Answer with our content + own attestations
            # (paced; fresh late attestations don't trigger this).
            state = self._slots.get(slot)
            if state is not None and state.delivered:
                self._help_straggler(peer, slot, state)
            return False
        self._attest_seen.add(seen_key)
        state = self._slots.get(slot)
        if state is not None:
            by_origin = (
                state.echo_by_origin if att.phase == ECHO else state.ready_by_origin
            )
            if att.origin in by_origin:
                return False  # this origin already cast a verified vote here
        return True

    # -- stage 3: synchronous state transitions (post-verify; every check
    # that another worker could have raced during the verify await is
    # re-validated here) ---------------------------------------------------

    def _post_gossip(self, payload: Payload) -> None:
        ph = self.phases
        t0 = ph.t() if ph is not None else 0
        slot = payload.slot
        if slot in self._delivered_slots:
            return
        chash = payload.content_hash()
        state = self._new_or_existing_slot(slot)
        if chash in state.contents:
            return
        if (
            len(state.contents) >= MAX_CONTENTS_PER_SLOT
            and not self._content_wanted(state, chash)
        ):
            # Another worker filled the slot to the cap during the verify
            # await. Un-poison the dedup set: _pre_gossip's NOTE promises
            # cap rejections stay retryable, so a later retransmission (or
            # the content-pull catch-up response, should this hash become
            # the quorate one) must be processed, not dedup-suppressed.
            self._gossip_seen.discard((slot, chash))
            return
        state.contents[chash] = payload
        # murmur: relay to everyone (gossip_size = full network)
        self.mesh.broadcast(payload.encode())
        # sieve: echo only the FIRST content seen for this slot — and only
        # if the cross-plane entry registry agrees (a conflicting content
        # for this (sender, seq) may already be bound via a BATCH entry;
        # endorsing both here and there would let two intersecting quorums
        # form for different contents — module docstring)
        if state.echoed_hash is None:
            body = payload.encode()[1:]
            bound = self._entry_registry.get(slot)
            if bound is None or bound == body:
                if bound is None:
                    self._entry_registry.put(slot, body)
                state.echoed_hash = chash
                if self.trace is not None:
                    self.trace.stamp(slot, "echoed")
                if self.recorder is not None:
                    self.recorder.record("echo", (payload.sequence,))
                self._send_attestation(
                    ECHO, payload.sender, payload.sequence, chash
                )
                if self.overlap_ready and not state.ready_sent:
                    # [wan] phase piggyback: bind and send the Ready in
                    # the same frame as the Echo (mesh coalescing packs
                    # both into one wire frame), collapsing the serial
                    # echo-quorum round trip out of the critical path
                    state.ready_sent = True
                    state.ready_hash = chash
                    self._send_attestation(
                        READY, payload.sender, payload.sequence, chash
                    )
        if ph is not None:
            t0 = ph.add("echo_apply", t0)
        self._advance(slot, state, chash)
        if ph is not None:
            ph.add("ready_deliver", t0)

    def _post_attestation(self, att: Attestation) -> None:
        ph = self.phases
        t0 = ph.t() if ph is not None else 0
        slot = (att.sender, att.sequence)
        if slot in self._delivered_slots:
            return
        state = self._new_or_existing_slot(slot)
        by_origin = (
            state.echo_by_origin if att.phase == ECHO else state.ready_by_origin
        )
        if att.origin in by_origin:
            return
        by_origin[att.origin] = att.content_hash
        votes = state.echoes if att.phase == ECHO else state.readies
        votes[att.content_hash].add(att.origin)
        if ph is not None:
            t0 = ph.add("quorum_bitmap", t0)
        self._advance(slot, state, att.content_hash)
        if ph is not None:
            ph.add("ready_deliver", t0)

    def _on_request(self, peer: Optional[Peer], req: ContentRequest) -> None:
        """Serve a peer's content pull (no verify: channel-authenticated)."""
        self.stats["content_req_rx"] += 1
        if peer is None:
            return  # requests only make sense from the wire
        state = self._slots.get((req.sender, req.sequence))
        if state is None:
            return  # unknown or already compacted; best-effort
        payload = state.contents.get(req.content_hash)
        if payload is not None:
            self.stats["content_served"] += 1
            self.mesh.send(peer, payload.encode())

    def _request_content(self, slot: Slot, state: _SlotState, chash: bytes) -> None:
        """Pull a ready-quorate slot's missing payload from its Ready voters
        (they either hold the content or know who gossiped it; falls back to
        all peers when no voter maps to a known peer)."""
        now = self.clock.monotonic()
        if now - state.content_requested_at < REQUEST_RETRY:
            return
        state.content_requested_at = now
        self.stats["content_req_tx"] += 1
        frame = ContentRequest(slot[0], slot[1], chash).encode()
        targets = [
            self.mesh.by_sign[origin]
            for origin in state.readies.get(chash, ())
            if origin in self.mesh.by_sign
        ]
        if targets:
            for peer in targets:
                self.mesh.send(peer, frame)
        else:
            self.mesh.broadcast(frame)

    def _new_or_existing_slot(self, slot: Slot) -> _SlotState:
        state = self._slots.get(slot)
        if state is None:
            state = self._slots[slot] = _SlotState(self.clock.monotonic())
            state.birth = next(self._birth_seq)
            self._undelivered += 1
        return state

    # -- batched plane (module docstring) ---------------------------------

    def release_entry(self, sender: bytes, sequence: int) -> None:
        """Drop the (sender, seq) -> content equivocation binding once the
        sequence has passed the LEDGER gate (the service's commit loop
        calls this). Safe because the per-account sequence gate now
        rejects ANY content for this sequence — committed or conflicting
        — so the registry's job for the slot is done. Eager release keeps
        the registry's working set proportional to in-flight
        (uncommitted) entries instead of all-time traffic, which is what
        makes the FIFO cap a dead-man's valve rather than a live
        eviction path (see the construction-site comment)."""
        self._entry_registry.pop((sender, sequence))

    def _new_or_existing_batch_slot(self, slot) -> _BatchState:
        state = self._batch_slots.get(slot)
        if state is None:
            state = self._batch_slots[slot] = _BatchState(self.clock.monotonic())
            state.birth = next(self._birth_seq)
            self._undelivered += 1
        return state

    def _pre_batch(self, batch: TxBatch) -> bool:
        self.stats["batch_rx"] += 1
        # batch slots exist only under KNOWN node identities (peers or
        # self) — an unauthenticated key cannot open batch slots at all
        if (
            batch.origin not in self.mesh.by_sign
            and batch.origin != self.keypair.public
        ):
            logger.warning(
                "batch from unknown origin %s", batch.origin.hex()[:16]
            )
            return False
        slot = batch.slot
        if slot in self._delivered_batch_slots:
            return False
        if slot not in self._batch_slots and self._undelivered >= MAX_LIVE_SLOTS:
            self.stats["slots_dropped"] += 1
            return False
        chash = batch.content_hash()
        key = (BATCH, slot, chash)  # distinct key-space from per-tx gossip
        if key in self._gossip_seen:
            return False
        state = self._batch_slots.get(slot)
        if state is not None:
            if chash in state.contents:
                return False
            # same cap/NOTE discipline as _pre_gossip: capacity rejections
            # stay retryable, quorate content is always admitted
            if (
                len(state.contents) >= MAX_CONTENTS_PER_SLOT
                and not self._batch_content_wanted(state, chash)
            ):
                return False
        self._gossip_seen.add(key)
        return True

    def _batch_content_wanted(self, state: _BatchState, chash: bytes) -> bool:
        rv = state.ready_votes.get(chash)
        if rv is not None and len(rv.by_origin) >= max(self.ready_threshold, 1):
            return True
        ev = state.echo_votes.get(chash)
        return ev is not None and len(ev.by_origin) >= max(self.echo_threshold, 1)

    def _pre_batch_attestation(
        self, att: BatchAttestation, peer: Optional[Peer] = None
    ) -> bool:
        key = "batch_echo_rx" if att.phase == BATCH_ECHO else "batch_ready_rx"
        self.stats[key] += 1
        if att.origin not in self.mesh.by_sign:
            logger.warning(
                "batch attestation from unknown origin %s",
                att.origin.hex()[:16],
            )
            return False
        if len(att.bitmap) > MAX_BITMAP_BYTES or not att.bitmap:
            return False
        slot = (att.batch_origin, att.batch_seq)
        if slot in self._delivered_batch_slots:
            return False
        if slot not in self._batch_slots and self._undelivered >= MAX_LIVE_SLOTS:
            self.stats["slots_dropped"] += 1
            return False
        seen_key = (
            att.phase, att.origin, slot, att.batch_hash, att.bitmap,
            att.signature,
        )
        if seen_key in self._attest_seen:
            # duplicate on a fully-delivered (or retired — resolved is
            # resolved) batch slot: straggler retransmission beacon —
            # help (see _pre_attestation)
            dstate = self._batch_slots.get(slot)
            if dstate is not None and (
                dstate.delivered_all or dstate.retired
            ):
                self._help_batch_straggler(peer, slot, dstate)
            return False
        self._attest_seen.add(seen_key)
        state = self._batch_slots.get(slot)
        if state is not None:
            by_origin = (
                state.echo_by_origin
                if att.phase == BATCH_ECHO
                else state.ready_by_origin
            )
            bound = by_origin.get(att.origin)
            if bound is not None and bound != att.batch_hash:
                return False  # origin already voted for a different content
            # monotone bitmaps: a subset of already-counted bits is noise;
            # don't spend a verify on it
            votes = (
                state.echo_votes
                if att.phase == BATCH_ECHO
                else state.ready_votes
            ).get(att.batch_hash)
            if votes is not None:
                old = votes.by_origin.get(att.origin, 0)
                if int.from_bytes(att.bitmap, "little") & ~old == 0:
                    return False
        return True

    def _post_batch(self, batch: TxBatch, entry_oks) -> None:
        # phase segments are chained (each add() returns the next t0) so
        # echo_apply / entry_registry / ready_deliver stay disjoint —
        # their sum never double-counts a nanosecond of this call
        ph = self.phases
        t0 = ph.t() if ph is not None else 0
        slot = batch.slot
        if slot in self._delivered_batch_slots:
            return
        chash = batch.content_hash()
        state = self._new_or_existing_batch_slot(slot)
        if chash in state.contents:
            return
        if (
            len(state.contents) >= MAX_CONTENTS_PER_SLOT
            and not self._batch_content_wanted(state, chash)
        ):
            self._gossip_seen.discard((BATCH, slot, chash))
            return
        state.contents[chash] = batch
        # the real entry count is now known: CLAMP nbits to the widest
        # known content rather than only growing it — oversized
        # attestation bitmaps received before any content landed must not
        # leave phantom entry positions behind (positions >= count can
        # never deliver, but could spuriously quorate and trigger content
        # pulls forever)
        state.nbits = max(b.count for b in state.contents.values())
        # murmur: relay the batch to everyone
        self.mesh.broadcast(batch.encode())
        # sieve, batched: echo only the FIRST batch content for this slot,
        # endorsing exactly the entries whose client signature verified
        # AND whose (sender, seq) registry binding is unbound-or-equal
        if state.echoed_hash is None:
            state.echoed_hash = chash
            bits = 0
            rejected = 0
            if ph is not None:
                t0 = ph.add("echo_apply", t0)
            for i, ok in enumerate(entry_oks):
                if not ok:
                    self.stats["invalid_sig"] += 1
                    rejected |= 1 << i  # locally RESOLVED: rejected
                    continue
                entry = batch.entry_bytes(i)
                ekey = (entry[:32], int.from_bytes(entry[32:36], "little"))
                bound = self._entry_registry.get(ekey)
                if bound is None:
                    self._entry_registry.put(ekey, entry)
                elif bound != entry:
                    # conflicting content already endorsed: resolved too
                    rejected |= 1 << i
                    continue
                bits |= 1 << i
                if self.trace is not None:
                    self.trace.stamp(ekey, "echoed")
            if ph is not None:
                t0 = ph.add("entry_registry", t0)
            state.own_echo_bits[chash] = bits
            state.rejected_bits[chash] = rejected
            if self.recorder is not None:
                self.recorder.record(
                    "batch_echo",
                    (slot[1], bits.bit_count(), rejected.bit_count()),
                )
            if bits:
                self._send_batch_attestation(
                    BATCH_ECHO, slot, chash, bits, batch.count
                )
                if self.overlap_ready and state.ready_hash is None:
                    # [wan] phase piggyback, batched plane: bind the
                    # slot's single Ready hash now and ready exactly the
                    # entries just echoed; _advance_batch later tops up
                    # ready_sent_bits cumulatively as more entries
                    # quorate (to_ready masks off these initial bits)
                    state.ready_hash = chash
                    state.ready_sent_bits |= bits
                    if self.trace is not None:
                        self._stamp_batch_marker(batch, bits, "ready_sent")
                    self._send_batch_attestation(
                        BATCH_READY, slot, chash, bits, batch.count
                    )
        if ph is not None:
            t0 = ph.add("echo_apply", t0)
        self._advance_batch(slot, state, chash)
        self._maybe_retire_batch(slot, state)
        if ph is not None:
            ph.add("ready_deliver", t0)

    def _post_batch_attestation(self, att: BatchAttestation) -> None:
        ph = self.phases
        t0 = ph.t() if ph is not None else 0
        slot = (att.batch_origin, att.batch_seq)
        if slot in self._delivered_batch_slots:
            return
        state = self._new_or_existing_batch_slot(slot)
        by_origin = (
            state.echo_by_origin
            if att.phase == BATCH_ECHO
            else state.ready_by_origin
        )
        bound = by_origin.get(att.origin)
        if bound is not None and bound != att.batch_hash:
            return
        by_origin[att.origin] = att.batch_hash
        votes_map = (
            state.echo_votes if att.phase == BATCH_ECHO else state.ready_votes
        )
        votes = votes_map.get(att.batch_hash)
        if votes is None:
            votes = votes_map[att.batch_hash] = _BatchVotes()
        nbits = len(att.bitmap) * 8
        bits = int.from_bytes(att.bitmap, "little")
        if state.contents:
            # Clamp the claimed width to the batch's REAL entry count once
            # any slot content is known: bits at positions >= count are
            # phantom — they can never deliver, and without the clamp they
            # inflate state.nbits and the vote counts, spuriously quorate,
            # and drive pointless content pulls.
            known = state.contents.get(att.batch_hash)
            count = (
                known.count
                if known is not None
                else max(b.count for b in state.contents.values())
            )
            if nbits > count:
                nbits = count
                bits &= (1 << count) - 1
                if not bits:
                    return
        if votes.add(att.origin, bits, nbits):
            state.nbits = max(state.nbits, nbits)
            if ph is not None:
                t0 = ph.add("quorum_bitmap", t0)
            self._advance_batch(slot, state, att.batch_hash)
            self._maybe_retire_batch(slot, state)
            if ph is not None:
                ph.add("ready_deliver", t0)
        elif ph is not None:
            ph.add("quorum_bitmap", t0)

    def _send_batch_attestation(
        self,
        phase: int,
        slot,
        chash: bytes,
        bits: int,
        nbits: int,
        peer: Optional[Peer] = None,
    ) -> None:
        """Sign and send our batch Echo/Ready — broadcast by default,
        targeted when ``peer`` is given (straggler help)."""
        floor = self._floor_batch.get(slot[0])
        if floor is not None and slot[1] <= floor:
            # same no-post-restart-equivocation discipline as the per-tx
            # plane (_send_attestation); batch_seq is time-seeded per
            # origin so fresh batches always clear a restored floor
            self.floor_refusals += 1
            return
        if slot[1] > self._wm_batch.get(slot[0], 0):
            self._wm_batch[slot[0]] = slot[1]
        bitmap = bits.to_bytes((nbits + 7) // 8, "little")
        sig = self.keypair.sign(
            BatchAttestation.signing_bytes(phase, slot[0], slot[1], chash, bitmap)
        )
        if self.on_attest is not None:
            self.on_attest(phase, slot[0], slot[1], chash)
        att = BatchAttestation(
            phase, self.keypair.public, slot[0], slot[1], chash, bitmap, sig
        )
        if self.recorder is not None:
            self.recorder.record(
                "tx", (phase, slot[1], 1 if peer is not None else 0)
            )
        if peer is not None:
            self.mesh.send(peer, att.encode())
        else:
            self.mesh.broadcast(att.encode())

    def _stamp_batch_marker(self, batch: TxBatch, bits: int, stage: str) -> None:
        """Stamp an order-free phase marker (obs/trace.py PHASE_MARKERS)
        on every set-bit entry of ``batch`` — unsampled keys cost one
        dict miss each."""
        entries = batch.entries()
        while bits:
            lsb = bits & -bits
            p = entries[lsb.bit_length() - 1]
            self.trace.stamp((p.sender, p.sequence), stage)
            bits ^= lsb

    def _advance_batch(self, slot, state: _BatchState, chash: bytes) -> None:
        """Drive per-entry phase transitions for one batch content."""
        batch = state.contents.get(chash)
        nbits = batch.count if batch is not None else state.nbits
        if nbits <= 0:
            return
        full = (1 << nbits) - 1
        ev = state.echo_votes.get(chash)
        rv = state.ready_votes.get(chash)
        # Degenerate thresholds (standalone node / explicit 0): no peer
        # quorum exists to carry the verification argument, so the gate
        # is this node's OWN endorsement bits — a full mask here would
        # deliver entries whose client signature FAILED (the per-tx
        # plane drops those at the verify stage; parity demands we do
        # too).
        if self.echo_threshold <= 0:
            echo_q = state.own_echo_bits.get(chash, 0)
        else:
            echo_q = _quorate_mask(
                ev.counts if ev is not None else _EMPTY_COUNTS,
                self.echo_threshold,
                nbits,
            )
        if self.ready_threshold <= 0:
            ready_q = echo_q
        else:
            ready_q = _quorate_mask(
                rv.counts if rv is not None else _EMPTY_COUNTS,
                self.ready_threshold,
                nbits,
            )
        # Ready an entry on its Echo quorum (sieve-deliver) OR on a full
        # Ready quorum (contagion amplification) — cumulative bitmap so a
        # late joiner always receives a superset of earlier attestations.
        # Slot-level binding (per-tx parity, _SlotState.ready_sent): this
        # node signs Ready for at most ONE content per slot — an honest
        # node must never be wire-indistinguishable from an equivocator.
        if self.trace is not None and batch is not None:
            new_eq = echo_q & ~state.echo_q_marked & full
            if new_eq:
                state.echo_q_marked |= new_eq
                self._stamp_batch_marker(batch, new_eq, "echo_quorum")
        wants_ready = (echo_q | ready_q) & full
        if state.ready_hash is None and wants_ready:
            state.ready_hash = chash
        if state.ready_hash == chash:
            to_ready = wants_ready & ~state.ready_sent_bits
            if to_ready:
                state.ready_sent_bits |= to_ready
                if self.trace is not None and batch is not None:
                    self._stamp_batch_marker(batch, to_ready, "ready_sent")
                self._send_batch_attestation(
                    BATCH_READY, slot, chash, state.ready_sent_bits, nbits
                )
        # deliver: entry-level Ready quorum, this node has cast its Ready
        # for the slot (per-tx parity: `... and state.ready_sent` — the
        # quorum needn't be for OUR content, amplification covers that),
        # content known, not yet delivered
        if state.ready_hash is None:
            return
        deliverable = ready_q & ~state.delivered_bits.get(chash, 0) & full
        if not deliverable:
            return
        if batch is None:
            # quorate but the gossip never landed here: pull the batch
            self._request_batch_content(slot, state, chash)
            return
        state.delivered_bits[chash] = (
            state.delivered_bits.get(chash, 0) | deliverable
        )
        if self.recorder is not None:
            # quorum edge: these entries just crossed their Ready quorum
            # (on the batched plane that IS the delivery condition)
            self.recorder.record(
                "batch_deliver", (slot[1], deliverable.bit_count())
            )
        entries = batch.entries()
        d = deliverable
        while d:
            lsb = d & -d
            i = lsb.bit_length() - 1
            p = entries[i]
            if self.trace is not None:
                # on the batched plane an entry's Ready quorum IS its
                # delivery condition, so the two stamps coincide here
                self.trace.stamp((p.sender, p.sequence), "ready_quorum")
                self.trace.stamp((p.sender, p.sequence), "delivered")
            self.delivered.put_nowait(p)
            self.stats["batch_entries_delivered"] += 1
            d ^= lsb
        if state.delivered_bits[chash] == (1 << batch.count) - 1:
            if not state.delivered_all:
                state.delivered_all = True
                # a retired slot already left the undelivered population
                if not state.retired:
                    self._undelivered -= 1
                self.stats["delivered"] += 1

    def _ready_quorate_bits(
        self, state: _BatchState, chash: bytes, nbits: int
    ) -> int:
        """Entries of ``chash`` holding a full Ready quorum — the
        deliverable set, mirroring _advance_batch's degenerate-threshold
        handling (thresholds <= 0 fall back to echo quorum / own bits)."""
        if self.ready_threshold <= 0:
            if self.echo_threshold <= 0:
                return state.own_echo_bits.get(chash, 0)
            ev = state.echo_votes.get(chash)
            return _quorate_mask(
                ev.counts if ev is not None else _EMPTY_COUNTS,
                self.echo_threshold,
                nbits,
            )
        rv = state.ready_votes.get(chash)
        return _quorate_mask(
            rv.counts if rv is not None else _EMPTY_COUNTS,
            self.ready_threshold,
            nbits,
        )

    def _maybe_retire_batch(self, slot, state: _BatchState) -> None:
        """Retire a batch slot that is complete-by-RESOLUTION: every
        ready-quorate entry is delivered and every remaining entry of the
        echoed content is locally resolved-rejected (invalid client
        signature or equivocation-registry conflict at echo time).

        Without retirement, a single never-deliverable poison entry held
        the slot "stalled" for SLOT_MAX_AGE — burning retransmission
        budget and firing network-wide stall kicks every GC pass (the
        byzantine amplification). A retired
        slot leaves the undelivered population immediately and compacts
        after DELIVERED_RETENTION like a delivered one. Retirement does
        NOT gate delivery: while the slot is retained, a late Ready
        quorum for a rejected entry still delivers it through
        _advance_batch (our local rejection is not the network's
        verdict); after compaction, recovery belongs to the ledger
        catchup plane — the same contract as any expired slot."""
        if state.delivered_all or state.retired:
            return
        chash = state.echoed_hash
        if chash is None:
            return  # no content echoed yet: nothing is resolved
        batch = state.contents.get(chash)
        if batch is None:
            return
        full = (1 << batch.count) - 1
        delivered = state.delivered_bits.get(chash, 0)
        rejected = state.rejected_bits.get(chash, 0)
        if (delivered | rejected) & full != full:
            return  # unresolved entries remain: genuinely in progress
        # every ready-quorate entry — on ANY content with votes, not just
        # the echoed one (an equivocating origin's sibling content could
        # quorate if enough peers echoed it first) — must be delivered
        for h in set(state.ready_votes) | {chash}:
            b = state.contents.get(h)
            nb = b.count if b is not None else state.nbits
            if self._ready_quorate_bits(
                state, h, nb
            ) & ~state.delivered_bits.get(h, 0):
                return
        state.retired = True
        self._undelivered -= 1
        self.stats["slots_retired"] += 1
        poison = rejected & ~delivered
        self.stats["poison_resolved"] += poison.bit_count()
        if self.recorder is not None:
            self.recorder.record(
                "slot_retire", (slot[1], poison.bit_count())
            )

    def _poison_blocked_only(self, state: _BatchState) -> bool:
        """True when every undelivered entry is one this node rejected at
        echo time and nothing quorate is missing: the network never
        endorsed the poison, so a catchup session cannot heal the slot
        and the stall signal must not fire for it. (Such a slot is
        normally retired by _maybe_retire_batch; this guards the GC's
        stall classification in the window before retirement settles.)"""
        chash = state.echoed_hash
        if chash is None:
            return False
        batch = state.contents.get(chash)
        if batch is None:
            return False
        full = (1 << batch.count) - 1
        undelivered = full & ~state.delivered_bits.get(chash, 0)
        if undelivered & ~state.rejected_bits.get(chash, 0):
            return False  # an unresolved entry genuinely awaits quorum
        for h in set(state.ready_votes) | {chash}:
            b = state.contents.get(h)
            nb = b.count if b is not None else state.nbits
            if self._ready_quorate_bits(
                state, h, nb
            ) & ~state.delivered_bits.get(h, 0):
                return False
        return True

    def _on_batch_request(
        self, peer: Optional[Peer], req: BatchContentRequest
    ) -> None:
        """Serve a peer's batch content pull (channel-authenticated)."""
        self.stats["content_req_rx"] += 1
        if peer is None:
            return
        state = self._batch_slots.get((req.batch_origin, req.batch_seq))
        if state is None:
            return
        batch = state.contents.get(req.batch_hash)
        if batch is not None:
            self.stats["content_served"] += 1
            self.mesh.send(peer, batch.encode())

    def _request_batch_content(
        self, slot, state: _BatchState, chash: bytes
    ) -> None:
        now = self.clock.monotonic()
        if now - state.content_requested_at < REQUEST_RETRY:
            return
        state.content_requested_at = now
        self.stats["content_req_tx"] += 1
        frame = BatchContentRequest(slot[0], slot[1], chash).encode()
        rv = state.ready_votes.get(chash)
        targets = [
            self.mesh.by_sign[origin]
            for origin in (rv.by_origin if rv is not None else ())
            if origin in self.mesh.by_sign
        ]
        if targets:
            for peer in targets:
                self.mesh.send(peer, frame)
        else:
            self.mesh.broadcast(frame)

    # -- durability (store manifest round-trip, at2_node_tpu/store/) ------

    def part_delivered_batches(self, limit: int = 16) -> list:
        """The batch slots still held with no content fully delivered,
        oldest first, each with its entries, what was delivered and
        rejected here and the votes seen: where a stalled run stopped
        (``/debugz`` ``plane_slots``)."""
        def most_bits(by_hash: dict) -> int:
            return max((bin(b).count("1") for b in list(by_hash.values())),
                       default=0)

        def origins(votes: dict) -> dict:
            return {h.hex()[:12]: len(v.by_origin)
                    for h, v in list(votes.items())}

        now = self.clock.monotonic()
        rows = []
        # list() copies in one step: a thread shard may add slots meanwhile
        for (origin, bseq), st in list(self._batch_slots.items()):
            if st.delivered_all or st.retired:
                continue
            rows.append({
                "origin": origin.hex()[:16],
                "batch_seq": bseq,
                "age_s": round(now - st.created, 3),
                "entries": st.nbits,
                "contents": len(st.contents),
                "echoed": st.echoed_hash is not None,
                "delivered": most_bits(st.delivered_bits),
                "rejected": most_bits(st.rejected_bits),
                "ready_sent": bin(st.ready_sent_bits).count("1"),
                "echo_origins": origins(st.echo_votes),
                "ready_origins": origins(st.ready_votes),
            })
        rows.sort(key=lambda r: -r["age_s"])
        return rows[:limit]

    def export_watermarks(self) -> dict:
        """Per-origin max-attested slots, both planes — persisted in the
        store manifest on every flush."""
        # list() copies in one step: a thread shard may add keys meanwhile
        return {
            "tx": {k.hex(): v for k, v in list(self._wm_tx.items())},
            "batch": {k.hex(): v for k, v in list(self._wm_batch.items())},
        }

    def restore_watermarks(self, doc: dict) -> None:
        """Install pre-crash watermarks as signing floors (and re-seed
        the live watermarks so the next flush persists at least them)."""
        for hx, seq in (doc.get("tx") or {}).items():
            key = bytes.fromhex(hx)
            self._floor_tx[key] = int(seq)
            self._wm_tx[key] = max(self._wm_tx.get(key, 0), int(seq))
        for hx, seq in (doc.get("batch") or {}).items():
            key = bytes.fromhex(hx)
            self._floor_batch[key] = int(seq)
            self._wm_batch[key] = max(self._wm_batch.get(key, 0), int(seq))

    # -- state transitions (synchronous; no awaits) -----------------------

    def _send_attestation(
        self,
        phase: int,
        sender: bytes,
        sequence: int,
        chash: bytes,
        peer: Optional[Peer] = None,
    ) -> None:
        """Sign and send our Echo/Ready — broadcast by default, targeted
        when ``peer`` is given (straggler help)."""
        floor = self._floor_tx.get(sender)
        if floor is not None and sequence <= floor:
            # no-post-restart-equivocation: this slot may hold a
            # pre-crash vote from this node that peers already counted;
            # signing again (possibly for different content) is the one
            # thing a restarted node must never do
            self.floor_refusals += 1
            return
        if sequence > self._wm_tx.get(sender, 0):
            self._wm_tx[sender] = sequence
        sig = self.keypair.sign(Attestation.signing_bytes(phase, sender, sequence, chash))
        if self.on_attest is not None:
            self.on_attest(phase, sender, sequence, chash)
        if phase == READY and self.trace is not None:
            # order-free phase marker (obs/trace.py PHASE_MARKERS): with
            # overlap_ready this lands BEFORE echo_quorum
            self.trace.stamp((sender, sequence), "ready_sent")
        att = Attestation(phase, self.keypair.public, sender, sequence, chash, sig)
        if self.recorder is not None:
            self.recorder.record(
                "tx", (phase, sequence, 1 if peer is not None else 0)
            )
        if peer is not None:
            self.mesh.send(peer, att.encode())
        else:
            self.mesh.broadcast(att.encode())

    def _advance(self, slot: Slot, state: _SlotState, chash: bytes) -> None:
        """Drive the slot's phase transitions for one content hash."""
        if state.delivered:
            return
        # sieve-deliver: enough echoes for this content (quorum-driven; the
        # per-origin single-vote rule above makes two quorums impossible
        # whenever echo_threshold > n_peers/2)
        if (
            not state.sieve_delivered
            and len(state.echoes[chash]) >= self.echo_threshold
        ):
            state.sieve_delivered = True
            if self.trace is not None:
                self.trace.stamp(slot, "echo_quorum")
            if self.recorder is not None:
                self.recorder.record("echo_quorum", (slot[1],))
            if not state.ready_sent:
                state.ready_sent = True
                state.ready_hash = chash
                self._send_attestation(READY, slot[0], slot[1], chash)
        # contagion amplification: a full Ready quorum convinces a node
        # that missed the Echo phase to join (keeps delivery total)
        if (
            not state.ready_sent
            and len(state.readies[chash]) >= max(self.ready_threshold, 1)
        ):
            state.ready_sent = True
            state.ready_hash = chash
            self._send_attestation(READY, slot[0], slot[1], chash)
        # deliver: enough readies AND the payload content is known
        if len(state.readies[chash]) >= self.ready_threshold and state.ready_sent:
            if self.trace is not None:
                # slot IS the tracer key (sender, sequence)
                self.trace.stamp(slot, "ready_quorum")
            if chash in state.contents:
                state.delivered = True
                self._undelivered -= 1
                self.stats["delivered"] += 1
                if self.trace is not None:
                    self.trace.stamp(slot, "delivered")
                if self.recorder is not None:
                    self.recorder.record("ready_quorum", (slot[1],))
                self.delivered.put_nowait(state.contents[chash])
            else:
                # quorum reached but the gossip never landed here: pull the
                # payload from the voters (totality catch-up)
                self._request_content(slot, state, chash)

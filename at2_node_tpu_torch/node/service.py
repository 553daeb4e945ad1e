"""The AT2 node: broadcast wiring + delivery→commit loop + gRPC surface.

Counterpart of ``at2_node_tpu/node/service.py``.

Equivalent of the reference's `rpc::Service`
(`at2-node/src/bin/server/rpc.rs:61-344`): bring up the encrypted
node mesh, run the three-phase broadcast with the configured Verifier,
drain deliveries into the ledger with the reference's exact ordering /
retry / TTL semantics, and serve the four `at2.AT2` RPCs to clients.

Delivery→commit loop parity (`rpc.rs:149-211`):

* delivered payloads enter a min-heap ordered by (sequence, sender,
  content) with their arrival time (`rpc.rs:163-173`);
* the heap is drained to a fixpoint — a pass that commits anything
  re-sorts and retries, so out-of-order sequences gap-fill
  (`rpc.rs:176-208`);
* only sequence/balance failures (`AccountModificationError`) are retried;
  anything else is logged and dropped (`rpc.rs:195-205`);
* a payload older than ``TRANSACTION_TTL`` (60 s) is marked Failure —
  and then still falls through to processing, so it can later flip to
  Success: the reference has no `continue` after its TTL branch
  (`rpc.rs:183-193`), and that observable quirk is kept deliberately;
* leftovers carry into the next delivery batch (`rpc.rs:207`).

``[plane] shards > 1`` runs the sharded broadcast plane
(broadcast/shards.py) under the ``inline``, ``thread`` or ``process``
executor, ``[store] dir`` the durable sharded store (store/) and
``[finality] enabled`` the quorum certificates (finality/), as in the
reference. Co-signatures are checked on the host through OpenSSL
(finality/scheme.py), as the reference's are. With ``[verifier]
kind = "cuda"`` every client signature goes through the hand-written
kernel on the card, and so does every payload, Echo and Ready signature
under the monolithic plane and the ``inline`` and ``thread`` executors;
a ``process`` shard verifies its plane signatures on the host, in its
own worker process, as the reference's does.
"""

from __future__ import annotations

import asyncio
import hashlib
import heapq
import json
import logging
import secrets
from typing import Dict, List, Optional, Set, Tuple

import grpc

from ..broadcast.messages import (
    MAX_BATCH_ENTRIES,
    CertSig,
    DirectoryAnnounce,
    HistoryBatch,
    HistoryIndex,
    HistoryIndexRequest,
    HistoryRequest,
    Payload,
    StateBeacon,
    TxBatch,
)
from ..broadcast.stack import Broadcast
from ..crypto.keys import verify_one
from ..crypto.verifier import Verifier
from ..finality import CertAssembler
from ..ledger import checkpoint as ckpt
from ..ledger import history as hist
from ..ledger.accounts import AccountModificationError, Accounts
from ..ledger.recent import RecentTransactions
from ..net.peers import Mesh, Peer
from ..net.webmux import PortMux
from ..obs.audit import FleetAuditor
from ..obs.profiler import (
    NO_SPANS,
    EventLoopLagProbe,
    PhaseAccounting,
    StackSampler,
    TraceSpans,
    build_info,
)
from ..obs.recorder import FlightRecorder
from ..obs.registry import Registry
from ..obs.slo import SloEngine, default_objectives
from ..obs.trace import REJECTED, TxTrace
from ..proto import at2_pb2 as pb
from ..proto import distill
from ..proto import finality_pb2 as fpb
from ..proto.rpc import At2Servicer, add_to_server
from ..types import (
    TRANSFER_SIG_TAG,
    ThinTransaction,
    TransactionState,
    rfc3339,
)
from ..store import RecoveryProgress, ShardedStore
from .config import Config
from .directory import ClientDirectory, DirectoryFullError
from .membership import MembershipManager
from .overload import OverloadController, format_shed_details

logger = logging.getLogger(__name__)

# Dedicated stats logger with its own INFO handler: operator-enabled stats
# must be visible even under the reference-parity WARN default
# (at2-node/src/bin/server/main.rs:94-99). Configured lazily by
# _enable_stats_logging so library users keep full control otherwise.
stats_logger = logging.getLogger("at2_node_tpu_torch.stats")

TRANSACTION_TTL = 60.0  # seconds, rpc.rs:35

# A catchup session holds at most this many candidate payloads (bounds a
# byzantine peer flooding HistoryBatch junk into an open session).
MAX_SESSION_PAYLOADS = 1 << 17

# Serving-side catchup budgets, per peer per second: a 9-byte
# HistoryIndexRequest triggers an O(ledger) frontier snapshot and a
# response of up to megabytes, and a 49-byte HistoryRequest up to
# MAX_RANGE payload encodes — without a budget an authenticated byzantine
# peer has a huge amplification lever into the broadcast workers. A real
# catchup session needs ONE index and one range request per gapped
# sender; the budgets are far above that and refill every second, so a
# throttled legitimate requester just retries next session.
SERVE_IDX_PER_SEC = 4
SERVE_ROWS_PER_SEC = 4 * 4096

# Distinct ingress sources tracked by the admission rate limiter (one
# token bucket per gRPC peer string). A source evicted at the cap simply
# starts a fresh, full bucket — the cap bounds memory, not correctness.
ADMISSION_SOURCES_CAP = 4096

# Recently-ingested (client_id, sequence) pairs remembered by the
# distilled-batch path: a byzantine broker can replay an entry across
# frames (WITHIN a frame duplicates are unrepresentable — the wire's
# delta coding is strictly increasing). A replay that slips past the cap
# is still harmless — the ledger's per-account sequence gate rejects it
# at commit — so this memory only keeps replays off the broadcast plane.
DISTILL_SEEN_CAP = 1 << 16

class _CatchupSession:
    """In-flight catchup state: peers' frontiers and served payloads,
    grouped for quorum confirmation. Filled synchronously by the
    broadcast workers' handler; consumed by `Service._catchup_once`."""

    __slots__ = ("nonce", "per_peer_cap", "indexes", "votes", "payloads",
                 "stored_by_peer", "prechecked")

    def __init__(self, nonce: int, n_peers: int) -> None:
        self.nonce = nonce
        # The storage cap is per SENDING peer: one byzantine peer
        # flooding junk payloads exhausts only its own share and can
        # neither evict nor block honest peers' copies. Vote accrual on
        # already-stored keys is never capped (votes are one set entry,
        # and blocking them would let the flooder starve quorum).
        self.per_peer_cap = max(1, MAX_SESSION_PAYLOADS // max(1, n_peers))
        # peer sign key -> ((sender, last_seq), ...)
        self.indexes: Dict[bytes, tuple] = {}
        # ((sender, seq), content_hash) -> peer sign keys vouching for it
        self.votes: Dict[tuple, Set[bytes]] = {}
        # ((sender, seq), content_hash) -> the payload itself
        self.payloads: Dict[tuple, Payload] = {}
        self.stored_by_peer: Dict[bytes, int] = {}
        # [wan] verify_ahead verdict cache: vote_key -> signature ok,
        # filled speculatively during the quorum wait so the post-quorum
        # apply only verifies what the speculation missed
        self.prechecked: Dict[tuple, bool] = {}


# module-level latch: repeated Service.start in one process (tests, bench
# tools, multi-node harnesses) must configure the stats logger exactly
# once — the handler check alone would re-attach after a caller's
# removeHandler/clear, silently doubling every line
_stats_logging_enabled = False


def _enable_stats_logging() -> None:
    global _stats_logging_enabled
    if _stats_logging_enabled:
        return
    _stats_logging_enabled = True
    if not stats_logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(message)s")
        )
        stats_logger.addHandler(handler)
        stats_logger.setLevel(logging.INFO)
        stats_logger.propagate = False


class Service(At2Servicer):
    """One AT2 node. `await Service.start(config)`, then `serve_forever`."""

    # the node's torch.profiler trace and its spans while profile_dir
    # traces (obs/profiler.py TraceSpans); the shared no-op otherwise
    spans = NO_SPANS
    # the served loop's BusySelector (cli/server.py), read by /metrics
    loop_selector = None

    def __init__(self, config: Config, clock=None) -> None:
        from ..clock import SYSTEM_CLOCK

        self.config = config
        self.clock = SYSTEM_CLOCK if clock is None else clock
        self.accounts = Accounts()
        self.recent = RecentTransactions()
        # Per-Service metrics registry (obs/registry.py): every counter,
        # gauge, and histogram this node exposes lives here, and
        # snapshot_stats() / the GET endpoints are pure views over it.
        # Per-instance, not process-global: tests and bench tools run
        # many Services in one process.
        self.registry = Registry()
        obs = config.observability
        self.tx_trace = TxTrace(
            self.registry,
            sample_every=obs.trace_sample,
            cap=obs.trace_cap,
            done_cap=obs.trace_done_cap,
            clock=self.clock,
        )
        # protocol flight recorder (obs/recorder.py): always on (bounded
        # ring), dumped via /debugz, auto-snapshotted on anomalies
        # (healthz flipping to degraded, a stall kick)
        self.recorder = FlightRecorder(
            cap=obs.recorder_cap, clock=self.clock
        )
        self.registry.gauge(
            "recorder_events", "protocol events ever flight-recorded",
            fn=lambda: self.recorder.recorded,
        )
        self.registry.gauge(
            "recorder_snapshots", "anomaly snapshots captured",
            fn=lambda: self.recorder.snapshots_taken,
        )
        self._health_was_ok = True
        self._started_at = self.clock.monotonic()
        self._started_wall = self.clock.wall()
        # continuous profiler (obs/profiler.py). Phase accounting is
        # plain counters/histograms — safe to arm everywhere, sim
        # included (registry values never feed the wire trace). The
        # stack sampler is a REAL thread and the lag-probe loop a
        # standing timer, so neither auto-starts here: the sampler runs
        # on demand (/profilez?start, the healthz degraded edge, bench
        # harnesses) and start() spawns the lag loop only on served
        # (real-time) nodes.
        self.phases = (
            PhaseAccounting(self.registry) if obs.phase_accounting else None
        )
        self.sampler = StackSampler(
            hz=obs.profiler_hz, max_nodes=obs.profiler_max_nodes
        )
        self.lag_probe = (
            EventLoopLagProbe(
                self.registry, self.clock, interval=obs.lag_probe_interval
            )
            if obs.lag_probe_interval > 0
            else None
        )
        self._config_hash = hashlib.sha256(
            config.dumps().encode()
        ).hexdigest()[:12]
        # SLO engine (obs/slo.py): declarative objectives from the [slo]
        # config table, probed periodically (start() spawns the loop on
        # served nodes), served at GET /sloz, folded into /healthz.
        # Constructed unconditionally — snapshot_stats()'s key set must
        # not depend on traffic or config — the probe task is what the
        # enabled flag gates.
        slo_cfg = config.slo
        self.slo = SloEngine(
            default_objectives(
                latency_p99_ms=slo_cfg.latency_p99_ms,
                throughput_floor_tps=slo_cfg.throughput_floor_tps,
                rejection_ratio_max=slo_cfg.rejection_ratio_max,
                stall_budget=slo_cfg.stall_budget,
            ),
            windows=(slo_cfg.fast_window, slo_cfg.slow_window),
            clock=self.clock,
        )
        self._slo_task: Optional[asyncio.Task] = None
        self._audit_task: Optional[asyncio.Task] = None
        # the probe reads the commit-latency histogram TxTrace already
        # feeds; get-or-create by name returns that same instrument
        self._slo_hist = self.registry.histogram("tx_ingress_to_committed")
        self.registry.gauge(
            "slo_breaching", "objectives burning above 1.0 in every window",
            fn=lambda: len(self.slo.breaching()),
        )
        self.registry.gauge(
            "slo_samples", "probe samples held by the SLO engine",
            fn=lambda: self.slo.sample_count,
        )
        # per-objective fast-window burn as scrapeable gauges (the signal
        # /sloz buried in JSON; also the overload controller's SLO input)
        self.registry.register_provider(
            "slo_burn_", lambda: self.slo.fast_burns()
        )
        # closed-loop overload controller (node/overload.py, config
        # [overload]): constructed unconditionally so /statusz always
        # carries a pressure block, fully inert while disabled — no
        # samples, no sheds, byte-identical wire schedules
        self.overload = OverloadController(
            config.overload,
            self.clock,
            verifier_stats=self._verifier_stats,
            stage_hists=self._overload_stage_hists,
            backlog=self._plane_backlog,
            tail_age=self._commit_tail_age,
            burns=lambda: self.slo.fast_burns(),
            on_transition=self._overload_transition,
        )
        self.overload_stats = self.registry.counter_group(
            (
                "overload_shed_requests",
                "overload_shed_entries",
                "overload_shed_distilled",
            )
        )
        self.registry.gauge(
            "overload_pressure", "smoothed overload pressure score",
            fn=lambda: self.overload.pressure,
        )
        self.registry.gauge(
            "overload_level",
            "overload ladder position (0 normal .. 3 saturated)",
            fn=lambda: float(self.overload.level),
        )
        # durable sharded store (store/sharded.py): None when [store] dir
        # is unset — the node then falls back to the legacy monolithic
        # checkpoint (ledger/checkpoint.py), exactly as before
        self.store: Optional[ShardedStore] = None
        self._store_task: Optional[asyncio.Task] = None
        # recovery state machine (store/recovery.py): starts "cold"; a
        # store-backed restart walks loading_segments -> replaying_wal ->
        # catchup -> live and /healthz reports "recovering" on the way
        self.recovery = RecoveryProgress()
        # epoch-based membership (node/membership.py): None when no
        # [membership] admin key is configured
        self.membership: Optional[MembershipManager] = None
        self._membership_task: Optional[asyncio.Task] = None
        self.verifier: Optional[Verifier] = None
        self.mesh: Optional[Mesh] = None
        self.broadcast: Optional[Broadcast] = None
        self._grpc_server: Optional[grpc.aio.Server] = None
        self._mux: Optional[PortMux] = None
        self._delivery_task: Optional[asyncio.Task] = None
        self._stats_task: Optional[asyncio.Task] = None
        self._checkpoint_task: Optional[asyncio.Task] = None
        self._owns_verifier = True
        self.committed = 0  # payloads committed to the ledger
        # leftovers: (key, arrival, tiebreak, payload) carried across batches
        self._heap: List[tuple] = []
        self._push_count = 0  # monotonic heap tiebreaker
        self._heap_keys: set = set()  # keys pending, _heap or _parked (dedup)
        # leftovers a pass could not commit, by sender (see _park)
        self._parked: Dict[bytes, list] = {}
        self._parked_n = 0
        # the delivery loop, catchup task, and close() all drain the heap;
        # serialize the fixpoint passes so two drains never interleave
        self._drain_lock = asyncio.Lock()
        # heap keys that entered via catchup: their TTL expiry must NOT
        # write FAILURE into the recent ring — the slot was committed
        # network-wide (quorum-confirmed), so a local gap-block is an
        # "unresolved" condition, not a failed transfer
        self._catchup_keys: set = set()
        # commits of catchup-keyed payloads: the runner's progress
        # signal. The global `committed` counter won't do — unrelated
        # live traffic keeps it rising and would reset the backoff
        # forever on a beyond-horizon gap.
        self._catchup_commits = 0
        self._closing = False
        # ledger-history catchup (the reference's open roadmap item,
        # README.md:53): serving store + at most one in-flight session
        self.history = hist.CommittedHistory(config.catchup.history_cap)
        self._catchup_session: Optional[_CatchupSession] = None
        self._catchup_task: Optional[asyncio.Task] = None
        # registry-backed with the dict call-site surface intact
        # (obs/registry.py CounterGroup docstring)
        self.catchup_stats = self.registry.counter_group(
            (
                "catchup_sessions",
                "catchup_applied",
                "catchup_idx_req_rx",
                "catchup_hist_req_rx",
                "catchup_served",
                "catchup_throttled",
                # [wan] verify_ahead: payloads signature-checked during
                # the quorum wait instead of after it
                "catchup_preverified",
            )
        )
        # per-(peer, kind) serving budgets: [window_start, used]
        self._serve_budget: Dict[tuple, list] = {}
        self._idx_serve_offset = 0  # rotating HistoryIndex window
        # ingress batcher (broadcast/stack.py batched plane): SendAsset
        # payloads accumulate here and flush as ONE TxBatch slot on size
        # or window. batch_seq is time-seeded so a restarted node never
        # reuses a (node, batch_seq) slot peers may still remember (batch
        # slots need uniqueness, not continuity — the ledger's per-client
        # sequence gate is what orders transfers).
        self._batch_buf: List[Payload] = []
        self._batch_flush_task: Optional[asyncio.Task] = None
        self._batch_seq = int(self.clock.wall() * 1000) << 20
        # catchup session nonce source: secrets by default; the simulator
        # swaps in a seeded rng so session frames replay bit-identically
        self._nonce_bits = secrets.randbits
        # ingress admission (config [admission]): per-source token
        # buckets charged ONLY for entries that fail pre-verification —
        # source -> [tokens, refill_stamp]
        self._admission_buckets: Dict[str, list] = {}
        # Register charges its own per-source bucket (config [admission]
        # register_limit/register_window): registrations grow every
        # node's directory and checkpoint PERMANENTLY, so unlike the
        # fail-only signature bucket each new assignment costs a token.
        self._register_buckets: Dict[str, list] = {}
        self.admission_stats = self.registry.counter_group(
            ("rejected_at_ingress", "admission_throttled")
        )
        # broker ingress tier (node/directory.py, proto/distill.py):
        # ranks come from the sorted set of ALL node sign keys — every
        # correctly-configured node derives the same ranking, so id
        # strides never collide without any coordination round
        ranked = sorted(
            [config.sign_key.public] + [p.sign_public for p in config.nodes]
        )
        self.directory = ClientDirectory(
            rank=ranked.index(config.sign_key.public), total=len(ranked)
        )
        self._node_ranks = {key: i for i, key in enumerate(ranked)}
        self._distill_seen: Dict[Tuple[int, int], None] = {}
        self.distill_stats = self.registry.counter_group(
            ("distilled_batches_rx", "directory_misses", "dedup_drops")
        )
        self.registry.gauge(
            "directory_size", "client-directory mappings known",
            fn=lambda: len(self.directory),
        )
        # commit progress + queue depths as lazy gauges; transport /
        # verifier stats() dicts as prefixed providers — together these
        # make registry.snapshot() reproduce the exact key families the
        # hand-rolled snapshot_stats() used to assemble
        self.registry.gauge(
            "committed", "payloads committed to the ledger",
            fn=lambda: self.committed,
        )
        self.registry.gauge(
            "pending", "payloads parked in the commit retry heap",
            fn=self._pending_count,
        )
        self.registry.gauge(
            "history_retained", "payloads retained for peer catchup",
            fn=lambda: len(self.history),
        )
        self.registry.register_provider("verifier_", self._verifier_stats)
        self.registry.register_provider(
            "event_loop_",
            lambda: (
                {"busy_ns": self.loop_selector.busy_ns}
                if self.loop_selector is not None
                else {}
            ),
        )
        # verifier per-stage latency as REAL histograms (bucket/sum/count
        # on /metrics — the plain provider above only carries its stats()
        # spot values), so external scrapers can aggregate across nodes
        self.registry.register_histogram_provider(
            "verifier_stage_", self._verifier_stage_hists
        )
        self.registry.register_provider(
            "mesh_",
            lambda: self.mesh.stats() if self.mesh is not None else {},
        )
        self.registry.register_provider(
            "rpc_",
            lambda: self._mux.stats() if self._mux is not None else {},
        )
        self.registry.register_provider("store_", self._store_stats_view)
        self.registry.register_provider(
            "membership_",
            lambda: (
                self.membership.stats() if self.membership is not None else {}
            ),
        )
        self.store_stats = self.registry.counter_group(
            ("store_flushes", "store_segments_written", "store_segment_bytes")
        )
        # Fleet consistency auditor (obs/audit.py): the additive digest
        # lanes live on Accounts/ClientDirectory (maintained at the
        # mutation sites); the auditor owns the chain head, the local
        # audit-point history, peer-beacon comparison, and divergence
        # attribution. Beacon emission: every `audit_every` commits
        # (_commit_tail, deterministic under sim) plus a wall timer on
        # served nodes (start()).
        self.auditor = FleetAuditor(
            self.accounts.digest, history_cap=obs.audit_history,
            clock=self.clock,
        )
        # sim failpoint (sim/campaign.py planted_divergence_episode):
        # callable (payload) -> balance delta misapplied to the
        # recipient after a successful transfer; None = off
        self.ledger_failpoint = None
        self.registry.register_provider("audit_", self.auditor.stats)
        self.registry.gauge(
            "audit_divergence",
            "1 when the auditor holds a confirmed peer divergence",
            fn=lambda: 1 if self.auditor.divergence is not None else 0,
        )
        self.registry.gauge(
            "audit_commits", "commits folded into the local digest chain",
            fn=lambda: self.auditor.commits,
        )
        # Finality certificates (finality/, config [finality]): the
        # assembler collects kind-16 co-signatures into quorum certs.
        # None when the table is absent/disabled — the subsystem is
        # fully inert and the wire schedule stays byte-identical.
        fin = config.finality
        self.certs: Optional[CertAssembler] = None
        if fin.enabled:
            self.certs = CertAssembler(
                list(self._node_ranks),
                epoch=0,
                scheme=fin.scheme,
                quorum=fin.quorum,
                history=fin.history,
            )
            self.registry.register_provider("finality_", self.certs.stats)
            self.registry.gauge(
                "finality_equivocation",
                "1 when the assembler holds a latched cert equivocation",
                fn=lambda: (
                    1 if self.certs.equivocation is not None else 0
                ),
            )

    # -- lifecycle --------------------------------------------------------

    @staticmethod
    async def start(
        config: Config,
        verifier: Optional[Verifier] = None,
        *,
        clock=None,
        mesh_factory=None,
        serve_rpc: bool = True,
    ) -> "Service":
        """Bring up one node. ``verifier`` injects a SHARED verifier (the
        BASELINE config-5 shape: many nodes feeding one device pool —
        `parallel.pool.PoolVerifier`); the caller keeps ownership and
        closes it after every sharing node is down.

        ``clock`` / ``mesh_factory`` / ``serve_rpc`` are the simulator's
        seams (the deterministic simulator): an injected virtual clock, a transport
        factory ``(config, on_frame) -> Mesh``-compatible object replacing
        the real socket mesh, and a switch to skip the gRPC/PortMux
        surface (the sim drives the handlers directly). Defaults preserve
        production behavior exactly."""
        service = Service(config, clock=clock)
        if verifier is not None:
            service.verifier = verifier
            service._owns_verifier = False
        else:
            service.verifier = config.verifier.make()
            # Compile the device verifier BEFORE binding the RPC port: a
            # node is not ready while its first signature check would stall
            # seconds behind the kernel's build (readiness probes poll
            # the port — tests/shell/lib.sh, reference tests/cli.rs:119-131).
            try:
                await service.verifier.warmup()
            except Exception:
                await service.verifier.close()
                raise
        # Resume ledger state BEFORE joining the network: peers judge this
        # node by its per-account sequence answers from the first message.
        try:
            await service._restore_state()
        except Exception:
            if service._owns_verifier:
                await service.verifier.close()
            raise
        # Everything past the verifier is brought up under one guard:
        # close() tolerates partially-initialized state, so ANY bring-up
        # failure (mesh bind, broadcast start, profiler, grpc/mux bind)
        # releases the warmed-up verifier, mesh tasks, and background
        # loops instead of leaking them.
        try:
            on_frame = lambda peer, frame: service.broadcast.on_frame(peer, frame)  # noqa: E731
            if mesh_factory is not None:
                service.mesh = mesh_factory(config, on_frame)
            else:
                service.mesh = Mesh(
                    config.node_address,
                    config.network_key,
                    config.nodes,
                    on_frame=on_frame,
                    clock=service.clock,
                    region_fanout=config.wan.region_fanout,
                    region=config.wan.region,
                    capture_cap=config.observability.capture_cap,
                )
            plane_cfg = config.plane
            if plane_cfg.shards > 1:
                # sharded broadcast plane (broadcast/shards.py). Under a
                # non-system clock the executor is forced inline: the sim
                # owns the schedule and shard threads/processes would
                # race it — inline keeps shards=N byte-identical on the
                # wire regardless of the configured executor (the CI
                # campaign-hash sweep pins this across all three).
                from ..broadcast.shards import ShardedPlane
                from ..clock import SYSTEM_CLOCK

                executor = plane_cfg.executor
                if service.clock is not SYSTEM_CLOCK:
                    executor = "inline"
                service.broadcast = ShardedPlane(
                    config.sign_key,
                    service.mesh,
                    service.verifier,
                    shards=plane_cfg.shards,
                    executor=executor,
                    workers=plane_cfg.workers,
                    ring_slots=plane_cfg.ring_slots,
                    ring_slot_bytes=plane_cfg.ring_slot_bytes,
                    echo_threshold=config.echo_threshold,
                    ready_threshold=config.ready_threshold,
                    registry=service.registry,
                    trace=service.tx_trace,
                    recorder=(
                        service.recorder if service.recorder.enabled else None
                    ),
                    clock=service.clock,
                    phases=service.phases,
                    overlap_ready=config.wan.overlap_ready,
                    worker_profiler=config.observability.profilez,
                    profiler_hz=config.observability.profiler_hz,
                    profiler_max_nodes=config.observability.profiler_max_nodes,
                )
            else:
                service.broadcast = Broadcast(
                    config.sign_key,
                    service.mesh,
                    service.verifier,
                    echo_threshold=config.echo_threshold,
                    ready_threshold=config.ready_threshold,
                    registry=service.registry,
                    trace=service.tx_trace,
                    recorder=(
                        service.recorder if service.recorder.enabled else None
                    ),
                    clock=service.clock,
                    phases=service.phases,
                    overlap_ready=config.wan.overlap_ready,
                )
            # flight-record the verifier's flush decisions too (duck-typed
            # attach; a SHARED verifier keeps its first owner's recorder)
            if (
                service.recorder.enabled
                and getattr(service.verifier, "recorder", ()) is None
            ):
                service.verifier.recorder = service.recorder
            # phase-account the verifier's flush decisions the same way
            # (a SHARED verifier keeps its first owner's seam)
            if (
                service.phases is not None
                and getattr(service.verifier, "phases", ()) is None
            ):
                service.verifier.phases = service.phases
            service.broadcast.catchup_handler = service._on_catchup
            service.broadcast.directory_handler = service._on_directory
            service.broadcast.beacon_handler = service._on_beacon
            service.broadcast.cert_handler = service._on_cert_sig
            if service.store is not None:
                # broadcast-safety floors: the slots this node attested
                # before the crash are fenced — a restarted node never
                # signs a conflicting echo/ready for them
                service.broadcast.restore_watermarks(service.store.watermarks)
            mcfg = config.membership
            if mcfg.admin_public:
                service.membership = MembershipManager(
                    admin_public=bytes.fromhex(mcfg.admin_public),
                    clock=service.clock,
                    grace=mcfg.grace,
                    epoch=service.store.epoch if service.store else 0,
                    mesh=service.mesh,
                    on_thresholds=service._on_thresholds,
                    own_sign_public=config.sign_key.public,
                )
                service.recovery.epoch = service.membership.epoch
                service.broadcast.config_handler = service._on_config_tx
            if config.catchup.enabled:
                # broadcast GC signal: a slot stalled past push-
                # retransmission recovers via the ledger-catchup plane
                # (peers replay the committed payload from history)
                service.broadcast.stall_handler = service._kick_catchup
            await service.mesh.start()
            await service.broadcast.start()
            service._delivery_task = asyncio.create_task(service._delivery_loop())

            # Rejoin catchup: a node starting into an existing network may
            # have missed committed history (crash without checkpoint, or
            # checkpoint lag); one session shortly after the mesh dials
            # re-converges the ledger without waiting for new traffic to
            # expose the gap.
            if config.catchup.enabled and service.mesh.peers:
                service._catchup_task = asyncio.create_task(
                    service._catchup_runner(initial_delay=config.catchup.after)
                )
            if service.recovery.state == "catchup" and not (
                config.catchup.enabled and service.mesh.peers
            ):
                # nothing to catch up FROM: a peerless (or catchup-
                # disabled) store restart is as live as it will ever be
                service.recovery.mark_live(service.clock.monotonic())

            # incremental store flush loop (config [store] flush_interval).
            # Like the SLO probe, only on SERVED nodes: the sim flushes
            # and sweeps explicitly at deterministic points instead.
            if (
                serve_rpc
                and service.store is not None
                and config.store.flush_interval > 0
            ):
                service._store_task = asyncio.create_task(
                    service._store_flush_loop(config.store.flush_interval)
                )
            if serve_rpc and service.membership is not None:
                service._membership_task = asyncio.create_task(
                    service._membership_loop()
                )

            # interval <= 0 means snapshot-on-shutdown only (consistent with
            # the observability convention where 0 disables the periodic
            # task). The legacy monolithic loop is superseded entirely by
            # the sharded store when [store] dir is configured.
            if (
                service.store is None
                and config.checkpoint.path
                and config.checkpoint.interval > 0
            ):
                service._checkpoint_task = asyncio.create_task(
                    service._checkpoint_loop(
                        config.checkpoint.path, config.checkpoint.interval
                    )
                )

            obs = config.observability
            if obs.stats_interval > 0:
                _enable_stats_logging()
                service._stats_task = asyncio.create_task(
                    service._stats_loop(obs.stats_interval)
                )
            # SLO probe loop only on SERVED nodes: the simulator runs
            # with serve_rpc=False and evaluates scenario cells offline
            # (sim adding a standing periodic timer would also blunt its
            # deadlock detection); live /sloz needs the samples.
            if serve_rpc and config.slo.enabled:
                service._slo_task = asyncio.create_task(
                    service._slo_loop(config.slo.probe_interval)
                )
            # event-loop lag probe loop: served nodes only, same reasoning
            # as the SLO probe (a standing timer under sim virtual time
            # would blunt SimScheduler's deadlock detection; sim tests
            # drive probe_once() manually instead)
            if serve_rpc and service.lag_probe is not None:
                service.lag_probe.start()
            # idle-fleet audit beacons: served nodes only, same reasoning
            # as the SLO probe (sim emission is commit-count triggered in
            # _commit_tail, keeping every sim schedule timer-free)
            if serve_rpc and config.observability.audit_interval > 0:
                service._audit_task = asyncio.create_task(
                    service._audit_beacon_loop(
                        config.observability.audit_interval
                    )
                )
            if obs.profile_dir:
                # CPU activity, and CUDA activity (the verifier's launches
                # and copies) when the verifier runs on the card; the
                # spans go to the monolithic plane and to the verifier,
                # whose first owner keeps them when it is shared
                spans = service.spans = TraceSpans.start(
                    getattr(service.verifier, "device", None)
                )
                if isinstance(service.broadcast, Broadcast):
                    service.broadcast.spans = spans
                if getattr(service.verifier, "spans", None) is NO_SPANS:
                    service.verifier.spans = spans

            if serve_rpc:
                # The public RPC port is a mux (reference parity: tonic serves
                # native gRPC AND grpc-web/HTTP1/CORS on one port, main.rs:110-114):
                # grpc.aio binds an internal loopback port; the mux splices HTTP/2
                # clients to it and answers grpc-web itself.
                server = grpc.aio.server()
                add_to_server(service, server)
                # assigned BEFORE start: if start() (or anything after) raises,
                # the guard's close() must stop this server, not leak its port
                service._grpc_server = server
                internal_port = server.add_insecure_port("127.0.0.1:0")
                if internal_port == 0:
                    raise OSError("cannot bind internal grpc port")
                await server.start()
                service._mux = PortMux(config.rpc_address, internal_port, service)
                try:
                    await service._mux.start()
                except OSError as exc:
                    raise OSError(
                        f"cannot bind rpc address {config.rpc_address}"
                    ) from exc
        except BaseException:
            await service.close()
            raise
        logger.info(
            "node up: mesh on %s, rpc on %s, %d peers, verifier=%s",
            config.node_address,
            config.rpc_address,
            len(service.mesh.peers),
            config.verifier.kind,
        )
        return service

    async def serve_forever(self) -> None:
        await self._grpc_server.wait_for_termination()

    async def close(self) -> None:
        self._closing = True
        if self._catchup_task is not None:
            self._catchup_task.cancel()
            try:
                await self._catchup_task
            except asyncio.CancelledError:
                pass
        if self.spans.on:
            self.spans.stop(self.config.observability.profile_dir)
            self.spans = NO_SPANS
        if self._stats_task is not None:
            self._stats_task.cancel()
            try:
                await self._stats_task
            except asyncio.CancelledError:
                pass
        if self._slo_task is not None:
            self._slo_task.cancel()
            try:
                await self._slo_task
            except asyncio.CancelledError:
                pass
        if self._audit_task is not None:
            self._audit_task.cancel()
            try:
                await self._audit_task
            except asyncio.CancelledError:
                pass
        if self.lag_probe is not None:
            await self.lag_probe.stop()
        self.sampler.stop()
        if self._checkpoint_task is not None:
            self._checkpoint_task.cancel()
            try:
                await self._checkpoint_task
            except asyncio.CancelledError:
                pass
        if self._store_task is not None:
            self._store_task.cancel()
            try:
                await self._store_task
            except asyncio.CancelledError:
                pass
        if self._membership_task is not None:
            self._membership_task.cancel()
            try:
                await self._membership_task
            except asyncio.CancelledError:
                pass
        if self._mux is not None:
            await self._mux.close()
        if self._grpc_server is not None:
            try:
                await self._grpc_server.stop(grace=0.5)
            except Exception:
                # stop() on a server whose start() never completed (failed
                # bring-up path) can raise; the socket dies with the object
                logger.exception("grpc server stop failed")
        # AFTER the RPC surface is down (no SendAsset can respawn it):
        # cancel the flush timer. ACK is not a commit receipt (rpc.rs:286)
        # — an unflushed ingress buffer may drop on shutdown, like any
        # pre-broadcast payload in the reference. SendAsset also gates on
        # _closing, so a handler mid-await cannot recreate the task.
        if self._batch_flush_task is not None:
            self._batch_flush_task.cancel()
            try:
                await self._batch_flush_task
            except asyncio.CancelledError:
                pass
        if self._delivery_task is not None:
            self._delivery_task.cancel()
            try:
                await self._delivery_task
            except asyncio.CancelledError:
                pass
        if self.broadcast is not None:
            await self.broadcast.close()
        if self.mesh is not None:
            await self.mesh.close()
        if self.verifier is not None and self._owns_verifier:
            await self.verifier.close()
        # Graceful-shutdown drain: payloads still sitting in
        # broadcast.delivered or the retry heap were already delivered
        # NETWORK-WIDE (peers commit and compact them — nothing will ever
        # re-gossip them to us). Dropping them here would permanently
        # desync this node's per-account sequence gate after restart, so
        # commit them before the final snapshot. Crash shutdown remains
        # best-effort by design (ledger/checkpoint.py docstring).
        if self.broadcast is not None:
            now = self.clock.monotonic()
            while True:
                try:
                    p = self.broadcast.delivered.get_nowait()
                except asyncio.QueueEmpty:
                    break
                self._push_pending(p, now)
        if self._pending_count():
            await self._drain_to_fixpoint()
        # Final snapshot LAST — ingress, delivery, and broadcast are all
        # stopped, so no commit can land after (and be missing from) it.
        if self.store is not None:
            try:
                await self._store_flush()
            except OSError:
                logger.exception("final store flush failed")
            self.store.close()
        elif self.config.checkpoint.path:
            try:
                await ckpt.save(
                    self.config.checkpoint.path,
                    self.accounts,
                    self.recent,
                    self.directory,
                )
            except OSError:
                logger.exception("final checkpoint failed")

    # -- checkpoint ------------------------------------------------------

    async def _checkpoint_loop(self, path: str, interval: float) -> None:
        while True:
            await self.clock.sleep(interval)
            try:
                await ckpt.save(path, self.accounts, self.recent, self.directory)
            except OSError:
                logger.exception("periodic checkpoint failed")

    # -- durable sharded store (store/) ----------------------------------

    async def _restore_state(self) -> None:
        """Resume ledger state at start. With [store] dir configured this
        opens (or initializes) the sharded store — migrating a legacy
        monolithic checkpoint one-shot if one exists and the store does
        not yet — and walks the recovery machine through
        loading_segments/replaying_wal; without it, the legacy full-
        snapshot path loads exactly as before."""
        scfg = self.config.store
        ccfg = self.config.checkpoint
        if not scfg.dir:
            if ccfg.path and await ckpt.load(
                ccfg.path, self.accounts, self.recent, self.directory
            ):
                # restored from its own snapshot: the node is behind the
                # fleet by whatever committed while it was down, so it
                # walks catchup -> live as a store-backed restart does
                # (start() marks it live at once when no peer can serve
                # a catchup); the reference leaves it "cold" throughout
                self.recovery.started_at = self.clock.monotonic()
                self.recovery.advance("catchup")
            return
        self.recovery.started_at = self.clock.monotonic()
        legacy = None
        if ccfg.path:
            # parsed, not loaded: the store decides whether to migrate
            # (only when no manifest exists yet)
            try:
                with open(ccfg.path) as fp:
                    legacy = json.load(fp)
            except FileNotFoundError:
                legacy = None

        def _on_segment(loaded: int, total: int) -> None:
            self.recovery.advance("loading_segments")
            self.recovery.segments_loaded = loaded
            self.recovery.segments_total = total

        def _on_wal_record(count: int) -> None:
            self.recovery.advance("replaying_wal")
            self.recovery.wal_records_replayed = count

        self.recovery.advance("loading_segments")
        store = ShardedStore.open(
            scfg.dir,
            n_shards=scfg.shards,
            sync=scfg.sync,
            history_cap=scfg.history_cap,
            legacy_checkpoint=legacy,
            on_segment=_on_segment,
            on_wal_record=_on_wal_record,
        )
        self.store = store
        self.recovery.segments_total = max(
            self.recovery.segments_total, store.segments_loaded
        )
        self.recovery.wal_records_replayed = store.wal_replayed
        self.recovery.migrated = store.migrated
        self.recovery.epoch = store.epoch
        await self.accounts.import_state(store.accounts_state())
        await self.recent.import_state(store.recent_rows)
        self.directory.import_(store.directory_rows)
        # the additive digest lanes were reseeded by the imports above
        # (Accounts.import_state / ClientDirectory.apply maintain them);
        # resume the persisted local chain head with a restart marker
        self.auditor.restore(store.audit)
        if self.certs is not None:
            # resume the persisted certificate chain (and any latched
            # equivocation evidence) at the epoch the store reached
            self.certs.restore(store.finality)
            self.certs.epoch = store.epoch
        # refill the catchup serving store from persisted history so a
        # restarted node can serve peers (and the conservation invariant
        # can replay) without waiting for new commits
        for payload in store.iter_history():
            self.history.record(payload)
        # the distilled-batch dedup window survives restart (a replaying
        # broker must not get a second pass at the broadcast plane just
        # because this node bounced)
        for row in store.distill_seen:
            self._distill_seen[(int(row[0]), int(row[1]))] = None
        # re-enqueue delivered-but-uncommitted payloads at the sequence
        # gate: the broadcast never retransmits a delivered slot, and
        # catchup can only confirm it while `quorum` full-history peers
        # are alive — the parked set is this node's own durable copy.
        # Fresh `now`: a restart grants the slot a new TTL window.
        now = self.clock.monotonic()
        restored_parked = 0
        for payload in store.iter_parked():
            if self._push_pending(payload, now):
                restored_parked += 1
        self.recovery.advance("catchup")
        logger.info(
            "store restored: gen=%d %d accounts, %d segments, "
            "%d wal records, %d parked%s",
            store.gen,
            store.account_count(),
            store.segments_loaded,
            store.wal_replayed,
            restored_parked,
            " (migrated legacy checkpoint)" if store.migrated else "",
        )

    def _store_stats_view(self) -> dict:
        if self.store is None:
            return {}
        return {
            "gen": self.store.gen,
            "accounts": self.store.account_count(),
            "history": self.store.history_count(),
            "parked": self.store.parked_count(),
        }

    async def _store_flush(self) -> None:
        """One incremental flush: refresh the manifest's small state
        (directory, recent ring, broadcast-safety watermarks, dedup
        window, epoch), then write dirty shards + rotate the WAL.
        Synchronous on the event loop by design — the mirror the flush
        walks is mutated by the commit path on this same loop, so
        off-thread flushing would race it; cost is bounded by the delta
        since the last flush."""
        if self.store is None:
            return
        watermarks = (
            self.broadcast.export_watermarks()
            if self.broadcast is not None
            else None
        )
        seen = list(self._distill_seen)[-4096:]
        self.store.set_meta(
            directory_rows=self.directory.export(),
            recent_rows=await self.recent.export_state(),
            watermarks=watermarks,
            distill_seen=[[cid, seq] for cid, seq in seen],
            epoch=self.membership.epoch if self.membership else None,
            audit=self.auditor.export(),
            finality=(
                self.certs.export() if self.certs is not None else None
            ),
        )
        stats = self.store.flush()
        if stats:
            self.store_stats["store_flushes"] += 1
            self.store_stats["store_segments_written"] += stats[
                "segments_written"
            ]
            self.store_stats["store_segment_bytes"] += stats["segment_bytes"]

    async def _store_flush_loop(self, interval: float) -> None:
        while True:
            await self.clock.sleep(interval)
            try:
                await self._store_flush()
            except OSError:
                logger.exception("store flush failed")

    # -- membership reconfiguration (node/membership.py) ------------------

    async def _membership_loop(self) -> None:
        """Finalize expired eviction grace windows (mesh removal + ban)."""
        while True:
            await self.clock.sleep(1.0)
            try:
                self.membership.sweep()
            except Exception:
                logger.exception("membership sweep failed")

    def _on_thresholds(
        self, echo: Optional[int], ready: Optional[int]
    ) -> None:
        """Quorum re-weighting hook: a ConfigTx naming new thresholds
        re-weights the broadcast stack's echo/ready quorums in place."""
        if self.broadcast is None:
            return
        if echo is not None:
            self.broadcast.echo_threshold = echo
        if ready is not None:
            self.broadcast.ready_threshold = ready

    def _on_config_tx(self, peer, tx) -> None:
        """Broadcast-worker hook (synchronous): validate/apply a gossiped
        ConfigTx. ``peer`` is None for admin-local injection. A NEWLY
        applied transition is re-gossiped so the fleet converges
        regardless of arrival topology, and the epoch is persisted so a
        restart rejoins at the epoch it had reached."""
        if self.membership is None:
            return
        if not self.membership.handle(tx):
            return
        self.recovery.epoch = self.membership.epoch
        if self.certs is not None:
            # certificates name their epoch: pending co-signature
            # buckets from the old epoch can never reach quorum under
            # the new one, so the assembler drops them; the assembled
            # chain survives the transition
            self.certs.reconfigure(self.certs.members, self.membership.epoch)
        if self.store is not None:
            self.store.set_meta(epoch=self.membership.epoch)
        self.recorder.record("config_apply", (self.membership.epoch,))
        if self.mesh is not None and self.mesh.peers:
            self.mesh.broadcast(tx.encode())

    # -- observability ---------------------------------------------------

    def _verifier_stats(self) -> dict:
        if self.verifier is None:
            return {}
        fn = getattr(self.verifier, "stats", None)
        return fn() if callable(fn) else {}

    def _verifier_stage_hists(self) -> dict:
        """Expose the batch verifier's stage Histograms to the registry's
        histogram-provider path (full _bucket/_sum/_count exposition).
        CpuVerifier has no stage histograms — empty dict, no families."""
        if self.verifier is None:
            return {}
        out = {}
        for name in ("queue_wait", "prep", "launch", "finish", "dispatch"):
            h = getattr(self.verifier, f"h_{name}", None)
            if h is not None:
                out[name] = h
        return out

    # -- overload-controller signal sources (node/overload.py) ----------

    def _overload_stage_hists(self) -> Optional[dict]:
        """Verifier stage snapshots for the controller's sojourn signal
        — the batch verifier's stage_histograms(), or a sim model's."""
        if self.verifier is None:
            return None
        fn = getattr(self.verifier, "stage_histograms", None)
        return fn() if callable(fn) else None

    def _plane_backlog(self) -> float:
        """Live undelivered broadcast slots, across shard cores when the
        plane is sharded — the same number the ``slots_undelivered``
        gauge exports."""
        b = self.broadcast
        if b is None:
            return 0.0
        und = getattr(b, "_undelivered", None)
        if und is not None:
            return float(und)
        cores = getattr(b, "_cores", None)
        if cores is not None:
            return float(sum(c._undelivered for c in cores))
        return 0.0

    def _commit_tail_age(self) -> float:
        """Age of the oldest payload parked in the commit retry heap —
        the commit-tail-lag pressure signal."""
        oldest = self._oldest_pending()
        if oldest is None:
            return 0.0
        return max(0.0, self.clock.monotonic() - oldest)

    def _overload_transition(
        self, old: str, new: str, pressure: float
    ) -> None:
        """Ladder transitions are flight-recorded so incident bundles
        capture when and why the controller engaged."""
        self.recorder.record(
            "overload_level", (old, new, round(pressure, 4))
        )

    def snapshot_stats(self) -> dict:
        """One structured stats record: broadcast per-stage counters +
        verifier batch metrics + commit progress. Now a
        pure registry view — every key comes from exactly one instrument
        or provider, so nothing is counted twice."""
        return self.registry.snapshot()

    async def _stats_loop(self, interval: float) -> None:
        while True:
            await self.clock.sleep(interval)
            snap = self.snapshot_stats()
            # one JSON object per line, keys sorted: machine-parseable
            # (jq / pandas) where the old space-joined k=v repr was not
            stats_logger.info(
                "%s", json.dumps(snap, sort_keys=True, default=float)
            )

    def _stalled_now(self, now: float) -> bool:
        """Commit-stall predicate shared by /healthz and the SLO probe:
        some pending payload has been gap-blocked past the catchup
        trigger horizon."""
        oldest = self._oldest_pending()
        stall_horizon = max(self.config.catchup.after * 2, 5.0)
        return oldest is not None and now - oldest > stall_horizon

    def slo_probe(self) -> None:
        """Take one SLO probe sample from the registry/TxTrace state the
        node already maintains. Called by the background loop on served
        nodes; tests and offline tooling may call it directly."""
        now = self.clock.monotonic()
        self.slo.observe(
            {
                "t": now,
                "committed": self.committed,
                "rejected": self.admission_stats["rejected_at_ingress"],
                "pending": self._pending_count(),
                "stalled": self._stalled_now(now),
                "latency": self._slo_hist.buckets(),
            }
        )

    async def _slo_loop(self, interval: float) -> None:
        while True:
            await self.clock.sleep(interval)
            try:
                self.slo_probe()
                # piggyback the overload pressure sample: served nodes
                # keep a fresh score even when ingress is idle (the sim
                # has no probe loop — there the sample is taken lazily
                # at ingress, keeping schedules deterministic)
                self.overload.maybe_sample()
            except Exception:
                logger.exception("slo probe failed")

    def sloz(self) -> dict:
        """Burn-rate verdicts for GET /sloz."""
        return {
            "node": self.config.sign_key.public.hex()[:16],
            **self.slo.evaluate(),
        }

    # HTTP GET surface, served through PortMux's HTTP/1 keep-alive loop
    # (net/webmux.py): the mux routes GETs here, so scrapes share the
    # grpc-web path's _MAX_HTTP1_CONNS / per-connection request cap /
    # per-request timeout — a scrape flood cannot pin handler tasks
    # beyond what grpc-web traffic already could.

    _OBS_JSON = "application/json; charset=utf-8"
    _OBS_PROM = "text/plain; version=0.0.4; charset=utf-8"

    def obs_http(self, path: str):
        """Route one GET. Returns (status, content_type, body) or None
        for 404 (unknown path, or endpoints disabled in config). ``path``
        may carry a query string (the mux passes it through verbatim);
        only /tracez reads one (``?limit=N`` bounds the completed-trace
        payload)."""
        if not self.config.observability.endpoints:
            return None
        route, _, query = path.partition("?")
        if route == "/metrics":
            body = self.registry.render_prometheus().encode()
            return 200, self._OBS_PROM, body
        if route == "/healthz":
            verdict = self.health_verdict()
            # "overloaded" is still-serving by design: the controller is
            # shedding excess ingress, not failing probes
            status = 200 if verdict["status"] in ("ok", "overloaded") else 503
            body = json.dumps(verdict, sort_keys=True).encode()
            return status, self._OBS_JSON, body
        if route == "/statusz":
            body = json.dumps(
                self.statusz(), sort_keys=True, default=float
            ).encode()
            return 200, self._OBS_JSON, body
        if route == "/tracez":
            limit = None
            for part in query.split("&"):
                if part.startswith("limit="):
                    try:
                        limit = max(0, int(part[6:]))
                    except ValueError:
                        pass
            body = json.dumps(
                self.tracez(limit), sort_keys=True, default=float
            ).encode()
            return 200, self._OBS_JSON, body
        if route == "/debugz":
            body = json.dumps(
                self.debugz(), sort_keys=True, default=float
            ).encode()
            return 200, self._OBS_JSON, body
        if route == "/sloz":
            body = json.dumps(
                self.sloz(), sort_keys=True, default=float
            ).encode()
            return 200, self._OBS_JSON, body
        if route == "/profilez":
            # [observability] kill-switch, same contract as the other
            # gated surfaces: switched off means 404, not 403 — the
            # endpoint does not exist on this node
            if not self.config.observability.profilez:
                return None
            params: dict[str, str] = {}
            for part in query.split("&"):
                if part:
                    k, _, v = part.partition("=")
                    params[k] = v
            return self.profilez(params)
        if route == "/certz":
            # finality certificate chain (finality/): kill-switched by
            # the [finality] table — disabled means 404, the endpoint
            # does not exist on this node
            if self.certs is None:
                return None
            body = json.dumps(self.certz(), sort_keys=True).encode()
            return 200, self._OBS_JSON, body
        if route == "/capturez":
            # inbound wire-capture ring (net/peers.py): kill-switched
            # like the flight recorder — capture_cap=0 (or a sim mesh,
            # which has no ring) means the endpoint does not exist
            dump = getattr(self.mesh, "capture_dump", None)
            if dump is None or getattr(self.mesh, "_capture", None) is None:
                return None
            body = json.dumps(
                {
                    "node": self.config.sign_key.public.hex()[:16],
                    **dump(),
                },
                sort_keys=True,
            ).encode()
            return 200, self._OBS_JSON, body
        return None

    def profilez(self, params: dict | None = None):
        """GET /profilez: the sampling profiler's control + view surface.

        ``?start[&duration=S]`` resets the tree and begins a bounded
        capture (default length [observability] profiler_duration);
        ``?stop`` ends one early; ``?fmt=folded[&limit=N]`` serves
        collapsed-stack text for flamegraph tooling; the default GET
        serves JSON — sampler state, the stack tree, folded lines, the
        build block, and the phase-accounting totals (so one scrape
        carries the whole plane decomposition input)."""
        params = params or {}
        obs = self.config.observability
        plane = self._plane_obs()
        if "start" in params:
            try:
                duration = float(
                    params.get("duration") or obs.profiler_duration
                )
            except ValueError:
                duration = obs.profiler_duration
            self.sampler.reset()
            started = self.sampler.start(duration=duration)
            workers = (
                plane.profiler_start(duration) if plane is not None else False
            )
            body = json.dumps(
                {
                    "started": started,
                    "workers_started": workers,
                    **self.sampler.stats(),
                },
                sort_keys=True, default=float,
            ).encode()
            return 200, self._OBS_JSON, body
        if "stop" in params:
            self.sampler.stop()
            if plane is not None:
                plane.profiler_stop()
            body = json.dumps(
                {"stopped": True, **self.sampler.stats()},
                sort_keys=True, default=float,
            ).encode()
            return 200, self._OBS_JSON, body
        limit = None
        if "limit" in params:
            try:
                limit = max(0, int(params["limit"]))
            except ValueError:
                pass
        if params.get("fmt") == "folded":
            body = self._merged_folded(plane, limit).encode()
            return 200, "text/plain; charset=utf-8", body
        folded = self._merged_folded(plane, limit)
        sampler_stats = self.sampler.stats()
        if plane is not None:
            sampler_stats["worker_samples"] = plane.worker_fold_samples()
        body = json.dumps(
            {
                "node": self.config.sign_key.public.hex()[:16],
                "build": self.build_block(),
                "sampler": sampler_stats,
                "phases": (
                    self.phases.totals() if self.phases is not None else {}
                ),
                "folded": folded.splitlines(),
                "tree": self.sampler.tree(),
            },
            sort_keys=True, default=float,
        ).encode()
        return 200, self._OBS_JSON, body

    def _plane_obs(self):
        """The sharded plane, iff it runs the process-mode obs shipping
        lane (otherwise the single-interpreter surfaces are complete on
        their own and nothing needs merging)."""
        b = self.broadcast
        if b is not None and getattr(b, "_obs_ship", False):
            return b
        return None

    def _merged_folded(self, plane, limit: int | None) -> str:
        """Owner folded stacks merged with every shard worker's shipped
        increments, worker frames prefixed ``shardN/``. With no obs lane
        this is exactly the owner sampler's folded() output."""
        if plane is None:
            return self.sampler.folded(limit)
        from ..obs.profiler import merge_folded

        parts = [("", self.sampler.folded())]
        parts.extend(plane.worker_folds())
        return merge_folded(parts, limit)

    def tracez(self, limit: int | None = None) -> dict:
        """Live + completed lifecycle traces plus a paired clock reading
        (tools/trace_collect.py joins records by (sender, seq) across
        nodes and normalizes on the wall stamps)."""
        return {
            "node": self.config.sign_key.public.hex()[:16],
            "clock": {
                "monotonic": round(self.clock.monotonic(), 9),
                "wall": round(self.clock.wall(), 9),
            },
            **self.tx_trace.tracez(limit),
        }

    def debugz(self) -> dict:
        """The flight recorder's ring + anomaly snapshots. In process
        mode, shard workers' shipped recorder events are interleaved
        into the event list by mono timestamp (codes are ``shardN/``-
        prefixed), so one dump reads as one fleet-of-processes
        timeline. ``plane_slots`` lists the batch slots the plane still
        holds undelivered (a stalled run's part-delivered batches)."""
        dump = self.recorder.dump()
        plane = self._plane_obs()
        if plane is not None:
            worker_events = plane.worker_events()
            if worker_events:
                dump["worker_events"] = len(worker_events)
                dump["events"] = sorted(
                    dump["events"] + worker_events, key=lambda e: e[0]
                )
        out = {
            "node": self.config.sign_key.public.hex()[:16],
            "recorder": dump,
        }
        if self.broadcast is not None:
            out["plane_slots"] = self.broadcast.part_delivered_batches()
        return out

    def health_verdict(self) -> dict:
        """Liveness + quorum/stall verdict. ``status`` is "ok" only when
        the node is not shutting down, enough peer channels are up that
        a broadcast can reach its ready quorum, and no pending payload
        has been gap-blocked past the catchup trigger horizon."""
        now = self.clock.monotonic()
        peers_total = len(self.config.nodes)
        channels = 0
        if self.mesh is not None:
            try:
                channels = int(self.mesh.stats().get("channels", 0))
            except Exception:
                pass
        need = peers_total
        if self.broadcast is not None:
            # ready quorum counts this node's own attestation, so
            # peers_needed = threshold - 1 remote channels
            need = max(0, self.broadcast.ready_threshold - 1)
        quorum_ok = peers_total == 0 or channels >= min(need, peers_total)
        stalled = self._stalled_now(now)
        # SLO degradation folds into the verdict: an objective burning
        # above 1.0 in BOTH windows (obs/slo.py multi-window AND — a
        # transient spike cannot flip this) marks the node degraded even
        # when quorum and the commit heap look healthy.
        slo_breach = self.slo.breaching(now)
        # a latched audit divergence is a safety signal, not a liveness
        # one: the ledgers have provably forked at a shared coordinate
        # (obs/audit.py zero-false-positive compare), so the node must
        # fail probes until an operator intervenes
        diverged = self.auditor.divergence is not None
        # a dead plane-shard worker process (process executor only) is a
        # permanent capacity loss: that shard's origins stop making
        # progress while everything else stays live. Degraded with shard
        # attribution — never a silent hang.
        plane_crashed = dict(
            getattr(self.broadcast, "worker_crashed", None) or {}
        )
        ok = (
            quorum_ok
            and not stalled
            and not slo_breach
            and not diverged
            and not plane_crashed
            and not self._closing
        )
        # a store-backed restart reports "recovering" until catchup lag
        # hits zero: healthy-but-behind, distinct from degraded (top.py
        # tolerates it within its deadline; probes still get 503 — the
        # node is not a full quorum participant yet)
        recovering = self.recovery.recovering
        # anomaly-triggered capture: the moment health flips ok->degraded
        # (for a real reason, not shutdown or recovery), freeze the flight
        # recorder so the lead-up survives ring rollover. Edge-triggered
        # on the transition, so a poll loop hammering a degraded node
        # takes ONE snapshot per incident, not one per scrape.
        if not ok and self._health_was_ok and not self._closing:
            if diverged:
                reason = "diverged"
            elif stalled:
                reason = "stalled"
            elif not quorum_ok:
                reason = "quorum_lost"
            elif plane_crashed:
                reason = "plane_worker:" + ",".join(
                    f"shard={sid}" for sid in sorted(plane_crashed)
                )
            else:
                reason = "slo:" + ",".join(slo_breach)
            self.recorder.snapshot("healthz_degraded:" + reason)
            # same edge, stack capture: one bounded profiler run per
            # incident, so the burn that degraded the node is
            # attributable from /profilez afterwards. Served nodes only
            # (the sampler is a real thread — never auto-started under
            # sim) and never clobbering an operator-started capture.
            if (
                self.config.observability.profilez
                and self._mux is not None
                and not self.sampler.running
            ):
                self.sampler.reset()
                self.sampler.start(
                    duration=self.config.observability.profiler_duration
                )
        self._health_was_ok = ok
        if diverged:
            # distinct from "degraded": liveness may be perfect while
            # the state has forked, and operators triage the two very
            # differently (restart vs incident bundle + capture replay)
            status = "diverged"
        elif not ok:
            status = "degraded"
        elif recovering:
            status = "recovering"
        elif self.overload.overloaded:
            # actively shedding but otherwise healthy: still serving,
            # NOT a 503 — load balancers must keep routing here (pulling
            # an overloaded node only concentrates the crowd on the
            # rest); operators see the ladder on /statusz
            status = "overloaded"
        else:
            status = "ok"
        return {
            "status": status,
            "overload_level": self.overload.level,
            "pressure": round(self.overload.pressure, 4),
            "recovering": recovering,
            "epoch": self.membership.epoch if self.membership else 0,
            "closing": self._closing,
            "peers_configured": peers_total,
            "peers_connected": channels,
            "quorum_ok": quorum_ok,
            "stalled": stalled,
            "slo_breach": slo_breach,
            "plane_workers_crashed": {
                str(sid): code for sid, code in sorted(plane_crashed.items())
            },
            "divergence": self.auditor.divergence,
            "pending": self._pending_count(),
            "committed": self.committed,
            "uptime_s": round(now - self._started_at, 3),
        }

    def build_block(self) -> dict:
        """The /statusz ``build`` block: exactly what is running — the
        static identity (git SHA, Python/torch/CUDA versions, the card) plus this
        process's config hash, start time, and uptime. profile_collect
        and regress.py stamp their reports with the static half.

        ``kernel_launches``, ``rlc_kernel_launches`` and
        ``rlc_fold_launches`` are process-wide figures, not this node's: the
        launches of the ed25519 verify kernel and of the two RLC kernels by
        every verifier in the process (a ``server run`` process holds
        one)."""
        from ..ops import cuda_rlc, cuda_verify

        return {
            **build_info(),
            "config_hash": self._config_hash,
            "started_wall": round(self._started_wall, 3),
            "uptime_s": round(self.clock.monotonic() - self._started_at, 3),
            "kernel_launches": cuda_verify.launches,
            "rlc_kernel_launches": cuda_rlc.launches,
            "rlc_fold_launches": cuda_rlc.fold_launches,
        }

    def statusz(self) -> dict:
        """Full JSON snapshot for /statusz and tools/top.py: flat stats
        + tx-lifecycle percentiles + verifier pipeline stage histograms."""
        stages = {}
        routing = {}
        if self.verifier is not None:
            fn = getattr(self.verifier, "stage_histograms", None)
            if callable(fn):
                stages = fn()
            router = getattr(self.verifier, "router", None)
            if router is not None:
                # the LIVE routing decision: which path the
                # last flush took, why (batch size vs expected bad), and
                # how many sources the failure EWMA currently tracks
                routing = {
                    "mode": router.mode,
                    **router.stats(),
                    "hot_sources": router.hot_sources(),
                }
        return {
            "node": self.config.sign_key.public.hex()[:16],
            "rpc_address": self.config.rpc_address,
            "build": self.build_block(),
            "health": self.health_verdict(),
            "stats": self.snapshot_stats(),
            "tx_lifecycle": self.tx_trace.snapshot(),
            "verifier_stages": stages,
            "verifier_routing": routing,
            "slo": self.slo.evaluate(),
            # overload-controller block (node/overload.py): the smoothed
            # pressure score, ladder position, per-signal readings, and
            # the live shed fractions / retry-after hint
            "pressure": self.overload.snapshot(),
            "recovery": self.recovery.to_dict(self.clock.monotonic()),
            "membership": (
                self.membership.stats() if self.membership else {}
            ),
            # fleet-audit block (obs/audit.py): digest lanes, chain
            # head, peer beacon summaries, and any latched divergence
            "audit": self.auditor.status(self.directory.digest),
            # finality block (finality/certs.py): assembler counters,
            # latest certificate, and the certified-vs-commit lag the
            # top.py finality column renders
            "finality": self._finality_status(),
            # sharded-plane block (tools/top.py `shards` column); the
            # monolithic plane has no plane_info and reports shards=1
            "plane": (
                self.broadcast.plane_info()
                if hasattr(self.broadcast, "plane_info")
                else {"shards": 1, "executor": "loop"}
            ),
        }

    # -- delivery → commit loop ------------------------------------------

    def _push_pending(
        self, p: Payload, now: float, from_catchup: bool = False
    ) -> bool:
        """Push one delivered payload onto the retry heap — the ONE place
        the heap key is built (delivery loop, catchup, and shutdown drain
        share it: the commit order must not depend on which path
        enqueued). Exact duplicates already pending are skipped: catchup
        can race normal delivery of the same slot, and the loser of the
        sequence gate would otherwise park in the heap forever. Returns
        True only when the payload was NEWLY enqueued (catchup uses this
        to count real progress, not dedup hits)."""
        key = (p.sequence, p.sender, p.transaction.recipient, p.transaction.amount)
        if from_catchup:
            # quorum-confirmed regardless of which path enqueued it first
            # (an ingress duplicate may already sit in the heap): the TTL
            # branch must never FAILURE-mark a network-committed slot
            self._catchup_keys.add(key)
        if key in self._heap_keys:
            return False
        self._heap_keys.add(key)
        self._push_count += 1
        heapq.heappush(self._heap, (key, now, self._push_count, p))
        if self.store is not None:
            # a delivered payload is never retransmitted by the
            # broadcast: losing the heap at a crash would strand slots
            # whose full-history copies dip below the catchup quorum, so
            # park it durably until it commits or times out
            try:
                self.store.note_parked(p)
            except OSError:
                logger.exception("store parked append failed")
        return True

    # A pass leaves a payload pending only when its sender's sequence gate
    # refuses it, and no pass after that can act on it until its sender's
    # last sequence moves, another payload of the sender arrives, or its
    # TTL runs out. Such leftovers wait in ``_parked``, grouped by sender
    # as [the sender's last sequence, the oldest arrival, entries], and a
    # pass takes up only the groups that one of those three has touched:
    # the passes act exactly as if every entry were visited, at a cost
    # that does not grow with the payloads parked behind shed sequences.

    def _pending_count(self) -> int:
        return len(self._heap) + self._parked_n

    def _oldest_pending(self) -> Optional[float]:
        """Arrival time of the oldest pending payload, or None."""
        return min(
            [e[1] for e in self._heap]
            + [group[1] for group in self._parked.values()],
            default=None,
        )

    def _unpark(
        self, parked: dict, batch: List[tuple], now: float
    ) -> List[tuple]:
        """Take out of ``parked`` the groups this pass must visit."""
        if not parked:
            return []
        arriving = {entry[0][1] for entry in batch}
        last = self.accounts.last_sequence_nowait
        touched = [
            sender
            for sender, (seq, oldest, _) in parked.items()
            if sender in arriving
            or last(sender) != seq
            or now - oldest > TRANSACTION_TTL
        ]
        out: List[tuple] = []
        for sender in touched:
            out.extend(parked.pop(sender)[2])
        return out

    def _park(self, parked: dict, retry: List[tuple]) -> None:
        """Put a pass's leftovers with the groups it did not visit, and
        make them the pending set's parked part again."""
        last = self.accounts.last_sequence_nowait
        for entry in retry:
            sender = entry[0][1]
            group = parked.get(sender)
            if group is None:
                parked[sender] = [last(sender), entry[1], [entry]]
            else:
                group[1] = min(group[1], entry[1])
                group[2].append(entry)
        self._parked = parked
        self._parked_n = sum(len(group[2]) for group in parked.values())

    async def _delivery_loop(self) -> None:
        queue = self.broadcast.delivered
        while True:
            payload = await queue.get()
            batch = [payload]
            while True:  # greedy drain: one pass per delivered batch
                try:
                    batch.append(queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            now = self.clock.monotonic()
            for p in batch:
                self._push_pending(p, now)
            await self._drain_to_fixpoint()

    async def _drain_to_fixpoint(self) -> None:
        # Mirrors rpc.rs:176-208: keep passing over the (sorted) pending
        # set while progress is made; retry only AccountModification
        # errors so a sequence gap fills once its predecessor lands.
        async with self._drain_lock:
            await self._drain_to_fixpoint_locked()

    async def _drain_to_fixpoint_locked(self) -> None:
        # one at2.commit.drain span a synchronous stretch: the accounts
        # lock is never held across a suspension, so only the shielded
        # commit tail suspends a pass
        sp = self.spans
        h = sp.begin("at2.commit.drain", self._pending_count()) if sp.on else None
        try:
            while True:
                # Take ownership of everything currently pending; the loop
                # body awaits, and _push_pending (delivery loop, catchup) runs
                # WITHOUT the drain lock — concurrent pushes land in the fresh
                # self._heap and are picked up by the next pass instead of
                # mutating the list this pass is iterating (a heappush mid-
                # iteration could sift an entry behind the iterator, and the
                # end-of-pass rebuild would silently discard it forever).
                # The parked groups leave with it, so that readers see during
                # the pass what they would see of the reference's one list.
                if not self._heap and not self._parked_n:
                    break
                batch, parked = self._heap, self._parked
                self._heap, self._parked, self._parked_n = [], {}, 0
                now = self.clock.monotonic()
                batch.extend(self._unpark(parked, batch, now))
                before = len(batch)
                batch.sort()
                catchup_keys = self._catchup_keys

                def _apply_pass(accounts) -> tuple:
                    """One synchronous pass over the sorted batch under the
                    accounts lock (Accounts.run_exclusive): per-item stale /
                    TTL / transfer semantics identical to the reference's
                    loop (rpc.rs:176-208), but ONE lock round-trip for the
                    whole pass and the ring mutations collected for one bulk
                    apply — the commit path's per-tx actor overhead was the
                    top in-window cost at batched-plane rates."""
                    retry: List[tuple] = []
                    ring_ops: List[tuple] = []
                    commits: List[tuple] = []
                    drops: List[Payload] = []  # gave up: unpark from the store
                    for key, added, tiebreak, payload in batch:
                        # An already-consumed sequence can never commit (the
                        # gate admits exactly last+1 and last only grows);
                        # keep it retrying until the reference's TTL so the
                        # ring records stay bit-identical with the
                        # reference, then drop it instead of parking it.
                        stale = payload.sequence <= accounts.last_sequence_nowait(
                            payload.sender
                        )
                        if now - added > TRANSACTION_TTL:
                            logger.warning(
                                "transaction timed out: (%s, %d)",
                                payload.sender.hex()[:16],
                                payload.sequence,
                            )
                            if stale:
                                # catchup/delivery duplicate of a committed
                                # slot, or a transfer whose own failed debit
                                # consumed the sequence: FAILURE-mark the
                                # latter, never flip a committed twin's
                                # SUCCESS, and drop
                                ring_ops.append(
                                    (
                                        "unless_success",
                                        payload.sender,
                                        payload.sequence,
                                    )
                                )
                                drops.append(payload)
                                continue
                            if key not in catchup_keys:
                                # catchup-sourced payloads are quorum-
                                # confirmed committed network-wide; a local
                                # gap-block must not record FAILURE for a
                                # transfer every peer reports SUCCESS
                                ring_ops.append(
                                    (
                                        "update",
                                        payload.sender,
                                        payload.sequence,
                                        TransactionState.FAILURE,
                                    )
                                )
                            # NO continue — TTL-expired payloads still
                            # process and may flip to Success (reference
                            # quirk, rpc.rs:183-205)
                        try:
                            accounts._transfer(
                                payload.sender,
                                payload.sequence,
                                payload.transaction.recipient,
                                payload.transaction.amount,
                            )
                        except AccountModificationError as exc:
                            logger.debug(
                                "retrying payload (%s, %d): %s",
                                payload.sender.hex()[:16],
                                payload.sequence,
                                exc,
                            )
                            retry.append((key, added, tiebreak, payload))
                            continue
                        except Exception as exc:
                            logger.warning("dropping bad payload: %s", exc)
                            drops.append(payload)
                            continue
                        if self.ledger_failpoint is not None:
                            # sim-only corruption seam (sim/campaign.py
                            # "misapply" event): misapply a balance delta to
                            # the recipient AFTER a successful transfer,
                            # BEFORE the post-commit balance capture — the
                            # WAL, the ring, and the digest all see the
                            # corrupted state consistently, so only peers'
                            # auditors can catch it (which is the point).
                            delta = self.ledger_failpoint(payload)
                            if delta:
                                accounts._tamper(
                                    payload.transaction.recipient, delta
                                )
                        ring_ops.append(
                            (
                                "update",
                                payload.sender,
                                payload.sequence,
                                TransactionState.SUCCESS,
                            )
                        )
                        # POST-commit balances captured here, inside the
                        # exclusive section, so the WAL record the store
                        # appends is exactly the ledger state this transfer
                        # left behind (a later read could see a newer value)
                        s_bal = accounts._ledger[payload.sender].balance
                        recipient = payload.transaction.recipient
                        r_bal = (
                            accounts._ledger[recipient].balance
                            if recipient != payload.sender
                            else None
                        )
                        commits.append((key, payload, s_bal, r_bal))
                    return retry, ring_ops, commits, drops

                retry, ring_ops, commits, drops = await self.accounts.run_exclusive(
                    _apply_pass
                )
                if drops and self.store is not None:
                    for p in drops:
                        try:
                            self.store.note_unparked(p)
                        except OSError:
                            logger.exception("store unpark append failed")
                if commits or ring_ops:
                    # the accounts mutation already happened inside
                    # run_exclusive: a cancellation landing between it and the
                    # history/ring bookkeeping would leave committed transfers
                    # invisible to catchup peers and stuck Pending in the
                    # recent ring. Shield the tail so close()'s task
                    # cancellation can interrupt the DRAIN but never split a
                    # commit from its record.
                    if h is not None:
                        sp.end(h)
                        h = None
                    await asyncio.shield(self._commit_tail(commits, ring_ops))
                    h = sp.begin("at2.commit.drain", self._pending_count()) if sp.on else None
                # park the leftovers beside anything that arrived mid-pass; no
                # awaits between here and the key update, so the set and the
                # pending entries cannot diverge
                arrivals = len(self._heap)
                gone = {entry[0] for entry in batch}
                gone.difference_update(entry[0] for entry in retry)
                self._park(parked, retry)
                self._heap_keys -= gone
                self._catchup_keys &= self._heap_keys  # prune committed/dropped
                progressed = len(retry) < before
                if not self._pending_count() or not (progressed or arrivals):
                    break
            # Anything still pending after a fixpoint pass is gap-blocked: its
            # predecessor is not in flight anywhere local, so if it doesn't
            # resolve within cfg.after (the runner's initial delay), it was
            # committed network-wide while this node was away — pull it from
            # peers. The kick is single-flight and the runner paces itself,
            # so kicking on every drain with leftovers is cheap; kicking ONLY
            # when entries are already old would miss gaps entirely (drains
            # run on delivery, and a quiet net delivers nothing after the
            # gapped payload — the age condition would never be re-checked).
            cfg = self.config.catchup
            if (
                cfg.enabled
                and self._pending_count()
                and not self._closing
                and self.mesh is not None
                and self.mesh.peers
            ):
                self._kick_catchup()
        finally:
            if h is not None:
                sp.end(h)

    async def _commit_tail(self, commits: list, ring_ops: list) -> None:
        """Post-apply commit bookkeeping, always run to completion (the
        caller shields it): history retention, counters, equivocation-
        registry release, and the recent-ring flips. One synchronous
        stretch: the ring's lock is never held across a suspension."""
        ph, sp = self.phases, self.spans
        t0 = ph.t() if ph is not None else 0
        h = sp.begin("at2.commit.tail", len(commits)) if sp.on else None
        try:
            for key, payload, s_bal, r_bal in commits:
                logger.info(
                    "new payload: seq=%d sender=%s",
                    payload.sequence,
                    payload.sender.hex()[:16],
                )
                self.committed += 1
                if self.store is not None:
                    # WAL append first (durability), then the in-memory fold;
                    # a store I/O failure must not split a commit from its
                    # ring/history bookkeeping
                    try:
                        self.store.note_commit(
                            payload, payload.sequence, s_bal, r_bal
                        )
                    except OSError:
                        logger.exception("store wal append failed")
                self.tx_trace.stamp(
                    (payload.sender, payload.sequence), "committed"
                )
                if key in self._catchup_keys:
                    self._catchup_commits += 1
                # retain for peers' ledger catchup (ledger/history.py)
                self.history.record(payload)
                if self.broadcast is not None:
                    # the ledger's per-client sequence gate now owns this
                    # (sender, sequence) binding — release the broadcast
                    # plane's equivocation-registry entry eagerly so the
                    # registry's working set tracks in-flight entries only
                    self.broadcast.release_entry(payload.sender, payload.sequence)
            if ring_ops:
                await self.recent.apply_many(ring_ops)
            if commits:
                # commit-count-triggered audit beacon: every node emits at
                # the same committed-transfer strides, so the sim exercises
                # the full beacon/compare path without any standing timer
                # (and identically at plane shards 1 vs 4 — the commit order
                # is identical, hence so are the emission points).
                every = self.config.observability.audit_every
                before = self.auditor.commits
                self.auditor.note_commit(len(commits))
                if every > 0 and before // every != self.auditor.commits // every:
                    self._emit_beacon()
        finally:
            if h is not None:
                sp.end(h)
        if ph is not None:
            ph.add("commit_tail", t0)

    # -- fleet consistency audit (obs/audit.py) ---------------------------

    def _emit_beacon(self) -> None:
        """Fold a local audit point and gossip it as a signed
        StateBeacon (wire kind 15). Called from _commit_tail at
        audit_every commit strides and from the wall timer on served
        nodes; safe pre-mesh (the point still lands in local history,
        so late peers' beacons at that watermark remain comparable)."""
        epoch = self.membership.epoch if self.membership is not None else 0
        point = self.auditor.snapshot(epoch, self.directory.digest)
        # finality rides the same frontier: the co-signature covers the
        # canonical subset of this very audit point (before the peer
        # check — a single-node fleet still certifies locally)
        self._emit_cert_sig(epoch, point)
        if self.mesh is None or not self.mesh.peers:
            return
        beacon = StateBeacon.create(
            self.config.sign_key,
            epoch,
            point["commits"],
            point["wm"],
            point["ranges"],
            point["dir"],
            point["chain"],
        )
        self.auditor.counters["beacons_tx"] += 1
        self.mesh.broadcast(beacon.encode())

    def _on_beacon(self, peer: Peer, msg: StateBeacon) -> None:
        """Broadcast-plane hook for inbound StateBeacons. The origin must
        be a KNOWN member sign key but deliberately not the transport
        peer: a relayed or replayed beacon (tools/capture_replay.py
        injects captures through a synthetic identity) still exercises
        the auditor, and the ed25519 signature alone binds the claims."""
        origin = bytes(msg.origin)
        if (
            origin not in self._node_ranks
            or origin == self.config.sign_key.public
            or not verify_one(origin, msg.to_sign(), msg.signature)
        ):
            self.auditor.counters["beacon_invalid"] += 1
            return
        divergence = self.auditor.observe(
            origin.hex(),
            {
                "epoch": msg.epoch,
                "commits": msg.commits,
                "wm": bytes(msg.wm_digest),
                "ranges": bytes(msg.ranges),
                "dir": bytes(msg.dir_digest),
                "chain": bytes(msg.chain),
            },
        )
        if divergence is not None:
            logger.warning(
                "fleet divergence: peer=%s ranges=%s wm=%s",
                divergence["peer"][:16],
                divergence["ranges"],
                divergence["wm"][:16],
            )
            self.recorder.snapshot("audit_divergence")

    # -- finality certificates (finality/) --------------------------------

    def _emit_cert_sig(self, epoch: int, point: dict) -> None:
        """Co-sign the canonical frontier tuple of a freshly-folded
        audit point and gossip it (wire kind 16). The local co-signature
        is folded into our own assembler first — we never hear our own
        broadcast — which also lets a single-node fleet (quorum 1)
        certify without any wire traffic."""
        if self.certs is None:
            return
        cosig = CertSig.create(
            self.config.sign_key,
            epoch,
            point["commits"],
            point["wm"],
            point["ranges"],
            point["dir"],
        )
        self.certs.epoch = epoch
        cert = self.certs.add(cosig)
        if cert is not None:
            self._note_certificate(cert)
        if self.mesh is not None and self.mesh.peers:
            self.mesh.broadcast(cosig.encode())

    def _on_cert_sig(self, peer: Peer, msg: CertSig) -> None:
        """Broadcast-plane hook for inbound cert co-signatures. Like
        beacons, the TRANSPORT peer is deliberately not authenticated
        against the origin — the assembler verifies the co-signature
        against the claimed member key, and that signature alone binds
        the claims (replayed captures still exercise the assembler)."""
        if self.certs is None:
            return
        had_eq = self.certs.equivocation is not None
        cert = self.certs.add(msg)
        if cert is not None:
            self._note_certificate(cert)
        if not had_eq and self.certs.equivocation is not None:
            eq = self.certs.equivocation
            logger.warning(
                "certificate equivocation: origin=%s epoch=%d wm=%s",
                eq["origin"][:16], eq["epoch"], eq["wm"][:16],
            )
            self.recorder.snapshot("cert_equivocation")

    def _note_certificate(self, cert) -> None:
        logger.info(
            "finality certificate: epoch=%d commits=%d signers=%d",
            cert.epoch, cert.commits, cert.signer_count(),
        )
        self.recorder.record(
            "certificate", (cert.epoch, cert.commits, cert.signer_count())
        )

    def _finality_status(self) -> dict:
        """The /statusz finality block (tools/top.py finality column)."""
        if self.certs is None:
            return {"enabled": False}
        latest = self.certs.latest
        certified = latest.commits if latest is not None else 0
        return {
            "enabled": True,
            "audit_every": self.config.observability.audit_every,
            "frontier": self.auditor.commits,
            "certified": certified,
            "lag": max(0, self.auditor.commits - certified),
            **self.certs.status(),
        }

    def certz(self) -> dict:
        """GET /certz: the full light-client bundle — member keys,
        quorum rule, and the retained certificate chain (oldest first).
        Everything here is verifiable; nothing needs to be trusted."""
        return {
            "node": self.config.sign_key.public.hex(),
            "epoch": self.certs.epoch,
            "scheme": self.certs.scheme.name,
            "quorum": self.certs.quorum,
            "members": [k.hex() for k in self.certs.members],
            "commits": self.auditor.commits,
            "chain": [c.to_doc() for c in self.certs.chain],
            "equivocation": self.certs.equivocation,
        }

    async def _audit_beacon_loop(self, interval: float) -> None:
        """Wall-timer beacon emission for served nodes: an idle fleet
        (no commits, so no stride triggers) still cross-checks state."""
        while True:
            await self.clock.sleep(interval)
            try:
                self._emit_beacon()
            except Exception:
                logger.exception("audit beacon emission failed")

    # -- ledger-history catchup ------------------------------------------
    #
    # The reference's open "catchup mechanism" roadmap item
    # (at2-node/README.md:53). Protocol (messages in
    # broadcast/messages.py, serving store in ledger/history.py):
    #
    #   1. broadcast HistoryIndexRequest(nonce); peers answer with their
    #      commit frontier (sender -> last committed sequence);
    #   2. for every sender some peer reports ahead of us, broadcast
    #      HistoryRequest for the missing range; peers serve
    #      HistoryBatch from their bounded history stores;
    #   3. apply a slot only when `quorum` distinct peers returned the
    #      same content hash for it (>= f+1 peers means at least one
    #      correct peer vouches the content was committed — and sieve
    #      guarantees committed content is unique per slot) AND the
    #      client signature verifies; then replay through the normal
    #      sequence gate, which makes the whole path idempotent.
    #
    # Snapshot transfer would be unsound here: in a consensus-free ledger
    # a balance is a function of full history (credits don't bump the
    # recipient's sequence), so point-in-time (sequence, balance) pairs
    # from different peers cannot be safely reconciled. Replaying signed,
    # quorum-confirmed history can, deterministically.

    def _catchup_quorum(self, n_peers: int) -> int:
        cfg = self.config.catchup
        quorum = cfg.quorum
        if quorum <= 0:
            quorum = (
                self.config.ready_threshold
                if self.config.ready_threshold is not None
                else n_peers
            )
        return max(1, min(quorum, n_peers))

    def _serve_allow(self, peer: Peer, kind: str, cost: int, cap: int) -> bool:
        """1-second token window per (peer, kind); drops beyond the cap
        (the requester's session loop simply retries next second)."""
        now = self.clock.monotonic()
        budget = self._serve_budget.setdefault(
            (peer.sign_public, kind), [now, 0]
        )
        if now - budget[0] >= 1.0:
            budget[0] = now
            budget[1] = 0
        if budget[1] + cost > cap:
            self.catchup_stats["catchup_throttled"] += 1
            return False
        budget[1] += cost
        return True

    def _on_catchup(self, peer: Peer, msg) -> None:
        """Broadcast-worker hook (synchronous): serve peers' catchup
        requests and collect responses for our own session."""
        if isinstance(msg, HistoryIndexRequest):
            self.catchup_stats["catchup_idx_req_rx"] += 1
            if not self._serve_allow(peer, "idx", 1, SERVE_IDX_PER_SEC):
                return
            entries = list(self.accounts.frontier_nowait().items())
            if len(entries) > hist.MAX_IDX_ENTRIES:
                # rotate the served window across requests: a fixed
                # first-N slice (dict insertion order) would make senders
                # past the cap permanently invisible to every requester —
                # rotation guarantees coverage within ceil(N/cap) sessions
                start = self._idx_serve_offset % len(entries)
                self._idx_serve_offset = start + hist.MAX_IDX_ENTRIES
                end = start + hist.MAX_IDX_ENTRIES
                entries = entries[start:end] + entries[: max(0, end - len(entries))]
                logger.warning(
                    "history index truncated to %d entries (rotating window)",
                    hist.MAX_IDX_ENTRIES,
                )
            self.mesh.send(peer, HistoryIndex(msg.nonce, tuple(entries)).encode())
        elif isinstance(msg, HistoryRequest):
            self.catchup_stats["catchup_hist_req_rx"] += 1
            # budget BEFORE the store lookup, charged at the clamped
            # request size: the O(range) work is the amplification lever,
            # so a throttled request must cost nothing (over-charging a
            # partially-retained range is the cheap, safe side)
            cost = min(max(msg.to_seq - msg.from_seq + 1, 0), hist.MAX_RANGE)
            if cost == 0 or not self._serve_allow(
                peer, "rows", cost, SERVE_ROWS_PER_SEC
            ):
                return
            payloads = self.history.get_range(msg.sender, msg.from_seq, msg.to_seq)
            for i in range(0, len(payloads), hist.MAX_BATCH):
                chunk = tuple(payloads[i : i + hist.MAX_BATCH])
                self.mesh.send(peer, HistoryBatch(msg.nonce, chunk).encode())
            self.catchup_stats["catchup_served"] += len(payloads)
        elif isinstance(msg, HistoryIndex):
            session = self._catchup_session
            if session is not None and msg.nonce == session.nonce:
                session.indexes[peer.sign_public] = msg.entries
        elif isinstance(msg, HistoryBatch):
            session = self._catchup_session
            if session is not None and msg.nonce == session.nonce:
                stored = session.stored_by_peer.get(peer.sign_public, 0)
                for p in msg.payloads:
                    vote_key = ((p.sender, p.sequence), p.content_hash())
                    if vote_key in session.payloads:
                        # vote accrual is never capped (see _CatchupSession)
                        session.votes[vote_key].add(peer.sign_public)
                        continue
                    if stored >= session.per_peer_cap:
                        logger.warning(
                            "catchup payload cap reached for peer %s",
                            peer.address,
                        )
                        break
                    stored += 1
                    session.votes.setdefault(vote_key, set()).add(
                        peer.sign_public
                    )
                    session.payloads[vote_key] = p
                session.stored_by_peer[peer.sign_public] = stored

    def _kick_catchup(self) -> None:
        if self._catchup_task is None or self._catchup_task.done():
            # a stall kick IS an anomaly: freeze the flight recorder so
            # the 2s before the stall are inspectable after the fact.
            # Single-flight gated (like the runner itself), so a stall
            # persisting across GC passes takes one snapshot per session.
            self.recorder.snapshot("stall_kick")
            # the initial delay gives a transient gap (predecessor still
            # in flight through the broadcast) time to resolve without a
            # session, and paces back-to-back kicks
            self._catchup_task = asyncio.create_task(
                self._catchup_runner(initial_delay=self.config.catchup.after)
            )

    # Sessions that heard from no peer retry at least this many times:
    # right after a restart, peers' redial backoff (net/peers.py, capped
    # at 5s) can delay their replies past several session windows.
    _CATCHUP_MIN_ATTEMPTS = 8
    # After this many consecutive sessions without commit progress the
    # runner backs off exponentially (doubling per session) up to the
    # max. A gap beyond every peer's history horizon can NEVER resolve
    # via catchup (ledger/history.py:19-23 — operator action required);
    # without backoff each session re-broadcasts HistoryRequests and
    # re-verifies up to MAX_RANGE payloads per peer every cfg.after
    # seconds forever.
    _CATCHUP_BACKOFF_AFTER = 3
    _CATCHUP_MAX_BACKOFF = 60.0

    async def _catchup_runner(self, initial_delay: float = 0.0) -> None:
        """Run catchup sessions until the ledger is caught up: no stale
        sequence gap remains AND at least one peer has answered (or the
        attempt budget for unanswered sessions is spent). Sessions that
        stop producing COMMIT progress back off exponentially."""
        cfg = self.config.catchup
        if initial_delay:
            await self.clock.sleep(initial_delay)
        attempts = 0
        no_progress = 0  # consecutive sessions with no commit progress
        try:
            while not self._closing:
                commits_before = self._catchup_commits
                responses, applied = await self._catchup_once()
                attempts += 1
                # progress = catchup-sourced work only: new payloads
                # enqueued, or catchup-keyed payloads committed. The
                # global commit counter would count unrelated live
                # traffic and keep resetting the backoff forever.
                progressed = (
                    applied > 0 or self._catchup_commits > commits_before
                )
                no_progress = 0 if progressed else no_progress + 1
                now = self.clock.monotonic()
                oldest = self._oldest_pending()
                gap_remains = oldest is not None and now - oldest > cfg.after
                if applied == 0 and not gap_remains and (
                    responses > 0 or attempts >= self._CATCHUP_MIN_ATTEMPTS
                ):
                    if self.recovery.state == "catchup":
                        self.recovery.mark_live(now)
                    return
                if applied == 0 and gap_remains:
                    logger.log(
                        logging.WARNING if attempts <= 3 else logging.DEBUG,
                        "catchup made no progress (attempt %d, %d peers "
                        "answered); gap persists",
                        attempts,
                        responses,
                    )
                delay = cfg.after
                if no_progress > self._CATCHUP_BACKOFF_AFTER:
                    delay = min(
                        cfg.after
                        * 2 ** (no_progress - self._CATCHUP_BACKOFF_AFTER),
                        self._CATCHUP_MAX_BACKOFF,
                    )
                await self.clock.sleep(delay)
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("catchup runner failed")

    async def _catchup_once(self) -> Tuple[int, int]:
        """One catchup session; returns (peer index responses, applied)."""
        cfg = self.config.catchup
        peers = self.mesh.peers if self.mesh is not None else []
        if not peers or self._catchup_session is not None:
            return 0, 0
        quorum = self._catchup_quorum(len(peers))
        session = _CatchupSession(self._nonce_bits(64), len(peers))
        self._catchup_session = session
        self.catchup_stats["catchup_sessions"] += 1
        self.recovery.catchup_sessions += 1
        try:
            self.mesh.broadcast(HistoryIndexRequest(session.nonce).encode())
            await self.clock.sleep(cfg.window)
            responses = len(session.indexes)
            local = self.accounts.frontier_nowait()
            needed: Dict[bytes, int] = {}
            for frontier in session.indexes.values():
                for sender, seq in frontier:
                    if seq > local.get(sender, 0) and seq > needed.get(sender, 0):
                        needed[sender] = seq
            # catchup lag = missing slots vs the fleet frontier; a session
            # where peers answered and reported nothing missing is the
            # recovery machine's "caught up to live" signal
            if self.recovery.state == "catchup":
                self.recovery.catchup_lag = sum(
                    top - local.get(sender, 0)
                    for sender, top in needed.items()
                )
                if responses > 0 and not needed:
                    self.recovery.mark_live(self.clock.monotonic())
            if not needed:
                return responses, 0
            for sender, top in needed.items():
                lo = local.get(sender, 0) + 1
                self.mesh.broadcast(
                    HistoryRequest(session.nonce, sender, lo, top).encode()
                )
            if self.config.wan.verify_ahead:
                await self._verify_ahead_wait(session, cfg.window)
            else:
                await self.clock.sleep(cfg.window)
            quorate = [
                (vote_key, payload)
                for vote_key, payload in session.payloads.items()
                if len(session.votes.get(vote_key, ())) >= quorum
            ]
            if not quorate:
                return responses, 0
            # verify only what the speculative pass (if any) missed —
            # with verify_ahead on and an idle verifier this list is
            # empty and delivery never blocks on signature checks
            unchecked = [
                (k, p) for k, p in quorate if k not in session.prechecked
            ]
            if unchecked:
                fresh = await self.verifier.verify_many(
                    [(p.sender, p.to_sign(), p.signature)
                     for _, p in unchecked]
                )
                for (k, _), ok in zip(unchecked, fresh):
                    session.prechecked[k] = ok
            candidates = [p for _, p in quorate]
            results = [session.prechecked[k] for k, _ in quorate]
            now = self.clock.monotonic()
            frontier = self.accounts.frontier_nowait()
            applied = 0
            for p, ok in zip(candidates, results):
                if ok and p.sequence > frontier.get(p.sender, 0):
                    # only NEWLY-enqueued payloads count as progress: a
                    # dedup hit on a heap entry parked since the last
                    # session is churn, not advancement:
                    # counting those kept `applied > 0` forever and
                    # defeated the runner's termination condition
                    if self._push_pending(p, now, from_catchup=True):
                        applied += 1
                elif not ok:
                    logger.warning(
                        "catchup payload failed signature check: (%s, %d)",
                        p.sender.hex()[:16],
                        p.sequence,
                    )
            if applied:
                self.catchup_stats["catchup_applied"] += applied
                logger.info("catchup applied %d historical payloads", applied)
                await self._drain_to_fixpoint()
            return responses, applied
        finally:
            self._catchup_session = None

    async def _verify_ahead_wait(
        self, session: _CatchupSession, window: float
    ) -> None:
        """[wan] speculative verify-ahead: slice the quorum wait and
        spend idle verifier capacity pre-verifying parked payloads as
        they stream in, caching verdicts in ``session.prechecked`` so
        the post-quorum apply step never blocks on signature checks.
        Occupancy-gated: a busy verifier (nonzero queue depth — the
        device pool reports one; CpuVerifier has no queue and always
        reads idle) keeps its capacity for live traffic."""
        slices = 4
        for _ in range(slices):
            await self.clock.sleep(window / slices)
            stats_fn = getattr(self.verifier, "stats", None)
            if stats_fn is not None and stats_fn().get("queue_depth", 0):
                continue
            pending = [
                (k, p) for k, p in list(session.payloads.items())
                if k not in session.prechecked
            ]
            if not pending:
                continue
            verdicts = await self.verifier.verify_many(
                [(p.sender, p.to_sign(), p.signature) for _, p in pending]
            )
            for (k, _), ok in zip(pending, verdicts):
                session.prechecked[k] = ok
            self.catchup_stats["catchup_preverified"] += len(pending)

    # -- ingress batching (broadcast/stack.py batched plane) --------------

    async def _flush_batch(self) -> None:
        """Flush the accumulated SendAsset payloads as batch slots (one
        per max_entries chunk — SendAssetBatch can land more than one
        slot's worth at once; a slot must never exceed the wire's entry
        cap). Synchronous SNAPSHOT at entry: concurrent flushes (size
        trigger racing the window timer) see an empty buffer, and
        payloads that arrive while a broadcast_batch below is suspended
        wait for their own window/size trigger instead of leaking out as
        undersized slots (or keeping this flush looping unboundedly)."""
        buf, self._batch_buf = self._batch_buf, []
        limit = self.config.batching.max_entries
        for lo in range(0, len(buf), limit):
            chunk = buf[lo : lo + limit]
            self._batch_seq += 1
            entries_raw = b"".join(p.encode()[1:] for p in chunk)
            batch = TxBatch.create(
                self.config.sign_key, self._batch_seq, entries_raw
            )
            await self.broadcast.broadcast_batch(batch)

    async def _delayed_flush(self, window: float) -> None:
        # Loop until the buffer is observed empty: a payload that arrived
        # while the flush below was suspended (inbox backpressure) saw
        # this task not-done and did NOT schedule a new timer — it relies
        # on this loop picking it up. The empty-check and the task
        # completing are atomic (no await between them, single event
        # loop), so nothing can slip in after the last check.
        while True:
            await self.clock.sleep(window)
            await self._flush_batch()
            if not self._batch_buf:
                return

    # -- gRPC handlers (rpc.rs:256-344) ----------------------------------

    @staticmethod
    def _checked_payload(request, where: str = "") -> tuple:
        """``(payload, "")`` for a well-formed request, ``(None, why)``
        otherwise; the caller aborts, outside its span."""
        if len(request.sender) != 32 or len(request.recipient) != 32:
            return None, f"keys must be 32 bytes{where}"
        if len(request.signature) != 64:
            return None, f"signature must be 64 bytes{where}"
        try:
            thin = ThinTransaction(request.recipient, request.amount)
        except ValueError as exc:
            return None, f"{exc}{where}"
        return Payload(request.sender, request.sequence, thin, request.signature), ""

    def _rpc_span(self, name: str, first, n: int):
        """Open RPC span ``name`` of a call whose first transfer is
        ``first`` (a request or a payload) and which carries ``n``."""
        return self.spans.begin(name, first.sender, first.sequence, n)

    async def _ingest(self, payloads: List[Payload]) -> None:
        """Common ingress tail for SendAsset / SendAssetBatch: ring
        Pending records, then the batcher (or the per-tx plane).
        Fire-and-forget: the ACK is not a commit receipt (rpc.rs:286)."""
        await self.recent.put_many(
            [(p.sender, p.sequence, p.transaction) for p in payloads]
        )
        bcfg = self.config.batching
        if not bcfg.enabled or self._closing:
            # during shutdown, skip the batcher: a flush timer spawned
            # after close() cancelled the old one would be orphaned
            for p in payloads:
                await self.broadcast.broadcast(p)
            return
        self._batch_buf.extend(payloads)
        if len(self._batch_buf) >= bcfg.max_entries:
            await self._flush_batch()
        elif self._batch_flush_task is None or self._batch_flush_task.done():
            self._batch_flush_task = asyncio.create_task(
                self._delayed_flush(bcfg.window)
            )

    # -- ingress admission (config [admission]) --------------------------

    @staticmethod
    def _bucket_refill(
        buckets: Dict[str, list],
        source: str,
        now: float,
        limit: float,
        window: float,
    ) -> list:
        """The source's token bucket ``[tokens, stamp]`` in ``buckets``,
        refilled continuously to ``limit`` over ``window`` seconds. All
        buckets in one dict share (limit, window) — the eviction scan
        below depends on that. Refill is clamped at zero elapsed time:
        a clock stepping backwards (NTP slew, a test's fake clock) must
        neither mint tokens nor DRAIN them via a negative delta."""
        rate = limit / window
        bucket = buckets.get(source)
        if bucket is None:
            if len(buckets) >= ADMISSION_SOURCES_CAP:
                # evict fully-refilled buckets first (they carry no
                # throttling state); if every source is actively failing,
                # drop the oldest — it restarts with a full bucket
                full = [
                    k
                    for k, (t, s) in buckets.items()
                    if t + max(0.0, now - s) * rate >= limit
                ]
                for k in full:
                    del buckets[k]
                if len(buckets) >= ADMISSION_SOURCES_CAP:
                    buckets.pop(next(iter(buckets)))
            bucket = [float(limit), now]
            buckets[source] = bucket
        else:
            elapsed = max(0.0, now - bucket[1])
            bucket[0] = min(float(limit), bucket[0] + elapsed * rate)
            # the stamp never moves backwards: re-crediting an interval
            # the bucket already refilled over would mint free tokens
            bucket[1] = max(bucket[1], now)
        return bucket

    def _admission_refill(self, source: str, now: float) -> list:
        ad = self.config.admission
        return self._bucket_refill(
            self._admission_buckets, source, now, ad.fail_limit, ad.fail_window
        )

    def _register_refill(self, source: str, now: float) -> list:
        ad = self.config.admission
        return self._bucket_refill(
            self._register_buckets,
            source,
            now,
            ad.register_limit,
            ad.register_window,
        )

    async def _admit(self, payloads: List[Payload], context) -> None:
        """Pre-verify client signatures at the RPC boundary: ONE
        ``Verifier.verify_many`` call per admission batch (the same
        CPU/CUDA seam the broadcast workers use). Entries failing it are
        rejected HERE — they never reach the gossip plane, so one
        poisoned entry can no longer stall a whole broadcast slot. The
        per-source bucket is charged only for FAILED entries; a source
        that exhausted it is refused before any verifier work.

        Overload shedding (node/overload.py, config [overload]) happens
        FIRST: a shed request costs no verifier work and must NOT charge
        the sender's fail bucket — refusing valid work under pressure is
        the node's state, not evidence against the sender. Shed
        responses carry a typed ``retry_after_ms`` hint.

        The ``at2.rpc.gate`` span covers the gate and the bucket, up to
        the verifier call; a refusal aborts after it closes."""
        sp = self.spans
        h = self._rpc_span("at2.rpc.gate", payloads[0], len(payloads)) if sp.on else None
        try:
            refusal = self._overload_gate(payloads)
            items = None
            ad = self.config.admission
            if refusal is None and ad.preverify and self.verifier is not None:
                peer_fn = getattr(context, "peer", None)
                source = peer_fn() if callable(peer_fn) else "local"
                bucket = self._admission_refill(source, self.clock.monotonic())
                if bucket[0] < 1.0:
                    self.admission_stats["admission_throttled"] += 1
                    # terminal trace stamp + flight-record BEFORE the abort
                    # raises: a throttled tx's trace must retire into the
                    # completed ring, not linger until cap eviction
                    self._trace_stamp(payloads, REJECTED)
                    self.recorder.record(
                        "admit_throttle", (len(payloads), source)
                    )
                    refusal = "too many invalid signatures from this source; retry later"
                else:
                    items = [(p.sender, p.to_sign(), p.signature) for p in payloads]
        finally:
            if h is not None:
                sp.end(h)
        if refusal is not None:
            await context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, refusal)
        if items is None:
            return
        results = await self.verifier.verify_many(items)
        bad = [i for i, ok in enumerate(results) if not ok]
        if not bad:
            return
        self.admission_stats["rejected_at_ingress"] += len(bad)
        bucket[0] = max(0.0, bucket[0] - len(bad))
        # admission is all-or-nothing: the whole request aborts, so EVERY
        # entry's trace terminates here (the bad ones failed verification,
        # the good ones were refused alongside them and may retry under a
        # fresh ingress)
        self._trace_stamp(payloads, REJECTED)
        self.recorder.record("admit_reject", (len(bad), source))
        await context.abort(
            grpc.StatusCode.INVALID_ARGUMENT,
            "client signature verification failed"
            + (f" (entries {bad})" if len(payloads) > 1 else ""),
        )

    def _overload_gate(self, payloads: List[Payload]) -> Optional[str]:
        """The adaptive-admission actuator: one deterministic shed
        decision per client request, taken before any verifier work;
        the details to refuse it with, or None to admit it.
        Senders already in the gossiped directory get the configured
        grace (the crowd is, almost by definition, unknown senders).
        Protocol traffic never passes through here — only client
        ingress is sheddable."""
        ov = self.overload
        if not ov.cfg.enabled:
            return None
        now = self.clock.monotonic()
        # lazy sample: the sim has no standing probe loop, so ingress is
        # where the pressure score stays fresh (rate-limited inside)
        ov.maybe_sample(now)
        registered = all(
            self.directory.id_of(p.sender) is not None for p in payloads
        )
        retry_ms = ov.admit(registered=registered, now=now)
        if retry_ms is None:
            return None
        self.overload_stats["overload_shed_requests"] += 1
        self.overload_stats["overload_shed_entries"] += len(payloads)
        self._trace_stamp(payloads, REJECTED)
        self.recorder.record(
            "overload_shed",
            (
                len(payloads),
                "registered" if registered else "new",
                round(ov.pressure, 4),
                retry_ms,
            ),
        )
        return format_shed_details("ingress shed under overload", retry_ms)

    def _trace_begin(self, payloads: List[Payload]) -> None:
        if self.tx_trace.enabled:
            now = self.clock.monotonic()
            for p in payloads:
                self.tx_trace.begin((p.sender, p.sequence), now)

    def _trace_stamp(self, payloads: List[Payload], stage: str) -> None:
        if self.tx_trace.enabled:
            now = self.clock.monotonic()
            for p in payloads:
                self.tx_trace.stamp((p.sender, p.sequence), stage, now)

    async def _admitted(self, payloads: List[Payload]) -> None:
        """The post-admission stamp and ``_ingest``, each in its span. The
        awaits in ``_ingest`` suspend only on a full inbox: the ring's
        lock is never held across a suspension."""
        sp = self.spans
        h = self._rpc_span("at2.rpc.stamp", payloads[0], len(payloads)) if sp.on else None
        try:
            self._trace_stamp(payloads, "admitted")
        finally:
            if h is not None:
                sp.end(h)
        h = self._rpc_span("at2.rpc.ingest", payloads[0], len(payloads)) if sp.on else None
        try:
            await self._ingest(payloads)
        finally:
            if h is not None:
                sp.end(h)

    async def SendAsset(self, request, context):
        sp = self.spans
        h = self._rpc_span("at2.rpc.validate", request, 1) if sp.on else None
        try:
            payload, error = self._checked_payload(request)
            if payload is not None:
                self._trace_begin([payload])
        finally:
            if h is not None:
                sp.end(h)
        if error:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, error)
        await self._admit([payload], context)
        await self._admitted([payload])
        return pb.SendAssetReply()

    async def SendAssetBatch(self, request, context):
        """Beyond-parity bulk ingress (at2.proto documents the contract):
        semantically identical to one SendAsset per entry, one RPC
        round-trip. The whole request is validated — shape first, then
        client signatures via ingress pre-verification (config
        [admission]) — before any entry is admitted (all-or-nothing
        admission with per-entry rejection detail; commit outcomes stay
        per-entry, exactly like separate SendAssets)."""
        if not request.transactions:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, "empty batch"
            )
        if len(request.transactions) > MAX_BATCH_ENTRIES:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                f"batch exceeds {MAX_BATCH_ENTRIES} transactions",
            )
        sp = self.spans
        h = (
            self._rpc_span("at2.rpc.validate", request.transactions[0], len(request.transactions))
            if sp.on
            else None
        )
        try:
            payloads, error = [], ""
            for i, req in enumerate(request.transactions):
                payload, error = self._checked_payload(req, f" (entry {i})")
                if error:
                    break
                payloads.append(payload)
            else:
                self._trace_begin(payloads)
        finally:
            if h is not None:
                sp.end(h)
        if error:
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, error)
        await self._admit(payloads, context)
        await self._admitted(payloads)
        return pb.SendAssetReply()

    async def GetBalance(self, request, context):
        amount = await self.accounts.get_balance(request.sender)
        return pb.GetBalanceReply(amount=amount)

    async def GetLastSequence(self, request, context):
        sequence = await self.accounts.get_last_sequence(request.sender)
        return pb.GetLastSequenceReply(sequence=sequence)

    async def GetCertificate(self, request, context):
        """Finality lane (finality/): the retained certificate chain in
        binary form plus this node's LIVE commit frontier — the frontier
        lets wait_final() know when a future certificate must cover its
        transfer (certificates are emitted at audit_every strides, so
        one more stride always closes the gap)."""
        if self.certs is None:
            return fpb.GetCertificateReply(
                enabled=False, node_commits=self.auditor.commits
            )
        return fpb.GetCertificateReply(
            enabled=True,
            epoch=self.certs.epoch,
            node_commits=self.auditor.commits,
            certificates=[c.encode() for c in self.certs.chain],
        )

    async def GetLatestTransactions(self, request, context):
        txs = await self.recent.get_all()
        return pb.GetLatestTransactionsReply(
            transactions=[
                pb.FullTransaction(
                    timestamp=rfc3339(tx.timestamp),
                    sender=tx.sender,
                    recipient=tx.recipient,
                    amount=tx.amount,
                    state=tx.state.value,
                    sender_sequence=tx.sender_sequence,
                )
                for tx in txs
            ]
        )

    # -- broker ingress tier (node/directory.py, proto/distill.py) --------

    def _on_directory(self, peer: Peer, msg: DirectoryAnnounce) -> None:
        """Broadcast-worker hook (synchronous): install gossiped
        directory mappings. The stride check runs against the CHANNEL
        peer's rank — authenticated by the mesh handshake — not the
        frame's origin field, so a byzantine peer can only announce into
        its own id stride (and even there, only poison liveness: wrong
        keys just fail entry signature verification locally)."""
        rank = self._node_ranks.get(peer.sign_public)
        if rank is None:
            return
        applied = 0
        for client_id, pubkey in msg.entries:
            if self.directory.apply(client_id, pubkey, rank=rank):
                applied += 1
        if applied:
            self.recorder.record("dir_apply", (applied, rank))

    async def Register(self, request, context):
        """Directory registration (at2.proto): assign — or look up — the
        dense client-id for a pubkey and announce the mapping to peers.

        A NEW assignment permanently grows every node's directory array,
        pubkey map, and checkpoint, so it is charged against the source's
        register token bucket (config [admission] register_limit/
        register_window) and refused outright once this node's stride is
        full (node/directory.py MAX_CLIENTS_PER_RANK). Idempotent
        re-registration of a known key is free.

        The announce goes out on every call whose id falls in THIS
        node's stride, not just first assignment: a client retrying
        Register doubles as a gossip repair for mappings peers may have
        missed. Ids learned via gossip from another node's stride are
        NOT re-announced — receivers validate announce ids against the
        announcing peer's stride and would silently drop them; repair
        for those belongs to their assigning node."""
        key = bytes(request.public_key)
        if len(key) != 32 or key == b"\x00" * 32:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT,
                "public_key must be 32 nonzero bytes",
            )
        client_id = self.directory.id_of(key)
        if client_id is None:
            peer_fn = getattr(context, "peer", None)
            source = peer_fn() if callable(peer_fn) else "local"
            bucket = self._register_refill(source, self.clock.monotonic())
            if bucket[0] < 1.0:
                self.admission_stats["admission_throttled"] += 1
                await context.abort(
                    grpc.StatusCode.RESOURCE_EXHAUSTED,
                    "registration rate exceeded for this source; retry later",
                )
            try:
                client_id, created = self.directory.assign(key)
            except DirectoryFullError:
                await context.abort(
                    grpc.StatusCode.RESOURCE_EXHAUSTED,
                    "client directory full on this node",
                )
            if created:
                bucket[0] = max(0.0, bucket[0] - 1.0)
        if (
            self.mesh is not None
            and self.mesh.peers
            and client_id % self.directory.total == self.directory.rank
        ):
            self.mesh.broadcast(
                DirectoryAnnounce(
                    self.config.sign_key.public, ((client_id, key),)
                ).encode()
            )
        return pb.RegisterReply(client_id=client_id)

    def _expand_distilled(self, frame: bytes):
        """Parse + directory-expand one distilled frame: a single
        GIL-released native call when the library is ready, the Python
        reference codec otherwise (identical acceptance set —
        differential-tested). Returns ``(bodies, ids, ok)`` lists or
        ``None`` for a malformed frame."""
        from ..native.ingest import distill_parse_native, ingest_ready_or_kick

        if ingest_ready_or_kick():
            res = distill_parse_native(frame, *self.directory.keys_view())
            if res is None:
                return None
            bodies, ids_arr, ok_arr = res
            return bodies, ids_arr.tolist(), ok_arr.tolist()
        try:
            bodies_ba, ids, ok = distill.expand_py(frame, self.directory.get)
        except distill.DistillError:
            return None
        return bytes(bodies_ba), ids, ok

    async def SendDistilledBatch(self, request, context):
        """Broker-built distilled batch (proto/distill.py wire format).

        Unlike `_admit`'s all-or-nothing contract, admission here is
        PER-ENTRY: one frame aggregates many mutually-independent
        clients, so a bad signature drops alone — charged to its OWN
        client-id's token bucket, never the broker's — and cannot censor
        co-batched traffic. The broker's identity stays entirely outside
        the trust boundary: it can withhold or replay, but every entry
        it forwards is still client-signed over canonical bytes.
        ACK means "accepted what survived", never a commit receipt."""
        if self._closing:
            await context.abort(
                grpc.StatusCode.UNAVAILABLE, "node shutting down"
            )
        expanded = self._expand_distilled(bytes(request.frame))
        if expanded is None:
            await context.abort(
                grpc.StatusCode.INVALID_ARGUMENT, "malformed distilled frame"
            )
        bodies, ids, ok = expanded
        self.distill_stats["distilled_batches_rx"] += 1
        self.recorder.record("distill_rx", (len(ok),))
        misses = len(ok) - sum(ok)
        if misses:
            self.distill_stats["directory_misses"] += misses
            # a miss means this node's gossiped directory lags the
            # assigning node — the usual explanation for broker-era
            # "frames arrive but nothing commits" stalls, so it earns a
            # flight-recorder event, not just a counter
            self.recorder.record("dir_miss", (misses, len(ok)))
        now = self.clock.monotonic()
        seen = self._distill_seen
        E = distill.ENTRY_WIRE
        ad = self.config.admission
        preverify = ad.preverify and self.verifier is not None
        ov = self.overload
        ov_on = ov.cfg.enabled
        if ov_on:
            ov.maybe_sample(now)
        n_dedup = 0
        n_shed = 0
        kept: List[int] = []
        keys: List[Tuple[int, int]] = []
        for i, cid in enumerate(ids):
            if not ok[i]:
                continue
            base = i * E
            k = (cid, int.from_bytes(bodies[base + 32 : base + 36], "little"))
            if k in seen:
                self.distill_stats["dedup_drops"] += 1
                n_dedup += 1
                continue
            # overload shedding is per-entry here (the frame is a
            # many-sender aggregate; all-or-nothing would punish every
            # broker client for pressure one caused). Distilled entries
            # are directory-resolved by construction, so they shed on
            # the registered (graced) ramp — and a shed must NOT charge
            # the cid's fail bucket, so it runs before the refill.
            if ov_on and ov.admit(registered=True, now=now) is not None:
                n_shed += 1
                continue
            if preverify:
                bucket = self._admission_refill(f"cid:{cid}", now)
                if bucket[0] < 1.0:
                    self.admission_stats["admission_throttled"] += 1
                    continue
            kept.append(i)
            keys.append(k)
        if n_dedup:
            # aggregated per frame (not per entry): a replaying broker
            # must not be able to flood the ring via its own dups
            self.recorder.record("dedup_drop", (n_dedup, len(ok)))
        if n_shed:
            self.overload_stats["overload_shed_distilled"] += n_shed
            self.recorder.record(
                "overload_shed_distilled",
                (n_shed, len(ok), round(ov.pressure, 4)),
            )
            if not kept:
                # the whole frame was shed: surface typed backpressure
                # to the broker instead of a silent empty ACK, so its
                # forwarding loop (and its clients' retry budgets) can
                # back off on the hint
                await context.abort(
                    grpc.StatusCode.RESOURCE_EXHAUSTED,
                    format_shed_details(
                        "distilled ingress shed under overload",
                        ov.retry_after_ms(),
                    ),
                )
        if preverify and kept:
            # the v2 transfer preimage is TAG + the first 76 body bytes
            # (sender || seq || recipient || amount — types.py), so a
            # broker re-encoding a captured signature at another sequence
            # changes the preimage and fails right here
            results = await self.verifier.verify_many(
                [
                    (
                        bodies[i * E : i * E + 32],
                        TRANSFER_SIG_TAG + bodies[i * E : i * E + 76],
                        bodies[i * E + 76 : i * E + 140],
                    )
                    for i in kept
                ]
            )
            good, good_keys, n_bad = [], [], 0
            for i, k, okv in zip(kept, keys, results):
                if okv:
                    good.append(i)
                    good_keys.append(k)
                else:
                    n_bad += 1
                    bucket = self._admission_refill(f"cid:{k[0]}", now)
                    bucket[0] = max(0.0, bucket[0] - 1.0)
            if n_bad:
                self.admission_stats["rejected_at_ingress"] += n_bad
                self.recorder.record("distill_reject", (n_bad, len(kept)))
            kept, keys = good, good_keys
        if kept:
            # mark seen only for entries actually ingested: a client whose
            # signature failed (or who was throttled) may legitimately
            # resubmit the same (id, seq) corrected later
            for k in keys:
                if len(seen) >= DISTILL_SEEN_CAP:
                    seen.pop(next(iter(seen)))
                seen[k] = None
            await self._ingest_distilled(bodies, kept)
        return pb.SendAssetReply()

    async def _ingest_distilled(self, bodies: bytes, kept: List[int]) -> None:
        """Ingress tail for surviving distilled entries. The expanded
        bodies already ARE the batched plane's ``entries_raw`` layout, so
        the hot path slices them straight into TxBatch slots — decoding
        per-entry Payload objects here would reintroduce exactly the
        per-entry Python cost the distilled format exists to avoid."""
        E = distill.ENTRY_WIRE
        bcfg = self.config.batching
        if not bcfg.enabled or self._closing:
            # the slow path mirrors _ingest's semantics exactly (sim
            # configs disable batching; shutdown must not spawn timers)
            payloads = [
                Payload.decode_body(bodies[i * E : (i + 1) * E]) for i in kept
            ]
            await self.recent.put_many(
                [(p.sender, p.sequence, p.transaction) for p in payloads]
            )
            for p in payloads:
                await self.broadcast.broadcast(p)
            return
        if self.tx_trace.enabled:
            now = self.clock.monotonic()
            for i in kept:
                base = i * E
                key = (
                    bodies[base : base + 32],
                    int.from_bytes(bodies[base + 32 : base + 36], "little"),
                )
                self.tx_trace.begin(key, now)
                self.tx_trace.stamp(key, "admitted", now)
        # the recent ring holds 10 entries (ledger/recent.py): feeding it
        # the batch tail leaves observably identical ring state without
        # per-entry decode of the whole frame
        tail = [
            Payload.decode_body(bodies[i * E : (i + 1) * E])
            for i in kept[-10:]
        ]
        await self.recent.put_many(
            [(p.sender, p.sequence, p.transaction) for p in tail]
        )
        if len(kept) * E == len(bodies):
            entries_raw = bodies  # nothing dropped: zero-copy
        else:
            entries_raw = b"".join(
                bodies[i * E : (i + 1) * E] for i in kept
            )
        limit = bcfg.max_entries * E
        for lo in range(0, len(entries_raw), limit):
            self._batch_seq += 1
            batch = TxBatch.create(
                self.config.sign_key, self._batch_seq, entries_raw[lo : lo + limit]
            )
            await self.broadcast.broadcast_batch(batch)

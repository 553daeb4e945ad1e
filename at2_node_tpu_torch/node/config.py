"""Server TOML configuration.

Counterpart of ``at2_node_tpu/node/config.py``.

Same schema and operator workflow as the reference
(`at2-node/src/bin/server/config.rs:6-38`): a `Config{addresses
{node, rpc}, keys{sign, network}, nodes = [{address, public_key}]}` TOML
document piped via stdin/stdout, peers appended by textually concatenating
`config get-node` fragments (`at2-node/README.md:26-27`,
`at2-node/tests/cli.rs:172-184`).

Two conscious additions over the reference schema:

* each `[[nodes]]` row also carries `sign_public_key` — this build's nodes
  sign their own Echo/Ready attestations (the work the CUDA verifier
  batches), so peers must know each other's ed25519 keys, not only the
  channel (X25519) keys;
* an optional `[verifier]` table — `kind = "cpu" | "cuda" | "pool"`,
  `batch_size`, `max_delay`, `mode`, `rlc_min_batch` — the verifier plugin
  selection. ``"cuda"`` is the counterpart of the JAX package's ``"tpu"``:
  the batch verifier on the first CUDA device, which never falls back to
  the CPU. It is the default, so ``config new`` writes it (the JAX package
  writes ``"cpu"``); ``config new --verifier cpu`` writes the host verifier
  for a host without a card. ``"pool"`` splits each batch over every
  local CUDA device (``parallel/pool.py``; only ``batch_size`` and
  ``max_delay`` apply). A ``"tpu"`` table raises ``ValueError`` naming
  ``"cuda"``;
* an optional `[observability]` table — `stats_interval` (seconds between
  structured stats log lines; 0 disables), `profile_dir` (when set, a
  `torch.profiler` trace of the node, CUDA activity included when the
  verifier is on the card, is exported there as a Chrome trace),
  `endpoints` (GET /metrics /healthz /statusz on the public RPC port),
  and `trace_sample` / `trace_cap` (tx-lifecycle tracer sampling and
  cardinality bounds, obs/trace.py), plus the fleet-audit knobs
  `audit_every` / `audit_interval` / `audit_history` / `capture_cap`
  (state-digest beacons and the wire-capture ring, obs/audit.py);
* an optional `[slo]` table — declarative service-level objectives
  (commit-latency p99 ceiling, throughput floor, rejection-rate ceiling,
  quorum-stall budget) evaluated with multi-window burn rates and served
  on GET /sloz (see `SloConfig` and obs/slo.py);
* an optional `[checkpoint]` table — `path` (ledger snapshot file;
  restored on start when present) and `interval` (seconds between
  snapshots) — implements the reference's open "store state on disk to
  restart after crash" roadmap item (`at2-node/README.md:52`);
* an optional `[catchup]` table — `enabled`, `quorum`, `after`, `window`,
  `history_cap` (see `CatchupConfig`) — implements the reference's open
  "catchup mechanism" roadmap item (`at2-node/README.md:53`);
* an optional `[batching]` table — `enabled`, `max_entries`, `window`
  (see `BatchingConfig`) — ingress transaction batching over the batched
  broadcast plane (broadcast/stack.py); `enabled = false` restores the
  reference's one-transaction-per-broadcast-slot behavior exactly;
* an optional `[admission]` table — `preverify`, `fail_limit`,
  `fail_window` (see `AdmissionConfig`) — ingress pre-verification of
  client signatures at the RPC boundary plus a per-source rate limit on
  entries that FAIL it; `preverify = false` restores the previous
  admit-then-verify-in-broadcast behavior exactly;
* an optional `[overload]` table — closed-loop overload control (see
  `OverloadConfig` and node/overload.py): a smoothed pressure score over
  the live signals drives adaptive admission shedding and broker
  brownout; `enabled = false` (the default) is fully inert and keeps
  every same-seed wire schedule byte-identical.
"""

from __future__ import annotations

try:
    import tomllib
except ModuleNotFoundError:  # Python < 3.11: tomli is the same parser
    import tomli as tomllib
from dataclasses import dataclass, field
from typing import List, Optional, TextIO

from ..crypto.keys import ExchangeKeyPair, SignKeyPair
from ..net.peers import Peer


@dataclass
class VerifierConfig:
    # the entry points run on the card unless the config asks for the CPU
    kind: str = "cuda"
    batch_size: int = 256
    max_delay: float = 0.002
    # Amortized verification: "auto" routes big clean batches to one RLC
    # check per flush (on the CUDA kind only with rlc_min_batch set), "rlc"
    # forces the RLC path (the CUDA kind's RLC kernels, or the CPU kind's
    # host engine), "per_sig" pins per-signature verification.
    mode: str = "auto"
    # Smallest flush worth one RLC check. None keeps each verifier's
    # default: 128 on the CPU engine, opt-out on the CUDA kind — setting
    # it there is an opt-in to the device RLC route.
    rlc_min_batch: Optional[int] = None

    def __post_init__(self) -> None:
        if self.kind == "tpu":
            raise ValueError(
                'verifier.kind "tpu" is the JAX build\'s; this build\'s device '
                'verifier is kind = "cuda"'
            )

    def make(self):
        from ..crypto.verifier import make_verifier

        rlc_kw = (
            {} if self.rlc_min_batch is None
            else {"rlc_min_batch": self.rlc_min_batch}
        )
        # Route every kind through make_verifier so an unknown kind raises
        # instead of silently degrading the device path to per-signature
        # CPU verification.
        if self.kind == "cpu":
            return make_verifier("cpu", mode=self.mode, **rlc_kw)
        if self.kind == "pool":
            # the device pool over every local CUDA device; it splits the
            # per-signature kernel regardless of mode
            return make_verifier(
                self.kind, batch_size=self.batch_size, max_delay=self.max_delay
            )
        return make_verifier(
            self.kind,
            batch_size=self.batch_size,
            max_delay=self.max_delay,
            mode=self.mode,
            **rlc_kw,
        )


@dataclass
class ObservabilityConfig:
    """Runtime telemetry (obs/ package, TECHNICAL.md "Observability").
    ``endpoints`` serves GET /metrics, /healthz, /statusz on the node's
    public RPC port through the mux (on by default: the endpoints are
    read-only views and share the mux's connection caps).
    ``trace_sample`` = trace every Nth ingress transaction through the
    lifecycle tracker (1 = all, 0 = off); ``trace_cap`` bounds live
    (uncommitted) traces — see obs/trace.py for the eviction policy.
    ``trace_done_cap`` bounds the completed-trace ring served on
    /tracez; ``recorder_cap`` sizes the protocol flight-recorder ring
    served on /debugz (obs/recorder.py; 0 disables recording).

    Continuous profiler (obs/profiler.py, TECHNICAL.md "Continuous
    profiling & plane time-accounting"): ``profilez`` is the kill-switch
    for GET /profilez and the healthz degraded-edge stack capture;
    ``profiler_hz``/``profiler_max_nodes`` size the sampling stack
    profiler; ``profiler_duration`` is the default capture length for
    on-demand and edge-triggered captures; ``lag_probe_interval`` paces
    the event-loop lag probe (0 disables; the standing loop only runs on
    served nodes — never under sim); ``phase_accounting`` arms the plane
    time-accounting seam (phase counters accumulate under sim too — they
    never feed the wire trace).

    Fleet audit plane (obs/audit.py, TECHNICAL.md "Fleet audit &
    incident capture"): ``audit_every`` emits a signed state-digest
    beacon every Nth committed transfer (0 disables; commit-count
    triggered, so emission is deterministic under sim and identical
    across plane shard counts); ``audit_interval`` additionally paces a
    wall-clock beacon on served nodes so an idle fleet still
    cross-checks (0 disables; never runs under sim); ``audit_history``
    bounds the local audit-point ring beacons are compared against.
    ``capture_cap`` sizes the real Mesh's inbound wire-capture ring
    ((mono_ns, peer, kind, frame) records served on /capturez, the
    input to tools/capture_replay.py; 0 disables — the flight-recorder
    kill-switch shape)."""

    stats_interval: float = 0.0  # seconds between stats lines; 0 = off
    profile_dir: str = ""  # torch.profiler trace output dir; "" = off
    endpoints: bool = True  # GET /metrics /healthz /statusz on the mux
    trace_sample: int = 1  # trace every Nth ingress tx; 0 disables
    trace_cap: int = 8192  # max live (uncommitted) traces
    trace_done_cap: int = 1024  # completed traces retained for /tracez
    recorder_cap: int = 2048  # flight-recorder ring size; 0 disables
    profilez: bool = True  # GET /profilez + degraded-edge capture
    profiler_hz: float = 97.0  # stack sampler frequency
    profiler_max_nodes: int = 20000  # stack-tree node budget
    profiler_duration: float = 10.0  # default capture length, seconds
    lag_probe_interval: float = 0.05  # event-loop lag probe pace; 0 = off
    phase_accounting: bool = True  # plane time-accounting seam
    audit_every: int = 256  # beacon every Nth commit; 0 disables
    audit_interval: float = 5.0  # idle-fleet beacon pace (served); 0 = off
    audit_history: int = 512  # local audit points kept for comparison
    capture_cap: int = 512  # inbound wire-capture ring size; 0 disables

    def __post_init__(self) -> None:
        if self.trace_sample < 0:
            raise ValueError("observability.trace_sample must be >= 0")
        if self.trace_cap < 1:
            raise ValueError("observability.trace_cap must be >= 1")
        if self.trace_done_cap < 1:
            raise ValueError("observability.trace_done_cap must be >= 1")
        if self.recorder_cap < 0:
            raise ValueError("observability.recorder_cap must be >= 0")
        if self.profiler_hz <= 0:
            raise ValueError("observability.profiler_hz must be > 0")
        if self.profiler_max_nodes < 1:
            raise ValueError("observability.profiler_max_nodes must be >= 1")
        if self.profiler_duration <= 0:
            raise ValueError("observability.profiler_duration must be > 0")
        if self.lag_probe_interval < 0:
            raise ValueError("observability.lag_probe_interval must be >= 0")
        if self.audit_every < 0:
            raise ValueError("observability.audit_every must be >= 0")
        if self.audit_interval < 0:
            raise ValueError("observability.audit_interval must be >= 0")
        if self.audit_history < 8:
            raise ValueError("observability.audit_history must be >= 8")
        if self.capture_cap < 0:
            raise ValueError("observability.capture_cap must be >= 0")


@dataclass
class SloConfig:
    """Service-level objectives (obs/slo.py): declarative targets
    evaluated live with multi-window burn rates, served on GET /sloz and
    folded into /healthz. ``probe_interval`` is the sampling cadence of
    the background probe (only runs on a real served node; the simulator
    evaluates cells offline). The default targets are deliberately
    lenient — they flag a broken node, not a slow one; tighten per
    deployment. A target <= 0 disables that objective; ``enabled =
    false`` disables probing and /sloz reports no_data forever."""

    enabled: bool = True
    fast_window: float = 30.0  # fast burn window, seconds
    slow_window: float = 300.0  # slow burn window, seconds
    probe_interval: float = 2.0  # seconds between probe samples
    latency_p99_ms: float = 2000.0  # ingress→commit p99 ceiling
    throughput_floor_tps: float = 0.0  # committed tx/s floor; 0 = off
    rejection_ratio_max: float = 0.95  # rejected/(rej+committed) ceiling
    stall_budget: float = 0.5  # commit-stalled fraction of window

    def __post_init__(self) -> None:
        if self.fast_window <= 0 or self.slow_window <= 0:
            raise ValueError("slo windows must be > 0")
        if self.probe_interval <= 0:
            raise ValueError("slo.probe_interval must be > 0")


@dataclass
class CheckpointConfig:
    path: str = ""  # ledger snapshot file; "" disables checkpointing
    interval: float = 30.0  # seconds between periodic snapshots


@dataclass
class StoreConfig:
    """Durable sharded store (store/): per-account-range
    segment files + a write-ahead delta log of committed slots, committed
    atomically by a manifest rename. Supersedes the monolithic
    ``[checkpoint]`` snapshot (still honored: when only ``[checkpoint]``
    is configured the old path runs unchanged, and when BOTH are set an
    existing monolithic snapshot seeds an uninitialized store — the
    one-shot migration). ``flush_interval`` is the seconds between
    incremental flushes (dirty shards only); ``shards`` fixes the
    account-range partition width at store creation; ``sync`` is the WAL
    append discipline (``"buffered"`` = durable at next flush,
    ``"always"`` = fsync per commit); ``history_cap`` bounds retained
    per-sender history bodies (mirrors catchup.history_cap)."""

    dir: str = ""  # store directory; "" disables the sharded store
    flush_interval: float = 5.0  # seconds between incremental flushes
    shards: int = 16
    sync: str = "buffered"  # "buffered" | "always"
    history_cap: int = 1 << 17

    def __post_init__(self) -> None:
        if self.sync not in ("buffered", "always"):
            raise ValueError('store.sync must be "buffered" or "always"')
        if self.shards < 1:
            raise ValueError("store.shards must be >= 1")
        if self.flush_interval <= 0:
            raise ValueError("store.flush_interval must be > 0")


@dataclass
class MembershipConfig:
    """Epoch-based membership reconfiguration (node/membership.py).
    ``admin_public`` is the hex ed25519 key every CONFIG_TX must verify
    against; "" disables reconfiguration entirely (config transactions
    are dropped). ``grace`` is the window, in seconds after an epoch
    transition, during which messages stamped with the PREVIOUS epoch
    are still accepted — covers transactions already in flight when the
    transition lands."""

    admin_public: str = ""  # hex ed25519 admin key; "" disables
    grace: float = 5.0

    def __post_init__(self) -> None:
        if self.grace < 0:
            raise ValueError("membership.grace must be >= 0")


@dataclass
class CatchupConfig:
    """Ledger-history catchup (ledger/history.py): a rejoining node pulls
    quorum-confirmed committed history from peers and replays it through
    the sequence gate. ``quorum`` = peers that must agree on a slot's
    content hash before it is applied (0 → the node's ready threshold;
    set >= f+1 for byzantine tolerance). ``after`` = seconds a sequence
    gap must persist in the retry heap before a catchup session starts.
    ``window`` = seconds a session waits for index/batch responses.
    ``history_cap`` = committed payloads retained for serving peers —
    the catchup HORIZON: a node absent for more commits than every
    peer's history_cap cannot re-converge via catchup alone (sessions
    back off exponentially rather than churn). The supported operator
    path is a LOCAL checkpoint ([checkpoint] table) whose frontier is
    within the horizon: restore-from-own-checkpoint + catchup-of-the-
    tail is tested end-to-end (tests/test_faults.py
    TestBeyondHorizonRejoin). Peer checkpoints cannot be transplanted
    safely (ledger/history.py docstring: balances are functions of full
    history in a consensus-free ledger), so size history_cap to cover
    the longest absence your checkpoint cadence allows."""

    enabled: bool = True
    quorum: int = 0
    after: float = 3.0
    window: float = 1.0
    history_cap: int = 1 << 17


@dataclass
class BatchingConfig:
    """Ingress transaction batching (broadcast/stack.py module docstring:
    the batched broadcast plane). ``max_entries`` caps one batch slot
    (wire hard cap 1024); ``window`` is the flush timer — the latency a
    lone transaction pays for batching. ``enabled = false`` restores the
    reference's one-payload-per-slot surface
    (`at2-node/src/bin/server/rpc.rs:275-284`) exactly; relayed
    batches from peers are always understood either way."""

    enabled: bool = True
    max_entries: int = 256
    window: float = 0.005

    def __post_init__(self) -> None:
        from ..broadcast.messages import MAX_BATCH_ENTRIES

        if not 1 <= self.max_entries <= MAX_BATCH_ENTRIES:
            raise ValueError(
                f"batching.max_entries must be in [1, {MAX_BATCH_ENTRIES}]"
            )


@dataclass
class AdmissionConfig:
    """Ingress admission control (node/service.py SendAsset /
    SendAssetBatch). With ``preverify`` on, every admission batch runs
    its client signatures through ONE ``Verifier.verify_many`` call (the
    same CPU/CUDA seam the broadcast plane uses) and entries that fail
    are rejected at the RPC boundary with a per-entry status —
    unauthenticated spam never enters the gossip plane at all.
    ``fail_limit`` / ``fail_window`` shape a per-source token bucket
    charged ONLY for entries that fail pre-verification, so a hostile
    client cannot use the verifier itself as a DoS lever: up to
    ``fail_limit`` failed entries per source are tolerated per bucket,
    refilling continuously over ``fail_window`` seconds; beyond that the
    source's requests are rejected outright (RESOURCE_EXHAUSTED) without
    spending any verifier throughput. Honest clients never pay: valid
    entries cost zero tokens. ``preverify = false`` restores the
    previous behavior (admit everything, verification happens inside the
    broadcast workers).

    ``register_limit`` / ``register_window`` shape a SEPARATE per-source
    bucket charged one token per NEW directory assignment (Register,
    node/service.py): unlike a failed signature, a registration grows
    every node's directory and checkpoint permanently, so even
    well-formed calls are rate-bounded. The defaults (1024 per 2 s)
    clear a broker warming up thousands of clients in seconds while
    keeping a flooder's permanent-growth rate bounded; the hard backstop
    is the per-stride cap (node/directory.py MAX_CLIENTS_PER_RANK)."""

    preverify: bool = True
    fail_limit: int = 64
    fail_window: float = 10.0
    register_limit: int = 1024
    register_window: float = 2.0

    def __post_init__(self) -> None:
        if self.fail_limit < 1:
            raise ValueError("admission.fail_limit must be >= 1")
        if self.fail_window <= 0:
            raise ValueError("admission.fail_window must be > 0")
        if self.register_limit < 1:
            raise ValueError("admission.register_limit must be >= 1")
        if self.register_window <= 0:
            raise ValueError("admission.register_window must be > 0")


@dataclass
class PlaneConfig:
    """The `[plane]` table: broadcast-plane sharding (broadcast/shards.py).

    ``shards = 1`` (the default) keeps the monolithic single-loop plane —
    the production-safe configuration every existing deployment runs.
    ``shards > 1`` partitions slot state per origin key across that many
    shard cores; ``executor`` picks where their drain work runs:
    ``"thread"`` (one OS thread per shard; scaling comes from the
    GIL-released native kernels), ``"process"`` (one spawn worker
    process per shard over shared-memory rings — true parallelism for
    the Python-level admission/quorum/verify work, see
    parallel/plane_worker.py), or ``"inline"`` (synchronous on the
    event loop — the deterministic mode the sim forces, also useful to
    measure sharding overhead without threads). ``workers`` is the
    owner-loop drain task count for the sharded ingress.

    ``ring_slots`` / ``ring_slot_bytes`` size the per-shard
    shared-memory rings process mode uses (parallel/ring.py): each of
    the three rings per shard (actions, effects, obs) is ``ring_slots *
    ring_slot_bytes`` of /dev/shm. A record that does not fit is DROPPED with producer-side
    accounting (``plane_shard_effects_dropped`` on /metrics), so
    undersizing degrades visibly rather than blocking the plane. The
    defaults (4096 x 1 KiB = 4 MiB per direction per shard) hold ~20 ms
    of a saturated shard's traffic."""

    shards: int = 1
    executor: str = "thread"
    workers: int = 4
    ring_slots: int = 4096
    ring_slot_bytes: int = 1024

    def __post_init__(self) -> None:
        if self.shards < 1:
            raise ValueError("plane.shards must be >= 1")
        if self.executor not in ("thread", "inline", "process"):
            raise ValueError(
                "plane.executor must be 'thread', 'inline' or 'process'"
            )
        if self.workers < 1:
            raise ValueError("plane.workers must be >= 1")
        if self.ring_slots < 1:
            raise ValueError("plane.ring_slots must be >= 1")
        if self.ring_slot_bytes < 16:
            raise ValueError("plane.ring_slot_bytes must be >= 16")


@dataclass
class WanConfig:
    """The `[wan]` table: WAN-finality latency levers.

    Every knob defaults OFF so the wire schedule — and therefore every
    same-seed sim/campaign hash — is byte-identical to a build without
    this table. Turn them on per deployment:

    ``overlap_ready`` lets a node piggyback its Ready attestation in the
    same frame as its Echo (broadcast/stack.py), collapsing the serial
    echo-quorum -> ready-broadcast round trip into one propagation. Safe
    because the per-slot single-Ready binding and the delivery gate
    (ready quorum AND own ready sent AND content known) are unchanged;
    what is relaxed is only the non-load-bearing "Ready implies an echo
    quorum was locally observed" ordering.

    ``region_fanout`` orders broadcast fanout nearest-first: the sim
    mesh sorts peers by fabric link latency; the real mesh sorts by a
    per-peer RTT EWMA (fed from dial timing) with ``region`` hints as
    the coarse tiebreak. Quorum then forms from the near-region majority
    while far links are still in flight.

    ``region`` is this node's own region hint (free-form string, ""
    means unhinted) compared against each peer's declared region.

    ``verify_ahead`` verifies parked catchup payloads DURING the quorum
    wait when verifier occupancy is low (node/service.py), so delivery
    after ready-quorum never blocks on signature checks.

    ``eager_broker`` anchors the broker's flush deadline at the FIRST
    buffered entry and shrinks it when the queue is shallow
    (broker.py), so a lone WAN tx never waits out a full batch window.
    """

    overlap_ready: bool = False
    region_fanout: bool = False
    region: str = ""
    verify_ahead: bool = False
    eager_broker: bool = False

    def __post_init__(self) -> None:
        if not isinstance(self.region, str):
            raise ValueError("wan.region must be a string")


@dataclass
class OverloadConfig:
    """The `[overload]` table: closed-loop overload control.

    ``enabled = false`` (the default) keeps the controller fully inert:
    no samples are taken, no requests are shed, and the wire schedule —
    and therefore every same-seed sim/campaign hash — is byte-identical
    to a build without this table (hash-gated in CI, same bar as
    `[wan]`).

    When enabled, node/overload.py samples the live pressure signals
    (verifier queue depth and sojourn, plane backlog, commit-tail age,
    SLO fast-window burn) at most every ``sample_interval`` seconds,
    folds the worst normalized signal into an EWMA pressure score
    (``smoothing`` is the EWMA alpha), and sheds client ingress when
    pressure crosses the ladder:

    * ``sojourn_target_ms`` / ``sojourn_arm_s`` — CoDel-style gate on
      the verifier queue-wait signal: sojourn must stay above target
      for ``sojourn_arm_s`` continuous seconds before that signal
      counts, and disarms once it falls below half the target, so a
      single deep batch never triggers shedding.
    * ``queue_target`` / ``backlog_target`` / ``tail_target_s`` —
      full-scale normalization for verifier queue depth, undelivered
      broadcast slots, and the oldest pending payload's age.
    * ``shed_start`` .. ``shed_full`` — the shed ramp: unregistered
      senders shed a fraction that rises linearly from 0 at
      ``shed_start`` to 1.0 at ``shed_full``; senders already in the
      gossiped client directory get ``registered_grace`` extra pressure
      headroom before their ramp begins. Protocol traffic (echo/ready/
      catchup/beacons) is never shed — it is what drains the backlog.
    * ``retry_after_ms`` / ``retry_after_max_ms`` — the typed hint shed
      responses carry (``retry_after_ms=N`` in the gRPC status detail),
      scaled up with pressure and honored by client.py's RetryPolicy.
    * ``brownout_frac`` / ``refuse_frac`` — the broker's graduated
      ladder as fractions of PENDING_CAP: above ``brownout_frac`` the
      broker shrinks its flush deadline (the eager-flush machinery),
      above ``refuse_frac`` it refuses new submissions with the
      retry-after hint instead of riding into the hard cap.
    """

    enabled: bool = False
    sample_interval: float = 0.25
    smoothing: float = 0.3
    sojourn_target_ms: float = 150.0
    sojourn_arm_s: float = 0.5
    queue_target: int = 4096
    backlog_target: int = 1024
    tail_target_s: float = 5.0
    shed_start: float = 0.5
    shed_full: float = 0.95
    registered_grace: float = 0.25
    retry_after_ms: int = 250
    retry_after_max_ms: int = 5000
    brownout_frac: float = 0.5
    refuse_frac: float = 0.9

    def __post_init__(self) -> None:
        if self.sample_interval <= 0:
            raise ValueError("overload.sample_interval must be > 0")
        if not 0.0 < self.smoothing <= 1.0:
            raise ValueError("overload.smoothing must be in (0, 1]")
        if self.sojourn_target_ms <= 0:
            raise ValueError("overload.sojourn_target_ms must be > 0")
        if self.sojourn_arm_s < 0:
            raise ValueError("overload.sojourn_arm_s must be >= 0")
        if self.queue_target < 1:
            raise ValueError("overload.queue_target must be >= 1")
        if self.backlog_target < 1:
            raise ValueError("overload.backlog_target must be >= 1")
        if self.tail_target_s <= 0:
            raise ValueError("overload.tail_target_s must be > 0")
        if not 0.0 < self.shed_start < self.shed_full:
            raise ValueError(
                "overload needs 0 < shed_start < shed_full"
            )
        if self.registered_grace < 0:
            raise ValueError("overload.registered_grace must be >= 0")
        if self.retry_after_ms < 1:
            raise ValueError("overload.retry_after_ms must be >= 1")
        if self.retry_after_max_ms < self.retry_after_ms:
            raise ValueError(
                "overload.retry_after_max_ms must be >= retry_after_ms"
            )
        if not 0.0 < self.brownout_frac < self.refuse_frac <= 1.0:
            raise ValueError(
                "overload needs 0 < brownout_frac < refuse_frac <= 1"
            )


@dataclass
class FinalityConfig:
    """The `[finality]` table: succinct finality certificates
    (finality/, TECHNICAL.md "Finality certificates").

    ``enabled = false`` (the default) keeps the subsystem fully inert:
    no kind-16 co-signatures are emitted, no assembler state is kept,
    and the wire schedule — and therefore every same-seed sim/campaign
    hash — is byte-identical to a build without this table (hash-gated
    in CI, same bar as `[wan]` and `[overload]`).

    When enabled, every ``observability.audit_every`` commit frontier
    the node broadcasts a co-signature over the canonical
    (epoch, watermark digest, range lanes, directory digest) tuple;
    the assembler folds ``quorum`` of them (0 derives the AT2 default
    2f+1 from the member count) into a certificate under the named
    attestation ``scheme`` (finality/scheme.py registry — multi_eddsa
    today, the BLS aggregate slots in here later). ``history`` bounds
    the certificate chain tail retained in memory, the store manifest,
    and /certz."""

    enabled: bool = False
    scheme: str = "multi_eddsa"
    quorum: int = 0  # 0 = derive 2f+1 from the membership size
    history: int = 8

    def __post_init__(self) -> None:
        if not isinstance(self.scheme, str) or not self.scheme:
            raise ValueError("finality.scheme must be a non-empty string")
        if self.quorum < 0:
            raise ValueError("finality.quorum must be >= 0")
        if self.history < 1:
            raise ValueError("finality.history must be >= 1")


@dataclass
class Config:
    node_address: str
    rpc_address: str
    sign_key: SignKeyPair
    network_key: ExchangeKeyPair
    nodes: List[Peer] = field(default_factory=list)
    verifier: VerifierConfig = field(default_factory=VerifierConfig)
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig
    )
    slo: SloConfig = field(default_factory=SloConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    store: StoreConfig = field(default_factory=StoreConfig)
    membership: MembershipConfig = field(default_factory=MembershipConfig)
    catchup: CatchupConfig = field(default_factory=CatchupConfig)
    batching: BatchingConfig = field(default_factory=BatchingConfig)
    admission: AdmissionConfig = field(default_factory=AdmissionConfig)
    plane: PlaneConfig = field(default_factory=PlaneConfig)
    wan: WanConfig = field(default_factory=WanConfig)
    overload: OverloadConfig = field(default_factory=OverloadConfig)
    finality: FinalityConfig = field(default_factory=FinalityConfig)
    echo_threshold: Optional[int] = None
    ready_threshold: Optional[int] = None

    # -- TOML -------------------------------------------------------------

    def dumps(self) -> str:
        lines = []
        # top-level keys must precede any table header in TOML
        if self.echo_threshold is not None:
            lines.append(f"echo_threshold = {self.echo_threshold}")
        if self.ready_threshold is not None:
            lines.append(f"ready_threshold = {self.ready_threshold}")
        lines += [
            "[addresses]",
            f'node = "{self.node_address}"',
            f'rpc = "{self.rpc_address}"',
            "",
            "[keys]",
            f'sign = "{self.sign_key.to_hex()}"',
            f'network = "{self.network_key.to_hex()}"',
            "",
            "[verifier]",
            f'kind = "{self.verifier.kind}"',
            f"batch_size = {self.verifier.batch_size}",
            f"max_delay = {self.verifier.max_delay}",
            f'mode = "{self.verifier.mode}"',
        ]
        if self.verifier.rlc_min_batch is not None:
            lines.append(f"rlc_min_batch = {self.verifier.rlc_min_batch}")
        obs = self.observability
        if obs != ObservabilityConfig():
            lines += [
                "",
                "[observability]",
                f"stats_interval = {obs.stats_interval}",
                f'profile_dir = "{obs.profile_dir}"',
                f"endpoints = {'true' if obs.endpoints else 'false'}",
                f"trace_sample = {obs.trace_sample}",
                f"trace_cap = {obs.trace_cap}",
                f"trace_done_cap = {obs.trace_done_cap}",
                f"recorder_cap = {obs.recorder_cap}",
                f"profilez = {'true' if obs.profilez else 'false'}",
                f"profiler_hz = {obs.profiler_hz}",
                f"profiler_max_nodes = {obs.profiler_max_nodes}",
                f"profiler_duration = {obs.profiler_duration}",
                f"lag_probe_interval = {obs.lag_probe_interval}",
                "phase_accounting = "
                + ("true" if obs.phase_accounting else "false"),
                f"audit_every = {obs.audit_every}",
                f"audit_interval = {obs.audit_interval}",
                f"audit_history = {obs.audit_history}",
                f"capture_cap = {obs.capture_cap}",
            ]
        slo = self.slo
        if slo != SloConfig():
            lines += [
                "",
                "[slo]",
                f"enabled = {'true' if slo.enabled else 'false'}",
                f"fast_window = {slo.fast_window}",
                f"slow_window = {slo.slow_window}",
                f"probe_interval = {slo.probe_interval}",
                f"latency_p99_ms = {slo.latency_p99_ms}",
                f"throughput_floor_tps = {slo.throughput_floor_tps}",
                f"rejection_ratio_max = {slo.rejection_ratio_max}",
                f"stall_budget = {slo.stall_budget}",
            ]
        if self.checkpoint.path:
            lines += [
                "",
                "[checkpoint]",
                f'path = "{self.checkpoint.path}"',
                f"interval = {self.checkpoint.interval}",
            ]
        st = self.store
        if st != StoreConfig():
            lines += [
                "",
                "[store]",
                f'dir = "{st.dir}"',
                f"flush_interval = {st.flush_interval}",
                f"shards = {st.shards}",
                f'sync = "{st.sync}"',
                f"history_cap = {st.history_cap}",
            ]
        mb = self.membership
        if mb != MembershipConfig():
            lines += [
                "",
                "[membership]",
                f'admin_public = "{mb.admin_public}"',
                f"grace = {mb.grace}",
            ]
        cu = self.catchup
        if cu != CatchupConfig():
            lines += [
                "",
                "[catchup]",
                f"enabled = {'true' if cu.enabled else 'false'}",
                f"quorum = {cu.quorum}",
                f"after = {cu.after}",
                f"window = {cu.window}",
                f"history_cap = {cu.history_cap}",
            ]
        ba = self.batching
        if ba != BatchingConfig():
            lines += [
                "",
                "[batching]",
                f"enabled = {'true' if ba.enabled else 'false'}",
                f"max_entries = {ba.max_entries}",
                f"window = {ba.window}",
            ]
        ad = self.admission
        if ad != AdmissionConfig():
            lines += [
                "",
                "[admission]",
                f"preverify = {'true' if ad.preverify else 'false'}",
                f"fail_limit = {ad.fail_limit}",
                f"fail_window = {ad.fail_window}",
            ]
        pl = self.plane
        if pl != PlaneConfig():
            lines += [
                "",
                "[plane]",
                f"shards = {pl.shards}",
                f'executor = "{pl.executor}"',
                f"workers = {pl.workers}",
                f"ring_slots = {pl.ring_slots}",
                f"ring_slot_bytes = {pl.ring_slot_bytes}",
            ]
        wa = self.wan
        if wa != WanConfig():
            lines += [
                "",
                "[wan]",
                f"overlap_ready = {'true' if wa.overlap_ready else 'false'}",
                f"region_fanout = {'true' if wa.region_fanout else 'false'}",
                f'region = "{wa.region}"',
                f"verify_ahead = {'true' if wa.verify_ahead else 'false'}",
                f"eager_broker = {'true' if wa.eager_broker else 'false'}",
            ]
        ov = self.overload
        if ov != OverloadConfig():
            lines += [
                "",
                "[overload]",
                f"enabled = {'true' if ov.enabled else 'false'}",
                f"sample_interval = {ov.sample_interval}",
                f"smoothing = {ov.smoothing}",
                f"sojourn_target_ms = {ov.sojourn_target_ms}",
                f"sojourn_arm_s = {ov.sojourn_arm_s}",
                f"queue_target = {ov.queue_target}",
                f"backlog_target = {ov.backlog_target}",
                f"tail_target_s = {ov.tail_target_s}",
                f"shed_start = {ov.shed_start}",
                f"shed_full = {ov.shed_full}",
                f"registered_grace = {ov.registered_grace}",
                f"retry_after_ms = {ov.retry_after_ms}",
                f"retry_after_max_ms = {ov.retry_after_max_ms}",
                f"brownout_frac = {ov.brownout_frac}",
                f"refuse_frac = {ov.refuse_frac}",
            ]
        fi = self.finality
        if fi != FinalityConfig():
            lines += [
                "",
                "[finality]",
                f"enabled = {'true' if fi.enabled else 'false'}",
                f'scheme = "{fi.scheme}"',
                f"quorum = {fi.quorum}",
                f"history = {fi.history}",
            ]
        for peer in self.nodes:
            lines += [
                "",
                "[[nodes]]",
                f'address = "{peer.address}"',
                f'public_key = "{peer.exchange_public.hex()}"',
                f'sign_public_key = "{peer.sign_public.hex()}"',
            ]
            if peer.region:
                lines.append(f'region = "{peer.region}"')
        return "\n".join(lines) + "\n"

    @staticmethod
    def loads(text: str) -> "Config":
        doc = tomllib.loads(text)
        verifier = VerifierConfig(**doc.get("verifier", {}))
        observability = ObservabilityConfig(**doc.get("observability", {}))
        slo = SloConfig(**doc.get("slo", {}))
        ckpt = CheckpointConfig(**doc.get("checkpoint", {}))
        store = StoreConfig(**doc.get("store", {}))
        membership = MembershipConfig(**doc.get("membership", {}))
        catchup = CatchupConfig(**doc.get("catchup", {}))
        batching = BatchingConfig(**doc.get("batching", {}))
        admission = AdmissionConfig(**doc.get("admission", {}))
        plane = PlaneConfig(**doc.get("plane", {}))
        wan = WanConfig(**doc.get("wan", {}))
        overload = OverloadConfig(**doc.get("overload", {}))
        finality = FinalityConfig(**doc.get("finality", {}))
        return Config(
            node_address=doc["addresses"]["node"],
            rpc_address=doc["addresses"]["rpc"],
            sign_key=SignKeyPair.from_hex(doc["keys"]["sign"]),
            network_key=ExchangeKeyPair.from_hex(doc["keys"]["network"]),
            nodes=[
                Peer(
                    address=n["address"],
                    exchange_public=bytes.fromhex(n["public_key"]),
                    sign_public=bytes.fromhex(n["sign_public_key"]),
                    region=n.get("region", ""),
                )
                for n in doc.get("nodes", [])
            ],
            verifier=verifier,
            observability=observability,
            slo=slo,
            checkpoint=ckpt,
            store=store,
            membership=membership,
            catchup=catchup,
            batching=batching,
            admission=admission,
            plane=plane,
            wan=wan,
            overload=overload,
            finality=finality,
            echo_threshold=doc.get("echo_threshold"),
            ready_threshold=doc.get("ready_threshold"),
        )

    @staticmethod
    def load(fp: TextIO) -> "Config":
        return Config.loads(fp.read())

    def node_fragment(self) -> str:
        """The shareable `config get-node` output: this node's address and
        public identities, as a `[[nodes]]` TOML fragment
        (`at2-node/src/bin/server/main.rs:74-88`)."""
        return "\n".join(
            [
                "[[nodes]]",
                f'address = "{self.node_address}"',
                f'public_key = "{self.network_key.public.hex()}"',
                f'sign_public_key = "{self.sign_key.public.hex()}"',
            ]
        ) + "\n"

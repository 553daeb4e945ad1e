"""Continuous profiler: sampling stack profiler, event-loop lag probe,
and the plane time-accounting seam.

Counterpart of ``at2_node_tpu/obs/profiler.py``.

Dependency-free (stdlib only), same contract as registry.py: the node
must stay deployable on a bare host image, so there is no py-spy /
yappi / opentelemetry here. Three coordinated parts:

* :class:`PhaseAccounting` — the plane time-accounting seam. Hot paths
  (both broadcast planes, the commit tail, verifier flush decisions)
  mark disjoint sequential segments against a fixed phase vocabulary;
  each segment lands in a per-phase ns Counter plus a ×2-log Histogram
  in the node's existing :class:`~.registry.Registry`, so ``/metrics``
  and ``/statusz`` export the decomposition for free. Timing uses
  ``time.perf_counter_ns()`` directly — NOT the clock seam — because
  the quantity being accounted is real elapsed host time (the thing
  ROADMAP item 1 needs decomposed), and because sim determinism is
  carried by wire traces, never by registry values: phase counters keep
  accumulating under the virtual clock without perturbing a schedule.

* :class:`StackSampler` — a sampling wall/CPU profiler: one daemon
  thread walks ``sys._current_frames()`` at a configurable Hz and
  aggregates frames into a bounded stack tree. Output is the tree as
  JSON or collapsed-stack ("folded") text for flamegraphs. The sampler
  is a REAL thread, so it never auto-starts under the simulator (sim
  time is virtual; a real thread would race the deterministic
  schedule) — it is started on demand via ``/profilez?start``, the
  healthz ok→degraded edge capture, or a bench harness.

* :class:`EventLoopLagProbe` — measures asyncio scheduling lag as the
  overshoot of a short cooperative sleep. Clock-seam aware: under the
  sim virtual clock a manually-driven :meth:`~EventLoopLagProbe.
  probe_once` measures exactly zero lag (virtual sleeps are exact) and
  never deadlocks the scheduler, while the standing background loop is
  reserved for served (real-time) nodes.

See TECHNICAL.md "Continuous profiling & plane time-accounting" for the
phase vocabulary and the overhead budget.
"""

from __future__ import annotations

import contextvars
import os
import platform
import subprocess
import sys
import threading
import time
from typing import Iterable, Optional, Sequence

from .registry import Histogram, Registry

__all__ = [
    "PHASES",
    "PLANE_LEAF_PHASES",
    "PHASE_BOUNDS",
    "EventLoopLagProbe",
    "PhaseAccounting",
    "ShardPhaseView",
    "StackSampler",
    "build_info",
    "merge_folded",
    "parse_folded",
]

# The fixed phase vocabulary. ``plane_total`` wraps a broadcast worker's
# whole drain cycle (parse + process); the PLANE_LEAF_PHASES are the
# disjoint sequential segments inside it, so
# ``sum(leaves) / plane_total`` is the decomposition coverage that
# profile_collect checks against its >=90% bar. ``slot_gc``,
# ``commit_tail`` and ``verifier_flush`` run outside the worker span and
# are reported as separate serial terms.
PLANE_LEAF_PHASES: tuple[str, ...] = (
    "rx_decode",       # frame parse + admission pre-checks
    "verify_wait",     # worker blocked on verifier.verify_many
    "echo_apply",      # content insert, relay, sieve echo construction
    "quorum_bitmap",   # attestation vote/bitmap ingestion
    "ready_deliver",   # quorum evaluation, ready send, delivery
    "entry_registry",  # (sender, seq) -> entry binding ops
)

PHASES: tuple[str, ...] = PLANE_LEAF_PHASES + (
    "plane_total",     # whole worker drain cycle (denominator)
    "slot_gc",         # per-sweep cost of the slot GC loop
    "commit_tail",     # per-commit bookkeeping after delivery
    "verifier_flush",  # batch verifier flush decision + dispatch
)

# Phase segments are routinely single-digit microseconds — far below the
# registry's default 100µs floor — so phase histograms get their own ×2
# ladder: 1µs .. ~33s in 26 buckets (+1 overflow).
PHASE_BOUNDS: tuple[float, ...] = tuple(1e-6 * 2.0**i for i in range(26))


class PhaseAccounting:
    """Per-phase elapsed-ns counters + ×2-log histograms.

    Hot-site idiom (one attribute read + one ``is not None`` when
    accounting is off, one ``perf_counter_ns`` pair per segment when
    on)::

        ph = self.phases
        t0 = ph.t() if ph is not None else 0
        ...work...
        if ph is not None:
            t0 = ph.add("echo_apply", t0)   # returns fresh t for chaining

    Counters are exact across threads (registry Counter.inc is
    lock-protected), which is what makes the decomposition shares
    trustworthy when 16 workers mark concurrently.

    The ``plane_total`` denominator goes through ``begin_plane`` /
    ``end_plane`` instead of a bare ``add_ns``: a drain cycle can
    re-enter the plane within the same logical task (e.g. a verifier
    fallback path kicked via ``rlc_ready_or_kick`` that pumps the inbox
    again), and the naive span-per-call accounting counted the nested
    cycle's wall time TWICE — once in its own span and once inside the
    outer one — inflating the denominator and deflating coverage. The
    guard is a contextvar depth counter, which gives exactly the right
    isolation on both runtimes: per-Task on the event loop (two worker
    tasks interleaving on one thread still account their own cycles) and
    per-thread on shard executors.
    """

    __slots__ = ("_counters", "_hists")

    def __init__(
        self, registry: Registry, phases: Sequence[str] = PHASES
    ) -> None:
        self._counters = {
            p: registry.counter(
                f"phase_{p}_ns", f"elapsed ns accounted to phase {p}"
            )
            for p in phases
        }
        self._hists = {
            p: registry.histogram(
                f"phase_{p}", f"per-segment latency of phase {p}",
                bounds=PHASE_BOUNDS,
            )
            for p in phases
        }

    @staticmethod
    def t() -> int:
        """A segment-open timestamp (ns)."""
        return time.perf_counter_ns()

    def add(self, phase: str, t0: int) -> int:
        """Close the segment opened at ``t0`` against ``phase``; returns
        a fresh timestamp so chained segments stay gap-free and
        disjoint (no double counting)."""
        t1 = time.perf_counter_ns()
        dt = t1 - t0
        if dt > 0:
            self._counters[phase].inc(dt)
            self._hists[phase].observe(dt * 1e-9)
        return t1

    def add_ns(self, phase: str, ns: int) -> None:
        """Account an externally-measured duration. Exists for callers
        that already hold a ns delta — and it makes counter exactness
        directly testable."""
        if ns > 0:
            self._counters[phase].inc(ns)
            self._hists[phase].observe(ns * 1e-9)

    def begin_plane(self) -> int:
        """Open a plane drain cycle. Returns the cycle-open timestamp,
        or -1 when this context is already inside a cycle (the nested
        cycle's span must NOT be added to ``plane_total`` again)."""
        depth = _plane_depth.get()
        _plane_depth.set(depth + 1)
        return time.perf_counter_ns() if depth == 0 else -1

    def end_plane(self, t0: int) -> None:
        """Close the cycle opened by the matching :meth:`begin_plane`;
        accounts ``plane_total`` only for the outermost cycle."""
        depth = _plane_depth.get()
        if depth > 0:
            _plane_depth.set(depth - 1)
        if t0 >= 0:
            self.add_ns("plane_total", time.perf_counter_ns() - t0)

    def shard_view(self, shard_id: int, registry: Registry) -> "ShardPhaseView":
        """A per-shard facade over this accounting: same marking API,
        but the six plane leaf phases additionally land in
        ``phase_<p>_shard<k>_ns`` counters on ``registry`` so /metrics
        can show where each shard's time goes. Base counters still get
        every mark — aggregate coverage math is unchanged."""
        return ShardPhaseView(self, shard_id, registry)

    def totals(self) -> dict[str, int]:
        """{phase: accumulated ns} — the raw decomposition vector."""
        return {p: c.value for p, c in self._counters.items()}


# Depth of nested plane drain cycles in the current context. Module-level
# (not per-instance) so a shard core's view and the owner's accounting
# agree on what "inside a cycle" means; contextvars give per-Task
# isolation on the loop and per-thread isolation on shard executors.
_plane_depth: contextvars.ContextVar[int] = contextvars.ContextVar(
    "at2_plane_depth", default=0
)


class ShardPhaseView:
    """Shard-labeled facade over a shared :class:`PhaseAccounting` (see
    :meth:`PhaseAccounting.shard_view`). Leaf-phase marks dual-write to
    the base counters and the shard's own ``phase_<p>_shard<k>_ns``
    counters; everything else delegates."""

    __slots__ = ("_base", "shard_id", "_shard_counters")

    def __init__(
        self, base: PhaseAccounting, shard_id: int, registry: Registry
    ) -> None:
        self._base = base
        self.shard_id = shard_id
        self._shard_counters = {
            p: registry.counter(
                f"phase_{p}_shard{shard_id}_ns",
                f"elapsed ns accounted to phase {p} on plane shard {shard_id}",
            )
            for p in PLANE_LEAF_PHASES
        }

    t = staticmethod(PhaseAccounting.t)

    def add(self, phase: str, t0: int) -> int:
        t1 = self._base.add(phase, t0)
        dt = t1 - t0
        sc = self._shard_counters.get(phase)
        if sc is not None and dt > 0:
            sc.inc(dt)
        return t1

    def add_ns(self, phase: str, ns: int) -> None:
        self._base.add_ns(phase, ns)
        sc = self._shard_counters.get(phase)
        if sc is not None and ns > 0:
            sc.inc(ns)

    def begin_plane(self) -> int:
        return self._base.begin_plane()

    def end_plane(self, t0: int) -> None:
        self._base.end_plane(t0)

    def totals(self) -> dict[str, int]:
        return self._base.totals()


# --------------------------------------------------------------------------
# Sampling stack profiler


class _StackNode:
    __slots__ = ("count", "children")

    def __init__(self) -> None:
        self.count = 0
        self.children: dict[str, _StackNode] = {}


_TRUNCATED = "(truncated)"


def _frame_label(filename: str, func: str) -> str:
    return f"{os.path.basename(filename)}:{func}"


class StackSampler:
    """Sampling profiler: a daemon thread walks every live thread's
    frame stack at ``hz`` and folds the stacks into a bounded tree.

    * Interior frames are labeled ``file:func``; the leaf frame carries
      its line number (``file:func:line``) so the hottest folded stack
      names an exact file:line — the attribution profile_collect puts
      in its decomposition report.
    * The tree is bounded at ``max_nodes``: once the budget is spent,
      paths that would create a new node collapse into a
      ``(truncated)`` child at the divergence point, so a pathological
      workload can never grow memory without bound.
    * ``start()/stop()`` are idempotent and the sampler is restartable;
      ``start(duration=...)`` self-stops (used by ``/profilez?start``
      and the healthz degraded-edge capture).
    * :meth:`ingest` is the deterministic test seam: it takes synthetic
      root-first stacks and is exactly the path real samples take.
    """

    def __init__(
        self,
        hz: float = 97.0,
        max_nodes: int = 20000,
        max_depth: int = 64,
    ) -> None:
        if hz <= 0:
            raise ValueError(f"sampler hz must be > 0, got {hz}")
        if max_nodes <= 0:
            raise ValueError(f"sampler max_nodes must be > 0, got {max_nodes}")
        self.hz = float(hz)
        self.max_nodes = int(max_nodes)
        self.max_depth = int(max_depth)
        self._lock = threading.Lock()
        self._root = _StackNode()
        self._nodes = 1
        self._samples = 0
        self._truncated = 0
        # code object -> "file:func": label construction (basename +
        # format) dominates per-sample cost, and the set of live code
        # objects is small and stable — caching it cuts the sampler's
        # per-tick cost ~4x, which is what keeps the whole tier inside
        # the 5% overhead budget on a 1-core host
        self._label_cache: dict = {}
        self._thread: Optional[threading.Thread] = None
        self._stop_event = threading.Event()
        self._started_at: Optional[float] = None
        self._last_duration: Optional[float] = None

    # -- lifecycle -------------------------------------------------------

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self, duration: Optional[float] = None) -> bool:
        """Begin sampling; returns False (no-op) if already running.
        With ``duration`` the sampler stops itself after that many real
        seconds."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            self._stop_event = threading.Event()
            self._started_at = time.monotonic()
            self._last_duration = duration
            self._thread = threading.Thread(
                target=self._run,
                args=(self._stop_event, duration),
                name="at2-profiler",
                daemon=True,
            )
            self._thread.start()
            return True

    def stop(self) -> None:
        """Idempotent; joins the sampler thread."""
        with self._lock:
            thread = self._thread
            event = self._stop_event
            self._thread = None
        if thread is None:
            return
        event.set()
        if thread is not threading.current_thread():
            thread.join(timeout=5.0)

    def reset(self) -> None:
        with self._lock:
            self._root = _StackNode()
            self._nodes = 1
            self._samples = 0
            self._truncated = 0

    def _run(self, stop: threading.Event, duration: Optional[float]) -> None:
        interval = 1.0 / self.hz
        deadline = (
            time.monotonic() + duration if duration is not None else None
        )
        own = threading.get_ident()
        while not stop.wait(interval):
            if deadline is not None and time.monotonic() >= deadline:
                break
            self._sample_once(own)

    def _sample_once(self, own_tid: int) -> None:
        cache = self._label_cache
        if len(cache) > 65536:  # paranoia bound; code objects are finite
            cache.clear()
        stacks: list[list[str]] = []
        for tid, frame in sys._current_frames().items():
            if tid == own_tid:
                continue
            labels: list[str] = []
            leaf_lineno = frame.f_lineno
            f = frame
            while f is not None and len(labels) < self.max_depth:
                code = f.f_code
                label = cache.get(code)
                if label is None:
                    label = _frame_label(code.co_filename, code.co_name)
                    cache[code] = label
                labels.append(label)
                f = f.f_back
            labels.reverse()  # root-first; labels[-1] is the leaf
            labels[-1] = f"{labels[-1]}:{leaf_lineno}"
            stacks.append(labels)
        self._ingest_labeled(stacks)

    # -- aggregation -----------------------------------------------------

    def ingest(
        self, stacks: Iterable[Sequence[tuple[str, str, int]]]
    ) -> None:
        """Fold root-first ``(filename, func, lineno)`` stacks into the
        tree. One call = one sample tick (every stack in it shares the
        sample count bump). This is the path real samples take (modulo
        label caching), so tests can drive it with synthetic frames."""
        labeled: list[list[str]] = []
        for stack in stacks:
            labels = [_frame_label(fn, func) for fn, func, _ in stack]
            if labels:
                labels[-1] = f"{labels[-1]}:{stack[-1][2]}"
            labeled.append(labels)
        self._ingest_labeled(labeled)

    def _ingest_labeled(self, stacks: Iterable[Sequence[str]]) -> None:
        with self._lock:
            self._samples += 1
            for labels in stacks:
                if not labels:
                    continue
                node = self._root
                for label in labels:
                    child = node.children.get(label)
                    if child is None:
                        if self._nodes >= self.max_nodes:
                            self._truncated += 1
                            child = node.children.get(_TRUNCATED)
                            if child is None:
                                child = _StackNode()
                                node.children[_TRUNCATED] = child
                                self._nodes += 1
                            child.count += 1
                            break
                        child = _StackNode()
                        node.children[label] = child
                        self._nodes += 1
                    node = child
                else:
                    node.count += 1

    # -- views -----------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "running": self.running,
                "samples": self._samples,
                "nodes": self._nodes,
                "truncated_paths": self._truncated,
                "hz": self.hz,
                "duration": self._last_duration,
            }

    def folded(self, limit: Optional[int] = None) -> str:
        """Collapsed-stack text (``frame;frame;frame count`` per line),
        ready for flamegraph.pl / speedscope. Deterministic ordering:
        count descending, then stack string — byte-identical for
        identical trees regardless of insertion order."""
        lines: list[tuple[int, str]] = []

        def walk(node: _StackNode, path: list[str]) -> None:
            if node.count and path:
                lines.append((node.count, ";".join(path)))
            for label in node.children:
                walk(node.children[label], path + [label])

        with self._lock:
            walk(self._root, [])
        lines.sort(key=lambda e: (-e[0], e[1]))
        if limit is not None:
            lines = lines[:limit]
        return "\n".join(f"{stack} {count}" for count, stack in lines)

    def tree(self) -> dict:
        """The stack tree as JSON-ready nested dicts, children sorted by
        count descending then label (deterministic)."""

        def render(label: str, node: _StackNode) -> dict:
            kids = sorted(
                node.children.items(),
                key=lambda kv: (-self._subtree_count(kv[1]), kv[0]),
            )
            out: dict = {"name": label, "count": node.count}
            if kids:
                out["children"] = [render(k, v) for k, v in kids]
            return out

        with self._lock:
            return render("root", self._root)

    @staticmethod
    def _subtree_count(node: _StackNode) -> int:
        total = node.count
        for child in node.children.values():
            total += StackSampler._subtree_count(child)
        return total


def parse_folded(text: str) -> dict[str, int]:
    """Collapsed-stack text -> ``{stack: count}``. Tolerant of blank
    lines; a malformed line (no trailing integer) is skipped rather than
    poisoning the merge — folded increments cross a process boundary."""
    out: dict[str, int] = {}
    for line in text.splitlines():
        stack, _, count = line.rpartition(" ")
        if not stack:
            continue
        try:
            n = int(count)
        except ValueError:
            continue
        out[stack] = out.get(stack, 0) + n
    return out


def merge_folded(
    parts: Iterable[tuple[str, "str | dict[str, int]"]],
    limit: Optional[int] = None,
) -> str:
    """Merge several collapsed-stack profiles into one folded text.

    ``parts`` is ``(prefix, folded)`` pairs where ``folded`` is either
    folded text or an already-parsed ``{stack: count}`` dict; a
    non-empty prefix is prepended to every stack in that part (the
    multi-process convention: worker frames arrive as ``shardN/...``).
    Ordering matches :meth:`StackSampler.folded`: count descending,
    then stack string — deterministic for identical inputs.
    """
    agg: dict[str, int] = {}
    for prefix, folded in parts:
        entries = (
            parse_folded(folded) if isinstance(folded, str) else folded
        )
        for stack, count in entries.items():
            key = f"{prefix}{stack}" if prefix else stack
            agg[key] = agg.get(key, 0) + count
    lines = sorted(agg.items(), key=lambda kv: (-kv[1], kv[0]))
    if limit is not None:
        lines = lines[:limit]
    return "\n".join(f"{stack} {count}" for stack, count in lines)


# --------------------------------------------------------------------------
# Event-loop lag probe


class EventLoopLagProbe:
    """Asyncio scheduling-lag probe: sleep ``interval`` through the
    clock seam and record the overshoot into an ``event_loop_lag``
    histogram (so ``event_loop_lag_p99_ms`` lands in /statusz stats and
    /metrics automatically).

    Two driving modes:

    * :meth:`probe_once` — one measurement, awaitable from anywhere.
      Under the sim virtual clock the overshoot is exactly 0.0 and the
      call completes in zero virtual time steps beyond the sleep, so
      sim tests can drive it manually without ever parking a standing
      timer (standing timers blunt SimScheduler's deadlock detection).
    * :meth:`start` / :meth:`stop` — the standing background loop, for
      served real-time nodes only (Service gates it on ``serve_rpc``).
    """

    def __init__(
        self,
        registry: Registry,
        clock,
        interval: float = 0.05,
    ) -> None:
        if interval <= 0:
            raise ValueError(f"lag probe interval must be > 0, got {interval}")
        self.clock = clock
        self.interval = float(interval)
        self.hist: Histogram = registry.histogram(
            "event_loop_lag",
            "asyncio scheduling lag (sleep overshoot)",
            bounds=PHASE_BOUNDS,
        )
        self._task = None

    async def probe_once(self) -> float:
        t0 = self.clock.monotonic()
        await self.clock.sleep(self.interval)
        lag = max(0.0, self.clock.monotonic() - t0 - self.interval)
        self.hist.observe(lag)
        return lag

    def start(self) -> None:
        import asyncio

        if self._task is None or self._task.done():
            self._task = asyncio.get_running_loop().create_task(self._loop())

    async def _loop(self) -> None:
        while True:
            await self.probe_once()

    async def stop(self) -> None:
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except BaseException:
                pass


# --------------------------------------------------------------------------
# Build identity


_GIT_SHA: Optional[str] = None
_GIT_SHA_RESOLVED = False


def _git_sha() -> Optional[str]:
    global _GIT_SHA, _GIT_SHA_RESOLVED
    if not _GIT_SHA_RESOLVED:
        _GIT_SHA_RESOLVED = True
        try:
            out = subprocess.run(
                ["git", "rev-parse", "--short=12", "HEAD"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True,
                timeout=5,
            )
            if out.returncode == 0:
                sha = out.stdout.decode("ascii", "replace").strip()
                _GIT_SHA = sha or None
        except Exception:
            _GIT_SHA = None
    return _GIT_SHA


def build_info() -> dict:
    """The static half of the /statusz ``build`` block: what code is
    running. Service adds the dynamic half (config hash, start time,
    uptime). It is stable across runs of the same checkout on the same
    host: the torch and CUDA versions, and the card's name when a CUDA
    device is present."""
    import torch

    info = {
        "git_sha": _git_sha(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    if torch.cuda.is_available():
        info["device"] = torch.cuda.get_device_name(0)
    return info

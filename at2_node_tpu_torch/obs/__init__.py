"""Observability subsystem: metrics registry, lifecycle tracing, the
protocol flight recorder, the SLO engine, wire exposition. See the
registry.py / trace.py / recorder.py / slo.py module docstrings for the
contracts. Nothing here imports torch: a plane shard worker loads this
package without it (``profiler.build_info`` imports torch when called,
``profiler.TraceSpans.start`` when a node starts its trace)."""

from .audit import AUDIT_RANGES, FleetAuditor, LedgerDigest
from .profiler import (
    NO_SPANS,
    PHASES,
    PLANE_LEAF_PHASES,
    SPAN_ARGS,
    BusySelector,
    EventLoopLagProbe,
    PhaseAccounting,
    StackSampler,
    TraceSpans,
    build_info,
)
from .recorder import FlightRecorder
from .registry import (
    Counter,
    CounterGroup,
    Gauge,
    Histogram,
    Registry,
)
from .slo import Objective, SloEngine, default_objectives, evaluate_point
from .trace import BROKER_STAGES, REJECTED, STAGES, TxTrace

__all__ = [
    "AUDIT_RANGES",
    "BROKER_STAGES",
    "BusySelector",
    "Counter",
    "CounterGroup",
    "EventLoopLagProbe",
    "FleetAuditor",
    "FlightRecorder",
    "LedgerDigest",
    "Gauge",
    "Histogram",
    "NO_SPANS",
    "Objective",
    "PHASES",
    "PLANE_LEAF_PHASES",
    "PhaseAccounting",
    "REJECTED",
    "Registry",
    "SPAN_ARGS",
    "STAGES",
    "SloEngine",
    "StackSampler",
    "TraceSpans",
    "TxTrace",
    "build_info",
    "default_objectives",
    "evaluate_point",
]

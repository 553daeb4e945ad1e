"""Deterministic simulation harness for the AT2 stack.

Counterpart of ``at2_node_tpu/sim/__init__.py``.

FoundationDB-style discrete-event simulation: the REAL node logic
(broadcast planes, service commit tail, catchup, admission) runs
unmodified under a virtual clock and a simulated network fabric — no
real sockets, no real sleeps, no wall-clock time. A whole multi-node
adversarial episode (partitions, loss, byzantine frames, equivocating
clients) executes in milliseconds and, given the same ``(seed,
config)``, replays bit-identically.

Layout:

* :mod:`.scheduler` — ``SimScheduler`` (a virtual-time asyncio event
  loop) and ``SimClock`` (the injectable clock bound to it);
* :mod:`.fabric`    — ``SimFabric`` / ``SimMesh`` / ``SimChannel``:
  the simulated network with per-link latency/loss/duplication,
  partitions, a byzantine interposer hook, and full event tracing;
* :mod:`.hostile`   — ``HostileFrameGen``: seeded hostile-frame
  generators (shared with the live-socket byzantine fuzz tests);
* :mod:`.net`       — ``SimNet``: an n-node f-tolerant network of real
  ``Service`` cores plus the AT2 invariant checker;
* :mod:`.campaign`  — seeded episode generation, campaign runner,
  exact replay, and greedy trace minimization.

Entry point: ``python -m at2_node_tpu_torch.tools.sim_run`` (see README).
"""

from .campaign import (  # noqa: F401
    EpisodeResult,
    generate_events,
    minimize_events,
    run_campaign,
    run_episode,
)
from .fabric import LinkModel, SimChannel, SimFabric, SimMesh  # noqa: F401
from .hostile import HostileFrameGen  # noqa: F401
from .net import InvariantViolation, SimNet  # noqa: F401
from .scheduler import SimClock, SimDeadlockError, SimScheduler  # noqa: F401

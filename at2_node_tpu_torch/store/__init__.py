"""Durable ledger store: the recovery state machine.

Counterpart of ``at2_node_tpu/store/__init__.py``. The reference's sharded
store (per-account-range segment files, a write-ahead delta log and a
manifest committed by rename) is not ported yet: ROADMAP.md item 7c, and a
port node refuses a ``[store] dir`` at start. What the node needs without
it is :class:`RecoveryProgress`, the cold -> loading_segments ->
replaying_wal -> catchup -> live walk that /healthz and /statusz report; a
node without a store goes from cold to live.
"""

from .recovery import RecoveryProgress

__all__ = ["RecoveryProgress"]

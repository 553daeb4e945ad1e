"""Durable sharded ledger store.

Counterpart of ``at2_node_tpu/store/__init__.py``.

Replaces the monolithic full-snapshot checkpoint (ledger/checkpoint.py)
with an incremental, crash-safe on-disk layout:

* **segments** (segments.py) — per-account-range shard files holding
  account state and committed history for the shard's senders;
* **write-ahead delta log** (wal.py) — checksummed JSON lines, one per
  committed slot, appended at commit time and folded into segments at
  the next flush;
* **manifest** (manifest.py) — the single atomic commit point binding a
  generation of segment files + the WAL position + the client directory
  + the recent ring + broadcast-safety watermarks (per-origin
  last-attested sequences, so a restarted node never signs a conflicting
  echo for a slot it attested pre-crash) + the membership epoch.

The facade is :class:`ShardedStore` (sharded.py): dirty-shard tracking
makes flush cost proportional to the *delta* since the last flush, not
to account count. Recovery (recovery.py) is load-segments -> replay-WAL
-> catchup-to-live, each stage surfaced through :class:`RecoveryProgress` on /statusz and
/healthz.
"""

from .manifest import MANIFEST_NAME, STORE_FORMAT_VERSION
from .recovery import RecoveryProgress
from .sharded import InjectedCrash, ShardedStore
from .wal import WalRecord

__all__ = [
    "MANIFEST_NAME",
    "STORE_FORMAT_VERSION",
    "InjectedCrash",
    "RecoveryProgress",
    "ShardedStore",
    "WalRecord",
]

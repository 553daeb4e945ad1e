"""Committed-payload history store: the serving side of ledger catchup.

Counterpart of ``at2_node_tpu/ledger/history.py``.

The reference leaves "catchup mechanism" as an open roadmap item
(`at2-node/README.md:53`); this build closes it. A rejoining (or
long-partitioned) node cannot reconstruct balances from a peer's ledger
SNAPSHOT safely — in a consensus-free ledger an account's balance is a
function of the full committed history (credits arrive without bumping
the recipient's sequence, so (sequence, balance) pairs from different
peers are not comparable at a point in time). What IS safely
transferable is the history itself: committed payloads are client-signed
(unforgeable) and sieve guarantees at most one committed content per
(sender, sequence) slot, so replaying quorum-confirmed history through
the normal sequence gate deterministically re-converges the ledger.

Every node therefore retains its recently committed payloads here
(recorded by the commit pass in `node.service.Service._drain_to_fixpoint_locked`) and serves them to
catching-up peers over the mesh (`HIST_IDX_REQ`/`HIST_REQ` messages,
`broadcast/messages.py`). Retention is bounded: beyond ``cap`` total
payloads the oldest are evicted FIFO, and a request older than the
horizon is answered with whatever suffix survives — the requester
detects the gap (its frontier stays behind) and the operator restores
from a fresher checkpoint, which is the honest limit of a bounded store.

Per-sender sequences are contiguous by construction (the account gate
admits only last+1, `ledger/account.py`), so each sender's retained
range is a contiguous suffix ``[evicted+1 .. last]``.
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Tuple

# Serving bounds (requests are clamped, never rejected): one HIST_REQ
# yields at most MAX_RANGE payloads, batched MAX_BATCH per wire message
# so a response frame stays far under the transport's 16 MiB frame cap.
MAX_RANGE = 4096
MAX_BATCH = 1024
# One HIST_IDX message carries at most this many frontier entries
# (36 bytes each). Truncation keeps the first N in ledger-dict insertion
# order (arbitrary, not recency); a requester behind on >N senders still
# converges over multiple sessions as its own frontier advances.
MAX_IDX_ENTRIES = 100_000

DEFAULT_CAP = 1 << 17


class CommittedHistory:
    """Bounded FIFO store of committed payloads, indexed by slot."""

    def __init__(self, cap: int = DEFAULT_CAP) -> None:
        self.cap = cap
        self._by_sender: Dict[bytes, Dict[int, object]] = {}
        self._order: Deque[Tuple[bytes, int]] = deque()

    def __len__(self) -> int:
        return len(self._order)

    def record(self, payload) -> None:
        """Retain one committed payload (idempotent per slot)."""
        sender_map = self._by_sender.setdefault(payload.sender, {})
        if payload.sequence in sender_map:
            return
        sender_map[payload.sequence] = payload
        self._order.append((payload.sender, payload.sequence))
        while len(self._order) > self.cap:
            old_sender, old_seq = self._order.popleft()
            old_map = self._by_sender.get(old_sender)
            if old_map is not None:
                old_map.pop(old_seq, None)
                if not old_map:
                    del self._by_sender[old_sender]

    def get_range(self, sender: bytes, lo: int, hi: int) -> List:
        """Retained payloads for ``sender`` with lo <= seq <= hi, in
        sequence order, clamped to MAX_RANGE."""
        sender_map = self._by_sender.get(sender)
        if not sender_map:
            return []
        hi = min(hi, lo + MAX_RANGE - 1)
        return [
            sender_map[seq]
            for seq in range(lo, hi + 1)
            if seq in sender_map
        ]

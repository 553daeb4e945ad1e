"""Recent-transactions ring actor (last 10, Pending/Success/Failure).

Counterpart of ``at2_node_tpu/ledger/recent.py``.

Equivalent of the reference's `RecentTransactions` actor
(`at2-node/src/bin/server/recent_transactions.rs:38-201`):

* capacity-10 ring (`recent_transactions.rs:7`), oldest evicted
  (`:173-177`);
* ``put`` stamps the current UTC time, starts Pending, and is a NOP when a
  transaction with the same (sender, sequence) is already present
  (`:149-180`);
* ``update`` finds the latest matching (sender, sequence) and flips its
  state; NOP when absent because a transaction may resolve after eviction
  (`:182-196`).
"""

from __future__ import annotations

import asyncio
import dataclasses
import datetime
from collections import deque
from typing import Deque, List

from ..types import FullTransaction, ThinTransaction, TransactionState

LATEST_TRANSACTIONS_MAX_SIZE = 10  # recent_transactions.rs:7


class RecentTransactions:
    """Single-writer actor over the last-N transactions ring."""

    def __init__(self) -> None:
        self._ring: Deque[FullTransaction] = deque()
        self._lock = asyncio.Lock()

    def _put_locked(
        self, sender: bytes, sender_sequence: int, thin: ThinTransaction
    ) -> None:
        for tx in self._ring:
            if tx.sender_sequence == sender_sequence and tx.sender == sender:
                return
        if len(self._ring) == LATEST_TRANSACTIONS_MAX_SIZE:
            self._ring.popleft()
        self._ring.append(
            FullTransaction(
                timestamp=datetime.datetime.now(datetime.timezone.utc),
                sender=sender,
                sender_sequence=sender_sequence,
                recipient=thin.recipient,
                amount=thin.amount,
                state=TransactionState.PENDING,
            )
        )

    async def put(
        self, sender: bytes, sender_sequence: int, thin: ThinTransaction
    ) -> None:
        async with self._lock:
            self._put_locked(sender, sender_sequence, thin)

    async def put_many(self, rows: list) -> None:
        """Insert many Pending records under ONE lock round-trip
        (SendAssetBatch ingress): rows are ``(sender, sequence, thin)``,
        per-row semantics identical to :meth:`put`."""
        async with self._lock:
            for sender, seq, thin in rows:
                self._put_locked(sender, seq, thin)

    def _update_locked(
        self, sender: bytes, sender_sequence: int, state: TransactionState
    ) -> None:
        """Flip the latest matching entry's state (caller holds the lock;
        NOP when absent — a transaction may resolve after eviction)."""
        for tx in reversed(self._ring):
            if tx.sender_sequence == sender_sequence and tx.sender == sender:
                tx.state = state
                return

    def _mark_failure_locked(
        self, sender: bytes, sender_sequence: int
    ) -> None:
        """TTL marking for a stale (already-consumed-sequence) heap entry
        (caller holds the lock): a catchup/delivery duplicate of a
        COMMITTED transfer must not flip its twin's SUCCESS record, while
        a genuinely failed transfer (its own debit consumed the sequence)
        still gets the reference's FAILURE record
        (`at2-node/src/bin/server/rpc.rs:183-193`)."""
        for tx in reversed(self._ring):
            if tx.sender_sequence == sender_sequence and tx.sender == sender:
                if tx.state is not TransactionState.SUCCESS:
                    tx.state = TransactionState.FAILURE
                return

    async def update(
        self, sender: bytes, sender_sequence: int, state: TransactionState
    ) -> None:
        async with self._lock:
            self._update_locked(sender, sender_sequence, state)

    async def mark_failure_unless_success(
        self, sender: bytes, sender_sequence: int
    ) -> None:
        async with self._lock:
            self._mark_failure_locked(sender, sender_sequence)

    async def apply_many(self, ops: list) -> None:
        """Apply an ordered batch of ring mutations under ONE lock
        round-trip (the delivery loop collects a whole drain pass's
        updates): ops are ``("update", sender, seq, state)`` or
        ``("unless_success", sender, seq)`` rows, with exactly the same
        per-op semantics as :meth:`update` /
        :meth:`mark_failure_unless_success`."""
        async with self._lock:
            for op in ops:
                if op[0] == "update":
                    self._update_locked(op[1], op[2], op[3])
                else:
                    self._mark_failure_locked(op[1], op[2])

    async def export_state(self) -> list:
        """Snapshot for checkpointing (JSON-safe rows, oldest first)."""
        from ..types import rfc3339

        async with self._lock:
            return [
                [
                    rfc3339(tx.timestamp),
                    tx.sender.hex(),
                    tx.sender_sequence,
                    tx.recipient.hex(),
                    tx.amount,
                    tx.state.value,
                ]
                for tx in self._ring
            ]

    async def import_state(self, rows: list) -> None:
        from ..types import parse_rfc3339

        async with self._lock:
            self._ring = deque(
                FullTransaction(
                    timestamp=parse_rfc3339(ts),
                    sender=bytes.fromhex(sender),
                    sender_sequence=seq,
                    recipient=bytes.fromhex(recipient),
                    amount=amount,
                    state=TransactionState(state),
                )
                for ts, sender, seq, recipient, amount, state in rows
            )

    async def get_all(self) -> List[FullTransaction]:
        async with self._lock:
            # Deep snapshot, like the reference's `self.0.clone()`
            # (recent_transactions.rs:198-200): later state updates must not
            # mutate an already-returned list, nor callers corrupt the ring.
            return [dataclasses.replace(tx) for tx in self._ring]

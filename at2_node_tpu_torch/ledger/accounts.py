"""Single-writer accounts guard owning the ledger map.

Counterpart of ``at2_node_tpu/ledger/accounts.py``.

Equivalent of the reference's `Accounts`/`AccountsHandler` actor
(`at2-node/src/bin/server/accounts/mod.rs:28-214`). The reference
needs a tokio task + mpsc/oneshot channels because its mutations come from
many OS threads; in a single-threaded asyncio node the same single-writer
linearizability falls out of serializing all mutations through one
``asyncio.Lock`` critical section — no channel machinery, no close-time
future bookkeeping (the sibling :class:`RecentTransactions` uses the same
pattern).

Observable semantics reproduced exactly (pinned by the reference's tests at
`accounts/mod.rs:216-301`):

* unknown accounts read as fresh (balance 100 000, sequence 0)
  (`accounts/mod.rs:155-163,207-213`);
* self-transfer is a zero-amount debit: bumps the sequence, keeps the
  balance (`accounts/mod.rs:175-182`);
* a transfer debits then credits; the sender's account state is persisted
  even when the debit fails, so a failed overdraft still consumes the
  sender's sequence number (`accounts/mod.rs:184-196`).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict

from ..obs.audit import LedgerDigest
from .account import Account, AccountException

logger = logging.getLogger(__name__)


class AccountModificationError(Exception):
    """Wraps an account-level failure; the delivery loop retries only this
    error kind (gap filling, `at2-node/src/bin/server/rpc.rs:195-205`)."""

    def __init__(self, source: AccountException):
        super().__init__(f"account modification: {source}")
        self.source = source


class Accounts:
    """Async facade over the ledger; all mutations serialize on one lock."""

    def __init__(self) -> None:
        self._ledger: Dict[bytes, Account] = {}
        self._lock = asyncio.Lock()
        # Fleet-audit digest lanes (obs/audit.py): folded at every
        # mutation site below so they are always an O(1)-maintained pure
        # function of the current ledger state — the beacon plane reads
        # them without ever scanning the ledger.
        self.digest = LedgerDigest()

    def close(self) -> None:
        """Kept for API symmetry with heavier backends; nothing to stop."""

    async def export_state(self) -> dict:
        """Snapshot for checkpointing: {hex pubkey: [last_sequence, balance]}."""
        async with self._lock:
            return {
                user.hex(): [a.last_sequence, a.balance]
                for user, a in self._ledger.items()
            }

    async def import_state(self, data: dict) -> None:
        """Replace the ledger with a checkpoint snapshot (resume-on-start)."""
        async with self._lock:
            self._ledger = {
                bytes.fromhex(user): Account(last_sequence=seq, balance=bal)
                for user, (seq, bal) in data.items()
            }
            self.digest.reseed(
                (user, a.last_sequence, a.balance)
                for user, a in self._ledger.items()
            )

    def frontier_nowait(self) -> Dict[bytes, int]:
        """Point-in-time {sender: last_sequence} map, lock-free.

        Safe on the event loop: every mutation happens synchronously
        inside a lock-held critical section on this same loop, so a
        single synchronous read can never observe a torn update. Used by
        the catchup plane, whose handlers run in broadcast workers and
        must not await the actor lock. O(ledger) — hot paths that need a
        single sender use :meth:`last_sequence_nowait` instead.
        """
        return {
            user: a.last_sequence
            for user, a in self._ledger.items()
            if a.last_sequence > 0
        }

    def last_sequence_nowait(self, user: bytes) -> int:
        """Single-sender lock-free read (same safety argument as
        :meth:`frontier_nowait`); O(1) for the delivery drain's per-entry
        staleness check."""
        account = self._ledger.get(user)
        return account.last_sequence if account is not None else 0

    async def get_balance(self, user: bytes) -> int:
        async with self._lock:
            account = self._ledger.get(user)
            return account.balance if account is not None else Account().balance

    async def get_last_sequence(self, user: bytes) -> int:
        async with self._lock:
            account = self._ledger.get(user)
            return account.last_sequence if account is not None else 0

    async def transfer(
        self, sender: bytes, sender_sequence: int, receiver: bytes, amount: int
    ) -> None:
        async with self._lock:
            self._transfer(sender, sender_sequence, receiver, amount)

    async def run_exclusive(self, fn):
        """Run a synchronous multi-item ledger transaction under the
        single-writer lock: ``fn(self)`` may call ``_transfer`` and the
        ``*_nowait`` readers but MUST NOT await. One lock round-trip per
        delivery-batch instead of per transfer — the commit path's cost
        at batched-plane rates, with the
        same linearizability argument: nothing interleaves a synchronous
        critical section on a single event loop."""
        async with self._lock:
            return fn(self)

    def _touch(self, key: bytes, old: tuple, account: Account) -> None:
        """Fold one row's (sequence, balance) change into the audit
        digest; no-op when the observable state did not change."""
        if old != (account.last_sequence, account.balance):
            self.digest.touch(
                key, old[0], old[1], account.last_sequence, account.balance
            )

    def _tamper(self, user: bytes, delta: int) -> None:
        """Failpoint back door (sim/campaign.py planted-divergence
        episodes): misapply ``delta`` to ``user``'s balance exactly as a
        buggy apply would. The digest folds the corrupted post-state —
        which is precisely what lets peers' auditors catch it."""
        account = self._ledger.setdefault(user, Account())
        old = (account.last_sequence, account.balance)
        account.balance += delta
        self._touch(user, old, account)

    def _transfer(
        self, sender: bytes, sender_sequence: int, receiver: bytes, amount: int
    ) -> None:
        if sender == receiver:
            logger.warning("transfer to itself: %s", sender.hex())
            account = self._ledger.setdefault(sender, Account())
            old = (account.last_sequence, account.balance)
            try:
                account.debit(sender_sequence, 0)
            except AccountException as exc:
                self._touch(sender, old, account)
                raise AccountModificationError(exc) from exc
            self._touch(sender, old, account)
            return

        sender_account = self._ledger.get(sender) or Account()
        receiver_account = self._ledger.get(receiver) or Account()
        sender_old = (sender_account.last_sequence, sender_account.balance)
        receiver_old = (
            receiver_account.last_sequence,
            receiver_account.balance,
        )

        try:
            sender_account.debit(sender_sequence, amount)
        except AccountException as exc:
            # Persist the (sequence-consumed) sender state even on failure
            # (accounts/mod.rs:190-194).
            self._ledger[sender] = sender_account
            self._touch(sender, sender_old, sender_account)
            raise AccountModificationError(exc) from exc
        self._ledger[sender] = sender_account
        self._touch(sender, sender_old, sender_account)

        try:
            receiver_account.credit(amount)
        except AccountException as exc:
            raise AccountModificationError(exc) from exc
        self._ledger[receiver] = receiver_account
        self._touch(receiver, receiver_old, receiver_account)

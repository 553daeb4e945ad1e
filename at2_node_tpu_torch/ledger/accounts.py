"""Single-writer accounts guard owning the ledger map: the commit at the
end of the verify path.

Counterpart of ``at2_node_tpu/ledger/accounts.py``, with the observable
semantics of the upstream at2-node ``Accounts`` actor
(``accounts/mod.rs``). All mutations serialize on one ``asyncio.Lock``:

* unknown accounts read as fresh (balance 100 000, sequence 0);
* self-transfer is a zero-amount debit: bumps the sequence, keeps the
  balance;
* a transfer debits then credits; the sender's account state is kept even
  when the debit fails, so a failed overdraft still consumes the sender's
  sequence number.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict

from ..obs.audit import LedgerDigest
from .account import Account, AccountException

logger = logging.getLogger(__name__)


class AccountModificationError(Exception):
    """Wraps an account-level failure (a delivery loop retries only this
    error kind when it fills sequence gaps)."""

    def __init__(self, source: AccountException):
        super().__init__(f"account modification: {source}")
        self.source = source


class Accounts:
    """Async facade over the ledger; all mutations serialize on one lock."""

    def __init__(self) -> None:
        self._ledger: Dict[bytes, Account] = {}
        self._lock = asyncio.Lock()
        # audit digest lanes (obs/audit.py), folded at every mutation so
        # they stay an O(1)-maintained function of the ledger state
        self.digest = LedgerDigest()

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

    def _touch(self, key: bytes, old: tuple, account: Account) -> None:
        """Fold one row's (sequence, balance) change into the audit
        digest; no-op when the observable state did not change."""
        if old != (account.last_sequence, account.balance):
            self.digest.touch(
                key, old[0], old[1], account.last_sequence, account.balance
            )

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
            # keep the (sequence-consumed) sender state even on failure
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

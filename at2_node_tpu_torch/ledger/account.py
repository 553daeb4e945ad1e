"""Per-account balance + sequence state machine.

Counterpart of ``at2_node_tpu/ledger/account.py``, with the observable
semantics of the upstream at2-node ``Account`` (``accounts/account.rs``):

* accounts start with ``INITIAL_BALANCE`` (100 000) — the faucet TODO
  (`account.rs:17,24`);
* ``credit`` checks u64 overflow (`account.rs:29-33`);
* ``debit`` requires ``sequence == last_sequence + 1`` and bumps
  ``last_sequence`` BEFORE the balance check, so a failed (underflow)
  debit still consumes the sequence number (`account.rs:36-43`).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

INITIAL_BALANCE = 100_000
_U64_MAX = (1 << 64) - 1


class AccountError(enum.Enum):
    INCONSECUTIVE_SEQUENCE = "inconsecutive sequence"
    OVERFLOW = "overflow"
    UNDERFLOW = "underflow"


class AccountException(Exception):
    def __init__(self, kind: AccountError):
        super().__init__(kind.value)
        self.kind = kind


def _check_u64(amount: int) -> None:
    # Rust's u64 type makes negative/oversized amounts unrepresentable
    # (account.rs:14); Python ints need the bound enforced explicitly.
    if not 0 <= amount <= _U64_MAX:
        raise ValueError("amount must fit in u64")


@dataclass
class Account:
    last_sequence: int = 0
    balance: int = INITIAL_BALANCE

    def credit(self, amount: int) -> None:
        _check_u64(amount)
        new = self.balance + amount
        if new > _U64_MAX:
            raise AccountException(AccountError.OVERFLOW)
        self.balance = new

    def debit(self, sequence: int, amount: int) -> None:
        _check_u64(amount)
        if self.last_sequence + 1 != sequence:
            raise AccountException(AccountError.INCONSECUTIVE_SEQUENCE)
        # Sequence is consumed even if the balance check below fails
        # (account.rs), as upstream's `debit_too_much_fails` test pins.
        self.last_sequence = sequence
        if amount > self.balance:
            raise AccountException(AccountError.UNDERFLOW)
        self.balance -= amount

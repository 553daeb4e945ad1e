"""Plain AT2 ledger rules over Python ints: the reference for every
balance and sequence the benchmark reads back from a node.

An account starts with ``initial_balance``. A transfer (sender, sequence,
recipient, amount) commits when its sequence is the sender's last
committed sequence plus one and the sender's balance covers the amount;
then the amount moves and the sender's sequence advances. Transfers of
distinct senders commute as long as no debit can fail, so
:func:`final_state` first checks that every sender's debits are covered
by its initial balance alone, whatever it receives and in whatever order
the senders interleave; traffic that could overdraw raises, since then
the final ledger would depend on the order the nodes chose.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

Transfer = Tuple[bytes, int, bytes, int]


class Ledger:
    def __init__(self, initial_balance: int) -> None:
        self.initial_balance = initial_balance
        self.balance: Dict[bytes, int] = {}
        self.sequence: Dict[bytes, int] = {}

    def balance_of(self, account: bytes) -> int:
        return self.balance.get(account, self.initial_balance)

    def sequence_of(self, account: bytes) -> int:
        return self.sequence.get(account, 0)

    def apply(self, sender: bytes, sequence: int, recipient: bytes, amount: int) -> bool:
        """Commit one transfer if the rules allow it; whether it committed."""
        if sequence != self.sequence_of(sender) + 1 or self.balance_of(sender) < amount:
            return False
        self.balance[sender] = self.balance_of(sender) - amount
        self.balance[recipient] = self.balance_of(recipient) + amount
        self.sequence[sender] = sequence
        return True


def final_state(per_sender: Sequence[Sequence[Transfer]], initial_balance: int) -> Ledger:
    """The ledger after every sender's transfers, each sender's list in
    sequence order, interleaved round-robin. Raises ValueError when a
    sender's debits exceed its initial balance (the result would depend on
    the interleaving) or when a transfer does not commit."""
    for transfers in per_sender:
        if transfers and sum(t[3] for t in transfers) > initial_balance:
            raise ValueError(f"sender {transfers[0][0].hex()[:16]} could overdraw")
    ledger = Ledger(initial_balance)
    cursors = [iter(t) for t in per_sender]
    while cursors:
        alive = []
        for it in cursors:
            t = next(it, None)
            if t is None:
                continue
            if not ledger.apply(*t):
                raise ValueError(f"transfer {t[1]} of {t[0].hex()[:16]} does not commit")
            alive.append(it)
        cursors = alive
    return ledger


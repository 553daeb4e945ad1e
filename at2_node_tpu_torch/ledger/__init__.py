"""The ledger: per-account state machine and single-writer actors."""

from .account import Account, AccountError, INITIAL_BALANCE
from .accounts import Accounts, AccountModificationError
from .recent import RecentTransactions

__all__ = [
    "Account",
    "AccountError",
    "INITIAL_BALANCE",
    "Accounts",
    "AccountModificationError",
    "RecentTransactions",
]

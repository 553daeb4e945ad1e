"""Incremental ledger digests, folded at the ledger's mutation sites.

Counterpart of ``account_contrib``, ``watermark_contrib`` and
``LedgerDigest`` from ``at2_node_tpu/obs/audit.py``. Every digest is
additive, an unordered sum of per-row contributions, so nodes that commit
the same transfers in different orders agree, and an update is O(1):
subtract the old contribution, add the new one. A virgin account (sequence
0, balance ``INITIAL_BALANCE``) contributes zero.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Iterable, List, Tuple

# ledger/account.INITIAL_BALANCE, duplicated so obs/ stays a leaf
# package (ledger/accounts.py imports the digest, not the other way round)
INITIAL_BALANCE = 100_000

AUDIT_RANGES = 16  # account-range lanes; range index = key[0] >> 4

_M64 = (1 << 64) - 1
_M128 = (1 << 128) - 1
_ACCT_TAG = b"at2-audit/acct/v1"
_WM_TAG = b"at2-audit/wm/v1"
_QQ = struct.Struct("<QQ")
_Q = struct.Struct("<Q")


def account_contrib(key: bytes, sequence: int, balance: int) -> int:
    """u64 contribution of one ledger row to its account-range lane.

    Virgin rows contribute 0 (see module docstring) so row presence
    alone — which is not deterministic across nodes — never shows."""
    if sequence == 0 and balance == INITIAL_BALANCE:
        return 0
    h = hashlib.sha256(_ACCT_TAG + key + _QQ.pack(sequence, balance)).digest()
    return int.from_bytes(h[:8], "little")


def watermark_contrib(key: bytes, sequence: int) -> int:
    """128-bit contribution of one sender's frontier entry."""
    if sequence == 0:
        return 0
    h = hashlib.sha256(_WM_TAG + key + _Q.pack(sequence)).digest()
    return int.from_bytes(h[:16], "little")


class LedgerDigest:
    """Additive digest lanes over the account ledger, maintained at the
    mutation sites (ledger/accounts.py ``_touch``) so they are always an
    O(1)-updated pure function of the current ledger state."""

    __slots__ = ("ranges", "wm")

    def __init__(self) -> None:
        self.ranges: List[int] = [0] * AUDIT_RANGES
        self.wm: int = 0

    def touch(
        self,
        key: bytes,
        old_sequence: int,
        old_balance: int,
        new_sequence: int,
        new_balance: int,
    ) -> None:
        lane = key[0] >> 4
        self.ranges[lane] = (
            self.ranges[lane]
            - account_contrib(key, old_sequence, old_balance)
            + account_contrib(key, new_sequence, new_balance)
        ) & _M64
        if old_sequence != new_sequence:
            self.wm = (
                self.wm
                - watermark_contrib(key, old_sequence)
                + watermark_contrib(key, new_sequence)
            ) & _M128

    def reseed(self, rows: Iterable[Tuple[bytes, int, int]]) -> None:
        """Recompute from scratch over (key, sequence, balance) rows —
        the restart path, after a checkpoint/store import replaces the
        ledger wholesale."""
        self.ranges = [0] * AUDIT_RANGES
        self.wm = 0
        for key, sequence, balance in rows:
            lane = key[0] >> 4
            self.ranges[lane] = (
                self.ranges[lane] + account_contrib(key, sequence, balance)
            ) & _M64
            self.wm = (self.wm + watermark_contrib(key, sequence)) & _M128

    def ranges_bytes(self) -> bytes:
        return b"".join(_Q.pack(r) for r in self.ranges)

    def wm_bytes(self) -> bytes:
        return self.wm.to_bytes(16, "little")

"""Fleet consistency auditor: incremental ledger digests + beacon compare.

Counterpart of ``at2_node_tpu/obs/audit.py``.

AT2's correctness claim is that independent nodes converge on the same
ledger without consensus (arXiv:1812.10844) — this module is the runtime
evidence for that claim. Each node maintains a cheap incremental digest
of its committed state (folded at the mutation sites, never recomputed),
periodically gossips it as a signed ``StateBeacon`` (broadcast/messages
kind 15), and compares peers' beacons against its own history; a
confirmed conflict flips /healthz to ``diverged`` with attribution.

Digest rules (TECHNICAL.md "Fleet audit & incident capture"):

* Correct AT2 nodes commit the same *set* of transfers in different
  *orders*, so every cross-node-comparable digest is **additive**: an
  unordered sum of per-item contributions mod 2^64 / 2^128. Updating on
  a mutation is O(1): subtract the old contribution, add the new one.
* A virgin account (sequence 0, balance ``INITIAL_BALANCE``) contributes
  zero, so a ledger row created as a side effect of a *failed* apply
  (e.g. a sequence-gap retry) is digest-neutral until its observable
  state actually changes — row-creation timing can differ across nodes
  without perturbing the digest.
* Beacons are compared only between snapshots taken at the **same
  watermark digest** and the same membership epoch. The watermark digest
  sums H(sender, last_sequence) over the per-sender commit frontier;
  under AT2's gap-free per-sender sequencing, equal watermark vectors
  mean equal applied sets, so two correct nodes at the same coordinate
  MUST agree on every account-range lane. A mismatch there is a real
  divergence (corrupted apply, torn restart, registry eviction), never
  a reordering artifact — the comparison is zero-false-positive by
  construction.
* Directory skew is informational only: directory gossip is eventually
  consistent and a stale mapping is a liveness issue, not a safety one.
* The sha256 ``chain`` head is order-dependent and therefore *local
  only* — folded per beacon point, persisted in the store manifest, and
  used as restart tamper evidence; it is never compared across peers.
"""

from __future__ import annotations

import hashlib
import struct
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Tuple

# ledger/account.INITIAL_BALANCE, duplicated so obs/ stays a leaf
# package (ledger/accounts.py imports the digest, not the other way
# around); pinned against the ledger constant by tests/test_obs.py.
INITIAL_BALANCE = 100_000

AUDIT_RANGES = 16  # account-range lanes; range index = key[0] >> 4

_M64 = (1 << 64) - 1
_M128 = (1 << 128) - 1
_ACCT_TAG = b"at2-audit/acct/v1"
_WM_TAG = b"at2-audit/wm/v1"
_DIR_TAG = b"at2-audit/dir/v1"
_CHAIN_TAG = b"at2-audit/chain/v1"
_RESTART_TAG = b"at2-audit/restart/v1"
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


def directory_contrib(client_id: int, pubkey: bytes) -> int:
    """u64 contribution of one installed client-directory binding."""
    h = hashlib.sha256(_DIR_TAG + _Q.pack(client_id) + pubkey).digest()
    return int.from_bytes(h[:8], "little")


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


class FleetAuditor:
    """Local beacon history + peer comparison + divergence attribution.

    Single-threaded: every call happens on the node's event loop (commit
    tail, beacon handler, statusz renderer). Peers whose beacons arrive
    *before* the local chain reaches the same watermark are parked in a
    bounded foreign buffer and compared when the local point lands, so
    detection is symmetric regardless of who beacons first."""

    def __init__(
        self, digest: LedgerDigest, history_cap: int = 512, clock=None
    ) -> None:
        self.digest = digest
        self.history_cap = max(8, history_cap)
        # monotonic-clock source (service injects its own, virtual under
        # sim); only used to stamp the last matched-watermark comparison
        # so /statusz can report beacon AGE — a silently-stalled audit
        # loop shows as a growing age where counters alone look healthy
        self.clock = clock
        self.last_matched_mono: Optional[float] = None
        self.chain = bytes(32)
        self.commits = 0  # transfers folded since process start/restore
        self._points: "OrderedDict[bytes, dict]" = OrderedDict()
        self._foreign: "OrderedDict[bytes, list]" = OrderedDict()
        self.peers: Dict[str, dict] = {}  # origin hex -> latest summary
        self.divergence: Optional[dict] = None  # first confirmed, latched
        self.counters: Dict[str, int] = {
            "beacons_tx": 0,
            "beacons_rx": 0,
            "beacon_invalid": 0,
            "compared": 0,
            "matched": 0,
            "diverged": 0,
            "dir_skew": 0,
            "epoch_skew": 0,
        }

    # ---- local chain ---------------------------------------------------

    def note_commit(self, n: int = 1) -> None:
        self.commits += n

    def snapshot(self, epoch: int, dir_digest: int) -> dict:
        """Fold a new audit point at the current state and return it;
        beacons are built from exactly this dict (service._emit_beacon).
        Also settles any parked foreign beacons at the same watermark."""
        wm = self.digest.wm_bytes()
        ranges = self.digest.ranges_bytes()
        dird = _Q.pack(dir_digest & _M64)
        self.chain = hashlib.sha256(
            _CHAIN_TAG
            + self.chain
            + _QQ.pack(epoch, self.commits)
            + wm
            + ranges
            + dird
        ).digest()
        point = {
            "epoch": epoch,
            "commits": self.commits,
            "wm": wm,
            "ranges": ranges,
            "dir": dird,
            "chain": self.chain,
        }
        # first observation of a watermark wins: its `commits` is the
        # earliest local coordinate, which is what attribution reports
        if wm not in self._points:
            self._points[wm] = point
            while len(self._points) > self.history_cap:
                self._points.popitem(last=False)
        for origin, remote in self._foreign.pop(wm, ()):
            self._compare(origin, remote, self._points.get(wm, point))
        return point

    # ---- peer beacons --------------------------------------------------

    def observe(self, origin_hex: str, remote: dict) -> Optional[dict]:
        """Feed one verified peer beacon (as a field dict); returns the
        divergence record when this observation confirms a conflict."""
        self.counters["beacons_rx"] += 1
        self.peers[origin_hex] = {
            "epoch": remote["epoch"],
            "commits": remote["commits"],
            "wm": remote["wm"].hex(),
            "chain": remote["chain"].hex(),
        }
        point = self._points.get(remote["wm"])
        if point is None:
            parked = self._foreign.setdefault(remote["wm"], [])
            parked.append((origin_hex, remote))
            while len(self._foreign) > self.history_cap:
                self._foreign.popitem(last=False)
            return None
        return self._compare(origin_hex, remote, point)

    def _compare(
        self, origin_hex: str, remote: dict, local: dict
    ) -> Optional[dict]:
        if remote["epoch"] != local["epoch"]:
            # mid-reconfiguration snapshots are incomparable, not wrong
            self.counters["epoch_skew"] += 1
            return None
        self.counters["compared"] += 1
        if remote["ranges"] == local["ranges"]:
            self.counters["matched"] += 1
            if self.clock is not None:
                self.last_matched_mono = self.clock.monotonic()
            if remote["dir"] != local["dir"]:
                self.counters["dir_skew"] += 1
            return None
        self.counters["diverged"] += 1
        lanes = [
            i
            for i in range(AUDIT_RANGES)
            if remote["ranges"][i * 8 : i * 8 + 8]
            != local["ranges"][i * 8 : i * 8 + 8]
        ]
        record = {
            "peer": origin_hex,
            "epoch": local["epoch"],
            "ranges": lanes,  # which account ranges conflict
            "wm": remote["wm"].hex(),  # first divergent watermark
            "commits": local["commits"],  # earliest local coordinate
            "peer_commits": remote["commits"],
            "detected_commits": self.commits,
        }
        if self.divergence is None:
            self.divergence = record
        return record

    # ---- views & persistence -------------------------------------------

    def stats(self) -> Dict[str, int]:
        return dict(self.counters)

    def beacon_age(self) -> Optional[float]:
        """Mono seconds since the last matched-watermark comparison;
        None until the first match (or without a clock)."""
        if self.clock is None or self.last_matched_mono is None:
            return None
        return max(0.0, self.clock.monotonic() - self.last_matched_mono)

    def status(self, dir_digest: int) -> dict:
        return {
            "beacon_age_s": self.beacon_age(),
            "chain": self.chain.hex(),
            "commits": self.commits,
            "wm": self.digest.wm_bytes().hex(),
            "ranges": self.digest.ranges_bytes().hex(),
            "dir": dir_digest & _M64,
            "points": len(self._points),
            "foreign_parked": len(self._foreign),
            "peers": dict(self.peers),
            "divergence": self.divergence,
            "counters": self.stats(),
        }

    def export(self) -> dict:
        """Manifest-persisted view: the chain head survives restarts as
        tamper evidence (store/sharded.py ``audit``)."""
        return {"chain": self.chain.hex(), "commits": self.commits}

    def restore(self, doc: dict) -> None:
        """Resume a persisted chain, folding an explicit restart marker
        so a restarted history is distinguishable from a continuous one
        (the additive lanes are reseeded separately from the restored
        ledger by the caller)."""
        chain = doc.get("chain")
        if not chain:
            return
        self.commits = int(doc.get("commits", 0))
        self.chain = hashlib.sha256(
            _RESTART_TAG + bytes.fromhex(chain)
        ).digest()

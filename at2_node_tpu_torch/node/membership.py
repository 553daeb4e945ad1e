"""Epoch-based membership reconfiguration.

Counterpart of ``at2_node_tpu/node/membership.py``.

AT2 needs no consensus for asset transfers, and this build keeps
membership changes consensus-free too: a fleet admin signs a
``ConfigTx`` (broadcast/messages.py) naming the NEXT epoch and the
change — nodes to add (address + both public keys), nodes to remove
(sign-key), and optional quorum re-weighting — and gossips it like any
other message. Epochs are strictly sequential (a transaction must name
exactly ``current + 1``), so every correct node applies the same
transitions in the same order regardless of gossip arrival order:
a transaction for a later epoch is simply ignored until its
predecessor arrives (re-gossip and the mesh's full fan-out make that
convergent without retry machinery).

Applying a transition is three local actions:

* mesh add (net/peers.py ``add_peer``) for joining nodes — the mesh
  starts dialing them immediately;
* threshold re-weighting via the ``on_thresholds`` hook (the broadcast
  stack's echo/ready quorums);
* recording the evicted sign keys with a GRACE deadline: attestations
  from an evicted origin keep counting for ``grace`` seconds after the
  transition (covering slots already in flight when the transition
  landed). Only when ``sweep`` finds the deadline expired is the peer
  removed from the mesh (``remove_peer``) and the key banned for good —
  the "old-epoch messages rejected after a grace window" contract.

The applied epoch is durable: the service persists it in the sharded
store's manifest, so a restarted node rejoins at the epoch it had
reached, not at genesis.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

from ..broadcast.messages import ConfigTx
from ..crypto.keys import verify_one
from ..net.peers import Peer

logger = logging.getLogger(__name__)


class MembershipManager:
    """Validates and applies ConfigTx transitions; answers the two
    questions the hot path asks: ``origin_allowed(sign_key)`` and
    ``epoch`` (for /statusz)."""

    def __init__(
        self,
        *,
        admin_public: bytes,
        clock,
        grace: float = 5.0,
        epoch: int = 0,
        mesh=None,
        on_thresholds: Optional[Callable[[Optional[int], Optional[int]], None]] = None,
        own_sign_public: bytes = b"",
    ) -> None:
        self.admin_public = admin_public
        self.clock = clock
        self.grace = grace
        self.epoch = epoch
        self.mesh = mesh
        self.on_thresholds = on_thresholds
        self.own_sign_public = own_sign_public
        # evicted sign key -> clock.monotonic() deadline after which its
        # attestations stop counting. Mesh removal is DEFERRED to
        # sweep(): the broadcast stack filters origins through
        # mesh.by_sign, so removing the peer at apply time would drop
        # in-flight attestations instantly and defeat the grace window.
        self._evicted: Dict[bytes, float] = {}
        # sign keys whose grace expired and whose mesh peer was removed:
        # origin_allowed stays False for them forever (re-add via a later
        # epoch clears the ban)
        self._banned: set = set()
        self.applied = 0  # transitions applied (stats)
        self.rejected = 0  # transactions dropped by validation (stats)
        self.evicted_self = False  # this node was removed from the fleet

    # -- hot-path queries --------------------------------------------------

    def origin_allowed(self, sign_public: bytes) -> bool:
        """False once an evicted origin's grace window has expired."""
        if sign_public in self._banned:
            return False
        deadline = self._evicted.get(sign_public)
        if deadline is None:
            return True
        return self.clock.monotonic() < deadline

    def sweep(self, now: Optional[float] = None) -> int:
        """Finalize evictions whose grace window has expired: remove the
        peer from the mesh (the stack's by_sign filter then drops its
        attestations) and move the key to the permanent ban set. Called
        from the service's periodic loop and after sim settles. Returns
        the number of evictions finalized."""
        if now is None:
            now = self.clock.monotonic()
        expired = [k for k, dl in self._evicted.items() if now >= dl]
        for key in expired:
            del self._evicted[key]
            self._banned.add(key)
            if self.mesh is not None:
                self.mesh.remove_peer(key)
        return len(expired)

    # -- transitions -------------------------------------------------------

    def handle(self, tx: ConfigTx) -> bool:
        """Validate and apply one config transaction. Returns True when
        the transaction was NEWLY applied (the caller re-gossips it so
        the fleet converges); False for duplicates, stale or gapped
        epochs, bad signatures, and malformed bodies."""
        if not self.admin_public:
            return False  # reconfiguration disabled
        if tx.epoch != self.epoch + 1:
            # duplicates/stale are normal gossip echo; a gapped future
            # epoch waits for its predecessor's re-gossip
            if tx.epoch > self.epoch + 1:
                self.rejected += 1
            return False
        if not verify_one(self.admin_public, tx.to_sign(), tx.signature):
            self.rejected += 1
            logger.warning("config tx epoch %d: bad admin signature", tx.epoch)
            return False
        try:
            change = tx.change()
            if not isinstance(change, dict):
                raise ValueError("change body must be an object")
            self._apply(change)
        except (ValueError, KeyError, TypeError) as exc:
            self.rejected += 1
            logger.warning("config tx epoch %d malformed: %s", tx.epoch, exc)
            return False
        self.epoch = tx.epoch
        self.applied += 1
        logger.info("membership epoch %d applied", self.epoch)
        # grace <= 0 means "no window": finalize the eviction now rather
        # than waiting for the next periodic sweep
        self.sweep()
        return True

    def _apply(self, change: dict) -> None:
        grace = float(change.get("grace", self.grace))
        deadline = self.clock.monotonic() + grace
        # validate everything before mutating anything: a half-applied
        # transition would diverge nodes that saw the same transaction
        adds = []
        for row in change.get("add", []):
            adds.append(
                Peer(
                    address=str(row["address"]),
                    exchange_public=bytes.fromhex(row["exchange_hex"]),
                    sign_public=bytes.fromhex(row["sign_hex"]),
                )
            )
        removes = [bytes.fromhex(h) for h in change.get("remove", [])]
        for peer in adds:
            if len(peer.exchange_public) != 32 or len(peer.sign_public) != 32:
                raise ValueError("membership add row: bad key length")
        for key in removes:
            if len(key) != 32:
                raise ValueError("membership remove row: bad key length")
        for peer in adds:
            # a re-added node sheds any pending eviction or ban
            self._evicted.pop(peer.sign_public, None)
            self._banned.discard(peer.sign_public)
            if self.mesh is not None:
                self.mesh.add_peer(peer)
        for key in removes:
            # mesh removal is deferred to sweep() so attestations from
            # the evicted origin keep counting through the grace window
            self._evicted[key] = deadline
            if key == self.own_sign_public:
                self.evicted_self = True
        echo = change.get("echo_threshold")
        ready = change.get("ready_threshold")
        if (echo is not None or ready is not None) and self.on_thresholds:
            self.on_thresholds(
                int(echo) if echo is not None else None,
                int(ready) if ready is not None else None,
            )

    def stats(self) -> dict:
        return {
            "epoch": self.epoch,
            "applied": self.applied,
            "rejected": self.rejected,
            "evicted_pending": len(self._evicted),
            "evicted_final": len(self._banned),
            "evicted_self": self.evicted_self,
        }

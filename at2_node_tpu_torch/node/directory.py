"""Dense client directory: client-id -> ed25519 pubkey.

Counterpart of ``at2_node_tpu/node/directory.py``.

The broker ingress tier (Chop Chop's distillation, arXiv:2304.07081)
replaces the per-entry 32-byte pubkey with a varint client-id, which
needs a mapping every node agrees on *enough* to resolve ids — but the
mapping is deliberately NOT consensus state:

* Ids are assigned **strided by node rank**: node ``rank`` of ``total``
  hands out ``rank, rank + total, rank + 2*total, ...``. Any node can
  register a client without coordination, ids never collide, and the id
  space stays dense (the directory is a flat array, not a hash map).
* Assignments are gossiped via ``DirectoryAnnounce`` (wire kind 13) over
  the authenticated node mesh and persisted through the checkpoint.
* A wrong or missing mapping can only make an entry FAIL signature
  verification on the affected node (the entry's signature binds the
  real key) — degrading liveness for that id, handled by the existing
  per-entry attestation bitmaps and poison-entry resolution. Safety
  never depends on directory agreement, so no consensus is needed.

The pubkey table is a contiguous ``(cap, 32)`` uint8 numpy array so the
native distilled-frame parser can resolve every id in one GIL-released
pass (``at2_distill_parse`` takes the base pointer + row count). An
all-zero row means "unassigned" — the zero key is not a usable ed25519
verification key, so the sentinel cannot shadow a real client.

Because the table is dense, the id space must stay bounded even against
a byzantine mesh peer: ids are u64 on the wire, and without a bound one
``DirectoryAnnounce`` claiming id ~2^60 (in the announcer's own stride,
so it passes the stride check) would force an exabyte-scale allocation
on every correct receiver. Two limits close that:

* ``MAX_CLIENTS_PER_RANK`` — hard cap on the stride multiplier ``k``
  (``client_id = rank + total * k``), bounding the table at
  ``total * MAX_CLIENTS_PER_RANK`` rows no matter what arrives;
* ``APPLY_GAP_SLACK`` — an accepted id may run at most this many
  registrations ahead of the mappings already installed for its stride.
  Announces arrive roughly in assignment order (and checkpoint imports
  are id-sorted), so honest traffic always fits; a forged far-ahead id
  is refused without allocating. A legitimate mapping dropped for an
  out-of-order gap is liveness-only and repairs once the gap fills (the
  assigning node re-announces on client Register retries).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..obs.audit import directory_contrib

_ZERO32 = b"\x00" * 32
_M64 = (1 << 64) - 1

# Per-stride registration cap: bounds the dense table (and every peer's
# copy, and the checkpoint) at total * cap rows of 32 bytes. 2^18 rows
# = 8 MiB per stride — far above any bench or deployment here.
MAX_CLIENTS_PER_RANK = 1 << 18

# How far beyond a stride's installed-mapping count an applied id may
# reach (out-of-order gossip tolerance; see module docstring).
APPLY_GAP_SLACK = 1024


class DirectoryFullError(RuntimeError):
    """This node's stride hit MAX_CLIENTS_PER_RANK; no ids left."""


class ClientDirectory:
    def __init__(self, rank: int = 0, total: int = 1) -> None:
        if total < 1 or not (0 <= rank < total):
            raise ValueError(f"bad directory stride rank={rank} total={total}")
        self.rank = rank
        self.total = total
        self._keys = np.zeros((1024, 32), dtype=np.uint8)
        self._limit = 0  # rows [0, _limit) may be assigned
        self._ids: Dict[bytes, int] = {}
        self._next_k = 0  # next own-stride multiplier
        # installed mappings per stride rank, the anchor of the
        # APPLY_GAP_SLACK bound (assign and apply both advance it)
        self._rank_applied: Dict[int, int] = {}
        # Additive fleet-audit digest over installed bindings
        # (obs/audit.py): bindings are install-once (first wins), so a
        # u64 sum of per-binding contributions is order-independent and
        # O(1) to maintain. Informational in beacon comparisons —
        # directory gossip is eventually consistent.
        self.digest = 0

    def __len__(self) -> int:
        return len(self._ids)

    def _ensure(self, client_id: int) -> None:
        if client_id >= len(self._keys):
            cap = len(self._keys)
            while cap <= client_id:
                cap *= 2
            grown = np.zeros((cap, 32), dtype=np.uint8)
            grown[: self._limit] = self._keys[: self._limit]
            self._keys = grown
        if client_id >= self._limit:
            self._limit = client_id + 1

    def assign(self, pubkey: bytes) -> Tuple[int, bool]:
        """Register ``pubkey`` in this node's stride; idempotent.

        Returns ``(client_id, created)`` — ``created`` is False when the
        key was already registered (here or via gossip)."""
        if len(pubkey) != 32 or pubkey == _ZERO32:
            raise ValueError("pubkey must be 32 nonzero bytes")
        existing = self._ids.get(pubkey)
        if existing is not None:
            return existing, False
        if self._next_k >= MAX_CLIENTS_PER_RANK:
            raise DirectoryFullError(
                f"stride {self.rank} is full ({MAX_CLIENTS_PER_RANK} ids)"
            )
        client_id = self.rank + self.total * self._next_k
        self._next_k += 1
        self._ensure(client_id)
        self._keys[client_id] = np.frombuffer(pubkey, dtype=np.uint8)
        self._ids[pubkey] = client_id
        self._rank_applied[self.rank] = self._rank_applied.get(self.rank, 0) + 1
        self.digest = (self.digest + directory_contrib(client_id, pubkey)) & _M64
        return client_id, True

    def apply(self, client_id: int, pubkey: bytes, rank: Optional[int] = None) -> bool:
        """Install a gossiped mapping. Returns False (without mutating)
        when the mapping is rejected: malformed key, id outside the
        announcing node's stride (``rank`` given), id beyond the growth
        bounds (MAX_CLIENTS_PER_RANK / APPLY_GAP_SLACK — the allocation
        DoS guard, refused before any array growth), or the id is
        already bound to a DIFFERENT key (first binding wins — a
        conflicting re-announce is exactly the liveness-only poisoning
        the trust argument allows, so it is dropped, not honored)."""
        if len(pubkey) != 32 or pubkey == _ZERO32 or client_id < 0:
            return False
        if rank is not None and client_id % self.total != rank:
            return False
        current = self.get(client_id)
        if current is not None:
            return current == pubkey
        r = client_id % self.total
        k = client_id // self.total
        if k >= MAX_CLIENTS_PER_RANK:
            return False
        if k > self._rank_applied.get(r, 0) + APPLY_GAP_SLACK:
            return False
        self._ensure(client_id)
        self._keys[client_id] = np.frombuffer(pubkey, dtype=np.uint8)
        self._ids.setdefault(pubkey, client_id)
        self._rank_applied[r] = self._rank_applied.get(r, 0) + 1
        self.digest = (self.digest + directory_contrib(client_id, pubkey)) & _M64
        if r == self.rank:
            self._next_k = max(self._next_k, k + 1)
        return True

    def get(self, client_id: int) -> Optional[bytes]:
        if not (0 <= client_id < self._limit):
            return None
        row = self._keys[client_id].tobytes()
        return None if row == _ZERO32 else row

    def id_of(self, pubkey: bytes) -> Optional[int]:
        return self._ids.get(pubkey)

    def keys_view(self) -> Tuple[np.ndarray, int]:
        """(contiguous uint8 table, assigned-row count) for the native
        parser; rows at id >= count are misses by construction."""
        return self._keys, self._limit

    def export(self) -> List[List[str]]:
        """Checkpoint form: ``[[id_as_str, pubkey_hex], ...]`` sorted by
        id (ids can exceed 2^53, so they travel as strings in JSON)."""
        pairs = sorted((cid, key) for key, cid in self._ids.items())
        out = [[str(cid), key.hex()] for cid, key in pairs]
        # ids bound by gossip under a key that later got a second id are
        # only in the array; export those rows too so restore is exact
        known = {cid for cid, _ in pairs}
        for cid in range(self._limit):
            if cid in known:
                continue
            row = self._keys[cid].tobytes()
            if row != _ZERO32:
                out.append([str(cid), row.hex()])
        out.sort(key=lambda p: int(p[0]))
        return out

    def import_(self, entries: Iterable[Iterable[str]]) -> int:
        """Restore from :meth:`export` output; returns mappings applied."""
        applied = 0
        for cid_s, key_hex in entries:
            if self.apply(int(cid_s), bytes.fromhex(key_hex)):
                applied += 1
        return applied

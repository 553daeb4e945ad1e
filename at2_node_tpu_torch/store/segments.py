"""Per-account-range segment files.

Counterpart of ``at2_node_tpu/store/segments.py``.

An account belongs to shard ``shard_of(pubkey)`` — the first two bytes
of its ed25519 key modulo the shard count, so the assignment is stable
across restarts and independent of insertion order. One segment file
holds one shard's slice of the ledger:

* ``accounts``: ``{pubkey_hex: [last_sequence, balance]}``
* ``history``: ``{sender_hex: [payload_body_hex, ...]}`` — the 140-byte
  GOSSIP payload bodies (broadcast/messages.py ``Payload``) of the
  shard's committed slots, in sequence order. Persisting the full body
  (client signature included) keeps the conservation invariant and the
  forged-commit sweep checkable across a restart: replayed history
  reproduces balances and every slot still carries its client
  signature.

Segment files are immutable once written: a flush writes dirty shards
under NEW generation-stamped names and the manifest rename is what
commits them (manifest.py). A crash mid-write can therefore never tear
a referenced segment — the torn file is an unreferenced orphan, removed
by the next successful flush or at load.
"""

from __future__ import annotations

import json
from typing import Dict, List

from ..ledger.checkpoint import write_atomic

SEGMENT_FORMAT_VERSION = 1

#: default shard count; 16 keeps sim stores small while still proving
#: the dirty-shard accounting (production would size this to spread IO)
DEFAULT_SHARDS = 16


def shard_of(pubkey: bytes, n_shards: int) -> int:
    """Stable account-range assignment: leading two key bytes mod shards."""
    return int.from_bytes(pubkey[:2], "big") % n_shards


def segment_name(gen: int, shard: int) -> str:
    return f"seg-{gen:08d}-{shard:03d}.json"


def write_segment(
    path: str,
    shard: int,
    accounts: Dict[str, list],
    history: Dict[str, List[str]],
) -> int:
    """Write one shard's segment with the fsync'd-rename discipline.
    Returns the serialized size in bytes (the bench's delta-cost
    measure)."""
    doc = {
        "version": SEGMENT_FORMAT_VERSION,
        "shard": shard,
        "accounts": accounts,
        "history": history,
    }
    write_atomic(path, doc)
    return len(json.dumps(doc))


def read_segment(path: str) -> dict:
    """Load one segment; raises on version mismatch or corruption — a
    torn segment must never silently load as an empty shard."""
    with open(path) as fp:
        doc = json.load(fp)
    if doc.get("version") != SEGMENT_FORMAT_VERSION:
        raise ValueError(
            f"unsupported segment version in {path}: {doc.get('version')}"
        )
    return doc

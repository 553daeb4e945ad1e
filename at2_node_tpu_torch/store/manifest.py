"""The manifest: single atomic commit point of the sharded store.

Counterpart of ``at2_node_tpu/store/manifest.py``.

``MANIFEST.json`` is written with the fsync'd-rename discipline
(ledger/checkpoint.py ``write_atomic``), so at every instant the store
directory contains exactly one committed state: the generation of
segment files + WAL file the manifest references, plus the small state
that rides inside the manifest itself:

* ``directory``   — client-directory export rows (round-trip)
* ``recent``      — the last-10 transactions ring
* ``watermarks``  — per-origin last-attested sequences for BOTH
  broadcast planes (``tx``: sender_hex -> max echoed/ready sequence;
  ``batch``: origin_hex -> max attested batch_seq). Restored as signing
  FLOORS after a crash: the node refuses to re-attest any slot at or
  below its pre-crash watermark, so it can never sign a conflicting
  echo for a slot it already attested (the no-post-restart-equivocation
  discipline; TEE-BFT precedent, arXiv:2102.01970).
* ``distill_seen`` — the broker-ingress cross-frame dedup window
  (node/service.py ``_distill_seen``), so a crashed node cannot be
  replayed into re-admitting distilled entries it already forwarded.
* ``epoch``       — the membership epoch (node/membership.py).

Files not referenced by the committed manifest are orphans (a crash
between segment writes and the manifest rename leaves some); they are
swept opportunistically after each successful flush and at load.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from ..ledger.checkpoint import write_atomic

MANIFEST_NAME = "MANIFEST.json"
STORE_FORMAT_VERSION = 1


def empty_manifest() -> dict:
    return {
        "version": STORE_FORMAT_VERSION,
        "gen": 0,
        "epoch": 0,
        "segments": {},  # shard (str) -> segment filename
        "wal": "",
        "directory": [],
        "recent": [],
        "watermarks": {"tx": {}, "batch": {}},
        "distill_seen": [],
        "audit": {},
        "finality": {},  # certificate chain tail (finality/certs.py)
        "accounts_total": 0,
    }


def write_manifest(store_dir: str, doc: dict) -> None:
    write_atomic(os.path.join(store_dir, MANIFEST_NAME), doc)


def read_manifest(store_dir: str) -> Optional[dict]:
    """The committed manifest, or None when the store is uninitialized.
    A corrupt manifest raises — silently restarting from genesis after
    state loss would violate the sequence contract with the network."""
    try:
        with open(os.path.join(store_dir, MANIFEST_NAME)) as fp:
            doc = json.load(fp)
    except FileNotFoundError:
        return None
    if doc.get("version") != STORE_FORMAT_VERSION:
        raise ValueError(
            f"unsupported store manifest version: {doc.get('version')}"
        )
    return doc


def referenced_files(doc: dict) -> set:
    refs = set(doc.get("segments", {}).values())
    if doc.get("wal"):
        refs.add(doc["wal"])
    refs.add(MANIFEST_NAME)
    return refs


def sweep_orphans(store_dir: str, doc: dict) -> int:
    """Unlink store files the committed manifest does not reference
    (crash leftovers and superseded generations). Tmp files from an
    in-flight atomic write are covered too — their random mkstemp names
    are never referenced. Returns the number removed."""
    refs = referenced_files(doc)
    removed = 0
    try:
        names = os.listdir(store_dir)
    except FileNotFoundError:
        return 0
    for name in names:
        if name in refs:
            continue
        if not (
            name.startswith(("seg-", "wal-", ".ckpt-"))
        ):
            continue  # never touch files the store didn't create
        try:
            os.unlink(os.path.join(store_dir, name))
            removed += 1
        except OSError:
            pass
    return removed

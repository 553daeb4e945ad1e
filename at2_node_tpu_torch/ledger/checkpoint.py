"""Ledger checkpoint/resume: periodic atomic snapshots of node state.

Counterpart of ``at2_node_tpu/ledger/checkpoint.py``.

The reference keeps ALL state in RAM and lists "store state on disk to
restart after crash" as an open roadmap item
(`at2-node/README.md:52`); this build implements it. A checkpoint
is one JSON document holding the accounts map and the recent-transactions
ring, written atomically (tmp + rename on the same filesystem) so a crash
mid-write can never leave a torn file.

Scope: the checkpoint restores LEDGER state (balances, per-sender
sequences, the last-10 ring). Broadcast-layer state (in-flight slots,
Echo/Ready votes) is deliberately NOT persisted — it is rebuilt from the
network: peers re-gossip undelivered payloads and the content-pull
catch-up (`broadcast.stack._request_content`) recovers anything this node
missed while down. Re-delivered already-committed transfers are rejected
by the per-account sequence gate (`ledger.account.Account.debit`), so a
restart cannot double-apply.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import tempfile

logger = logging.getLogger(__name__)

FORMAT_VERSION = 1


async def snapshot(accounts, recent, directory=None) -> dict:
    """Collect a consistent point-in-time snapshot of the ledger actors.

    ``directory`` (node/directory.py ClientDirectory) rides along when the
    node runs the broker ingress tier: the id -> pubkey mappings this node
    assigned or learned survive restarts, so registered clients keep their
    ids without re-registering. The key is optional — checkpoints written
    before the directory existed (or by directory-less configs) load fine.
    """
    doc = {
        "version": FORMAT_VERSION,
        "accounts": await accounts.export_state(),
        "recent": await recent.export_state(),
    }
    if directory is not None:
        doc["directory"] = directory.export()
    return doc


def write_atomic(path: str, doc: dict) -> None:
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".ckpt-")
    try:
        with os.fdopen(fd, "w") as fp:
            json.dump(doc, fp)
            fp.flush()
            os.fsync(fp.fileno())
        os.replace(tmp, path)
        # fsync the containing directory too: the rename itself must be
        # durable, or a crash can leave the old (or no) checkpoint after
        # the caller was told the save completed
        try:
            dfd = os.open(directory, os.O_RDONLY)
        except OSError:
            pass  # platform/filesystem without directory fds
        else:
            try:
                os.fsync(dfd)
            except OSError:
                pass
            finally:
                os.close(dfd)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


async def save(path: str, accounts, recent, directory=None) -> None:
    doc = await snapshot(accounts, recent, directory)
    # serialization + fsync off the event loop: a large ledger must not
    # stall delivery/RPC handling for the duration of a snapshot
    await asyncio.to_thread(write_atomic, path, doc)


async def load(path: str, accounts, recent, directory=None) -> bool:
    """Restore actors from ``path``; returns False when no checkpoint
    exists (fresh start). A corrupt file raises — silently starting from
    genesis after state loss would violate the sequence contract with the
    rest of the network."""
    try:
        with open(path) as fp:
            doc = json.load(fp)
    except FileNotFoundError:
        return False
    if doc.get("version") != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version: {doc.get('version')}")
    await accounts.import_state(doc["accounts"])
    await recent.import_state(doc["recent"])
    if directory is not None:
        directory.import_(doc.get("directory", ()))
    logger.info("restored checkpoint %s (%d accounts)", path, len(doc["accounts"]))
    return True

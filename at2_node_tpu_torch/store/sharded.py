"""ShardedStore: the durable-ledger facade the node talks to.

Counterpart of ``at2_node_tpu/store/sharded.py``.

Holds an in-memory mirror of the on-disk state (per-shard account maps
+ per-shard committed-history bodies), updated record-by-record from
the commit path and flushed incrementally:

* ``note_commit`` appends one WAL record (wal.py) and folds it into the
  mirror, marking the sender's and recipient's shards dirty;
* ``note_parked`` / ``note_unparked`` track payloads the broadcast
  DELIVERED that still wait at the ledger's sequence gate. These must
  survive a crash: delivered slots are never retransmitted, and the
  quorum-confirmed catchup path can only refill them while enough
  full-history peers are alive — a restarted node re-enqueues the
  parked set instead (``iter_parked``);
* ``flush`` writes ONLY dirty shards as new generation-stamped segment
  files, rotates the WAL, and commits everything with one atomic
  manifest rename — cost proportional to the delta since the last
  flush, not to account count;
* ``ShardedStore.open`` recovers: read manifest -> load referenced
  segments -> replay the WAL's intact prefix -> sweep orphans. Every
  crash point between those steps lands on the previous committed
  generation (the store tests walk the failpoints).

``failpoint`` is the crash-injection seam: when set, it is called with
a label at each durability step and may raise :class:`InjectedCrash`
to abort mid-flush exactly where a power cut would.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Callable, Dict, List, Optional

from ..broadcast.messages import Payload
from .manifest import (
    MANIFEST_NAME,  # noqa: F401  (re-exported for tests)
    empty_manifest,
    read_manifest,
    sweep_orphans,
    write_manifest,
)
from .segments import (
    DEFAULT_SHARDS,
    read_segment,
    segment_name,
    shard_of,
    write_segment,
)
from .wal import WalRecord, WriteAheadLog, replay, wal_name

DEFAULT_HISTORY_CAP = 1 << 17  # matches CatchupConfig.history_cap
# Parked payloads beyond this are dropped oldest-first: a slot parked
# this long past the gate has timed out of the heap anyway, and losing
# a parked record only costs the restart shortcut, never ledger state.
PARKED_CAP = 8192


class InjectedCrash(BaseException):
    """Raised by test failpoints to abort a durability step mid-flight.
    Derives from BaseException so no internal handler can swallow it."""


class ShardedStore:
    def __init__(
        self,
        store_dir: str,
        *,
        n_shards: int = DEFAULT_SHARDS,
        sync: str = "buffered",
        history_cap: int = DEFAULT_HISTORY_CAP,
    ) -> None:
        self.dir = store_dir
        self.n_shards = n_shards
        self.sync = sync
        self.history_cap = history_cap
        self.failpoint: Optional[Callable[[str], None]] = None

        self._acc: List[Dict[str, list]] = [{} for _ in range(n_shards)]
        self._hist: List[Dict[str, List[str]]] = [{} for _ in range(n_shards)]
        self._hist_order: deque = deque()  # (shard, sender_hex) FIFO
        self._hist_count = 0
        self._dirty: set = set()
        self._meta_dirty = False
        # delivered-but-uncommitted payload bodies, insertion-ordered
        # (dict-as-ordered-set); carried in the manifest across WAL
        # rotations, pruned by commit/unpark records
        self._parked: Dict[str, None] = {}

        self.gen = 0
        self.epoch = 0
        self.directory_rows: list = []
        self.recent_rows: list = []
        self.watermarks: dict = {"tx": {}, "batch": {}}
        self.distill_seen: list = []
        # fleet-audit chain persistence (obs/audit.py export/restore):
        # {"chain": hex, "commits": int} — restart tamper evidence
        self.audit: dict = {}
        # finality certificate-chain persistence (finality/certs.py
        # export/restore): the assembled chain tail + equivocation latch
        self.finality: dict = {}
        self.wal_replayed = 0  # records replayed by the last open()
        self.segments_loaded = 0  # segments read by the last open()
        self.migrated = False  # open() imported a legacy checkpoint

        self._segments: Dict[str, str] = {}  # shard str -> filename
        self._wal: Optional[WriteAheadLog] = None

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def open(
        cls,
        store_dir: str,
        *,
        n_shards: int = DEFAULT_SHARDS,
        sync: str = "buffered",
        history_cap: int = DEFAULT_HISTORY_CAP,
        legacy_checkpoint: Optional[dict] = None,
        on_segment: Optional[Callable[[int, int], None]] = None,
        on_wal_record: Optional[Callable[[int], None]] = None,
    ) -> "ShardedStore":
        """Recover (or initialize) a store at ``store_dir``.

        ``legacy_checkpoint``: a parsed monolithic checkpoint document
        (ledger/checkpoint.py format) used to seed an UNINITIALIZED
        store — the one-shot migration path for nodes upgrading from
        the full-snapshot format. Ignored once a manifest exists.
        ``on_segment(loaded, total)`` / ``on_wal_record(count)`` are the
        recovery-progress hooks (recovery.py)."""
        os.makedirs(store_dir, exist_ok=True)
        store = cls(
            store_dir,
            n_shards=n_shards,
            sync=sync,
            history_cap=history_cap,
        )
        doc = read_manifest(store_dir)
        if doc is None:
            doc = empty_manifest()
            if legacy_checkpoint is not None:
                store._migrate_monolithic(legacy_checkpoint)
                store.migrated = True
            # commit generation 0 so the directory is a valid store from
            # here on (and the WAL filename exists to reference)
            store._segments = {}
            store.gen = 0
            wal_file = wal_name(0)
            store._wal = WriteAheadLog(
                os.path.join(store_dir, wal_file), sync=sync
            )
            if store.migrated:
                # a migration flush writes every populated shard once;
                # afterwards the store is incremental like any other
                store._meta_dirty = True
                store.flush()
            else:
                write_manifest(store_dir, store._manifest_doc(wal_file))
            return store

        store.gen = doc["gen"]
        store.epoch = doc.get("epoch", 0)
        store.directory_rows = doc.get("directory", [])
        store.recent_rows = doc.get("recent", [])
        store.watermarks = doc.get("watermarks", {"tx": {}, "batch": {}})
        store.distill_seen = doc.get("distill_seen", [])
        store.audit = doc.get("audit", {})
        store.finality = doc.get("finality", {})
        store._parked = dict.fromkeys(doc.get("parked", []))
        store._segments = dict(doc.get("segments", {}))

        total = len(store._segments)
        for shard_s, fname in sorted(
            store._segments.items(), key=lambda kv: int(kv[0])
        ):
            seg = read_segment(os.path.join(store_dir, fname))
            shard = int(shard_s)
            store._acc[shard] = dict(seg.get("accounts", {}))
            hist = {
                sender: list(bodies)
                for sender, bodies in seg.get("history", {}).items()
            }
            store._hist[shard] = hist
            for sender, bodies in hist.items():
                for _ in bodies:
                    store._hist_order.append((shard, sender))
                    store._hist_count += 1
            store.segments_loaded += 1
            if on_segment is not None:
                on_segment(store.segments_loaded, total)

        wal_file = doc.get("wal") or wal_name(store.gen)
        wal_path = os.path.join(store_dir, wal_file)
        for record in replay(wal_path):
            store._fold(record, mark_dirty=True)
            store.wal_replayed += 1
            if on_wal_record is not None:
                on_wal_record(store.wal_replayed)
        # keep appending to the same WAL: its records are folded into
        # the mirror and replay is idempotent, so a second crash before
        # the next flush still recovers exactly
        store._wal = WriteAheadLog(wal_path, sync=sync)
        store._wal.records = store.wal_replayed
        sweep_orphans(store_dir, doc)
        return store

    def close(self) -> None:
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    # -- commit path -------------------------------------------------------

    def note_commit(
        self,
        payload: Payload,
        sender_seq: int,
        sender_balance: int,
        recipient_balance: Optional[int],
        in_history: bool = True,
    ) -> None:
        """Record one committed slot: WAL append first (durability),
        then fold into the mirror. Balances are the POST-commit values
        captured inside the ledger's exclusive section."""
        record = WalRecord(
            body_hex=payload.encode()[1:].hex(),
            sender_seq=sender_seq,
            sender_balance=sender_balance,
            recipient_balance=recipient_balance,
            in_history=in_history,
        )
        self._fp("wal:pre_append")
        self._wal.append(record)
        self._fp("wal:post_append")
        self._fold(record, mark_dirty=True)

    def note_parked(self, payload: Payload) -> None:
        """Record a payload the broadcast delivered that is waiting at
        the sequence gate (WAL append, then the in-memory set). A later
        ``note_commit`` for the same payload prunes it."""
        body_hex = payload.encode()[1:].hex()
        if body_hex in self._parked:
            return
        record = WalRecord.parked(body_hex)
        self._fp("wal:pre_append")
        self._wal.append(record)
        self._fp("wal:post_append")
        self._fold(record, mark_dirty=False)

    def note_unparked(self, payload: Payload) -> None:
        """The gate gave up on a parked payload (timeout sweep)."""
        body_hex = payload.encode()[1:].hex()
        if body_hex not in self._parked:
            return
        record = WalRecord.unparked(body_hex)
        self._wal.append(record)
        self._fold(record, mark_dirty=False)

    def set_meta(
        self,
        *,
        directory_rows: Optional[list] = None,
        recent_rows: Optional[list] = None,
        watermarks: Optional[dict] = None,
        distill_seen: Optional[list] = None,
        epoch: Optional[int] = None,
        audit: Optional[dict] = None,
        finality: Optional[dict] = None,
    ) -> None:
        """Refresh the small state the manifest carries (called by the
        service right before a flush)."""
        if directory_rows is not None:
            self.directory_rows = directory_rows
        if recent_rows is not None:
            self.recent_rows = recent_rows
        if watermarks is not None:
            self.watermarks = watermarks
        if distill_seen is not None:
            self.distill_seen = distill_seen
        if epoch is not None:
            self.epoch = epoch
        if audit is not None:
            self.audit = audit
        if finality is not None:
            self.finality = finality
        self._meta_dirty = True

    def flush(self, force: bool = False) -> Optional[dict]:
        """Write dirty shards as generation ``gen+1`` segments, rotate
        the WAL, commit with one manifest rename, sweep orphans.
        Returns flush stats, or None when nothing changed (and not
        ``force``)."""
        if not (self._dirty or self._meta_dirty or force):
            return None
        new_gen = self.gen + 1
        segments = dict(self._segments)  # clean shards carry forward
        written = 0
        written_bytes = 0
        self._fp("flush:pre_segments")
        for shard in sorted(self._dirty):
            fname = segment_name(new_gen, shard)
            written_bytes += write_segment(
                os.path.join(self.dir, fname),
                shard,
                self._acc[shard],
                self._hist[shard],
            )
            segments[str(shard)] = fname
            written += 1
            self._fp(f"flush:post_segment:{written}")
        self._fp("flush:post_segments")
        # the WAL rotates with the manifest: the new generation's log
        # starts empty because its records are now inside the segments
        wal_file = wal_name(new_gen)
        new_wal = WriteAheadLog(os.path.join(self.dir, wal_file), sync=self.sync)
        folded = self._wal.records if self._wal is not None else 0
        try:
            self._fp("flush:pre_manifest")
            write_manifest(
                self.dir,
                self._manifest_doc(wal_file, gen=new_gen, segments=segments),
            )
            self._fp("flush:post_manifest")
        except BaseException:
            new_wal.close()  # a crashed flush must not leak the new log fd
            raise
        # the manifest rename is the commit point: only after it may the
        # old generation's files be dropped
        if self._wal is not None:
            self._wal.close()
        self._wal = new_wal
        self.gen = new_gen
        self._segments = segments
        self._dirty.clear()
        self._meta_dirty = False
        sweep_orphans(self.dir, self._manifest_doc(wal_file))
        return {
            "gen": new_gen,
            "segments_written": written,
            "segment_bytes": written_bytes,
            "wal_records_folded": folded,
        }

    # -- views -------------------------------------------------------------

    def accounts_state(self) -> Dict[str, list]:
        """Full ledger map in Accounts.import_state form."""
        merged: Dict[str, list] = {}
        for shard in self._acc:
            merged.update(shard)
        return merged

    def account_count(self) -> int:
        return sum(len(shard) for shard in self._acc)

    def iter_history(self):
        """Committed payloads, per sender in sequence order (the form
        CommittedHistory.record re-ingests at restart)."""
        for shard in self._hist:
            for bodies in shard.values():
                for body_hex in bodies:
                    yield Payload.decode_body(bytes.fromhex(body_hex))

    def history_count(self) -> int:
        return self._hist_count

    def iter_parked(self):
        """Delivered-but-uncommitted payloads, oldest first (the restart
        path re-enqueues these at the sequence gate)."""
        for body_hex in self._parked:
            yield Payload.decode_body(bytes.fromhex(body_hex))

    def parked_count(self) -> int:
        return len(self._parked)

    # -- internals ---------------------------------------------------------

    def _fp(self, label: str) -> None:
        if self.failpoint is not None:
            self.failpoint(label)

    def _manifest_doc(
        self,
        wal_file: str,
        gen: Optional[int] = None,
        segments: Optional[Dict[str, str]] = None,
    ) -> dict:
        return {
            "version": 1,
            "gen": self.gen if gen is None else gen,
            "epoch": self.epoch,
            "segments": dict(
                self._segments if segments is None else segments
            ),
            "wal": wal_file,
            "directory": self.directory_rows,
            "recent": self.recent_rows,
            "watermarks": self.watermarks,
            "distill_seen": self.distill_seen,
            "audit": self.audit,
            "finality": self.finality,
            "parked": list(self._parked),
            "accounts_total": self.account_count(),
        }

    def _fold(self, record: WalRecord, mark_dirty: bool) -> None:
        if record.kind == "p":
            self._parked[record.body_hex] = None
            while len(self._parked) > PARKED_CAP:
                self._parked.pop(next(iter(self._parked)))
            self._meta_dirty = True
            return
        if record.kind == "u":
            if self._parked.pop(record.body_hex, None) is not None:
                self._meta_dirty = True
            return
        if self._parked.pop(record.body_hex, None) is not None:
            self._meta_dirty = True  # committed: no longer parked
        payload = Payload.decode_body(bytes.fromhex(record.body_hex))
        sender_hex = payload.sender.hex()
        s_shard = shard_of(payload.sender, self.n_shards)
        self._acc[s_shard][sender_hex] = [
            record.sender_seq,
            record.sender_balance,
        ]
        if mark_dirty:
            self._dirty.add(s_shard)
        if record.recipient_balance is not None:
            recipient = payload.transaction.recipient
            r_shard = shard_of(recipient, self.n_shards)
            r_hex = recipient.hex()
            prev = self._acc[r_shard].get(r_hex)
            self._acc[r_shard][r_hex] = [
                prev[0] if prev else 0,
                record.recipient_balance,
            ]
            if mark_dirty:
                self._dirty.add(r_shard)
        if record.in_history:
            bodies = self._hist[s_shard].setdefault(sender_hex, [])
            if record.body_hex not in bodies[-2:]:  # replay idempotence
                bodies.append(record.body_hex)
                self._hist_order.append((s_shard, sender_hex))
                self._hist_count += 1
                self._evict_history()

    def _evict_history(self) -> None:
        while self._hist_count > self.history_cap and self._hist_order:
            shard, sender = self._hist_order.popleft()
            bodies = self._hist[shard].get(sender)
            if bodies:
                bodies.pop(0)
                if not bodies:
                    del self._hist[shard][sender]
                self._dirty.add(shard)
            self._hist_count -= 1

    def _migrate_monolithic(self, doc: dict) -> None:
        """Seed the mirror from a legacy full-snapshot checkpoint
        (ledger/checkpoint.py FORMAT_VERSION 1). Legacy checkpoints
        carry no committed history — the catchup plane refills it from
        peers, exactly as a legacy restart always has."""
        if doc.get("version") != 1:
            raise ValueError(
                f"unsupported legacy checkpoint version: {doc.get('version')}"
            )
        for user_hex, (seq, bal) in doc.get("accounts", {}).items():
            shard = shard_of(bytes.fromhex(user_hex), self.n_shards)
            self._acc[shard][user_hex] = [seq, bal]
            self._dirty.add(shard)
        self.recent_rows = doc.get("recent", [])
        self.directory_rows = doc.get("directory", [])

"""Write-ahead delta log of committed slots.

Counterpart of ``at2_node_tpu/store/wal.py``.

One checksummed JSON line per committed (sender, sequence) slot,
appended by the commit path (node/service.py ``_commit_tail``) between
flushes. The line format is::

    crc32_hex<space>json_body\\n

and the body carries everything replay needs to reproduce the exact
post-commit state without re-running transfer semantics:

* ``b``  — the 140-byte payload body, hex (slot identity + client sig)
* ``ss`` — the sender's last_sequence AFTER this commit
* ``sb`` — the sender's balance AFTER this commit
* ``rb`` — the recipient's balance AFTER this commit (absent for
  failed/self transfers where no credit happened)
* ``h``  — 1 when the slot entered committed history (successful and
  failed transfers both do; see service.py), 0 otherwise
* ``k``  — record kind: ``"c"`` commit (default, may be absent),
  ``"p"`` parked (a payload DELIVERED by the broadcast but still
  waiting at the ledger's sequence gate — losing these at a crash
  would strand the node: delivered slots are never retransmitted and
  catchup can only confirm them while enough full-history peers are
  alive), ``"u"`` unparked (the gate timed the payload out). Parked
  records carry only ``b``; replay re-enqueues the survivors.

Balances are captured at transfer time inside the ledger's exclusive
section, so replaying a *prefix* of the log (the only thing a crash can
leave) always lands on a state the node actually passed through.

A torn tail — a partial last line, or a line whose checksum does not
match — terminates replay at the last good record; everything before it
is intact by construction (appends are sequential). ``sync="always"``
fsyncs every append (sim/tests: deterministic, cheap under the inline
executor); ``"buffered"`` leaves appends in the OS page cache and makes
them durable at the next flush's fsync — the documented residual window
(TECHNICAL.md "Durability & membership").
"""

from __future__ import annotations

import json
import os
import zlib
from dataclasses import dataclass
from typing import Iterator, Optional


def wal_name(gen: int) -> str:
    return f"wal-{gen:08d}.log"


@dataclass(frozen=True)
class WalRecord:
    """One committed slot's delta (see module docstring for fields)."""

    body_hex: str
    sender_seq: int
    sender_balance: int
    recipient_balance: Optional[int]
    in_history: bool
    kind: str = "c"  # "c" commit | "p" parked | "u" unparked

    @staticmethod
    def parked(body_hex: str) -> "WalRecord":
        return WalRecord(body_hex, 0, 0, None, False, kind="p")

    @staticmethod
    def unparked(body_hex: str) -> "WalRecord":
        return WalRecord(body_hex, 0, 0, None, False, kind="u")

    def to_json(self) -> str:
        if self.kind != "c":
            return json.dumps(
                {"b": self.body_hex, "k": self.kind},
                separators=(",", ":"),
                sort_keys=True,
            )
        doc = {
            "b": self.body_hex,
            "ss": self.sender_seq,
            "sb": self.sender_balance,
            "h": 1 if self.in_history else 0,
        }
        if self.recipient_balance is not None:
            doc["rb"] = self.recipient_balance
        return json.dumps(doc, separators=(",", ":"), sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "WalRecord":
        doc = json.loads(text)
        kind = doc.get("k", "c")
        if kind != "c":
            return WalRecord(doc["b"], 0, 0, None, False, kind=kind)
        return WalRecord(
            body_hex=doc["b"],
            sender_seq=doc["ss"],
            sender_balance=doc["sb"],
            recipient_balance=doc.get("rb"),
            in_history=bool(doc.get("h", 1)),
        )


def encode_line(record: WalRecord) -> bytes:
    body = record.to_json()
    crc = zlib.crc32(body.encode()) & 0xFFFFFFFF
    return f"{crc:08x} {body}\n".encode()


class WriteAheadLog:
    """Append-only log handle for the current generation's WAL file."""

    def __init__(self, path: str, *, sync: str = "buffered") -> None:
        self.path = path
        self.sync = sync
        self.records = 0
        # O_APPEND + explicit open so the file exists (and survives an
        # empty interval) from the moment the manifest references it
        self._fd = os.open(
            path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
        )

    def append(self, record: WalRecord) -> None:
        os.write(self._fd, encode_line(record))
        self.records += 1
        if self.sync == "always":
            os.fsync(self._fd)

    def fsync(self) -> None:
        os.fsync(self._fd)

    def close(self) -> None:
        if self._fd >= 0:
            try:
                os.fsync(self._fd)
            except OSError:
                pass
            os.close(self._fd)
            self._fd = -1


def replay(path: str) -> Iterator[WalRecord]:
    """Yield intact records in append order, stopping (silently) at the
    first torn or checksum-failing line — the crash-truncation contract.
    A missing file replays as empty (manifest committed, first append
    never happened)."""
    try:
        with open(path, "rb") as fp:
            raw = fp.read()
    except FileNotFoundError:
        return
    for line in raw.split(b"\n"):
        if not line:
            continue
        head, sep, body = line.partition(b" ")
        if not sep or len(head) != 8:
            return  # torn tail
        try:
            want = int(head, 16)
        except ValueError:
            return
        if zlib.crc32(body) & 0xFFFFFFFF != want:
            return  # torn or bit-rotted tail
        try:
            yield WalRecord.from_json(body.decode())
        except (ValueError, KeyError):
            return

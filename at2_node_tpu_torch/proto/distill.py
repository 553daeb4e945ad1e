"""Distilled transaction-batch wire format (the broker ingress frame).

Counterpart of ``at2_node_tpu/proto/distill.py``.

Chop Chop's distillation insight (arXiv:2304.07081) applied to the AT2
ingress plane: once a client has registered its pubkey in the client
directory, a steady-state transfer no longer needs to carry the 32-byte
key through the RPC plane — a varint client-id is enough, and a broker
that collects many clients' transfers can strip all per-entry framing:

    frame := magic(1) version(1)
             varint n_groups
             varint n_entries                  (redundant, cross-checked)
             group*                            (sender ids strictly increasing)
             sig_block                         (n_entries x 64 bytes, columnar)

    group := varint id_delta                   (first group: the id itself;
                                                later groups: id - prev_id >= 1)
             varint n                          (entries in group, >= 1)
             entry*                            (seqs strictly increasing)

    entry := varint seq_delta                  (first entry: the seq itself,
                                                >= 1; later: seq - prev >= 1)
             varint rtag                       (0: raw 32-byte recipient key
                                                follows; k>=1: directory id k-1)
             [recipient_key(32) when rtag==0]
             varint amount

Sorted strictly-increasing deltas make within-batch duplicate
(sender, seq) pairs *unrepresentable*, so a byzantine broker cannot even
encode a duplicated entry inside one frame (cross-frame duplication is
caught by the node's dedup window, counted as ``dedup_drops``).
Signatures live in one columnar trailing block so the variable-length
head parses without touching them; each signature is the client's
ed25519 over the SAME canonical bytes the per-tx path signs — the v2
tagged transfer form (types.py ``transfer_signing_bytes``), which binds
sender AND sequence into the preimage. That binding is what keeps the
broker untrusted: it can censor or reorder, but it cannot re-encode a
captured signature at a fresh sequence (the preimage changes), so it
never forges — not even by replay.

This module is the pure-Python reference codec; ``native/at2_ingest.cpp``
carries the GIL-released bulk parse (`at2_distill_parse`) that the node
uses when the ingest library is available. The two are differential-
tested against each other in ``tests/test_distill.py``.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, Iterable, List, Optional, Sequence, Tuple, Union

MAGIC = 0xD5
VERSION = 0x01

# Hard cap on entries per distilled frame. Four full TxBatch slots: the
# node re-chunks at `batching.max_entries` anyway, and the cap bounds
# the work a single hostile RPC can demand before signature checks.
DISTILL_MAX_ENTRIES = 4096

ENTRY_WIRE = 140  # expanded body: sender(32) seq(4) recipient(32) amount(8) sig(64)
SIG_WIRE = 64

_BODY = struct.Struct("<32sI32sQ64s")

_U64_MAX = (1 << 64) - 1
_U32_MAX = (1 << 32) - 1


class DistillError(ValueError):
    """Malformed distilled frame (bounds, ordering, or count violations)."""


@dataclass(frozen=True)
class DistilledEntry:
    """One transfer inside a distilled frame.

    ``recipient`` is either an ``int`` directory id or a raw 32-byte
    pubkey (``bytes``) for recipients that never registered —
    directory-less clients stay first-class on both sides of a transfer.
    """

    sender_id: int
    sequence: int
    recipient: Union[int, bytes]
    amount: int
    signature: bytes


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0 or value > _U64_MAX:
        raise DistillError(f"varint out of range: {value}")
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(buf: bytes, off: int) -> Tuple[int, int]:
    """Decode one LEB128 varint at ``off``; returns (value, new_off)."""
    result = 0
    shift = 0
    for _ in range(10):  # 10 * 7 = 70 bits covers u64
        if off >= len(buf):
            raise DistillError("truncated varint")
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            if result > _U64_MAX:
                raise DistillError("varint exceeds u64")
            return result, off
        shift += 7
    raise DistillError("varint longer than 10 bytes")


def encode(entries: Sequence[DistilledEntry]) -> bytes:
    """Encode entries (already sorted by (sender_id, sequence), strictly
    increasing — :func:`distill` produces that order) into one frame."""
    if not entries:
        raise DistillError("empty distilled frame")
    if len(entries) > DISTILL_MAX_ENTRIES:
        raise DistillError(f"too many entries: {len(entries)}")

    head = bytearray([MAGIC, VERSION])
    groups: List[List[DistilledEntry]] = []
    for e in entries:
        if groups and groups[-1][0].sender_id == e.sender_id:
            groups[-1].append(e)
        else:
            groups.append([e])

    _write_varint(head, len(groups))
    _write_varint(head, len(entries))
    sigs = bytearray()
    prev_id = None
    for group in groups:
        gid = group[0].sender_id
        if prev_id is not None and gid <= prev_id:
            raise DistillError("sender ids not strictly increasing")
        _write_varint(head, gid if prev_id is None else gid - prev_id)
        prev_id = gid
        _write_varint(head, len(group))
        prev_seq = 0
        for e in group:
            if e.sequence <= prev_seq or e.sequence > _U32_MAX:
                raise DistillError("sequences not strictly increasing u32")
            _write_varint(head, e.sequence - prev_seq)
            prev_seq = e.sequence
            if isinstance(e.recipient, int):
                _write_varint(head, e.recipient + 1)
            else:
                if len(e.recipient) != 32:
                    raise DistillError("raw recipient must be 32 bytes")
                _write_varint(head, 0)
                head += e.recipient
            _write_varint(head, e.amount)
            if len(e.signature) != SIG_WIRE:
                raise DistillError("signature must be 64 bytes")
            sigs += e.signature
    return bytes(head + sigs)


def decode(frame: bytes) -> List[DistilledEntry]:
    """Strict decode; raises :class:`DistillError` on any malformation
    (bad magic, non-increasing ids/seqs, count mismatch, trailing bytes)."""
    if len(frame) < 4:
        raise DistillError("frame too short")
    if frame[0] != MAGIC or frame[1] != VERSION:
        raise DistillError("bad magic/version")
    off = 2
    n_groups, off = _read_varint(frame, off)
    n_entries, off = _read_varint(frame, off)
    if n_groups == 0 or n_entries == 0:
        raise DistillError("empty distilled frame")
    if n_entries > DISTILL_MAX_ENTRIES or n_groups > n_entries:
        raise DistillError("entry/group count out of bounds")
    sig_len = n_entries * SIG_WIRE
    if len(frame) < off + sig_len:
        raise DistillError("frame shorter than signature block")
    sig_start = len(frame) - sig_len

    out: List[DistilledEntry] = []
    prev_id = None
    for _ in range(n_groups):
        delta, off = _read_varint(frame, off)
        if prev_id is None:
            gid = delta
        else:
            if delta == 0:
                raise DistillError("sender ids not strictly increasing")
            gid = prev_id + delta
            if gid > _U64_MAX:
                raise DistillError("sender id exceeds u64")
        prev_id = gid
        n, off = _read_varint(frame, off)
        if n == 0 or len(out) + n > n_entries:
            raise DistillError("group count out of bounds")
        prev_seq = 0
        for _ in range(n):
            sd, off = _read_varint(frame, off)
            if sd == 0:
                raise DistillError("sequences not strictly increasing")
            seq = prev_seq + sd
            if seq > _U32_MAX:
                raise DistillError("sequence exceeds u32")
            prev_seq = seq
            rtag, off = _read_varint(frame, off)
            recipient: Union[int, bytes]
            if rtag == 0:
                if off + 32 > sig_start:
                    raise DistillError("truncated raw recipient")
                recipient = frame[off : off + 32]
                off += 32
            else:
                recipient = rtag - 1
            amount, off = _read_varint(frame, off)
            if off > sig_start:
                raise DistillError("head overruns signature block")
            sig = frame[sig_start + len(out) * SIG_WIRE :][:SIG_WIRE]
            out.append(DistilledEntry(gid, seq, recipient, amount, sig))
    if len(out) != n_entries:
        raise DistillError("entry count mismatch")
    if off != sig_start:
        raise DistillError("trailing bytes between head and signatures")
    return out


def distill(
    entries: Iterable[DistilledEntry],
) -> Tuple[bytes, int]:
    """Broker-side build: sort by (sender_id, sequence), drop exact
    duplicate (sender_id, sequence) pairs (first submission wins), and
    encode. Returns ``(frame, n_duplicates_dropped)``."""
    ordered = sorted(entries, key=lambda e: (e.sender_id, e.sequence))
    kept: List[DistilledEntry] = []
    dropped = 0
    for e in ordered:
        if kept and kept[-1].sender_id == e.sender_id and kept[-1].sequence == e.sequence:
            dropped += 1
            continue
        kept.append(e)
    return encode(kept), dropped


def expand_py(
    frame: bytes,
    get_key: Callable[[int], Optional[bytes]],
) -> Tuple[bytearray, List[int], List[bool]]:
    """Pure-Python mirror of the native ``at2_distill_parse``: decode the
    frame and expand each entry to its 140-byte canonical body (the exact
    ``Payload.encode()[1:]`` bytes the batched broadcast plane carries).

    ``get_key(client_id)`` resolves a directory id to a 32-byte pubkey or
    ``None``. Returns ``(bodies, sender_ids, ok)`` where ``bodies`` is
    ``n * 140`` bytes; an entry whose sender or recipient id is unknown
    gets ``ok[i] = False`` (its unresolved fields are zeroed) — the
    caller counts those as ``directory_misses`` and drops them.
    """
    entries = decode(frame)
    bodies = bytearray(len(entries) * ENTRY_WIRE)
    ids: List[int] = []
    ok: List[bool] = []
    zero32 = b"\x00" * 32
    for i, e in enumerate(entries):
        sender = get_key(e.sender_id)
        if isinstance(e.recipient, int):
            recipient = get_key(e.recipient)
        else:
            recipient = e.recipient
        good = sender is not None and recipient is not None
        _BODY.pack_into(
            bodies,
            i * ENTRY_WIRE,
            sender if sender is not None else zero32,
            e.sequence,
            recipient if recipient is not None else zero32,
            e.amount,
            e.signature,
        )
        ids.append(e.sender_id)
        ok.append(good)
    return bodies, ids, ok

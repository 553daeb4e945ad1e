"""ctypes bindings for the native message-plane ingest (at2_ingest.cpp).

Counterpart of ``at2_node_tpu/native/ingest.py``. Same build-on-first-use
pattern as ``prep.py`` (shared helpers in ``_build.py``, output in the
port's ``build/``); additionally links the system libcrypto (OpenSSL) for
the bulk ed25519 verify. The C++ source declares its own OpenSSL
prototypes, so only the runtime ``.so`` is needed; on images without it the
build fails cleanly and callers fall back to Python. This is host code,
not a device kernel.

Exports:
* :func:`parse_frames_native` — one C call parses a whole chunk of wire
  frames (kind dispatch + record extraction + payload SHA-256 content
  hashes) and returns the same message objects `parse_frame` would, with
  the content hash pre-seeded so the state machine never re-hashes.
* :func:`verify_bulk_native` — one C call verifies a whole list of
  (pk, msg, sig) items on native threads; verdicts bit-identical with
  `crypto.keys.verify_one` (same libcrypto under both).
* :func:`counts_add_native` / :func:`quorum_mask_native` — the batched
  plane's endorsement tallies.

The source also holds the fused owner drain (``at2_plane_drain``) and the
distilled-frame parser (``at2_distill_parse``); their bindings come with
their consumers (the plane shards and the service).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from ..broadcast.messages import (
    BATCH,
    BATCH_ECHO,
    BATCH_READY,
    BATCH_REQ,
    BEACON,
    CERT_SIG,
    CONFIG_TX,
    DIR_ANNOUNCE,
    ECHO,
    GOSSIP,
    HIST_BATCH,
    HIST_IDX,
    HIST_IDX_REQ,
    HIST_REQ,
    MAX_MSGS_PER_FRAME,
    READY,
    REQUEST,
    _DIR_HDR,
    _HIST_HDR,
    Attestation,
    BatchAttestation,
    BatchContentRequest,
    CertSig,
    ConfigTx,
    ContentRequest,
    DirectoryAnnounce,
    HistoryBatch,
    HistoryIndex,
    HistoryIndexRequest,
    HistoryRequest,
    Payload,
    StateBeacon,
    TxBatch,
)
from ._build import U32P, U64P, U8P, load_gxx_lib, pack_ragged, ptr8

_I32P = ctypes.POINTER(ctypes.c_int32)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

# Preferred OpenSSL soname first, but hosts differ (build VMs still ship
# 1.1): probe each candidate until one links. The C source only uses the
# stable EVP verify API, which is identical across both majors.
_LINK_CANDIDATES = (
    ("-l:libcrypto.so.3",),
    ("-l:libcrypto.so.1.1",),
    ("-lcrypto",),
)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        lib = None
        for link_args in _LINK_CANDIDATES:
            lib = load_gxx_lib(
                ["native/at2_ingest.cpp"], "libat2ingest.so", link_args=link_args
            )
            if lib is not None:
                break
        if lib is None:
            return None
        lib.at2_parse_frames.argtypes = [
            U8P, U64P, ctypes.c_int64, U8P, ctypes.c_int64, U32P, U8P,
        ]
        lib.at2_parse_frames.restype = ctypes.c_int64
        lib.at2_verify_bulk.argtypes = [
            U8P, U64P, U8P, U64P, U8P, U64P,
            ctypes.c_int64, ctypes.c_int64, U8P,
        ]
        lib.at2_verify_bulk.restype = None
        lib.at2_ingest_row_stride.argtypes = []
        lib.at2_ingest_row_stride.restype = ctypes.c_int64
        lib.at2_ingest_min_wire.argtypes = []
        lib.at2_ingest_min_wire.restype = ctypes.c_int64
        lib.at2_counts_add.argtypes = [
            U8P, ctypes.c_int64, _I32P, ctypes.c_int64,
        ]
        lib.at2_counts_add.restype = ctypes.c_int64
        lib.at2_quorum_mask.argtypes = [
            _I32P, ctypes.c_int64, ctypes.c_int32, U8P, ctypes.c_int64,
        ]
        lib.at2_quorum_mask.restype = ctypes.c_int64
        _lib = lib
        return _lib


def ingest_available() -> bool:
    if os.environ.get("AT2_NO_NATIVE_INGEST"):
        return False  # explicit kill-switch (benchmarking / incident triage)
    return _load() is not None


def ingest_ready() -> bool:
    """Non-BUILDING probe for hot paths: True only when the library load
    already completed. `ingest_available` can run the first-use g++
    compile (seconds, synchronous) — that must never happen on an event
    loop inside a live worker chunk; Broadcast.start/warmup pre-build
    off-loop, and anything used without warmup consults this instead and
    kicks the build to a background thread via :func:`kick_ingest_build`."""
    if os.environ.get("AT2_NO_NATIVE_INGEST"):
        return False
    return _lib is not None


_build_kicked = False


def kick_ingest_build() -> None:
    """Start the build/load on a daemon thread if no one has yet, so a
    verifier used without warmup converges to the native path after the
    first few chunks instead of freezing the loop on chunk one."""
    global _build_kicked
    if _build_kicked or _tried:
        return
    _build_kicked = True
    threading.Thread(
        target=ingest_available, daemon=True, name="at2-ingest-build"
    ).start()


def ingest_ready_or_kick() -> bool:
    """THE hot-path probe: True when the native path is usable right now;
    otherwise kicks the background build (once) and returns False so the
    caller takes the Python path this time. Keeps the
    never-build-on-the-event-loop policy in one place."""
    if ingest_ready():
        return True
    kick_ingest_build()
    return False


def parse_frames_native(frames: Sequence[bytes]):
    """Parse many frames in one native call.

    Returns ``(messages, frame_ok)`` where messages is a list of
    ``(frame_index, message_object)`` and ``frame_ok[i]`` says whether
    frame i parsed cleanly (malformed frames are dropped whole, matching
    ``parse_frame``'s WireError behavior)."""
    lib = _load()
    assert lib is not None, "call ingest_available() first"
    flat, offsets = pack_ragged(frames)
    stride = int(lib.at2_ingest_row_stride())
    # Row capacity: size the buffer for the hot-path mix first (nothing on
    # the wire smaller than a ContentRequest, 69 bytes); if a frame turns
    # out to be dense with tiny catchup control messages (min_wire bytes
    # each) the parser returns -1 and we retry once with the true bound —
    # which the per-frame message cap (MAX_MSGS_PER_FRAME, pinned against
    # kMaxMsgsPerFrame by the ingest tests; frames beyond it are
    # malformed and drop whole) keeps proportional to the frame count,
    # not the byte count.
    per_frame_bound = len(frames) * MAX_MSGS_PER_FRAME
    for min_wire in (69, int(lib.at2_ingest_min_wire())):
        cap = min(int(flat.size // min_wire), per_frame_bound) + len(frames) + 1
        rows = np.zeros((cap, stride), dtype=np.uint8)
        msg_frame = np.zeros(cap, dtype=np.uint32)
        frame_ok = np.zeros(len(frames), dtype=np.uint8)
        n = int(
            lib.at2_parse_frames(
                ptr8(flat),
                offsets.ctypes.data_as(U64P),
                len(frames),
                ptr8(rows),
                cap,
                msg_frame.ctypes.data_as(U32P),
                ptr8(frame_ok),
            )
        )
        if n >= 0:
            break
    if n < 0:  # cannot happen given the final bound; survive `python -O`
        raise RuntimeError("native parse overflowed its row capacity")

    out = [
        (frame_idx, msg)
        for _, frame_idx, msg in _build_rows(rows, msg_frame, flat, n, stride)
    ]
    return out, frame_ok.astype(bool)


def _build_rows(rows, msg_frame, flat, n: int, stride: int):
    """Yield ``(row_index, frame_index, message_object)`` for every
    parsed row. Object building reuses the same Struct-based decode_body
    paths the Python parser uses (one C-level unpack per message); the
    native side's contribution is the GIL-released validation pass and
    the payload content hashes (seeded here so nothing re-hashes)."""
    row_bytes = rows[:n].tobytes()
    frame_idx = msg_frame[:n].tolist()
    setattr_ = object.__setattr__
    for i in range(n):
        base = i * stride
        kind = row_bytes[base]
        if kind == GOSSIP:
            msg = Payload.decode_body(row_bytes[base + 1 : base + 141])
            setattr_(msg, "_chash", row_bytes[base + 141 : base + 173])
        elif kind in (ECHO, READY):
            msg = Attestation.decode_body(
                kind, row_bytes[base + 1 : base + 165]
            )
        elif kind == REQUEST:
            msg = ContentRequest.decode_body(row_bytes[base + 1 : base + 69])
        elif kind == HIST_IDX_REQ:
            msg = HistoryIndexRequest.decode_body(row_bytes[base + 1 : base + 9])
        elif kind == HIST_REQ:
            msg = HistoryRequest.decode_body(row_bytes[base + 1 : base + 49])
        elif kind == BATCH_REQ:
            msg = BatchContentRequest.decode_body(row_bytes[base + 1 : base + 73])
        elif kind in (
            HIST_IDX, HIST_BATCH, BATCH, BATCH_ECHO, BATCH_READY,
            DIR_ANNOUNCE, CONFIG_TX, BEACON, CERT_SIG,
        ):
            # variable-length rows carry (offset, length) into `flat`
            # (BEACON/CERT_SIG are fixed-size but wider than the row stride)
            off = int.from_bytes(row_bytes[base + 1 : base + 9], "little")
            ln = int.from_bytes(row_bytes[base + 9 : base + 17], "little")
            body = flat[off : off + ln].tobytes()
            if kind == BATCH:
                msg = TxBatch.decode_body(body)
            elif kind in (BATCH_ECHO, BATCH_READY):
                msg = BatchAttestation.decode_body(kind, body)
            elif kind == CONFIG_TX:
                msg = ConfigTx.decode_body(body)
            elif kind == BEACON:
                msg = StateBeacon.decode_body(body)
            elif kind == CERT_SIG:
                msg = CertSig.decode_body(body)
            elif kind == DIR_ANNOUNCE:
                origin, _count = _DIR_HDR.unpack_from(body)
                msg = DirectoryAnnounce.decode_body(origin, body[_DIR_HDR.size :])
            else:
                nonce, _count = _HIST_HDR.unpack_from(body)
                if kind == HIST_IDX:
                    msg = HistoryIndex.decode_body(nonce, body[_HIST_HDR.size :])
                else:
                    msg = HistoryBatch.decode_body(nonce, body[_HIST_HDR.size :])
        else:  # pragma: no cover - the C side never emits other kinds
            continue
        yield i, frame_idx[i], msg


def verify_bulk_native(
    items: Sequence[Tuple[bytes, bytes, bytes]], n_threads: int = 1
) -> np.ndarray:
    """Verify (public_key, message, signature) items in one native call.
    The GIL is released for the whole call (ctypes), so the event loop
    breathes while OpenSSL grinds; n_threads > 1 fans out on real cores."""
    lib = _load()
    assert lib is not None, "call ingest_available() first"
    n = len(items)
    out = np.zeros(n, dtype=np.uint8)
    if n == 0:
        return out.astype(bool)
    pk_flat, pk_off = pack_ragged([it[0] for it in items])
    msg_flat, msg_off = pack_ragged([it[1] for it in items])
    sig_flat, sig_off = pack_ragged([it[2] for it in items])
    lib.at2_verify_bulk(
        ptr8(pk_flat), pk_off.ctypes.data_as(U64P),
        ptr8(msg_flat), msg_off.ctypes.data_as(U64P),
        ptr8(sig_flat), sig_off.ctypes.data_as(U64P),
        n, n_threads, ptr8(out),
    )
    return out.astype(bool)


def counts_add_native(bitmap: bytes, counts: np.ndarray) -> int:
    """Fold a little-endian endorsement bitmap into an int32 tally array
    (counts[i] += 1 for every set bit i). GIL released for the scan, so
    shard threads applying attestations genuinely overlap. Returns the
    number of bits folded. ``counts`` must be C-contiguous int32 and is
    mutated in place."""
    lib = _load()
    assert lib is not None, "call ingest_available() first"
    assert counts.dtype == np.int32 and counts.flags["C_CONTIGUOUS"]
    buf = np.frombuffer(bitmap, dtype=np.uint8)
    return int(
        lib.at2_counts_add(
            ptr8(buf), len(bitmap),
            counts.ctypes.data_as(_I32P), len(counts),
        )
    )


def quorum_mask_native(counts: np.ndarray, threshold: int, nbits: int) -> int:
    """Little-endian packed quorum bitmap (as a Python int) of tally
    indices with counts[i] >= threshold, over the first ``nbits``
    entries. The GIL-released native twin of broadcast._quorate_mask."""
    lib = _load()
    assert lib is not None, "call ingest_available() first"
    assert counts.dtype == np.int32 and counts.flags["C_CONTIGUOUS"]
    n = min(nbits, len(counts))
    if n <= 0:
        return 0
    out = np.zeros((n + 7) // 8, dtype=np.uint8)
    lib.at2_quorum_mask(
        counts.ctypes.data_as(_I32P), n, threshold, ptr8(out), len(out)
    )
    return int.from_bytes(out.tobytes(), "little")

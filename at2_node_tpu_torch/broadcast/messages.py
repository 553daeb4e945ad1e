"""Wire messages of the three-phase broadcast (gossip / Echo / Ready).

Counterpart of ``at2_node_tpu/broadcast/messages.py``, byte for byte: the
same kinds, the same structs and the same domain-separation tags, so a
node of this package and a node of the reference sign the same bytes and
read each other's frames.

The reference gets these from its murmur/sieve/contagion crates
(`at2-node/technical.md:7-15` [dep-inferred]); here they are
explicit fixed-size binary records so a frame can carry many of them
back-to-back and batches parse with zero framing overhead:

* ``Payload`` — the gossiped unit: one client transfer in its
  (sender, sequence) slot. The client signature covers the slot itself
  (types.py ``transfer_signing_bytes``: tag || sender || seq ||
  recipient || amount) — stronger than the reference, whose sieve layer
  binds the sequence outside the signature
  (`at2-node/src/bin/server/rpc.rs:277-282`); see types.py for
  why the RPC-fronted design needs the binding inside.
* ``Attestation`` — an Echo or Ready: a node's signed vote that it saw a
  specific payload content for a given (sender, sequence) slot. Signing
  bytes carry a phase-specific domain tag so an Echo can never be replayed
  as a Ready.

All integers little-endian; keys/signatures raw (types.py's canonical
layout).
"""

from __future__ import annotations

import hashlib
import json
import struct
from dataclasses import dataclass

from ..types import ThinTransaction, transfer_signing_bytes

GOSSIP = 1
ECHO = 2
READY = 3
REQUEST = 4
# Ledger-history catchup plane (the reference's open "catchup mechanism"
# roadmap item, at2-node/README.md:53 — see ledger/history.py and
# node/service.py `_catchup_once` for the protocol):
HIST_IDX_REQ = 5  # "send me your commit frontier"
HIST_IDX = 6  # per-sender committed-sequence frontier
HIST_REQ = 7  # "send me sender X's committed payloads in [lo, hi]"
HIST_BATCH = 8  # a batch of committed payloads
# Batched broadcast plane (see TxBatch below): one broadcast slot carries
# many client transactions, amortizing the per-slot protocol cost (the
# ~9 wire messages + ~7 verifies per tx at n=4 that cap the per-tx plane
# at a few hundred tx/s). Public precedent: Chop Chop's batched atomic
# broadcast (PAPERS.md); here adapted to AT2's consensus-free model with
# per-entry endorsement bitmaps so sieve's per-(sender, sequence)
# equivocation filtering is preserved exactly (stack.py docstring).
BATCH = 9  # a node-originated batch of client payloads (gossip unit)
BATCH_ECHO = 10  # Echo over a batch: endorsement bitmap + one signature
BATCH_READY = 11  # Ready over a batch: same shape as BATCH_ECHO
BATCH_REQ = 12  # content pull for a quorate batch never gossiped here
# Client-directory gossip (broker ingress tier, see node/directory.py):
# a node that assigned client-ids announces the id -> pubkey mappings to
# its peers so distilled batches resolve everywhere. Liveness-only state
# (a wrong mapping just fails the entry's signature check locally), so
# announces are unsigned and accepted only over authenticated channels,
# same trust shape as the catchup plane.
DIR_ANNOUNCE = 13  # (announcing node, [(client_id, pubkey)...])
# Membership reconfiguration (node/membership.py): an admin-signed epoch
# transition — add/remove nodes, re-weight quorum thresholds. Gossiped
# like any other message and re-gossiped on first acceptance so every
# node converges on the new epoch; messages from epochs older than the
# grace window are rejected (stack.py / membership.py).
CONFIG_TX = 14  # (epoch, admin signature, JSON change description)
# Fleet-consistency audit plane (obs/audit.py): each node periodically
# gossips a signed digest of its committed ledger state — additive
# (commutative) lanes over the account ranges, the per-sender commit
# watermarks, and the client directory, plus a local hash-chain head.
# Peers compare beacons taken at the *same watermark digest* (equal
# watermark vector ⇔ equal committed set under AT2's gap-free per-sender
# sequencing), so nodes that legitimately commit in different orders
# never false-positive, while a real ledger divergence conflicts at an
# identical coordinate and flips /healthz to `diverged` with attribution.
BEACON = 15  # (epoch, commits, wm/account/directory digests, chain head)
# Finality co-signature (finality/): a node's signature over the
# CANONICAL frontier tuple (epoch, watermark digest, account-range
# lanes, directory digest) — the subset of a beacon every correct node
# reproduces byte-identically at the same committed set. The node-local
# `commits` count rides along unsigned (a lag/progress coordinate for
# operators and wait_final(); it differs across correct nodes and must
# never enter the preimage). CertAssembler folds 2f+1 of these into a
# quorum certificate a stateless light client can verify offline.
CERT_SIG = 16  # (epoch, commits, wm/account/directory digests, co-sig)

_PAYLOAD = struct.Struct("<32sI32sQ64s")  # sender, seq, recipient, amount, sig
_ATTEST = struct.Struct("<32s32sI32s64s")  # origin, sender, seq, hash, sig
_REQUEST = struct.Struct("<32sI32s")  # sender, seq, hash
_HIST_IDX_REQ = struct.Struct("<Q")  # nonce
_HIST_HDR = struct.Struct("<QI")  # nonce, entry count (HIST_IDX / HIST_BATCH)
_HIST_IDX_ENTRY = struct.Struct("<32sI")  # sender, last committed sequence
_HIST_REQ = struct.Struct("<Q32sII")  # nonce, sender, from_seq, to_seq
_BATCH_HDR = struct.Struct("<32sQI64s")  # origin, batch_seq, count, origin sig
_BATCH_ATT = struct.Struct("<32s32sQ32sI")  # origin, b_origin, b_seq, hash, bm len
_BATCH_REQ = struct.Struct("<32sQ32s")  # batch origin, batch_seq, hash
_DIR_HDR = struct.Struct("<32sI")  # announcing node, entry count
_DIR_ENTRY = struct.Struct("<Q32s")  # client id, client pubkey
_CONFIG_HDR = struct.Struct("<QI64s")  # epoch, body length, admin sig
# origin, epoch, commits, wm digest (16B), 16 u64 account-range lanes
# (128B), directory digest (8B), local chain head (32B); + 64B signature
_BEACON_BODY = struct.Struct("<32sQQ16s128s8s32s")
# origin, epoch, commits, wm digest (16B), 16 u64 account-range lanes
# (128B), directory digest (8B); + 64B co-signature. No chain head: only
# the canonical (cross-node identical) fields belong in a certificate.
_CERT_BODY = struct.Struct("<32sQQ16s128s8s")
# The signed preimage of a co-signature covers ONLY the canonical tuple
# (epoch, wm, ranges, dir) — not origin (the multi-sig scheme binds the
# signer via its verification key) and not commits (node-local).
_CERT_PREIMAGE = struct.Struct("<Q16s128s8s")

PAYLOAD_WIRE = 1 + _PAYLOAD.size
ATTEST_WIRE = 1 + _ATTEST.size
REQUEST_WIRE = 1 + _REQUEST.size
HIST_IDX_REQ_WIRE = 1 + _HIST_IDX_REQ.size
HIST_REQ_WIRE = 1 + _HIST_REQ.size
HIST_HDR_WIRE = 1 + _HIST_HDR.size  # variable records: header + entries
ENTRY_WIRE = _PAYLOAD.size  # one batch entry = one 140-byte payload body
BATCH_HDR_WIRE = 1 + _BATCH_HDR.size  # variable: header + count entries
BATCH_ATT_WIRE = 1 + _BATCH_ATT.size + 64  # variable: + bitmap before sig
BATCH_REQ_WIRE = 1 + _BATCH_REQ.size
DIR_HDR_WIRE = 1 + _DIR_HDR.size  # variable: header + count entries
CONFIG_HDR_WIRE = 1 + _CONFIG_HDR.size  # variable: header + JSON body
BEACON_WIRE = 1 + _BEACON_BODY.size + 64  # fixed: body + origin signature
CERT_SIG_WIRE = 1 + _CERT_BODY.size + 64  # fixed: body + co-signature

# Bounds one announce's parse amplification (a full directory re-sync
# splits across several announces).
MAX_DIR_ENTRIES = 4096

# A config transaction describes a handful of membership rows; anything
# larger is malformed (must match kMaxConfigBytes in
# native/at2_ingest.cpp).
MAX_CONFIG_BYTES = 4096

# Hard cap on entries per batch (bounds bitmap width, parse amplification,
# and the per-slot verify burst); the ingress batcher flushes well below
# it (node/config.py BatchingConfig.max_entries).
MAX_BATCH_ENTRIES = 1024
MAX_BITMAP_BYTES = MAX_BATCH_ENTRIES // 8

# A legitimate frame coalesces at most MAX_BATCH_MSGS = 1024 messages
# (net/peers.py); 4x that is the malformed bound. Bounds the parse
# amplification of frames dense with the 9-byte catchup request (must
# match kMaxMsgsPerFrame in native/at2_ingest.cpp).
MAX_MSGS_PER_FRAME = 4096

_ECHO_TAG = b"at2-node-tpu/echo/v1"
_READY_TAG = b"at2-node-tpu/ready/v1"
_BATCH_TAG = b"at2-node-tpu/batch/v1"
_BECHO_TAG = b"at2-node-tpu/batch-echo/v1"
_BREADY_TAG = b"at2-node-tpu/batch-ready/v1"
_CONFIG_TAG = b"at2-node-tpu/config-tx/v1"
_BEACON_TAG = b"at2-node-tpu/beacon/v1"
_CERT_TAG = b"at2-node-tpu/cert/v1"


class WireError(Exception):
    pass


@dataclass(frozen=True)
class Payload:
    """A transfer in flight: (sender, sequence) slot + signed content."""

    sender: bytes
    sequence: int
    transaction: ThinTransaction
    signature: bytes  # client's ed25519 over to_sign() (types.py v2 tag)

    @property
    def slot(self) -> tuple:
        return (self.sender, self.sequence)

    def to_sign(self) -> bytes:
        """The client-signature preimage: the v2 tagged transfer form
        binding (sender, sequence, recipient, amount) — see types.py."""
        return transfer_signing_bytes(
            self.sender,
            self.sequence,
            self.transaction.recipient,
            self.transaction.amount,
        )

    @classmethod
    def create(
        cls, keypair, sequence: int, transaction: ThinTransaction
    ) -> "Payload":
        """Build and client-sign a payload (the one construction path
        clients, benches, and tests share)."""
        return cls(
            keypair.public,
            sequence,
            transaction,
            keypair.sign(
                transfer_signing_bytes(
                    keypair.public,
                    sequence,
                    transaction.recipient,
                    transaction.amount,
                )
            ),
        )

    def encode(self) -> bytes:
        return bytes([GOSSIP]) + _PAYLOAD.pack(
            self.sender,
            self.sequence,
            self.transaction.recipient,
            self.transaction.amount,
            self.signature,
        )

    def content_hash(self) -> bytes:
        """Identifies the payload *content* within its slot — what Echo and
        Ready votes attest to (sieve's equivocation unit). Cached: the
        broadcast pipeline consults it several times per message."""
        cached = self.__dict__.get("_chash")
        if cached is None:
            cached = hashlib.sha256(
                _PAYLOAD.pack(
                    self.sender,
                    self.sequence,
                    self.transaction.recipient,
                    self.transaction.amount,
                    self.signature,
                )
            ).digest()
            object.__setattr__(self, "_chash", cached)
        return cached

    @staticmethod
    def decode_body(body: bytes) -> "Payload":
        sender, seq, recipient, amount, sig = _PAYLOAD.unpack(body)
        return Payload(sender, seq, ThinTransaction(recipient, amount), sig)


@dataclass(frozen=True)
class Attestation:
    """An Echo (phase=ECHO) or Ready (phase=READY) vote."""

    phase: int
    origin: bytes  # ed25519 sign key of the attesting node
    sender: bytes
    sequence: int
    content_hash: bytes
    signature: bytes

    @staticmethod
    def signing_bytes(
        phase: int, sender: bytes, sequence: int, content_hash: bytes
    ) -> bytes:
        tag = _ECHO_TAG if phase == ECHO else _READY_TAG
        return tag + sender + struct.pack("<I", sequence) + content_hash

    def to_sign(self) -> bytes:
        return self.signing_bytes(
            self.phase, self.sender, self.sequence, self.content_hash
        )

    def encode(self) -> bytes:
        return bytes([self.phase]) + _ATTEST.pack(
            self.origin, self.sender, self.sequence, self.content_hash, self.signature
        )

    @staticmethod
    def decode_body(phase: int, body: bytes) -> "Attestation":
        origin, sender, seq, chash, sig = _ATTEST.unpack(body)
        return Attestation(phase, origin, sender, seq, chash, sig)


@dataclass(frozen=True)
class ContentRequest:
    """Pull request for a payload whose Ready quorum was observed but whose
    gossip never arrived (contagion totality catch-up — the reference left
    this as the open "catchup mechanism" roadmap item,
    `at2-node/README.md:53`). Carries no signature: requests are
    only ever accepted over the mesh's authenticated channels, so the
    transport identifies the requester."""

    sender: bytes
    sequence: int
    content_hash: bytes

    def encode(self) -> bytes:
        return bytes([REQUEST]) + _REQUEST.pack(
            self.sender, self.sequence, self.content_hash
        )

    @staticmethod
    def decode_body(body: bytes) -> "ContentRequest":
        sender, seq, chash = _REQUEST.unpack(body)
        return ContentRequest(sender, seq, chash)


@dataclass(frozen=True)
class HistoryIndexRequest:
    """Ask a peer for its commit frontier (first step of a catchup
    session). ``nonce`` ties responses to the requesting session; like
    ContentRequest, unsigned — accepted only over authenticated channels."""

    nonce: int

    def encode(self) -> bytes:
        return bytes([HIST_IDX_REQ]) + _HIST_IDX_REQ.pack(self.nonce)

    @staticmethod
    def decode_body(body: bytes) -> "HistoryIndexRequest":
        (nonce,) = _HIST_IDX_REQ.unpack(body)
        return HistoryIndexRequest(nonce)


@dataclass(frozen=True)
class HistoryIndex:
    """A peer's commit frontier: (sender, last committed sequence) pairs.
    Variable length: header carries the entry count."""

    nonce: int
    entries: tuple  # of (sender: bytes, last_seq: int)

    def encode(self) -> bytes:
        parts = [
            bytes([HIST_IDX]),
            _HIST_HDR.pack(self.nonce, len(self.entries)),
        ]
        parts.extend(
            _HIST_IDX_ENTRY.pack(sender, seq) for sender, seq in self.entries
        )
        return b"".join(parts)

    @staticmethod
    def decode_body(nonce: int, body: bytes) -> "HistoryIndex":
        n = len(body) // _HIST_IDX_ENTRY.size
        entries = tuple(
            _HIST_IDX_ENTRY.unpack_from(body, i * _HIST_IDX_ENTRY.size)
            for i in range(n)
        )
        return HistoryIndex(nonce, entries)


@dataclass(frozen=True)
class HistoryRequest:
    """Pull a sender's committed payloads for sequences [from_seq, to_seq]
    (inclusive); the server clamps the range (see ledger/history.py)."""

    nonce: int
    sender: bytes
    from_seq: int
    to_seq: int

    def encode(self) -> bytes:
        return bytes([HIST_REQ]) + _HIST_REQ.pack(
            self.nonce, self.sender, self.from_seq, self.to_seq
        )

    @staticmethod
    def decode_body(body: bytes) -> "HistoryRequest":
        nonce, sender, lo, hi = _HIST_REQ.unpack(body)
        return HistoryRequest(nonce, sender, lo, hi)


@dataclass(frozen=True)
class HistoryBatch:
    """Committed payloads served from a peer's history store. The
    receiving catchup session trusts NO single peer: a slot is applied
    only once `catchup quorum` peers returned the same content hash AND
    the client signature verifies (node/service.py `_catchup_once`)."""

    nonce: int
    payloads: tuple  # of Payload

    def encode(self) -> bytes:
        parts = [
            bytes([HIST_BATCH]),
            _HIST_HDR.pack(self.nonce, len(self.payloads)),
        ]
        parts.extend(p.encode()[1:] for p in self.payloads)
        return b"".join(parts)

    @staticmethod
    def decode_body(nonce: int, body: bytes) -> "HistoryBatch":
        n = len(body) // _PAYLOAD.size
        payloads = tuple(
            Payload.decode_body(
                body[i * _PAYLOAD.size : (i + 1) * _PAYLOAD.size]
            )
            for i in range(n)
        )
        return HistoryBatch(nonce, payloads)


@dataclass(frozen=True)
class TxBatch:
    """A node-originated batch of client transactions: ONE broadcast slot
    ((origin node, batch_seq)) carrying many independently client-signed
    transfers. This is the protocol lever that amortizes the per-slot
    broadcast cost (gossip relay + n Echo + n Ready signatures) over
    ``count`` transactions — the reference broadcasts one transaction per
    sieve payload (`at2-node/src/bin/server/rpc.rs:275-284`); this
    build generalizes that surface (Chop Chop precedent, PAPERS.md).

    ``entries_raw`` is ``count`` back-to-back 140-byte payload bodies
    (the exact GOSSIP body layout), so entries decode with the same
    structs, the catchup/history plane stores them unchanged, and the
    per-entry *client* signatures ride inside — verified in the same bulk
    ``verify_many`` call as the one origin signature.

    The origin signs (tag || origin || batch_seq || sha256(entries_raw)):
    relayed batches cannot be forged under another node's identity, and a
    byzantine origin equivocating two batch contents for one batch_seq is
    filtered exactly like a per-tx equivocation (stack.py binds each slot
    to the first content echoed)."""

    origin: bytes  # sign key of the batching node
    batch_seq: int  # u64; unique per origin (time-seeded, see service.py)
    entries_raw: bytes  # count x 140-byte payload bodies
    signature: bytes  # origin's ed25519 over signing_bytes()

    @property
    def slot(self) -> tuple:
        return (self.origin, self.batch_seq)

    @property
    def count(self) -> int:
        return len(self.entries_raw) // ENTRY_WIRE

    def entry(self, i: int) -> Payload:
        return Payload.decode_body(
            self.entries_raw[i * ENTRY_WIRE : (i + 1) * ENTRY_WIRE]
        )

    def entry_bytes(self, i: int) -> bytes:
        return self.entries_raw[i * ENTRY_WIRE : (i + 1) * ENTRY_WIRE]

    def entries(self) -> list:
        """All entries decoded (memoized: echo and delivery both need
        them; one decode pass per batch per node)."""
        cached = self.__dict__.get("_entries")
        if cached is None:
            cached = [
                Payload(sender, seq, ThinTransaction(recipient, amount), sig)
                for sender, seq, recipient, amount, sig in _PAYLOAD.iter_unpack(
                    self.entries_raw
                )
            ]
            object.__setattr__(self, "_entries", cached)
        return cached

    def signing_bytes(self) -> bytes:
        return (
            _BATCH_TAG
            + self.origin
            + struct.pack("<Q", self.batch_seq)
            + hashlib.sha256(self.entries_raw).digest()
        )

    @classmethod
    def create(
        cls, keypair, batch_seq: int, entries_raw: bytes
    ) -> "TxBatch":
        """Build and origin-sign a batch (the one construction path the
        ingress batcher and bench tools share)."""
        unsigned = cls(keypair.public, batch_seq, entries_raw, b"\0" * 64)
        return cls(
            keypair.public,
            batch_seq,
            entries_raw,
            keypair.sign(unsigned.signing_bytes()),
        )

    def content_hash(self) -> bytes:
        """The batch content identity Echo/Ready bitmaps attest to (the
        whole encoded body, signature included — same convention as
        Payload.content_hash)."""
        cached = self.__dict__.get("_chash")
        if cached is None:
            cached = hashlib.sha256(self.encode()[1:]).digest()
            object.__setattr__(self, "_chash", cached)
        return cached

    def encode(self) -> bytes:
        cached = self.__dict__.get("_encoded")
        if cached is None:
            cached = (
                bytes([BATCH])
                + _BATCH_HDR.pack(
                    self.origin, self.batch_seq, self.count, self.signature
                )
                + self.entries_raw
            )
            object.__setattr__(self, "_encoded", cached)
        return cached

    @staticmethod
    def decode_body(body: bytes) -> "TxBatch":
        origin, batch_seq, count, sig = _BATCH_HDR.unpack_from(body)
        entries = body[_BATCH_HDR.size :]
        if len(entries) != count * ENTRY_WIRE:
            raise WireError("batch entry count mismatch")
        return TxBatch(origin, batch_seq, entries, sig)


@dataclass(frozen=True)
class BatchAttestation:
    """An Echo or Ready over a batch: ONE signature endorsing a subset of
    the batch's entries, given by ``bitmap`` (little-endian bit i =
    entry i). Bitmaps let a node endorse exactly the entries that pass
    its per-(sender, sequence) equivocation registry, so one conflicting
    entry cannot poison the rest of the batch, and per-entry quorum
    counting preserves sieve/contagion semantics entry-by-entry
    (stack.py `_BatchState`). Ready bitmaps are monotone: an origin may
    re-attest with a superset as more entries reach Echo quorum."""

    phase: int  # BATCH_ECHO or BATCH_READY
    origin: bytes  # attesting node's sign key
    batch_origin: bytes
    batch_seq: int
    batch_hash: bytes  # TxBatch.content_hash()
    bitmap: bytes  # little-endian entry endorsement bits
    signature: bytes

    @staticmethod
    def signing_bytes(
        phase: int, batch_origin: bytes, batch_seq: int, batch_hash: bytes,
        bitmap: bytes,
    ) -> bytes:
        tag = _BECHO_TAG if phase == BATCH_ECHO else _BREADY_TAG
        return (
            tag
            + batch_origin
            + struct.pack("<Q", batch_seq)
            + batch_hash
            + bitmap
        )

    def to_sign(self) -> bytes:
        return self.signing_bytes(
            self.phase, self.batch_origin, self.batch_seq, self.batch_hash,
            self.bitmap,
        )

    def encode(self) -> bytes:
        return (
            bytes([self.phase])
            + _BATCH_ATT.pack(
                self.origin,
                self.batch_origin,
                self.batch_seq,
                self.batch_hash,
                len(self.bitmap),
            )
            + self.bitmap
            + self.signature
        )

    @staticmethod
    def decode_body(phase: int, body: bytes) -> "BatchAttestation":
        origin, b_origin, b_seq, b_hash, bm_len = _BATCH_ATT.unpack_from(body)
        bitmap = body[_BATCH_ATT.size : _BATCH_ATT.size + bm_len]
        sig = body[_BATCH_ATT.size + bm_len :]
        if len(bitmap) != bm_len or len(sig) != 64:
            raise WireError("truncated batch attestation")
        return BatchAttestation(phase, origin, b_origin, b_seq, b_hash, bitmap, sig)


@dataclass(frozen=True)
class BatchContentRequest:
    """Pull request for a batch whose Ready quorum was observed but whose
    gossip never arrived (the batch-plane twin of ContentRequest;
    unsigned, accepted only over authenticated channels)."""

    batch_origin: bytes
    batch_seq: int
    batch_hash: bytes

    def encode(self) -> bytes:
        return bytes([BATCH_REQ]) + _BATCH_REQ.pack(
            self.batch_origin, self.batch_seq, self.batch_hash
        )

    @staticmethod
    def decode_body(body: bytes) -> "BatchContentRequest":
        b_origin, b_seq, b_hash = _BATCH_REQ.unpack(body)
        return BatchContentRequest(b_origin, b_seq, b_hash)


@dataclass(frozen=True)
class DirectoryAnnounce:
    """Gossiped client-directory mappings: ``entries`` is a tuple of
    (client_id, pubkey) pairs assigned by ``origin`` (ids must fall in
    origin's stride — receivers check, node/directory.py ``apply``).
    Unsigned: accepted only over the mesh's authenticated channels, and
    a byzantine peer announcing wrong mappings can only make entries
    fail signature verification locally (liveness, never safety)."""

    origin: bytes  # announcing node's sign key
    entries: tuple  # of (client_id: int, pubkey: bytes)

    def encode(self) -> bytes:
        parts = [
            bytes([DIR_ANNOUNCE]),
            _DIR_HDR.pack(self.origin, len(self.entries)),
        ]
        parts.extend(_DIR_ENTRY.pack(cid, key) for cid, key in self.entries)
        return b"".join(parts)

    @staticmethod
    def decode_body(origin: bytes, body: bytes) -> "DirectoryAnnounce":
        n = len(body) // _DIR_ENTRY.size
        entries = tuple(
            _DIR_ENTRY.unpack_from(body, i * _DIR_ENTRY.size) for i in range(n)
        )
        return DirectoryAnnounce(origin, entries)


@dataclass(frozen=True)
class ConfigTx:
    """An epoch-based membership reconfiguration, signed by the fleet
    admin key (node/config.py ``admin_public``). ``body`` is canonical
    JSON (sorted keys, compact separators) describing the change:

    * ``add``    — rows of {address, exchange_hex, sign_hex} to join
    * ``remove`` — sign-key hexes to evict
    * ``echo_threshold`` / ``ready_threshold`` — optional re-weighting
    * ``grace``  — seconds old-epoch messages stay accepted

    The admin signature covers (tag || epoch || body), so a transaction
    can neither be replayed into a different epoch nor altered in
    flight. Validation (epoch must be exactly current+1, signature must
    verify against the configured admin key) lives in
    node/membership.py — the wire layer only carries it."""

    epoch: int
    body: bytes  # canonical JSON change description
    signature: bytes  # admin ed25519 over signing_bytes()

    @staticmethod
    def signing_bytes(epoch: int, body: bytes) -> bytes:
        return _CONFIG_TAG + struct.pack("<Q", epoch) + body

    def to_sign(self) -> bytes:
        return self.signing_bytes(self.epoch, self.body)

    @classmethod
    def create(cls, admin_keypair, epoch: int, change: dict) -> "ConfigTx":
        """Build and admin-sign a config transaction (the one
        construction path tools, sims, and tests share)."""
        body = json.dumps(
            change, separators=(",", ":"), sort_keys=True
        ).encode()
        return cls(epoch, body, admin_keypair.sign(cls.signing_bytes(epoch, body)))

    def change(self) -> dict:
        return json.loads(self.body)

    def encode(self) -> bytes:
        return (
            bytes([CONFIG_TX])
            + _CONFIG_HDR.pack(self.epoch, len(self.body), self.signature)
            + self.body
        )

    @staticmethod
    def decode_body(body: bytes) -> "ConfigTx":
        epoch, length, sig = _CONFIG_HDR.unpack_from(body)
        payload = body[_CONFIG_HDR.size :]
        if len(payload) != length:
            raise WireError("config tx body length mismatch")
        return ConfigTx(epoch, payload, sig)


@dataclass(frozen=True)
class StateBeacon:
    """A signed fleet-audit digest of one node's committed ledger state
    (obs/audit.py builds, compares, and attributes; TECHNICAL.md "Fleet
    audit & incident capture" documents the digest rules).

    All cross-node-comparable fields are *additive* digests — unordered
    sums over the state, so two correct nodes that committed the same
    set of transactions in different orders produce identical values:

    * ``wm_digest``  — 128-bit sum of H(sender, last_sequence) over the
      commit-watermark frontier; the comparison coordinate.
    * ``ranges``     — sixteen u64 lanes, one per account range
      (``key[0] >> 4``), each a sum of H(key, balance, sequence) over
      the accounts in that range; lane-granular attribution.
    * ``dir_digest`` — u64 sum of H(client_id, pubkey) over the client
      directory (informational: directory gossip is eventually
      consistent, so skew here is never treated as divergence).

    ``chain`` is the node's *local* sha256 digest-chain head — folded
    per beacon point and persisted in the store manifest as restart
    tamper evidence; it is order-dependent and never compared across
    peers. The origin signature makes a beacon non-repudiable evidence
    in incident bundles."""

    origin: bytes  # beaconing node's sign key
    epoch: int  # membership epoch the digest was taken under
    commits: int  # node-local committed-transfer count at the snapshot
    wm_digest: bytes  # 16B additive watermark digest (the coordinate)
    ranges: bytes  # 16 little-endian u64 account-range lanes (128B)
    dir_digest: bytes  # 8B additive client-directory digest
    chain: bytes  # 32B local digest-chain head (never compared)
    signature: bytes  # origin ed25519 over signing_bytes()

    @staticmethod
    def signing_bytes(
        origin: bytes,
        epoch: int,
        commits: int,
        wm_digest: bytes,
        ranges: bytes,
        dir_digest: bytes,
        chain: bytes,
    ) -> bytes:
        return _BEACON_TAG + _BEACON_BODY.pack(
            origin, epoch, commits, wm_digest, ranges, dir_digest, chain
        )

    def to_sign(self) -> bytes:
        return self.signing_bytes(
            self.origin,
            self.epoch,
            self.commits,
            self.wm_digest,
            self.ranges,
            self.dir_digest,
            self.chain,
        )

    @classmethod
    def create(
        cls,
        keypair,
        epoch: int,
        commits: int,
        wm_digest: bytes,
        ranges: bytes,
        dir_digest: bytes,
        chain: bytes,
    ) -> "StateBeacon":
        sig = keypair.sign(
            cls.signing_bytes(
                keypair.public, epoch, commits, wm_digest, ranges,
                dir_digest, chain,
            )
        )
        return cls(
            keypair.public, epoch, commits, wm_digest, ranges, dir_digest,
            chain, sig,
        )

    def encode(self) -> bytes:
        return (
            bytes([BEACON])
            + _BEACON_BODY.pack(
                self.origin,
                self.epoch,
                self.commits,
                self.wm_digest,
                self.ranges,
                self.dir_digest,
                self.chain,
            )
            + self.signature
        )

    @staticmethod
    def decode_body(body: bytes) -> "StateBeacon":
        origin, epoch, commits, wm, ranges, dird, chain = _BEACON_BODY.unpack(
            body[: _BEACON_BODY.size]
        )
        return StateBeacon(
            origin, epoch, commits, wm, ranges, dird, chain,
            body[_BEACON_BODY.size :],
        )


def cert_signing_bytes(
    epoch: int, wm_digest: bytes, ranges: bytes, dir_digest: bytes
) -> bytes:
    """The canonical certificate preimage: every correct node at the
    same committed frontier produces these exact bytes, so a quorum of
    signatures over them is portable finality evidence. Deliberately
    excludes the signer identity (bound by the verification key in the
    attestation scheme) and every node-local field (commits, chain)."""
    return _CERT_TAG + _CERT_PREIMAGE.pack(epoch, wm_digest, ranges, dir_digest)


@dataclass(frozen=True)
class CertSig:
    """One node's finality co-signature over a canonical commit
    frontier (finality/certs.py assembles 2f+1 of these into a quorum
    certificate; TECHNICAL.md "Finality certificates").

    ``epoch``/``wm_digest``/``ranges``/``dir_digest`` are the signed
    canonical tuple — additive digests identical across correct nodes
    at the same committed set (see StateBeacon). ``commits`` is the
    origin's node-local committed-transfer count at the frontier:
    informational (progress/lag coordinate), carried OUTSIDE the
    preimage because correct nodes disagree on it."""

    origin: bytes  # co-signing node's sign key
    epoch: int  # membership epoch the frontier was taken under
    commits: int  # node-local commit count (unsigned, informational)
    wm_digest: bytes  # 16B additive watermark digest (the coordinate)
    ranges: bytes  # 16 little-endian u64 account-range lanes (128B)
    dir_digest: bytes  # 8B additive client-directory digest
    signature: bytes  # origin ed25519 over cert_signing_bytes()

    def to_sign(self) -> bytes:
        return cert_signing_bytes(
            self.epoch, self.wm_digest, self.ranges, self.dir_digest
        )

    @classmethod
    def create(
        cls,
        keypair,
        epoch: int,
        commits: int,
        wm_digest: bytes,
        ranges: bytes,
        dir_digest: bytes,
    ) -> "CertSig":
        sig = keypair.sign(
            cert_signing_bytes(epoch, wm_digest, ranges, dir_digest)
        )
        return cls(
            keypair.public, epoch, commits, wm_digest, ranges, dir_digest, sig
        )

    def encode(self) -> bytes:
        return (
            bytes([CERT_SIG])
            + _CERT_BODY.pack(
                self.origin,
                self.epoch,
                self.commits,
                self.wm_digest,
                self.ranges,
                self.dir_digest,
            )
            + self.signature
        )

    @staticmethod
    def decode_body(body: bytes) -> "CertSig":
        origin, epoch, commits, wm, ranges, dird = _CERT_BODY.unpack(
            body[: _CERT_BODY.size]
        )
        return CertSig(
            origin, epoch, commits, wm, ranges, dird, body[_CERT_BODY.size :]
        )


def parse_frame(frame: bytes) -> list:
    """Split a frame into messages (frames may coalesce many)."""
    out = []
    view = memoryview(frame)
    while view:
        if len(out) >= MAX_MSGS_PER_FRAME:
            raise WireError("frame exceeds message cap")
        kind = view[0]
        if kind == GOSSIP:
            if len(view) < PAYLOAD_WIRE:
                raise WireError("truncated payload")
            out.append(Payload.decode_body(bytes(view[1:PAYLOAD_WIRE])))
            view = view[PAYLOAD_WIRE:]
        elif kind in (ECHO, READY):
            if len(view) < ATTEST_WIRE:
                raise WireError("truncated attestation")
            out.append(Attestation.decode_body(kind, bytes(view[1:ATTEST_WIRE])))
            view = view[ATTEST_WIRE:]
        elif kind == REQUEST:
            if len(view) < REQUEST_WIRE:
                raise WireError("truncated content request")
            out.append(ContentRequest.decode_body(bytes(view[1:REQUEST_WIRE])))
            view = view[REQUEST_WIRE:]
        elif kind == HIST_IDX_REQ:
            if len(view) < HIST_IDX_REQ_WIRE:
                raise WireError("truncated history index request")
            out.append(
                HistoryIndexRequest.decode_body(bytes(view[1:HIST_IDX_REQ_WIRE]))
            )
            view = view[HIST_IDX_REQ_WIRE:]
        elif kind == HIST_REQ:
            if len(view) < HIST_REQ_WIRE:
                raise WireError("truncated history request")
            out.append(HistoryRequest.decode_body(bytes(view[1:HIST_REQ_WIRE])))
            view = view[HIST_REQ_WIRE:]
        elif kind in (HIST_IDX, HIST_BATCH):
            if len(view) < HIST_HDR_WIRE:
                raise WireError("truncated history header")
            nonce, count = _HIST_HDR.unpack(bytes(view[1:HIST_HDR_WIRE]))
            entry = _HIST_IDX_ENTRY.size if kind == HIST_IDX else _PAYLOAD.size
            total = HIST_HDR_WIRE + count * entry
            if len(view) < total:
                raise WireError("truncated history entries")
            body = bytes(view[HIST_HDR_WIRE:total])
            if kind == HIST_IDX:
                out.append(HistoryIndex.decode_body(nonce, body))
            else:
                out.append(HistoryBatch.decode_body(nonce, body))
            view = view[total:]
        elif kind == BATCH:
            if len(view) < BATCH_HDR_WIRE:
                raise WireError("truncated batch header")
            _, _, count, _ = _BATCH_HDR.unpack_from(view, 1)
            if not 1 <= count <= MAX_BATCH_ENTRIES:
                raise WireError("batch entry count out of range")
            total = BATCH_HDR_WIRE + count * ENTRY_WIRE
            if len(view) < total:
                raise WireError("truncated batch entries")
            out.append(TxBatch.decode_body(bytes(view[1:total])))
            view = view[total:]
        elif kind in (BATCH_ECHO, BATCH_READY):
            if len(view) < BATCH_ATT_WIRE:
                raise WireError("truncated batch attestation")
            bm_len = int.from_bytes(
                bytes(view[1 + _BATCH_ATT.size - 4 : 1 + _BATCH_ATT.size]),
                "little",
            )
            if bm_len > MAX_BITMAP_BYTES:
                raise WireError("batch attestation bitmap too wide")
            total = BATCH_ATT_WIRE + bm_len
            if len(view) < total:
                raise WireError("truncated batch attestation bitmap")
            out.append(
                BatchAttestation.decode_body(kind, bytes(view[1:total]))
            )
            view = view[total:]
        elif kind == BATCH_REQ:
            if len(view) < BATCH_REQ_WIRE:
                raise WireError("truncated batch content request")
            out.append(
                BatchContentRequest.decode_body(bytes(view[1:BATCH_REQ_WIRE]))
            )
            view = view[BATCH_REQ_WIRE:]
        elif kind == DIR_ANNOUNCE:
            if len(view) < DIR_HDR_WIRE:
                raise WireError("truncated directory announce header")
            origin, count = _DIR_HDR.unpack(bytes(view[1:DIR_HDR_WIRE]))
            if count > MAX_DIR_ENTRIES:
                raise WireError("directory announce entry count out of range")
            total = DIR_HDR_WIRE + count * _DIR_ENTRY.size
            if len(view) < total:
                raise WireError("truncated directory announce entries")
            out.append(
                DirectoryAnnounce.decode_body(origin, bytes(view[DIR_HDR_WIRE:total]))
            )
            view = view[total:]
        elif kind == CONFIG_TX:
            if len(view) < CONFIG_HDR_WIRE:
                raise WireError("truncated config tx header")
            _, length, _ = _CONFIG_HDR.unpack(bytes(view[1:CONFIG_HDR_WIRE]))
            if length > MAX_CONFIG_BYTES:
                raise WireError("config tx body too large")
            total = CONFIG_HDR_WIRE + length
            if len(view) < total:
                raise WireError("truncated config tx body")
            out.append(ConfigTx.decode_body(bytes(view[1:total])))
            view = view[total:]
        elif kind == BEACON:
            if len(view) < BEACON_WIRE:
                raise WireError("truncated state beacon")
            out.append(StateBeacon.decode_body(bytes(view[1:BEACON_WIRE])))
            view = view[BEACON_WIRE:]
        elif kind == CERT_SIG:
            if len(view) < CERT_SIG_WIRE:
                raise WireError("truncated cert co-signature")
            out.append(CertSig.decode_body(bytes(view[1:CERT_SIG_WIRE])))
            view = view[CERT_SIG_WIRE:]
        else:
            raise WireError(f"unknown message kind {kind}")
    return out

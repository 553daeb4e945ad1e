"""Quorum certificates over canonical commit frontiers.

Counterpart of ``at2_node_tpu/finality/certs.py``.

A :class:`Certificate` is the portable artifact: the canonical tuple
(epoch, watermark digest, 16 account-range lanes, directory digest) a
quorum of member nodes co-signed, plus WHO signed (a bitmap over the
epoch's member list in sorted-key order) and the scheme's signature
blob. Everything in it is externally checkable — no field depends on
the serving node being honest.

The :class:`CertAssembler` is the node-side collector: it buckets
incoming kind-16 co-signatures by (epoch, watermark digest), verifies
each against the claimed member key, latches *equivocation* — one
member co-signing two different ledger states for the same committed
set — with the two signed preimages as evidence, and assembles a
certificate the moment any bucket reaches quorum. Assembly is
deterministic: signatures are ordered by member rank, never by
arrival, so every node that sees the same co-signature set produces a
byte-identical certificate.
"""

from __future__ import annotations

import struct
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..broadcast.messages import CertSig, cert_signing_bytes
from .scheme import SCHEME_IDS, get_scheme, scheme_by_id

CERT_VERSION = 1

# version(u8) scheme_id(u8) epoch(u64) commits(u64) wm(16) ranges(128)
# dir(8) bitmap_len(u16) blob_len(u32); then bitmap + blob
_CERT_HDR = struct.Struct("<BBQQ16s128s8sHI")

# pending co-signature buckets kept per assembler: frontiers older than
# this many distinct (epoch, wm) coordinates are evicted oldest-first —
# a straggler beyond that re-converges at the next frontier instead
_PENDING_CAP = 64

# sanity bounds for decode (a certificate names at most one signature
# per member; fleets are small)
_MAX_MEMBERS = 4096


@dataclass(frozen=True)
class Certificate:
    """One assembled quorum certificate (externally verifiable)."""

    epoch: int  # membership epoch the frontier was certified under
    commits: int  # max contributor commit count (informational)
    wm_digest: bytes  # 16B additive watermark digest — the coordinate
    ranges: bytes  # 16 u64 account-range lanes (128B)
    dir_digest: bytes  # 8B additive client-directory digest
    scheme: str  # attestation scheme name (scheme.py registry)
    bitmap: bytes  # little-endian member bitmap, sorted-key rank order
    sigs: bytes  # scheme signature blob (rank order for multi_eddsa)

    def preimage(self) -> bytes:
        """The bytes every co-signature in this certificate covers."""
        return cert_signing_bytes(
            self.epoch, self.wm_digest, self.ranges, self.dir_digest
        )

    def signer_count(self) -> int:
        return bin(int.from_bytes(self.bitmap, "little")).count("1")

    def signer_ranks(self) -> List[int]:
        bits = int.from_bytes(self.bitmap, "little")
        return [i for i in range(len(self.bitmap) * 8) if (bits >> i) & 1]

    def encode(self) -> bytes:
        return (
            _CERT_HDR.pack(
                CERT_VERSION,
                SCHEME_IDS[self.scheme],
                self.epoch,
                self.commits,
                self.wm_digest,
                self.ranges,
                self.dir_digest,
                len(self.bitmap),
                len(self.sigs),
            )
            + self.bitmap
            + self.sigs
        )

    @staticmethod
    def decode(raw: bytes) -> "Certificate":
        if len(raw) < _CERT_HDR.size:
            raise ValueError("truncated certificate header")
        (
            version, scheme_id, epoch, commits, wm, ranges, dird,
            bitmap_len, blob_len,
        ) = _CERT_HDR.unpack_from(raw)
        if version != CERT_VERSION:
            raise ValueError(f"unknown certificate version {version}")
        if bitmap_len > (_MAX_MEMBERS + 7) // 8:
            raise ValueError("certificate bitmap too wide")
        scheme = scheme_by_id(scheme_id)  # raises on unknown id
        if blob_len > _MAX_MEMBERS * scheme.sig_bytes:
            raise ValueError("certificate signature blob too large")
        total = _CERT_HDR.size + bitmap_len + blob_len
        if len(raw) != total:
            raise ValueError("certificate length mismatch")
        bitmap = raw[_CERT_HDR.size : _CERT_HDR.size + bitmap_len]
        sigs = raw[_CERT_HDR.size + bitmap_len : total]
        return Certificate(
            epoch, commits, wm, ranges, dird, scheme.name, bitmap, sigs
        )

    def to_doc(self) -> dict:
        """JSON-safe form (/certz, store manifest)."""
        return {
            "v": CERT_VERSION,
            "scheme": self.scheme,
            "epoch": self.epoch,
            "commits": self.commits,
            "wm": self.wm_digest.hex(),
            "ranges": self.ranges.hex(),
            "dir": self.dir_digest.hex(),
            "bitmap": self.bitmap.hex(),
            "sigs": self.sigs.hex(),
        }

    @staticmethod
    def from_doc(doc: dict) -> "Certificate":
        if int(doc.get("v", 0)) != CERT_VERSION:
            raise ValueError("unknown certificate doc version")
        scheme = str(doc["scheme"])
        if scheme not in SCHEME_IDS:
            raise ValueError(f"unknown attestation scheme {scheme!r}")
        return Certificate(
            int(doc["epoch"]),
            int(doc["commits"]),
            bytes.fromhex(doc["wm"]),
            bytes.fromhex(doc["ranges"]),
            bytes.fromhex(doc["dir"]),
            scheme,
            bytes.fromhex(doc["bitmap"]),
            bytes.fromhex(doc["sigs"]),
        )


class CertAssembler:
    """Collects kind-16 co-signatures into quorum certificates.

    ``members`` is the epoch's node sign-key set; rank order (and so
    bitmap bit assignment) is the sorted key order, which every node
    derives identically from the same membership view. ``quorum=0``
    derives the AT2 default 2f+1 with f=(n-1)//3."""

    def __init__(
        self,
        members,
        *,
        epoch: int = 0,
        scheme: str = "multi_eddsa",
        quorum: int = 0,
        history: int = 8,
    ):
        self.scheme = get_scheme(scheme)
        self.history = max(1, int(history))
        self.epoch = int(epoch)
        self.chain: List[Certificate] = []
        # latched first equivocation (culprit attribution + evidence);
        # like the auditor's divergence latch it never self-clears
        self.equivocation: Optional[dict] = None
        self.counters: Dict[str, int] = {
            "cosigs": 0,
            "foreign": 0,
            "epoch_skew": 0,
            "bad_sig": 0,
            "duplicates": 0,
            "equivocations": 0,
            "assembled": 0,
        }
        self._configured_quorum = int(quorum)
        self._set_members(members)
        # (epoch, wm) -> {(ranges, dir) -> {origin -> CertSig}}
        self._pending: "OrderedDict[Tuple[int, bytes], dict]" = OrderedDict()
        self._certified: set = set()  # (epoch, wm) already assembled

    # -- membership -------------------------------------------------------

    def _set_members(self, members) -> None:
        ranked = sorted(set(bytes(m) for m in members))
        self._ranks: Dict[bytes, int] = {k: i for i, k in enumerate(ranked)}
        self._members: List[bytes] = ranked
        n = len(ranked)
        if self._configured_quorum > 0:
            self.quorum = min(self._configured_quorum, max(1, n))
        else:
            f = (n - 1) // 3 if n else 0
            self.quorum = 2 * f + 1 if n else 1

    def reconfigure(self, members, epoch: int) -> None:
        """Epoch transition: new member set, pending buckets from the
        old epoch dropped (their co-signatures name the old epoch and
        can never reach quorum under the new one). The assembled chain
        survives — certificates name their epoch."""
        self.epoch = int(epoch)
        self._set_members(members)
        for key in [k for k in self._pending if k[0] != self.epoch]:
            del self._pending[key]

    @property
    def members(self) -> List[bytes]:
        return list(self._members)

    # -- collection -------------------------------------------------------

    def add(self, cosig: CertSig) -> Optional[Certificate]:
        """Fold one co-signature; returns a Certificate when this one
        completes a quorum, else None."""
        self.counters["cosigs"] += 1
        rank = self._ranks.get(cosig.origin)
        if rank is None:
            self.counters["foreign"] += 1
            return None
        if cosig.epoch != self.epoch:
            # stale (pre-reconfig) or future-epoch co-signature: either
            # way it cannot join this epoch's quorum
            self.counters["epoch_skew"] += 1
            return None
        preimage = cosig.to_sign()
        if not self.scheme.verify_cosig(
            cosig.origin, preimage, cosig.signature
        ):
            self.counters["bad_sig"] += 1
            return None

        key = (cosig.epoch, cosig.wm_digest)
        groups = self._pending.get(key)
        if groups is None:
            groups = self._pending[key] = {}
            while len(self._pending) > _PENDING_CAP:
                self._pending.popitem(last=False)
        state = (cosig.ranges, cosig.dir_digest)

        # Equivocation: equal watermark digest ⇔ equal committed set
        # (AT2 gap-free per-sender sequencing), so one origin signing
        # two different (ranges, dir) states at the same (epoch, wm) is
        # cryptographic proof of misbehavior — latch it with both
        # signed statements as evidence.
        for other_state, sigs in groups.items():
            if other_state != state and cosig.origin in sigs:
                self.counters["equivocations"] += 1
                if self.equivocation is None:
                    prev = sigs[cosig.origin]
                    self.equivocation = {
                        "origin": cosig.origin.hex(),
                        "epoch": cosig.epoch,
                        "wm": cosig.wm_digest.hex(),
                        "first": {
                            "ranges": prev.ranges.hex(),
                            "dir": prev.dir_digest.hex(),
                            "sig": prev.signature.hex(),
                        },
                        "second": {
                            "ranges": cosig.ranges.hex(),
                            "dir": cosig.dir_digest.hex(),
                            "sig": cosig.signature.hex(),
                        },
                    }
                return None

        sigs = groups.setdefault(state, {})
        if cosig.origin in sigs:
            self.counters["duplicates"] += 1
            return None
        sigs[cosig.origin] = cosig

        if len(sigs) >= self.quorum and key not in self._certified:
            self._certified.add(key)
            cert = self._assemble(cosig.epoch, cosig.wm_digest, state, sigs)
            del self._pending[key]
            return cert
        return None

    def _assemble(
        self,
        epoch: int,
        wm: bytes,
        state: Tuple[bytes, bytes],
        sigs: Dict[bytes, CertSig],
    ) -> Certificate:
        ranked = sorted(sigs, key=lambda k: self._ranks[k])
        bits = 0
        for origin in ranked:
            bits |= 1 << self._ranks[origin]
        width = (len(self._members) + 7) // 8
        cert = Certificate(
            epoch=epoch,
            commits=max(sigs[o].commits for o in ranked),
            wm_digest=wm,
            ranges=state[0],
            dir_digest=state[1],
            scheme=self.scheme.name,
            bitmap=bits.to_bytes(max(1, width), "little"),
            sigs=self.scheme.aggregate(
                [sigs[o].signature for o in ranked]
            ),
        )
        self.counters["assembled"] += 1
        # A quorum for an older audit point can complete after a newer
        # one did (co-signatures arrive in any order). Insert it in
        # (epoch, commits) order, so the served chain never rolls
        # progress back (verify_chain) and ``latest`` stays the newest.
        at = len(self.chain)
        while at and (
            (self.chain[at - 1].epoch, self.chain[at - 1].commits)
            > (cert.epoch, cert.commits)
        ):
            at -= 1
        self.chain.insert(at, cert)
        del self.chain[: -self.history]
        return cert

    # -- views / persistence ---------------------------------------------

    @property
    def latest(self) -> Optional[Certificate]:
        return self.chain[-1] if self.chain else None

    def status(self) -> dict:
        latest = self.latest
        out = {
            "epoch": self.epoch,
            "quorum": self.quorum,
            "members": len(self._members),
            "chain_len": len(self.chain),
            "pending": len(self._pending),
            **self.counters,
        }
        if latest is not None:
            out["latest"] = {
                "epoch": latest.epoch,
                "commits": latest.commits,
                "wm": latest.wm_digest.hex(),
                "signers": latest.signer_count(),
            }
        if self.equivocation is not None:
            out["equivocation"] = dict(self.equivocation)
        return out

    def stats(self) -> dict:
        """Flat numeric counters for the metrics registry."""
        return {
            **self.counters,
            "chain_len": len(self.chain),
            "latest_commits": self.latest.commits if self.chain else 0,
        }

    def export(self) -> dict:
        """Manifest persistence: the assembled chain tail plus the
        equivocation latch (evidence must survive a restart)."""
        doc: dict = {"chain": [c.to_doc() for c in self.chain]}
        if self.equivocation is not None:
            doc["equivocation"] = dict(self.equivocation)
        return doc

    def restore(self, doc: Optional[dict]) -> None:
        if not doc:
            return
        chain = []
        for cert_doc in doc.get("chain", []):
            try:
                chain.append(Certificate.from_doc(cert_doc))
            except (ValueError, KeyError, TypeError):
                continue  # skip corrupt entries, keep the rest
        if chain:
            self.chain = chain[-self.history :]
            # re-assembling an already-certified frontier after restart
            # would fork the chain ordering; remember what we served
            self._certified.update(
                (c.epoch, c.wm_digest) for c in self.chain
            )
        eq = doc.get("equivocation")
        if eq and self.equivocation is None:
            self.equivocation = dict(eq)

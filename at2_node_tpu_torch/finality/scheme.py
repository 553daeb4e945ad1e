"""The attestation seam: how co-signatures are made, aggregated, and
checked.

Counterpart of ``at2_node_tpu/finality/scheme.py``.

A certificate is scheme-agnostic above this line — the assembler and
the light client only ever call the four methods below, so swapping the
multi-signature for a real aggregate (a BLS mode, per the
EdDSA-vs-BLS committee study) is a registry entry plus a scheme id,
not a wire or verifier redesign.

``multi_eddsa`` (the only built-in) is the trivial aggregate: the
member co-signatures, 64 bytes each, concatenated in member-bitmap bit
order. Verification is per-signature ed25519 (crypto/keys.verify_one,
OpenSSL), never the batch verifier or the kernel, so it needs no
pairing library and the light client stays pure Python.
"""

from __future__ import annotations

from typing import Dict, List

from ..crypto.keys import verify_one


class AttestationScheme:
    """One way of turning member co-signatures into a checkable blob.

    ``name`` keys the registry (and the wire scheme id via
    :data:`SCHEME_IDS`); ``sig_bytes`` is the fixed per-member
    co-signature width this scheme emits on kind-16 frames."""

    name: str = ""
    sig_bytes: int = 64

    def cosign(self, keypair, preimage: bytes) -> bytes:
        raise NotImplementedError

    def verify_cosig(self, public: bytes, preimage: bytes, sig: bytes) -> bool:
        raise NotImplementedError

    def aggregate(self, sigs: List[bytes]) -> bytes:
        """Fold per-member co-signatures (bitmap bit order) into the
        certificate's signature blob."""
        raise NotImplementedError

    def split(self, blob: bytes) -> List[bytes]:
        """Inverse of :meth:`aggregate` for schemes where the blob is
        separable (the light client checks members one by one)."""
        raise NotImplementedError


class MultiEddsa(AttestationScheme):
    name = "multi_eddsa"
    sig_bytes = 64

    def cosign(self, keypair, preimage: bytes) -> bytes:
        return keypair.sign(preimage)

    def verify_cosig(self, public: bytes, preimage: bytes, sig: bytes) -> bool:
        if len(sig) != self.sig_bytes:
            return False
        return verify_one(public, preimage, sig)

    def aggregate(self, sigs: List[bytes]) -> bytes:
        return b"".join(sigs)

    def split(self, blob: bytes) -> List[bytes]:
        w = self.sig_bytes
        if len(blob) % w:
            raise ValueError("multi_eddsa blob not a multiple of 64 bytes")
        return [blob[i : i + w] for i in range(0, len(blob), w)]


_SCHEMES: Dict[str, AttestationScheme] = {}

# wire/manifest scheme ids: append-only (certificates persist across
# versions); 0 is reserved so an all-zero header never looks valid
SCHEME_IDS: Dict[str, int] = {"multi_eddsa": 1}


def register_scheme(scheme: AttestationScheme) -> None:
    if not scheme.name:
        raise ValueError("attestation scheme needs a name")
    if scheme.name not in SCHEME_IDS:
        SCHEME_IDS[scheme.name] = max(SCHEME_IDS.values(), default=0) + 1
    _SCHEMES[scheme.name] = scheme


def get_scheme(name: str) -> AttestationScheme:
    try:
        return _SCHEMES[name]
    except KeyError:
        raise ValueError(f"unknown attestation scheme {name!r}") from None


def scheme_by_id(scheme_id: int) -> AttestationScheme:
    for name, sid in SCHEME_IDS.items():
        if sid == scheme_id and name in _SCHEMES:
            return _SCHEMES[name]
    raise ValueError(f"unknown attestation scheme id {scheme_id}")


register_scheme(MultiEddsa())

"""The stateless light client: verify finality with f+1 known keys.

Counterpart of ``at2_node_tpu/finality/light.py``.

No node state, no gRPC stream, no trust in the serving node — a
:class:`LightVerifier` holds nothing but public keys from the genesis
epoch config and checks certificates fetched from ANY node's
``GET /certz`` (or the ``GetCertificate`` RPC). Two modes:

* **subset** (the wallet case): the client knows only ``keys`` — at
  least f+1 member public keys — and accepts a certificate once
  ``threshold`` distinct known keys have valid co-signatures over the
  canonical preimage. With threshold ≥ f+1, at least one co-signer is
  honest, and an honest node only co-signs a frontier its own ledger
  reached — so the certified state is real finality, not a story the
  serving node made up.

* **full** (node/CI audit): ``members`` is the complete epoch member
  list in canonical (sorted-key) rank order; every set bitmap bit must
  carry a valid co-signature from exactly that member and the popcount
  must reach ``quorum`` (2f+1 by default). This is the strict check the
  assembler's own output always passes; any mutation — forged bitmap
  bit, swapped signature, altered digest — fails it.

Pure Python on purpose: the only dependency is the ed25519 verify the
package already carries, so the verifier runs anywhere the wire format
is known.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from .certs import Certificate
from .scheme import get_scheme


def _to_key(k) -> bytes:
    if isinstance(k, str):
        return bytes.fromhex(k)
    return bytes(k)


def default_threshold(total: int) -> int:
    """f+1 for an n-node fleet with f=(n-1)//3: the smallest count that
    guarantees an honest co-signer."""
    return (max(1, int(total)) - 1) // 3 + 1


class LightVerifier:
    def __init__(
        self,
        keys: Iterable,
        *,
        threshold: Optional[int] = None,
        total: Optional[int] = None,
        members: Optional[Sequence] = None,
        quorum: Optional[int] = None,
    ):
        """``keys``: the member public keys this client trusts (bytes or
        hex). ``total``: fleet size from the genesis epoch config, used
        to derive the default f+1 ``threshold``; without it the default
        demands every known key co-sign. ``members`` (full rank-ordered
        member list) switches on full-quorum mode with ``quorum``
        signers required (default 2f+1)."""
        self.keys: List[bytes] = [_to_key(k) for k in keys]
        if not self.keys and members is None:
            raise ValueError("light verifier needs at least one key")
        if threshold is not None:
            self.threshold = max(1, int(threshold))
        elif total is not None:
            self.threshold = default_threshold(total)
        else:
            self.threshold = max(1, len(self.keys))
        self.members: Optional[List[bytes]] = (
            sorted(_to_key(m) for m in members) if members is not None
            else None
        )
        if self.members is not None:
            n = len(self.members)
            f = (n - 1) // 3
            self.quorum = int(quorum) if quorum else 2 * f + 1
        else:
            self.quorum = int(quorum) if quorum else 0

    def verify(self, cert: Certificate) -> dict:
        """Returns a verdict dict: ``ok`` plus ``valid`` (distinct
        members with verified co-signatures), ``need``, and a
        ``reason`` when rejected."""
        try:
            scheme = get_scheme(cert.scheme)
            sigs = scheme.split(cert.sigs)
        except ValueError as exc:
            return {"ok": False, "valid": 0, "need": 0, "reason": str(exc)}
        preimage = cert.preimage()

        if self.members is not None:
            ranks = cert.signer_ranks()
            if len(ranks) != len(sigs):
                return {
                    "ok": False, "valid": 0, "need": self.quorum,
                    "reason": "bitmap popcount != signature count",
                }
            if ranks and ranks[-1] >= len(self.members):
                return {
                    "ok": False, "valid": 0, "need": self.quorum,
                    "reason": "bitmap names a rank outside the member list",
                }
            valid = 0
            for rank, sig in zip(ranks, sigs):
                if not scheme.verify_cosig(
                    self.members[rank], preimage, sig
                ):
                    return {
                        "ok": False, "valid": valid, "need": self.quorum,
                        "reason": f"invalid co-signature at rank {rank}",
                    }
                valid += 1
            if valid < self.quorum:
                return {
                    "ok": False, "valid": valid, "need": self.quorum,
                    "reason": "below quorum",
                }
            return {"ok": True, "valid": valid, "need": self.quorum}

        # subset mode: each known key may claim at most one signature,
        # each signature at most one key
        unmatched = list(self.keys)
        valid = 0
        for sig in sigs:
            for i, key in enumerate(unmatched):
                if scheme.verify_cosig(key, preimage, sig):
                    unmatched.pop(i)
                    valid += 1
                    break
            if valid >= self.threshold:
                return {"ok": True, "valid": valid, "need": self.threshold}
        return {
            "ok": False, "valid": valid, "need": self.threshold,
            "reason": "not enough known co-signers",
        }


def verify_chain(certs: Sequence[Certificate], verifier: LightVerifier) -> dict:
    """Verify an ordered certificate chain (oldest first): every
    certificate must pass the verifier, and the informational progress
    coordinates (epoch, commits) must be non-decreasing — a served
    chain that rolls either back is evidence of tampering."""
    prev_epoch = -1
    prev_commits = -1
    for i, cert in enumerate(certs):
        verdict = verifier.verify(cert)
        if not verdict["ok"]:
            return {"ok": False, "index": i, **verdict}
        if cert.epoch < prev_epoch or (
            cert.epoch == prev_epoch and cert.commits < prev_commits
        ):
            return {
                "ok": False, "index": i, "valid": verdict["valid"],
                "need": verdict["need"],
                "reason": "chain progress rolled back",
            }
        prev_epoch, prev_commits = cert.epoch, cert.commits
    return {"ok": True, "count": len(certs)}

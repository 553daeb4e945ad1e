"""The general generator: what a cell sends, drawn from ``--seed``.

Everything here is a pure function of the seed and of the traffic file's
parameters, so the generator processes, the harness and the reference
work out the same transfers independently. Signing goes through the
``cryptography`` package (RFC 8032 signatures are deterministic, so a
transfer signed twice carries the same signature); the tampered classes
that need curve arithmetic use the plain reference's.

Tamper classes (phase 3 of the port's smoke run, ``TAMPER_CLASSES``, and
its 8-torsion lanes):

* ``r_flip``, ``s_flip``: one bit of R or S flipped;
* ``msg_flip``: the signature of another message;
* ``high_s``: S + L in place of S (RFC 8032 refuses S >= L);
* ``noncanonical_y``: a key encoded with y = p + 1, which names the
  identity only if y is reduced mod p (RFC 8032 refuses y >= p), signed
  so that the equation holds for that identity;
* ``x0_sign``: the key y = 1 with the sign bit set (x = 0 may not carry
  it), signed likewise;
* ``wrong_len``: a 63-byte signature (or a 31-byte key in a replay);
* ``r_torsion``: R plus a point of order 8, S adjusted so that the
  cofactored equation holds and the cofactorless one does not;
* ``a_torsion`` (replay only): a key plus a point of order 8; valid
  under the cofactorless equation only when 8 divides the challenge.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Optional, Sequence, Tuple

from cryptography.hazmat.primitives import serialization
from cryptography.hazmat.primitives.asymmetric import ed25519 as _ossl

from benchmark.reference import ed25519 as ref

# the port's wire contract for a transfer's signed bytes (at2.proto's
# SendAssetRequest.signature): tag || sender || sequence (u32 LE) ||
# recipient || amount (u64 LE)
TRANSFER_SIG_TAG = b"at2-node-tpu/transfer/v2"

_RAW = serialization.Encoding.Raw
_RAW_PUB = serialization.PublicFormat.Raw
_TORSION = None


def signing_bytes(sender: bytes, sequence: int, recipient: bytes, amount: int) -> bytes:
    return TRANSFER_SIG_TAG + sender + struct.pack("<I", sequence) + recipient + struct.pack("<Q", amount)


def draw(seed: int, *parts) -> int:
    """64 seeded bits for the tuple ``parts``."""
    text = "/".join(str(p) for p in (seed,) + parts).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little")


def torsion():
    global _TORSION
    if _TORSION is None:
        _TORSION = ref.torsion_point()
    return _TORSION


class Key:
    """A client key from a 32-byte seed: signing through OpenSSL, the
    secret scalar for the classes that need it."""

    __slots__ = ("seed", "public", "_key", "_scalar")

    def __init__(self, seed32: bytes) -> None:
        self.seed = seed32
        self._key = _ossl.Ed25519PrivateKey.from_private_bytes(seed32)
        self.public = self._key.public_key().public_bytes(_RAW, _RAW_PUB)
        self._scalar = None

    def sign(self, message: bytes) -> bytes:
        return self._key.sign(message)

    @property
    def scalar(self) -> int:
        if self._scalar is None:
            self._scalar = ref.secret_scalar(self.seed)
        return self._scalar


def key(seed: int, role: str, index: int) -> Key:
    return Key(hashlib.sha512(f"at2-bench/{role}/{seed}/{index}".encode()).digest()[:32])


# -- the net cells: clients in a ring, contiguous sequences --------------


def amount_of(seed: int, client: int, sequence: int, amounts: Sequence[int]) -> int:
    return amounts[draw(seed, "amount", client, sequence) % len(amounts)]


def transfer(seed: int, publics: Sequence[bytes], client: int, sequence: int,
             amounts: Sequence[int]) -> Tuple[bytes, int, bytes, int]:
    """Client ``client``'s transfer ``sequence``: to the next client of the
    ring, an amount drawn from ``amounts``."""
    return (publics[client], sequence, publics[(client + 1) % len(publics)],
            amount_of(seed, client, sequence, amounts))


def twin_class(seed: int, client: int, sequence: int, share: float,
               classes: Sequence[str]) -> Optional[str]:
    """The tamper class of the twin sent before transfer ``sequence`` of
    ``client``, or None (about ``share`` of transfers have one)."""
    if draw(seed, "twin", client, sequence) >= share * 2.0**64:
        return None
    return classes[draw(seed, "class", client, sequence) % len(classes)]


CRAFTED_KEYS = {
    "noncanonical_y": (ref.P + 1).to_bytes(32, "little"),
    "x0_sign": (1 | (1 << 255)).to_bytes(32, "little"),
}


def crafted(kind: str, r: int, message: bytes) -> Tuple[bytes, bytes]:
    """(key, signature) of class ``kind``: the key names the identity if it
    is decoded leniently, R = [r]B and S = r, so the equation holds for
    any message under lenient decoding."""
    r %= ref.L
    return CRAFTED_KEYS[kind], ref.encode(ref.mul(r, ref.BASE)) + r.to_bytes(32, "little")


def r_torsion(k: Key, message: bytes) -> bytes:
    """A signature of ``message`` by ``k`` whose R carries a point of
    order 8: the cofactored equation holds, the cofactorless one fails."""
    sig = k.sign(message)
    r_pt = ref.decode(sig[:32])
    r2 = ref.encode(ref.add(r_pt, torsion()))
    h = ref.challenge(sig[:32], k.public, message)
    h2 = ref.challenge(r2, k.public, message)
    s = (int.from_bytes(sig[32:], "little") + (h2 - h) * k.scalar) % ref.L
    return r2 + s.to_bytes(32, "little")


def tampered(cls: str, k: Key, message: bytes, other: bytes, r: int):
    """(key, message, signature) of class ``cls`` built on a transfer by
    ``k``; ``other`` is a second message, ``r`` a seeded scalar."""
    if cls == "r_flip":
        sig = k.sign(message)
        return k.public, message, bytes([sig[0] ^ 1]) + sig[1:]
    if cls == "s_flip":
        sig = k.sign(message)
        return k.public, message, sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
    if cls == "msg_flip":
        return k.public, message, k.sign(other)
    if cls == "high_s":
        sig = k.sign(message)
        s = int.from_bytes(sig[32:], "little") + ref.L
        return k.public, message, sig[:32] + s.to_bytes(32, "little")
    if cls in CRAFTED_KEYS:
        pk, sig = crafted(cls, r, message)
        return pk, message, sig
    if cls == "wrong_len":
        return k.public, message, k.sign(message)[:63]
    if cls == "r_torsion":
        return k.public, message, r_torsion(k, message)
    raise ValueError(f"unknown tamper class {cls!r}")


def net_twin(seed: int, clients: Sequence[Key], client: int, sequence: int, cls: str,
             amounts: Sequence[int]):
    """The tampered twin of a client's transfer: (sender, sequence,
    recipient, amount, signature). It carries another amount than the
    transfer it shadows; a crafted-key twin is a transfer of 1 from that
    key (sequence 1) to the client."""
    publics = [k.public for k in clients]
    sender, seq, recipient, amount = transfer(seed, publics, client, sequence, amounts)
    k = clients[client]
    r = draw(seed, "r", client, sequence) | (draw(seed, "r2", client, sequence) << 64)
    if cls in CRAFTED_KEYS:
        pk = CRAFTED_KEYS[cls]
        _, sig = crafted(cls, r, signing_bytes(pk, 1, k.public, 1))
        return pk, 1, k.public, 1, sig
    message = signing_bytes(sender, seq, recipient, amount + 1)
    original = signing_bytes(sender, seq, recipient, amount)
    _, _, sig = tampered(cls, k, message, original, r)
    return sender, seq, recipient, amount + 1, sig


# -- the replay: a seeded trace of distinct signed transfers -------------


def replay_entry(seed: int, senders: Sequence[Key], index: int, share: float,
                 classes: Sequence[str]):
    """Entry ``index`` of the trace: (key, message, signature, class or
    None, expected verdict). Sender ``index mod n`` at sequence ``index //
    n + 1``, to another sender, an amount of 1-4,999."""
    n = len(senders)
    c, seq = index % n, index // n + 1
    k = senders[c]
    recipient = senders[(c + 1 + draw(seed, "to", index) % (n - 1)) % n].public
    amount = 1 + draw(seed, "amount", index) % 4999
    message = signing_bytes(k.public, seq, recipient, amount)
    cls = None
    if draw(seed, "tamper", index) < share * 2.0**64:
        cls = classes[draw(seed, "class", index) % len(classes)]
    if cls is None:
        return k.public, message, k.sign(message), None, True
    r = draw(seed, "r", index) | (draw(seed, "r2", index) << 64)
    if cls == "a_torsion":
        a = ref.add(ref.mul(k.scalar, ref.BASE), torsion())
        a_enc = ref.encode(a)
        r %= ref.L
        r_enc = ref.encode(ref.mul(r, ref.BASE))
        h = ref.challenge(r_enc, a_enc, message)
        s = (r + h * k.scalar) % ref.L
        # [S]B = R + [h]A' exactly when [h]T is the identity: 8 divides h
        return a_enc, message, r_enc + s.to_bytes(32, "little"), cls, h % 8 == 0
    if cls == "wrong_len" and index % 2:
        return k.public[:31], message, k.sign(message), cls, False
    other = signing_bytes(k.public, seq, recipient, amount + 1)
    pk, msg, sig = tampered(cls, k, message, other, r)
    return pk, msg, sig, cls, False


def replay_block(args) -> List[tuple]:
    """Entries [lo, hi) of the trace (a worker process's share)."""
    seed, n_senders, lo, hi, share, classes = args
    senders = [key(seed, "sender", i) for i in range(n_senders)]
    return [replay_entry(seed, senders, i, share, classes) for i in range(lo, hi)]

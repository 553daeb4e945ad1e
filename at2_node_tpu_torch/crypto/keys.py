"""ed25519 signing keys: :class:`SignKeyPair` and :func:`verify_one`.

Counterpart of the signing half of ``at2_node_tpu/crypto/keys.py`` (the
X25519 channel keys come with the network layer). Single signatures use the
``cryptography`` wheel (OpenSSL) when it is installed, else the pure-Python
RFC 8032 transcription in ``crypto/_fallback.py`` (same algorithm, same
bytes). Keys are hex-encoded in config files.
"""

from __future__ import annotations

from dataclasses import dataclass

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import ed25519

    _HAVE_OPENSSL = True
    _RAW = serialization.Encoding.Raw
    _RAW_PUB = serialization.PublicFormat.Raw
    _RAW_PRIV = serialization.PrivateFormat.Raw
    _NOENC = serialization.NoEncryption()
except ImportError:  # image without the OpenSSL wheels: RFC fallback
    from ._fallback import InvalidSignature  # noqa: F401 (re-exported)

    _HAVE_OPENSSL = False

from . import _fallback as _fb


@dataclass(frozen=True)
class SignKeyPair:
    """ed25519 keypair; signs the canonical byte form of messages.

    The OpenSSL key object and the derived public bytes are cached on
    first use: ``from_private_bytes`` re-derives the public point on every
    call, so rebuilding it per sign() would double the cost of signing."""

    private_bytes: bytes  # 32-byte seed

    @staticmethod
    def random() -> "SignKeyPair":
        if not _HAVE_OPENSSL:
            return SignKeyPair(_fb.ed25519_generate_seed())
        key = ed25519.Ed25519PrivateKey.generate()
        return SignKeyPair(key.private_bytes(_RAW, _RAW_PRIV, _NOENC))

    @staticmethod
    def from_hex(s: str) -> "SignKeyPair":
        return SignKeyPair(bytes.fromhex(s))

    def to_hex(self) -> str:
        return self.private_bytes.hex()

    def _key(self) -> "ed25519.Ed25519PrivateKey":
        cached = self.__dict__.get("_key_obj")
        if cached is None:
            cached = ed25519.Ed25519PrivateKey.from_private_bytes(
                self.private_bytes
            )
            object.__setattr__(self, "_key_obj", cached)
        return cached

    @property
    def public(self) -> bytes:
        cached = self.__dict__.get("_pub")
        if cached is None:
            if _HAVE_OPENSSL:
                cached = self._key().public_key().public_bytes(_RAW, _RAW_PUB)
            else:
                cached = _fb.ed25519_public(self.private_bytes)
            object.__setattr__(self, "_pub", cached)
        return cached

    def sign(self, message: bytes) -> bytes:
        if not _HAVE_OPENSSL:
            return _fb.ed25519_sign(self.private_bytes, message)
        return self._key().sign(message)


def verify_one(public_key: bytes, message: bytes, signature: bytes) -> bool:
    """Single CPU ed25519 verification; the batched GPU path is
    ``ops.ed25519.verify_batch``."""
    try:
        if _HAVE_OPENSSL:
            ed25519.Ed25519PublicKey.from_public_bytes(public_key).verify(
                signature, message
            )
        else:
            _fb.ed25519_verify(public_key, message, signature)
        return True
    except (InvalidSignature, ValueError):
        return False

"""ed25519 signing keys and X25519 network (channel) keys.

Counterpart of ``at2_node_tpu/crypto/keys.py``: :class:`SignKeyPair`,
:func:`verify_one` and :class:`ExchangeKeyPair`. Single signatures and key
exchanges use the ``cryptography`` wheel (OpenSSL) when it is installed,
else the pure-Python RFC transcriptions in ``crypto/_fallback.py`` (same
algorithms, same bytes). Keys are hex-encoded in config files.
"""

from __future__ import annotations

from dataclasses import dataclass

try:
    from cryptography.exceptions import InvalidSignature
    from cryptography.hazmat.primitives import serialization
    from cryptography.hazmat.primitives.asymmetric import ed25519, x25519

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


@dataclass(frozen=True)
class ExchangeKeyPair:
    """X25519 keypair authenticating node<->node channels."""

    private_bytes: bytes

    @staticmethod
    def random() -> "ExchangeKeyPair":
        if not _HAVE_OPENSSL:
            return ExchangeKeyPair(_fb.x25519_generate_seed())
        key = x25519.X25519PrivateKey.generate()
        return ExchangeKeyPair(key.private_bytes(_RAW, _RAW_PRIV, _NOENC))

    @staticmethod
    def from_hex(s: str) -> "ExchangeKeyPair":
        return ExchangeKeyPair(bytes.fromhex(s))

    def to_hex(self) -> str:
        return self.private_bytes.hex()

    @property
    def public(self) -> bytes:
        if not _HAVE_OPENSSL:
            return _fb.x25519_public(self.private_bytes)
        key = x25519.X25519PrivateKey.from_private_bytes(self.private_bytes)
        return key.public_key().public_bytes(_RAW, _RAW_PUB)

    def exchange(self, peer_public: bytes) -> bytes:
        if not _HAVE_OPENSSL:
            return _fb.x25519(self.private_bytes, peer_public)
        key = x25519.X25519PrivateKey.from_private_bytes(self.private_bytes)
        return key.exchange(x25519.X25519PublicKey.from_public_bytes(peer_public))

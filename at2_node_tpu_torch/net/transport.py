"""Authenticated encrypted TCP channels between nodes.

Counterpart of ``at2_node_tpu/net/transport.py``, on the wire byte for
byte, so a node of this package and a node of the reference complete the
handshake and read each other's frames. The equivalent of drop's network
plane (`at2-node/src/bin/server/rpc.rs:18,82-86`: `TcpListener::new(addr,
Exchanger)`, `ResolveConnector(TcpConnector).retry()`): asyncio TCP
streams with an X25519 key-exchange handshake and per-frame
ChaCha20-Poly1305 encryption, so a node only ever talks to peers it can
authenticate by their configured network public key
(`at2-node/src/bin/server/config.rs:29-33`).

Handshake (one round trip):

1. each side sends its raw 32-byte X25519 public key followed by a fresh
   32-byte random nonce;
2. both compute the static-static ECDH shared secret (authenticating the
   peer) and derive two directional session keys via HKDF-SHA256, salted
   with BOTH random nonces — so every connection gets fresh keys even
   between the same long-term key pair (no (key, nonce) reuse across
   reconnects, and frames recorded from an old connection cannot be
   replayed into a new one); the `info` string binds each key to the
   initiator→responder / responder→initiator direction, so the two
   directions never share (key, nonce) space either;
3. every subsequent frame is `u32-LE ciphertext length || ciphertext`
   where ciphertext = ChaCha20-Poly1305(plaintext) under the sending
   direction's key with a little-endian frame-counter nonce.

The receiving side learns the peer's identity (its exchange public key)
from the handshake and the caller checks it against the configured peer
set — an unknown key is rejected before any frame is processed.
"""

from __future__ import annotations

import asyncio
import os
import struct
from dataclasses import dataclass, field

try:
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives import hashes
    from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305
    from cryptography.hazmat.primitives.kdf.hkdf import HKDF

    def _hkdf32(shared: bytes, salt: bytes, info: bytes) -> bytes:
        return HKDF(
            algorithm=hashes.SHA256(), length=32, salt=salt, info=info
        ).derive(shared)

except ImportError:  # image without the OpenSSL wheels: RFC fallback
    from ..crypto._fallback import ChaCha20Poly1305, InvalidTag

    def _hkdf32(shared: bytes, salt: bytes, info: bytes) -> bytes:
        from ..crypto._fallback import hkdf_sha256

        return hkdf_sha256(shared, salt, info, 32)

from ..crypto.keys import ExchangeKeyPair

MAX_FRAME = 16 * 1024 * 1024  # hard cap; a frame is at most a message batch

_LEN = struct.Struct("<I")
_NONCE = struct.Struct("<Q")


class HandshakeError(Exception):
    pass


class ChannelClosed(Exception):
    pass


def _derive(
    shared: bytes,
    initiator_pub: bytes,
    responder_pub: bytes,
    initiator_nonce: bytes,
    responder_nonce: bytes,
) -> tuple:
    """Two directional ChaCha20-Poly1305 keys from the ECDH secret; the
    per-connection nonces make the keys unique per connection."""

    def one(direction: bytes) -> bytes:
        return _hkdf32(
            shared,
            initiator_pub + responder_pub + initiator_nonce + responder_nonce,
            b"at2-node-tpu channel " + direction,
        )

    return one(b"i2r"), one(b"r2i")


@dataclass(eq=False)  # identity hash: channels live in a set
class Channel:
    """One encrypted, authenticated duplex connection to a peer."""

    reader: asyncio.StreamReader
    writer: asyncio.StreamWriter
    peer_public: bytes  # the peer's X25519 key, proven by the handshake
    _send_aead: ChaCha20Poly1305
    _recv_aead: ChaCha20Poly1305
    _send_ctr: int = 0
    _recv_ctr: int = 0
    _send_lock: asyncio.Lock = field(default_factory=asyncio.Lock)

    async def send(self, payload: bytes) -> None:
        async with self._send_lock:
            nonce = _NONCE.pack(self._send_ctr) + b"\x00\x00\x00\x00"
            self._send_ctr += 1
            ct = self._send_aead.encrypt(nonce, payload, None)
            self.writer.write(_LEN.pack(len(ct)) + ct)
            try:
                await self.writer.drain()
            except ConnectionError as exc:
                raise ChannelClosed(str(exc)) from exc

    async def recv(self) -> bytes:
        try:
            header = await self.reader.readexactly(_LEN.size)
            (length,) = _LEN.unpack(header)
            if length > MAX_FRAME:
                # post-handshake garbage (attacker or corruption), same
                # class as a bad AEAD tag below: channel-fatal, normal drop
                raise ChannelClosed(f"oversized frame: {length}")
            ct = await self.reader.readexactly(length)
        except (asyncio.IncompleteReadError, ConnectionError) as exc:
            raise ChannelClosed(str(exc)) from exc
        nonce = _NONCE.pack(self._recv_ctr) + b"\x00\x00\x00\x00"
        self._recv_ctr += 1
        try:
            return self._recv_aead.decrypt(nonce, ct, None)
        except InvalidTag as exc:
            # a frame failing the AEAD tag is wire corruption or an active
            # attacker: protocol-fatal for the channel, but NOT an internal
            # error — callers (the mesh) treat ChannelClosed as a normal
            # drop/redial, so on-path garbage cannot traceback-spam logs.
            # (ONLY InvalidTag: anything else here is a real bug and must
            # surface loudly, not be laundered into a silent redial.)
            raise ChannelClosed("integrity check failed") from exc

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:
            pass


async def _swap_hello(
    reader: asyncio.StreamReader, writer: asyncio.StreamWriter, own_public: bytes
) -> tuple:
    """Exchange (public key, connection nonce); returns the peer's pair."""
    own_nonce = os.urandom(32)
    writer.write(own_public + own_nonce)
    await writer.drain()
    try:
        hello = await reader.readexactly(64)
    except (asyncio.IncompleteReadError, ConnectionError) as exc:
        raise HandshakeError(f"peer closed during handshake: {exc}") from exc
    return own_nonce, hello[:32], hello[32:]


def _shared_or_raise(keypair: ExchangeKeyPair, peer_public: bytes) -> bytes:
    try:
        return keypair.exchange(peer_public)
    except ValueError as exc:  # low-order / malformed point
        raise HandshakeError(f"bad peer key: {exc}") from exc


def responder_session_keys(
    keypair: ExchangeKeyPair, own_nonce: bytes, hello: bytes
) -> tuple:
    """Responder-side key material from the peer's 64-byte hello: returns
    (peer_public, k_i2r, k_r2i). THE one implementation — used by both
    the asyncio accept path below and the native-reader accept path
    (net/peers.py), so the two inbound planes can never drift."""
    peer_public, peer_nonce = hello[:32], hello[32:64]
    shared = _shared_or_raise(keypair, peer_public)
    k_i2r, k_r2i = _derive(
        shared, peer_public, keypair.public, peer_nonce, own_nonce
    )
    return peer_public, k_i2r, k_r2i


async def connect(
    host: str, port: int, keypair: ExchangeKeyPair, timeout: float = 5.0
) -> Channel:
    """Dial a peer (initiator role). DNS names resolve via the OS — the
    equivalent of drop's ResolveConnector
    (`at2-node/tests/server-config-resolve-addrs:5-8`)."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout
    )
    try:
        own_nonce, peer_public, peer_nonce = await asyncio.wait_for(
            _swap_hello(reader, writer, keypair.public), timeout
        )
        shared = _shared_or_raise(keypair, peer_public)
        k_i2r, k_r2i = _derive(
            shared, keypair.public, peer_public, own_nonce, peer_nonce
        )
    except Exception:
        writer.close()
        raise
    return Channel(
        reader,
        writer,
        peer_public,
        _send_aead=ChaCha20Poly1305(k_i2r),
        _recv_aead=ChaCha20Poly1305(k_r2i),
    )


async def accept(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    keypair: ExchangeKeyPair,
    timeout: float = 5.0,
) -> Channel:
    """Complete the responder side of the handshake on an inbound socket.
    On any failure the socket is closed before the error propagates."""
    try:
        own_nonce, peer_public, peer_nonce = await asyncio.wait_for(
            _swap_hello(reader, writer, keypair.public), timeout
        )
        peer_public, k_i2r, k_r2i = responder_session_keys(
            keypair, own_nonce, peer_public + peer_nonce
        )
    except Exception:
        writer.close()
        raise
    return Channel(
        reader,
        writer,
        peer_public,
        _send_aead=ChaCha20Poly1305(k_r2i),
        _recv_aead=ChaCha20Poly1305(k_i2r),
    )

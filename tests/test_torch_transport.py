"""The port's encrypted node-to-node channels (``net/transport.py``) and
the crypto under them (``crypto/_fallback.py`` X25519, ChaCha20-Poly1305,
HKDF-SHA256; ``crypto/keys.py`` ``ExchangeKeyPair``) against the JAX
package's and the ``cryptography`` wheel's: a port channel and a reference
channel complete the handshake in both directions and carry frames both
ways; a tampered frame, a low-order peer key and a frame replayed from an
old connection are rejected."""

import asyncio

import numpy as np
import pytest
from cryptography.hazmat.primitives import hashes
from cryptography.hazmat.primitives.asymmetric import x25519
from cryptography.hazmat.primitives.ciphers.aead import ChaCha20Poly1305 as WheelAead
from cryptography.hazmat.primitives.kdf.hkdf import HKDF

from at2_node_tpu.crypto import _fallback as ref_fb
from at2_node_tpu.crypto.keys import ExchangeKeyPair as RefExchangeKeyPair
from at2_node_tpu.net import transport as ref_transport
from at2_node_tpu_torch.crypto import _fallback as fb
from at2_node_tpu_torch.crypto import keys as port_keys
from at2_node_tpu_torch.crypto.keys import ExchangeKeyPair
from at2_node_tpu_torch.net import transport

TRANSPORTS = {"ref": (ref_transport, RefExchangeKeyPair), "port": (transport, ExchangeKeyPair)}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_x25519_equals_the_reference_and_openssl(seed):
    rng = np.random.default_rng(seed)
    a, b = rng.bytes(32), rng.bytes(32)
    pub_a = fb.x25519_public(a)
    wheel_a = x25519.X25519PrivateKey.from_private_bytes(a)
    assert pub_a == ref_fb.x25519_public(a) == wheel_a.public_key().public_bytes_raw()
    shared = fb.x25519(b, pub_a)
    assert shared == ref_fb.x25519(b, pub_a) == fb.x25519(a, fb.x25519_public(b))
    assert shared == x25519.X25519PrivateKey.from_private_bytes(b).exchange(
        x25519.X25519PublicKey.from_public_bytes(pub_a))
    kp = ExchangeKeyPair(a)
    assert kp.public == pub_a == RefExchangeKeyPair(a).public
    assert kp.exchange(fb.x25519_public(b)) == shared
    assert ExchangeKeyPair.from_hex(kp.to_hex()) == kp


def test_x25519_low_order_point_raises():
    with pytest.raises(ValueError):
        fb.x25519(bytes(range(32)), b"\x00" * 32)
    with pytest.raises(ValueError):
        ExchangeKeyPair(bytes(range(32))).exchange(b"\x00" * 32)


@pytest.mark.parametrize("size", [0, 1, 63, 64, 65, 1000, 70_000])
def test_chacha20_poly1305_equals_the_reference_and_openssl(size):
    rng = np.random.default_rng(size)
    key, nonce, data, aad = rng.bytes(32), rng.bytes(12), rng.bytes(size), rng.bytes(size % 17)
    ct = fb.ChaCha20Poly1305(key).encrypt(nonce, data, aad)
    assert ct == ref_fb.ChaCha20Poly1305(key).encrypt(nonce, data, aad)
    assert ct == WheelAead(key).encrypt(nonce, data, aad)
    assert fb.ChaCha20Poly1305(key).decrypt(nonce, ct, aad) == data
    bad = bytearray(ct)
    bad[size // 2] ^= 1
    with pytest.raises(fb.InvalidTag):
        fb.ChaCha20Poly1305(key).decrypt(nonce, bytes(bad), aad)


@pytest.mark.parametrize("length", [16, 32, 42, 100])
def test_hkdf_sha256_equals_the_reference_and_openssl(length):
    rng = np.random.default_rng(length)
    ikm, salt, info = rng.bytes(32), rng.bytes(128), b"at2-node-tpu channel i2r"
    out = fb.hkdf_sha256(ikm, salt, info, length)
    assert out == ref_fb.hkdf_sha256(ikm, salt, info, length)
    assert out == HKDF(algorithm=hashes.SHA256(), length=length, salt=salt, info=info).derive(ikm)
    # an empty salt is RFC 5869's string of zeros
    assert fb.hkdf_sha256(ikm, b"", info, 32) == ref_fb.hkdf_sha256(ikm, b"", info, 32) == \
        HKDF(algorithm=hashes.SHA256(), length=32, salt=None, info=info).derive(ikm)


def test_session_keys_equal_the_reference():
    rng = np.random.default_rng(9)
    args = (rng.bytes(32), rng.bytes(32), rng.bytes(32), rng.bytes(32), rng.bytes(32))
    assert transport._derive(*args) == ref_transport._derive(*args)
    kp = ExchangeKeyPair(rng.bytes(32))
    hello = fb.x25519_public(rng.bytes(32)) + rng.bytes(32)
    nonce = rng.bytes(32)
    assert transport.responder_session_keys(kp, nonce, hello) == \
        ref_transport.responder_session_keys(RefExchangeKeyPair(kp.private_bytes), nonce, hello)
    assert transport.MAX_FRAME == ref_transport.MAX_FRAME


@pytest.mark.parametrize("initiator,responder", [("port", "ref"), ("ref", "port"), ("port", "port")])
async def test_channels_interoperate(initiator, responder):
    """Handshake, then frames both ways, across the two packages."""
    (t_i, K_i), (t_r, K_r) = TRANSPORTS[initiator], TRANSPORTS[responder]
    rng = np.random.default_rng([len(initiator), len(responder)])
    kp_i, kp_r = K_i(rng.bytes(32)), K_r(rng.bytes(32))
    frames = [b"", b"hello over the wire", rng.bytes(70_000)]
    got = asyncio.get_running_loop().create_future()

    async def on_conn(reader, writer):
        ch = await t_r.accept(reader, writer, kp_r)
        received = [await ch.recv() for _ in frames]
        for f in frames:
            await ch.send(f[::-1])
        got.set_result((ch.peer_public, received))
        ch.close()

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    ch = await t_i.connect("127.0.0.1", port, kp_i)
    try:
        assert ch.peer_public == kp_r.public
        for f in frames:
            await ch.send(f)
        peer_public, received = await asyncio.wait_for(got, 10)
        assert peer_public == kp_i.public and received == frames
        assert [await ch.recv() for _ in frames] == [f[::-1] for f in frames]
    finally:
        ch.close()
        server.close()


async def _responder(outcomes):
    kp = ExchangeKeyPair(bytes(range(1, 33)))

    async def on_conn(reader, writer):
        try:
            ch = await transport.accept(reader, writer, kp)
        except Exception as exc:
            await outcomes.put(("handshake", type(exc).__name__))
            return
        try:
            await outcomes.put(("ok", await ch.recv()))
        except Exception as exc:
            await outcomes.put(("recv", type(exc).__name__))
        finally:
            ch.close()

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    return server, server.sockets[0].getsockname()[1]


async def test_tampered_frame_rejected():
    outcomes = asyncio.Queue()
    server, port = await _responder(outcomes)
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(ExchangeKeyPair(bytes(32)).public + b"\x07" * 32)
    await reader.readexactly(64)
    writer.write(b"\x10\x00\x00\x00" + b"Z" * 16)  # never AEAD-encrypted
    await writer.drain()
    assert await asyncio.wait_for(outcomes.get(), 5) == ("recv", "ChannelClosed")
    writer.close()
    server.close()


async def test_low_order_peer_key_rejected():
    outcomes = asyncio.Queue()
    server, port = await _responder(outcomes)
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(b"\x00" * 32 + b"\x01" * 32)
    await writer.drain()
    assert await asyncio.wait_for(outcomes.get(), 5) == ("handshake", "HandshakeError")
    writer.close()
    server.close()


async def test_replayed_frame_from_old_connection_rejected():
    outcomes = asyncio.Queue()
    server, port = await _responder(outcomes)
    client = ExchangeKeyPair(bytes(range(2, 34)))
    ch = await transport.connect("127.0.0.1", port, client)
    wire = bytearray()
    write = ch.writer.write
    ch.writer.write = lambda data: (wire.extend(data), write(data))
    await ch.send(b"secret message")
    ch.writer.write = write
    assert await asyncio.wait_for(outcomes.get(), 5) == ("ok", b"secret message")
    ch.close()
    # a new connection with the same static keys gets fresh session keys
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(client.public + b"\x05" * 32)
    await reader.readexactly(64)
    writer.write(bytes(wire))
    await writer.drain()
    assert await asyncio.wait_for(outcomes.get(), 5) == ("recv", "ChannelClosed")
    writer.close()
    server.close()


async def test_oversized_frame_closes_the_channel():
    outcomes = asyncio.Queue()
    server, port = await _responder(outcomes)
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(ExchangeKeyPair(bytes(32)).public + b"\x07" * 32)
    await reader.readexactly(64)
    writer.write((transport.MAX_FRAME + 1).to_bytes(4, "little"))
    await writer.drain()
    assert await asyncio.wait_for(outcomes.get(), 5) == ("recv", "ChannelClosed")
    writer.close()
    server.close()


async def test_fallback_crypto_carries_a_channel(monkeypatch):
    """Without the ``cryptography`` wheel the port's keys and channels run
    on ``_fallback``: the bytes on the wire are the same, so a fallback
    port channel talks to an OpenSSL reference channel."""
    monkeypatch.setattr(port_keys, "_HAVE_OPENSSL", False)
    monkeypatch.setattr(transport, "ChaCha20Poly1305", fb.ChaCha20Poly1305)
    monkeypatch.setattr(transport, "InvalidTag", fb.InvalidTag)
    monkeypatch.setattr(transport, "_hkdf32", lambda s, salt, info: fb.hkdf_sha256(s, salt, info, 32))
    kp_i, kp_r = ExchangeKeyPair(bytes(range(3, 35))), RefExchangeKeyPair(bytes(range(4, 36)))
    got = asyncio.get_running_loop().create_future()

    async def on_conn(reader, writer):
        ch = await ref_transport.accept(reader, writer, kp_r)
        got.set_result(await ch.recv())
        ch.close()

    server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
    ch = await transport.connect("127.0.0.1", server.sockets[0].getsockname()[1], kp_i)
    await ch.send(b"x" * 5000)
    assert await asyncio.wait_for(got, 10) == b"x" * 5000
    ch.close()
    server.close()

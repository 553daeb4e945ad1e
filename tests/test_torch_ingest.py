"""The port's native message-plane ingest (``native/at2_ingest.cpp`` built
by ``native/ingest.py``, and the channel reader of ``native/reader.py``)
against the JAX package's library and against plain Python and numpy:
frame parsing on mixed-kind frames, the batched plane's endorsement
tallies, OpenSSL bulk verify, and the reader thread on a socketpair."""

import os
import select
import socket
import struct

import numpy as np
import pytest

from at2_node_tpu.broadcast import messages as ref_msgs
from at2_node_tpu.broadcast import stack as ref_stack
from at2_node_tpu.crypto.keys import verify_one as ref_verify_one
from at2_node_tpu.native import ingest as ref_ingest
from at2_node_tpu_torch.broadcast import messages as port_msgs
from at2_node_tpu_torch.broadcast import stack as port_stack
from at2_node_tpu_torch.crypto._fallback import ChaCha20Poly1305
from at2_node_tpu_torch.crypto.keys import SignKeyPair, verify_one
from at2_node_tpu_torch.native import _build, ingest, reader

from test_torch_wire import KINDS, build


def test_library_builds_into_the_port_with_the_link_probe():
    assert ingest.ingest_available()
    assert ingest.ingest_ready() and ingest.ingest_ready_or_kick()
    assert ingest._LINK_CANDIDATES == ref_ingest._LINK_CANDIDATES
    assert os.path.exists(os.path.join(_build.BUILD_DIR, "libat2ingest.so"))
    assert _build.BUILD_DIR.startswith(os.path.dirname(os.path.dirname(ingest.__file__)))
    with open(os.path.join(_build.PACKAGE_DIR, "native", "at2_ingest.cpp")) as f:
        port_src = f.read()
    assert "at2_parse_frames" in port_src and "at2_reader_start" in port_src


def test_kill_switch_turns_ingest_off(monkeypatch):
    monkeypatch.setenv("AT2_NO_NATIVE_INGEST", "1")
    assert not ingest.ingest_available() and not ingest.ingest_ready_or_kick()


def _mixed_frames(seed: int) -> list:
    """Frames of 1-6 messages of random kinds, some malformed (a truncated
    tail, an unknown kind, a batch count past the cap)."""
    rng = np.random.default_rng(seed)
    frames = []
    for f in range(24):
        kinds = [KINDS[int(i)] for i in rng.integers(0, len(KINDS), int(rng.integers(1, 7)))]
        frame = b"".join(build("ref", k, seed=int(rng.integers(0, 1 << 30))).encode() for k in kinds)
        bad = int(rng.integers(0, 8))
        if bad == 0:
            frame = frame[:-1]
        elif bad == 1:
            frame += b"\xee" + b"z" * 64
        frames.append(frame)
    return frames


def _python_parse(msgs_mod, frames):
    out, ok = [], []
    for i, frame in enumerate(frames):
        try:
            out.extend((i, m.encode()) for m in msgs_mod.parse_frame(frame))
            ok.append(True)
        except msgs_mod.WireError:
            ok.append(False)
    return out, ok


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_parse_frames_native_equals_the_reference_and_python(seed):
    frames = _mixed_frames(seed)
    parsed, frame_ok = ingest.parse_frames_native(frames)
    ref_parsed, ref_ok = ref_ingest.parse_frames_native(frames)
    got = [(i, m.encode()) for i, m in parsed]
    assert got == [(i, m.encode()) for i, m in ref_parsed]
    assert frame_ok.tolist() == ref_ok.tolist()
    py, py_ok = _python_parse(port_msgs, frames)
    assert got == py and frame_ok.tolist() == py_ok
    assert 0 < sum(py_ok) < len(frames)
    for _, m in parsed:
        assert type(m).__module__ == port_msgs.__name__
        if isinstance(m, port_msgs.Payload):
            # the native pass seeds the content hash; it must be the real one
            assert m.__dict__["_chash"] == port_msgs.Payload.decode_body(m.encode()[1:]).content_hash()


def test_parse_frames_native_dense_control_frames():
    # frames dense with the smallest message take the retry with the true
    # row bound; a frame past the per-frame message cap drops whole
    req = port_msgs.HistoryIndexRequest(3).encode()
    frames = [req * 600, req * (port_msgs.MAX_MSGS_PER_FRAME + 1), build("ref", "GOSSIP").encode()]
    parsed, ok = ingest.parse_frames_native(frames)
    ref_parsed, ref_ok = ref_ingest.parse_frames_native(frames)
    assert ok.tolist() == ref_ok.tolist() == [True, False, True]
    assert [(i, m.encode()) for i, m in parsed] == [(i, m.encode()) for i, m in ref_parsed]
    assert len(parsed) == 601


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counts_add_and_quorum_mask_equal_numpy(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        nbits = int(rng.integers(1, 1025))
        bitmap = rng.bytes((nbits + 7) // 8)
        counts = rng.integers(0, 5, nbits).astype(np.int32)
        want = counts + np.unpackbits(np.frombuffer(bitmap, np.uint8), bitorder="little")[:nbits]
        got = counts.copy()
        folded = ingest.counts_add_native(bitmap, got)
        ref = counts.copy()
        assert folded == ref_ingest.counts_add_native(bitmap, ref)
        assert np.array_equal(got, want) and np.array_equal(ref, want)
        assert folded == int(want.sum() - counts.sum())
        for threshold in (1, 2, 3, 5):
            n = int(rng.integers(1, nbits + 1))
            mask = ingest.quorum_mask_native(got, threshold, n)
            plain = int.from_bytes(np.packbits(got[:n] >= threshold, bitorder="little").tobytes(), "little")
            assert mask == plain == ref_ingest.quorum_mask_native(got, threshold, n)


@pytest.mark.parametrize("native", [True, False])
def test_stack_tallies_equal_the_reference(native, monkeypatch):
    """``_quorate_mask`` and ``_BatchVotes`` take the native path from 16
    entries when the library is loaded, else numpy; both give the
    reference's values."""
    if not native:
        monkeypatch.setenv("AT2_NO_NATIVE_INGEST", "1")
    rng = np.random.default_rng(7)
    votes, ref_votes = port_stack._BatchVotes(), ref_stack._BatchVotes()
    for _ in range(40):
        nbits = int(rng.integers(1, 300))
        origin = bytes([int(rng.integers(0, 4))]) * 32
        bits = int.from_bytes(rng.bytes((nbits + 7) // 8), "little") & ((1 << nbits) - 1)
        assert votes.add(origin, bits, nbits) == ref_votes.add(origin, bits, nbits)
        assert np.array_equal(votes.counts, ref_votes.counts)
        assert votes.by_origin == ref_votes.by_origin
        for threshold in (0, 1, 2, 4):
            assert port_stack._quorate_mask(votes.counts, threshold, nbits) == \
                ref_stack._quorate_mask(ref_votes.counts, threshold, nbits)


def _verify_items(seed: int):
    rng = np.random.default_rng(seed)
    keys = [SignKeyPair(rng.bytes(32)) for _ in range(8)]
    items = []
    for i in range(96):
        kp = keys[i % len(keys)]
        msg = rng.bytes(int(rng.integers(0, 200)))
        sig = kp.sign(msg)
        c = i % 6
        if c == 1:
            sig = bytes([sig[0] ^ 4]) + sig[1:]  # R
        elif c == 2:
            sig = sig[:40] + bytes([sig[40] ^ 1]) + sig[41:]  # S
        elif c == 3:
            msg = msg + b"!"
        elif c == 4:
            sig = sig[:63]  # wrong length
        items.append((kp.public, msg, sig))
    return items


@pytest.mark.parametrize("n_threads", [1, 3])
def test_verify_bulk_native_equals_verify_one(n_threads):
    items = _verify_items(n_threads)
    got = ingest.verify_bulk_native(items, n_threads).tolist()
    assert got == [verify_one(*it) for it in items]
    assert got == [ref_verify_one(*it) for it in items]
    assert got == ref_ingest.verify_bulk_native(items, n_threads).tolist()
    assert 0 < sum(got) < len(items)
    assert ingest.verify_bulk_native([], n_threads).tolist() == []


# -- the channel reader -----------------------------------------------------


def _encrypt_frame(aead, ctr: int, payload: bytes) -> bytes:
    ct = aead.encrypt(struct.pack("<Q", ctr) + b"\x00" * 4, payload, None)
    return struct.pack("<I", len(ct)) + ct


def _drain(rdr, rfd, timeout=5.0):
    r, _, _ = select.select([rfd], [], [], timeout)
    assert r, "reader never woke the pipe"
    os.read(rfd, 65536)
    frames = []
    while True:
        batch, status, _drops = rdr.take()
        frames.extend(batch)
        if not batch:
            return frames, status


@pytest.fixture
def reader_pair():
    key = bytes(range(32))
    a, b = socket.socketpair()
    rfd, wfd = os.pipe()
    os.set_blocking(rfd, False)
    rdr = reader.NativeChannelReader(b.fileno(), key, wfd)
    yield ChaCha20Poly1305(key), a, rdr, rfd
    rdr.stop()
    for fd in (rfd, wfd):
        os.close(fd)
    a.close()
    b.close()


def test_reader_frames_round_trip_then_clean_eof(reader_pair):
    aead, a, rdr, rfd = reader_pair
    payloads = [b"", b"x", os.urandom(1000), os.urandom(5 * 1024 * 1024)]
    a.sendall(b"".join(_encrypt_frame(aead, i, p) for i, p in enumerate(payloads)))
    got = []
    while len(got) < len(payloads):
        frames, status = _drain(rdr, rfd)
        got.extend(frames)
        assert status == reader.STATUS_OPEN
    assert got == payloads
    a.shutdown(socket.SHUT_WR)
    frames, status = _drain(rdr, rfd)
    assert frames == [] and status == reader.STATUS_EOF


def test_reader_oversized_length_is_a_protocol_error(reader_pair):
    _aead, a, rdr, rfd = reader_pair
    a.sendall(struct.pack("<I", 16 * 1024 * 1024 + 1) + b"\x00" * 64)
    frames, status = _drain(rdr, rfd)
    assert frames == [] and status == reader.STATUS_PROTOCOL_ERROR


def test_reader_tampered_frame_is_a_protocol_error(reader_pair):
    aead, a, rdr, rfd = reader_pair
    a.sendall(_encrypt_frame(aead, 0, b"fine"))
    assert _drain(rdr, rfd) == ([b"fine"], reader.STATUS_OPEN)
    bad = bytearray(_encrypt_frame(aead, 1, b"evil"))
    bad[7] ^= 1
    a.sendall(bytes(bad))
    frames, status = _drain(rdr, rfd)
    assert frames == [] and status == reader.STATUS_PROTOCOL_ERROR


@pytest.mark.parametrize("cores,env,want", [
    (1, {}, False),
    (1, {"AT2_FORCE_NATIVE_READER": "1"}, True),
    (8, {}, True),
    (8, {"AT2_NO_NATIVE_READER": "1"}, False),
])
def test_reader_core_count_default_and_overrides(cores, env, want, monkeypatch):
    for var in ("AT2_FORCE_NATIVE_READER", "AT2_NO_NATIVE_READER"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(reader.os, "sched_getaffinity", lambda pid: set(range(cores)), raising=False)
    monkeypatch.setattr(reader.os, "cpu_count", lambda: cores)
    assert reader.reader_default_on() == (cores > 1)
    assert reader.reader_available() == want

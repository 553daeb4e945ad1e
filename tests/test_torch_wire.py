"""The port's wire codec (``at2_node_tpu_torch/broadcast/messages.py``)
against the JAX package's, byte for byte: every one of the 16 message kinds
built from the same seeded keys and fields encodes to the same bytes in
both packages, a frame encoded by either parses in the other and
re-encodes unchanged, the signing preimages and domain tags are equal, and
truncated or oversized frames raise ``WireError`` in both."""

import dataclasses
import struct

import numpy as np
import pytest

from at2_node_tpu.broadcast import messages as ref_msgs
from at2_node_tpu.crypto.keys import SignKeyPair as RefSignKeyPair
from at2_node_tpu_torch.broadcast import messages as port_msgs
from at2_node_tpu_torch.crypto.keys import SignKeyPair as PortSignKeyPair

PKGS = {"ref": (ref_msgs, RefSignKeyPair), "port": (port_msgs, PortSignKeyPair)}

KINDS = [
    "GOSSIP", "ECHO", "READY", "REQUEST", "HIST_IDX_REQ", "HIST_IDX",
    "HIST_REQ", "HIST_BATCH", "BATCH", "BATCH_ECHO", "BATCH_READY",
    "BATCH_REQ", "DIR_ANNOUNCE", "CONFIG_TX", "BEACON", "CERT_SIG",
]


def build(pkg: str, kind: str, seed: int = 0):
    """One message of ``kind`` built with ``pkg``'s classes. The seeded
    draws happen in the same order in both packages, and ed25519 signs
    deterministically, so both builds are the same message."""
    m, SK = PKGS[pkg]
    rng = np.random.default_rng([seed, KINDS.index(kind)])
    kp, other = SK(rng.bytes(32)), SK(rng.bytes(32))

    def b(n):
        return rng.bytes(n)

    def payload(seq):
        return m.Payload.create(kp, seq, m.ThinTransaction(b(32), int(rng.integers(1, 2**40))))

    if kind == "GOSSIP":
        return payload(7)
    if kind in ("ECHO", "READY"):
        phase = getattr(m, kind)
        sender, chash = b(32), b(32)
        sig = kp.sign(m.Attestation.signing_bytes(phase, sender, 9, chash))
        return m.Attestation(phase, kp.public, sender, 9, chash, sig)
    if kind == "REQUEST":
        return m.ContentRequest(b(32), 11, b(32))
    if kind == "HIST_IDX_REQ":
        return m.HistoryIndexRequest(int(rng.integers(0, 2**63)))
    if kind == "HIST_IDX":
        return m.HistoryIndex(5, ((b(32), 3), (b(32), 70000)))
    if kind == "HIST_REQ":
        return m.HistoryRequest(6, b(32), 2, 40)
    if kind == "HIST_BATCH":
        return m.HistoryBatch(8, (payload(1), payload(2), payload(3)))
    if kind == "BATCH":
        return m.TxBatch.create(kp, 42, b"".join(payload(s).encode()[1:] for s in range(1, 6)))
    if kind in ("BATCH_ECHO", "BATCH_READY"):
        phase = getattr(m, kind)
        bhash, bitmap = b(32), b(3)
        sig = kp.sign(m.BatchAttestation.signing_bytes(phase, other.public, 42, bhash, bitmap))
        return m.BatchAttestation(phase, kp.public, other.public, 42, bhash, bitmap, sig)
    if kind == "BATCH_REQ":
        return m.BatchContentRequest(other.public, 42, b(32))
    if kind == "DIR_ANNOUNCE":
        return m.DirectoryAnnounce(kp.public, ((1, b(32)), (17, b(32))))
    if kind == "CONFIG_TX":
        return m.ConfigTx.create(kp, 3, {"remove": [other.public.hex()], "grace": 5})
    if kind == "BEACON":
        return m.StateBeacon.create(kp, 1, 100, b(16), b(128), b(8), b(32))
    if kind == "CERT_SIG":
        return m.CertSig.create(kp, 1, 100, b(16), b(128), b(8))
    raise AssertionError(kind)


def fields(msg):
    return type(msg).__name__, dataclasses.astuple(msg)


@pytest.mark.parametrize("kind", KINDS)
def test_both_packages_build_the_same_bytes(kind):
    ref, port = build("ref", kind), build("port", kind)
    assert port.encode() == ref.encode()
    assert port.encode()[0] == getattr(port_msgs, kind) == getattr(ref_msgs, kind)
    assert fields(port) == fields(ref)
    for name in ("to_sign", "content_hash"):
        if callable(getattr(ref, name, None)):
            assert getattr(port, name)() == getattr(ref, name)()
    if kind == "BATCH":
        assert port.signing_bytes() == ref.signing_bytes()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_frames_parse_across_packages_and_reencode(kind, direction):
    src, dst = ("ref", "port") if direction == "ref_to_port" else ("port", "ref")
    frame = build(src, kind).encode()
    [msg] = PKGS[dst][0].parse_frame(frame)
    assert type(msg).__module__ == PKGS[dst][0].__name__
    assert msg.encode() == frame
    assert fields(msg) == fields(build(src, kind))


def test_coalesced_mixed_frame_parses_alike():
    frame = b"".join(build("ref", k, seed=3).encode() for k in KINDS) * 2
    ref = ref_msgs.parse_frame(frame)
    port = port_msgs.parse_frame(frame)
    assert [fields(m) for m in port] == [fields(m) for m in ref]
    assert [type(m).__name__ for m in port[: len(KINDS)]] == [
        type(build("ref", k)).__name__ for k in KINDS
    ]
    assert b"".join(m.encode() for m in port) == frame


def test_static_signing_preimages_and_tags_are_equal():
    names = [n for n in dir(ref_msgs) if n.endswith("_TAG") or n.endswith("_WIRE")
             or n.startswith("MAX_")]
    assert len(names) >= 25
    for name in names:
        assert getattr(port_msgs, name) == getattr(ref_msgs, name), name
    structs = [n for n in dir(ref_msgs) if isinstance(getattr(ref_msgs, n), struct.Struct)]
    for name in structs:
        assert getattr(port_msgs, name).format == getattr(ref_msgs, name).format, name
    for phase in (ref_msgs.ECHO, ref_msgs.READY):
        assert port_msgs.Attestation.signing_bytes(phase, b"s" * 32, 5, b"h" * 32) == \
            ref_msgs.Attestation.signing_bytes(phase, b"s" * 32, 5, b"h" * 32)
    for phase in (ref_msgs.BATCH_ECHO, ref_msgs.BATCH_READY):
        args = (phase, b"o" * 32, 7, b"h" * 32, b"\x05\x01")
        assert port_msgs.BatchAttestation.signing_bytes(*args) == \
            ref_msgs.BatchAttestation.signing_bytes(*args)
    assert port_msgs.ConfigTx.signing_bytes(4, b"{}") == ref_msgs.ConfigTx.signing_bytes(4, b"{}")
    cert = (2, b"w" * 16, b"r" * 128, b"d" * 8)
    assert port_msgs.cert_signing_bytes(*cert) == ref_msgs.cert_signing_bytes(*cert)
    # an Echo's preimage can never be replayed as a Ready
    assert port_msgs.Attestation.signing_bytes(port_msgs.ECHO, b"s" * 32, 1, b"h" * 32) != \
        port_msgs.Attestation.signing_bytes(port_msgs.READY, b"s" * 32, 1, b"h" * 32)


def _raises_in_both(frame: bytes) -> None:
    for m in (ref_msgs, port_msgs):
        with pytest.raises(m.WireError):
            m.parse_frame(frame)


@pytest.mark.parametrize("kind", KINDS)
def test_truncated_frames_raise_in_both(kind):
    frame = build("ref", kind).encode()
    for cut in sorted({1, len(frame) // 2, len(frame) - 1}):
        _raises_in_both(frame[:cut])
    # a valid message followed by a truncated one drops the whole frame
    _raises_in_both(build("ref", "GOSSIP").encode() + frame[:-1])


def test_oversized_frames_raise_in_both():
    m = ref_msgs
    # more messages than a frame may carry
    _raises_in_both(m.HistoryIndexRequest(1).encode() * (m.MAX_MSGS_PER_FRAME + 1))
    assert len(port_msgs.parse_frame(m.HistoryIndexRequest(1).encode() * m.MAX_MSGS_PER_FRAME)) \
        == m.MAX_MSGS_PER_FRAME
    # a batch past the entry cap, and one with no entry
    for count in (m.MAX_BATCH_ENTRIES + 1, 0):
        hdr = bytes([m.BATCH]) + m._BATCH_HDR.pack(b"o" * 32, 1, count, b"s" * 64)
        _raises_in_both(hdr + b"e" * m.ENTRY_WIRE * max(count, 1))
    # a batch attestation bitmap wider than the entry cap allows
    att = build("ref", "BATCH_ECHO")
    wide = dataclasses.replace(att, bitmap=b"\xff" * (m.MAX_BITMAP_BYTES + 1))
    _raises_in_both(wide.encode())
    # a directory announce past its entry cap
    _raises_in_both(bytes([m.DIR_ANNOUNCE]) + m._DIR_HDR.pack(b"o" * 32, m.MAX_DIR_ENTRIES + 1))
    # a config body past its size cap
    _raises_in_both(bytes([m.CONFIG_TX]) + m._CONFIG_HDR.pack(1, m.MAX_CONFIG_BYTES + 1, b"s" * 64)
                    + b"{" * (m.MAX_CONFIG_BYTES + 1))
    # an unknown kind
    _raises_in_both(b"\xff" + b"x" * 200)
    _raises_in_both(bytes([m.CERT_SIG + 1]) + b"x" * 400)

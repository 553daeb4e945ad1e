"""Pins for the browser wallet page (web/wallet.html).

No JS runtime exists in this image, so the page cannot be executed in
CI. The byte-level codec check therefore runs in two halves that meet at
a golden-vector block embedded in the page:

* this test REGENERATES every vector from the server's own protobuf
  bindings (at2_pb2) plus the canonical grpc-web-text framing, and
  byte-compares against the block between the page's GOLDEN-BEGIN/END
  markers — any drift between page, proto, or framing fails CI;
* the page runs `selfTest()` at load, driving its real encoder/decoder
  functions (varint, pbBytes/pbUint, frameB64, pbDecode,
  parseGrpcWebBody) against the same vectors, and DISABLES the wallet
  on mismatch — so the JS half of the contract is enforced by the only
  JS executor in the loop, the user's browser, before any signing.

Also pinned here (pre-existing):

* the PKCS8 prefix the page uses to import raw Ed25519 seeds into
  WebCrypto is byte-identical to the real PKCS8 encoding `cryptography`
  produces — the single most fragile constant on the page (a wrong
  prefix silently derives a different key);
* the signed byte layout the page builds (tag || sender || sequence LE
  || recipient || amount LE) matches types.transfer_signing_bytes, so a
  browser signature verifies server-side;
* the page references the correct service path and content type.
"""

import base64
import json
import os
import re

import pytest

# this module mimics the browser's WebCrypto key handling (PKCS8/SPKI DER),
# which the pure-python fallback deliberately does not implement
cryptography = pytest.importorskip(
    "cryptography", reason="wallet test needs the real cryptography wheel"
)
from cryptography.hazmat.primitives import serialization  # noqa: E402
from cryptography.hazmat.primitives.asymmetric import ed25519  # noqa: E402

from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.proto import at2_pb2 as pb
from at2_node_tpu_torch.types import TRANSFER_SIG_TAG, transfer_signing_bytes

PAGE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "web",
    "wallet.html",
)


def _page() -> str:
    with open(PAGE, encoding="utf-8") as f:
        return f.read()


def test_pkcs8_prefix_matches_real_encoding():
    match = re.search(r'PKCS8_PREFIX = hexToBytes\("([0-9a-f]+)"\)', _page())
    assert match, "PKCS8 prefix constant missing from the page"
    page_prefix = bytes.fromhex(match.group(1))

    seed = bytes(range(32))
    key = ed25519.Ed25519PrivateKey.from_private_bytes(seed)
    pkcs8 = key.private_bytes(
        serialization.Encoding.DER,
        serialization.PrivateFormat.PKCS8,
        serialization.NoEncryption(),
    )
    assert pkcs8 == page_prefix + seed, (
        "the page's PKCS8 wrapper diverges from the real encoding; "
        "WebCrypto importKey would build a different key"
    )


def test_signing_layout_matches_canonical():
    page = _page()
    # the page signs tag || sender || seqLe || recipient || amountLe with
    # LE u32/u64 — the same canonical v2 form transfer_signing_bytes
    # defines, sequence fetched BEFORE signing so it lands in the preimage
    assert 'TextEncoder().encode("at2-node-tpu/transfer/v2")' in page
    assert "setUint32(0, Number(sequence), true)" in page  # little-endian
    assert "setBigUint64(0, amount, true)" in page  # little-endian
    assert (
        "concat(\n    TRANSFER_SIG_TAG, keyPair.publicKey, seqLe, "
        "recipient, amountLe)" in page
    )
    kp = SignKeyPair.from_hex("2b" * 32)
    pre = transfer_signing_bytes(kp.public, 513, b"\x07" * 32, 9)
    assert pre == (
        TRANSFER_SIG_TAG
        + kp.public
        + (513).to_bytes(4, "little")
        + b"\x07" * 32
        + (9).to_bytes(8, "little")
    )
    # a signature over that layout verifies with the repo's own keys
    sig = kp.sign(pre)
    from at2_node_tpu_torch.crypto.keys import verify_one

    assert verify_one(kp.public, pre, sig)


def _expected_golden(pb=pb) -> dict:
    """The vectors as the SERVER's own bindings produce them — the
    oracle the page's embedded block must match byte-for-byte."""
    sender = bytes(range(32))
    recipient = bytes(range(32, 64))
    signature = bytes(range(64, 128))
    sequence = 300
    amount = (1 << 32) + 5

    sa = pb.SendAssetRequest(
        sender=sender, sequence=sequence, recipient=recipient,
        amount=amount, signature=signature,
    ).SerializeToString()
    frame = b"\x00" + len(sa).to_bytes(4, "big") + sa
    reply = pb.GetBalanceReply(amount=100_000).SerializeToString()
    tx = pb.FullTransaction(
        timestamp="2026-07-31T00:00:00Z", sender=sender, recipient=recipient,
        amount=7, state=1, sender_sequence=9,
    ).SerializeToString()
    trailer = b"grpc-status:0\r\n"
    resp_body = (
        b"\x00" + len(reply).to_bytes(4, "big") + reply
        + b"\x80" + len(trailer).to_bytes(4, "big") + trailer
    )

    def var(n: int) -> bytes:
        out = bytearray()
        while True:
            b = n & 0x7F
            n >>= 7
            out.append(b | (0x80 if n else 0))
            if not n:
                return bytes(out)

    return {
        "send_asset": {
            "sender": sender.hex(),
            "sequence": sequence,
            "recipient": recipient.hex(),
            "amount": str(amount),
            "signature": signature.hex(),
            "expect": sa.hex(),
            "expect_frame_b64": base64.b64encode(frame).decode(),
        },
        "get_balance_request": {
            "expect": pb.GetBalanceRequest(sender=sender)
            .SerializeToString()
            .hex()
        },
        "balance_reply": {"bytes": reply.hex(), "amount": "100000"},
        "full_transaction": {
            "bytes": tx.hex(),
            "timestamp": "2026-07-31T00:00:00Z",
            "sender": sender.hex(),
            "recipient": recipient.hex(),
            "amount": "7",
            "state": 1,
            "sender_sequence": "9",
        },
        "response_body_b64": {
            "b64": base64.b64encode(resp_body).decode(),
            "data": reply.hex(),
            "status": 0,
        },
        "varints": [
            [str(n), var(n).hex()]
            for n in [0, 1, 127, 128, 300, (1 << 32) + 5, (1 << 64) - 1]
        ],
    }


def test_golden_vectors_match_at2_pb2_byte_for_byte():
    match = re.search(
        r"/\* GOLDEN-BEGIN \*/\s*(\{.*?\})\s*/\* GOLDEN-END \*/",
        _page(),
        re.DOTALL,
    )
    assert match, "GOLDEN vector block missing from the page"
    embedded = json.loads(match.group(1))
    assert embedded == _expected_golden(), (
        "the page's golden vectors diverge from at2_pb2's byte output — "
        "regenerate the block (tests/test_web_wallet.py _expected_golden)"
    )


def test_self_test_gates_the_wallet():
    """The page must run selfTest() BEFORE wiring any button, and a
    failure must disable the UI — the vectors are only load-bearing if
    their check actually gates operation."""
    page = _page()
    assert "selfTest();" in page
    gate = page.index("selfTest();")
    wiring = page.index('["load", loadKey]')
    assert gate < wiring, "self-test must run before the UI is wired"
    assert '$(id).disabled = true' in page
    # every codec function the wallet uses at runtime appears in the test
    for fn in ("varint(", "pbBytes(", "pbUint(", "pbDecode(",
               "frameB64(", "parseGrpcWebBody("):
        body = page[page.index("function selfTest()"):page.index("try {")]
        assert fn in body, f"selfTest does not exercise {fn}"


def test_page_targets_the_served_surface():
    page = _page()
    assert "/at2.AT2/" in page
    assert "application/grpc-web-text" in page
    # field numbers used for SendAsset match at2.proto's
    # (sender=1, sequence=2, recipient=3, amount=4, signature=5)
    assert "pbBytes(1, keyPair.publicKey)" in page
    assert "pbUint(2, sequence)" in page
    assert "pbBytes(3, recipient)" in page
    assert "pbUint(4, amount)" in page
    assert "pbBytes(5, signature)" in page
    # FullTransaction decode uses the right field map (timestamp=1,
    # sender=2, recipient=3, amount=4, state=5 — proto/at2.proto:61-75)
    assert "t[3] ? bytesToHex(t[3][0])" in page  # recipient
    assert "stateNames[Number(t[5]" in page  # state


@pytest.mark.parametrize("seed", [7, 70])
def test_wallet_request_bytes_equal_the_reference(seed):
    """Differential: the browser wallet's request, built from the same
    seeded key, sequence, recipient and amount by the reference's modules
    and the port's (the signing preimage, the signature, the SendAsset
    message in one grpc-web frame, and its text-mode body), is the same
    bytes, and the golden vectors the page embeds are the same."""
    import numpy as np

    from at2_node_tpu.crypto import keys as ref_keys
    from at2_node_tpu.net import webmux as ref_webmux
    from at2_node_tpu.proto import at2_pb2 as ref_pb
    from at2_node_tpu.types import transfer_signing_bytes as ref_signing_bytes
    from at2_node_tpu_torch.crypto import keys
    from at2_node_tpu_torch.net import webmux

    def request(keys_mod, pb_mod, signing_bytes, frame):
        rng = np.random.default_rng(seed)
        kp = keys_mod.SignKeyPair(rng.bytes(32))
        recipient, seq, amount = rng.bytes(32), int(rng.integers(1, 2**31)), int(rng.integers(0, 2**63))
        pre = signing_bytes(kp.public, seq, recipient, amount)
        msg = pb_mod.SendAssetRequest(sender=kp.public, sequence=seq, recipient=recipient, amount=amount,
                                      signature=kp.sign(pre)).SerializeToString()
        return pre, frame(msg), base64.b64encode(frame(msg))

    port = request(keys, pb, transfer_signing_bytes, webmux._frame)
    assert port == request(ref_keys, ref_pb, ref_signing_bytes, ref_webmux._frame)
    assert _expected_golden() == _expected_golden(ref_pb)

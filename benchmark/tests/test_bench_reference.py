"""The plain references against RFC 8032's first test vector, every
tamper class the traffic sends, and the ledger rules."""

import pytest
from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives.asymmetric import ed25519 as ossl

from benchmark.harness import workload
from benchmark.reference import ed25519 as ref
from benchmark.reference import ledger

# RFC 8032 section 7.1, TEST 1: secret key, public key, signature of the empty message
RFC8032_TEST1 = (
    "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
    "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
    "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
)
NET_CLASSES = ("r_flip", "s_flip", "msg_flip", "high_s", "noncanonical_y", "x0_sign", "wrong_len", "r_torsion")
# the classes OpenSSL's verify (the program's host path) also refuses
OPENSSL_REFUSES = ("r_flip", "s_flip", "msg_flip", "high_s", "wrong_len", "r_torsion")


def openssl_verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    try:
        ossl.Ed25519PublicKey.from_public_bytes(pk).verify(sig, msg)
        return True
    except (InvalidSignature, ValueError):
        return False


def test_rfc8032_test1():
    sk, pk, sig = (bytes.fromhex(x) for x in RFC8032_TEST1)
    assert ref.public_key(sk) == pk
    assert ref.sign(sk, b"") == sig
    assert ref.verify(pk, b"", sig)
    assert ref.verify(pk, b"", sig, cofactored=True)
    assert not ref.verify(pk, b"x", sig)


def test_signing_agrees_with_openssl():
    k = workload.key(5, "client", 0)
    msg = workload.signing_bytes(k.public, 1, k.public, 1)
    assert ref.public_key(k.seed) == k.public
    assert ref.sign(k.seed, msg) == k.sign(msg)


@pytest.mark.parametrize("cls", NET_CLASSES)
def test_net_twin_classes_are_refused(cls):
    keys = [workload.key(11, "client", i) for i in range(3)]
    sender, seq, recipient, amount, sig = workload.net_twin(11, keys, 1, 7, cls, [1, 2])
    msg = workload.signing_bytes(sender, seq, recipient, amount)
    assert not ref.verify(sender, msg, sig)
    # the twin shadows a valid transfer that the reference accepts
    t = workload.transfer(11, [k.public for k in keys], 1, 7, [1, 2])
    assert ref.verify(t[0], workload.signing_bytes(*t), keys[1].sign(workload.signing_bytes(*t)))
    if cls in OPENSSL_REFUSES:
        assert not openssl_verify(sender, msg, sig)
    else:  # lenient decoding accepts it: the program's OpenSSL path is the control
        assert openssl_verify(sender, msg, sig)
    # of these only r_torsion passes the cofactored equation (the crafted keys fail strict decoding)
    assert ref.verify(sender, msg, sig, cofactored=True) == (cls == "r_torsion")


@pytest.mark.parametrize("index", range(0, 400, 7))
def test_replay_entries_match_the_reference(index):
    classes = ("r_flip", "s_flip", "msg_flip", "high_s", "noncanonical_y", "x0_sign", "wrong_len",
               "r_torsion", "a_torsion")
    senders = [workload.key(3, "sender", i) for i in range(16)]
    pk, msg, sig, cls, ok = workload.replay_entry(3, senders, index, 0.5, classes)
    assert ref.verify(pk, msg, sig) == ok
    if cls is None:
        assert ok


def test_a_torsion_verdict_follows_the_challenge():
    senders = [workload.key(4, "sender", i) for i in range(8)]
    seen = set()
    for i in range(200):
        pk, msg, sig, cls, ok = workload.replay_entry(4, senders, i, 1.0, ("a_torsion",))
        seen.add(ok)
        assert ref.verify(pk, msg, sig) == ok
        assert ref.verify(pk, msg, sig, cofactored=True)
    assert seen == {True, False}


def test_torsion_point_has_order_8():
    t = ref.torsion_point()
    assert ref.equal(ref.mul(8, t), ref.IDENTITY)
    assert not ref.equal(ref.mul(4, t), ref.IDENTITY)


def test_ledger_rules():
    a, b = b"a" * 32, b"b" * 32
    lg = ledger.Ledger(10)
    assert lg.apply(a, 1, b, 4)
    assert not lg.apply(a, 1, b, 1)  # sequence already used
    assert not lg.apply(a, 3, b, 1)  # gap
    assert not lg.apply(a, 2, b, 7)  # balance 6 does not cover 7
    assert lg.apply(a, 2, b, 6)
    assert (lg.balance_of(a), lg.balance_of(b), lg.sequence_of(a), lg.sequence_of(b)) == (0, 20, 2, 0)


def test_ledger_final_state_is_order_free():
    keys = [workload.key(9, "client", i).public for i in range(4)]
    sent = [[workload.transfer(9, keys, c, s, [1, 2]) for s in range(1, 6 + c)] for c in range(4)]
    lg = ledger.final_state(sent, 100)
    assert sum(lg.balance_of(k) for k in keys) == 400
    for c in range(4):
        assert lg.sequence_of(keys[c]) == 5 + c
        out = sum(t[3] for t in sent[c])
        into = sum(t[3] for t in sent[c - 1])
        assert lg.balance_of(keys[c]) == 100 - out + into


def test_ledger_refuses_traffic_that_could_overdraw():
    a, b = b"a" * 32, b"b" * 32
    with pytest.raises(ValueError):
        ledger.final_state([[(a, 1, b, 6), (a, 2, b, 6)], [(b, 1, a, 1)]], 10)

"""Differential tests: the port's batched ed25519 verify (host prep, plain
PyTorch device function, bitmask) against the JAX package's
``ops.ed25519.verify_batch`` (XLA on the CPU) and ``crypto.keys.verify_one``.
Verdicts, packed rows and bitmasks must be identical."""

import numpy as np
import pytest
import torch

from at2_node_tpu.crypto import keys as ref_keys
from at2_node_tpu.ops import ed25519 as ref_v
from at2_node_tpu_torch.crypto import _fallback as fb
from at2_node_tpu_torch.crypto.keys import SignKeyPair, verify_one
from at2_node_tpu_torch.native.prep import native_available
from at2_node_tpu_torch.ops import cuda_verify
from at2_node_tpu_torch.ops import ed25519 as v
from at2_node_tpu_torch.ops import field as fe

# These tensors are small: more intra-op threads only spin, and take
# cores from the tests that run beside these in other processes.
torch.set_num_threads(1)

RNG = np.random.default_rng(0xED25519 % 2**32 + 1)

RFC_SK = "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60"
RFC_PK = "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a"
RFC_SIG = (
    "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b"
)


def _sign_many(n, msg_len=32):
    keys = [SignKeyPair(RNG.bytes(32)) for _ in range(n)]
    msgs = [RNG.bytes(msg_len) for _ in range(n)]
    return [k.public for k in keys], msgs, [k.sign(m) for k, m in zip(keys, msgs)]


def _crafted(a_enc: bytes):
    """A of order 1 with R = [r]B, S = r: verifies iff A's encoding is
    accepted, whatever the message."""
    r = int.from_bytes(RNG.bytes(32), "little") % v.L
    big_r = fb._pt_compress(fb._pt_mul(r, fb._BASE))
    return a_enc, b"crafted", big_r + r.to_bytes(32, "little")


def _cases():
    """(pks, msgs, sigs, expected): every case of the reference's verifier
    tests in one batch of at most 64 lanes."""
    pks, msgs, sigs = _sign_many(8)
    cases = [(pks[0], msgs[0], sigs[0], True)]
    cases.append((bytes.fromhex(RFC_PK), b"", bytes.fromhex(RFC_SIG), True))
    cases.append((pks[1], msgs[1], bytes([sigs[1][0] ^ 1]) + sigs[1][1:], False))  # R
    cases.append((pks[2], msgs[2], sigs[2][:32] + bytes([sigs[2][32] ^ 1]) + sigs[2][33:], False))
    cases.append((pks[3], b"not the message", sigs[3], False))
    cases.append((pks[0], msgs[4], sigs[4], False))  # wrong key
    s = int.from_bytes(sigs[5][32:], "little")
    cases.append((pks[5], msgs[5], sigs[5][:32] + (s + v.L).to_bytes(32, "little"), False))
    cases.append((pks[6][:16], msgs[6], sigs[6], False))  # short key
    cases.append((pks[7], msgs[7], sigs[7][:20], False))  # short signature
    one = (1).to_bytes(32, "little")
    cases.append(_crafted(one) + (True,))  # small-order A, canonical: accepted
    cases.append(_crafted((fe.P + 1).to_bytes(32, "little")) + (False,))  # y = p + 1
    cases.append(_crafted((1 | (1 << 255)).to_bytes(32, "little")) + (False,))  # x = 0, sign 1
    cases.append((pks[4], msgs[4], sigs[4], True))
    return tuple(list(c) for c in zip(*cases))


def _fuzz(n=64):
    pks, msgs, sigs = _sign_many(n, msg_len=7)
    for i in range(n):
        if RNG.random() < 0.5:
            which = RNG.integers(0, 3)
            if which == 0:
                sigs[i] = bytes([sigs[i][0] ^ 0x40]) + sigs[i][1:]
            elif which == 1:
                msgs[i] = msgs[i] + b"x"
            else:
                pks[i] = SignKeyPair(RNG.bytes(32)).public
    return pks, msgs, sigs


CASES = _cases()
FUZZ = _fuzz()


@pytest.fixture(scope="module")
def reference_verdicts():
    """The JAX package's XLA verify on the CPU, both batches in its
    64-lane bucket (one compile)."""
    return {
        "cases": ref_v.verify_batch(*CASES[:3]).tolist(),
        "fuzz": ref_v.verify_batch(*FUZZ).tolist(),
    }


def test_rfc8032_vector1_signs_and_verifies():
    kp = SignKeyPair(bytes.fromhex(RFC_SK))
    assert kp.public.hex() == RFC_PK
    assert kp.sign(b"").hex() == RFC_SIG
    assert ref_keys.SignKeyPair(bytes.fromhex(RFC_SK)).sign(b"x") == kp.sign(b"x")
    assert fb.ed25519_sign(bytes.fromhex(RFC_SK), b"").hex() == RFC_SIG
    assert fb.ed25519_public(bytes.fromhex(RFC_SK)).hex() == RFC_PK
    assert v.verify_batch([kp.public], [b""], [kp.sign(b"")], device="cpu").tolist() == [True]


def test_cases_match_reference(reference_verdicts):
    pks, msgs, sigs, expect = CASES
    got = v.verify_batch(pks, msgs, sigs, device="cpu").tolist()
    assert got == reference_verdicts["cases"] == expect


def test_cases_match_verify_one():
    """OpenSSL and the RFC fallback agree with the batch path on every case
    whose encodings are canonical (OpenSSL reduces a non-canonical y)."""
    pks, msgs, sigs, expect = CASES
    for pk, msg, sig, want in list(zip(pks, msgs, sigs, expect))[:-4]:
        assert verify_one(pk, msg, sig) == ref_keys.verify_one(pk, msg, sig) == want
    fallback_ok = []
    for pk, msg, sig in zip(pks, msgs, sigs):
        try:
            fb.ed25519_verify(pk, msg, sig)
            fallback_ok.append(True)
        except (fb.InvalidSignature, ValueError):
            fallback_ok.append(False)
    assert fallback_ok == expect


def test_fuzz_64_lanes_matches_reference(reference_verdicts):
    got = v.verify_batch(*FUZZ, device="cpu").tolist()
    assert got == reference_verdicts["fuzz"]
    assert got == [ref_keys.verify_one(*item) for item in zip(*FUZZ)]
    assert 10 < sum(got) < 54  # both verdicts well represented


@pytest.mark.parametrize("size", [13, 64, 70])
def test_native_rows_match_reference_prep(size):
    pks, msgs, sigs = (CASES[0] + FUZZ[0])[:size], (CASES[1] + FUZZ[1])[:size], (CASES[2] + FUZZ[2])[:size]
    bucket = v.bucket_for(size)
    assert native_available()
    rows = np.full((bucket, v.PACKED_WIDTH), 0xAB, dtype=np.uint8)  # stale bytes must go
    v.fill_packed(pks, msgs, sigs, rows)
    want = ref_v.pack_prepared(*ref_v.prepare_batch_py(pks, msgs, sigs, bucket))
    assert rows.tobytes() == want.tobytes()
    port_py = v.pack_prepared(*v.prepare_batch_py(pks, msgs, sigs, bucket))
    assert port_py.tobytes() == want.tobytes()
    for got, ref_arr in zip(v.prepare_batch(pks, msgs, sigs, bucket), ref_v.prepare_batch(pks, msgs, sigs, bucket)):
        assert np.array_equal(got, ref_arr)


def test_bitmask_is_np_packbits():
    pks, msgs, sigs, expect = CASES
    rows = np.empty((len(pks), v.PACKED_WIDTH), dtype=np.uint8)
    v.fill_packed(pks, msgs, sigs, rows)
    bits = v.verify_packed(torch.from_numpy(rows))
    assert bits.dtype == torch.uint8 and bits.shape == ((len(pks) + 7) // 8,)
    assert bits.numpy().tobytes() == np.packbits(np.array(expect)).tobytes()
    rng = np.random.default_rng(5)
    for n in (1, 7, 8, 9, 129):
        b = rng.integers(0, 2, size=n).astype(bool)
        assert v.packbits(torch.from_numpy(b)).numpy().tobytes() == np.packbits(b).tobytes()


def test_mixed_batch_with_padding():
    pks, msgs, sigs = _sign_many(5)
    msgs[2] = b"tampered"
    out = v.verify_batch(pks, msgs, sigs, batch_size=64, device="cpu")
    assert out.tolist() == [True, True, False, True, True]
    with pytest.raises(ValueError):
        v.verify_batch(pks, msgs, sigs, batch_size=4, device="cpu")


def test_padding_lanes_verify_false():
    """A valid row whose valid byte is cleared (what padding is) is False."""
    pks, msgs, sigs = _sign_many(3)
    rows = np.empty((3, v.PACKED_WIDTH), dtype=np.uint8)
    v.fill_packed(pks, msgs, sigs, rows)
    rows[1, 128] = 0
    bits = v.verify_packed(torch.from_numpy(rows)).numpy()
    assert np.unpackbits(bits, count=3).tolist() == [1, 0, 1]


def test_bucket_policy_matches_reference():
    assert v.BUCKETS == ref_v.BUCKETS and v.PACKED_WIDTH == ref_v.PACKED_WIDTH == 129
    assert v.L == ref_v.L
    for n in (0, 1, 64, 65, 1000, 8192, 70000):
        assert v.bucket_for(n) == ref_v.bucket_for(n)


def test_field_muls_per_lane_counts_the_plain_version(monkeypatch):
    calls, squares = [], []
    real_mul, real_square = fe.mul, fe.square

    def counting(a, b):
        calls.append(1)
        return real_mul(a, b)

    def counting_square(a):
        squares.append(1)
        return real_square(a)  # goes through mul, so it is in calls too

    monkeypatch.setattr(fe, "mul", counting)
    monkeypatch.setattr(fe, "square", counting_square)
    rows = np.empty((1, v.PACKED_WIDTH), dtype=np.uint8)
    v.fill_packed(*[[x] for x in (CASES[0][0], CASES[1][0], CASES[2][0])], rows)
    v.verify_packed(torch.from_numpy(rows))
    assert len(calls) == cuda_verify.PLAIN_FIELD_MULS_PER_LANE == 3871
    assert len(squares) == cuda_verify.PLAIN_FIELD_SQUARES_PER_LANE == 1562
    # the kernel's own counts are counted in its g++ build (test_torch_kernel_host.py)
    assert cuda_verify.INT32_MULADD_SLOTS_PER_LANE == 2 * 274_150


def test_wrapper_checks_and_cpu_route():
    rows = torch.zeros((4, v.PACKED_WIDTH), dtype=torch.uint8)
    before = cuda_verify.launches
    assert cuda_verify.verify_packed(rows).tolist() == [0]
    assert cuda_verify.launches == before  # the plain version is no launch
    with pytest.raises(ValueError):
        cuda_verify.verify_packed(rows.to(torch.int32))
    with pytest.raises(ValueError):
        cuda_verify.verify_packed(torch.zeros((4, 128), dtype=torch.uint8))
    with pytest.raises(ValueError):
        cuda_verify.verify_packed(torch.zeros((v.PACKED_WIDTH, 4), dtype=torch.uint8).t())
    with pytest.raises(TypeError):
        cuda_verify.verify_packed(rows.numpy())


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        assert cuda_verify.resolve_device(None) == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            v.verify_batch(*_sign_many(1))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cuda_verify.resolve_device("cuda")
    assert cuda_verify.resolve_device("cpu") == torch.device("cpu")

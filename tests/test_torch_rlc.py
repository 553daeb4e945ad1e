"""The port's CPU RLC engine, router and auto-mode ``CpuVerifier`` against
the JAX package's: the same adversarial batches and bisection shapes give
the same verdicts, the same check and leaf counts and the same router
decisions and stats keys.

Every key is made from a numpy seed. Verdicts must equal ``verify_one``'s
(per-signature, cofactorless) exactly; there is no tolerance.
"""

import asyncio
import hashlib

import numpy as np
import pytest

from at2_node_tpu.crypto import verifier as ref_verifier
from at2_node_tpu_torch.crypto import verifier as port_verifier
from at2_node_tpu_torch.crypto.keys import SignKeyPair, verify_one
from at2_node_tpu_torch.native.rlc import rlc_available
from at2_node_tpu_torch.ops import edwards as ed
from at2_node_tpu_torch.ops.ed25519 import L

BASE_PT = (ed.BX_INT, ed.BY_INT)


@pytest.fixture(scope="module", autouse=True)
def _rlc_libraries():
    """Both packages' engines need their g++ library; a missing toolchain
    fails here rather than skipping."""
    from at2_node_tpu.native.rlc import rlc_available as ref_rlc_available

    assert rlc_available() and ref_rlc_available()


def _signed(rng, n, tag):
    keys = [SignKeyPair(rng.bytes(32)) for _ in range(n)]
    msgs = [tag + b" %d" % i for i in range(n)]
    return [(k.public, m, k.sign(m)) for k, m in zip(keys, msgs)]


def _mult(k, p):
    acc = (0, 1)
    while k:
        if k & 1:
            acc = ed.affine_add_ints(acc, p)
        p = ed.affine_add_ints(p, p)
        k >>= 1
    return acc


def _compress(pt):
    x, y = pt
    enc = bytearray(y.to_bytes(32, "little"))
    if x & 1:
        enc[31] |= 0x80
    return bytes(enc)


def _torsion_point():
    for y in range(2, 60):
        try:
            x = ed._recover_x(y, 0)
        except ValueError:
            continue
        t = _mult(L, (x, y))
        if t != (0, 1):
            return t
    raise AssertionError("no torsion point found")


def _h(r_bytes, a_pub, msg):
    return int.from_bytes(hashlib.sha512(r_bytes + a_pub + msg).digest(), "little") % L


def _torsioned_r_item(a_scalar, i=0, r_nonce=None):
    """R carries a small-order component: per-signature verification
    rejects."""
    a_pub = _compress(_mult(a_scalar, BASE_PT))
    msg = b"torsioned R %d" % i
    r_nonce = 31337 + i if r_nonce is None else r_nonce
    r_bytes = _compress(ed.affine_add_ints(_mult(r_nonce, BASE_PT), _torsion_point()))
    s = (r_nonce + _h(r_bytes, a_pub, msg) * a_scalar) % L
    return (a_pub, msg, r_bytes + s.to_bytes(32, "little"))


def _tainted_a_item(a_scalar, want_accept):
    """The public key carries torsion: the verdict depends on h, and the
    lane must be rerouted to the exact path either way."""
    a_pub = _compress(ed.affine_add_ints(_mult(a_scalar, BASE_PT), _torsion_point()))
    r_nonce = 424242
    r_bytes = _compress(_mult(r_nonce, BASE_PT))
    for trial in range(256):
        msg = b"tainted A trial %d" % trial
        s = (r_nonce + _h(r_bytes, a_pub, msg) * a_scalar) % L
        item = (a_pub, msg, r_bytes + s.to_bytes(32, "little"))
        if verify_one(*item) == want_accept:
            return item
    raise AssertionError("no matching h")


def _matrix(rng):
    items = _signed(rng, 28, b"matrix")
    sig1 = items[1][2]
    items[1] = (items[1][0], items[1][1], sig1[:32] + bytes([sig1[32] ^ 1]) + sig1[33:])
    items[2] = (items[2][0], b"substituted message", items[2][2])
    s_int = int.from_bytes(items[3][2][32:], "little")
    items[3] = (items[3][0], items[3][1],
                items[3][2][:32] + ((s_int + L) % (1 << 256)).to_bytes(32, "little"))
    items[4] = (items[4][0], items[4][1], b"\xff" * 32 + items[4][2][32:])
    items[5] = _torsioned_r_item(987654321987654321987654321 % L)
    items[6] = _tainted_a_item(1122334455667788990 % L, want_accept=True)
    items[7] = _tainted_a_item(998877665544332211 % L, want_accept=False)
    return [items]


def _clean(rng):
    return [_signed(rng, 24, b"clean")]


def _cancellation(rng):
    a_scalar = 987654321987654321987654321 % L
    attack = [_torsioned_r_item(a_scalar, i, r) for i, r in enumerate((11111, 22222))]
    return [attack + _signed(rng, 22, b"filler")]


def _cert_cache(rng):
    kp = SignKeyPair(rng.bytes(32))
    rounds = []
    for r in range(3):
        msgs = [b"round %d msg %d" % (r, i) for i in range(20)]
        rounds.append([(kp.public, m, kp.sign(m)) for m in msgs])
    return rounds


@pytest.mark.parametrize("batches", [_matrix, _clean, _cancellation, _cert_cache])
def test_engine_matches_the_reference_on_adversarial_batches(batches):
    """Same batches (one engine per package, fed every batch in turn):
    verdicts equal ``verify_one`` lane for lane, and the stats (checks,
    fallbacks, reroutes, leaves, certified keys) are equal."""
    rng = np.random.default_rng(7)
    port, ref = port_verifier.RlcEngine(), ref_verifier.RlcEngine()
    for items in batches(rng):
        expected = [verify_one(*it) for it in items]
        assert port.verify_batch(items) == expected
        assert ref.verify_batch(items) == expected
    assert port.stats() == ref.stats()
    assert port.stats()["rlc_batches"] >= 1


def _planted(module, bad, leaf_size=16, check=None):
    def check_bad(prep, idxs):
        return not any(int(i) in bad for i in idxs), np.ones(len(idxs), dtype=bool)

    def leaf(items, idxs):
        return [int(i) not in bad for i in idxs]

    return module.RlcEngine(leaf_size=leaf_size, check_fn=check or check_bad, leaf_fn=leaf)


@pytest.mark.parametrize(
    "n,bad,leaf_size,anomaly",
    [
        (256, {5}, 16, False),  # one culprit: 1 + 2 checks per halving
        (256, {10, 80, 150, 240}, 16, False),  # k culprits share upper levels
        (64, set(range(64)), 16, False),  # all bad: every lane exact
        (64, set(), 16, True),  # parent fails, both halves pass
        (12, {3}, 16, False),  # under the amortization floor: no check
    ],
)
def test_bisection_counts_match_the_reference(n, bad, leaf_size, anomaly):
    rng = np.random.default_rng(n + len(bad))
    items = _signed(rng, n, b"bisect")

    def parent_fails(prep, idxs):
        return len(idxs) < n, np.ones(len(idxs), dtype=bool)

    check = parent_fails if anomaly else None
    port = _planted(port_verifier, bad, leaf_size, check)
    ref = _planted(ref_verifier, bad, leaf_size, check)
    want = [i not in bad for i in range(n)]
    assert port.verify_batch(items) == want == ref.verify_batch(items)
    assert port.stats() == ref.stats()
    if anomaly:
        assert port.stats()["rlc_anomalies"] == 1
    if n == 256 and len(bad) == 1:
        assert port.stats()["rlc_checks"] == 1 + 2 * 4


def _router_script(module):
    """The reference tests' routing sequence; every decision and the final
    stats."""
    out = []
    srcs = [b"k%d" % i for i in range(16)]
    r = module.VerifyRouter("auto", min_batch=8)
    out += [r.choose(srcs), r.choose(srcs[:4]), r.choose(srcs, rlc_ready=False)]
    out.append(module.VerifyRouter("per_sig", min_batch=1).choose(srcs))
    out.append(module.VerifyRouter("rlc", min_batch=1 << 30).choose(srcs[:2]))
    salter, honest = b"salter", [b"h%d" % i for i in range(15)]
    batch = [salter] + honest
    s = module.VerifyRouter("auto", min_batch=8, expected_bad_budget=0.5)
    out.append(s.choose(batch))
    for _ in range(5):
        s.observe([(salter, False)] + [(h, True) for h in honest])
    out += [round(s.expected_bad(batch), 12), s.choose(batch), s.hot_sources(), s.choose(honest * 2)]
    for _ in range(30):
        s.observe([(salter, True)])
    out += [s.choose(batch), s.hot_sources(), s.stats()]
    bounded = module.VerifyRouter("auto", max_sources=64)
    bounded.observe([(b"s%04d" % i, False) for i in range(500)])
    out.append(bounded.stats())
    return out


def test_router_decisions_and_stats_match_the_reference():
    port, ref = _router_script(port_verifier), _router_script(ref_verifier)
    assert port == ref
    assert port[:5] == ["rlc", "per_sig", "per_sig", "per_sig", "rlc"]
    assert port[-1]["router_sources"] == 64
    with pytest.raises(ValueError):
        port_verifier.VerifyRouter("both")


def _auto_batches(rng):
    """Flushes for a CpuVerifier in auto mode: a clean 160 (routes RLC at
    the default 128), a 160 with three tampered lanes, a trickle of 20
    (per-sig), then a salter riding clean flushes until routed per-sig."""
    clean = _signed(rng, 160, b"auto clean")
    dirty = _signed(rng, 160, b"auto dirty")
    for j in (3, 77, 150):
        pk, m, s = dirty[j]
        dirty[j] = (pk, m + b"!", s)
    salter = SignKeyPair(rng.bytes(32))
    salted = []
    for r in range(5):
        items = _signed(rng, 140, b"salt %d" % r)
        items.append((salter.public, b"salted %d" % r, b"\0" * 64))
        salted.append(items)
    return [clean, dirty, _signed(rng, 20, b"trickle")] + salted


def test_cpu_verifier_auto_matches_the_reference():
    """``CpuVerifier()`` (mode auto, rlc_min_batch 128, the node default)
    gives the reference's verdicts and routes every flush the same way."""

    async def run():
        rng = np.random.default_rng(11)
        flushes = _auto_batches(rng)
        port, ref = port_verifier.CpuVerifier(), ref_verifier.CpuVerifier()
        await port.warmup()
        await ref.warmup()
        routes = []
        try:
            for items in flushes:
                expected = [verify_one(*it) for it in items]
                assert await port.verify_many(items) == expected
                assert await ref.verify_many(items) == expected
                routes.append((port.router.last_route, ref.router.last_route))
            p, r = port.stats(), ref.stats()
        finally:
            await port.close()
            await ref.close()
        assert set(p) == set(r)
        assert [a for a, _ in routes] == [b for _, b in routes]
        assert routes[0][0] == "rlc" and routes[2][0] == "per_sig"
        assert routes[-1][0] == "per_sig"  # the salter is priced out
        for key in ("signatures", "route_rlc", "route_per_sig", "rlc_batches", "rlc_fallbacks",
                    "exact_reroutes", "certified_keys", "router_sources"):
            assert p[key] == r[key], key

    asyncio.run(run())

"""The port's RLC check and certificate verify (``ops/aggregate.py``)
against the JAX package.

The reference's XLA graphs (``_rlc_graph_packed``, ``_aggregate_graph``)
take minutes to compile on the CPU, so the fast tier holds the port to
pieces of the reference that are cheap to run: lane codes and eq_ok against
a Python-int model built from the reference's g++ helpers
(``native.rlc.decompress_check``, ``scalarmul(enc, L)``) and its integer
point arithmetic (``ops.edwards.affine_add_ints``); ``rlc_prep`` rows
byte for byte against the reference's; verdicts against ``verify_one`` and
the reference's ``verify_batch``. Two slow-marked twins run the reference's
graphs themselves.

Every key and coefficient comes from a numpy seed; batches hold 8-16
lanes. This is integer math: there is no tolerance.
"""

import hashlib

import numpy as np
import pytest
import torch

from at2_node_tpu.native import rlc as ref_rlc
from at2_node_tpu.ops import aggregate as ref_agg
from at2_node_tpu.ops import ed25519 as ref_base
from at2_node_tpu.ops import edwards as ref_ed
from at2_node_tpu_torch.crypto.keys import SignKeyPair, verify_one
from at2_node_tpu_torch.ops import aggregate as agg
from at2_node_tpu_torch.ops import cuda_rlc
from at2_node_tpu_torch.ops import ed25519 as v
from at2_node_tpu_torch.ops import edwards as ed
from at2_node_tpu_torch.ops.ed25519 import L

# These tensors are small: more intra-op threads only spin, and take
# cores from the tests that run beside these in other processes.
torch.set_num_threads(1)

P = (1 << 255) - 19
BASE_PT = (ref_ed.BX_INT, ref_ed.BY_INT)
IDENT_ENC = (1).to_bytes(32, "little")


@pytest.fixture(scope="module", autouse=True)
def _reference_helpers():
    """The model needs the reference's g++ engine; a missing toolchain
    fails here rather than skipping."""
    assert ref_rlc.rlc_available()


# -- integer point arithmetic (the reference's) and the adversarial lanes --


def _mult(k, p):
    acc = (0, 1)
    while k:
        if k & 1:
            acc = ref_ed.affine_add_ints(acc, p)
        p = ref_ed.affine_add_ints(p, p)
        k >>= 1
    return acc


def _compress(pt):
    x, y = pt
    enc = bytearray(y.to_bytes(32, "little"))
    if x & 1:
        enc[31] |= 0x80
    return bytes(enc)


def _decode(enc):
    raw = int.from_bytes(enc, "little")
    return ref_ed._recover_x(raw & ((1 << 255) - 1), raw >> 255), raw & ((1 << 255) - 1)


def _torsion_point():
    """A point of order 8: [L]Q for a curve point Q off the subgroup."""
    for y in range(2, 60):
        try:
            x = ref_ed._recover_x(y, 0)
        except ValueError:
            continue
        t = _mult(L, (x, y))
        if t != (0, 1):
            return t
    raise AssertionError("no torsion point found")


TORSION = _torsion_point()


def _h(r_bytes, a_pub, msg):
    return int.from_bytes(hashlib.sha512(r_bytes + a_pub + msg).digest(), "little") % L


def _signed(rng, n, tag):
    keys = [SignKeyPair(rng.bytes(32)) for _ in range(n)]
    msgs = [tag + b" %d" % i for i in range(n)]
    return [(k.public, m, k.sign(m)) for k, m in zip(keys, msgs)]


def _scalar(rng):
    return int.from_bytes(rng.bytes(32), "little") % L


def _torsioned_r_item(rng, r_point=None):
    """R = [r]B + T (or ``r_point`` itself), S = r + h a: the per-signature
    check rejects (its residual is -T)."""
    a_scalar, r_nonce = _scalar(rng), _scalar(rng)
    a_pub = _compress(_mult(a_scalar, BASE_PT))
    msg = b"torsioned R %d" % r_nonce
    r_pt = r_point if r_point is not None else ref_ed.affine_add_ints(_mult(r_nonce, BASE_PT), TORSION)
    r_bytes = _compress(r_pt)
    s = (r_nonce + _h(r_bytes, a_pub, msg) * a_scalar) % L
    return (a_pub, msg, r_bytes + s.to_bytes(32, "little"))


def _tainted_a_item(rng, want_accept):
    """A' = [a]B + T: the per-signature verdict depends on h mod 8, and the
    lane is rerouted (code 2) either way."""
    a_scalar, r_nonce = _scalar(rng), _scalar(rng)
    a_pub = _compress(ref_ed.affine_add_ints(_mult(a_scalar, BASE_PT), TORSION))
    r_bytes = _compress(_mult(r_nonce, BASE_PT))
    for trial in range(256):
        msg = b"tainted A trial %d" % trial
        s = (r_nonce + _h(r_bytes, a_pub, msg) * a_scalar) % L
        item = (a_pub, msg, r_bytes + s.to_bytes(32, "little"))
        if verify_one(*item) == want_accept:
            return item
    raise AssertionError("no matching h")


def _crafted(rng, a_enc=None, r_enc=None):
    """A of order 1 with R = [r]B and S = r verifies for any message; an
    encoding put in A's or R's place is then all that decides the lane."""
    r = _scalar(rng)
    big_r = _compress(_mult(r, BASE_PT))
    return (a_enc or IDENT_ENC, b"crafted %d" % r, (r_enc or big_r) + r.to_bytes(32, "little"))


def _case(name, rng):
    """Seven clean lanes and one lane of the case (eight clean for
    "clean"), the odd lane at a seeded position; (items, its position)."""
    items = _signed(rng, 8, name.encode())
    at = int(rng.integers(0, 8))
    if name == "clean":
        return items, at
    pk, msg, sig = items[0]
    s = int.from_bytes(sig[32:], "little")
    odd = {
        "tampered": lambda: (pk, msg + b"!", sig),
        "high_s": lambda: (pk, msg, sig[:32] + (s + L).to_bytes(32, "little")),
        "noncanonical_a": lambda: _crafted(rng, a_enc=(P + 1).to_bytes(32, "little")),
        "noncanonical_r": lambda: _crafted(rng, r_enc=(P + 1).to_bytes(32, "little")),
        "x0_sign": lambda: _crafted(rng, a_enc=(1 | 1 << 255).to_bytes(32, "little")),
        "small_order_r": lambda: _torsioned_r_item(rng, r_point=TORSION),
        "torsioned_r": lambda: _torsioned_r_item(rng),
        "tainted_a_accepting": lambda: _tainted_a_item(rng, True),
        "tainted_a_rejecting": lambda: _tainted_a_item(rng, False),
    }[name]()
    items[at] = odd
    return items, at


CASES = ("clean", "tampered", "high_s", "noncanonical_a", "noncanonical_r", "x0_sign",
         "small_order_r", "torsioned_r", "tainted_a_accepting", "tainted_a_rejecting")
# the code of the odd lane; every clean lane has code 1
ODD_CODE = {"clean": 1, "tampered": 1, "high_s": 0, "noncanonical_a": 2, "noncanonical_r": 0,
            "x0_sign": 2, "small_order_r": 0, "torsioned_r": 0, "tainted_a_accepting": 2,
            "tainted_a_rejecting": 2}


def _model(rows):
    """(eq_ok, codes) of packed RLC rows: decode and [L]P from the
    reference's g++ engine, the residuals [z]R + [zh]A - [zs]B of the code-1
    lanes summed in the reference's integer point arithmetic."""
    codes, total = [], (0, 1)
    for row in rows:
        a, r = bytes(row[:32]), bytes(row[32:64])
        a_clean = ref_rlc.decompress_check(a) and ref_rlc.scalarmul(a, L) == IDENT_ENC
        r_clean = ref_rlc.decompress_check(r) and ref_rlc.scalarmul(r, L) == IDENT_ENC
        code = 0 if not row[160] else (2 if not a_clean else int(r_clean))
        codes.append(code)
        if code == 1:
            z, zh, zs = (int.from_bytes(bytes(row[o:o + 32]), "little") for o in (64, 96, 128))
            nb = _mult(zs, BASE_PT)
            e = ref_ed.affine_add_ints(_mult(z, _decode(r)), _mult(zh, _decode(a)))
            total = ref_ed.affine_add_ints(total, ref_ed.affine_add_ints(e, ((-nb[0]) % P, nb[1])))
    return total == (0, 1), codes


def _rows(items, bucket=None, z=None):
    return agg.rlc_prep(*[list(x) for x in zip(*items)], bucket, _z_override=z).numpy()


def _z(rng, n):
    return [int(x) | 1 for x in rng.integers(1, 1 << 62, size=n)]


@pytest.mark.parametrize("name", CASES)
def test_plain_rlc_matches_the_integer_model(name):
    """rlc_graph_packed_plain's codes and eq_ok equal the model's, two
    padding lanes included; the odd lane has its expected code, and eq_ok
    holds unless a code-1 lane is bad."""
    rng = np.random.default_rng(CASES.index(name))
    items, at = _case(name, rng)
    rows = _rows(items, 10, z=_z(rng, 8) + [1 << 127, (1 << 128) - 1])
    eq_ok, codes = agg.rlc_graph_packed_plain(torch.from_numpy(rows))
    want_eq, want_codes = _model(rows)
    assert codes.tolist() == want_codes and bool(eq_ok) == want_eq
    assert want_codes[at] == ODD_CODE[name] and want_codes[8:] == [0, 0]
    assert want_codes[:8].count(1) == 8 - (ODD_CODE[name] != 1)
    assert want_eq == (name != "tampered")


def test_rlc_prep_rows_equal_the_reference():
    """Byte-equal rows under the same coefficients: a ragged bucket, bad
    lengths, a high S and a tainted key among the lanes; the padding lanes
    take z = 1 in both."""
    rng = np.random.default_rng(40)
    items = _signed(rng, 9, b"prep")
    pk, msg, sig = items[2]
    items[2] = (pk, msg, sig[:32] + (int.from_bytes(sig[32:], "little") + L).to_bytes(32, "little"))
    items[4] = (pk[:31], msg, sig)
    items[5] = (pk, msg, sig[:63])
    items[7] = _tainted_a_item(rng, True)
    cols = [list(x) for x in zip(*items)]
    z = _z(rng, 9)
    got = agg.rlc_prep(*cols, 13, _z_override=z).numpy()
    want = ref_agg.rlc_prep(*cols, 13, _z_override=z)
    assert got.shape == (13, agg.RLC_PACKED_WIDTH) and got.tolist() == want.tolist()
    assert got[:, 160].tolist() == [1, 1, 0, 1, 0, 0, 1, 1, 1] + [0] * 4
    pool = v.StagingPool(pinned=False, width=agg.RLC_PACKED_WIDTH)
    buf = agg.rlc_prep(*cols, 13, pool, _z_override=z)
    assert buf.numpy().tolist() == want.tolist()
    pool.release(buf)
    assert agg.rlc_prep(*cols, 13, pool, _z_override=z) is buf


def _verdict_items(rng):
    """16 lanes: clean, a tampered message, a high S, a torsioned R and two
    tainted keys (one accepting, one rejecting)."""
    items = _signed(rng, 16, b"verdicts")
    pk, msg, sig = items[3]
    items[3] = (pk, msg + b"?", sig)
    pk, msg, sig = items[6]
    items[6] = (pk, msg, sig[:32] + (int.from_bytes(sig[32:], "little") + L).to_bytes(32, "little"))
    items[9] = _torsioned_r_item(rng)
    items[11] = _tainted_a_item(rng, True)
    items[14] = _tainted_a_item(rng, False)
    return items


def test_rlc_verify_batch_and_aggregate_verify_match_the_reference():
    """On the CPU (the plain version): rlc_verify_batch equals verify_one
    and the reference's verify_batch on a flush that falls back (tampered,
    rerouted lanes) and on one that resolves from its codes alone (a
    torsioned R and a high S: code 0); aggregate_verify equals their
    all-valid verdict on a clean and a tampered certificate, with the same
    coefficients."""
    rng = np.random.default_rng(41)
    items = _verdict_items(rng)
    coded = [it for i, it in enumerate(items) if i not in (3, 11, 14)]
    clean = _signed(rng, 8, b"certificate")
    tampered = list(clean)
    pk, msg, sig = tampered[5]
    tampered[5] = (pk, msg, sig[:32] + bytes([sig[32] ^ 4]) + sig[33:])
    # one call of the reference's 64-lane bucket, shared with the other
    # test files through the persistent compilation cache
    groups = [items, coded, clean, tampered]
    flat = [it for g in groups for it in g]
    ref = ref_base.verify_batch(*[list(x) for x in zip(*flat)]).tolist()
    bounds = np.cumsum([0] + [len(g) for g in groups])
    ref_by = [ref[bounds[i]:bounds[i + 1]] for i in range(len(groups))]
    for items_, want in zip(groups[:2], ref_by[:2]):
        assert [verify_one(*it) for it in items_] == want
        got = agg.rlc_verify_batch(*[list(x) for x in zip(*items_)], 16,
                                   _z_override=_z(rng, len(items_)), device="cpu")
        assert got.tolist() == want
    assert ref_by[1].count(False) == 2
    for cert, want in zip(groups[2:], ref_by[2:]):
        z = _z(rng, len(cert))
        assert agg.aggregate_verify(*[list(x) for x in zip(*cert)], _z_override=z,
                                    device="cpu") is all(want)
    assert all(ref_by[2]) and not all(ref_by[3])


def test_rlc_verify_batch_resolves_from_codes_without_the_exact_pass(monkeypatch):
    """A flush whose equation holds and that has no code-2 lane is decided
    by its codes: the per-signature kernel does not run."""
    rng = np.random.default_rng(42)
    items = _signed(rng, 6, b"codes only") + [_torsioned_r_item(rng)]

    def no_exact_pass(*a, **kw):
        raise AssertionError("the exact pass ran")

    monkeypatch.setattr(v, "verify_batch", no_exact_pass)
    got = agg.rlc_verify_batch(*[list(x) for x in zip(*items)], device="cpu")
    assert got.tolist() == [True] * 6 + [False]


def test_aggregate_verify_edges():
    rng = np.random.default_rng(43)
    assert agg.aggregate_verify([], [], [], device="cpu") is True
    pk, msg, sig = _signed(rng, 1, b"edge")[0]
    assert agg.aggregate_verify([pk], [msg], [sig[:10]], device="cpu") is False
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            agg.aggregate_verify([pk], [msg], [sig])


def test_certificate_is_x2_with_the_epilogue_on_the_cancellation_pair():
    """The reference's cancellation pair: two signatures whose R carries the
    same 8-torsion point, under coefficients 1 and 7, cancel in the naive
    RLC sum, which holds over all four lanes. X2 gives the two attack lanes
    code 0 and keeps them out of its fold, whose equation then holds over
    the honest lanes; the epilogue ``eq_ok and all(codes == 1)`` returns
    False, the reference's verdict (``subgroup_ok`` False), and the
    per-signature verdicts reject exactly the attack lanes."""
    rng = np.random.default_rng(44)
    a_scalar = 987654321987654321987654321 % L
    a_pub = _compress(_mult(a_scalar, BASE_PT))
    attack = []
    for i, r_nonce in enumerate((11111, 22222)):
        msg = b"small-order attack %d" % i
        r_bytes = _compress(ref_ed.affine_add_ints(_mult(r_nonce, BASE_PT), TORSION))
        s = (r_nonce + _h(r_bytes, a_pub, msg) * a_scalar) % L
        attack.append((a_pub, msg, r_bytes + s.to_bytes(32, "little")))
    items = attack + _signed(rng, 2, b"honest filler")
    cols = [list(x) for x in zip(*items)]
    z = [1, 7, 3, 5]
    rows = agg.rlc_prep(*cols, _z_override=z).numpy()

    naive = (0, 1)
    for row in rows:
        zz, zh, zs = (int.from_bytes(bytes(row[o:o + 32]), "little") for o in (64, 96, 128))
        nb = _mult(zs, BASE_PT)
        e = ref_ed.affine_add_ints(_mult(zz, _decode(bytes(row[32:64]))),
                                   _mult(zh, _decode(bytes(row[:32]))))
        naive = ref_ed.affine_add_ints(naive, ref_ed.affine_add_ints(e, ((-nb[0]) % P, nb[1])))
    assert naive == (0, 1), "the naive equation must hold for the attack to be one"

    eq_ok, codes = agg.rlc_graph_packed_plain(torch.from_numpy(rows))
    assert bool(eq_ok) and codes.tolist() == [0, 0, 1, 1]
    assert agg.aggregate_verify(*cols, _z_override=z, device="cpu") is False
    assert agg.verify_certificate(*cols, device="cpu").tolist() == [False, False, True, True]
    assert [verify_one(*it) for it in items] == [False, False, True, True]


def test_rlc_packed_wrapper_on_the_cpu():
    """A CPU tensor takes the plain version and launches nothing; shapes
    and types the kernels do not take raise."""
    rng = np.random.default_rng(45)
    rows = torch.from_numpy(_rows(_case("tampered", rng)[0], 9))
    before = (cuda_rlc.launches, cuda_rlc.fold_launches)
    eq, codes = cuda_rlc.rlc_packed(rows)
    plain_eq, plain_codes = agg.rlc_graph_packed_plain(rows)
    assert eq.tolist() == [int(plain_eq)] == [0] and codes.tolist() == plain_codes.tolist()
    assert (cuda_rlc.launches, cuda_rlc.fold_launches) == before
    eq, codes = cuda_rlc.rlc_packed(rows[:0])
    assert eq.tolist() == [1] and codes.numel() == 0
    for bad in (rows[:, :160].contiguous(), rows.to(torch.int32), rows[::2], rows.numpy()):
        with pytest.raises((TypeError, ValueError)):
            cuda_rlc.rlc_packed(bad)


@pytest.mark.parametrize("wave", [264 * 8, 132 * 8, 8])
def test_lanes_layout_choice_follows_one_wave(wave):
    """choose_layout: the split layout exactly while a launch fits in one
    wave of its resident blocks (``wave`` lanes), the whole layout past
    it; monotone in n, so no size returns to the split layout."""
    sizes = sorted({1, 7, 8, 9, 64, 77, 256, 1000, 1024, 4096, 8192, 65536,
                    wave - 1, wave, wave + 1} - {0})
    layouts = [cuda_rlc.choose_layout(n, wave) for n in sizes]
    for n, layout in zip(sizes, layouts):
        assert layout == (cuda_rlc.SPLIT if n <= wave else cuda_rlc.WHOLE)
        if layout == cuda_rlc.SPLIT:
            assert cuda_rlc.partials_for(n, layout) * cuda_rlc.LANES_PER_BLOCK[layout] <= wave
    assert layouts == sorted(layouts, reverse=True)  # SPLIT (1) before WHOLE (0), never back


@pytest.mark.parametrize("layout", [cuda_rlc.WHOLE, cuda_rlc.SPLIT], ids=["whole", "split"])
def test_fold_grid_keeps_the_chain_short(layout):
    """fold_grid: blocks of 32-128 threads (a power of two), every point in
    one block's share, at most 4 points a quad at each level up to 16,384
    partials, and one level up to 128; the scratch holds the partials, the
    blocks' points and the ticket."""
    for n in (1, 8, 9, 64, 77, 256, 1000, 1024, 4096, 8192, 65536, 262144):
        nparts = cuda_rlc.partials_for(n, layout)
        blocks, threads = cuda_rlc.fold_grid(nparts)
        quads = threads // 4
        assert 32 <= threads <= 4 * cuda_rlc.FOLD_MAX_QUADS and threads & (threads - 1) == 0
        share = -(-nparts // blocks)
        assert (blocks - 1) * share < nparts <= blocks * share  # no block without a point
        assert -(-share // quads) <= cuda_rlc.FOLD_PER_QUAD
        assert -(-blocks // quads) <= cuda_rlc.FOLD_PER_QUAD or nparts > 16384
        assert (blocks == 1) == (nparts <= cuda_rlc.FOLD_MAX_QUADS * cuda_rlc.FOLD_PER_QUAD)
        work = cuda_rlc.Scratch(n, layout, "cpu")
        assert work.points().shape == (nparts, 4, 10)
        assert work.ticket - work.partials == 4 * (nparts + blocks) * 40
        assert work.words.numel() == (nparts + blocks) * 40 + 1


def test_stages_on_the_cpu_give_the_staging_buffer_back_after_finish():
    rng = np.random.default_rng(46)
    items = _signed(rng, 3, b"stages")
    pool = v.StagingPool(pinned=False, width=agg.RLC_PACKED_WIDTH)
    host = agg.rlc_prep(*[list(x) for x in zip(*items)], 4, pool)
    handle = agg.rlc_launch(agg.rlc_upload(host, torch.device("cpu")))
    assert pool.free_count(4) == 0
    eq_ok, codes = agg.rlc_finish(handle, 3, pool)
    assert eq_ok is True and codes.tolist() == [1, 1, 1] and pool.free_count(4) == 1


def test_double_scalar_mul_and_mul_by_l():
    """[a]P + [b]Q of the port's Straus equals integer arithmetic; [L]
    sends a subgroup point to the identity and an 8-torsion point to
    itself."""
    rng = np.random.default_rng(47)
    p, q = _mult(_scalar(rng), BASE_PT), ref_ed.affine_add_ints(_mult(_scalar(rng), BASE_PT), TORSION)
    a, b = _scalar(rng), (1 << 256) - 1 - _scalar(rng)
    pts = [torch.as_tensor(ed.point_from_ints(*pt))[None] for pt in (p, q)]
    win = [torch.from_numpy(agg._windows_from_int(k))[None] for k in (a, b)]
    got = agg.double_scalar_mul(pts[0], win[0], pts[1], win[1])
    assert ed.point_to_ints(got[0].numpy()) == ref_ed.affine_add_ints(_mult(a, p), _mult(b, q))
    ident = agg.is_identity(agg.mul_by_L(torch.cat(pts + [torch.as_tensor(ed.point_from_ints(*TORSION))[None]])))
    assert ident.tolist() == [True, False, False]


@pytest.mark.slow
def test_rlc_graph_twin_matches_the_reference():
    """The reference's ``_rlc_graph_packed`` itself (a minutes-scale XLA
    compile on the CPU) on the rows of every case."""
    rng = np.random.default_rng(48)
    odd = [_case(name, rng) for name in CASES[1:]]
    items = [case[at] for case, at in odd] + _signed(rng, 7, b"twin")
    rows = _rows(items, 16, z=_z(rng, 16))
    ref_eq, ref_codes = ref_agg._rlc_jit(rows)
    eq_ok, codes = agg.rlc_graph_packed_plain(torch.from_numpy(rows))
    assert codes.tolist() == np.asarray(ref_codes).tolist() and bool(eq_ok) == bool(ref_eq)


@pytest.mark.slow
def test_aggregate_verify_twin_matches_the_reference():
    """The reference's ``aggregate_verify`` itself on a clean certificate,
    a tampered one and the cancellation pair, with the same coefficients."""
    rng = np.random.default_rng(49)
    clean = _signed(rng, 4, b"twin cert")
    tampered = clean[:2] + [(clean[2][0], clean[2][1] + b"!", clean[2][2])] + clean[3:]
    pair = [_torsioned_r_item(rng) for _ in range(2)] + clean[:2]
    for cert in (clean, tampered, pair):
        cols = [list(x) for x in zip(*cert)]
        z = _z(rng, 4)
        assert agg.aggregate_verify(*cols, _z_override=z, device="cpu") is ref_agg.aggregate_verify(
            *cols, _z_override=z)

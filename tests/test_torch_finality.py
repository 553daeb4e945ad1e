"""Finality certificates in the port against the JAX package's.

* Units, port against reference, on the same seeded co-signatures: the
  kind-16 ``CertSig`` and the ``Certificate`` encodings are byte-equal and
  decode alike in both packages; the two ``CertAssembler``s return equal
  certificates and equal ``status()``, ``stats()``, ``export()`` and
  equivocation evidence for the same quorum, duplicates and conflicting
  pairs; ``restore(export())`` carries across packages both ways; the two
  ``LightVerifier``s and ``verify_chain``s give equal verdicts on a clean
  chain and on its mutants; the port's native kind-16 parse equals its
  Python decode (and the reference's) on frames from the port's
  ``mutate_cert_frame``, which mutates byte for byte as the reference's.
* The fleet: four in-process port ``Service``s (host verifier, thresholds
  2, ``audit_every = 8``, ``[finality] enabled``) commit 64 transfers;
  every node holds a chain the reference's light client accepts (decoded
  from the port's bytes), ``Client.wait_final`` returns a covering
  certificate, a node restarted from its store holds the same chain tail,
  and the sharded plane (``thread``) still certifies.

Every key and input is drawn from a numpy generator; comparisons are
exact.
"""

import asyncio
import dataclasses
import json
import random

import numpy as np
import pytest

import chip_smoke
from at2_node_tpu.broadcast import messages as ref_msgs
from at2_node_tpu.crypto.keys import SignKeyPair as RefSignKeyPair
from at2_node_tpu.finality import CertAssembler as RefAssembler
from at2_node_tpu.finality import Certificate as RefCertificate
from at2_node_tpu.finality import LightVerifier as RefLightVerifier
from at2_node_tpu.finality import light as ref_light
from at2_node_tpu.finality import scheme as ref_scheme
from at2_node_tpu.finality import verify_chain as ref_verify_chain
from at2_node_tpu.sim.hostile import mutate_cert_frame as ref_mutate_cert_frame
from at2_node_tpu_torch.broadcast import messages as port_msgs
from at2_node_tpu_torch.client import Client
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.finality import CertAssembler, Certificate, LightVerifier, verify_chain
from at2_node_tpu_torch.finality import light as port_light
from at2_node_tpu_torch.finality import scheme as port_scheme
from at2_node_tpu_torch.native.ingest import ingest_available
from at2_node_tpu_torch.node.config import (
    FinalityConfig,
    ObservabilityConfig,
    PlaneConfig,
    StoreConfig,
    VerifierConfig,
)
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.sim.hostile import mutate_cert_frame
from at2_node_tpu_torch.tools._common import make_net_configs

TIMEOUT = 30.0


def _seeds(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    return [rng.bytes(32) for _ in range(n)]


def _digests(seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    return rng.bytes(16), rng.bytes(128), rng.bytes(8)


def _pair(seed: int, n: int = 4):
    """The same n keypairs in both packages."""
    s = _seeds(seed, n)
    return [SignKeyPair(x) for x in s], [RefSignKeyPair(x) for x in s]


def _to_ref(cosig) -> "ref_msgs.CertSig":
    """A port co-signature as the reference decodes its bytes."""
    (back,) = ref_msgs.parse_frame(cosig.encode())
    return back


def _cosigs(kps, epoch: int, seed: int, commits0: int = 50) -> list:
    wm, ranges, dird = _digests(seed)
    return [port_msgs.CertSig.create(kp, epoch, commits0 + i, wm, ranges, dird) for i, kp in enumerate(kps)]


def _feed(asm, ref, cosigs) -> list:
    """Fold each co-signature into both assemblers; the encoded
    certificates each returned, side by side."""
    out = []
    for c in cosigs:
        got, want = asm.add(c), ref.add(_to_ref(c))
        out.append((got.encode() if got else None, want.encode() if want else None))
    return out


def _assemblers(kps, **kw):
    members = [kp.public for kp in kps]
    return CertAssembler(members, **kw), RefAssembler(members, **kw)


def _chain(kps, seeds=(1, 2, 3)) -> list:
    """A chain of certificates over frontiers of rising commits."""
    asm = CertAssembler([kp.public for kp in kps])
    chain = []
    for k, seed in enumerate(seeds):
        for c in _cosigs(kps, 0, seed, commits0=100 * (k + 1)):
            cert = asm.add(c)
            if cert is not None:
                chain.append(cert)
    assert len(chain) == len(seeds)
    return chain


# -- wire -----------------------------------------------------------------


@pytest.mark.parametrize("epoch,commits", [(0, 0), (3, 1234), (2**40, 2**63)])
def test_cert_sig_bytes_equal_and_decode_alike(epoch, commits):
    port_kp, ref_kp = (k[0] for k in _pair(11, 1))
    wm, ranges, dird = _digests(epoch % 7)
    mine = port_msgs.CertSig.create(port_kp, epoch, commits, wm, ranges, dird)
    theirs = ref_msgs.CertSig.create(ref_kp, epoch, commits, wm, ranges, dird)
    assert mine.encode() == theirs.encode()
    assert len(mine.encode()) == port_msgs.CERT_SIG_WIRE == ref_msgs.CERT_SIG_WIRE
    assert mine.to_sign() == theirs.to_sign()
    (back,) = port_msgs.parse_frame(theirs.encode())
    assert back == mine
    assert dataclasses.asdict(_to_ref(mine)) == dataclasses.asdict(theirs)


def test_certificate_bytes_equal_and_decode_alike():
    port_kps, ref_kps = _pair(12)
    asm, ref = _assemblers(port_kps)
    wm, ranges, dird = _digests(1)
    for i, (p, r) in enumerate(zip(port_kps, ref_kps)):
        got = asm.add(port_msgs.CertSig.create(p, 0, 50 + i, wm, ranges, dird))
        want = ref.add(ref_msgs.CertSig.create(r, 0, 50 + i, wm, ranges, dird))
        assert (got is None) == (want is None)
    cert, rcert = asm.latest, ref.latest
    assert cert.encode() == rcert.encode()
    assert cert.preimage() == rcert.preimage()
    assert cert.signer_ranks() == rcert.signer_ranks() and cert.signer_count() == 3
    assert RefCertificate.decode(cert.encode()).encode() == cert.encode()
    assert Certificate.decode(rcert.encode()) == cert
    doc = json.loads(json.dumps(cert.to_doc()))
    assert doc == rcert.to_doc()
    assert Certificate.from_doc(rcert.to_doc()) == cert
    assert RefCertificate.from_doc(doc) == rcert


@pytest.mark.parametrize("cut", [0, 10, 100])
def test_certificate_decode_refusals_equal(cut):
    cert = _chain(_pair(13)[0], seeds=(4,))[0]
    raw = bytearray(cert.encode())
    bad = [bytes(raw[:cut]), bytes(raw) + b"\0", bytes([9]) + bytes(raw[1:]), bytes(raw[:1]) + b"\x77" + bytes(raw[2:])]
    for frame in bad:
        with pytest.raises(ValueError) as mine:
            Certificate.decode(frame)
        with pytest.raises(ValueError) as theirs:
            RefCertificate.decode(frame)
        assert str(mine.value) == str(theirs.value)


@pytest.mark.skipif(not ingest_available(), reason="native ingest library unavailable")
def test_native_kind16_parse_equals_python_decode():
    from at2_node_tpu_torch.native.ingest import parse_frames_native

    kp = _pair(14, 1)[0][0]
    wm, ranges, dird = _digests(2)
    good = port_msgs.CertSig.create(kp, 0, 7, wm, ranges, dird).encode()
    seed = int(np.random.default_rng(14).integers(1 << 31))
    rng, ref_rng = random.Random(seed), random.Random(seed)
    frames = [good] + [mutate_cert_frame(good, rng) for _ in range(48)]
    assert frames[1:] == [ref_mutate_cert_frame(good, ref_rng) for _ in range(48)]
    native, frame_ok = parse_frames_native(frames)
    for fi, ok in enumerate(frame_ok):
        try:
            py, py_ok = port_msgs.parse_frame(frames[fi]), True
        except Exception:
            py, py_ok = [], False
        try:
            ref, ref_ok = ref_msgs.parse_frame(frames[fi]), True
        except Exception:
            ref, ref_ok = [], False
        assert bool(ok) == py_ok == ref_ok, f"frame {fi}"
        if py_ok:
            assert [m for gi, m in native if gi == fi] == py, f"frame {fi}"
            assert [m.encode() for m in py] == [m.encode() for m in ref]


# -- the assembler ----------------------------------------------------------


def test_assembler_quorum_duplicates_and_counters_equal():
    port_kps, _ = _pair(15)
    asm, ref = _assemblers(port_kps)
    assert asm.quorum == ref.quorum == 3
    assert asm.members == ref.members
    sigs = _cosigs(port_kps, 0, 3)
    outsider = SignKeyPair(_seeds(99, 1)[0])
    wm, ranges, dird = _digests(3)
    seq = [sigs[0], sigs[0], sigs[1], sigs[2], sigs[3],
           port_msgs.CertSig.create(outsider, 0, 1, wm, ranges, dird),
           port_msgs.CertSig.create(port_kps[0], 9, 1, wm, ranges, dird),
           dataclasses.replace(sigs[3], signature=bytes(64))]
    pairs = _feed(asm, ref, seq)
    assert [a == b for a, b in pairs] == [True] * len(seq)
    assert [a is not None for a, _ in pairs] == [False, False, False, True, False, False, False, False]
    assert asm.status() == ref.status()
    assert asm.stats() == ref.stats()
    assert asm.export() == ref.export()
    assert asm.counters == {"cosigs": 8, "foreign": 1, "epoch_skew": 1, "bad_sig": 1,
                            "duplicates": 1, "equivocations": 0, "assembled": 1}


@pytest.mark.parametrize("quorum,history", [(0, 8), (2, 2), (4, 1)])
def test_assembler_chains_equal_over_many_frontiers(quorum, history):
    port_kps, _ = _pair(16, 5)
    asm, ref = _assemblers(port_kps, quorum=quorum, history=history)
    rng = np.random.default_rng(quorum * 10 + history)
    cosigs = []
    for k in range(6):
        batch = _cosigs(port_kps, 0, 100 + k, commits0=10 * k)
        cosigs += [batch[int(i)] for i in rng.permutation(len(batch))]
    assert all(a == b for a, b in _feed(asm, ref, cosigs))
    assert [c.encode() for c in asm.chain] == [c.encode() for c in ref.chain]
    assert len(asm.chain) == min(history, 6)
    assert asm.status() == ref.status() and asm.stats() == ref.stats()
    assert asm.export() == ref.export()


def test_equivocation_evidence_equal():
    port_kps, _ = _pair(17)
    asm, ref = _assemblers(port_kps)
    wm, ranges, dird = _digests(4)
    first = port_msgs.CertSig.create(port_kps[0], 0, 5, wm, ranges, dird)
    conflicting = port_msgs.CertSig.create(port_kps[0], 0, 5, wm, bytes(x ^ 0xFF for x in ranges), dird)
    forged = dataclasses.replace(conflicting, signature=bytes(64))
    _feed(asm, ref, [first, forged])
    assert asm.equivocation is None and ref.equivocation is None
    _feed(asm, ref, [conflicting] + _cosigs(port_kps, 0, 5, commits0=20))
    assert asm.equivocation == ref.equivocation
    assert asm.equivocation["origin"] == port_kps[0].public.hex()
    assert asm.status() == ref.status() and asm.export() == ref.export()
    assert asm.counters["equivocations"] == ref.counters["equivocations"] == 1


def test_reconfigure_drops_old_epoch_buckets_alike():
    port_kps, _ = _pair(18, 7)
    asm, ref = _assemblers(port_kps[:4])
    _feed(asm, ref, _cosigs(port_kps[:4], 0, 6)[:2])
    asm.reconfigure([kp.public for kp in port_kps], 1)
    ref.reconfigure([kp.public for kp in port_kps], 1)
    assert asm.status() == ref.status() and asm.quorum == ref.quorum == 5
    assert all(a == b for a, b in _feed(asm, ref, _cosigs(port_kps, 1, 7)))
    assert asm.latest.encode() == ref.latest.encode()


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_export_restore_across_packages(direction):
    port_kps, _ = _pair(19)
    members = [kp.public for kp in port_kps]
    asm, ref = _assemblers(port_kps)
    _feed(asm, ref, _cosigs(port_kps, 0, 8))
    wm, ranges, dird = _digests(9)
    _feed(asm, ref, [port_msgs.CertSig.create(port_kps[1], 0, 1, wm, ranges, dird),
                     port_msgs.CertSig.create(port_kps[1], 0, 1, wm, bytes(128), dird)])
    assert asm.equivocation is not None
    to_ref = direction == "port_to_reference"
    src = asm if to_ref else ref
    dst = RefAssembler(members) if to_ref else CertAssembler(members)
    same = CertAssembler(members) if to_ref else RefAssembler(members)
    doc = json.loads(json.dumps(src.export()))  # the store manifest's JSON seam
    dst.restore(doc)
    same.restore(doc)
    assert [c.encode() for c in dst.chain] == [c.encode() for c in src.chain]
    assert dst.equivocation == src.equivocation
    assert dst.export() == same.export() == src.export()
    assert dst.counters["assembled"] == 0
    # a restored frontier is never assembled again
    for c in _cosigs(port_kps, 0, 8):
        assert dst.add(_to_ref(c) if to_ref else c) is None


# -- the light client ---------------------------------------------------------


def _mutants(chain: list) -> dict:
    last = chain[-1]
    flip = bytearray(last.sigs)
    flip[5] ^= 0x40
    return {
        "clean": chain,
        "flipped_signature": chain[:-1] + [dataclasses.replace(last, sigs=bytes(flip))],
        "wrong_epoch": chain[:-1] + [dataclasses.replace(last, epoch=last.epoch + 1)],
        "reordered": [chain[-1]] + chain[:-1],
        "altered_ranges": chain[:-1] + [dataclasses.replace(last, ranges=bytes(x ^ 0xFF for x in last.ranges))],
        "bitmap_bits": chain[:-1] + [dataclasses.replace(last, bitmap=bytes([last.bitmap[0] ^ 0x0F]))],
        "dropped_signature": chain[:-1] + [dataclasses.replace(last, sigs=last.sigs[:-64])],
        "rotated_signatures": chain[:-1] + [dataclasses.replace(last, sigs=last.sigs[64:] + last.sigs[:64])],
        "ragged_blob": chain[:-1] + [dataclasses.replace(last, sigs=last.sigs[:-1])],
    }


@pytest.mark.parametrize("mutant", list(_mutants(_chain(_pair(20)[0])).keys()))
def test_light_verdicts_equal_on_clean_and_mutated_chains(mutant):
    port_kps, _ = _pair(20)
    keys = [kp.public for kp in port_kps]
    chain = _mutants(_chain(port_kps))[mutant]
    ref_chain = [RefCertificate(**dataclasses.asdict(c)) for c in chain]
    verifiers = [
        (lambda m: m(keys, total=4)),  # f+1 of the genesis keys
        (lambda m: m(keys[:2], total=4)),  # a subset of f+1 keys
        (lambda m: m(keys[:1], total=4)),  # fewer keys than f+1
        (lambda m: m(keys, threshold=3)),
        (lambda m: m([], members=keys)),  # the full member list
        (lambda m: m([], members=keys, quorum=4)),
    ]
    verdicts = []
    for make in verifiers:
        mine = verify_chain(chain, make(LightVerifier))
        theirs = ref_verify_chain(ref_chain, make(RefLightVerifier))
        assert mine == theirs, (mutant, mine, theirs)
        for c, rc in zip(chain, ref_chain):
            assert make(LightVerifier).verify(c) == make(RefLightVerifier).verify(rc)
        verdicts.append(mine["ok"])
    if mutant == "clean":
        assert verdicts == [True, True, False, True, True, False]
    elif mutant in ("flipped_signature", "bitmap_bits", "dropped_signature", "rotated_signatures"):
        assert verdicts[4] is False  # full mode refuses every structural mutant
    else:
        assert verdicts == [False] * 6


@pytest.mark.parametrize("total", range(1, 11))
def test_default_threshold_and_schemes_equal(total):
    assert port_light.default_threshold(total) == ref_light.default_threshold(total)
    assert port_scheme.SCHEME_IDS == ref_scheme.SCHEME_IDS
    mine, theirs = port_scheme.get_scheme("multi_eddsa"), ref_scheme.get_scheme("multi_eddsa")
    blob = np.random.default_rng(total).bytes(64 * total)
    assert mine.split(blob) == theirs.split(blob)
    assert mine.aggregate(mine.split(blob)) == blob
    assert port_scheme.scheme_by_id(1).name == "multi_eddsa"


# -- the fleet on the CPU -------------------------------------------------------


async def _wait(pred, what, timeout=TIMEOUT):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if pred():
            return
        await asyncio.sleep(0.05)
    raise TimeoutError(f"{what} not reached within {timeout} s")


def _fleet_configs(seed: int, **tables):
    ports = iter(chip_smoke.free_ports(8))
    return make_net_configs(4, ports, seed=seed, echo_threshold=2, ready_threshold=2,
                            verifier=VerifierConfig(kind="cpu"), finality=FinalityConfig(enabled=True),
                            observability=ObservabilityConfig(audit_every=8), **tables)


async def _drive(cfgs, services, seed: int, per_client: int = 16):
    """64 transfers: four seeded clients, client c through node c."""
    rng = np.random.default_rng(seed)
    clients = [SignKeyPair(rng.bytes(32)) for _ in range(4)]

    async def send(c):
        async with Client(f"http://{cfgs[c].rpc_address}") as conn:
            await conn.send_asset_many(clients[c], [(s, clients[(c + 1) % 4].public, 1 + s % 5)
                                                    for s in range(1, per_client + 1)])

    before = [s.committed for s in services]
    await asyncio.gather(*(send(c) for c in range(4)))
    await _wait(lambda: all(s.committed >= b + 4 * per_client for s, b in zip(services, before)), "commits")
    await _wait(lambda: all(s.certs.latest is not None and s.certs.latest.commits >= s.auditor.commits
                            for s in services), "a certificate covering every node's frontier")
    return clients


async def test_fleet_chains_pass_the_reference_light_client():
    cfgs = _fleet_configs(31)
    services = [await Service.start(c) for c in cfgs]
    try:
        clients = await _drive(cfgs, services, 32)
        keys = [c.sign_key.public for c in cfgs]
        subset, full = RefLightVerifier(keys, total=4), RefLightVerifier([], members=keys)
        for svc in services:
            chain = [RefCertificate.decode(c.encode()) for c in svc.certs.chain]
            assert chain, svc.certs.status()
            assert ref_verify_chain(chain, subset)["ok"] and ref_verify_chain(chain, full)["ok"]
            assert svc.certs.equivocation is None
            assert svc._finality_status()["lag"] == 0
        assert len({svc.certs.latest.preimage() for svc in services}) == 1
        async with Client(f"http://{cfgs[1].rpc_address}") as conn:
            enabled, epoch, frontier, certs = await conn.get_certificates()
            assert enabled and epoch == 0 and frontier == services[1].auditor.commits
            assert [c.encode() for c in certs] == [c.encode() for c in services[1].certs.chain]
            cert = await conn.wait_final(clients[2].public, 16, verifier=LightVerifier(keys, total=4),
                                         timeout_s=10.0)
            assert cert.commits >= frontier
        doc = json.loads(services[0].obs_http("/certz")[2])
        assert doc["members"] == sorted(k.hex() for k in keys) and doc["quorum"] == 3
        assert [Certificate.from_doc(d) for d in doc["chain"]] == services[0].certs.chain
    finally:
        for s in services:
            await s.close()


async def test_fleet_node_restarted_from_its_store_keeps_its_chain(tmp_path):
    cfgs = _fleet_configs(33)
    for i, cfg in enumerate(cfgs):
        cfg.store = StoreConfig(dir=str(tmp_path / f"store{i}"), flush_interval=0.2)
    services = [await Service.start(c) for c in cfgs]
    try:
        await _drive(cfgs, services, 34)
        tail = [c.encode() for c in services[0].certs.chain]
        assert tail
        await services[0].close()
        services[0] = await Service.start(cfgs[0])
        assert [c.encode() for c in services[0].certs.chain] == tail
        # a restored frontier is not certified again; the next one is
        clients = await _drive(cfgs, services, 35, per_client=8)
        assert services[0].certs.latest.commits == services[0].auditor.commits > Certificate.decode(tail[-1]).commits
        assert len(clients) == 4
    finally:
        for s in services:
            await s.close()


async def test_fleet_on_the_thread_sharded_plane_certifies():
    cfgs = _fleet_configs(36, plane=PlaneConfig(shards=2, executor="thread"))
    services = [await Service.start(c) for c in cfgs]
    try:
        assert {s.broadcast.plane_info()["shards"] for s in services} == {2}
        await _drive(cfgs, services, 37)
        keys = [c.sign_key.public for c in cfgs]
        for svc in services:
            assert verify_chain(list(svc.certs.chain), LightVerifier([], members=keys))["ok"]
    finally:
        for s in services:
            await s.close()


async def test_finality_disabled_is_inert():
    cfgs = make_net_configs(2, iter(chip_smoke.free_ports(4)), seed=38, verifier=VerifierConfig(kind="cpu"))
    services = [await Service.start(c) for c in cfgs]
    try:
        for svc in services:
            assert svc.certs is None and svc._finality_status() == {"enabled": False}
            assert svc.obs_http("/certz") is None
        async with Client(f"http://{cfgs[0].rpc_address}") as conn:
            enabled, _, _, certs = await conn.get_certificates()
            assert not enabled and certs == []
            with pytest.raises(RuntimeError, match="no \\[finality\\] table"):
                await conn.wait_final(b"\1" * 32, 0, timeout_s=1.0)
    finally:
        for s in services:
            await s.close()

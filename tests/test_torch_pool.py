"""The port's device pool (``at2_node_tpu_torch/parallel/pool.py``) on the
CPU, against the JAX package's pool (``at2_node_tpu/parallel/pool.py``).

A pool of ``["cpu"] * k`` runs each shard's plain PyTorch version, so the
split, the shard seams and the joined bitmask run here as on the card.
The fast tier holds the pool's verdicts to the reference's bucket policy,
its python-int verifier and ``CudaBatchVerifier(device="cpu")``; the slow
twin holds them to the reference's sharded graph on the conftest's
8-device virtual mesh (a fresh XLA-CPU compile of ~3 minutes). Then the
reference's ``tests/test_pool.py`` cases over ``["cpu"] * 2``, the
partial-override guard of ``CudaBatchVerifier``, and the rule that
nothing falls back to the CPU without being asked.
"""

import asyncio

import numpy as np
import pytest
import torch

import chip_smoke
from at2_node_tpu.crypto import _fallback as ref_fallback
from at2_node_tpu.parallel import pool as ref_pool
from at2_node_tpu_torch import entry
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.crypto.verifier import CudaBatchVerifier, make_verifier
from at2_node_tpu_torch.node.config import VerifierConfig
from at2_node_tpu_torch.ops import cuda_verify
from at2_node_tpu_torch.ops import ed25519 as kernel
from at2_node_tpu_torch.parallel import pool

# These tensors are small: more intra-op threads only spin, and take
# cores from the tests that run beside these in other processes.
torch.set_num_threads(1)

L = 2**252 + 27742317777372353535851937790883648493
TAMPER = ("r_flip", "s_flip", "msg_flip", "high_s", "wrong_len")


def _material(n, seed, share=0.02):
    """n seeded lanes: ~``share`` of each tamper class, the rest valid,
    shuffled. Returns (pks, msgs, sigs, expected verdicts)."""
    rng = np.random.default_rng(seed)
    keys = [SignKeyPair(rng.bytes(32)) for _ in range(4)]
    lanes = []
    per_class = max(1, round(share * n))
    for c in TAMPER:
        for j in range(per_class):
            kp = keys[j % len(keys)]
            msg = b"%s %d" % (c.encode(), j)
            sig = kp.sign(msg)
            pk = kp.public
            if c == "r_flip":
                sig = bytes([sig[0] ^ 1]) + sig[1:]
            elif c == "s_flip":
                sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
            elif c == "msg_flip":
                msg = msg + b"!"
            elif c == "high_s":
                s = int.from_bytes(sig[32:], "little") + L
                sig = sig[:32] + s.to_bytes(32, "little")
            else:
                sig = sig[:63]
            lanes.append((pk, msg, sig, False))
    for i in range(n - len(lanes)):
        kp = keys[i % len(keys)]
        msg = b"pool lane %d" % i
        lanes.append((kp.public, msg, kp.sign(msg), True))
    lanes = [lanes[i] for i in rng.permutation(n)]
    return ([x[0] for x in lanes], [x[1] for x in lanes], [x[2] for x in lanes],
            np.array([x[3] for x in lanes]))


def _reference_verdict(pk, msg, sig) -> bool:
    try:
        ref_fallback.ed25519_verify(pk, msg, sig)
        return True
    except Exception:
        return False


def _items(n, tamper_every=None):
    """The reference's ``tests/test_pool.py`` ``_sigs``: one key, a
    flipped S bit every ``tamper_every`` lanes."""
    kp = SignKeyPair.from_hex("11" * 32)
    out = []
    for i in range(n):
        msg = b"pool message %d" % i
        sig = kp.sign(msg)
        if tamper_every and i % tamper_every == 0:
            sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
        out.append((kp.public, msg, sig))
    return out


# -- the bucket policy -------------------------------------------------------


def test_bucket_ladders_agree():
    assert kernel.BUCKETS == ref_pool.kernel.BUCKETS


@pytest.mark.parametrize("n_devices", range(1, 9))
def test_pool_bucket_for_matches_reference(n_devices):
    rng = np.random.default_rng(n_devices)
    ns = sorted(set(rng.integers(0, 70_001, 400).tolist())
                | {0, 1, 63, 64, 65, 255, 256, 257, 4095, 4096, 65535, 65536, 65537, 70_000})
    q = pool._pool_quantum(n_devices)
    for n in ns:
        assert pool.pool_bucket_for(n, n_devices) == ref_pool.pool_bucket_for(n, n_devices), n
        assert pool.pool_bucket_for(n, n_devices, q) == ref_pool.pool_bucket_for(n, n_devices, q), n
        b = pool.pool_bucket_for(n, n_devices, q)
        assert b >= n and b % q == 0


@pytest.mark.parametrize("n_devices", [1, 2, 3, 8])
def test_quantum_is_a_whole_bitmask_byte_a_shard(n_devices):
    assert pool._pool_quantum(n_devices) == 8 * n_devices
    with pytest.raises(ValueError, match="quantum"):
        pool.verify_batch_sharded(*zip(*_items(3)), devices=["cpu"] * n_devices,
                                  batch_size=8 * n_devices + 4)


# -- verdicts ------------------------------------------------------------------


def test_pool_verdicts_match_reference_verifier_and_cuda_cpu():
    """64 seeded lanes with ~2% of each tamper class, split over eight CPU
    shards of 8 lanes: the pool's verdicts equal the reference's python-int
    verifier's, the expected ones, and ``CudaBatchVerifier(device="cpu")``'s
    on the same rows (exact: integer math)."""
    pks, msgs, sigs, expect = _material(64, seed=61)
    out = pool.verify_batch_sharded(pks, msgs, sigs, devices=["cpu"] * 8, batch_size=64)
    ref = np.array([_reference_verdict(*x) for x in zip(pks, msgs, sigs)])
    assert (out == expect).all() and (out == ref).all()

    async def cuda_cpu():
        ver = CudaBatchVerifier(device="cpu", batch_size=64, max_delay=0.001, mode="per_sig")
        try:
            return await ver.verify_many(list(zip(pks, msgs, sigs)))
        finally:
            await ver.close()

    assert asyncio.run(cuda_cpu()) == out.tolist()


@pytest.mark.slow
def test_pool_verdicts_match_reference_sharded_graph():
    """The twin against the reference's ``verify_batch_sharded`` on the
    8-device virtual mesh (a fresh XLA-CPU compile of ~3 minutes)."""
    pks, msgs, sigs, expect = _material(64, seed=62)
    out = pool.verify_batch_sharded(pks, msgs, sigs, devices=["cpu"] * 8, batch_size=64)
    ref = ref_pool.verify_batch_sharded(pks, msgs, sigs, batch_size=64)
    assert (out == np.asarray(ref)).all() and (out == expect).all()


def _seam_rows(n, shards):
    """n lanes of seeded valid signatures with a tampered lane on each side
    of every seam of a pool of ``shards``; (rows, expected verdicts)."""
    per = -(-n // pool._pool_quantum(shards)) * pool._pool_quantum(shards) // shards
    kp = SignKeyPair(np.random.default_rng(n + shards).bytes(32))
    pks, msgs, sigs = [], [], []
    expect = np.ones(n, dtype=bool)
    for i in range(n):
        msg = b"seam %d" % i
        sig = kp.sign(msg)
        if i % per in (0, per - 1) and 0 < i < n - 1:
            sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
            expect[i] = False
        pks.append(kp.public)
        msgs.append(msg)
        sigs.append(sig)
    rows = np.empty((n, kernel.PACKED_WIDTH), dtype=np.uint8)
    kernel.fill_packed(pks, msgs, sigs, rows)
    return rows, expect


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_ragged_77_across_shard_seams(shards):
    """77 lanes (a partial last byte) padded to whole bitmask bytes a shard:
    tampered lanes on both sides of each seam keep their places, and the
    count is their popcount."""
    rows, expect = _seam_rows(77, shards)
    ok, count = pool.verify_and_count(rows, pool.make_pool_devices(["cpu"] * shards))
    assert ok.shape == (77,) and (ok == expect).all()
    assert count == int(expect.sum())


@pytest.mark.parametrize("n", [77, 1000])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_joined_bitmask_is_the_batch_bitmask(monkeypatch, n, shards):
    """The shards' bitmasks end to end are the batch's, at 77 and 1,000
    lanes: each shard verified by a stand-in whose verdict is a lane's
    valid byte, so every seam lane shows where it lands."""
    def stand_in(rows):
        return kernel.packbits(rows[:, 128] != 0)

    monkeypatch.setattr(cuda_verify, "verify_packed", stand_in)
    rng = np.random.default_rng(n * shards)
    rows = np.zeros((n, kernel.PACKED_WIDTH), dtype=np.uint8)
    rows[:, 128] = rng.integers(0, 2, n)
    q = pool._pool_quantum(shards)
    per = -(-n // q) * q // shards
    for s in range(per, n, per):  # an invalid lane before, a valid one after
        rows[s - 1, 128], rows[s, 128] = 0, 1
    padded = np.zeros((-(-n // q) * q, kernel.PACKED_WIDTH), dtype=np.uint8)
    padded[:n] = rows
    devs = pool.make_pool_devices(["cpu"] * shards)
    bits = pool.finish_sharded(pool.verify_sharded_packed(padded, devs))
    assert (bits == np.packbits(padded[:, 128] != 0)).all()
    ok, count = pool.verify_and_count(rows, devs)
    assert (ok == (rows[:, 128] != 0)).all() and count == int(rows[:, 128].sum())


def test_rows_are_host_rows_of_the_packed_width():
    devs = pool.make_pool_devices(["cpu"] * 2)
    with pytest.raises(ValueError, match="129"):
        pool.verify_sharded_packed(np.zeros((16, 128), np.uint8), devs)
    with pytest.raises(ValueError, match="whole"):
        pool.verify_sharded_packed(np.zeros((24, 129), np.uint8), devs)
    with pytest.raises(ValueError, match="at least one"):
        pool.make_pool_devices([])


# -- PoolVerifier (the reference's tests/test_pool.py:72-152) ------------------


async def test_pool_verifier_async():
    items = _items(20, tamper_every=7)
    v = pool.PoolVerifier(batch_size=64, max_delay=0.01, devices=["cpu"] * 2)
    try:
        results = await v.verify_many(items)
        assert results == [i % 7 != 0 for i in range(20)]
        assert v.signatures_verified == 20
        assert v.batches_dispatched >= 1
        assert v.router.mode == "per_sig"
    finally:
        await v.close()


async def test_make_verifier_pool_kind():
    v = make_verifier("pool", batch_size=60, devices=["cpu"] * 2)
    try:
        assert type(v) is pool.PoolVerifier and v.batch_size == 64
        (pk, msg, sig), = _items(1)
        assert await v.verify(pk, msg, sig) is True
        assert await v.verify(pk, b"wrong", sig) is False
    finally:
        await v.close()


async def test_two_node_net_shares_one_pool_verifier():
    """BASELINE config 5's shape at test scale: two full nodes send every
    signature check into one pool (``Service.start(verifier=...)``) and a
    transfer commits."""
    from at2_node_tpu_torch.client import Client
    from at2_node_tpu_torch.node.service import Service
    from at2_node_tpu_torch.tools._common import make_net_configs

    shared = pool.PoolVerifier(batch_size=64, max_delay=0.005, devices=["cpu"] * 2)
    await shared.warmup()
    cfgs = make_net_configs(2, iter(chip_smoke.free_ports(4)), seed=66)
    services = []
    rng = np.random.default_rng(67)
    try:
        for cfg in cfgs:
            services.append(await Service.start(cfg, verifier=shared))
        async with Client(f"http://{cfgs[0].rpc_address}") as client:
            sender, recipient = SignKeyPair(rng.bytes(32)), SignKeyPair(rng.bytes(32))
            await client.send_asset(sender, 1, recipient.public, 40)
            deadline = asyncio.get_running_loop().time() + 60
            while asyncio.get_running_loop().time() < deadline:
                if await client.get_last_sequence(sender.public) == 1:
                    break
                await asyncio.sleep(0.1)
            assert await client.get_balance(sender.public) == 99_960
        assert shared.signatures_verified > 0
        assert shared.batches_dispatched > 0
    finally:
        for s in services:
            await s.close()
        await shared.close()


async def test_pool_stages_are_the_ones_that_run(monkeypatch):
    """``PoolVerifier`` overrides the stages, so the base class's pipeline
    and warm-up run them: one split upload, one launch a shard and one
    joined finish a batch."""
    calls = {"upload": 0, "launch": 0, "finish": 0}
    for name, key in (("upload_sharded", "upload"), ("launch_sharded", "launch"),
                      ("finish_sharded", "finish")):
        real = getattr(pool, name)

        def spy(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(pool, name, spy)
    v = pool.PoolVerifier(batch_size=16, max_delay=0.005, devices=["cpu"] * 2)
    try:
        assert v._staged_overrides_consistent()
        await v.warmup()
        warm = dict(calls)
        assert warm["upload"] == warm["launch"] == warm["finish"] >= 2
        assert await v.verify_many(_items(24, tamper_every=5)) == [i % 5 != 0 for i in range(24)]
        batches = v.batches_dispatched - 1  # the warm-up's verify
        for key in calls:
            assert calls[key] - warm[key] == batches
    finally:
        await v.close()


# -- the partial-override guard ----------------------------------------------


class _RunBatchOnly(CudaBatchVerifier):
    """Overrides ``_run_batch`` alone: a lane is valid when its message does
    not end in "!" (the signatures are garbage, so the real stages would
    reject every lane)."""

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.runs = 0

    def _run_batch(self, pks, msgs, sigs, bucket):
        self.runs += 1
        return np.array([not m.endswith(b"!") for m in msgs])

    def _run_batch_rlc(self, pks, msgs, sigs, bucket):
        raise AssertionError("the RLC stages ran past the subclass's _run_batch")


@pytest.mark.parametrize("mode", ["per_sig", "rlc"])
async def test_subclass_overriding_only_run_batch_is_honoured(mode):
    v = _RunBatchOnly(batch_size=8, max_delay=0.001, mode=mode)
    try:
        assert not v._staged_overrides_consistent()
        await v.warmup()
        assert v.runs == 2  # one bucket, then the flush path's verify
        items = [(b"p" * 32, b"m%d" % i + (b"!" if i % 3 == 0 else b""), b"s" * 64)
                 for i in range(20)]
        assert await v.verify_many(items) == [i % 3 != 0 for i in range(20)]
        assert v.runs == 2 + v.batches_dispatched - 1
        assert v.rlc_batches == 0
    finally:
        await v.close()


def test_unmodified_verifier_runs_its_stages():
    async def run():
        v = CudaBatchVerifier(device="cpu", batch_size=8)
        try:
            return v._staged_overrides_consistent()
        finally:
            await v.close()

    assert asyncio.run(run())


# -- no hidden fallback --------------------------------------------------------


@pytest.mark.parametrize("build", ["PoolVerifier", "make_pool_devices", "config", "dryrun"])
def test_without_a_gpu_the_pool_raises(build):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the pool builds")
    fns = {
        "PoolVerifier": lambda: pool.PoolVerifier(),
        "make_pool_devices": lambda: pool.make_pool_devices(),
        "config": lambda: VerifierConfig(kind="pool").make(),
        "dryrun": lambda: entry.dryrun_multichip(2),
    }
    with pytest.raises(RuntimeError, match="CUDA device"):
        fns[build]()


def test_a_cuda_entry_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pool.make_pool_devices(["cpu", "cuda:0"])

"""CudaBatchVerifier on the CPU (``device="cpu"``) against the dispatch
contract of the JAX package's ``TpuBatchVerifier`` (tests/test_pipeline.py
and tests/test_rlc_verify.py): stage overlap, bounded FIFO flood, adaptive
bucket shaping, close and cancel hygiene, stats, staging-pool reuse,
device and mode rules, and the RLC route (exact verdicts, fallbacks and
reroutes counted, the router's default, its warm-up, capacity released
while a flush resolves)."""

import asyncio
import threading
import time

import numpy as np
import pytest
import torch

from at2_node_tpu.crypto.verifier import TpuBatchVerifier
from at2_node_tpu_torch.crypto import _fallback as fb
from at2_node_tpu_torch.crypto.keys import SignKeyPair, verify_one
from at2_node_tpu_torch.crypto.verifier import CudaBatchVerifier, make_verifier
from at2_node_tpu_torch.ops import ed25519 as kernel

# These tensors are small: more intra-op threads only spin, and take
# cores from the tests that run beside these in other processes.
torch.set_num_threads(1)


def _items(n, tag=b"m"):
    return [(b"p" * 32, tag + str(i).encode(), b"s" * 64) for i in range(n)]


class FakeDevice(CudaBatchVerifier):
    """Stage hooks that log (stage, edge, batch_seq, t) instead of running
    the verify; the handle threaded through is (batch_seq, n, bucket)."""

    def __init__(self, *a, prep_s=0.0, launch_s=0.0, finish_s=0.0, **kw):
        super().__init__(*a, device="cpu", **kw)
        self.events = []
        self.prep_log = []
        self._seq = 0
        self._prep_s, self._launch_s, self._finish_s = prep_s, launch_s, finish_s

    def _stage(self, stage, seq, delay):
        self.events.append((stage, "start", seq, time.monotonic()))
        if delay:
            time.sleep(delay)
        self.events.append((stage, "end", seq, time.monotonic()))

    def _prep(self, pks, msgs, sigs, bucket):
        seq = self._seq
        self._seq += 1
        self._stage("prep", seq, self._prep_s)
        self.prep_log.append((seq, len(pks), bucket, list(msgs)))
        return (seq, len(pks), bucket)

    def _launch(self, prepared):
        self._stage("launch", prepared[0], self._launch_s)
        return prepared

    def _finish(self, handle, n):
        self._stage("finish", handle[0], self._finish_s)
        return np.ones(n, dtype=bool)

    def edge(self, stage, edge, seq):
        for s, e, q, t in self.events:
            if (s, e, q) == (stage, edge, seq):
                return t
        raise AssertionError(f"no event {(stage, edge, seq)}")


async def test_overlap_next_prep_starts_before_prior_finish_ends():
    ver = FakeDevice(batch_size=4, max_delay=0.001, prep_s=0.01, finish_s=0.05)
    assert await ver.verify_many(_items(24)) == [True] * 24
    assert ver.batches_dispatched == 6
    overlapped = sum(
        1 for seq in range(1, 6)
        if ver.edge("prep", "start", seq) < ver.edge("finish", "end", seq - 1)
    )
    assert overlapped >= 3, f"only {overlapped}/5 successor preps overlapped"
    await ver.close()


async def test_backpressure_flood_is_bounded_and_fifo():
    ver = FakeDevice(batch_size=4, max_delay=0.001, max_queue=8, finish_s=0.005)
    callers = [
        asyncio.ensure_future(ver.verify_many(_items(16, tag=b"c%d-" % c)))
        for c in range(4)
    ]
    for r in await asyncio.gather(*callers):
        assert r == [True] * 16
    assert ver.queue_peak <= ver.max_queue
    order = {}
    for _seq, _n, _bucket, batch_msgs in ver.prep_log:
        for m in batch_msgs:
            caller, idx = m.split(b"-", 1)
            order.setdefault(caller, []).append(int(idx))
    assert len(order) == 4
    for caller, idx in order.items():
        assert idx == sorted(idx), f"caller {caller} reordered: {idx}"
    assert ver._cap_free == ver.max_queue
    await ver.close()


@pytest.mark.parametrize(
    "batch_size, max_delay, buckets, n, want",
    [(16, 0.01, (4, 8, 16), 3, [4]), (4, 10.0, (4, 16), 16, [16])],
    ids=["timer_flush_shrinks", "backlog_coalesces"],
)
async def test_adaptive_bucket_shaping(batch_size, max_delay, buckets, n, want):
    ver = FakeDevice(batch_size=batch_size, max_delay=max_delay, buckets=buckets)
    assert await ver.verify_many(_items(n)) == [True] * n
    assert [b for _, _, b, _ in ver.prep_log] == want
    await ver.close()


async def test_close_releases_parked_acquirer_with_wedged_device():
    ver = FakeDevice(batch_size=4, max_delay=0.001, max_queue=4, finish_s=0.4)
    first = asyncio.ensure_future(ver.verify_many(_items(24)))
    await asyncio.sleep(0.05)
    parked = asyncio.ensure_future(ver.verify_many(_items(4, tag=b"x-")))
    await asyncio.sleep(0.05)
    assert not parked.done()
    closer = asyncio.ensure_future(ver.close())
    with pytest.raises(RuntimeError, match="closed"):
        await asyncio.wait_for(asyncio.shield(parked), timeout=0.2)
    await closer
    await asyncio.gather(first, return_exceptions=True)


async def test_cancelled_caller_releases_reserved_capacity():
    ver = FakeDevice(batch_size=64, max_delay=30.0, max_queue=8)
    caller = asyncio.ensure_future(ver.verify_many(_items(6)))
    await asyncio.sleep(0.02)
    assert ver._cap_free == 2
    caller.cancel()
    await asyncio.gather(caller, return_exceptions=True)
    assert ver._cap_free == ver.max_queue, "cancelled capacity leaked"
    assert not ver._queue
    nxt = asyncio.ensure_future(ver.verify_many(_items(8, tag=b"y")))
    await asyncio.sleep(0.02)
    assert ver._cap_free == 0
    nxt.cancel()
    await asyncio.gather(nxt, return_exceptions=True)
    await ver.close()


async def test_stats_keys_and_counters_match_reference():
    ver = FakeDevice(batch_size=4, max_delay=0.001, finish_s=0.01)
    assert await ver.verify_many(_items(16)) == [True] * 16
    st = ver.stats()
    ref = TpuBatchVerifier(batch_size=4, max_delay=0.001)
    assert set(st) == set(ref.stats())
    await ref.close()
    assert st["batches"] == 4 and st["signatures"] == 16
    assert st["batch_occupancy"] == 1.0 and st["padding_ratio"] == 0.0
    assert st["capacity_free"] == st["max_queue"] and st["queue_depth"] == 0
    assert st["finish_ms_avg"] > 0.0 and st["avg_dispatch_ms"] > 0.0
    assert st["route_per_sig"] == 4 and st["route_rlc"] == 0 and st["mode_name"] == "auto"
    hists = ver.stage_histograms()
    assert set(hists) == {"queue_wait", "prep", "launch", "finish", "dispatch"}
    assert hists["finish"]["count"] == 4
    await ver.close()
    assert ver.stats()["capacity_free"] == ver.max_queue


def test_finish_packed_bitmask_roundtrip():
    rng = np.random.default_rng(3)
    for n in (1, 5, 8, 12, 64, 129):
        verdicts = rng.integers(0, 2, size=n).astype(bool)
        handle = kernel._InFlight(torch.from_numpy(np.packbits(verdicts)), None, None)
        out = kernel.finish_packed(handle, n)
        assert out.dtype == bool and out.shape == (n,)
        assert (out == verdicts).all(), n


def test_staging_buffer_returns_to_pool_only_after_finish():
    pool = kernel.StagingPool(pinned=False)
    kp = SignKeyPair(bytes(range(32)))
    items = ([kp.public] * 3, [b"a", b"b", b"c"], [kp.sign(b"a"), kp.sign(b"x"), kp.sign(b"c")])
    host = kernel.prep_packed(*items, 8, pool)
    assert host.shape == (8, kernel.PACKED_WIDTH) and pool.free_count(8) == 0
    handle = kernel.launch_packed(kernel.upload_packed(host, torch.device("cpu")))
    assert pool.free_count(8) == 0, "released before the batch finished"
    assert kernel.finish_packed(handle, 3, pool).tolist() == [True, False, True]
    assert pool.free_count(8) == 1
    again = kernel.prep_packed(items[0][:1], items[1][:1], items[2][:1], 8, pool)
    assert again is host and pool.free_count(8) == 0
    assert host.numpy()[1:, :].any() == False  # noqa: E712  stale lanes were zeroed
    pool.release(again)
    for _ in range(3 * kernel.StagingPool.CAP_PER_BUCKET):
        pool.release(torch.empty((8, kernel.PACKED_WIDTH), dtype=torch.uint8))
    assert pool.free_count(8) == kernel.StagingPool.CAP_PER_BUCKET


async def test_real_stages_verify_on_cpu_after_warmup():
    kp = SignKeyPair(bytes(range(1, 33)))
    msgs = [b"t%d" % i for i in range(10)]
    sigs = [kp.sign(m) for m in msgs]
    sigs[4] = bytes([sigs[4][0] ^ 2]) + sigs[4][1:]
    ver = make_verifier("cuda", device="cpu", batch_size=8, max_delay=0.001, buckets=(8, 16))
    await ver.warmup()
    got = await ver.verify_many(list(zip([kp.public] * 10, msgs, sigs)))
    assert got == [i != 4 for i in range(10)]
    assert await ver.verify(kp.public, msgs[0], sigs[0])
    await ver.close()
    with pytest.raises(RuntimeError, match="closed"):
        await ver.verify_many(_items(1))


async def test_device_none_means_the_gpu():
    if torch.cuda.is_available():
        ver = CudaBatchVerifier()
        assert ver.device == torch.device("cuda", 0)
        await ver.close()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CudaBatchVerifier()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_verifier("cuda")


async def test_rlc_modes_and_other_kinds_raise():
    """``mode="rlc"``, and ``auto`` with ``rlc_min_batch``, take the CUDA
    verifier's RLC route (its plain version here) and verify exactly; an
    unknown mode and the kinds this build does not have raise; ``"pool"``
    takes a device list, not a device."""
    kp = SignKeyPair(bytes(range(2, 34)))
    items = [(kp.public, b"a", kp.sign(b"a")), (kp.public, b"b", kp.sign(b"x"))]
    for kw in (dict(mode="rlc"), dict(mode="auto", rlc_min_batch=2)):
        ver = CudaBatchVerifier(device="cpu", batch_size=2, max_delay=0.001, **kw)
        assert await ver.verify_many(items) == [True, False]
        st = ver.stats()
        assert st["route_rlc"] == st["rlc_batches"] == st["rlc_fallbacks"] == 1
        assert st["mode_name"] == kw["mode"]
        await ver.close()
    with pytest.raises(ValueError):
        CudaBatchVerifier(device="cpu", mode="fast")
    with pytest.raises(ValueError):
        make_verifier("tpu", device="cpu")
    with pytest.raises(TypeError):
        make_verifier("pool", device="cpu")
    pooled = make_verifier("pool", devices=["cpu"] * 2, batch_size=2)
    assert type(pooled).__name__ == "PoolVerifier" and pooled.batch_size == 16
    assert await pooled.verify_many(items) == [True, False]
    await pooled.close()
    # the CPU verifier takes every mode, as the reference's does (its RLC
    # route is the host engine); auto is its default
    for mode in ("auto", "rlc", "per_sig"):
        cpu = make_verifier("cpu", mode=mode)
        assert cpu.stats()["mode_name"] == mode
        await cpu.close()
    cpu = make_verifier("cpu")
    assert cpu.mode == "auto" and cpu.router.min_batch == 128
    await cpu.close()
    with pytest.raises(ValueError):
        make_verifier("cpu", mode="fast")
    ver = CudaBatchVerifier(device="cpu", mode="per_sig", rlc_min_batch=128)
    assert ver.stats()["mode_name"] == "per_sig"
    await ver.close()


def _cpu_items(n, seed=5):
    """n seeded items; of every three, one has a flipped signature bit and
    one a changed message."""
    rng = np.random.default_rng(seed)
    keys = [SignKeyPair(rng.bytes(32)) for _ in range(4)]
    items = []
    for i in range(n):
        kp, msg = keys[i % 4], rng.bytes(40)
        sig = kp.sign(msg)
        if i % 3 == 1:
            j = i % 64
            sig = sig[:j] + bytes([sig[j] ^ 1]) + sig[j + 1:]
        elif i % 3 == 2:
            msg += b"!"
        items.append((kp.public, msg, sig))
    return items


@pytest.mark.parametrize("n", [1, 31, 32, 200])
@pytest.mark.parametrize("native", [True, False])
async def test_cpu_verifier_matches_the_reference_per_sig(n, native, monkeypatch):
    """The per-signature CPU verifier on both of its routes (one native
    OpenSSL call from 32 items, else slices of ``verify_one`` on the pool)
    gives the reference CpuVerifier's verdicts."""
    from at2_node_tpu.crypto.verifier import CpuVerifier as RefCpuVerifier
    from at2_node_tpu_torch.crypto.verifier import CpuVerifier
    from at2_node_tpu_torch.native import ingest

    if not native:
        monkeypatch.setenv("AT2_NO_NATIVE_INGEST", "1")
    items = _cpu_items(n)
    ver = make_verifier("cpu", max_workers=3, mode="per_sig")
    ref = RefCpuVerifier(mode="per_sig")
    assert isinstance(ver, CpuVerifier)
    await ver.warmup()
    assert ingest.ingest_ready() == native
    got = await ver.verify_many(items)
    assert got == await ref.verify_many(items)
    assert got[0] is True and (n < 3 or not all(got))
    assert await ver.verify(*items[0]) is True
    assert await ver.verify_many([]) == []
    st = ver.stats()
    assert set(st) == set(ref.stats())
    assert st["signatures"] == n + 1 and st["mode"] == 0 and st["mode_name"] == "per_sig"
    assert st["route_rlc"] == 0 and st["rlc_batches"] == 0
    await ver.close()
    await ref.close()


# -- the RLC route --------------------------------------------------------


def _torsion_point():
    """An extended point of order 8: [L]Q for a curve point Q off the
    subgroup."""
    for y in range(2, 60):
        try:
            q = fb._pt_decompress(y.to_bytes(32, "little"))
        except Exception:
            continue
        t = fb._pt_mul(kernel.L, q)
        if not fb._pt_equal(t, fb._IDENT):
            return t
    raise AssertionError("no torsion point found")


def _torsion_item(rng, in_key):
    """A signature whose public key (``in_key``) or whose R carries an
    8-torsion component: code 2 (reroute) or code 0 on the RLC route."""
    a, r = (int.from_bytes(rng.bytes(32), "little") % kernel.L for _ in range(2))
    big_a, big_r = fb._pt_mul(a, fb._BASE), fb._pt_mul(r, fb._BASE)
    if in_key:
        big_a = fb._pt_add(big_a, _torsion_point())
    else:
        big_r = fb._pt_add(big_r, _torsion_point())
    a_enc, r_enc, msg = fb._pt_compress(big_a), fb._pt_compress(big_r), rng.bytes(24)
    s = (r + fb._sha512_int(r_enc, a_enc, msg) % kernel.L * a) % kernel.L
    return (a_enc, msg, r_enc + s.to_bytes(32, "little"))


async def test_rlc_flushes_give_exact_verdicts_and_count_fallbacks():
    """Flush 1 holds a tampered lane and a torsioned key (code 2): the
    equation fails and a lane is rerouted, so one exact pass resolves it.
    Flush 2 holds a torsioned R (code 0) among clean lanes: its codes are
    its verdicts. Every verdict equals ``verify_one``'s."""
    rng = np.random.default_rng(60)
    keys = [SignKeyPair(rng.bytes(32)) for _ in range(8)]
    first = [(k.public, b"f%d" % i, k.sign(b"f%d" % i)) for i, k in enumerate(keys)]
    first[2] = (first[2][0], b"tampered", first[2][2])
    first[5] = _torsion_item(rng, in_key=True)
    second = [(k.public, b"s%d" % i, k.sign(b"s%d" % i)) for i, k in enumerate(keys)]
    second[6] = _torsion_item(rng, in_key=False)
    ver = CudaBatchVerifier(device="cpu", mode="rlc", batch_size=8, max_delay=0.001)
    try:
        for items in (first, second):
            assert await ver.verify_many(items) == [verify_one(*it) for it in items]
        st = ver.stats()
    finally:
        await ver.close()
    assert [verify_one(*it) for it in second].count(False) == 1
    assert st["rlc_batches"] == 2 and st["rlc_fallbacks"] == 1 and st["rlc_reroutes"] == 1
    assert st["batches"] == 2 and st["signatures"] == 16 and st["route_rlc"] == 2


class GatedRlc(CudaBatchVerifier):
    """Stage-stubbed verifier (the reference's ``_GatedRlcVerifier``): the
    RLC finish stage blocks on a gate so a test can cancel callers while a
    flush is resolving."""

    def __init__(self, gate, **kw):
        super().__init__(device="cpu", **kw)
        self._gate = gate

    def _prep(self, pks, msgs, sigs, bucket):
        return len(pks)

    def _launch(self, packed):
        return packed

    def _finish(self, handle, n):
        return np.ones(n, dtype=bool)

    def _prep_rlc(self, pks, msgs, sigs, bucket):
        return len(pks)

    def _launch_rlc(self, packed):
        return packed

    def _finish_rlc(self, handle, n):
        self._gate.wait(10.0)
        return True, np.ones(n, dtype=np.uint8)


def _fake(n, tag):
    return [(b"p" * 32, tag + b"%d" % i, b"s" * 64) for i in range(n)]


async def test_cancelled_verify_many_mid_rlc_releases_capacity():
    gate = threading.Event()
    ver = GatedRlc(gate, batch_size=8, max_delay=30.0, max_queue=16, mode="rlc")
    try:
        # a full batch flushes at once and blocks in _finish_rlc
        inflight = asyncio.ensure_future(ver.verify_many(_fake(8, b"in")))
        await asyncio.sleep(0.05)
        assert ver.router.last_route == "rlc"
        # a chunk under batch_size parks in the accumulator with capacity held
        parked = asyncio.ensure_future(ver.verify_many(_fake(4, b"park")))
        await asyncio.sleep(0.05)
        assert ver._cap_free == ver.max_queue - 4
        parked.cancel()
        with pytest.raises(asyncio.CancelledError):
            await parked
        assert ver._cap_free == ver.max_queue and not gate.is_set()
        gate.set()
        assert await inflight == [True] * 8
        assert ver.rlc_batches == 1 and ver.rlc_fallbacks == 0
    finally:
        gate.set()
        await ver.close()
    assert ver._inflight._value == ver.PIPELINE_DEPTH
    assert ver._cap_free == ver.max_queue


@pytest.mark.parametrize("mode", ["auto", "per_sig"])
async def test_auto_without_rlc_min_batch_never_routes_rlc(mode):
    """The reference's device default: plain ``auto`` keeps the
    per-signature kernel, as ``per_sig`` does."""
    gate = threading.Event()
    gate.set()
    ver = GatedRlc(gate, batch_size=8, max_delay=0.001, mode=mode)
    try:
        assert await ver.verify_many(_fake(8, b"auto")) == [True] * 8
        assert ver.rlc_batches == 0 and ver.router.route_rlc == 0
        assert ver.router.route_per_sig == (mode == "auto")
    finally:
        await ver.close()


async def test_rlc_warmup_checks_both_routes(monkeypatch):
    """In mode "rlc" the warm-up also runs the RLC stages at every bucket and
    refuses a route that does not give eq_ok with code 1 for a good
    signature and no eq_ok beside a tampered one."""
    ver = CudaBatchVerifier(device="cpu", mode="rlc", batch_size=4, max_delay=0.001)
    try:
        await ver.warmup()
        assert ver.stats()["rlc_batches"] == 1  # the final request's flush
        monkeypatch.setattr(ver, "_run_batch_rlc", lambda pks, *a: (True, np.ones(len(pks), np.uint8)))
        with pytest.raises(RuntimeError, match="rlc warm-up failed for bucket 4"):
            await ver.warmup()
    finally:
        await ver.close()

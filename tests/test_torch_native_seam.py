"""The CUDA verifier's native seam (``native/at2_seam.cpp``, ``native/seam.py``)
on the CPU, with no card: g++ builds its worker against a host stand-in for
the device calls (``native/at2_seam_host.cpp``: the copies as memcpy, K1 as
the lane math of ``csrc/ed25519_lane_host.cpp``, the host function called
directly or held back). The worker's verdicts, completion order through the
eventfd, ring bound, close, a failed launch, a device fault, its launch
count and its threads; then ``CudaBatchVerifier`` with the stand-in seam
attached (the card's flush path), and the cases whose flushes keep the
Python stages."""

import asyncio
import ctypes
import os

import numpy as np
import pytest
import torch

import chip_smoke
from at2_node_tpu_torch.crypto import verifier as vmod
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.native import seam as seam_mod
from at2_node_tpu_torch.ops import cuda_verify
from at2_node_tpu_torch.ops import ed25519 as kernel

torch.set_num_threads(1)

TWIN_CLASSES = ("r_flip", "s_flip", "msg_flip", "high_s", "noncanonical_y", "x0_sign", "wrong_len")


@pytest.fixture(scope="module")
def lib():
    return seam_mod.load_host()


@pytest.fixture(scope="module")
def material():
    return chip_smoke.Material(23)


@pytest.fixture(scope="module")
def consts():
    return np.ascontiguousarray(cuda_verify.lane_consts())


@pytest.fixture(autouse=True)
def _hooks(request):
    """Every test starts and ends with the stand-in's hooks off."""
    if "lib" not in request.fixturenames:
        yield
        return
    lib = request.getfixturevalue("lib")
    _reset(lib)
    yield
    _reset(lib)


def _reset(lib):
    lib.cdll.at2_seam_host_fault(0)
    lib.cdll.at2_seam_host_hold(0, 0)
    lib.cdll.at2_seam_host_fail_launch(ctypes.c_int64(0))


def _seam(lib, consts, depth=vmod.CudaBatchVerifier.PIPELINE_DEPTH, max_rows=64):
    k1 = ctypes.cast(lib.cdll.at2_seam_host_k1, ctypes.c_void_p).value
    return seam_mod.Seam(lib, device_index=0, depth=depth, max_rows=max_rows, copy_stream=0,
                         compute_stream=0, k1=k1, consts=consts.ctypes.data)


def _hold(lib, launch=False, complete=False):
    lib.cdll.at2_seam_host_hold(int(launch), int(complete))


def _cols(items):
    return [list(c) for c in zip(*items)]


def _twins(material, per_class=2):
    items = list(material.valid[:8])
    for cls in TWIN_CLASSES:
        items += material.tampered[cls][:per_class]
    items += [it for it, _ in material.torsion["r_torsion"][:per_class]]
    return items


def _plain(items, bucket):
    pks, msgs, sigs = _cols(items)
    rows = kernel.prep_packed(pks, msgs, sigs, bucket, kernel.StagingPool(pinned=False))
    return np.unpackbits(kernel.verify_packed(rows).numpy(), count=len(items)).astype(bool).tolist()


async def _run(seam, items, bucket):
    done = asyncio.get_running_loop().create_future()
    seam.submit(*_cols(items), bucket, done.set_result)
    return await done


# -- the worker --------------------------------------------------------------


async def test_verdicts_equal_the_plain_verify_on_every_twin_class(lib, material, consts):
    items = _twins(material)
    seam = _seam(lib, consts)
    seam.attach(asyncio.get_running_loop())
    try:
        c = await _run(seam, items, 32)
    finally:
        await seam.close()
    assert c.error is None and c.launched
    want = _plain(items, 32)
    assert c.verdicts.tolist() == want
    # RFC 8032's strict verdicts: the valid ones and none of the twins
    assert want == [True] * 8 + [False] * (len(items) - 8)
    assert c.t_submit <= c.t_uploaded <= c.t_launched <= c.t_done


async def test_completions_come_back_in_order_through_the_eventfd(lib, material, consts):
    seam = _seam(lib, consts)
    seam.attach(asyncio.get_running_loop())
    order = []
    futs = []
    sizes = [5, 1, 16, 3]
    _hold(lib, complete=True)  # every job reaches the "device"; none completes
    try:
        for j, n in enumerate(sizes):
            fut = asyncio.get_running_loop().create_future()
            futs.append(fut)
            items = material.valid[10 * j: 10 * j + n]

            def done(c, j=j, fut=fut):
                order.append(j)
                fut.set_result(c)

            seam.submit(*_cols(items), 16, done)
        await asyncio.sleep(0.2)
        assert order == [] and len(seam._pending) == 4
        # the held host functions run on this thread; the loop learns of them
        # only through the eventfd, by its reader
        await asyncio.get_running_loop().run_in_executor(None, _hold, lib)
        results = await asyncio.wait_for(asyncio.gather(*futs), 10)
    finally:
        _hold(lib)
        await seam.close()
    assert order == [0, 1, 2, 3]
    assert [c.verdicts.tolist() for c in results] == [[True] * n for n in sizes]


async def test_the_ring_blocks_at_pipeline_depth(lib, material, consts):
    depth = vmod.CudaBatchVerifier.PIPELINE_DEPTH
    seam = _seam(lib, consts, depth=depth)
    seam.attach(asyncio.get_running_loop())
    got = []
    _hold(lib, complete=True)
    try:
        for _ in range(depth):
            seam.submit(*_cols(material.valid[:2]), 8, got.append)
        with pytest.raises(seam_mod.SeamFull):
            seam.submit(*_cols(material.valid[:2]), 8, got.append)
        await asyncio.get_running_loop().run_in_executor(None, _hold, lib)
        for _ in range(100):
            if len(got) == depth:
                break
            await asyncio.sleep(0.02)
        assert len(got) == depth and len(seam._pending) == 0
        # a slot is free again
        assert (await _run(seam, material.valid[:2], 8)).verdicts.tolist() == [True, True]
    finally:
        _hold(lib)
        await seam.close()


async def test_a_failed_launch_fails_only_its_own_job(lib, material, consts):
    seam = _seam(lib, consts)
    seam.attach(asyncio.get_running_loop())
    lib.cdll.at2_seam_host_fail_launch(ctypes.c_int64(2))  # the second K1 call from now
    try:
        futs = []
        for j in range(3):
            fut = asyncio.get_running_loop().create_future()
            seam.submit(*_cols(material.valid[3 * j: 3 * j + 3]), 8, fut.set_result)
            futs.append(fut)
        first, second, third = await asyncio.wait_for(asyncio.gather(*futs), 10)
    finally:
        await seam.close()
    assert first.verdicts.tolist() == third.verdicts.tolist() == [True] * 3
    assert second.verdicts is None and not second.launched
    assert "stand-in launch failed" in str(second.error)


async def test_a_launch_is_counted_when_its_job_then_faults(lib, material, consts):
    seam = _seam(lib, consts)
    seam.attach(asyncio.get_running_loop())
    _hold(lib, complete=True)  # K1 launched, the job still on the "device"
    try:
        fut = asyncio.get_running_loop().create_future()
        seam.submit(*_cols(material.valid[:3]), 8, fut.set_result)
        await asyncio.sleep(0.2)
        assert seam.take_launches() == 1 and not fut.done()
        lib.cdll.at2_seam_host_fault(1)  # the stream reports a fault; the worker's sweep sees it
        c = await asyncio.wait_for(fut, 10)
        assert seam.take_launches() == 0  # counted once, at the launch
    finally:
        _reset(lib)
        await seam.close()
    assert c.launched and c.verdicts is None and "stand-in device fault" in str(c.error)


def _threads() -> int:
    return len(os.listdir("/proc/self/task"))


def _prep_helpers() -> int:
    return min(len(os.sched_getaffinity(0)), 8) - 1


async def test_prep_starts_no_thread_per_flush(lib, material, consts):
    started = lib.threads_started()
    seam = _seam(lib, consts, max_rows=1024)
    seam.attach(asyncio.get_running_loop())
    try:
        # the worker and the prep helpers, all started with the seam
        assert lib.threads_started() == started + 1 + _prep_helpers()
        await _run(seam, material.valid[:27], 256)
        before = _threads()
        for j in range(30):
            c = await _run(seam, material.valid[j: j + 27], 256)
            assert c.verdicts.tolist() == [True] * 27
        # a flush whose prep the helpers share starts none either
        c = await _run(seam, material.valid[:1024], 1024)
        assert c.verdicts.tolist() == [True] * 1024
        assert _threads() == before and lib.threads_started() == started + 1 + _prep_helpers()
    finally:
        await seam.close()


async def test_a_split_prep_puts_every_row_in_its_place(lib, material, consts):
    # 1,024 rows and more are prepped in parts by the helpers: twins spread
    # over every part must keep their own verdicts
    items = list(material.valid[:1010])
    twins = _twins(material)[8:]
    for k, twin in enumerate(twins):
        items.insert(61 * k + 5, twin)
    want = [any(it is v for v in material.valid[:1010]) for it in items]
    assert len(items) >= 1024 and want.count(False) == len(twins)
    seam = _seam(lib, consts, max_rows=len(items))
    seam.attach(asyncio.get_running_loop())
    try:
        c = await _run(seam, items, len(items))
    finally:
        await seam.close()
    assert c.error is None and c.verdicts.tolist() == want


# -- the verifier on the stand-in seam (the card's flush path) -----------------


def _attached(lib, consts, **kw):
    """A verifier whose flushes take the stand-in seam, as a card's take
    the CUDA one (the seam opens at warm-up only on a CUDA device)."""
    ver = vmod.CudaBatchVerifier(device="cpu", **kw)
    ver._native = _seam(lib, consts, max_rows=ver.buckets[-1])
    ver._native.attach(asyncio.get_running_loop())
    return ver


async def test_the_verifier_resolves_flushes_through_the_seam(lib, material, consts):
    ver = _attached(lib, consts, batch_size=16, max_delay=0.001, buckets=(8, 16))
    launches = cuda_verify.launches
    try:
        await ver.warmup()  # every bucket through the seam, then one flush
        warm = ver.stats()
        assert warm["native_batches"] == warm["batches"] == 1
        assert cuda_verify.launches - launches == 3  # two buckets, one flush
        items = _twins(material, per_class=1)
        got = await ver.verify_many(items)
        assert got == [True] * 8 + [False] * (len(items) - 8)
        st = ver.stats()
        assert st["native_batches"] == st["batches"] >= 2
        assert st["seam_resolved"] == st["signatures"] == 1 + len(items)
        assert st["seam_pipeline_s"] > 0 and st["queue_depth"] == 0
        hists = ver.stage_histograms()
        for stage in ("prep", "launch", "finish", "dispatch"):
            assert hists[stage]["count"] == st["batches"]
    finally:
        await ver.close()
    assert ver._inflight._value == ver.PIPELINE_DEPTH and ver._cap_free == ver.max_queue


async def test_the_flusher_waits_at_pipeline_depth_and_not_on_the_seam(lib, material, consts):
    ver = _attached(lib, consts, batch_size=4, max_delay=0.001, buckets=(4,))
    _hold(lib, complete=True)
    try:
        calls = [asyncio.ensure_future(ver.verify_many(material.valid[4 * j: 4 * j + 4])) for j in range(8)]
        await asyncio.sleep(0.3)
        # four flushes on the "device", the rest taken by nobody
        assert len(ver._native._pending) == ver.PIPELINE_DEPTH
        assert ver._inflight._value == 0 and ver.flushes == ver.PIPELINE_DEPTH + 1
        await asyncio.get_running_loop().run_in_executor(None, _hold, lib)
        assert await asyncio.wait_for(asyncio.gather(*calls), 20) == [[True] * 4] * 8
        assert ver.native_batches == 8
    finally:
        _hold(lib)
        await ver.close()


async def test_close_with_jobs_queued_and_in_flight_leaves_no_caller_hanging(lib, material, consts):
    ver = _attached(lib, consts, batch_size=4, max_delay=0.001, buckets=(4,))
    _hold(lib, launch=True)  # the worker stops inside its first job's K1
    calls = [asyncio.ensure_future(ver.verify_many(material.valid[4 * j: 4 * j + 4])) for j in range(8)]
    await asyncio.sleep(0.3)
    assert len(ver._native._pending) == ver.PIPELINE_DEPTH and ver._queue
    closing = asyncio.ensure_future(ver.close())
    await asyncio.sleep(0.1)
    assert not closing.done()  # the job on the "device" still runs
    await asyncio.get_running_loop().run_in_executor(None, _hold, lib)
    await asyncio.wait_for(closing, 10)
    outs = await asyncio.wait_for(asyncio.gather(*calls, return_exceptions=True), 10)
    # the running job resolves; the queued ones and the accumulator's fail
    assert outs[0] == [True] * 4
    assert all(isinstance(o, RuntimeError) and "closed" in str(o) for o in outs[1:])
    assert ver.native_batches == 1 and len(ver._native._pending) == 0


async def test_a_failed_launch_fails_only_its_callers(lib, material, consts):
    ver = _attached(lib, consts, batch_size=4, max_delay=0.001, buckets=(4,))
    try:
        lib.cdll.at2_seam_host_fail_launch(ctypes.c_int64(2))
        outs = []
        for j in range(3):
            try:
                outs.append(await ver.verify_many(material.valid[4 * j: 4 * j + 4]))
            except RuntimeError as exc:
                outs.append(exc)
        assert outs[0] == outs[2] == [True] * 4
        assert isinstance(outs[1], RuntimeError) and "stand-in launch failed" in str(outs[1])
        assert ver.native_batches == ver.batches_dispatched == 2
    finally:
        await ver.close()


async def test_a_faulted_flush_counts_its_launch_and_fails_its_callers(lib, material, consts):
    ver = _attached(lib, consts, batch_size=4, max_delay=0.001, buckets=(4,))
    try:
        assert await ver.verify_many(material.valid[:4]) == [True] * 4
        launches, batches = cuda_verify.launches, ver.batches_dispatched
        _hold(lib, complete=True)
        call = asyncio.ensure_future(ver.verify_many(material.valid[4:8]))
        await asyncio.sleep(0.2)
        lib.cdll.at2_seam_host_fault(1)
        with pytest.raises(RuntimeError, match="stand-in device fault"):
            await asyncio.wait_for(call, 10)
        # K1 ran for it: the launch counts, the batch does not
        assert cuda_verify.launches - launches == 1
        assert ver.batches_dispatched == batches and ver.native_batches == batches
        _reset(lib)
        assert await ver.verify_many(material.valid[8:12]) == [True] * 4
        assert cuda_verify.launches - launches == 2
    finally:
        _reset(lib)
        await ver.close()


async def test_a_sink_that_raises_fails_its_batch_and_no_caller_hangs(lib, material, consts, monkeypatch):
    ver = _attached(lib, consts, batch_size=4, max_delay=0.05, buckets=(4,))
    real_set = vmod._ChunkSink.set

    def broken(sink, idx, ok, now):
        raise ValueError("sink broke")

    try:
        monkeypatch.setattr(vmod._ChunkSink, "set", broken)
        # two callers share one flush; the first verdict handed out raises
        calls = [asyncio.ensure_future(ver.verify_many(material.valid[2 * j: 2 * j + 2])) for j in range(2)]
        outs = await asyncio.wait_for(asyncio.gather(*calls, return_exceptions=True), 10)
        assert ver.native_batches == 1
        assert all(isinstance(o, ValueError) and "sink broke" in str(o) for o in outs)
        monkeypatch.setattr(vmod._ChunkSink, "set", real_set)
        # the slot came back: the next flush resolves
        assert await ver.verify_many(material.valid[4:8]) == [True] * 4
    finally:
        await ver.close()
    assert ver._inflight._value == ver.PIPELINE_DEPTH


# -- where the Python stages keep a flush ------------------------------------


def _items(n, tag=b"m"):
    kp = SignKeyPair(bytes(range(1, 33)))
    return [(kp.public, tag + b"%d" % i, kp.sign(tag + b"%d" % i)) for i in range(n)]


async def test_a_cpu_verifier_never_opens_the_seam(lib, monkeypatch):
    calls = []
    monkeypatch.setattr(seam_mod, "load_cuda", lambda: calls.append(1) or lib)
    ver = vmod.make_verifier("cuda", device="cpu", batch_size=8, max_delay=0.001, buckets=(8,))
    try:
        await ver.warmup()
        items = _items(6)
        assert await ver.verify_many(items) == [True] * 6
        assert ver._native is None and calls == []
        assert ver.stats()["native_batches"] == 0 and ver.stats()["batches"] == 2
    finally:
        await ver.close()


async def test_a_seam_that_does_not_build_fails_the_card_verifier(monkeypatch):
    # no fallback, as for K1: a card verifier whose seam does not build
    # does not serve
    def no_build(*a, **k):
        raise OSError("nvcc: not found")

    monkeypatch.setattr(seam_mod, "_cuda", None)
    monkeypatch.setattr(seam_mod, "compile_lib", no_build)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        seam_mod.load_cuda()
    ver = vmod.CudaBatchVerifier(device="cpu", batch_size=8, max_delay=0.001, buckets=(8,))
    try:
        # as on a card: the device check passes, the seam does not build
        monkeypatch.setattr(ver, "device", torch.device("cuda", 0))
        monkeypatch.setattr(cuda_verify, "build", lambda: None)
        with pytest.raises(RuntimeError, match="nvcc not found"):
            ver._open_native()
        monkeypatch.setattr(ver, "device", torch.device("cpu"))
    finally:
        await ver.close()


class _StubRlc(vmod.CudaBatchVerifier):
    """Its RLC stages stubbed (every lane code 1), its per-signature stages
    its own: a flush the router sends to RLC."""

    def _prep_rlc(self, pks, msgs, sigs, bucket):
        return len(pks)

    def _launch_rlc(self, packed):
        return packed

    def _finish_rlc(self, handle, n):
        return True, np.ones(n, dtype=np.uint8)


async def test_a_flush_routed_to_rlc_keeps_the_python_stages(lib, consts):
    ver = _StubRlc(device="cpu", batch_size=8, max_delay=0.001, buckets=(8,), mode="rlc")
    ver._native = _seam(lib, consts, max_rows=8)
    ver._native.attach(asyncio.get_running_loop())
    try:
        assert ver._stages_own
        assert await ver.verify_many(_items(8)) == [True] * 8
        st = ver.stats()
        assert st["rlc_batches"] == 1 and st["batches"] == 1 and st["native_batches"] == 0
        assert len(ver._native._pending) == 0
    finally:
        await ver.close()


class _OwnStages(vmod.CudaBatchVerifier):
    """Overrides ``_prep`` and ``_launch`` (as ``PoolVerifier`` does)."""

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.preps = 0

    def _prep(self, pks, msgs, sigs, bucket):
        self.preps += 1
        return len(pks)

    def _launch(self, prepared):
        return prepared

    def _finish(self, handle, n):
        return np.ones(n, dtype=bool)


class _OwnRunBatch(vmod.CudaBatchVerifier):
    """Overrides ``_run_batch`` alone."""

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.preps = 0

    def _run_batch(self, pks, msgs, sigs, bucket):
        self.preps += 1
        return np.ones(len(pks), dtype=bool)


@pytest.mark.parametrize("cls", [_OwnStages, _OwnRunBatch], ids=["prep_launch", "run_batch_only"])
async def test_a_subclass_with_its_own_stages_keeps_them(cls):
    ver = cls(batch_size=8, max_delay=0.001, buckets=(8,))
    try:
        assert not ver._stages_own
        items = [(b"p" * 32, b"m%d" % i, b"s" * 64) for i in range(8)]
        assert await ver.verify_many(items) == [True] * 8
        assert ver.preps == 1 and ver.stats()["native_batches"] == 0
        # and on a card the seam would not open for it
        ver.device = torch.device("cuda", 0)
        assert ver._open_native() is None
        ver.device = torch.device("cpu")
    finally:
        await ver.close()


async def test_the_pool_verifier_keeps_its_stages():
    from at2_node_tpu_torch.parallel.pool import PoolVerifier

    ver = PoolVerifier(batch_size=8, max_delay=0.001, devices=["cpu"])
    try:
        assert not ver._stages_own and ver._open_native() is None
        assert await ver.verify_many(_items(3)) == [True] * 3
        assert ver.stats()["native_batches"] == 0 and ver.stats()["batches"] == 1
    finally:
        await ver.close()

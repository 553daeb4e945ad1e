"""The port's own timeline: program spans in the node's torch.profiler
trace, the seam's windowed round-trip sums, and the event loop's busy
time (obs/profiler.py ``TraceSpans`` and ``BusySelector``,
crypto/verifier.py ``CudaBatchVerifier``, cli/server.py).

* A node that does not trace holds the shared ``NO_SPANS`` and opens no
  span, even under a profiler some other code runs; ``obs/`` loads
  without torch.
* Under a CPU trace, one ``verify_many`` gives the four
  ``at2.verifier.*`` spans of one flush, as ``user_annotation`` events
  with their arguments.
* With a scripted clock the seam's queue, pipeline and hand-back sums are
  exactly the scripted waits; a flush ticks ``verifier_flush``.
* A stretch that raises still closes its span, so the next span of its
  name on its thread keeps its own arguments.
* A ``BusySelector`` loop counts a spinning callback and not a sleep.
* A served ``server run`` node with ``profile_dir`` exports
  ``event_loop_busy_ns`` on /metrics and writes a trace with its RPC and
  commit spans.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

import chip_smoke
from at2_node_tpu_torch.client import Client
from at2_node_tpu_torch.crypto.keys import ExchangeKeyPair, SignKeyPair
from at2_node_tpu_torch.crypto.verifier import CudaBatchVerifier
from at2_node_tpu_torch.node.config import Config, ObservabilityConfig, VerifierConfig
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.obs import Registry
from at2_node_tpu_torch.obs.profiler import (
    NO_SPANS,
    SPAN_ARGS,
    BusySelector,
    PhaseAccounting,
    TraceSpans,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 30.0


def _at2_events(path):
    with open(path) as f:
        doc = json.load(f)
    return [
        e for e in doc["traceEvents"]
        if e.get("ph") == "X" and str(e.get("name", "")).startswith("at2.")
    ]


def _items(n, tampered=()):
    kp = SignKeyPair.from_hex("02" * 32)
    out = []
    for i in range(n):
        msg = f"span {i}".encode()
        sig = kp.sign(msg)
        out.append((kp.public, msg + b"!" if i in tampered else msg, sig))
    return out


def _config(tmp_path, **obs):
    ports = chip_smoke.free_ports(2)
    return Config(
        node_address=f"127.0.0.1:{ports[0]}",
        rpc_address=f"127.0.0.1:{ports[1]}",
        sign_key=SignKeyPair.random(),
        network_key=ExchangeKeyPair.random(),
        verifier=VerifierConfig(kind="cpu"),
        observability=ObservabilityConfig(**obs),
    )


async def _send_and_commit(uri, seq=1):
    sender, recipient = SignKeyPair.random(), SignKeyPair.random()
    async with Client(uri) as client:
        await client.send_asset(sender, seq, recipient.public, 3)
        deadline = time.monotonic() + TIMEOUT
        while await client.get_last_sequence(sender.public) != seq:
            assert time.monotonic() < deadline
            await asyncio.sleep(0.05)
    return sender


class TestOff:
    def test_obs_loads_without_torch(self):
        code = (
            "import sys\n"
            "import at2_node_tpu_torch.obs as obs\n"
            "assert 'torch' not in sys.modules, 'obs imported torch'\n"
            "assert obs.NO_SPANS.on is False\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                              timeout=60)
        assert proc.returncode == 0, proc.stderr

    async def test_untraced_node_holds_the_shared_no_op_and_opens_no_span(self, tmp_path):
        # a profiler run by other code records every thread: the node's
        # sites must still open nothing
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            experimental_config=torch._C._profiler._ExperimentalConfig(profile_all_threads=True),
        )
        prof.start()
        try:
            service = await Service.start(_config(tmp_path))
            try:
                assert service.spans is NO_SPANS
                assert service.broadcast.spans is NO_SPANS
                await _send_and_commit(f"http://{service.config.rpc_address}")
            finally:
                await service.close()
        finally:
            prof.stop()
        path = str(tmp_path / "untraced.json")
        prof.export_chrome_trace(path)
        assert _at2_events(path) == []
        assert CudaBatchVerifier.spans is NO_SPANS


class TestVerifierSpans:
    async def test_one_flush_gives_four_spans_with_one_flush_id(self, tmp_path):
        v = CudaBatchVerifier(batch_size=8, max_delay=0.001, device="cpu")
        spans = v.spans = TraceSpans.start()
        try:
            assert await v.verify_many(_items(3, tampered={1})) == [True, False, True]
        finally:
            path = spans.stop(str(tmp_path))
            await v.close()
        events = [e for e in _at2_events(path) if e["cat"] == "user_annotation"]
        names = sorted(e["name"] for e in events)
        assert names == sorted(
            ["at2.verifier.flush", "at2.verifier.prep", "at2.verifier.launch", "at2.verifier.finish"]
        )
        assert {e["args"]["flush"] for e in events} == {1}
        flush = next(e for e in events if e["name"] == "at2.verifier.flush")
        assert (flush["args"]["lanes"], flush["args"]["bucket"]) == (3, 8)
        # the stages run on their own threads, the flush on the loop's
        loop_tid = flush["tid"]
        assert all(e["tid"] != loop_tid for e in events if e is not flush)
        by = {e["name"]: e for e in events}
        assert by["at2.verifier.prep"]["ts"] < by["at2.verifier.launch"]["ts"] < by["at2.verifier.finish"]["ts"]

    def test_vocabulary(self):
        assert all(name.startswith("at2.") for name in SPAN_ARGS)
        assert {"at2.rpc.validate", "at2.rpc.gate", "at2.rpc.stamp", "at2.rpc.ingest",
                "at2.commit.drain", "at2.commit.tail", "at2.verifier.flush"} <= set(SPAN_ARGS)


class TestRaisingStretch:
    async def test_a_raising_stretch_closes_its_span(self, tmp_path):
        service = await Service.start(_config(tmp_path, profile_dir=str(tmp_path)))
        try:
            b = service.broadcast
            assert service.spans.on and b.spans is service.spans
            item = _items(1)[0]

            def pre_msg(peer, msg, to_verify, actions):
                to_verify.append(item)
                actions.append(msg)

            def apply_fails(actions, results):
                raise RuntimeError("apply failed")

            b._pre_msg = pre_msg
            b._apply_actions = apply_fails
            # the tracebacks stay alive, and with them the failed frames
            with pytest.raises(RuntimeError) as apply_failed:
                await b._process_chunk([(None, "a"), (None, "b")])
            b._apply_actions = lambda actions, results: None
            await b._process_chunk([(None, "c")])

            async def pass_fails(fn):
                raise RuntimeError("drain failed")

            real = service.accounts.run_exclusive
            service.accounts.run_exclusive = pass_fails
            service._heap.append((b"k", 0.0, 0, None))
            with pytest.raises(RuntimeError) as drain_failed:
                await service._drain_to_fixpoint_locked()
            service.accounts.run_exclusive = real
            await service._drain_to_fixpoint_locked()  # nothing pending
        finally:
            await service.close()
        (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path) if f.endswith(".trace.json")]
        assert "apply failed" in str(apply_failed.value) and "drain failed" in str(drain_failed.value)
        events = sorted(_at2_events(path), key=lambda e: e["ts"])
        for name, arg, want in (("at2.broadcast.apply", "msgs", [2, 1]), ("at2.commit.drain", "pending", [1, 0])):
            spans = [e for e in events if e["name"] == name]
            assert [e["args"][arg] for e in spans] == want
            # the failed span closed before the next one opened
            assert spans[0]["ts"] + spans[0]["dur"] <= spans[1]["ts"]


class _ScriptedClock:
    def __init__(self) -> None:
        self.now = 0.0

    def monotonic(self) -> float:
        return self.now


class _Scripted(CudaBatchVerifier):
    """Stages that move the clock instead of verifying: the batch is
    taken at 1.0, prepped by 1.5, launched by 2.0, its verdicts set at
    3.0, and its caller resumes at 3.25."""

    def _prep(self, pks, msgs, sigs, bucket):
        self._clock.now = 1.5
        return len(pks)

    def _launch(self, prepared):
        self._clock.now = 2.0
        return prepared

    def _finish(self, handle, n):
        self._clock.now = 3.0
        return np.ones(n, dtype=bool)

    async def _complete(self, *args):
        await super()._complete(*args)
        self._clock.now = 3.25


class TestSeamSums:
    async def test_sums_equal_the_scripted_waits(self):
        clock = _ScriptedClock()
        v = _Scripted(batch_size=8, max_delay=0.05, clock=clock, device="cpu")
        v.phases = PhaseAccounting(Registry())
        try:
            call = asyncio.ensure_future(v.verify_many(_items(3)))
            await asyncio.sleep(0)  # enqueued at 0.0
            clock.now = 1.0  # the flusher takes the batch at 1.0
            assert await call == [True] * 3
            s = v.stats()
            assert (s["seam_taken"], s["seam_resolved"], s["seam_calls"]) == (3, 3, 1)
            assert s["seam_queue_s"] == 3 * 1.0
            assert s["seam_pipeline_s"] == 3 * (3.0 - 1.0)
            assert s["seam_handback_s"] == 3.25 - 3.0
            assert "last_dispatch_ms" not in s
            assert v.phases.totals()["verifier_flush"] > 0
        finally:
            await v.close()


class TestBusySelector:
    def test_busy_grows_while_spinning_not_while_sleeping(self):
        selector = BusySelector()

        async def main():
            b0 = selector.busy_ns
            await asyncio.sleep(0.3)
            slept = selector.busy_ns - b0
            b1 = selector.busy_ns
            t_end = time.perf_counter() + 0.2
            while time.perf_counter() < t_end:  # a callback that holds the loop
                pass
            await asyncio.sleep(0)
            return slept, selector.busy_ns - b1

        slept, spun = asyncio.run(main(), loop_factory=lambda: asyncio.SelectorEventLoop(selector))
        assert slept < 0.05e9
        assert spun >= 0.19e9


class TestServed:
    def test_server_run_exports_busy_time_and_writes_its_spans(self, tmp_path):
        ports = chip_smoke.free_ports(2)
        env = dict(os.environ, PYTHONPATH=REPO)
        server = [sys.executable, "-m", "at2_node_tpu_torch.cli.server"]
        toml = subprocess.run(
            server + ["config", "new", "--verifier", "cpu", f"127.0.0.1:{ports[0]}", f"127.0.0.1:{ports[1]}"],
            capture_output=True, text=True, env=env, check=True, timeout=60,
        ).stdout
        toml += f"\n[observability]\nprofile_dir = {json.dumps(str(tmp_path))}\n"
        proc = subprocess.Popen(server + ["run"], stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True, env=env)
        proc.stdin.write(toml)
        proc.stdin.close()
        uri = f"127.0.0.1:{ports[1]}"
        try:
            deadline = time.monotonic() + TIMEOUT
            while True:
                try:
                    with urllib.request.urlopen(f"http://{uri}/metrics", timeout=5) as r:
                        metrics = r.read().decode()
                    break
                except OSError:
                    assert proc.poll() is None, proc.stderr.read()
                    assert time.monotonic() < deadline, "the node never served /metrics"
                    time.sleep(0.1)
            sender = asyncio.run(_send_and_commit(f"http://{uri}"))
            with urllib.request.urlopen(f"http://{uri}/metrics", timeout=5) as r:
                metrics = r.read().decode()
        finally:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        assert rc == 0, proc.stderr.read()
        busy = [ln for ln in metrics.splitlines() if ln.startswith("at2_event_loop_busy_ns ")]
        assert busy and float(busy[0].split()[1]) > 0
        assert "at2_verifier_last_dispatch_ms" not in metrics
        (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path) if f.endswith(".trace.json")]
        events = [e for e in _at2_events(path) if e["cat"] == "user_annotation"]
        names = {e["name"] for e in events}
        assert {"at2.rpc.validate", "at2.rpc.gate", "at2.rpc.stamp", "at2.rpc.ingest"} <= names
        assert {"at2.commit.drain", "at2.commit.tail"} <= names
        assert names <= set(SPAN_ARGS)
        rpc = [e for e in events if e["name"].startswith("at2.rpc.")]
        assert {(e["args"]["sender"], e["args"]["sequence"], e["args"]["n"]) for e in rpc} == {
            (sender.public[:8].hex(), 1, 1)
        }
        tail = [e for e in events if e["name"] == "at2.commit.tail"]
        assert sum(e["args"]["commits"] for e in tail) == 1

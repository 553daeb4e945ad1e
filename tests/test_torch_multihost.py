"""The port's multi-process bring-up (``at2_node_tpu_torch/parallel/
multihost.py``) against the reference's (``tests/test_multihost.py``):
the unconfigured no-op, the partial configuration's ``ValueError``, two
real gloo processes summing one valid count across their local pools,
and ``server run`` under the ``AT2_*`` variables.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest

import at2_node_tpu.parallel.multihost as ref_mh
import chip_smoke
import at2_node_tpu_torch.parallel.multihost as mh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVER = [sys.executable, "-m", "at2_node_tpu_torch.cli.server"]
VARS = ("AT2_COORDINATOR", "AT2_NUM_PROCESSES", "AT2_PROCESS_ID")


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in VARS}
    return {**env, "PYTHONPATH": REPO, **extra}


def test_unconfigured_is_noop(monkeypatch):
    for var in VARS:
        monkeypatch.delenv(var, raising=False)
    assert mh.maybe_initialize() is False
    assert mh._initialized is False
    assert ref_mh.maybe_initialize() is False


@pytest.mark.parametrize("present", [{}, {"AT2_NUM_PROCESSES": "2"},
                                     {"AT2_PROCESS_ID": "0"},
                                     {"AT2_NUM_PROCESSES": "two", "AT2_PROCESS_ID": "0"}])
def test_partial_configuration_raises_clearly(monkeypatch, present):
    """As the reference's: the coordinator without both other variables (as
    integers) raises its ``ValueError``, the same message in both builds."""
    for mod in (mh, ref_mh):
        monkeypatch.setattr(mod, "_initialized", False)
    monkeypatch.setenv("AT2_COORDINATOR", "127.0.0.1:1")
    for var in VARS[1:]:
        monkeypatch.delenv(var, raising=False)
    for var, value in present.items():
        monkeypatch.setenv(var, value)
    messages = []
    for mod in (mh, ref_mh):
        with pytest.raises(ValueError, match="AT2_NUM_PROCESSES") as err:
            mod.maybe_initialize()
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    assert mh._initialized is False


def test_process_info_keys_match_the_reference():
    """Without a process group: one process, this host's CUDA devices."""
    import torch

    info = mh.process_info()
    assert set(info) == {"initialized", "process_index", "process_count",
                         "local_devices", "global_devices"}
    assert set(info) == set(ref_mh.process_info())
    assert info["process_count"] == 1 and info["process_index"] == 0
    assert info["local_devices"] == info["global_devices"] == torch.cuda.device_count()


_TWO_PROC = """
import json, sys
sys.path.insert(0, @REPO@)
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.ops import ed25519 as kernel
from at2_node_tpu_torch.parallel import multihost as mh, pool

assert mh.maybe_initialize() is True
assert mh.maybe_initialize() is True  # idempotent
info = mh.process_info()
rank = info["process_index"]
kp = SignKeyPair.from_hex("52" * 32)
msgs = [b"2proc%d" % i for i in range(8)]
sigs = [kp.sign(m) for m in msgs]
sigs[3] = b"\\x00" * 64  # one invalid lane
rows = np.empty((8, kernel.PACKED_WIDTH), dtype=np.uint8)
kernel.fill_packed([kp.public] * 8, msgs, sigs, rows)
# each rank verifies its four lanes on its local pool (two CPU shards);
# one all_reduce sums the counts
mine = rows[4 * rank:4 * rank + 4]
ok, count = pool.verify_and_count(mine, pool.make_pool_devices(["cpu"] * 2),
                                  group=dist.group.WORLD)
print("RESULT " + json.dumps({"info": info, "ok": ok.tolist(), "count": count}))
dist.destroy_process_group()
"""


def test_two_gloo_processes_sum_one_count():
    """A real two-process gloo group over loopback: each rank verifies its
    own lanes of one 8-lane batch (lane 3 invalid) on its local CPU shards;
    both see the global count 7, and each its own lanes' verdicts."""
    port = chip_smoke.free_ports(1)[0]
    code = _TWO_PROC.replace("@REPO@", repr(REPO))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
            env=_env(AT2_COORDINATOR=f"127.0.0.1:{port}", AT2_NUM_PROCESSES="2",
                     AT2_PROCESS_ID=str(rank)),
        )
        for rank in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, out in enumerate(outs):
        line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
        res = json.loads(line[len("RESULT "):])
        assert res["count"] == 7
        assert res["ok"] == [4 * rank + i != 3 for i in range(4)]
        info = res["info"]
        assert info["initialized"] is True
        assert (info["process_index"], info["process_count"]) == (rank, 2)
        assert info["local_devices"] == info["global_devices"] == 0


def _wait_for_port(port, proc, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return
        except OSError:
            if proc.poll() is not None:
                raise AssertionError(f"server exited {proc.returncode}: {proc.stderr.read()}")
            time.sleep(0.1)
    raise TimeoutError(f"port {port} never came up")


def test_server_run_joins_the_process_group():
    """Two ``server run`` processes with ``AT2_COORDINATOR`` set join one
    group of two (it raised ``NotImplementedError`` before the port had
    it), serve, and exit 0 on SIGTERM."""
    ports = chip_smoke.free_ports(5)
    coordinator = f"127.0.0.1:{ports[4]}"
    servers = []
    try:
        for rank in (0, 1):
            node, rpc = ports[2 * rank], ports[2 * rank + 1]
            config = subprocess.run(
                SERVER + ["config", "new", "--verifier", "cpu", f"127.0.0.1:{node}", f"127.0.0.1:{rpc}"],
                capture_output=True, text=True, env=_env(), timeout=60, check=True,
            ).stdout
            proc = subprocess.Popen(
                SERVER + ["run"], stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                stderr=subprocess.PIPE, text=True,
                env=_env(AT2_COORDINATOR=coordinator, AT2_NUM_PROCESSES="2",
                         AT2_PROCESS_ID=str(rank), AT2_LOG="INFO"),
            )
            proc.stdin.write(config)
            proc.stdin.close()
            servers.append((proc, rpc))
        for proc, rpc in servers:
            _wait_for_port(rpc, proc)
    finally:
        rcs = []
        for proc, _ in servers:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
            try:
                rcs.append(proc.wait(timeout=20))
            except subprocess.TimeoutExpired:
                proc.kill()
                rcs.append(proc.wait())
    errs = [proc.stderr.read() for proc, _ in servers]
    assert rcs == [0, 0], errs
    for rank, err in enumerate(errs):
        assert "NotImplementedError" not in err
        assert f"multi-host runtime up: process {rank}/2" in err

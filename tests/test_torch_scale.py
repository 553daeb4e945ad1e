"""BASELINE config 5's tools in the port, on the CPU: ``tools/scale_demo.py``
(a pool of ``["cpu"] * 2`` behind a 4-node net, and the replay) with the
reference artifact's keys, its helpers, ``tools/loadgen.py`` (through a
broker too),
``tools/_common.py``'s seeded nets, ``config new --verifier pool``, and
the entry (``entry.py``) against the repository's ``__graft_entry__.py``.
"""

import contextlib
import io
import json
import os
import resource
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
import chip_smoke
from at2_node_tpu.ops import ed25519 as ref_kernel
from at2_node_tpu_torch import entry
from at2_node_tpu_torch.node.config import Config
from at2_node_tpu_torch.tools import _common, loadgen, scale_demo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# These tensors are small: more intra-op threads only spin, and take
# cores from the tests that run beside these in other processes.
torch.set_num_threads(1)

# the keys of the reference's artifact (at2_node_tpu/tools/scale_demo.py,
# _phase_net's and _phase_replay's return values)
REF_NET_KEYS = {
    "nodes", "echo_threshold", "clients", "submitted", "committed", "commit_seconds",
    "committed_tx_per_sec", "pool_batches", "pool_signatures", "pool_batch_occupancy",
    "pool_avg_dispatch_ms",
}
REF_REPLAY_KEYS = {
    "replayed_signatures", "verified_ok", "seconds", "verifies_per_sec", "bucket",
    "mesh_devices",
}


def _port_base(n: int) -> int:
    """A base with ``n`` consecutive ports free on 127.0.0.1 (the demo
    takes ``--port-base`` and counts up)."""
    for base in chip_smoke.free_ports(16):
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no {n} consecutive free ports")


def test_scale_demo_runs_with_the_reference_keys():
    """``scale_demo --devices cpu,cpu --nodes 4 --clients 4 --tx-per-client
    2 --replay 128 --replay-bucket 64`` (a 64-lane pool batch: the plain
    version's pace): every transfer commits on every node, every ledger
    equals the replay, every replayed signature verifies, and the artifact
    has the reference's keys."""
    out = io.StringIO()
    argv = ["--devices", "cpu,cpu", "--nodes", "4", "--clients", "4", "--tx-per-client", "2",
            "--replay", "128", "--replay-bucket", "64", "--pool-batch", "64", "--seed", "9",
            "--port-base", str(_port_base(8))]
    with contextlib.redirect_stdout(out):
        assert scale_demo.main(argv) == 0
    art = json.loads(out.getvalue().strip().splitlines()[-1])
    assert {"config", "host_context", "net", "replay"} <= set(art)
    net, replay = art["net"], art["replay"]
    assert REF_NET_KEYS <= set(net) and REF_REPLAY_KEYS <= set(replay)
    assert net["nodes"] == 4 and net["echo_threshold"] == 3
    assert net["submitted"] == net["committed"] == 8
    assert net["ledgers_equal_replay_on_all_nodes"] is True
    assert net["pool_devices"] == ["cpu", "cpu"]
    assert net["pool_batches"] > 0 and net["pool_signatures"] > 0
    assert 0 < net["pool_batch_occupancy"] <= 1
    # the plain version is not the kernel: no launch is counted on the CPU
    assert net["kernel_launches"] == replay["kernel_launches"] == 0
    assert replay["replayed_signatures"] == replay["verified_ok"] == 128
    assert replay["mesh_devices"] == 2 and replay["bucket"] == 64


async def test_net_starts_again_when_a_listener_port_is_taken():
    """A port taken before its node binds it brings the net up again on
    fresh ports, with the same keys; the net still commits."""
    taken = socket.socket()
    taken.bind(("127.0.0.1", 0))
    taken.listen()
    try:
        ports = iter([taken.getsockname()[1]] + chip_smoke.free_ports(7))
        net = await scale_demo._phase_net(2, 1, 1, 1, pool_batch=16, devices=["cpu"],
                                          ports=ports, seed=12, commit_timeout=60.0)
    finally:
        taken.close()
    assert net["net_starts"] == 2
    assert net["committed"] == 1 and net["ledgers_equal_replay_on_all_nodes"]


def test_scale_demo_without_devices_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scale_demo._phase_replay(64, bucket=64)


def test_replay_ledger_follows_the_ledger_rules():
    a, b = b"a" * 32, b"b" * 32
    want = scale_demo.replay_ledger([
        (a, 1, a, 1),          # a self-transfer keeps the balance
        (a, 2, b, 40),
        (a, 2, b, 40),         # a repeated sequence is skipped
        (a, 3, b, 200_000),    # an overdraft consumes its sequence
        (b, 1, a, 10),
    ])
    assert want == {a.hex(): [3, 99_970], b.hex(): [1, 100_030]}


def test_open_files_are_raised_never_cut():
    need = scale_demo.open_files_needed(32)
    assert need >= 2 * 32 * 31
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    try:
        got_soft, got_hard = scale_demo.raise_open_files(min(need, hard))
        assert got_hard == hard and got_soft >= min(need, hard)
        with pytest.raises(RuntimeError, match="below"):
            scale_demo.raise_open_files(hard + 1 if hard != resource.RLIM_INFINITY else 1 << 62)
    finally:
        resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))


def test_seeded_net_configs():
    """The same seed gives the same keys; every node knows every other."""
    ports = iter(range(40_000, 40_100))
    one = _common.make_net_configs(5, ports, seed=3, echo_threshold=3, ready_threshold=3)
    two = _common.make_net_configs(5, ports, seed=3)
    assert [c.sign_key.public for c in one] == [c.sign_key.public for c in two]
    assert len({c.network_key.public for c in one}) == 5
    for i, cfg in enumerate(one):
        assert cfg.echo_threshold == cfg.ready_threshold == 3
        assert {p.address for p in cfg.nodes} == {o.node_address for j, o in enumerate(one) if j != i}
        assert Config.loads(cfg.dumps()).dumps() == cfg.dumps()
    assert loadgen.client_keys(3, seed=4)[2].public == loadgen.client_keys(3, seed=4)[2].public
    assert _common.parse_addr("127.0.0.1:80") == ("127.0.0.1", 80)
    with pytest.raises(ValueError):
        _common.parse_addr("no-port")


async def test_loadgen_through_a_broker_commits_every_transfer():
    """``run_load(..., broker=True)``: the clients' directory warm-up, then
    every transfer through a port broker in front of one in-process port
    node, distilled into ``SendDistilledBatch`` frames and committed."""
    from at2_node_tpu_torch.broker import Broker
    from at2_node_tpu_torch.node.config import VerifierConfig
    from at2_node_tpu_torch.node.service import Service

    (cfg,) = _common.make_net_configs(1, iter(chip_smoke.free_ports(2)), seed=5,
                                      verifier=VerifierConfig(kind="cpu"))
    service = await Service.start(cfg)
    addr = f"127.0.0.1:{chip_smoke.free_ports(1)[0]}"
    broker = await Broker.start(f"http://{cfg.rpc_address}", addr, max_entries=32)
    try:
        res = await loadgen.run_load([f"http://{addr}"], clients=4, tx_per_client=12, broker=True,
                                     seed=6, commit_timeout=30.0)
        assert res.submitted == res.committed == 48
        keys = loadgen.client_keys(4, seed=6)
        # the warm-up registered every client through the broker, so the
        # load itself needed no Register round-trip of the broker's own
        assert sorted(broker._ids) == sorted(k.public for k in keys)
        assert broker.stats["broker_registrations"] == 0
        assert broker.stats["broker_entries_tx"] == 48
        assert service.distill_stats["distilled_batches_rx"] == broker.stats["broker_batches_tx"] >= 2
        assert [await service.accounts.get_last_sequence(k.public) for k in keys] == [12] * 4
    finally:
        await broker.close()
        await service.close()


def test_config_new_writes_the_pool_kind():
    proc = subprocess.run(
        [sys.executable, "-m", "at2_node_tpu_torch.cli.server", "config", "new", "--verifier",
         "pool", "127.0.0.1:1", "127.0.0.1:2"],
        capture_output=True, text=True, env=dict(os.environ, PYTHONPATH=REPO), timeout=60,
    )
    assert proc.returncode == 0, proc.stderr
    assert '[verifier]\nkind = "pool"\n' in proc.stdout
    assert Config.loads(proc.stdout).verifier.kind == "pool"


# -- the entry -----------------------------------------------------------------


def test_entry_rows_match_the_reference_example_batch():
    """The entry's 64-row bucket, 8 real lanes with lane 1 tampered, is the
    reference's example batch packed into rows."""
    ref = ref_kernel.pack_prepared(*(np.asarray(x) for x in ref_entry._example_batch(8, 64)))
    assert (entry._example_rows(8, 64) == ref).all()


def test_entry_runs_its_function_on_its_example_arguments():
    fn, args = entry.entry("cpu")
    assert args[0].shape == (64, 129) and args[0].device.type == "cpu"
    ok = np.unpackbits(fn(*args).numpy(), count=64).astype(bool)
    assert (ok == entry._expected(8, 64)).all()
    assert ok.sum() == 7


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_multichip_over_cpu_shards(n):
    entry.dryrun_multichip(n, devices=["cpu"] * n)


def test_dryrun_multichip_checks_its_device_count():
    with pytest.raises(ValueError, match="need 4 devices"):
        entry.dryrun_multichip(4, devices=["cpu"] * 2)

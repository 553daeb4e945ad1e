"""The node service whole: port ``Service``s over gRPC on 127.0.0.1.

* The reference's node tests (single node and multi-node) against port
  Services, with the node default config (CPU verifier in ``auto``).
* The same seeded transfers through a net of reference Services and a net
  of port Services give equal balances, sequences and recent-transaction
  states; a mixed net of two reference and two port Services commits
  equal ledgers.
* ``/metrics`` and ``/statusz`` of a port node carry the reference's keys
  (the build block names torch and the card instead of jax).
* A node with the batched CUDA verifier's plain path injected
  (``device="cpu"``) commits through it.
* A reference checkpoint file loads into a port node and back.
* ``chip_smoke.py``'s phase 6 runs here with ``kind = "cpu"``, four
  ``server run`` processes and a few transfers per client.

Keys are seeded with numpy; ledgers must be equal exactly.
"""

import asyncio
import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

import chip_smoke
from at2_node_tpu.client import Client as RefClient
from at2_node_tpu.node import config as ref_config
from at2_node_tpu.node.service import Service as RefService
from at2_node_tpu_torch.client import Client
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.crypto.verifier import make_verifier
from at2_node_tpu_torch.node import config as port_config
from at2_node_tpu_torch.node.service import Service

TICK = 0.05
TIMEOUT = 20.0

PORT = (port_config, Service, Client)
REF = (ref_config, RefService, RefClient)


def make_configs(kinds, rng, **tables):
    """One config per entry of ``kinds`` (PORT or REF), fully meshed, on
    free ports, keys from ``rng``; ``tables`` replaces config tables."""
    n = len(kinds)
    ports = chip_smoke.free_ports(2 * n)
    seeds = [(rng.bytes(32), rng.bytes(32)) for _ in range(n)]
    cfgs = []
    for i, (mod, _, _) in enumerate(kinds):
        cfg = mod.Config(
            node_address=f"127.0.0.1:{ports[2 * i]}", rpc_address=f"127.0.0.1:{ports[2 * i + 1]}",
            sign_key=mod.SignKeyPair(seeds[i][0]), network_key=mod.ExchangeKeyPair(seeds[i][1]),
            verifier=mod.VerifierConfig(kind="cpu"),  # the port's default is the card's
        )
        cfg.nodes = [
            mod.Peer(f"127.0.0.1:{ports[2 * j]}", mod.ExchangeKeyPair(x).public, mod.SignKeyPair(s).public)
            for j, (s, x) in enumerate(seeds) if j != i
        ]
        for key, value in tables.items():
            setattr(cfg, key, dataclasses.replace(getattr(cfg, key), **value))
        cfgs.append(cfg)
    return cfgs


class Network:
    def __init__(self, kinds, seed=0, **tables):
        self.kinds = kinds
        self.configs = make_configs(kinds, np.random.default_rng(seed), **tables)
        self.services = []

    async def __aenter__(self):
        for (_, service, _), cfg in zip(self.kinds, self.configs):
            self.services.append(await service.start(cfg))
        return self

    async def __aexit__(self, *exc):
        for s in self.services:
            await s.close()

    def client(self, i=0):
        return self.kinds[i][2](f"http://{self.configs[i].rpc_address}")


async def wait_for_sequence(client, user, seq):
    deadline = asyncio.get_running_loop().time() + TIMEOUT
    while asyncio.get_running_loop().time() < deadline:
        if await client.get_last_sequence(user) == seq:
            return
        await asyncio.sleep(TICK)
    raise TimeoutError(f"sequence {seq} not committed within {TIMEOUT}s")


def _keys(seed, n):
    rng = np.random.default_rng(seed)
    return [SignKeyPair(rng.bytes(32)) for _ in range(n)]


# -- the reference's node tests against port Services --------------------


class TestSingleNode:
    async def test_new_client_has_faucet_balance(self):
        async with Network([PORT]) as net, net.client() as client:
            (user,) = _keys(1, 1)
            assert await client.get_balance(user.public) == 100_000

    async def test_transfer_commits_and_conserves(self):
        async with Network([PORT]) as net, net.client() as client:
            sender, recipient = _keys(2, 2)
            await client.send_asset(sender, 1, recipient.public, 100)
            await wait_for_sequence(client, sender.public, 1)
            assert await client.get_balance(sender.public) == 99_900
            assert await client.get_balance(recipient.public) == 100_100

    async def test_latest_transactions_shows_success(self):
        async with Network([PORT]) as net, net.client() as client:
            sender, recipient = _keys(3, 2)
            await client.send_asset(sender, 1, recipient.public, 42)
            await wait_for_sequence(client, sender.public, 1)
            txs = await client.get_latest_transactions()
            assert len(txs) == 1
            assert (txs[0].amount, txs[0].state.name, txs[0].sender) == (42, "SUCCESS", sender.public)

    async def test_self_transfer_keeps_balance(self):
        async with Network([PORT]) as net, net.client() as client:
            (user,) = _keys(4, 1)
            await client.send_asset(user, 1, user.public, 1000)
            await wait_for_sequence(client, user.public, 1)
            assert await client.get_balance(user.public) == 100_000

    async def test_bad_arguments_rejected(self):
        import grpc

        from at2_node_tpu_torch.proto import at2_pb2 as pb
        from at2_node_tpu_torch.proto.rpc import At2Stub

        async with Network([PORT]) as net:
            channel = grpc.aio.insecure_channel(net.configs[0].rpc_address)
            stub = At2Stub(channel)
            bad = [dict(sender=b"short"), dict(signature=b"s" * 63), dict(signature=b"s" * 64)]
            try:
                for fields in bad:
                    req = dict(sender=b"q" * 32, sequence=1, recipient=b"r" * 32, amount=1,
                               signature=b"s" * 64)
                    req.update(fields)
                    with pytest.raises(grpc.aio.AioRpcError) as err:
                        await stub.SendAsset(pb.SendAssetRequest(**req))
                    # the last: well-formed, refused by admission's preverify
                    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
            finally:
                await channel.close()
            stats = net.services[0].snapshot_stats()
            assert stats["rejected_at_ingress"] == 1

    async def test_stats_snapshot_and_periodic_log(self, caplog):
        import logging

        from at2_node_tpu_torch.node.service import stats_logger

        net = Network([PORT])
        net.configs[0].observability = port_config.ObservabilityConfig(stats_interval=0.2)
        propagate_before = stats_logger.propagate
        try:
            async with net, net.client() as client:
                stats_logger.propagate = True
                with caplog.at_level(logging.INFO, logger="at2_node_tpu_torch.stats"):
                    sender, recipient = _keys(5, 2)
                    await client.send_asset(sender, 1, recipient.public, 7)
                    await wait_for_sequence(client, sender.public, 1)
                    await asyncio.sleep(0.5)
                snap = net.services[0].snapshot_stats()
                assert snap["committed"] == 1 and snap["delivered"] == 1
                assert snap["verifier_signatures"] >= 1 and snap["rpc_http1_accepted"] == 0
                lines = [json.loads(r.message) for r in caplog.records if r.message.startswith("{")]
                assert lines and lines[-1]["committed"] == 1
        finally:
            stats_logger.propagate = propagate_before


class TestMultiNode:
    async def test_three_node_boot(self):
        async with Network([PORT] * 3):
            pass

    async def test_transfer_visible_on_all_nodes(self):
        async with Network([PORT] * 4) as net:
            sender, recipient = _keys(6, 2)
            async with net.client(0) as c0:
                await c0.send_asset(sender, 1, recipient.public, 250)
            for i in range(4):
                async with net.client(i) as c:
                    await wait_for_sequence(c, sender.public, 1)
                    assert await c.get_balance(sender.public) == 99_750
                    assert await c.get_balance(recipient.public) == 100_250

    async def test_sequence_gap_fills(self):
        async with Network([PORT] * 3) as net:
            sender, recipient = _keys(7, 2)
            async with net.client(0) as c0, net.client(1) as c1:
                for seq in (1, 2, 3):
                    await c0.send_asset(sender, seq, recipient.public, 10)
                await wait_for_sequence(c1, sender.public, 3)
                assert await c1.get_balance(sender.public) == 99_970

    async def test_same_content_twice_commits_twice(self):
        async with Network([PORT] * 3) as net, net.client(0) as client:
            sender, recipient = _keys(8, 2)
            await client.send_asset(sender, 1, recipient.public, 5)
            await wait_for_sequence(client, sender.public, 1)
            await client.send_asset(sender, 2, recipient.public, 5)
            await wait_for_sequence(client, sender.public, 2)
            assert await client.get_balance(recipient.public) == 100_010

    async def test_overdraft_consumes_sequence_but_not_balance(self):
        async with Network([PORT] * 3) as net, net.client(0) as client:
            sender, recipient = _keys(9, 2)
            await client.send_asset(sender, 1, recipient.public, 999_999_999)
            await wait_for_sequence(client, sender.public, 1)
            assert await client.get_balance(sender.public) == 100_000
            assert await client.get_balance(recipient.public) == 100_000


# -- the port against the reference ---------------------------------------


def _traffic(seed):
    """Three clients, three transfers each (one an overdraft): nine, so a
    node's ten-entry recent ring holds every transfer submitted to it."""
    rng = np.random.default_rng(seed)
    clients = [SignKeyPair(rng.bytes(32)) for _ in range(3)]
    out = []
    for c, kp in enumerate(clients):
        for seq in (1, 2, 3):
            amount = 200_000 if (c, seq) == (1, 2) else int(rng.integers(1, 500))
            out.append((c, kp, seq, clients[(c + seq) % 3].public, amount))
    return clients, out


async def _drive(net, seed):
    """Send the seeded traffic, client c to node c mod n; then every node's
    view: per client (sequence, balance), and the recent ring's
    (sender, sequence, recipient, amount, state) rows, sorted."""
    clients, traffic = _traffic(seed)
    n = len(net.services)
    conns = [net.client(i) for i in range(n)]
    try:
        for c, kp, seq, recipient, amount in traffic:
            await conns[c % n].send_asset(kp, seq, recipient, amount)
        views = []
        for conn in conns:
            for kp in clients:
                await wait_for_sequence(conn, kp.public, 3)
            state = [(await conn.get_last_sequence(kp.public), await conn.get_balance(kp.public))
                     for kp in clients]
            ring = sorted((t.sender, t.sender_sequence, t.recipient, t.amount, t.state.name)
                          for t in await conn.get_latest_transactions())
            views.append((state, ring))
        return views
    finally:
        for conn in conns:
            await conn.close()


async def test_port_net_commits_what_the_reference_net_commits():
    async with Network([REF] * 3, seed=21) as ref_net:
        ref_views = await _drive(ref_net, 5)
    async with Network([PORT] * 3, seed=21) as port_net:
        port_views = await _drive(port_net, 5)
    assert port_views == ref_views
    # every node holds the same ledger; a node's ring holds the transfers
    # submitted to it (three each), the overdraft's still pending
    assert all(v[0] == ref_views[0][0] for v in ref_views)
    assert [len(v[1]) for v in ref_views] == [3, 3, 3]
    assert [row[4] for v in ref_views for row in v[1]].count("SUCCESS") == 8


async def test_mixed_net_commits_equal_ledgers():
    async with Network([REF, PORT, REF, PORT], seed=22) as net:
        views = await _drive(net, 6)
        states = [await s.accounts.export_state() for s in net.services]
    assert all(v[0] == views[0][0] for v in views)
    assert all(s == states[0] for s in states)


def _get(cfg, path):
    with urllib.request.urlopen(f"http://{cfg.rpc_address}{path}", timeout=10) as r:
        return r.read().decode()


def _metric_names(text):
    return {line.rpartition(" ")[0] for line in text.splitlines() if line and not line.startswith("#")}


def _keys_of(doc, skip=("build",)):
    """Nested key paths of a JSON document, ``skip`` blocks left out."""
    out = set()
    for key, value in doc.items():
        if key in skip:
            continue
        out.add(key)
        if isinstance(value, dict):
            out |= {f"{key}.{k}" for k in _keys_of(value, ())}
    return out


async def test_metrics_and_statusz_carry_the_reference_keys():
    async def scrape(kind, seed):
        async with Network([kind], seed=seed) as net, net.client() as client:
            sender, recipient = _keys(seed, 2)
            await client.send_asset(sender, 1, recipient.public, 3)
            await wait_for_sequence(client, sender.public, 1)
            loop = asyncio.get_running_loop()
            metrics = await loop.run_in_executor(None, _get, net.configs[0], "/metrics")
            status = await loop.run_in_executor(None, _get, net.configs[0], "/statusz")
            return _metric_names(metrics), json.loads(status)

    port_metrics, port_status = await scrape(PORT, 23)
    ref_metrics, ref_status = await scrape(REF, 23)
    assert port_metrics == ref_metrics
    assert _keys_of(port_status) == _keys_of(ref_status)
    build = port_status["build"]
    assert "jax" not in build and {"git_sha", "python", "torch", "cuda"} <= set(build)


async def test_node_commits_through_the_injected_batch_verifier():
    """``Service.start(config, verifier=...)`` with the CUDA verifier's
    plain path: client signatures at admission and every payload, Echo and
    Ready go through its batches."""
    ver = make_verifier("cuda", device="cpu", batch_size=64, max_delay=0.002)
    try:
        await ver.warmup()
        cfg = make_configs([PORT], np.random.default_rng(24))[0]
        service = await Service.start(cfg, verifier=ver)
        try:
            async with Client(f"http://{cfg.rpc_address}") as client:
                sender, recipient = _keys(24, 2)
                await client.send_asset(sender, 1, recipient.public, 11)
                await wait_for_sequence(client, sender.public, 1)
                assert await client.get_balance(recipient.public) == 100_011
            stats = service.snapshot_stats()
            assert stats["verifier_batches"] >= 2 and stats["verifier_signatures"] >= 2
            assert stats["verifier_mode_name"] == "auto" and stats["verifier_route_rlc"] == 0
        finally:
            await service.close()
    finally:
        await ver.close()


async def test_node_commits_through_the_rlc_route():
    """The same with ``mode="rlc"``: every flush goes through the RLC
    stages (their plain version here), and the transfer commits."""
    ver = make_verifier("cuda", device="cpu", mode="rlc", batch_size=16, max_delay=0.002)
    try:
        await ver.warmup()
        cfg = make_configs([PORT], np.random.default_rng(27))[0]
        service = await Service.start(cfg, verifier=ver)
        try:
            async with Client(f"http://{cfg.rpc_address}") as client:
                sender, recipient = _keys(27, 2)
                await client.send_asset(sender, 1, recipient.public, 13)
                await wait_for_sequence(client, sender.public, 1)
                assert await client.get_balance(recipient.public) == 100_013
            stats = service.snapshot_stats()
            assert stats["verifier_mode_name"] == "rlc" and stats["verifier_rlc_batches"] >= 1
            assert stats["verifier_route_rlc"] == stats["verifier_rlc_batches"]
            assert service.build_block()["rlc_kernel_launches"] == 0  # the plain version ran
        finally:
            await service.close()
    finally:
        await ver.close()


async def test_rlc_mode_config_loads_and_builds_its_verifier(monkeypatch):
    """A config whose ``[verifier]`` table says ``kind = "cuda"`` and ``mode =
    "rlc"`` loads and builds the CUDA verifier on its RLC route (sent to the
    CPU here, where there is no card), which verifies."""
    from at2_node_tpu_torch.crypto.verifier import CudaBatchVerifier
    from at2_node_tpu_torch.ops import cuda_verify

    text = make_configs([PORT], np.random.default_rng(28))[0].dumps()
    table = '[verifier]\nkind = "cpu"\nbatch_size = 256\nmax_delay = 0.002\nmode = "auto"\n'
    assert table in text
    cfg = port_config.Config.loads(text.replace(table, table.replace('"cpu"', '"cuda"').replace(
        '"auto"', '"rlc"').replace("256", "2")))
    assert (cfg.verifier.kind, cfg.verifier.mode, cfg.verifier.batch_size) == ("cuda", "rlc", 2)
    monkeypatch.setattr(cuda_verify, "resolve_device", lambda device=None: torch.device("cpu"))
    ver = cfg.verifier.make()
    try:
        assert isinstance(ver, CudaBatchVerifier) and ver.router.mode == "rlc"
        kp = _keys(28, 1)[0]
        items = [(kp.public, b"one", kp.sign(b"one")), (kp.public, b"two", kp.sign(b"one"))]
        assert await ver.verify_many(items) == [True, False]
        assert ver.stats()["rlc_batches"] == 1
    finally:
        await ver.close()


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
async def test_checkpoint_carries_across_packages(direction, tmp_path):
    """A node's ``[checkpoint]`` file, written at shutdown by one package,
    restores a node of the other with equal balances, sequences and
    recent-transaction ring."""
    first, second = (REF, PORT) if direction == "reference_to_port" else (PORT, REF)
    path = str(tmp_path / "ledger.json")
    tables = {"checkpoint": dict(path=path, interval=0.0)}
    async with Network([first], seed=25, **tables) as net:
        views = await _drive(net, 7)
    async with Network([second], seed=26, **tables) as net:
        clients, _ = _traffic(7)
        async with net.client() as conn:
            state = [(await conn.get_last_sequence(kp.public), await conn.get_balance(kp.public))
                     for kp in clients]
            ring = sorted((t.sender, t.sender_sequence, t.recipient, t.amount, t.state.name)
                          for t in await conn.get_latest_transactions())
    assert [(state, ring)] == views


# -- chip_smoke.py phase 6 on the CPU --------------------------------------


async def test_chip_smoke_phase6_runs_with_the_cpu_kind(capsys):
    runs = await chip_smoke.node_path(9, None, None, kind="cpu", n_clients=4, per_batched=6,
                                      per_unary=3, n_tampered=2, deadline_s=60.0)
    out = capsys.readouterr().out
    assert set(runs) == {"node_grpc_batched", "node_grpc_unary", "node_grpc_web"}
    assert runs["node_grpc_batched"]["transfers"] == 24 and runs["node_grpc_unary"]["transfers"] == 12
    for run in (runs["node_grpc_batched"], runs["node_grpc_unary"]):
        assert len(run["nodes"]) == 4 and all(n["signatures"] > 0 for n in run["nodes"])
    assert sum(n["rejected_at_ingress"] for n in runs["node_grpc_unary"]["nodes"]) == 2
    # between the runs, one grpc-web SendAsset committed on every node
    assert 0 < runs["node_grpc_web"]["reply_s"] <= runs["node_grpc_web"]["commit_s"]
    assert "node net (grpc-web SendAsset): one transfer from a fresh account" in out
    assert "2 tampered transfers refused with INVALID_ARGUMENT" in out
    assert "every server exited 0 on SIGTERM" in out


async def test_chip_smoke_phase7_runs_with_the_cpu_kind(capsys):
    """Phase 7's harness: the ``[verifier]`` table of every node is edited
    to ``mode = "rlc"`` (the CPU kind's host RLC engine here) and the runs
    come back under their own names."""
    runs = await chip_smoke.node_path(10, None, None, kind="cpu", n_clients=4, per_batched=5,
                                      per_unary=2, n_tampered=2, deadline_s=60.0, mode="rlc")
    out = capsys.readouterr().out
    assert set(runs) == {"rlc_node_grpc_batched", "rlc_node_grpc_unary"}
    assert runs["rlc_node_grpc_unary"]["transfers"] == 8
    assert 'mode = "rlc", up and meshed' in out
    assert "rlc node net: 2 tampered transfers refused with INVALID_ARGUMENT" in out.replace(
        "4 accounts equal the python-int replay on all 4 nodes; ", "")

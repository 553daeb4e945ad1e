"""The port's node configuration against the JAX package's: a TOML the
reference writes loads in the port and dumps byte-equal (and back), the
verifier kinds map onto this build's (``"cuda"`` for ``"tpu"``; ``"pool"``
as written), and a port ``Service`` starts with ``[plane] shards = 2``
under each executor, with ``[store] dir`` and with ``[finality] enabled``,
reports them on ``/statusz`` (and ``/certz``) and stops cleanly.
"""

import asyncio
import dataclasses

import numpy as np
import pytest

from at2_node_tpu.node import config as ref_config
from at2_node_tpu_torch.cli import server as server_cli
from at2_node_tpu_torch.crypto.keys import ExchangeKeyPair, SignKeyPair
from at2_node_tpu_torch.net.peers import Peer
from at2_node_tpu_torch.node import config as port_config
from at2_node_tpu_torch.node.service import Service


def _base(module, rng, verifier=None):
    """A config of ``module``'s; the verifier kind is the host's, named
    explicitly, unless ``verifier`` is given, since the two packages'
    defaults differ ("cpu" in the reference, "cuda" in the port)."""
    return module.Config(
        node_address="127.0.0.1:7001",
        rpc_address="localhost:7002",
        sign_key=module.SignKeyPair(rng.bytes(32)),
        network_key=module.ExchangeKeyPair(rng.bytes(32)),
        nodes=[
            module.Peer("127.0.0.1:7003", rng.bytes(32), rng.bytes(32)),
            module.Peer("node-b:7005", rng.bytes(32), rng.bytes(32), region="eu"),
        ],
        verifier=verifier or module.VerifierConfig(kind="cpu"),
    )


# every table set to a non-default value (ids name the case)
_TABLES = {
    "default": {},
    "thresholds": {"echo_threshold": 2, "ready_threshold": 2},
    "verifier": {"verifier": dict(batch_size=64, max_delay=0.004, mode="per_sig", rlc_min_batch=32)},
    "observability": {"observability": dict(stats_interval=1.5, profile_dir="traces", endpoints=False,
                                            trace_sample=3, audit_every=0, capture_cap=0)},
    "slo": {"slo": dict(enabled=False, latency_p99_ms=250.0)},
    "checkpoint": {"checkpoint": dict(path="ledger.json", interval=2.5)},
    "store": {"store": dict(dir="store", shards=4, sync="always")},
    "membership": {"membership": dict(admin_public="ab" * 32, grace=1.0)},
    "catchup": {"catchup": dict(enabled=False, quorum=2)},
    "batching": {"batching": dict(enabled=False, max_entries=64, window=0.01)},
    "admission": {"admission": dict(preverify=False, fail_limit=8)},
    "plane": {"plane": dict(shards=4, executor="inline")},
    "wan": {"wan": dict(overlap_ready=True, region="eu")},
    "overload": {"overload": dict(enabled=True, shed_start=0.4)},
    "finality": {"finality": dict(enabled=True, quorum=3)},
}


def _with(module, rng, case):
    cfg = _base(module, rng)
    for key, value in _TABLES[case].items():
        if isinstance(value, dict):
            table = getattr(cfg, key)
            setattr(cfg, key, dataclasses.replace(table, **value))
        else:
            setattr(cfg, key, value)
    return cfg


@pytest.mark.parametrize("case", list(_TABLES))
def test_reference_toml_roundtrips_byte_equal(case):
    text = _with(ref_config, np.random.default_rng(3), case).dumps()
    port = port_config.Config.loads(text)
    assert port.dumps() == text
    assert ref_config.Config.loads(port.dumps()).dumps() == text
    assert port == _with(port_config, np.random.default_rng(3), case)


def test_cuda_kind_roundtrips_and_tpu_pool_raise():
    rng = np.random.default_rng(4)
    text = _base(ref_config, rng).dumps()
    assert '[verifier]\nkind = "cpu"\n' in text
    cuda = text.replace('kind = "cpu"', 'kind = "cuda"')
    assert port_config.Config.loads(cuda).dumps() == cuda
    # the port's default table is the card's; the reference's the host's,
    # and that one line is all that differs
    port_default = _base(port_config, np.random.default_rng(4), verifier=port_config.VerifierConfig())
    ref_default = _base(ref_config, np.random.default_rng(4), verifier=ref_config.VerifierConfig())
    assert port_default.dumps() == cuda and ref_default.dumps() == text
    with pytest.raises(ValueError, match='"cuda"'):
        port_config.Config.loads(text.replace('kind = "cpu"', 'kind = "tpu"'))
    # the device pool loads and dumps as written (it raised until it was
    # ported); without a GPU, building it raises
    pool = text.replace('kind = "cpu"', 'kind = "pool"')
    assert port_config.Config.loads(pool).dumps() == pool
    assert port_config.Config.loads(pool).verifier.kind == "pool"


async def test_default_verifier_table_builds_the_auto_cpu_verifier():
    """The node default table with the host kind (the reference's default)
    builds the CPU verifier in ``auto`` with the RLC engine loaded."""
    ver = port_config.VerifierConfig(kind="cpu").make()
    try:
        assert type(ver).__name__ == "CpuVerifier"
        assert ver.mode == "auto" and ver.router.min_batch == 128
        await ver.warmup()
        assert ver.engine.ready()
    finally:
        await ver.close()


async def test_cuda_kind_without_a_gpu_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: the kind builds")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_config.VerifierConfig().make()


def _port_config(**tables):
    cfg = port_config.Config(
        node_address="127.0.0.1:1", rpc_address="127.0.0.1:2",
        sign_key=SignKeyPair.random(), network_key=ExchangeKeyPair.random(),
        nodes=[Peer("127.0.0.1:3", ExchangeKeyPair.random().public, SignKeyPair.random().public)],
    )
    for key, value in tables.items():
        setattr(cfg, key, dataclasses.replace(getattr(cfg, key), **value))
    return cfg


def test_finality_table_starts_and_serves_certz():
    """``[finality] enabled`` with ``quorum = 3``, refused until finality
    was ported, now starts a node: the assembler holds the two members
    (this node and its one peer), caps the quorum at them, and ``/certz``,
    ``/statusz`` and ``/metrics`` serve its state; the node's own
    co-signature alone does not reach the quorum."""
    import json
    import urllib.request

    import chip_smoke

    rng = np.random.default_rng(13)
    node, rpc = chip_smoke.free_ports(2)
    cfg = _port_config(finality=dict(enabled=True, quorum=3))
    cfg.node_address, cfg.rpc_address = f"127.0.0.1:{node}", f"127.0.0.1:{rpc}"
    cfg.sign_key, cfg.network_key = SignKeyPair(rng.bytes(32)), ExchangeKeyPair(rng.bytes(32))
    cfg.verifier = port_config.VerifierConfig(kind="cpu")

    def get(path):
        with urllib.request.urlopen(f"http://{cfg.rpc_address}{path}", timeout=10) as r:
            return r.read().decode()

    async def run():
        service = await Service.start(cfg)
        try:
            service._emit_beacon()  # co-sign the current frontier
            doc = json.loads(await asyncio.to_thread(get, "/certz"))
            assert doc["quorum"] == 2 and doc["scheme"] == "multi_eddsa" and doc["epoch"] == 0
            assert doc["members"] == sorted([cfg.sign_key.public.hex(), cfg.nodes[0].sign_public.hex()])
            assert doc["chain"] == [] and doc["equivocation"] is None
            fin = service.statusz()["finality"]
            assert fin["enabled"] and fin["cosigs"] == 1 and fin["pending"] == 1
            assert "at2_finality_equivocation 0" in await asyncio.to_thread(get, "/metrics")
        finally:
            await service.close()

    asyncio.run(run())


@pytest.mark.parametrize(
    "tables",
    [
        {"plane": dict(shards=2, executor="inline")},
        {"plane": dict(shards=2, executor="thread")},
        {"plane": dict(shards=2, executor="process", ring_slots=64)},
        {"store": dict(dir="store", flush_interval=0.1)},
    ],
    ids=["plane-inline", "plane-thread", "plane-process", "store"],
)
def test_plane_and_store_tables_start_and_report(tables, tmp_path):
    """The ``[plane]`` and ``[store]`` tables, refused until the sharded
    plane and the store were ported, now start a node."""
    import chip_smoke

    rng = np.random.default_rng(12)
    node, rpc = chip_smoke.free_ports(2)
    if "store" in tables:
        tables = {"store": dict(tables["store"], dir=str(tmp_path / "store"))}
    cfg = _port_config(**tables)
    cfg.node_address, cfg.rpc_address = f"127.0.0.1:{node}", f"127.0.0.1:{rpc}"
    cfg.sign_key, cfg.network_key = SignKeyPair(rng.bytes(32)), ExchangeKeyPair(rng.bytes(32))
    cfg.verifier = port_config.VerifierConfig(kind="cpu")

    async def run():
        service = await Service.start(cfg)
        try:
            status = service.statusz()
            if "plane" in tables:
                want = tables["plane"]
                assert {k: status["plane"][k] for k in ("shards", "executor", "effects_dropped")} == \
                    {"shards": 2, "executor": want["executor"], "effects_dropped": 0}
                assert service.broadcast.plane_info() == status["plane"]
                if want["executor"] == "process":
                    assert all(service.broadcast._executor.alive(i) for i in range(2))
            else:
                assert status["plane"]["shards"] == 1
                await asyncio.sleep(0.3)  # a periodic flush or two
                st = service.snapshot_stats()
                assert st["store_gen"] >= 1 and st["store_flushes"] >= 1
                # a store-backed start with a peer to catch up from waits
                # in "catchup" for its first session (ours never answers)
                assert status["recovery"]["state"] == "catchup"
        finally:
            await service.close()
        return service

    service = asyncio.run(run())
    if "plane" in tables and tables["plane"]["executor"] == "process":
        ex = service.broadcast._executor
        assert all(not p.is_alive() for p in ex._procs) and ex.actions == []
    if "store" in tables:
        assert (tmp_path / "store" / "MANIFEST.json").exists()


def test_coordinator_raises_naming_item_11(monkeypatch):
    """``AT2_COORDINATOR`` is no longer refused (item 11 is ported): alone
    it raises the reference's ``ValueError`` naming the two other
    variables; unset, bring-up is a no-op."""
    monkeypatch.delenv("AT2_COORDINATOR", raising=False)
    assert server_cli.maybe_initialize() is False
    monkeypatch.setenv("AT2_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.delenv("AT2_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("AT2_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="AT2_NUM_PROCESSES"):
        server_cli.maybe_initialize()

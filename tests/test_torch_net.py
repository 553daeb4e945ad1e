"""The broadcast slice whole: four nodes on 127.0.0.1 over encrypted TCP,
each with its own mesh, ``Broadcast``, verifier and ``Accounts``, driven
by ``chip_smoke.py``'s phase-5 harness at a small size with thresholds of
2 peers.

* A net of port nodes, each verifying through the batched CUDA verifier's
  plain path (``device="cpu"``, 64-lane buckets), commits the same seeded
  transfers, on both planes, to the same ledger as a net of reference
  nodes verifying with the reference's per-signature CPU verifier.
* A mixed net of two reference and two port nodes commits them to equal
  ledgers: the wire, the handshake and the signatures interoperate.

Each runs with the native channel reader forced on and forced off.
Tampered twins of some slots never commit. Last, ``chip_smoke.py``'s
phase 5 itself runs here at a small size, with OpenSSL in the kernel's
place."""

import asyncio
import contextlib
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from at2_node_tpu.broadcast import messages as ref_msgs
from at2_node_tpu.broadcast.stack import Broadcast as RefBroadcast
from at2_node_tpu.crypto.keys import ExchangeKeyPair as RefExchangeKeyPair
from at2_node_tpu.crypto.keys import SignKeyPair as RefSignKeyPair
from at2_node_tpu.crypto.verifier import CpuVerifier as RefCpuVerifier
from at2_node_tpu.ledger import accounts as ref_accounts
from at2_node_tpu.net.peers import Mesh as RefMesh
from at2_node_tpu.net.peers import Peer as RefPeer
from at2_node_tpu.types import ThinTransaction as RefThinTransaction
from at2_node_tpu_torch.crypto import verifier as port_verifier
from at2_node_tpu_torch.crypto.verifier import CpuVerifier, CudaBatchVerifier, make_verifier
from at2_node_tpu_torch.native.ingest import ingest_available, verify_bulk_native
from at2_node_tpu_torch.ops import cuda_verify

torch.set_num_threads(1)

CLIENTS = 4
PER_CLIENT = 3
DEADLINE_S = 120.0


def ref_modules():
    from types import SimpleNamespace

    return SimpleNamespace(
        Payload=ref_msgs.Payload, TxBatch=ref_msgs.TxBatch, Broadcast=RefBroadcast,
        ExchangeKeyPair=RefExchangeKeyPair, SignKeyPair=RefSignKeyPair,
        AccountModificationError=ref_accounts.AccountModificationError,
        Accounts=ref_accounts.Accounts, Mesh=RefMesh, Peer=RefPeer,
        ThinTransaction=RefThinTransaction,
    )


@pytest.fixture
def plain_path_in_turn(monkeypatch):
    """The four verifiers of a port net take turns on the plain path. It
    is thousands of small eager ops that each hand the GIL back, so four
    threads running it at once on one host mostly wait on each other (a
    64-lane batch: 0.7 s alone, 2.1 s each with four at once). Same
    results, a quarter of the time."""
    plain, lock = cuda_verify.verify_packed, threading.Lock()

    def in_turn(rows):
        with lock:
            return plain(rows)

    monkeypatch.setattr(cuda_verify, "verify_packed", in_turn)


@pytest.fixture(params=["native", "asyncio"])
def reader(request, monkeypatch):
    """Which inbound plane every mesh of the test serves (both packages
    read the same switches)."""
    monkeypatch.delenv("AT2_FORCE_NATIVE_READER", raising=False)
    monkeypatch.delenv("AT2_NO_NATIVE_READER", raising=False)
    monkeypatch.setenv(
        "AT2_FORCE_NATIVE_READER" if request.param == "native" else "AT2_NO_NATIVE_READER", "1")
    return request.param


async def run_net(node_mods, verifiers, batching: bool, seed: int, reader: str) -> dict:
    """Start the net, drive the seeded traffic, check it (every valid
    transfer committed everywhere, equal ledgers equal to the replay, no
    tampered twin), and return the ledger."""
    port = chip_smoke.port_modules()
    rng = np.random.default_rng(seed)
    nodes = await chip_smoke.start_net(node_mods, verifiers, rng, deadline_s=30.0,
                                       threshold=2, workers=4, batching=batching)
    try:
        want_readers = 3 if reader == "native" else 0
        assert [n.mesh.stats()["native_readers"] for n in nodes] == [want_readers] * len(nodes)
        traffic = chip_smoke.make_traffic(port, np.random.default_rng(seed + 1), CLIENTS,
                                          PER_CLIENT, tamper_share=0.25)
        subs, valid, good_hash, bad_hashes = traffic
        assert bad_hashes and len(valid) == CLIENTS * PER_CLIENT
        await chip_smoke.drive_net(nodes, subs, valid, DEADLINE_S)
        state = await chip_smoke.check_ledgers(nodes, valid, good_hash, bad_hashes)
        for node in nodes:
            assert node.bcast.stats["delivered" if not batching else "batch_entries_delivered"] \
                >= len(valid)
        return state
    finally:
        for node in nodes:
            await node.close()


@pytest.mark.parametrize("batching", [True, False], ids=["batched", "per_tx"])
async def test_port_net_commits_the_reference_nets_ledger(batching, reader, plain_path_in_turn):
    ref = await run_net([ref_modules()] * 4,
                        [RefCpuVerifier(mode="per_sig") for _ in range(4)], batching, 11, reader)
    verifiers = [make_verifier("cuda", device="cpu", batch_size=64, max_delay=0.002)
                 for _ in range(4)]
    for v in verifiers:
        assert v.device.type == "cpu" and v.buckets == (64,)
    port = await run_net([chip_smoke.port_modules()] * 4, verifiers, batching, 11, reader)
    assert port == ref
    assert all(v.batches_dispatched > 0 for v in verifiers)


@pytest.mark.parametrize("batching", [True, False], ids=["batched", "per_tx"])
async def test_mixed_reference_and_port_net_commits_equal_ledgers(batching, reader):
    r, p = ref_modules(), chip_smoke.port_modules()
    verifiers = [RefCpuVerifier(mode="per_sig"), CpuVerifier(),
                 RefCpuVerifier(mode="per_sig"), CpuVerifier()]
    mixed = await run_net([r, p, r, p], verifiers, batching, 23, reader)
    ref = await run_net([r] * 4, [RefCpuVerifier(mode="per_sig") for _ in range(4)],
                        batching, 23, reader)
    assert mixed == ref
    assert all(v.signatures_verified > 0 for v in verifiers)


class _OpenSslStages(CudaBatchVerifier):
    """The batched verifier with OpenSSL's bulk verify in its three stages
    where the card's kernel would run, counted as a launch, and posing as
    a CUDA device: the stand-in that lets ``chip_smoke.py``'s phase 5 run
    here, checks and printout included."""

    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.device = torch.device("cuda")

    def _device_ctx(self):
        return contextlib.nullcontext()

    def _prep(self, pks, msgs, sigs, bucket):
        return list(zip(pks, msgs, sigs))

    def _launch(self, items):
        cuda_verify.launches += 1
        return verify_bulk_native(items, 2)

    def _finish(self, verdicts, n):
        return verdicts

    async def warmup(self):
        await asyncio.get_running_loop().run_in_executor(None, ingest_available)


async def test_chip_smoke_phase5_runs_with_openssl_in_the_kernels_place(monkeypatch, capsys):
    monkeypatch.setattr(port_verifier, "make_verifier", lambda kind, **kw: _OpenSslStages(**kw))
    monkeypatch.setattr(chip_smoke, "NET_PER_CLIENT_BATCHED", 8)
    monkeypatch.setattr(chip_smoke, "NET_PER_CLIENT_PER_TX", 2)
    runs = await chip_smoke.net_path(3, {256: {"ms": 0.43}})
    out = capsys.readouterr().out
    for name, transfers in (("net_batched", 128), ("net_per_tx", 32)):
        run = runs[name]
        assert run["transfers"] == transfers and run["launches"] > 0 and run["native_ingest"]
        assert len(run["nodes"]) == 4
        assert all(n["batches"] > 0 and n["signatures"] >= transfers for n in run["nodes"])
    assert all(n["slots_sent"] > 0 for n in runs["net_batched"]["nodes"])
    assert "one process and one GIL" in out and "stage histograms" in out

"""The port's observability tools against the JAX package's:
``tools/incident.py``, ``tools/profile_collect.py`` and
``tools/plane_bench.py --smoke-profile``.

* twins of ``tests/test_obs.py``'s incident-bundle tests, on the port's
  ``incident``; the same dumps give the reference's files, manifest and
  bundle hash, canned and scraped from a live port node; a bundle written
  to disk rebuilds from its files with its hash (phase 12e's check);
* canned ``/statusz`` and ``/profilez`` dumps (the loop and the process
  executor's per-shard keys) give the reference's decomposition, phase
  table and top serial term; a live port node profiles under load;
* the profiler smoke: 3 nodes, 200 transactions, the ``thread`` executor
  at 2 shards, ``--verifier cpu``: every phase counter ticks, slot GC's
  too when its pass comes 8 s after the start.

Every key is seeded with numpy; every comparison is exact."""

import asyncio
import contextlib
import copy
import hashlib
import io
import json

import numpy as np
import pytest

import chip_smoke
from at2_node_tpu.tools import incident as ref_incident
from at2_node_tpu.tools import profile_collect as ref_profile
from at2_node_tpu_torch.client import Client
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.node.config import VerifierConfig
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.obs.profiler import build_info
from at2_node_tpu_torch.tools import incident, plane_bench, profile_collect
from at2_node_tpu_torch.tools._common import make_net_configs


class TestIncidentBundle:
    _DUMPS = {
        "nodes": {
            "127.0.0.1:9101": {
                "statusz": {"health": {"status": "ok"}, "stats": {"c": 1}},
                "healthz": {"status": "ok"},
                "tracez": {"traces": [{"seq": 1}]},
                "debugz": {"snapshots": []},
            },
            "127.0.0.1:9102": {
                "statusz": {"health": {"status": "degraded"}},
                "healthz": {"status": "degraded"},
                "capturez": {"cap": 8, "captured": 2, "records": []},
            },
        }
    }

    def test_bundle_is_byte_identical(self):
        b1 = incident.build_bundle(copy.deepcopy(self._DUMPS), reason="slo:breach")
        b2 = incident.build_bundle(copy.deepcopy(self._DUMPS), reason="slo:breach")
        assert b1["files"] == b2["files"]
        assert b1["manifest"] == b2["manifest"]
        # every dump surface landed as a file, hashed in the manifest
        assert set(b1["manifest"]["files"]) == set(b1["files"])
        assert len(b1["files"]) == 7

    def test_bundle_hash_tracks_content_and_reason_is_unhashed(self):
        base = incident.build_bundle(copy.deepcopy(self._DUMPS), reason="a")
        mutated = copy.deepcopy(self._DUMPS)
        mutated["nodes"]["127.0.0.1:9101"]["statusz"]["stats"]["c"] = 2
        changed = incident.build_bundle(mutated, reason="a")
        assert changed["manifest"]["bundle_sha256"] != base["manifest"]["bundle_sha256"]
        # two collectors racing the same incident may name the trigger
        # differently; the bundle hash covers the EVIDENCE, not the label
        relabeled = incident.build_bundle(copy.deepcopy(self._DUMPS), reason="b")
        assert relabeled["manifest"]["bundle_sha256"] == base["manifest"]["bundle_sha256"]

    def test_write_bundle_matches_manifest(self, tmp_path):
        bundle = incident.build_bundle(copy.deepcopy(self._DUMPS))
        manifest_path = incident.write_bundle(str(tmp_path / "b"), bundle)
        with open(manifest_path) as fp:
            manifest = json.load(fp)
        assert manifest == bundle["manifest"]
        for rel, digest in manifest["files"].items():
            data = (tmp_path / "b" / rel).read_bytes()
            assert hashlib.sha256(data).hexdigest() == digest

    def test_edge_triggering(self):
        ok = {"nodes": {"a:1": {"statusz": {
            "health": {"status": "ok"}, "stats": {"recorder_snapshots": 2}}}}}
        bad = {"nodes": {"a:1": {"statusz": {
            "health": {"status": "diverged", "slo_breach": ["latency_p99"],
                       "divergence": {"peer": "ff"}},
            "stats": {"recorder_snapshots": 3}}}}}
        assert incident._edges(None, bad) == []  # first poll is baseline only
        assert incident._edges(ok, ok) == []
        reasons = incident._edges(ok, bad)
        assert any("health:diverged" in r for r in reasons)
        assert any("slo:" in r for r in reasons)
        assert any("divergence" in r for r in reasons)
        assert any("anomaly_snapshot" in r for r in reasons)
        # level-hold: staying degraded is NOT a fresh incident
        assert incident._edges(bad, bad) == []
        assert incident._edges(ok, bad) == ref_incident._edges(ok, bad)

    @pytest.mark.parametrize("reason", ["manual", "127.0.0.1:9102:health:degraded"])
    def test_bundle_equals_the_reference(self, reason):
        port = incident.build_bundle(copy.deepcopy(self._DUMPS), reason=reason)
        ref = ref_incident.build_bundle(copy.deepcopy(self._DUMPS), reason=reason)
        assert port["files"] == ref["files"]
        assert port["manifest"] == ref["manifest"]


def _net_configs(n, seed):
    ports = iter(chip_smoke.free_ports(2 * n))
    return make_net_configs(n, ports, seed=seed, verifier=VerifierConfig(kind="cpu"))


async def _send(cfg, seed, clients=4, per_client=16):
    """Seeded clients' transfers into one node (sequences 1..per_client)."""
    rng = np.random.default_rng(seed)
    kps = [SignKeyPair(rng.bytes(32)) for _ in range(clients)]
    async with Client(f"http://{cfg.rpc_address}") as conn:
        await asyncio.gather(*(
            conn.send_asset_many(kp, [(s, kps[(c + 1) % clients].public, 1)
                                      for s in range(1, per_client + 1)])
            for c, kp in enumerate(kps)))
    return clients * per_client


async def test_live_node_bundle_equals_the_reference_and_rebuilds_from_disk(tmp_path):
    cfg = _net_configs(1, seed=61)[0]
    service = await Service.start(cfg)
    try:
        await _send(cfg, seed=62)
        host, port = cfg.rpc_address.rsplit(":", 1)
        dumps = await incident.collect([(host, int(port))])
    finally:
        await service.close()
    surfaces = dumps["nodes"][cfg.rpc_address]
    assert {"statusz", "healthz", "tracez", "debugz"} <= set(surfaces)
    assert not any("error" in doc for doc in surfaces.values())
    port_b = incident.build_bundle(copy.deepcopy(dumps), reason="manual")
    ref_b = ref_incident.build_bundle(copy.deepcopy(dumps), reason="manual")
    assert port_b["files"] == ref_b["files"]
    assert port_b["manifest"]["bundle_sha256"] == ref_b["manifest"]["bundle_sha256"]
    incident.write_bundle(str(tmp_path / "b"), port_b)
    rebuilt = chip_smoke.rebuilt_dumps(str(tmp_path / "b"))
    assert incident.build_bundle(rebuilt, reason="manual")["manifest"] == port_b["manifest"]


def _stats(scale: int, shards: bool) -> dict:
    rng = np.random.default_rng(71 + scale)
    out = {f"phase_{p}_ns": int(rng.integers(0, 10**7)) * scale for p in profile_collect.PHASES}
    out["phase_plane_total_ns"] = sum(out[f"phase_{p}_ns"] for p in profile_collect.PLANE_LEAF_PHASES) * 11 // 10
    if shards:
        for k in range(2):
            for p in profile_collect.PLANE_LEAF_PHASES + ("plane_total",):
                out[f"phase_{p}_shard{k}_ns"] = int(rng.integers(0, 10**7)) * scale
    out["committed"] = 5
    return out


_PROFILE = {
    "folded": ["main;loop;drain 17", "main;loop;stack.py:_post_batch:1580 42", "bad line", "x;y 3"],
    "sampler": {"samples": 62},
    "build": {"git_sha": "abc", "config_hash": "cfg", "uptime_s": 3.5},
}


@pytest.mark.parametrize("shards", [False, True])
def test_canned_dumps_decompose_and_render_as_the_reference(shards):
    s0, s1 = _stats(1, shards), _stats(3, shards)
    port = profile_collect.decompose(s0, s1, copy.deepcopy(_PROFILE))
    ref = ref_profile.decompose(s0, s1, copy.deepcopy(_PROFILE))
    assert port == ref
    assert port["top_serial"]["site"] == "stack.py:_post_batch:1580"
    assert bool(port["shards"]) == shards
    results = [("127.0.0.1:1", dict(port, capture_started=True, node="n1")),
               ("127.0.0.1:2", RuntimeError("connection refused"))]
    outs = []
    for mod in (profile_collect, ref_profile):
        buf = io.StringIO()
        rc = mod.render(copy.deepcopy(results), 5.0, 99.0, out=buf)
        outs.append((rc, buf.getvalue().splitlines()))
    (rc_p, port_lines), (rc_r, ref_lines) = outs
    assert rc_p == rc_r == 1
    # the collector line names the build: torch here, jax there
    assert port_lines[0].endswith(f"torch={build_info()['torch']}")
    assert port_lines[1:] == ref_lines[1:]
    assert any(line.startswith("  top serial term: ") for line in port_lines)


async def test_live_node_profiles_under_load():
    """The 1.0 s capture opens once the node is committing, and rounds of
    4 x 64 fresh transfers (seeds 64, 65, ...) go on until it has closed,
    so the plane works inside the window however slow the host is."""
    cfg = _net_configs(1, seed=63)[0]
    service = await Service.start(cfg)
    done = asyncio.Event()

    async def load() -> int:
        sent, seed = 0, 64
        while not done.is_set():
            sent += await _send(cfg, seed=seed, per_client=64)
            seed += 1
        return sent

    try:
        host, port = cfg.rpc_address.rsplit(":", 1)
        sender = asyncio.ensure_future(load())
        while not service.committed and not sender.done():
            await asyncio.sleep(0.01)
        results = await profile_collect.run([(host, int(port))], 1.0)
        done.set()
        sent = await sender
        while service.committed < sent:
            await asyncio.sleep(0.05)
    finally:
        done.set()
        await service.close()
    (addr, rec), = results
    assert addr == cfg.rpc_address and not isinstance(rec, Exception)
    assert rec["capture_started"] and rec["plane_total_ms"] > 0
    assert set(rec["phase_ms"]) == set(profile_collect.PHASES)
    buf = io.StringIO()
    assert profile_collect.render(results, 1.0, 0.0, out=buf) == 0
    assert "top serial term: " in buf.getvalue()


def test_smoke_profile_waits_for_the_slot_gc_pass(monkeypatch):
    """Slot GC every 8 s, seconds after the commits: the fleet stays up
    until the pass has ticked ``slot_gc``."""
    from at2_node_tpu_torch.broadcast import stack

    monkeypatch.setattr(stack, "GC_INTERVAL", 8.0)
    with contextlib.redirect_stderr(io.StringIO()):
        res = plane_bench.smoke_profile(3, 200, 60.0, verifier="cpu")
    assert res["ok"] and res["zero_phases"] == [], res
    assert res["phase_ns"]["slot_gc"] > 0 and res["executor"] == "loop"


def test_smoke_profile_thread_shards_tick_every_counter(tmp_path):
    out = tmp_path / "smoke.json"
    with contextlib.redirect_stderr(io.StringIO()):
        rc = plane_bench.main(["--smoke-profile", "--nodes", "3", "--txs", "200", "--shards", "2",
                               "--executor", "thread", "--verifier", "cpu", "--out", str(out)])
    doc = json.loads(out.read_text())
    assert rc == 0 and doc["ok"], doc
    assert doc["zero_phases"] == [] and doc["executor"] == "thread"
    assert doc["committed_tx_per_sec"] > 0 and doc["folded_lines"] > 0
    assert doc["card"] == "cpu"

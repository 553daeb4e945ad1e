#!/usr/bin/env bash
# CI gate for at2_node_tpu_torch, the PyTorch/CUDA port: scripts/ci.sh's
# gates, in its order and under its headings, each with the same contract
# and thresholds, run on the port's modules and on the port's twins of the
# reference's test files. Every gate that starts a real Service on the
# host asks for the host verifier (VerifierConfig(kind="cpu"), --verifier
# cpu): the port's entry points default to the card and never fall back.
#
# Tiers:
#   fast - lint, the port's fast tests (pytest -m 'not slow') and the gates
#   all  - fast + the port's native sanitizers + its slow tier (pytest -m slow)
#   gpu  - chip_smoke.py on one CUDA card, alone: passes only when its last
#          line says "ok": true on platform "gpu"; without a card it fails
#
# Usage: scripts/ci_torch.sh [fast|all|gpu]   (default: all)

set -euo pipefail
cd "$(dirname "$0")/.."

tier="${1:-all}"
case "$tier" in
  fast|all|gpu) ;;
  *) echo "usage: scripts/ci_torch.sh [fast|all|gpu]" >&2; exit 2 ;;
esac

# this run's scratch files, under TMPDIR: two checkouts gating at once
# never read each other's
work="$(mktemp -d)"
trap 'rm -rf "$work"' EXIT
export CI_TORCH_WORK="$work"

if [ "$tier" = "gpu" ]; then
  # the card's smoke: every kernel held against its plain version and
  # every served path driven, deploy/README_torch.md's runbook included
  smoke_log="$work/chip_smoke.log"
  set +e
  python3 chip_smoke.py | tee "$smoke_log"
  rc=${PIPESTATUS[0]}
  set -e
  SMOKE_LAST="$(tail -n 1 "$smoke_log")" SMOKE_RC="$rc" python - <<'EOF'
import json, os, sys

rc = int(os.environ["SMOKE_RC"])
try:
    doc = json.loads(os.environ["SMOKE_LAST"])
except ValueError:
    doc = {}
dev = doc.get("device", {}) if isinstance(doc, dict) else {}
if rc != 0 or doc.get("ok") is not True or dev.get("platform") != "gpu":
    sys.exit(f"gpu tier FAILED: chip_smoke.py exited {rc}, last line "
             f"{os.environ['SMOKE_LAST'][:200]!r}")
print(f"chip_smoke.py ok on {dev.get('kind')} (count {dev.get('count')})")
EOF
  echo "CI gpu tier green."
  exit 0
fi

echo "== lint =="
if command -v ruff >/dev/null 2>&1; then
  ruff check at2_node_tpu_torch tests/test_torch_*.py chip_smoke.py chip_loop.py
else
  # ruff is not in this image: fall back to a compile pass (catches syntax
  # errors and nothing else; keep ruff in real CI)
  python -m compileall -q at2_node_tpu_torch tests/test_torch_*.py chip_smoke.py \
      chip_loop.py
fi

echo "== native library =="
python - <<'EOF'
from at2_node_tpu_torch.native import native_available
print("native prep library:", "available" if native_available() else
      "UNAVAILABLE (python fallback will be used)")
EOF

echo "== fast tier =="
python -m pytest tests/test_torch_*.py -q -m "not slow"

echo "== pipeline smoke gate =="
# Dispatch-pipeline regression: 4 overlapped batches on the
# fake device must report sane stats counters (batches, occupancy, zero
# leaked capacity), plus the overlap/backpressure/close-race invariants.
# Fake-device only (no kernel build), so the gate stays in the fast tier;
# named explicitly so a marker/collection change can never drop it. The
# port twins tests/test_pipeline.py in tests/test_torch_verifier.py.
python -m pytest tests/test_torch_verifier.py -q -m "not slow"

echo "== metrics-endpoints smoke gate =="
# Observability regression: the registry must stay exact under
# thread + asyncio concurrency, and a live node must serve /metrics,
# /healthz, /statusz (valid Prometheus exposition + JSON) through the
# real PortMux on its public RPC port. Named explicitly so a marker/
# collection change can never drop the endpoints from CI.
python -m pytest tests/test_torch_obs.py -q

echo "== poison-slot chaos gate =="
# Byzantine amplification regression: a bad-sig entry per
# ingress batch must not stall slots, fire stall kicks, or trigger
# catchup. Named explicitly so a marker/collection change in the fast
# tier can never silently drop it.
python -m pytest tests/test_torch_faults.py::TestPoisonChaos \
    tests/test_torch_poison_resolution.py -q

echo "== sim determinism gate =="
# Deterministic simulation: the same seed must reproduce the
# same campaign hash (sha256 over per-episode wire-trace hashes),
# byte-identical, run to run. PYTHONHASHSEED is pinned because set
# iteration order feeds the schedule.
export PYTHONHASHSEED=0
sim_hash() {
  python -m at2_node_tpu_torch.tools.sim_run --seed 7 --episodes 3 --quiet \
    | sed -n 's/.*hash \([0-9a-f]*\).*/\1/p'
}
h1="$(sim_hash)"
h2="$(sim_hash)"
if [ -z "$h1" ] || [ "$h1" != "$h2" ]; then
  echo "sim determinism gate FAILED: '$h1' != '$h2'" >&2
  exit 1
fi
echo "same-seed campaign hash reproduced: $h1"

echo "== flight-recorder capture gate =="
# Fleet tracing + flight recorder: a planted safety breach
# (thresholds below the quorum-intersection bound + a split vote) must
# fail invariants AND the failure artifact must carry its black box —
# one flight-recorder dump per node with events, plus the stitched
# cross-node timeline of the offending tx with straggler attribution.
python - <<'EOF'
from at2_node_tpu_torch.sim.campaign import planted_breach_episode

r = planted_breach_episode(20260805)
assert r.violations, "planted breach must violate invariants"
obs = r.obs
assert obs is not None, "failing episode must attach obs artifact"
recs = obs["recorders"]
assert len(recs) == 4, f"want 4 recorder dumps, got {len(recs)}"
for dump in recs:
    assert dump["recorder"]["events"], (
        f"node {dump['node']}: empty flight-recorder ring"
    )
offending = [tx for tx in obs["stitched"]["txs"] if tx["seq"] == 1]
assert offending, "stitched timeline must contain the offending tx"
assert offending[0]["nodes"] >= 2, "timeline must span multiple nodes"
assert offending[0]["stragglers"], "straggler attribution missing"
print(
    "breach artifact ok: 4 recorder dumps, offending tx stitched across"
    f" {offending[0]['nodes']} nodes"
)
EOF

echo "== sim invariant campaign (50 episodes) =="
# Seeded adversarial campaign on the simulated fabric: 50 episodes of
# the real 4-node f=1 stack under loss, partitions, equivocation, and
# hostile frames — every AT2 invariant (agreement, sieve consistency,
# totality, conservation) checked per episode. Exit nonzero on any
# violation; the printed episode seed is the exact replay recipe.
python -m at2_node_tpu_torch.tools.sim_run --seed 1 --episodes 50 --quiet

echo "== broker roundtrip smoke gate =="
# Broker ingress tier: codec roundtrip + native parity, the
# distilled ingress path on the sim fabric (commit/dedup/miss), and a
# real-gRPC broker roundtrip (register + collect + distill + commit +
# directory gossip). Named explicitly so a marker/collection change can
# never drop the broker path from CI.
python -m pytest tests/test_torch_distill.py -q -m "not slow"

echo "== byzantine-broker campaign =="
# Corrupting-collector campaign: distilled-frame ingress with
# broker mutations (dup / reorder / garbage / withhold / reseq — the
# last replays a captured signature at a shifted sequence) applied AFTER
# client signing, full AT2 invariant sweep PLUS a forged-commit sweep
# (every committed slot re-verified against its client signature) per
# episode. Run twice: the campaign hash must reproduce byte-identically,
# same contract as the base determinism gate above.
broker_hash() {
  python -m at2_node_tpu_torch.tools.sim_run --seed 11 --episodes 5 --broker \
    --quiet | sed -n 's/.*hash \([0-9a-f]*\).*/\1/p'
}
b1="$(broker_hash)"
b2="$(broker_hash)"
if [ -z "$b1" ] || [ "$b1" != "$b2" ]; then
  echo "byzantine-broker gate FAILED: '$b1' != '$b2'" >&2
  exit 1
fi
echo "same-seed broker campaign hash reproduced: $b1"

echo "== restart-determinism gate =="
# Durable sharded ledger: kill/restart cycles under load, on
# real per-node sharded stores (segments + WAL + manifest), with
# mid-catchup partitions, stale-checkpoint restarts, and membership
# reconfigs in the schedule. Every episode runs the full AT2 invariant
# sweep PLUS the no-post-restart-equivocation check (a rebooted node
# must never re-sign a pre-crash slot with different content). Run
# twice: the same seed must reproduce the same campaign hash even
# through crash/restart cycles — recovery is deterministic too.
restart_hash() {
  python -m at2_node_tpu_torch.tools.sim_run --seed 13 --episodes 4 \
    --durability --quiet | sed -n 's/.*hash \([0-9a-f]*\).*/\1/p'
}
r1="$(restart_hash)"
r2="$(restart_hash)"
if [ -z "$r1" ] || [ "$r1" != "$r2" ]; then
  echo "restart-determinism gate FAILED: '$r1' != '$r2'" >&2
  exit 1
fi
echo "same-seed restart campaign hash reproduced: $r1"

echo "== amortized-verification gate =="
# Amortized (RLC) verification: first the verdict-agreement
# suite — RLC verdicts must equal per-sig on every adversarial input
# class (small-order / mixed-torsion R and A included), bisection must
# isolate culprits in the expected check counts, and the router policy
# gates must hold. Then the batch-poisoning campaign — a byzantine
# client salts bad signatures into bulk flushes while the shared
# verifier runs amortized — run twice: invariants add bounded
# amortization loss + router convergence for the salting source, and
# the campaign hash must reproduce byte-identically (RLC's random
# coefficients affect internal check counts, never verdicts, so the
# wire trace is deterministic).
# The port twins tests/test_rlc_verify.py in three files: the host
# engine, bisection and router (test_torch_rlc.py), the verifier's RLC
# route (test_torch_verifier.py) and the device route's verdicts
# (test_torch_aggregate.py).
python -m pytest tests/test_torch_rlc.py \
    tests/test_torch_verifier.py::test_rlc_flushes_give_exact_verdicts_and_count_fallbacks \
    tests/test_torch_verifier.py::test_cancelled_verify_many_mid_rlc_releases_capacity \
    tests/test_torch_verifier.py::test_auto_without_rlc_min_batch_never_routes_rlc \
    tests/test_torch_verifier.py::test_rlc_warmup_checks_both_routes \
    tests/test_torch_aggregate.py::test_rlc_verify_batch_and_aggregate_verify_match_the_reference \
    tests/test_torch_aggregate.py::test_rlc_verify_batch_resolves_from_codes_without_the_exact_pass \
    -q -m "not slow"
salting_hash() {
  python -m at2_node_tpu_torch.tools.sim_run --seed 7 --episodes 3 --salting \
    --quiet | sed -n 's/.*hash \([0-9a-f]*\).*/\1/p'
}
s1="$(salting_hash)"
s2="$(salting_hash)"
if [ -z "$s1" ] || [ "$s1" != "$s2" ]; then
  echo "amortized-verification gate FAILED: '$s1' != '$s2'" >&2
  exit 1
fi
echo "same-seed salting campaign hash reproduced: $s1"

echo "== scenario-grid smoke gate =="
# Fleet SLO engine + scenario grid: the 2x2 smoke slice
# (lan/wan3 x steady/flash_crowd) must commit every offered transfer,
# pass every per-cell SLO verdict (exit 0), and reproduce its grid hash
# (sha256 over per-cell trace hashes) byte-identically run to run —
# same contract as the campaign determinism gates above.
grid_hash() {
  python -m at2_node_tpu_torch.tools.scenario_grid --seed 7 --smoke \
    --txs 24 --duration 8 --quiet | sed -n 's/.*hash \([0-9a-f]*\).*/\1/p'
}
g1="$(grid_hash)"
g2="$(grid_hash)"
if [ -z "$g1" ] || [ "$g1" != "$g2" ]; then
  echo "scenario-grid gate FAILED: '$g1' != '$g2'" >&2
  exit 1
fi
echo "same-seed scenario grid hash reproduced: $g1"

echo "== wan-finality gate =="
# Sub-second WAN finality: replay the [wan]-knobs-on wan3
# steady and cut cells twice each. Each cell must reproduce its trace
# hash byte-identically (the overlap levers are deterministic), and the
# steady cell must clear the sub-second SLO bar: commit p99 < 1000 ms
# with every offered transfer committed.
wan_cell() {  # $1 = FAULTS
  python -m at2_node_tpu_torch.tools.scenario_grid --seed 7 \
    --replay "wan3/steady/$1+wan" --txs 24 --duration 8 --json
}
wan_steady_json=""
for wfaults in none cut; do
  wj1="$(wan_cell "$wfaults")"
  wj2="$(wan_cell "$wfaults")"
  wh1="$(printf '%s' "$wj1" | python -c 'import json,sys; print(json.load(sys.stdin)["trace_hash"])')"
  wh2="$(printf '%s' "$wj2" | python -c 'import json,sys; print(json.load(sys.stdin)["trace_hash"])')"
  if [ -z "$wh1" ] || [ "$wh1" != "$wh2" ]; then
    echo "wan-finality gate FAILED: wan3/steady/$wfaults+wan hash '$wh1' != '$wh2'" >&2
    exit 1
  fi
  echo "wan3/steady/$wfaults+wan hash reproduced: $wh1"
  [ "$wfaults" = none ] && wan_steady_json="$wj1"
done
# the cell JSON rides an env var: the heredoc IS python's stdin here,
# so piping the JSON in as well would race the program text
WAN_STEADY_CELL="$wan_steady_json" python - <<'EOF'
import json, os
cell = json.loads(os.environ["WAN_STEADY_CELL"])
p99 = cell["latency_p99_ms"]
assert cell["committed"] == cell["offered"], (
    f"wan steady cell lost transfers: {cell['committed']}/{cell['offered']}")
assert not cell["violations"], cell["violations"]
assert cell["slo"]["ok"], f"SLO breach: {cell['slo']['breaching']}"
assert p99 < 1000.0, f"sub-second WAN finality missed: p99 {p99} ms"
print(f"wan3 steady +wan: p99 {p99} ms < 1000 ms, SLO ok")
EOF

echo "== overload-control gate =="
# Closed-loop overload control, three contracts:
#  1. the A/B claim at smoke scale on the scaled flash crowd, against a
#     finite modeled verifier pool: [overload] off must BREACH the
#     steady-tier client-perceived p99 SLO (the collapse baseline),
#     [overload] on must HOLD it while keeping Jain fairness for the
#     steady (pre-registered) senders at 1.0 >= the 0.8 floor — the
#     tool exits nonzero unless both arms hold their side;
#  2. determinism: the same seed must reproduce the same ab_hash
#     (sha256 over per-cell wire-trace hashes), byte-identical;
#  3. off-identity: a config carrying an all-defaults (disabled)
#     [overload] table must produce a wire trace byte-identical to one
#     with no table at all — same bar as the [wan] knobs.
overload_ab() {
  python -m at2_node_tpu_torch.tools.overload_ab --seed 5 --clients 60 \
    --crowd 40 --txs 80 --workload flash_crowd --quiet
}
v1="$(overload_ab)" || { echo "overload A/B claim FAILED: $v1" >&2; exit 1; }
v2="$(overload_ab)" || { echo "overload A/B claim FAILED: $v2" >&2; exit 1; }
vh1="$(printf '%s' "$v1" | sed -n 's/.*hash \([0-9a-f]*\).*/\1/p')"
vh2="$(printf '%s' "$v2" | sed -n 's/.*hash \([0-9a-f]*\).*/\1/p')"
if [ -z "$vh1" ] || [ "$vh1" != "$vh2" ]; then
  echo "overload-control gate FAILED: ab_hash '$vh1' != '$vh2'" >&2
  exit 1
fi
echo "same-seed overload A/B hash reproduced: $vh1"
python - <<'EOF'
from at2_node_tpu_torch.node.config import OverloadConfig
from at2_node_tpu_torch.sim.scenarios import run_cell

kw = dict(n_tx=24, duration=8.0)
plain = run_cell(7, "lan", "steady", "none", **kw)
tabled = run_cell(7, "lan", "steady", "none", overload=OverloadConfig(), **kw)
assert plain["trace_hash"] == tabled["trace_hash"], (
    f"[overload]-off not byte-identical: {plain['trace_hash'][:12]} != "
    f"{tabled['trace_hash'][:12]}"
)
print("all-knobs-off [overload] table is wire-invisible:",
      plain["trace_hash"][:16])
EOF

echo "== fleet-audit gate =="
# Fleet consistency auditor + capture/replay bridge, three
# contracts:
#  1. a planted single-node ledger corruption (consistent across the
#     culprit's own WAL/ring/digest, so only cross-node beacon compare
#     can see it) must be DETECTED by both honest peers within two
#     beacon intervals and ATTRIBUTED to the culprit node and the
#     victim's account-range lane;
#  2. zero false positives: clean adversarial, sharded-plane, and
#     wan-levers episodes must all end with no latched divergence;
#  3. a wire capture taken from a real-socket fleet must replay through
#     the sim bridge to the same verdict hash twice.
python - <<'EOF'
from at2_node_tpu_torch.sim.campaign import planted_divergence_episode
from at2_node_tpu_torch.sim.net import sim_keypairs, sim_client

seed = 20260805
r = planted_divergence_episode(seed)
assert r.violations, "planted divergence must fail the invariant sweep"
culprit = sim_keypairs(seed, 0)[0].public.hex()
victim_lane = sim_client(seed, 1).public[0] >> 4
assert r.audit is not None
honest = r.audit[1:]
for a in honest:
    d = a["divergence"]
    assert d is not None, "honest node failed to latch the divergence"
    assert d["peer"] == culprit, f"wrong attribution: {d['peer'][:12]}"
    assert victim_lane in d["ranges"], (victim_lane, d["ranges"])
    assert d["detected_commits"] - 6 <= 16, d  # two beacon intervals of 8
print("planted divergence: attributed to node 0, lane", victim_lane,
      "at commit", honest[0]["divergence"]["detected_commits"])
EOF
python - <<'EOF'
from at2_node_tpu_torch.node.config import ObservabilityConfig, WanConfig
from at2_node_tpu_torch.sim.campaign import run_episode

obs = {"observability": ObservabilityConfig(audit_every=8)}
cells = {
    "adversarial": dict(config_overrides=dict(obs)),
    "sharded": dict(config_overrides={**obs, "plane_shards": 4}),
    "wan": dict(config_overrides={
        **obs, "wan": WanConfig(overlap_ready=True, region_fanout=True)}),
}
for name, kw in cells.items():
    r = run_episode(11, n_events=12, duration=8.0, settle_horizon=60.0, **kw)
    assert not r.violations, (name, r.violations)
    for a in r.audit:
        assert a["divergence"] is None, (name, a["divergence"])
        assert a["counters"]["diverged"] == 0, (name, a["counters"])
    print(f"clean {name} episode: zero false positives "
          f"({sum(a['counters']['compared'] for a in r.audit)} compares)")
EOF
python - <<'EOF'
import asyncio, time
from at2_node_tpu_torch.broadcast.messages import Payload
from at2_node_tpu_torch.crypto.keys import SignKeyPair
from at2_node_tpu_torch.node.config import VerifierConfig
from at2_node_tpu_torch.node.service import Service
from at2_node_tpu_torch.tools._common import make_net_configs, port_counter
from at2_node_tpu_torch.tools.capture_replay import replay_capture, verdict_hash
from at2_node_tpu_torch.types import ThinTransaction

async def capture():
    # the host verifier, asked for: the port's default kind is the card's
    cfgs = make_net_configs(3, port_counter(28400),
                            verifier=VerifierConfig(kind="cpu"))
    services = []
    try:
        for c in cfgs:
            services.append(await Service.start(c))
        sender = SignKeyPair.from_hex("66" * 32)
        recipient = SignKeyPair.from_hex("67" * 32).public
        for seq in range(1, 25):
            await services[0].broadcast.broadcast(
                Payload.create(sender, seq, ThinTransaction(recipient, 1)))
        t0 = time.monotonic()
        while any(s.committed < 24 for s in services):
            await asyncio.sleep(0.02)
            assert time.monotonic() - t0 < 120, "fleet did not commit"
        for s in services:
            s._emit_beacon()
        await asyncio.sleep(0.3)
        return services[1].mesh.capture_dump()
    finally:
        for s in services:
            await s.close()

doc = asyncio.run(capture())
assert doc["records"], "capture ring stayed empty"
v1 = replay_capture(doc, 5)
v2 = replay_capture(doc, 5)
h1, h2 = verdict_hash(v1), verdict_hash(v2)
assert h1 == h2, (h1, h2)
assert not v1["violations"], v1["violations"]
print(f"capture of {len(doc['records'])} frames replayed to verdict "
      f"{h1[:16]} twice")
EOF

echo "== observability overhead gate =="
# The full observability tier's cost — tracer, recorder, SLO probes,
# phase accounting, lag probe, sampler, audit beacons, and the inbound
# wire-capture ring — measured as plane throughput with the tier on vs
# off (interleaved arms, best-of-N per arm to shed scheduler noise),
# must stay under the 5% budget. Exit nonzero when the obs-on arm
# regresses past --budget.
python -m at2_node_tpu_torch.tools.plane_bench --compare-obs --nodes 3 \
    --txs 200 --repeat 2 --verifier cpu --out /dev/null

echo "== profiler smoke gate =="
# Continuous profiler: one short batched firehose with the
# stack sampler live. Fails unless the capture produced folded stacks
# and every exercisable phase counter (plane leaves + plane_total +
# commit_tail + slot_gc) actually ticked — a silent 0 means a marker
# got dropped from a hot path.
python -m at2_node_tpu_torch.tools.plane_bench --smoke-profile --nodes 3 \
    --txs 200 --verifier cpu --out /dev/null
# Cross-process observability: the same smoke through the
# process executor. Worker processes ship their own phase marks,
# recorder events, and folded stacks over per-shard obs rings; the
# smoke fails unless the merged folded output carries shardN/ frames
# AND every plane leaf phase ticked in at least one worker shard — a
# silent 0 means a worker-side mark (or the shipping lane itself)
# broke. Needs a real second core for the worker process, same policy
# as the scaling smokes.
if [ "$(nproc)" -ge 2 ]; then
  python -m at2_node_tpu_torch.tools.plane_bench --smoke-profile --nodes 3 \
      --txs 200 --shards 2 --executor process --verifier cpu --out /dev/null
else
  echo "single-core host: skipping the process-mode profiler smoke"
fi

echo "== sharded-plane gate =="
# Sharded broadcast plane: the invariance suite first (named
# explicitly so a marker/collection change can never drop it), then the
# shard-determinism contract straight from the episode driver — the
# same seed must produce ONE campaign hash whether the plane runs
# monolithic or split across 4 shards, and reproduce it run to run.
python -m pytest tests/test_torch_plane_shards.py -q
python - <<'EOF'
from at2_node_tpu_torch.sim.campaign import run_episode

kw = dict(n_events=10, duration=8.0, settle_horizon=60.0)
mono = run_episode(21, **kw)
s4a = run_episode(21, config_overrides={"plane_shards": 4}, **kw)
s4b = run_episode(21, config_overrides={"plane_shards": 4}, **kw)
assert s4a.trace_hash == s4b.trace_hash, "shards=4 not self-deterministic"
assert mono.trace_hash == s4a.trace_hash, (
    f"shard count observable on the wire: {mono.trace_hash[:12]} != "
    f"{s4a.trace_hash[:12]}"
)
print("shard-invariant campaign hash:", mono.trace_hash[:16])
EOF
# 2-core scaling smoke: threaded shards must buy >= 1.5x plane
# throughput over the monolithic loop when there are real cores to
# spread across. A 1-core host cannot measure scaling — skip (the
# banked BENCH_PLANE_SHARDS.json grid is the tracked artifact there).
if [ "$(nproc)" -ge 2 ]; then
  python -m at2_node_tpu_torch.tools.plane_bench --shards-grid 1,2 --cores 2 \
      --nodes 3 --txs 300 --grid-repeat 2 --no-bank --verifier cpu \
      --out "$work/plane_shards_smoke.json"
  python - <<'EOF'
import json
import os

doc = json.load(open(os.path.join(os.environ["CI_TORCH_WORK"], "plane_shards_smoke.json")))
speedup = doc["summary"]["peak_speedup_vs_1"]
assert speedup >= 1.5, (
    f"sharded plane speedup {speedup}x < 1.5x on 2 cores"
)
print(f"sharded plane 2-core speedup: {speedup}x")
EOF
else
  echo "single-core host: skipping the 2-core scaling smoke"
fi

echo "== multiprocess-plane gate =="
# Process executor: one spawn worker per shard over
# shared-memory rings. The determinism half ALWAYS runs: the same seed
# must produce ONE campaign hash whether [plane] executor says inline,
# thread, or process — the sim clock forces inline placement, and this
# sweep pins that seam so a config-dependent code path can never leak
# into the wire schedule.
python - <<'EOF'
from at2_node_tpu_torch.sim.campaign import run_episode

kw = dict(n_events=8, duration=6.0, settle_horizon=45.0)
for seed in (0, 7):
    hashes = {}
    for shards, ex in ((1, "inline"), (4, "inline"), (4, "thread"),
                       (4, "process")):
        over = (
            {"plane_shards": shards, "plane_executor": ex}
            if shards > 1 else {}
        )
        ep = run_episode(seed, config_overrides=over, **kw)
        assert ep.violations == [], (seed, shards, ex, ep.violations)
        hashes[(shards, ex)] = ep.trace_hash
    assert len(set(hashes.values())) == 1, (
        f"executor observable on the wire at seed {seed}: "
        + ", ".join(f"{k}={v[:12]}" for k, v in hashes.items())
    )
    print(f"seed {seed}: executor-invariant campaign hash "
          f"{next(iter(hashes.values()))[:16]}")
EOF
# 2-core scaling smoke: process-mode shards must buy >= 1.5x plane
# throughput over the monolithic loop when there are real cores to
# spread across (this is the whole point of breaking the GIL). A
# 1-core host cannot measure scaling — skip, same policy as the
# thread-mode smoke above.
if [ "$(nproc)" -ge 2 ]; then
  python -m at2_node_tpu_torch.tools.plane_bench --shards-grid 1,2 --cores 2 \
      --executor process --nodes 3 --txs 300 --grid-repeat 2 --no-bank \
      --verifier cpu --out "$work/plane_process_smoke.json"
  python - <<'EOF'
import json
import os

doc = json.load(open(os.path.join(os.environ["CI_TORCH_WORK"], "plane_process_smoke.json")))
speedup = doc["summary"]["peak_speedup_vs_1"]
assert speedup >= 1.5, (
    f"process-mode plane speedup {speedup}x < 1.5x on 2 cores"
)
print(f"process plane 2-core speedup: {speedup}x")
EOF
else
  echo "single-core host: skipping the process-mode scaling smoke"
fi

echo "== finality gate =="
# Succinct finality certificates + stateless light client,
# three contracts:
#  1. the planted equivocation campaign — a compromised fleet member
#     co-signs two conflicting digests for the same (epoch, watermark)
#     coordinate, plus stale-epoch and forged-signature floods — must
#     end with ZERO invariant violations, every honest node latching
#     the equivocation with the culprit attributed by public key, and
#     the campaign trace hash reproduced byte-identically run to run;
#  2. a live simulated fleet's certificate chain must verify through
#     the stateless light client (f+1 co-signer threshold) on every
#     node, and the strict full-quorum verifier must reject byte-level
#     mutants (digest flip, bitmap flip, truncated signature blob);
#  3. off-identity: an all-defaults (disabled) [finality] table must
#     produce a wire trace byte-identical to no table at all — same
#     bar as the [wan] and [overload] knobs.
python -m pytest tests/test_torch_finality.py -q -m "not slow"
python - <<'EOF'
from at2_node_tpu_torch.sim.campaign import planted_cert_equivocation_episode
from at2_node_tpu_torch.sim.net import sim_keypairs

seed = 20260807
r1 = planted_cert_equivocation_episode(seed)
r2 = planted_cert_equivocation_episode(seed)
assert r1.trace_hash == r2.trace_hash, (r1.trace_hash, r2.trace_hash)
assert not r1.violations, r1.violations
culprit = sim_keypairs(seed, 4)[0].public.hex()
assert r1.audit is not None
for a in r1.audit:
    fin = a["finality"]
    assert fin is not None and fin["chain_len"] > 0, fin
    eq = fin.get("equivocation")
    assert eq is not None, "equivocation not latched"
    assert eq["origin"] == culprit, eq["origin"][:16]
    assert fin["epoch_skew"] > 0 and fin["bad_sig"] > 0, fin
print("planted equivocation: latched on every node, attributed to",
      culprit[:16] + ", hash", r1.trace_hash[:16])
EOF
python - <<'EOF'
import dataclasses

from at2_node_tpu_torch.finality import LightVerifier, verify_chain
from at2_node_tpu_torch.node.config import FinalityConfig, ObservabilityConfig
from at2_node_tpu_torch.sim.net import SimNet, sim_client, sim_keypairs

seed, nodes = 7, 4
net = SimNet(
    nodes, 1, seed,
    finality=FinalityConfig(enabled=True),
    observability=ObservabilityConfig(audit_every=8),
).start()
try:
    client = sim_client(seed, 0)
    recipient = sim_client(seed, 1).public
    for k in range(24):
        net.submit(k % nodes, client, k + 1, recipient, 1)
    net.settle(horizon=60.0)
    for svc in net.services:
        svc._emit_beacon()
    net.settle(horizon=10.0)
    keys = [sim_keypairs(seed, i)[0].public for i in range(nodes)]
    light = LightVerifier(keys, total=nodes)  # f+1 co-signer threshold
    full = LightVerifier([], members=keys)  # strict: every bitmap bit
    total = 0
    for svc in net.services:
        chain = list(svc.certs.chain)
        assert chain, svc.certs.status()
        assert verify_chain(chain, light)["ok"]
        assert verify_chain(chain, full)["ok"]
        total += len(chain)
    cert = list(net.services[0].certs.chain)[-1]
    mutants = [
        dataclasses.replace(cert, ranges=bytes(x ^ 0xFF
                                               for x in cert.ranges)),
        dataclasses.replace(
            cert, bitmap=bytes([cert.bitmap[0] ^ 0x0F]) + cert.bitmap[1:]
        ),
        dataclasses.replace(cert, sigs=cert.sigs[:-64]),
    ]
    for i, bad in enumerate(mutants):
        assert not full.verify(bad)["ok"], f"mutant {i} accepted"
    assert not net.check_invariants()
finally:
    net.close()
print(f"light client verified {total} live-fleet certificates; "
      "all mutants rejected")
EOF
python - <<'EOF'
from at2_node_tpu_torch.node.config import FinalityConfig
from at2_node_tpu_torch.sim.campaign import run_episode

kw = dict(n_events=10, duration=8.0, settle_horizon=60.0)
plain = run_episode(13, **kw)
tabled = run_episode(
    13, config_overrides={"finality": FinalityConfig()}, **kw
)
assert plain.trace_hash == tabled.trace_hash, (
    f"[finality]-off not byte-identical: {plain.trace_hash[:12]} != "
    f"{tabled.trace_hash[:12]}"
)
print("all-knobs-off [finality] table is wire-invisible:",
      plain.trace_hash[:16])
EOF

echo "== bench-regression sentry gate =="
# regress.py diffs every banked BENCH_*/SCALE_*/MULTICHIP_* artifact
# against its nearest COMPARABLE capture (tunnel/device state must
# match) and exits 1 on a beyond-band drop, 2 on a schema violation.
# Determinism contract: two runs over the same artifacts are
# byte-identical. The port's bank is its tools' OUT_DIR, the git-ignored
# at2_node_tpu_torch/build/bench (the repo root's artifacts are the TPU's
# record). On a fresh checkout it holds what this run banked (the
# obs-overhead gate's row), so there the gate checks that bank's schema
# and determinism; a drop is judged only against rows that earlier runs
# in the same checkout banked.
bank=at2_node_tpu_torch/build/bench
python -m at2_node_tpu_torch.tools.regress --dir "$bank" > "$work/regress1.txt"
python -m at2_node_tpu_torch.tools.regress --dir "$bank" > "$work/regress2.txt"
cmp "$work/regress1.txt" "$work/regress2.txt" || {
  echo "regression sentry output not deterministic" >&2; exit 1;
}
cat "$work/regress1.txt"

if [ "$tier" = "all" ]; then
  echo "== native sanitizers (TSAN + ASAN) =="
  # the reference gets race-freedom from Rust; the C++ prep library gets
  # it from disjoint output ranges, proven under TSAN here (SURVEY §5);
  # the binaries go to the port's git-ignored build directory
  (
    cd at2_node_tpu_torch/native
    mkdir -p ../build
    g++ -std=c++17 -O1 -g -fsanitize=thread at2_prep.cpp sanitize_test.cpp \
        -o ../build/sanitize_tsan -lpthread && ../build/sanitize_tsan
    g++ -std=c++17 -O1 -g -fsanitize=address at2_prep.cpp sanitize_test.cpp \
        -o ../build/sanitize_asan -lpthread && ../build/sanitize_asan
    g++ -std=c++17 -O1 -g -fsanitize=thread at2_ingest.cpp \
        sanitize_ingest_test.cpp -o ../build/sanitize_ingest_tsan \
        -lpthread -l:libcrypto.so.3 && ../build/sanitize_ingest_tsan
    g++ -std=c++17 -O1 -g -fsanitize=address at2_ingest.cpp \
        sanitize_ingest_test.cpp -o ../build/sanitize_ingest_asan \
        -lpthread -l:libcrypto.so.3 && ../build/sanitize_ingest_asan
  )

  echo "== kernel tier (slow) =="
  python -m pytest tests/test_torch_*.py -q -m "slow"
fi

echo "CI green (at2_node_tpu_torch)."

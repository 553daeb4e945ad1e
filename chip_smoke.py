#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises, the exit code is non-zero and no result line
is printed):

1. Device report: torch, CUDA, the card's name and power limit.
2. Build: the CUDA verify kernel and the two RLC kernels (nvcc, sm_90a,
   always rebuilt), the native host prep and the native message-plane
   ingest (g++), all from the sources in this checkout, built side by
   side; each kernel's registers, stack frame and spill bytes (the RLC
   lanes kernel's for each layout's instantiation) are read from ptxas's
   report.
3. Kernel vs plain: about 1,000 signed transfers plus the RFC 8032 TEST 1
   vector and eight tamper classes, tiled into batches of every bucket the
   main path launches (65,536, 8,192, 4,096, 1,024, 256 and 64 lanes), a
   ragged 1,000 and a 77 (a partial last bitmask byte). On every batch the
   kernel's bitmask must equal the plain PyTorch version's bitmask,
   computed on the card, and the expected verdicts: 0 mismatches. Both are
   timed with CUDA events.
3b. RLC kernels vs plain: at the same shapes, and at the most lanes one
   wave of the split layout holds and one block more (the crossover of
   ``cuda_rlc.choose_layout``), three batches each of phase 3's valid
   lanes with ~2% of every class that stays out of the equation (high S,
   bad lengths, padding, an R with an 8-torsion component: code 0), then
   also of every rerouted class (a non-canonical or x = 0 key, a key with
   an 8-torsion component: code 2), then also one tampered lane. On every
   batch ``rlc_packed`` and each layout of the lanes kernel launched apart
   (whole and split), each followed by the fold: the codes and eq_ok must
   equal the plain version's on the card and the expected ones (eq_ok
   True without the tampered lane, False with it); the fold must equal
   the plain fold on the lanes kernel's own partial points, and, on
   partial points that do not vanish, the known answer; the composed
   verdicts (the codes where eq_ok holds and no lane has code 2, else the
   verify kernel) must equal the verify kernel's bitmask and the expected
   verdicts. Each layout, the fold (and the one-block fold it replaced),
   the verify kernel on the same rows and the plain version are timed
   with CUDA events.
3c. The certificate (BASELINE config 4, n = 64): ``aggregate_verify`` on
   the card on a clean certificate and on one with a tampered
   attestation must equal the verify kernel's all-valid verdict, and
   ``verify_certificate`` the verify kernel's verdicts; both timed.
4. Main path, twice, 16 concurrent callers ``verify_many`` 70,000 items
   through ``make_verifier("cuda")`` after ``warmup()``:
   - stress: the node's default verifier table with the bucket ladder and
     a queue bound raised so the backlog coalesces into the 65,536 bucket;
     every verified transfer is then committed through
     ``Accounts.transfer`` and checked against a python-int replay;
   - node default: what a node's ``[verifier]`` table gives, one 256-lane
     bucket and a queue bound of 4,096.
   Every verdict is checked, the kernel's launch count (set to 0 just
   before each run) must rise, and every shape a run launched must be one
   that phase 3 checked.
5. The broadcast plane, twice: four port nodes in this process, each with
   its own mesh over encrypted TCP on 127.0.0.1, ``Broadcast`` (16
   workers, thresholds of all 3 peers), ``make_verifier("cuda")`` at the
   node's default [verifier] table and ``Accounts``; 16 seeded clients,
   client c submitting to node c mod 4, about 2% of the slots with a
   tampered twin. Run A, the batched plane (the node default: slots of at
   most 256 entries, a 5 ms window), 1,024 transfers per client; run B,
   the per-transaction plane, 64 per client. Each node commits what it
   delivers, retrying a transfer until its predecessor has committed.
   Checks: every valid transfer commits on all four nodes, the ledgers
   equal each other and the python-int replay, no tampered twin commits,
   every verifier is on the card, dispatched batches and flushed only
   256-lane buckets, the kernel's launch count (set to 0 just before each
   run) equals the flushes, and ``invalid_sig`` counts the tampered twins.
   The four nodes share one process and one GIL: the rate is a floor.
6. The node service, twice: four ``server run`` processes, configured
   by ``server config new`` and ``config get-node`` with ``[verifier]
   kind = "cuda"`` at the node default table, each in its own process on
   the card (the kernel built in phase 2 is loaded, not rebuilt); 16
   seeded clients, client c talking to node c mod 4 over gRPC through
   the port's ``Client``. Run A: ``send_asset_many`` (SendAssetBatch),
   1,024 transfers per client; run B: unary ``send_asset``, 64 per
   client, with 16 tampered twins sent first. A run's window ends when
   every node's committed count (one /healthz GET per node every 25 ms)
   has grown by the run's transfers; every client's ``GetLastSequence``
   on every node is checked once after it. Checks: every valid
   transfer commits on every node (``GetLastSequence`` and
   ``GetBalance`` of every account equal the python-int replay), every
   tampered twin is refused with INVALID_ARGUMENT, each node's
   ``/metrics`` shows ``audit_divergence`` 0 and ``rejected_at_ingress``
   equal to the twins refused there, each verifier dispatched batches
   and launched the kernel once per batch (the process's launch count in
   the ``/statusz`` build block, read before and after each run; a
   ``server run`` process holds one verifier), each build block
   names the card, and every server exits 0 on SIGTERM.
7. The node service on the RLC route: phase 6's net with ``[verifier]
   mode = "rlc"`` (every other key at its default); run B sends 16
   transfers a client. Phase 6's checks, and on each node over each run:
   every batch went through RLC, the RLC kernels launched once a batch,
   the verify kernel once a fallback, and a node that refused a twin fell
   back at least once.
8. BASELINE config 5, the device pool (``parallel/pool.py``), on one card:
   8a. phase 3's batches at every shape, with tampered lanes on both sides
       of every shard seam, through pools of 1, 2 and 4 shards on cuda:0
       (each shard on its own streams): the pool's verdicts and bitmask
       must equal the verify kernel's, the plain version's on the card and
       the expected ones, and ``verify_and_count``'s count their popcount;
       the whole pool launch (uploads, kernels, copies back) is timed with
       CUDA events at 4,096 and 65,536 lanes beside the kernel alone.
   8b. the 1M replay (``tools/scale_demo.py::_phase_replay``): 1,048,576
       signatures through ``verify_batch_sharded`` on the pool of 1, in
       4,096-lane buckets; every one must verify.
   8c. 32 nodes share one pool (``_phase_net``): ``[verifier] kind =
       "pool"``, batch_size 4,096, max_delay 10 ms; 32 in-process nodes,
       thresholds 21 (2f + 1, f = 10), 32 clients x 4 transfers through
       ``tools/loadgen.py``; every transfer must commit on every node,
       every ledger equal the python-int replay, and the kernel launch once
       a shard a batch. The open-file limit is raised to its hard limit
       first (the net holds ~2,000 sockets), and the phase fails below it.
   8d. the entry (``entry.entry()``'s function on its example arguments)
       and ``dryrun_multichip(4, devices=["cuda:0"] * 4)``.
9. The sharded broadcast plane and the durable store (BASELINE config 3,
   run right after phase 6): phase 6's net and run A's traffic (the same
   seed) with ``[plane] shards = 2`` and ``[store] dir`` (a directory a
   node, ``flush_interval = 1.0``), the reference's rings (4,096 slots of
   1 KiB); ``df -B1 /dev/shm`` is printed first, and the phase fails if
   the rings do not fit its free space.
   9a. ``executor = "thread"``: the owner's bulk ``verify_many`` sends
       admission's and the plane's signatures to the kernel.
   9b. ``executor = "process"``: each shard a spawn worker that verifies
       its plane signatures on the host, as in the reference; only
       admission's reach the kernel. Each server has its two workers, no
       worker maps libcuda or libtorch (every server maps libcuda), and
       ``nvidia-smi --query-compute-apps=pid`` lists none of them.
   Each of 9a and 9b: phase 6's checks of run A (the replay on every node,
   a kernel launch a batch, the card in the build block), the plane block
   (two shards, no crashed worker), ``plane_shard_effects_dropped`` 0,
   the store flushed, and committed tx/s printed beside phase 6's.
   9c. 9b's config at thresholds of two peers (f = 1) with a quarter of
       run A's traffic: the first half of it, but for its last 8
       transfers a client, goes to every node and into node 0's
       segments; those last transfers go to nodes 1-3, and node 0 is
       killed (SIGKILL) before its store's next flush, so what it
       committed of them lies in its WAL alone (which must hold records).
       Its shard workers must exit and its rings leave ``/dev/shm``. The
       second half goes to nodes 1-3, node 0 restarts from its TOML and
       store directory (its recovery states polled on ``/statusz`` until
       ``live``; the store is read before the RPC port binds, so the
       recovery block counts the segments loaded and the WAL records
       replayed, which must be all its WAL held), one more transfer a
       client goes to every node, and every node, node 0 included, must
       equal the python-int replay. The verify kernel's launches are
       counted from a snapshot after each node's warm-up (node 0's after
       its restart went live): a launch a batch, at least one a node.
   Every server of every run exits 0 on SIGTERM and leaves no ring in
   ``/dev/shm``.
10. Finality certificates and the broker ingress tier (BASELINE config 3,
   run right after phase 9): phase 6's net with ``[finality] enabled =
   true`` (``audit_every`` at its default, 256).
   10a. Run A (the same seed and size). Then, within 10 s,
       ``Client.wait_final`` through node 1 returns a certificate that
       an f+1 ``LightVerifier`` of the four sign keys (read from the
       TOMLs) accepts and that reaches the node's frontier; every node's
       ``/certz`` chain is polled until its newest certificate covers the
       node's commit frontier (the certificate lag is printed). Checks:
       phase 6's checks of run A; on every node a non-empty chain, its
       newest certificate at the node's committed count, the four newest
       certificates at the same commits with one preimage,
       ``verify_chain`` ok under the f+1 and the full light client and
       refused by the full one (and by one that needs every signer) once
       a co-signature byte is flipped, ``finality_equivocation`` 0.
   10b. ``tools/broker.py`` as a process in front of node 0
       (``--max-entries 1024``); ``tools/loadgen.py`` ``run_load(...,
       broker=True)`` with 16 seeded clients x 256 transfers through it,
       then 16 transfers with a flipped signature byte through the
       broker's gRPC surface. Checks: every node commits the 4,096 and
       equals the python-int replay, no tampered transfer commits, node
       0 refuses the 16 at ingress, took distilled batches and launched
       the verify kernel a batch (as every node did), the broker
       forwarded 4,096 + 16 entries and its ``/healthz`` says ``role =
       broker``, ``trace_collect.stitch`` over the four nodes' and the
       broker's ``/tracez`` joins transfers across the broker hop, the
       chains verify again, and ``tools/top.py --once`` over the nodes
       and the broker exits 0 with its ``final`` column. Every server
       exits 0 on SIGTERM, the broker 0 on SIGINT.
11. The deterministic simulator (``at2_node_tpu_torch/sim``, run after
   phase 8) through the port's five CLIs, each a subprocess started
   without PYTHONHASHSEED (the tools pin it), four at a time; every hash
   must equal the reference's in ``SIM_GATES``, printed by the JAX
   package's CLIs for the gates of its ``scripts/ci.sh``. The sim runs on
   the host CPU and launches no kernel.
   11a. The determinism, byzantine-broker, restart and salting campaigns,
       twice each (exit 0, no failing episode, the two hashes alike), the
       50-episode campaign once, and ``planted_breach_episode(20260805)``
       with scripts/ci.sh's artifact check (4 flight-recorder dumps, the
       offending transfer stitched across nodes with its stragglers).
   11b. The smoke grid twice and the full 18-cell grid at seed 1 once (no
       cell breaching its SLO; the full grid's hash is the one
       BENCH_SCENARIOS.json banks); both WAN replays with the [wan]
       levers twice each (every transfer committed, the reference's p99,
       the steady cell's under 1,000 ms); the overload A/B twice (the
       uncontrolled arm breaches its SLO, the controlled arm holds it).
   11c. Node 0's ``/capturez`` from the end of 10a (the last 512 inbound
       frames, signatures checked by the verify kernel) replayed into a
       fresh 4-node sim by ``capture_replay --repeat 2 --json``: one
       verdict hash both times, no invariant violation; the messages in
       the captured frames counted by kind, with a payload, an echo and a
       ready (per transfer or per batch) and a co-signature (kind 16)
       among them.
   11d. ``bench_finality`` at its defaults: the production block and the
       wire bytes equal the reference's; the light-client verify rate is
       printed as the host CPU's, beside the card's name and power limit.
   One ``{"sim": {...}}`` line gives the hashes, the seconds of each run
   and of the phase.
12. The measurement tools (``at2_node_tpu_torch/tools``, run after phase
   11), every row into a temporary directory:
   12a. ``verify_bench`` at its three buckets (65,536, 8,192, 1,024 lanes,
       3 trials): each bucket's kernel bitmask must equal the plain
       version's on the card and the expected verdicts (all valid).
   12b. ``aggregate_bench --cert-route`` at n = 64: the verify kernel's
       verdicts on a clean and a tampered certificate, and the RLC
       kernels' verdicts and eq_ok, which must equal phase 3c's; then the
       default host grid at ``--rounds 1``.
   12c. ``plane_bench`` with scripts/ci.sh's arguments, every node on the
       card's verifier: ``--compare-obs``, ``--smoke-profile`` (the loop,
       and 2 shards under the thread and the process executor; every
       phase counter must tick) and ``--shards-grid 1,2 --cores 2`` under
       each executor; the
       overhead and the speedup are printed beside the reference's 5%
       and 1.5x, not gated on.
   12d. ``e2e_bench``'s two arms at its defaults (16 clients x 50 unary
       transfers: four ``server run`` processes on the host verifier, and
       four in-process nodes sharing one ``CudaBatchVerifier``), then
       ``--compose``; every transfer must commit.
   12e. Four ``server run`` nodes with ``kind = "cuda"``: 16 clients send
       SendAssetBatch chunks while ``profile_collect --duration 5``
       profiles every node (its table printed a node); every transfer
       must commit and equal the replay; then ``incident --now`` as a
       subprocess, its bundle rebuilt twice from the files it wrote, with
       its hash.
   12f. ``bench_durability`` at its defaults (100,000 accounts, 64 shards),
       the restarted node on the card; its ``ok`` must hold.
   12g. ``regress --dir`` over the phase's rows (12a's and 12d's verify
       grids, at the same trials, are judged against each other): no
       schema error; a regression is printed, not gated on.
   One ``{"tool": ...}`` line a tool; the kernels line counts phase 12's
   launches with the earlier phases'.
13. One JSON line describing the kernels (their times and bound at every
   shape, every main-path run, the ptxas figures), then the result line
   ``{"ok": true, "device": {...}}``.

Runs only on a CUDA device and only from a checkout of the repository.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# Hopper H100 SXM published peaks: 3.35 TB/s of HBM3; 67 TFLOP/s float32
# outside the tensor cores is 132 SMs x 128 lanes x 2 x 1.98 GHz, and the
# SM issues 32-bit integer multiply-adds at half its float32 lane count
# (64 per clock), so 132 x 64 x 1.98e9 = 16.7e12 int32 multiply-adds/s.
H100_BYTES_PER_S = 3.35e12
H100_INT32_MULADD_PER_S = 132 * 64 * 1.98e9

# every bucket of the ladder the main path launches, a ragged batch (1,000)
# and a partial last bitmask byte (77)
KERNEL_LANES = (65536, 8192, 4096, 1024, 1000, 256, 64, 77)
MAIN_ITEMS = 70_000
MAIN_CALLERS = 16
CALLER_CHUNK = 1024
N_KEYS = 64
SEQS_PER_KEY = 16
TAMPER_SHARE = 0.02
TAMPER_CLASSES = (
    "r_flip", "s_flip", "msg_flip", "high_s", "noncanonical_y",
    "x0_sign", "wrong_len", "padding",
)

# phase 5: BASELINE config 3's net (4 nodes, 16 clients, batch_size=256)
NET_NODES = 4
NET_CLIENTS = 16
NET_PER_CLIENT_BATCHED = 1024
NET_PER_CLIENT_PER_TX = 64
NET_DEADLINE_S = 240.0
# phase 6: the same net as `server run` processes; run B's tampered twins
# stay far under the admission fail bucket (64 per 10 s per source)
NODE_TAMPERED = 16
# a run's window ends at the /healthz poll that sees the last node's
# committed count reach its target: one small GET per node per period
NODE_POLL_S = 0.025

# phase 3b: lane classes that stay out of the RLC equation (code 0) and
# that are rerouted to the exact check (code 2)
RLC_OUT = ("high_s", "wrong_len", "padding", "r_torsion")
RLC_REROUTE = ("noncanonical_y", "x0_sign", "a_torsion")
# phase 3c: BASELINE config 4, a quorum certificate of n = 64 attestations
CERT_N = 64
# phase 7: run B's unary transfers a client
NODE_RLC_PER_UNARY = 16
# phase 8: pool sizes on one card, the shapes its launch is timed at, the
# 1M replay, and the 32-node net of BASELINE config 5 (SCALE_r05's round-5
# shape: 32 clients x 4 transfers)
POOL_SHARDS = (1, 2, 4)
POOL_TIMED_LANES = (4096, 65536)
REPLAY_SIGNATURES = 1 << 20
REPLAY_BUCKET = 4096
SCALE_NODES = 32
SCALE_CLIENTS = 32
SCALE_PER_CLIENT = 4
SCALE_POOL_BATCH = 4096
SCALE_DEADLINE_S = 240.0

RFC8032_TEST1 = (
    "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
    "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
    "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e065224901555fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def log(*args) -> None:
    print(*args, flush=True)


# -- phase 1 ---------------------------------------------------------------


def device_report(torch) -> str:
    check(torch.cuda.is_available(), "no CUDA device: this script runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    return card


# -- phase 2 ---------------------------------------------------------------


# ptxas names: a kernel, or an instantiation of the RLC lanes template
# (its mangled name) by layout
PTXAS_ENTRIES = {
    "ed25519_verify_kernel": "ed25519_verify_kernel",
    "ed25519_rlc_lanes[whole]": "ed25519_rlc_lanesILi0E",
    "ed25519_rlc_lanes[split]": "ed25519_rlc_lanesILi1E",
    "ed25519_rlc_fold": "ed25519_rlc_fold",
}


def parse_ptxas(log_text: str, kernel: str) -> dict:
    """Registers, stack frame and spill bytes of `kernel`'s entry function
    (PTXAS_ENTRIES) from nvcc's ``-Xptxas -v`` output."""
    entry = next((m for m in re.finditer(r"Compiling entry function '([^']+)'", log_text)
                  if PTXAS_ENTRIES[kernel] in m.group(1)), None)
    check(entry is not None, f"no ptxas report for {kernel}")
    rest = log_text[entry.end():]
    regs = re.search(r"Used (\d+) registers", rest)
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", rest)
    check(regs is not None and frame is not None, f"ptxas report for {kernel} not understood")
    return {"registers": int(regs.group(1)), "stack_bytes": int(frame.group(1)),
            "spill_bytes": int(frame.group(2)), "spill_load_bytes": int(frame.group(3))}


def build_all() -> dict:
    """Every library, built side by side; the ptxas figures of each kernel
    by name."""
    from at2_node_tpu_torch.native import ingest, prep
    from at2_node_tpu_torch.native._build import BUILD_DIR
    from at2_node_tpu_torch.ops import cuda_rlc, cuda_verify

    # always build from the sources, so ptxas reports on what runs
    for mod in (cuda_verify, cuda_rlc):
        lib = os.path.join(BUILD_DIR, mod.LIB_NAME)
        if os.path.exists(lib):
            os.remove(lib)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=4) as pool:
        kern = pool.submit(timed, cuda_verify.build)
        rlc = pool.submit(timed, cuda_rlc.build)
        nat = pool.submit(timed, prep.native_available)
        ing = pool.submit(timed, ingest.ingest_available)
        _, kern_s = kern.result()
        _, rlc_s = rlc.result()
        native_ok, nat_s = nat.result()
        ingest_ok, ing_s = ing.result()
    log(f"build: verify kernel {kern_s:.1f} s, RLC kernels {rlc_s:.1f} s (nvcc sm_90a), native prep "
        f"{nat_s:.1f} s (g++), native ingest {ing_s:.1f} s (g++, libcrypto): "
        f"{'on' if ingest_ok else 'OFF, the broadcast plane parses and tallies in python'}")
    ptxas = {}
    for mod, names, build_s in ((cuda_verify, ("ed25519_verify_kernel",), kern_s),
                                (cuda_rlc, ("ed25519_rlc_lanes[whole]", "ed25519_rlc_lanes[split]",
                                            "ed25519_rlc_fold"), rlc_s)):
        for line in mod.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())
        for name in names:
            ptxas[name] = {**parse_ptxas(mod.build_log, name), "build_s": build_s}
            log(f"{name}: {ptxas[name]['registers']} registers, {ptxas[name]['stack_bytes']} bytes "
                f"stack frame, {ptxas[name]['spill_bytes']} bytes spill stores")
    check(native_ok, "native host prep did not build with g++")
    log("prep path: native")
    return ptxas


# -- test material ---------------------------------------------------------


def torsion_point():
    """An extended point of order 8: [L]Q for a curve point Q off the
    prime-order subgroup."""
    from at2_node_tpu_torch.crypto import _fallback as fb
    from at2_node_tpu_torch.ops.ed25519 import L

    for y in range(2, 60):
        try:
            q = fb._pt_decompress(y.to_bytes(32, "little"))
        except Exception:
            continue  # y is not on the curve
        t = fb._pt_mul(L, q)
        if not fb._pt_equal(t, fb._IDENT):
            return t
    raise RuntimeError("chip_smoke: no torsion point found")


class Material:
    """Signed transfers (64 seeded keys x 16 sequences), the RFC 8032
    TEST 1 vector, and a pool of lanes for every tamper class."""

    def __init__(self, seed: int) -> None:
        from at2_node_tpu_torch.crypto import _fallback as fb
        from at2_node_tpu_torch.crypto.keys import SignKeyPair, verify_one
        from at2_node_tpu_torch.ops.ed25519 import L
        from at2_node_tpu_torch.types import transfer_signing_bytes

        rng = np.random.default_rng(seed)
        keys = [SignKeyPair(rng.bytes(32)) for _ in range(N_KEYS)]
        self.senders = [kp.public for kp in keys]
        self.valid: list = []  # (pk, msg, sig)
        self.transfers: list = []  # (sender, seq, recipient, amount) per valid item, or None
        for seq in range(1, SEQS_PER_KEY + 1):
            for k, kp in enumerate(keys):
                recipient = keys[(k + seq) % N_KEYS].public
                amount = int(rng.integers(1, 5000))
                msg = transfer_signing_bytes(kp.public, seq, recipient, amount)
                self.valid.append((kp.public, msg, kp.sign(msg)))
                self.transfers.append((kp.public, seq, recipient, amount))
        sk, pk_hex, sig_hex = RFC8032_TEST1
        rfc = SignKeyPair(bytes.fromhex(sk))
        check(rfc.public.hex() == pk_hex and rfc.sign(b"").hex() == sig_hex,
              "RFC 8032 TEST 1 vector does not reproduce")
        self.valid.append((rfc.public, b"", bytes.fromhex(sig_hex)))
        self.transfers.append(None)

        def crafted(a_enc: bytes):
            # A of order 1 ([h]A = identity) with R = [r]B and S = r: the
            # equation holds for any message, so only A's encoding decides
            r = int.from_bytes(rng.bytes(32), "little") % L
            big_r = fb._pt_compress(fb._pt_mul(r, fb._BASE))
            return (a_enc, b"crafted %d" % r, big_r + r.to_bytes(32, "little"))

        one = (1).to_bytes(32, "little")
        # the control: canonical y = 1, sign 0, verifies
        self.control = crafted(one)
        p_plus_1 = (fb._P + 1).to_bytes(32, "little")
        one_signed = (1 | (1 << 255)).to_bytes(32, "little")
        self.tampered: dict = {c: [] for c in TAMPER_CLASSES}
        n_pool = 24
        for j in range(n_pool):
            pk, msg, sig = self.valid[int(rng.integers(0, len(self.valid) - 1))]
            s = int.from_bytes(sig[32:], "little")
            self.tampered["r_flip"].append((pk, msg, bytes([sig[0] ^ 1]) + sig[1:]))
            self.tampered["s_flip"].append((pk, msg, sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]))
            self.tampered["msg_flip"].append((pk, msg[:-1] + bytes([msg[-1] ^ 1]), sig))
            self.tampered["high_s"].append((pk, msg, sig[:32] + (s + L).to_bytes(32, "little")))
            self.tampered["noncanonical_y"].append(crafted(p_plus_1))
            self.tampered["x0_sign"].append(crafted(one_signed))
            self.tampered["wrong_len"].append(
                (pk[:31], msg, sig) if j % 2 else (pk, msg, sig[:63])
            )
            self.tampered["padding"].append((pk, msg, sig))  # valid byte zeroed later

        # 8-torsion lanes: R = [r]B + T with S = r + h a (the RLC route's
        # code 0; always rejected), and a key A' = [a]B + T (code 2: its
        # verdict depends on h mod 8), each with its expected verdict
        t = torsion_point()
        self.torsion: dict = {"r_torsion": [], "a_torsion": []}
        for j in range(2 * n_pool):
            in_key = j % 2 == 1
            a, r = (int.from_bytes(rng.bytes(32), "little") % L for _ in range(2))
            big_a, big_r = fb._pt_mul(a, fb._BASE), fb._pt_mul(r, fb._BASE)
            if in_key:
                big_a = fb._pt_add(big_a, t)
            else:
                big_r = fb._pt_add(big_r, t)
            a_enc, r_enc, msg = fb._pt_compress(big_a), fb._pt_compress(big_r), b"torsion %d" % j
            s = (r + fb._sha512_int(r_enc, a_enc, msg) % L * a) % L
            item = (a_enc, msg, r_enc + s.to_bytes(32, "little"))
            self.torsion["a_torsion" if in_key else "r_torsion"].append((item, verify_one(*item)))

    def rlc_batch(self, n: int, rng, reroute: bool, tamper: bool):
        """n lanes for the RLC kernels: ~2% of every class of RLC_OUT and,
        with ``reroute``, of RLC_REROUTE; with ``tamper`` one lane whose
        message changed (code 1: in the equation, invalid); the rest valid,
        the control among them; shuffled. Returns (items, expected codes,
        expected verdicts, padding mask)."""
        per_class = max(1, round(TAMPER_SHARE * n))
        lanes = []  # (item, code, verdict, padding)
        for c in RLC_OUT + (RLC_REROUTE if reroute else ()):
            for j in range(per_class):
                if c in self.torsion:
                    item, ok = self.torsion[c][j % len(self.torsion[c])]
                else:
                    item, ok = self.tampered[c][j % len(self.tampered[c])], False
                lanes.append((item, 2 if c in RLC_REROUTE else 0, ok, c == "padding"))
        if tamper:
            lanes.append((self.tampered["msg_flip"][0], 1, False, False))
        lanes.append((self.control, 1, True, False))
        for j in range(n - len(lanes)):
            lanes.append((self.valid[j % len(self.valid)], 1, True, False))
        lanes = [lanes[i] for i in rng.permutation(n)]
        return ([x[0] for x in lanes], np.array([x[1] for x in lanes], dtype=np.uint8),
                np.array([x[2] for x in lanes]), np.array([x[3] for x in lanes]))

    def cross_check(self) -> None:
        """The single-signature verifier agrees with the expected verdict
        of one lane of each class it can judge. Not the crafted encodings:
        OpenSSL reduces a non-canonical y mod p where RFC 8032 (and the
        batch verifier) rejects it."""
        from at2_node_tpu_torch.crypto.keys import verify_one

        check(all(verify_one(*self.valid[i]) for i in (0, 1, len(self.valid) - 1)),
              "verify_one rejects a valid lane")
        for c in ("r_flip", "s_flip", "msg_flip", "high_s", "wrong_len"):
            check(not verify_one(*self.tampered[c][0]), f"verify_one accepts a {c} lane")

    def batch(self, n: int, rng) -> tuple[list, np.ndarray, np.ndarray]:
        """n lanes, ~2% of every tamper class, the rest valid (the control
        included), shuffled. Returns (items, expected, padding mask)."""
        per_class = max(1, round(TAMPER_SHARE * n))
        items, expect, pad = [], [], []
        for c in TAMPER_CLASSES:
            pool = self.tampered[c]
            for j in range(per_class):
                items.append(pool[j % len(pool)])
                expect.append(False)
                pad.append(c == "padding")
        items.append(self.control)
        expect.append(True)
        pad.append(False)
        for j in range(n - len(items)):
            items.append(self.valid[j % len(self.valid)])
            expect.append(True)
            pad.append(False)
        order = rng.permutation(n)
        return ([items[i] for i in order], np.asarray(expect)[order],
                np.asarray(pad)[order])


# -- phase 3 ---------------------------------------------------------------


def cuda_ms(torch, fn, reps: int) -> float:
    """Device time of one call of ``fn`` over ``reps`` calls in a row, by
    CUDA events. The card first sleeps ~0.1 ms a call, so the calls are
    enqueued before the first runs: the time is the device's alone, not the
    host's launch interval, which a kernel of tens of us does not hide."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(reps * 1e-4 * 1.98e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n: int) -> tuple[float, str]:
    from at2_node_tpu_torch.ops import cuda_verify

    ops_s = n * cuda_verify.INT32_MULADD_SLOTS_PER_LANE / H100_INT32_MULADD_PER_S
    nbytes = n * 129 + (n + 7) // 8 + 4 * len(cuda_verify.lane_consts())
    bytes_s = nbytes / H100_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s else "bytes")


def kernel_vs_plain(torch, mat: Material, rng) -> dict:
    from at2_node_tpu_torch.ops import cuda_verify
    from at2_node_tpu_torch.ops import ed25519 as v

    rows_by_lanes = {}
    mismatches = 0
    max_abs_err = 0
    for n in KERNEL_LANES:
        items, expect, pad = mat.batch(n, rng)
        rows = np.empty((n, v.PACKED_WIDTH), dtype=np.uint8)
        v.fill_packed([i[0] for i in items], [i[1] for i in items], [i[2] for i in items], rows)
        rows[pad, 128] = 0  # padding lanes: a valid row with its valid byte cleared
        dev = torch.from_numpy(rows).cuda()
        kern = cuda_verify.verify_packed(dev)
        plain = v.verify_packed(dev)
        torch.cuda.synchronize()
        k_bits = np.unpackbits(kern.cpu().numpy(), count=n).astype(bool)
        p_bits = np.unpackbits(plain.cpu().numpy(), count=n).astype(bool)
        bad = int((k_bits != p_bits).sum() + (k_bits != expect).sum())
        tail = kern.cpu().numpy()[-1] & ((1 << (8 - n % 8)) - 1) if n % 8 else 0
        check(tail == 0, f"{n} lanes: bits past the last lane are not zero")
        err = int(np.abs(kern.cpu().numpy().astype(int) - plain.cpu().numpy().astype(int)).max())
        mismatches += bad
        max_abs_err = max(max_abs_err, err)
        reps = max(3, min(50, 200_000 // n))
        ms = cuda_ms(torch, lambda: cuda_verify.verify_packed(dev), reps)
        plain_ms = cuda_ms(torch, lambda: v.verify_packed(dev), 1)
        bms, by = bound_ms(n)
        rows_by_lanes[n] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "sigs_per_s": n / (ms / 1e3), "mismatches": bad,
            "valid_lanes": int(expect.sum()),
        }
        log(f"kernel vs plain {n:6d} lanes: {bad} mismatches, kernel {ms:.3f} ms "
            f"({n / (ms / 1e3):,.0f} sigs/s), plain {plain_ms:.1f} ms, bound {bms:.3f} ms ({by})")
    check(mismatches == 0, f"kernel, plain version and expected verdicts differ on {mismatches} lanes")
    return {"by_lanes": rows_by_lanes, "mismatches": mismatches, "max_abs_err": max_abs_err}


# -- phase 3b --------------------------------------------------------------


def rlc_bounds(n: int, nparts: int) -> dict:
    """The least time of each RLC kernel on these n lanes: the larger of
    its bytes over the memory rate and its multiply-add slots over the
    issue rate. The lanes kernel reads each row and the constants and
    writes a code a lane and a partial point (nparts of them, by layout),
    and does every lane's operations (the whole layout's count, the
    function's least) and the n - nparts additions of its block trees; the
    fold reads the partials and does nparts - 1 additions."""
    from at2_node_tpu_torch.ops import cuda_rlc, cuda_verify

    point = 4 * 40
    out = {}
    for name, ops, nbytes in (
        ("ed25519_rlc_lanes",
         n * cuda_rlc.INT32_MULADD_SLOTS_PER_LANE[cuda_rlc.WHOLE]
         + (n - nparts) * cuda_rlc.INT32_MULADD_SLOTS_PER_FOLD_ADD,
         n * 161 + n + nparts * point + 4 * len(cuda_verify.lane_consts())),
        ("ed25519_rlc_fold", (nparts - 1) * cuda_rlc.INT32_MULADD_SLOTS_PER_FOLD_ADD,
         nparts * point + 1 + 40),
    ):
        ops_s, bytes_s = ops / H100_INT32_MULADD_PER_S, nbytes / H100_BYTES_PER_S
        out[name] = (1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes")
    return out


def fold_known_answer(torch, lib, consts, work, rng) -> int:
    """The fold on points that do not all vanish: the lanes kernel's
    partials of a batch are mostly the identity, so here the partials are
    random multiples of B and, last, their negated sum (eq_ok True) or
    their sum (False). Returns the mismatches against the expected eq_ok
    and the plain fold."""
    from at2_node_tpu_torch.ops import aggregate as agg
    from at2_node_tpu_torch.ops import cuda_rlc
    from at2_node_tpu_torch.ops import edwards as ed
    from at2_node_tpu_torch.ops import field as fe

    eq = torch.empty((1,), dtype=torch.uint8, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    k = rng.integers(1, 16, size=work.nparts - 1)
    (sx, sy), p, m = (0, 1), ed.point_to_ints(ed.BASE), int(k.sum())
    while m:  # [sum k]B, double and add
        if m & 1:
            sx, sy = ed.affine_add_ints((sx, sy), p)
        p, m = ed.affine_add_ints(p, p), m >> 1
    bad = 0
    for sign, want in ((-1, True), (1, False)):
        pts = np.stack([ed.BASE_TABLE[int(j)] for j in k] + [ed.point_from_ints(sign * sx % fe.P, sy)])
        work.points().copy_(torch.as_tensor(pts, dtype=torch.int32))
        cuda_rlc.launch_fold(lib, consts, eq.data_ptr(), work, stream)
        fold_plain = bool(agg.is_identity(agg.tree_reduce_points(work.points().to(torch.int64))).item())
        got = bool(eq.item())
        bad += int(got != want) + int(fold_plain != want)
    return bad


def rlc_vs_plain(torch, mat: Material, rng) -> dict:
    """Phase 3b. ``rlc_packed`` runs both kernels in the layout
    ``choose_layout`` gives; each layout of the lanes kernel and the fold
    are also launched apart, straight through the library, on every batch:
    their codes and eq_ok against the plain version, the expected ones and
    the verify kernel's composed verdicts, the fold against the plain fold
    of the lanes kernel's own partial points. Each layout, the fold over
    its partials (and over one block, the alternative it replaced) and the
    verify kernel are timed on the clean batch."""
    from at2_node_tpu_torch.ops import aggregate as agg
    from at2_node_tpu_torch.ops import cuda_rlc, cuda_verify
    from at2_node_tpu_torch.ops import ed25519 as v

    lib = cuda_rlc.build()
    consts = torch.as_tensor(cuda_verify.lane_consts()).cuda()
    wave = cuda_rlc.split_wave_lanes(torch.device("cuda", 0))
    per_sm = {name: lib.ed25519_rlc_lanes_occupancy(layout)
              for layout, name in enumerate(cuda_rlc.LAYOUT_NAMES)}
    log(f"rlc lanes kernel: blocks an SM {per_sm}; the split layout while n <= {wave} lanes "
        f"(one wave), the whole layout past it")
    layouts = list(enumerate(cuda_rlc.LAYOUT_NAMES))
    by_lanes: dict = {"ed25519_rlc_lanes": {}, "ed25519_rlc_fold": {}}
    mism = Counter()
    max_err = {"ed25519_rlc_lanes": 0, "ed25519_rlc_fold": 0}
    stream = torch.cuda.current_stream().cuda_stream
    # every shape of phase 3, then the crossover: the most lanes one wave
    # of the split layout holds, and one block more
    for n in KERNEL_LANES + (wave, wave + cuda_rlc.LANES_PER_BLOCK[cuda_rlc.SPLIT]):
        chosen = cuda_rlc.choose_layout(n, wave)
        for kind, reroute, tamper in (("clean", False, False), ("rerouted", True, False),
                                      ("tampered", True, True)):
            items, want_codes, want_ok, pad = mat.rlc_batch(n, rng, reroute, tamper)
            cols = [list(x) for x in zip(*items)]
            rows = agg.rlc_prep(*cols, n).numpy()
            rows[pad, 160] = 0  # padding lanes: a valid row with its valid byte cleared
            k1_rows = np.empty((n, v.PACKED_WIDTH), dtype=np.uint8)
            v.fill_packed(*cols, k1_rows)
            k1_rows[pad, 128] = 0
            dev, k1_dev = torch.from_numpy(rows).cuda(), torch.from_numpy(k1_rows).cuda()

            eq, codes = cuda_rlc.rlc_packed(dev)
            bits = cuda_verify.verify_packed(k1_dev)
            # each layout apart: codes and partial points, then the fold
            outs, works = {}, {}
            for layout, name in layouts:
                outs[name] = torch.empty((n + 1,), dtype=torch.uint8, device="cuda")
                works[name] = cuda_rlc.Scratch(n, layout, dev.device)
                cuda_rlc.launch_lanes(lib, dev, consts, outs[name].data_ptr(), works[name], stream)
                cuda_rlc.launch_fold(lib, consts, outs[name].data_ptr() + n, works[name], stream)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            p_eq, p_codes = agg.rlc_graph_packed_plain(dev)
            end.record()
            fold_plain = {name: agg.is_identity(agg.tree_reduce_points(w.points().to(torch.int64)))
                          for name, w in works.items()}
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            eq, codes = bool(eq.item()), codes.cpu().numpy()
            p_eq, p_codes = bool(p_eq.item()), p_codes.cpu().numpy()
            k1 = np.unpackbits(bits.cpu().numpy(), count=n).astype(bool)
            composed = (codes == 1) if eq and not (codes == 2).any() else k1
            bad = {
                "lanes": int((codes != p_codes).sum() + (codes != want_codes).sum()),
                "fold": int(eq != p_eq) + int(eq != (not tamper)),
                "composed": int((composed != k1).sum() + (k1 != want_ok).sum()),
            }
            for name, out in outs.items():
                apart = out.cpu().numpy()
                a_eq, a_codes = bool(apart[n]), apart[:n]
                a_composed = (a_codes == 1) if a_eq and not (a_codes == 2).any() else k1
                bad["lanes"] += int((a_codes != p_codes).sum() + (a_codes != want_codes).sum())
                bad["fold"] += int(a_eq != p_eq) + int(bool(fold_plain[name].item()) != a_eq)
                bad["composed"] += int((a_composed != k1).sum())
                max_err["ed25519_rlc_lanes"] = max(max_err["ed25519_rlc_lanes"],
                                                   int(np.abs(a_codes.astype(int) - p_codes.astype(int)).max()))
                max_err["ed25519_rlc_fold"] = max(max_err["ed25519_rlc_fold"], abs(int(a_eq) - int(p_eq)))
            mism.update(bad)
            log(f"rlc vs plain {n:6d} lanes ({kind}): eq_ok {eq}, codes 0/1/2 "
                f"{[int((codes == c).sum()) for c in range(3)]}, both layouts apart and "
                f"rlc_packed ({cuda_rlc.LAYOUT_NAMES[chosen]}): {sum(bad.values())} mismatches "
                f"{dict(bad)}, plain {plain_ms:.1f} ms")
            if kind != "clean":
                continue
            reps = max(3, min(30, 60_000 // n))
            lanes_ms, fold_ms, bounds = {}, {}, {}
            for layout, name in layouts:
                work, out = works[name], outs[name]
                mism.update({"fold": fold_known_answer(torch, lib, consts, work, rng)})
                lanes_ms[name] = cuda_ms(torch, lambda: cuda_rlc.launch_lanes(
                    lib, dev, consts, out.data_ptr(), work, stream), reps)
                fold_ms[name] = cuda_ms(torch, lambda: cuda_rlc.launch_fold(
                    lib, consts, out.data_ptr() + n, work, stream), reps)
                bounds[name] = rlc_bounds(n, work.nparts)
            # the fold's alternative: one block of 32 quads, each adding
            # its share of the partials in a row
            whole = works["whole"]
            one_block_ms = cuda_ms(torch, lambda: check(lib.ed25519_rlc_fold_launch(
                whole.partials, whole.nparts, consts.data_ptr(), whole.level2, whole.ticket,
                outs["whole"].data_ptr() + n, 1, 4 * cuda_rlc.FOLD_MAX_QUADS, stream) == 0,
                "one-block fold launch"), reps)
            k1_ms = cuda_ms(torch, lambda: cuda_verify.verify_packed(k1_dev), reps)
            fold_plain_ms = cuda_ms(torch, lambda: agg.is_identity(
                agg.tree_reduce_points(works[cuda_rlc.LAYOUT_NAMES[chosen]].points().to(torch.int64))), 1)
            c = cuda_rlc.LAYOUT_NAMES[chosen]
            split_ops_ms = 1e3 * n * cuda_rlc.INT32_MULADD_SLOTS_PER_LANE[cuda_rlc.SPLIT] / H100_INT32_MULADD_PER_S
            for kname, ms, pms in (("ed25519_rlc_lanes", lanes_ms, plain_ms),
                                   ("ed25519_rlc_fold", fold_ms, fold_plain_ms)):
                bms, by = bounds[c][kname]
                by_lanes[kname][n] = {
                    "layout": c, "ms": ms[c], "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                    "verify_kernel_ms": k1_ms,
                    "by_layout": {name: {"ms": ms[name], "bound_ms": bounds[name][kname][0],
                                         "partials": works[name].nparts} for _, name in layouts},
                }
            by_lanes["ed25519_rlc_lanes"][n]["split_work_ms"] = split_ops_ms
            by_lanes["ed25519_rlc_fold"][n]["one_block_ms"] = one_block_ms
            log(f"rlc kernels {n:6d} lanes: lanes whole {lanes_ms['whole']:.3f} ms, split "
                f"{lanes_ms['split']:.3f} ms (bound {bounds[c]['ed25519_rlc_lanes'][0]:.3f}, "
                f"{bounds[c]['ed25519_rlc_lanes'][1]}; the split layout's own work "
                f"{split_ops_ms:.3f}); fold {fold_ms['whole']:.3f} / {fold_ms['split']:.3f} ms over "
                f"{whole.nparts} / {works['split'].nparts} partials (one block: {one_block_ms:.3f}); "
                f"{c} {lanes_ms[c] + fold_ms[c]:.3f} ms against the verify kernel's {k1_ms:.3f} ms on "
                f"the same rows: RLC/per-sig {(lanes_ms[c] + fold_ms[c]) / k1_ms:.2f}x")
    check(sum(mism.values()) == 0, f"RLC kernels, plain version, verify kernel and expected results "
          f"differ: {dict(mism)}")
    # the lanes kernel answers for the codes and the composed verdicts, the
    # fold for eq_ok
    return {"by_lanes": by_lanes, "max_abs_err": max_err, "split_wave_lanes": wave,
            "blocks_per_sm": per_sm,
            "mismatches": {"ed25519_rlc_lanes": mism["lanes"] + mism["composed"],
                           "ed25519_rlc_fold": mism["fold"]}}


# -- phase 3c --------------------------------------------------------------


def certificate(torch, mat: Material, rng, by_lanes: dict) -> dict:
    """Phase 3c: ``aggregate_verify`` and ``verify_certificate`` on the card
    at n = 64, against the verify kernel; host-clock times of whole calls
    (prep, both RLC kernels and the copy back) beside the verify kernel's
    ``verify_batch``. The RLC kernels' launch counts are set to 0 just
    before and read just after."""
    from at2_node_tpu_torch.ops import aggregate as agg
    from at2_node_tpu_torch.ops import cuda_rlc
    from at2_node_tpu_torch.ops import ed25519 as v

    cert = mat.valid[:CERT_N]  # sequence 1 of each of 64 keys: 64 distinct replicas
    j = int(rng.integers(0, CERT_N))
    pk, msg, sig = cert[j]
    bad = cert[:j] + [(pk, msg, sig[:40] + bytes([sig[40] ^ 2]) + sig[41:])] + cert[j + 1:]
    cuda_rlc.launches = cuda_rlc.fold_launches = 0
    cuda_rlc.layout_launches = [0, 0]
    verdicts = {}
    for name, items in (("clean", cert), ("tampered", bad)):
        cols = [list(x) for x in zip(*items)]
        one = verdicts[name] = agg.aggregate_verify(*cols)
        per_sig = v.verify_batch(*cols)
        check(one == bool(per_sig.all()) == (name == "clean"),
              f"certificate ({name}): aggregate_verify {one}, verify kernel {per_sig.all()}")
        check(agg.verify_certificate(*cols).tolist() == per_sig.tolist(),
              f"certificate ({name}): verify_certificate differs from the verify kernel")
    launches = (cuda_rlc.launches, cuda_rlc.fold_launches)
    check(launches == (2, 2), f"certificate: RLC kernel launches {launches}, expected (2, 2)")
    layout = by_lanes["ed25519_rlc_lanes"][CERT_N]["layout"]
    by_layout = dict(zip(cuda_rlc.LAYOUT_NAMES, cuda_rlc.layout_launches))
    check(by_layout[layout] == 2, f"certificate: lanes kernel launches by layout {by_layout}, "
          f"expected 2 in the {layout} layout")
    cols = [list(x) for x in zip(*cert)]

    def host_ms(fn, reps=20):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(times))

    agg_ms = host_ms(lambda: agg.aggregate_verify(*cols))
    per_sig_ms = host_ms(lambda: v.verify_batch(*cols))
    device_ms = (by_lanes["ed25519_rlc_lanes"][64]["ms"] + by_lanes["ed25519_rlc_fold"][64]["ms"])
    k1_ms = by_lanes["ed25519_rlc_lanes"][64]["verify_kernel_ms"]
    log(f"certificate n={CERT_N}: aggregate_verify agrees with the verify kernel (clean True, tampered "
        f"False); whole call {agg_ms:.3f} ms median against verify_batch's {per_sig_ms:.3f} ms; on the "
        f"card the RLC kernels take {device_ms:.3f} ms against the verify kernel's {k1_ms:.3f} ms at 64 lanes")
    return {"n": CERT_N, "verdicts": verdicts,
            "launches": {"ed25519_rlc_lanes": launches[0], "ed25519_rlc_fold": launches[1]},
            "lanes_launches_by_layout": by_layout,
            "aggregate_verify_ms": agg_ms, "verify_batch_ms": per_sig_ms,
            "rlc_device_ms": device_ms, "verify_kernel_ms": k1_ms}


# -- phase 4 ---------------------------------------------------------------


class FlushLog:
    """The verifier's flight-recorder seam: keeps every flush decision."""

    def __init__(self) -> None:
        self.flushes: list = []

    def record(self, kind: str, fields) -> None:
        if kind == "vflush":
            self.flushes.append(fields)  # (take, queue depth, bucket)


def replay_ledger(committed_items: list) -> dict:
    """The ledger rules in python ints, applied to the same transfers in
    the same order: {hex key: [last_sequence, balance]}."""
    state: dict = {}
    for sender, seq, recipient, amount in committed_items:
        s = state.setdefault(sender, [0, 100_000])
        if s[0] + 1 != seq:
            continue
        s[0] = seq
        if amount > s[1]:
            continue
        s[1] -= amount
        r = state.setdefault(recipient, [0, 100_000])
        r[1] += amount
    return {k.hex(): v for k, v in state.items()}


async def drive_verifier(label: str, items: list, expect: np.ndarray, **cfg) -> dict:
    """One main-path run: ``make_verifier("cuda", **cfg)``, ``warmup()``,
    then MAIN_CALLERS concurrent callers ``verify_many`` every item in
    chunks. The kernel's launch count is set to 0 just before the callers
    start and read just after they finish."""
    from at2_node_tpu_torch.crypto.verifier import make_verifier
    from at2_node_tpu_torch.ops import cuda_verify

    n_items = len(items)
    ver = make_verifier("cuda", **cfg)
    flushes = FlushLog()
    ver.recorder = flushes
    t0 = time.perf_counter()
    await ver.warmup()
    log(f"{label}: warmup of buckets {ver.buckets} took {time.perf_counter() - t0:.2f} s")

    async def caller(c: int) -> list:
        mine = list(range(c, n_items, MAIN_CALLERS))
        chunks = [mine[i:i + CALLER_CHUNK] for i in range(0, len(mine), CALLER_CHUNK)]
        results = await asyncio.gather(
            *(ver.verify_many([items[i] for i in ch]) for ch in chunks)
        )
        return [(i, ok) for ch, res in zip(chunks, results) for i, ok in zip(ch, res)]

    flushes.flushes.clear()
    cuda_verify.launches = 0
    t0 = time.perf_counter()
    per_caller = await asyncio.gather(*(caller(c) for c in range(MAIN_CALLERS)))
    wall = time.perf_counter() - t0
    launches = cuda_verify.launches

    got = np.zeros(n_items, dtype=bool)
    seen = np.zeros(n_items, dtype=bool)
    for pairs in per_caller:
        for i, ok in pairs:
            got[i] = ok
            seen[i] = True
    check(seen.all(), f"{label}: some items got no verdict")
    bad = int((got != expect).sum())
    check(bad == 0, f"{label}: {bad} verdicts differ from the expected ones")
    check(launches > 0, f"{label}: ran without launching the kernel")
    # the lanes each flush launched: its batch is min(take, depth) items,
    # padded to the smallest bucket that holds it
    buckets = [
        next((b for b in ver.buckets if b >= min(take, depth)), ver.buckets[-1])
        for take, depth, _ in flushes.flushes
    ]
    check(len(buckets) == launches, f"{label}: {len(buckets)} flushes but {launches} launches")
    check(set(buckets) <= set(KERNEL_LANES),
          f"{label}: flush buckets {sorted(set(buckets))} include a shape phase 3 did not check")
    stats = ver.stats()
    hists = ver.stage_histograms()
    await ver.close()
    log(f"{label}: {n_items} items from {MAIN_CALLERS} callers in {wall:.3f} s "
        f"= {n_items / wall:,.0f} sigs/s pipelined; {launches} kernel launches; "
        f"flush buckets {dict(sorted(Counter(buckets).items()))}")
    log(f"{label} verifier stats:", json.dumps(stats, sort_keys=True))
    log(f"{label} stage histograms:", json.dumps(hists, sort_keys=True))
    return {"launches": launches, "sigs_per_s": n_items / wall, "wall_s": wall,
            "buckets": buckets, "got": got}


async def main_path(mat: Material, rng) -> dict:
    from at2_node_tpu_torch.ledger.accounts import AccountModificationError, Accounts
    from at2_node_tpu_torch.ops.ed25519 import BUCKETS

    # one tile: every valid item in sequence order, the tampered items of
    # all item classes spread among them
    tile = [(it, True, tr) for it, tr in zip(mat.valid, mat.transfers)]
    for c in TAMPER_CLASSES:
        if c == "padding":
            continue
        for it in mat.tampered[c]:
            tile.insert(int(rng.integers(0, len(tile) + 1)), (it, False, None))
    work = [tile[i % len(tile)] for i in range(MAIN_ITEMS)]
    items = [w[0] for w in work]
    expect = np.array([w[1] for w in work])

    # The stress shape: the node's default [verifier] table with the
    # adaptive ladder, and a queue bound raised so a 70,000-item backlog can
    # coalesce into the 65,536 bucket (the default bound, 4,096, caps it).
    stress = await drive_verifier(
        "main path (stress)", items, expect,
        batch_size=256, max_delay=0.002, buckets=BUCKETS, max_queue=1 << 17,
    )
    check(65536 in stress["buckets"],
          f"the backlog never coalesced into the 65,536 bucket: {sorted(set(stress['buckets']))}")

    # commit every verified transfer, in item order; replays of an
    # already-committed sequence are refused by the ledger
    accounts = Accounts()
    committed, refused = [], 0
    for (it, _, transfer), ok in zip(work, stress["got"]):
        if not ok or transfer is None:
            continue
        committed.append(transfer)
        try:
            await accounts.transfer(*transfer)
        except AccountModificationError:
            refused += 1
    state = await accounts.export_state()
    check(state == replay_ledger(committed), "ledger state differs from the python-int replay")
    n_distinct = sum(1 for t in mat.transfers if t is not None)
    check(len(committed) - refused == n_distinct,
          f"{len(committed) - refused} transfers applied, expected {n_distinct}")
    check(all(state[pk.hex()][0] == SEQS_PER_KEY for pk in mat.senders),
          "a sender's last sequence is not its last signed transfer")
    log(f"ledger: {len(committed) - refused} transfers applied, {refused} replays refused, "
        f"{len(state)} accounts; balances equal the python-int replay")

    # What a node runs: VerifierConfig's defaults, one 256-lane bucket and
    # the default queue bound of 4,096, under the same flood.
    node = await drive_verifier(
        "main path (node default)", items, expect, batch_size=256, max_delay=0.002,
    )
    check(set(node["buckets"]) == {256}, f"node default flushed {sorted(set(node['buckets']))}")
    return {"stress": stress, "node_default": node}


# -- phase 5 ---------------------------------------------------------------


def port_modules():
    """The classes a node of this package is built from. Every net helper
    below takes such a namespace per node, so the same harness also builds
    nodes of another package with the same surface."""
    from types import SimpleNamespace

    from at2_node_tpu_torch.broadcast.messages import Payload, TxBatch
    from at2_node_tpu_torch.broadcast.stack import Broadcast
    from at2_node_tpu_torch.crypto.keys import ExchangeKeyPair, SignKeyPair
    from at2_node_tpu_torch.ledger.accounts import AccountModificationError, Accounts
    from at2_node_tpu_torch.net.peers import Mesh, Peer
    from at2_node_tpu_torch.types import ThinTransaction

    return SimpleNamespace(
        Payload=Payload, TxBatch=TxBatch, Broadcast=Broadcast,
        ExchangeKeyPair=ExchangeKeyPair, SignKeyPair=SignKeyPair,
        AccountModificationError=AccountModificationError, Accounts=Accounts,
        Mesh=Mesh, Peer=Peer, ThinTransaction=ThinTransaction,
    )


def free_ports(n: int) -> list:
    """n distinct free TCP ports on 127.0.0.1 (above 1024)."""
    import socket

    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


class Node:
    """One AT2 node's broadcast plane as the node service wires it: a mesh
    over encrypted TCP, a ``Broadcast`` verifying through its own verifier,
    an ``Accounts`` ledger, the ingress batcher (``service.py``
    ``_ingest``/``_flush_batch``/``_delayed_flush``) and the commit loop
    (``_drain_to_fixpoint``: retry a transfer until its predecessor has
    committed, then release its registry binding)."""

    def __init__(self, mods, sign_kp, exch_kp, address: str, peers: list, verifier,
                 threshold=None, workers: int = 16, batching: bool = True,
                 max_entries: int = 256, window: float = 0.005) -> None:
        self.m = mods
        self.sign_kp = sign_kp
        self.verifier = verifier
        self.mesh = mods.Mesh(address, exch_kp, peers, on_frame=self._on_frame)
        self.bcast = mods.Broadcast(sign_kp, self.mesh, verifier, echo_threshold=threshold,
                                    ready_threshold=threshold, workers=workers)
        self.accounts = mods.Accounts()
        self.batching = batching
        self.max_entries = max_entries
        self.window = window
        self._buf: list = []
        self._flush_task = None
        self._batch_seq = 0
        self.batches_sent = 0
        self._pending: dict = {}  # (sender, seq) -> delivered payload awaiting its turn
        self.committed: dict = {}  # (sender, seq) -> content hash
        self.consumed: list = []  # sequences a failed debit consumed
        self.last_commit_t = 0.0
        self.want = 0
        self.done = asyncio.Event()
        self._tasks: list = []

    async def _on_frame(self, peer, frame: bytes) -> None:
        await self.bcast.on_frame(peer, frame)

    async def start(self) -> None:
        await self.bcast.start()
        await self.mesh.start()
        self._tasks.append(asyncio.create_task(self._commit_loop()))

    async def close(self) -> None:
        for t in self._tasks + ([self._flush_task] if self._flush_task else []):
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        await self.mesh.close()
        await self.bcast.close()
        await self.verifier.close()

    def own(self, payload):
        """The same payload as this node's package builds it (wire-equal)."""
        return self.m.Payload.decode_body(payload.encode()[1:])

    async def submit(self, payload) -> None:
        """A client's SendAsset: batched into slots of at most
        ``max_entries``, flushed on size or after ``window``; with batching
        off, one broadcast slot per payload."""
        if not self.batching:
            await self.bcast.broadcast(payload)
            return
        self._buf.append(payload)
        if len(self._buf) >= self.max_entries:
            await self._flush()
        elif self._flush_task is None or self._flush_task.done():
            self._flush_task = asyncio.create_task(self._delayed_flush())

    async def _flush(self) -> None:
        buf, self._buf = self._buf, []
        for lo in range(0, len(buf), self.max_entries):
            self._batch_seq += 1
            raw = b"".join(p.encode()[1:] for p in buf[lo:lo + self.max_entries])
            self.batches_sent += 1
            await self.bcast.broadcast_batch(self.m.TxBatch.create(self.sign_kp, self._batch_seq, raw))

    async def _delayed_flush(self) -> None:
        while True:
            await asyncio.sleep(self.window)
            await self._flush()
            if not self._buf:
                return

    async def _commit_loop(self) -> None:
        q = self.bcast.delivered
        while True:
            batch = [await q.get()]
            while not q.empty():
                batch.append(q.get_nowait())
            for p in batch:
                self._pending.setdefault(p.slot, p)
            await self._drain()

    async def _drain(self) -> None:
        """One pass in (sender, sequence) order commits every run of
        consecutive sequences; a sender stops at its first gap and waits
        for the predecessor's delivery."""
        blocked = set()
        for key in sorted(self._pending):
            if key[0] in blocked:
                continue
            p = self._pending[key]
            try:
                await self.accounts.transfer(p.sender, p.sequence, p.transaction.recipient,
                                             p.transaction.amount)
            except self.m.AccountModificationError:
                if p.sequence > await self.accounts.get_last_sequence(p.sender):
                    blocked.add(key[0])  # a gap: the predecessor is not here yet
                    continue
                self.consumed.append(key)  # a failed debit consumed the sequence
            else:
                self.committed[key] = p.content_hash()
                self.last_commit_t = time.perf_counter()
            del self._pending[key]
            self.bcast.release_entry(*key)
        if len(self.committed) + len(self.consumed) >= self.want:
            self.done.set()


async def start_net(node_mods: list, verifiers: list, rng, deadline_s: float = 60.0,
                    **node_kw) -> list:
    """Nodes on 127.0.0.1, fully meshed: keys from ``rng``, node i built
    from ``node_mods[i]`` with ``verifiers[i]``; returns once every node
    holds an encrypted channel in each direction to every peer."""
    n = len(node_mods)
    ports = free_ports(n)
    seeds = [(rng.bytes(32), rng.bytes(32)) for _ in range(n)]
    nodes = []
    for i, m in enumerate(node_mods):
        keys = [(m.SignKeyPair(s), m.ExchangeKeyPair(x)) for s, x in seeds]
        peers = [m.Peer(f"127.0.0.1:{ports[j]}", keys[j][1].public, keys[j][0].public)
                 for j in range(n) if j != i]
        nodes.append(Node(m, keys[i][0], keys[i][1], f"127.0.0.1:{ports[i]}", peers,
                          verifiers[i], **node_kw))
    for node in nodes:
        await node.start()
    t_end = time.perf_counter() + deadline_s
    while any(node.mesh.stats()["channels"] < 2 * (n - 1) for node in nodes):
        check(time.perf_counter() < t_end, f"the {n}-node mesh did not connect in {deadline_s} s")
        await asyncio.sleep(0.02)
    return nodes


def make_traffic(m, rng, n_clients: int, per_client: int, tamper_share: float):
    """Client-signed transfers of ``n_clients`` seeded wallets, sequences 1
    to ``per_client``, each to another client with an amount of 1-50 (no
    debit can fail). About ``tamper_share`` of the slots also get a
    tampered twin, submitted just before the valid one: another amount,
    one signature bit flipped. Returns (per-client submissions, valid
    transfers as (sender, seq, recipient, amount), valid content hash per
    slot, tampered content hashes)."""
    clients = [m.SignKeyPair(rng.bytes(32)) for _ in range(n_clients)]
    subs = [[] for _ in range(n_clients)]
    valid, good_hash, bad_hashes = [], {}, set()
    for c, kp in enumerate(clients):
        for seq in range(1, per_client + 1):
            recipient = clients[(c + 1 + int(rng.integers(0, n_clients - 1))) % n_clients].public
            amount = int(rng.integers(1, 51))
            if rng.random() < tamper_share:
                twin = m.Payload.create(kp, seq, m.ThinTransaction(recipient, amount + 1))
                sig = bytearray(twin.signature)
                sig[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
                bad = m.Payload(kp.public, seq, twin.transaction, bytes(sig))
                subs[c].append(bad)
                bad_hashes.add(bad.content_hash())
            p = m.Payload.create(kp, seq, m.ThinTransaction(recipient, amount))
            subs[c].append(p)
            valid.append((kp.public, seq, recipient, amount))
            good_hash[p.slot] = p.content_hash()
    return subs, valid, good_hash, bad_hashes


async def drive_net(nodes: list, subs: list, valid: list, deadline_s: float) -> dict:
    """Client c submits its transfers, in order, to node c mod n; returns
    once every node has committed every valid transfer (or fails at the
    deadline). The wall time runs from the first submission to the last
    commit on any node."""
    n = len(nodes)
    own = [[nodes[c % n].own(p) for p in mine] for c, mine in enumerate(subs)]
    for node in nodes:
        node.want = len(valid)

    async def client(c: int) -> None:
        node = nodes[c % n]
        for p in own[c]:
            await node.submit(p)
            await asyncio.sleep(0)

    t0 = time.perf_counter()
    await asyncio.gather(*(client(c) for c in range(len(subs))))
    try:
        await asyncio.wait_for(asyncio.gather(*(node.done.wait() for node in nodes)), deadline_s)
    except asyncio.TimeoutError:
        for node in nodes:  # a commit loop that died explains the stall
            for t in node._tasks:
                if t.done() and not t.cancelled() and t.exception() is not None:
                    raise t.exception()
        counts = [len(node.committed) for node in nodes]
        raise RuntimeError(f"chip_smoke: committed {counts} of {len(valid)} transfers "
                           f"per node within {deadline_s} s") from None
    wall = max(node.last_commit_t for node in nodes) - t0
    return {"wall_s": wall, "tx_per_s": len(valid) / wall}


async def check_ledgers(nodes: list, valid: list, good_hash: dict, bad_hashes: set) -> dict:
    """Checks 1 and 2 of the net: equal ledgers that equal the python-int
    replay of the valid transfers, and no tampered content committed."""
    states = [await node.accounts.export_state() for node in nodes]
    replay = replay_ledger(sorted(valid, key=lambda t: (t[0], t[1])))
    for i, (node, state) in enumerate(zip(nodes, states)):
        check(not node.consumed, f"node {i}: {len(node.consumed)} transfers failed their debit")
        check(state == states[0], f"node {i}'s ledger differs from node 0's")
        committed_bad = sum(1 for h in node.committed.values() if h in bad_hashes)
        check(committed_bad == 0, f"node {i} committed {committed_bad} tampered transfers")
        check(node.committed == good_hash, f"node {i} committed other contents than the valid ones")
    check(states[0] == replay, "the ledgers differ from the python-int replay of the valid transfers")
    return states[0]


async def broadcast_net(label: str, rng, batching: bool, per_client: int, by_lanes: dict,
                        deadline_s: float) -> dict:
    """One run of phase 5: four port nodes over encrypted TCP on
    127.0.0.1, each verifying through its own ``make_verifier("cuda")`` at
    the node's default [verifier] table; 16 clients; every valid transfer
    commits on all four ledgers."""
    from at2_node_tpu_torch.crypto.verifier import make_verifier
    from at2_node_tpu_torch.native import ingest
    from at2_node_tpu_torch.ops import cuda_verify

    m = port_modules()
    verifiers, logs = [], []
    for _ in range(NET_NODES):
        ver = make_verifier("cuda", batch_size=256, max_delay=0.002)
        await ver.warmup()
        ver.recorder = FlushLog()
        verifiers.append(ver)
        logs.append(ver.recorder)
    nodes = await start_net([m] * NET_NODES, verifiers, rng, batching=batching)
    try:
        subs, valid, good_hash, bad_hashes = make_traffic(
            m, rng, NET_CLIENTS, per_client, TAMPER_SHARE)
        tampered_at = Counter()
        for c, mine in enumerate(subs):
            tampered_at[c % NET_NODES] += sum(1 for p in mine if p.content_hash() in bad_hashes)
        for log_ in logs:
            log_.flushes.clear()
        sigs0 = [v.signatures_verified for v in verifiers]
        cuda_verify.launches = 0
        run = await drive_net(nodes, subs, valid, deadline_s)
        launches = cuda_verify.launches
        state = await check_ledgers(nodes, valid, good_hash, bad_hashes)

        per_node = []
        for i, (node, ver, log_) in enumerate(zip(nodes, verifiers, logs)):
            buckets = [ver._bucket_for(min(take, depth)) for take, depth, _ in log_.flushes]
            stats = ver.stats()
            check(ver.device.type == "cuda", f"node {i}'s verifier is on {ver.device}")
            check(stats["batches"] > 0, f"node {i}'s verifier dispatched no batch")
            check(set(buckets) == {256}, f"node {i} flushed buckets {sorted(set(buckets))}")
            invalid = node.bcast.stats["invalid_sig"]
            # a tampered batch entry reaches every node; a tampered
            # per-transaction payload only the node it was submitted to
            need = len(bad_hashes) if batching else tampered_at[i]
            check(invalid >= need, f"node {i} counted {invalid} invalid signatures, expected >= {need}")
            per_node.append({
                "signatures": ver.signatures_verified - sigs0[i], "flushes": len(buckets),
                "batches": stats["batches"], "batch_occupancy": stats["batch_occupancy"],
                "invalid_sig": invalid, "slots_sent": node.batches_sent,
                "native_readers": node.mesh.stats()["native_readers"],
                "stage_histograms": ver.stage_histograms(),
            })
        flushes = sum(p["flushes"] for p in per_node)
        check(launches > 0, f"{label}: ran without launching the kernel")
        check(launches == flushes, f"{label}: {flushes} flushes but {launches} launches")
        share = flushes * by_lanes[256]["ms"] / (1e3 * run["wall_s"])
        native = ingest.ingest_ready()
        log(f"{label}: {len(valid)} transfers ({len(bad_hashes)} tampered twins) from "
            f"{NET_CLIENTS} clients committed on all {NET_NODES} nodes in {run['wall_s']:.3f} s "
            f"= {run['tx_per_s']:,.0f} tx/s; {launches} kernel launches, kernel busy "
            f"{100 * share:.1f}% of the wall time (phase 3 times); {len(state)} accounts, ledgers "
            f"equal to each other and to the replay")
        log(f"{label}: native ingest library {'on' if native else 'OFF (python fallback)'}, "
            f"native readers {[p['native_readers'] for p in per_node]} per node; the four nodes "
            f"share one process and one GIL, so the rate is a floor for a 4-node net")
        for i, p in enumerate(per_node):
            log(f"{label} node {i}: {p['signatures']} signatures verified, {p['batches']} batches, "
                f"occupancy {p['batch_occupancy']:.3f}, invalid_sig {p['invalid_sig']}, "
                f"{p['slots_sent']} batch slots sent")
            log(f"{label} node {i} stage histograms:", json.dumps(p.pop("stage_histograms"), sort_keys=True))
        return {"launches": launches, "tx_per_s": run["tx_per_s"], "wall_s": run["wall_s"],
                "transfers": len(valid), "tampered": len(bad_hashes), "kernel_busy_share": share,
                "native_ingest": native, "nodes": per_node}
    finally:
        for node in nodes:
            await node.close()


async def net_path(seed: int, by_lanes: dict) -> dict:
    rng = np.random.default_rng(seed + 5)
    return {
        "net_batched": await broadcast_net(
            "net (batched plane)", rng, True, NET_PER_CLIENT_BATCHED, by_lanes, NET_DEADLINE_S),
        "net_per_tx": await broadcast_net(
            "net (per-transaction plane)", rng, False, NET_PER_CLIENT_PER_TX, by_lanes, NET_DEADLINE_S),
    }


# -- phase 6 ---------------------------------------------------------------


def server_argv(*args: str) -> list:
    return [sys.executable, "-m", "at2_node_tpu_torch.cli.server", *args]


def checkout_env() -> dict:
    """The environment of a process started from this checkout: the
    checkout first on PYTHONPATH."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


class ServerNet:
    """``n`` ``server run`` processes on 127.0.0.1, configured the way an
    operator does it: one ``server config new`` per node (``--verifier
    cpu`` for the host kind), every other node's ``config get-node``
    fragment appended. ``top``, when given, is top-level TOML keys put
    before node i's config (the thresholds); ``tables(i)`` is TOML text
    appended after the fragments (``[plane]``, ``[store]``)."""

    def __init__(self, kind: str, workdir: str, n: int = NET_NODES, mode: str = "auto",
                 top: str = "", tables=None) -> None:
        self.kind = kind
        self.mode = mode
        self.workdir = workdir
        self.n = n
        self.top = top
        self.tables = tables
        self.procs: list = []
        self.logs: list = []
        self.tomls: list = []
        self.rpc_ports: list = []

    def _cli(self, argvs: list, inputs: list) -> list:
        """Run CLI commands side by side; their standard outputs."""
        procs = [subprocess.Popen(a, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True, env=checkout_env())
                 for a in argvs]
        outs = []
        for argv, proc, text in zip(argvs, procs, inputs):
            out, err = proc.communicate(text, timeout=120)
            check(proc.returncode == 0, f"{' '.join(argv[2:])} failed: {err.strip()[-2000:]}")
            outs.append(out)
        return outs

    def start(self, deadline_s: float) -> None:
        ports = free_ports(2 * self.n)
        node_ports, self.rpc_ports = ports[0::2], ports[1::2]
        # the card's kind is config new's default; the host's is asked for
        ask = [] if self.kind == "cuda" else ["--verifier", self.kind]
        configs = self._cli(
            [server_argv("config", "new", *ask, f"127.0.0.1:{a}", f"127.0.0.1:{b}")
             for a, b in zip(node_ports, self.rpc_ports)],
            [""] * self.n,
        )
        table = f'[verifier]\nkind = "{self.kind}"\nbatch_size = 256\nmax_delay = 0.002\nmode = "auto"\n'
        check(all(c.count(table) == 1 for c in configs),
              f"config new wrote no node default [verifier] table of kind {self.kind!r}")
        # the operator's one edit for another verifier mode
        configs = [c.replace(table, table.replace('"auto"', f'"{self.mode}"')) for c in configs]
        fragments = self._cli([server_argv("config", "get-node")] * self.n, configs)
        for i in range(self.n):
            toml = self.top + configs[i] + "\n" + "\n".join(f for j, f in enumerate(fragments) if j != i)
            if self.tables is not None:
                toml += "\n" + self.tables(i)
            path = os.path.join(self.workdir, f"node{i}.toml")
            with open(path, "w") as f:
                f.write(toml)
            self.tomls.append(path)
            self.logs.append(os.path.join(self.workdir, f"node{i}.log"))
            self.procs.append(self._spawn(i, "w"))
        # a node binds its RPC port after its verifier's warmup
        t_end = time.perf_counter() + deadline_s
        for i in range(self.n):
            self.wait_rpc(i, t_end)
        while any(self.stats(i)["mesh_channels"] < 2 * (self.n - 1) for i in range(self.n)):
            check(time.perf_counter() < t_end, f"the {self.n}-node mesh did not connect in {deadline_s} s")
            time.sleep(0.05)

    def _spawn(self, i: int, log_mode: str):
        with open(self.tomls[i]) as stdin, open(self.logs[i], log_mode) as out:
            return subprocess.Popen(server_argv("run"), stdin=stdin, stdout=out,
                                    stderr=subprocess.STDOUT, env=checkout_env())

    def wait_rpc(self, i: int, t_end: float) -> None:
        while not self._accepts(self.rpc_ports[i]):
            check(self.procs[i].poll() is None,
                  f"node {i} exited with {self.procs[i].returncode}: {self.log_tail(i)}")
            check(time.perf_counter() < t_end, f"node {i}'s RPC port never came up: {self.log_tail(i)}")
            time.sleep(0.05)

    def kill(self, i: int) -> None:
        """SIGKILL node i: no shutdown drain, no final store flush."""
        import signal

        self.procs[i].send_signal(signal.SIGKILL)
        self.procs[i].wait(timeout=60)

    def restart(self, i: int) -> None:
        """Start node i again from its TOML (its store directory with it)."""
        self.procs[i] = self._spawn(i, "a")

    @staticmethod
    def _accepts(port: int) -> bool:
        import socket

        try:
            with socket.create_connection(("127.0.0.1", port), timeout=1):
                return True
        except OSError:
            return False

    def log_tail(self, i: int, n: int = 3000) -> str:
        with open(self.logs[i]) as f:
            return f.read()[-n:]

    def get(self, i: int, path: str) -> str:
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{self.rpc_ports[i]}{path}", timeout=30) as r:
            return r.read().decode()

    def statusz(self, i: int) -> dict:
        return json.loads(self.get(i, "/statusz"))

    def stats(self, i: int) -> dict:
        return self.statusz(i)["stats"]

    def committed(self, i: int) -> int:
        """Transfers node ``i`` has committed, from /healthz: a small body
        (a 503 verdict carries it too)."""
        import urllib.error

        try:
            body = self.get(i, "/healthz")
        except urllib.error.HTTPError as exc:
            body = exc.read().decode()
        return json.loads(body)["committed"]

    def metrics(self, i: int) -> dict:
        """/metrics as {name: value} (the exposition's sample lines)."""
        out = {}
        for line in self.get(i, "/metrics").splitlines():
            if line and not line.startswith("#"):
                name, _, value = line.rpartition(" ")
                out[name] = float(value)
        return out

    def stop(self) -> list:
        """SIGTERM every server; their exit codes."""
        import signal

        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        rcs = []
        for p in self.procs:
            try:
                rcs.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
        return rcs


def more_transfers(rng, clients: list, first_seq: int, per_client: int) -> list:
    """``per_client`` transfers a client, sequences ``first_seq``.., each to
    another client with an amount of 1-50 (no debit can fail)."""
    n = len(clients)
    return [[(seq, clients[(c + 1 + int(rng.integers(0, n - 1))) % n].public, int(rng.integers(1, 51)))
             for seq in range(first_seq, first_seq + per_client)] for c in range(n)]


def node_traffic(rng, n_clients: int, per_batched: int, per_unary: int, n_tampered: int):
    """Seeded wallets and their transfers, sequences 1..per_batched (run A)
    then per_batched+1..+per_unary (run B), each to another client with an
    amount of 1-50 (no debit can fail). ``n_tampered`` run-B slots, spread
    over the clients, get a tampered twin (another amount, one signature
    bit flipped) sent just before the valid transfer."""
    from at2_node_tpu_torch.crypto.keys import SignKeyPair
    from at2_node_tpu_torch.types import transfer_signing_bytes

    clients = [SignKeyPair(rng.bytes(32)) for _ in range(n_clients)]
    run_a = more_transfers(rng, clients, 1, per_batched)
    run_b = more_transfers(rng, clients, per_batched + 1, per_unary)
    twins: dict = {}
    for k in range(n_tampered):
        c = k % n_clients
        seq, recipient, amount = run_b[c][int(rng.integers(0, per_unary))]
        sig = bytearray(clients[c].sign(
            transfer_signing_bytes(clients[c].public, seq, recipient, amount + 1)))
        sig[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
        twins[(c, seq)] = (recipient, amount + 1, bytes(sig))
    return clients, run_a, run_b, twins


def signing_pass(clients: list, per_client: list) -> float:
    """Seconds this process takes to sign every transfer once: the signing
    the Client does inside its calls, measured apart."""
    from at2_node_tpu_torch.types import transfer_signing_bytes

    t0 = time.perf_counter()
    for kp, transfers in zip(clients, per_client):
        for seq, recipient, amount in transfers:
            kp.sign(transfer_signing_bytes(kp.public, seq, recipient, amount))
    return time.perf_counter() - t0


def wait_committed(net: ServerNet, want: list, deadline_s: float) -> float:
    """Poll each node's committed count (one /healthz GET per node every
    NODE_POLL_S) until node i has committed ``want[i]``; the perf_counter
    time of the poll that saw the last node get there. The window's end
    is known to within one poll period, and the probe costs each node
    1/NODE_POLL_S small requests a second."""
    pending = set(range(net.n))
    t_end = time.perf_counter() + deadline_s
    last = 0.0
    while pending:
        check(time.perf_counter() < t_end,
              f"nodes {sorted(pending)} short of {[want[i] for i in sorted(pending)]} commits "
              f"after {deadline_s} s")
        for i in sorted(pending):
            if net.committed(i) >= want[i]:
                pending.discard(i)
                last = time.perf_counter()
        if pending:
            time.sleep(NODE_POLL_S)
    return last


async def check_sequences(net: ServerNet, clients: list, want: int) -> None:
    """Once, after a run's window: every client's GetLastSequence on every
    node is ``want``."""
    from at2_node_tpu_torch.client import Client

    for i, port in enumerate(net.rpc_ports):
        async with Client(f"http://127.0.0.1:{port}") as conn:
            seqs = await asyncio.gather(*(conn.get_last_sequence(kp.public) for kp in clients))
        short = [c for c, s in enumerate(seqs) if s != want]
        check(not short, f"node {i}: clients {short} are not at sequence {want}")


async def check_replay(net: ServerNet, clients: list, per_client: list) -> None:
    """Every node's ledger (``GetLastSequence`` and ``GetBalance`` of every
    client) equals the python-int replay of ``per_client[c]``, client c's
    transfers."""
    from at2_node_tpu_torch.client import Client

    replay = replay_ledger([(clients[c].public, seq, r, a)
                            for c in range(len(clients)) for seq, r, a in per_client[c]])
    for i, port in enumerate(net.rpc_ports):
        async with Client(f"http://127.0.0.1:{port}") as conn:
            for kp in clients:
                seq = await conn.get_last_sequence(kp.public)
                bal = await conn.get_balance(kp.public)
                check([seq, bal] == replay[kp.public.hex()],
                      f"node {i}: {kp.public.hex()[:12]} has sequence {seq}, balance {bal}; "
                      f"the replay says {replay[kp.public.hex()]}")


async def node_run(net: ServerNet, label: str, clients: list, transfers: list, batched: bool,
                   twins: dict, want_seq: int, deadline_s: float) -> dict:
    """One phase-6 run: client c submits its transfers, in order, to node c
    mod n through the port's Client (``send_asset_many`` or ``send_asset``),
    each tampered twin first through a raw stub; returns once every node
    has committed every valid transfer."""
    import grpc

    from at2_node_tpu_torch.client import Client
    from at2_node_tpu_torch.proto import at2_pb2 as pb
    from at2_node_tpu_torch.proto.rpc import At2Stub

    n = net.n
    sign_s = signing_pass(clients, transfers)
    n_sigs = sum(len(t) for t in transfers)
    refused = Counter()

    async def client(c: int) -> None:
        url = f"127.0.0.1:{net.rpc_ports[c % n]}"
        kp = clients[c]
        async with Client(f"http://{url}") as conn:
            if batched:
                await conn.send_asset_many(kp, transfers[c])
                return
            channel = grpc.aio.insecure_channel(url)
            stub = At2Stub(channel)
            try:
                for seq, recipient, amount in transfers[c]:
                    twin = twins.get((c, seq))
                    if twin is not None:
                        req = pb.SendAssetRequest(sender=kp.public, sequence=seq, recipient=twin[0],
                                                  amount=twin[1], signature=twin[2])
                        try:
                            await stub.SendAsset(req)
                        except grpc.aio.AioRpcError as exc:
                            check(exc.code() == grpc.StatusCode.INVALID_ARGUMENT,
                                  f"a tampered transfer got {exc.code()}, not INVALID_ARGUMENT")
                            refused[c % n] += 1
                        else:
                            check(False, "a tampered transfer was admitted")
                    await conn.send_asset(kp, seq, recipient, amount)
            finally:
                await channel.close()

    before = [net.statusz(i) for i in range(n)]
    t0 = time.perf_counter()
    await asyncio.gather(*(client(c) for c in range(len(clients))))
    submit_s = time.perf_counter() - t0
    t_last = wait_committed(net, [b["stats"]["committed"] + n_sigs for b in before], deadline_s)
    wall = t_last - t0
    await check_sequences(net, clients, want_seq)
    return {"label": label, "wall_s": wall, "tx_per_s": n_sigs / wall, "transfers": n_sigs,
            "clients": len(clients), "t_last": t_last,
            "sign_s": sign_s, "submit_s": submit_s, "refused": refused, "before": before}


async def node_path(seed: int, by_lanes, card, kind: str = "cuda", n_clients: int = NET_CLIENTS,
                    per_batched: int = NET_PER_CLIENT_BATCHED, per_unary: int = NET_PER_CLIENT_PER_TX,
                    n_tampered: int = NODE_TAMPERED, deadline_s: float = NET_DEADLINE_S,
                    mode: str = "auto") -> dict:
    """Phase 6 (and, with ``mode="rlc"``, phase 7): four ``server run``
    processes with ``[verifier] kind`` and ``mode``; run A through
    ``send_asset_many``, run B through unary ``send_asset`` with tampered
    twins; then the ledgers, refusals, metrics and shutdown are checked.
    ``by_lanes`` (phase 3's and 3b's kernel times by kernel name) and
    ``card`` (the name the build block must carry) are None off the card."""
    import tempfile

    rng = np.random.default_rng(seed + (6 if mode == "auto" else 7))
    clients, run_a, run_b, twins = node_traffic(rng, n_clients, per_batched, per_unary, n_tampered)
    prefix = "" if mode == "auto" else f"{mode} "
    with tempfile.TemporaryDirectory(prefix="at2-phase6-") as workdir:
        net = ServerNet(kind, workdir, mode=mode)
        t0 = time.perf_counter()
        try:
            net.start(deadline_s=180.0)
            log(f"{prefix}node net: {net.n} `server run` processes, [verifier] kind = \"{kind}\", "
                f"mode = \"{mode}\", up and meshed in {time.perf_counter() - t0:.1f} s")
            runs = {}
            refused_total = Counter()
            for name, label, transfers, batched, want in (
                ("node_grpc_batched", "node net (SendAssetBatch)", run_a, True, per_batched),
                ("node_grpc_unary", "node net (unary SendAsset)", run_b, False, per_batched + per_unary),
            ):
                run = await node_run(net, prefix + label, clients, transfers, batched,
                                     {} if batched else twins, want, deadline_s)
                refused_total.update(run["refused"])
                runs[prefix.replace(" ", "_") + name] = node_checks(
                    net, run, by_lanes, card, kind, refused_total, mode)
            check(sum(refused_total.values()) == len(twins),
                  f"{sum(refused_total.values())} of {len(twins)} tampered transfers refused")
            # the ledgers: every valid transfer committed on every node
            await check_replay(net, clients, [run_a[c] + run_b[c] for c in range(n_clients)])
            log(f"{prefix}node net: {len(clients)} accounts equal the python-int replay on all {net.n} "
                f"nodes; {sum(refused_total.values())} tampered transfers refused with INVALID_ARGUMENT")
        finally:
            rcs = net.stop()
        check(rcs == [0] * net.n, f"servers exited with {rcs} on SIGTERM")
        log(f"{prefix}node net: every server exited 0 on SIGTERM")
    return runs


def _lanes(st: dict) -> float:
    """Kernel lanes a verifier has launched since its node started
    (signatures plus padding), from its cumulative occupancy."""
    occ = st.get("verifier_batch_occupancy", 0.0)
    return st["verifier_signatures"] / occ if occ else 0.0


def node_checks(net: ServerNet, run: dict, by_lanes, card, kind: str, refused: Counter,
                mode: str = "auto") -> dict:
    """After a run: each node's /metrics (audit_divergence 0,
    rejected_at_ingress equal to the tampered transfers refused there so
    far), verifier counters, the kernels' launch counts and the card in its
    /statusz build block. In mode "rlc" every batch goes through the RLC
    kernels, and the verify kernel runs once a fallback."""
    label = run["label"]
    per_node, launches, rlc_launches = [], 0, 0
    for i in range(net.n):
        status, status0 = net.statusz(i), run["before"][i]
        st, st0 = status["stats"], status0["stats"]
        m = net.metrics(i)
        check(m["at2_audit_divergence"] == 0, f"node {i}: audit_divergence {m['at2_audit_divergence']}")
        check(m["at2_rejected_at_ingress_total"] == refused[i],
              f"node {i}: rejected_at_ingress {m['at2_rejected_at_ingress_total']}, {refused[i]} refused")
        sigs = st["verifier_signatures"] - st0["verifier_signatures"]
        check(sigs > 0, f"{label} node {i}: the verifier checked no signature")
        # the CPU kind (a rehearsal off the card) has no batches
        batches = st.get("verifier_batches", 0) - st0.get("verifier_batches", 0)
        node_launches = node_rlc = fallbacks = 0
        if kind == "cuda":
            check(batches > 0, f"{label} node {i}: the verifier dispatched no batch")
            check(status["build"].get("device") == card,
                  f"node {i}'s build block names {status['build'].get('device')!r}, not {card!r}")
            # the process-wide counts: a `server run` process holds one verifier
            b, b0 = status["build"], status0["build"]
            node_launches = b["kernel_launches"] - b0["kernel_launches"]
            node_rlc = b["rlc_kernel_launches"] - b0["rlc_kernel_launches"]
            node_fold = b["rlc_fold_launches"] - b0["rlc_fold_launches"]
            rlc_batches = st["verifier_rlc_batches"] - st0["verifier_rlc_batches"]
            fallbacks = st["verifier_rlc_fallbacks"] - st0["verifier_rlc_fallbacks"]
            if mode == "rlc":
                check(rlc_batches == batches, f"{label} node {i}: {batches} batches, {rlc_batches} RLC")
                check(node_rlc == node_fold == rlc_batches,
                      f"{label} node {i}: {rlc_batches} RLC batches, RLC kernel launches "
                      f"{node_rlc} and {node_fold}")
                check(node_launches == fallbacks,
                      f"{label} node {i}: {fallbacks} fallbacks, {node_launches} verify kernel launches")
                check(fallbacks >= 1 or not run["refused"][i],
                      f"{label} node {i} refused a twin without an exact pass")
            else:
                check(node_launches == batches, f"{label} node {i}: {batches} batches, {node_launches} launches")
                check(node_rlc == node_fold == rlc_batches == 0, f"{label} node {i}: RLC ran in mode {mode}")
        launches += node_launches
        rlc_launches += node_rlc
        per_node.append({
            "signatures": sigs, "batches": batches, "launches": node_launches,
            # this run's: signatures over the lanes its batches launched
            "batch_occupancy": sigs / (_lanes(st) - _lanes(st0)) if batches else 0.0,
            "rejected_at_ingress": int(m["at2_rejected_at_ingress_total"]),
            "rlc_launches": node_rlc, "rlc_fallbacks": fallbacks,
            "kernel_busy_share": ((node_launches * by_lanes["ed25519_verify"][256]["ms"]
                                   + node_rlc * (by_lanes["ed25519_rlc_lanes"][256]["ms"]
                                                 + by_lanes["ed25519_rlc_fold"][256]["ms"]))
                                  / (1e3 * run["wall_s"]) if by_lanes else None),
            "stage_histograms": status["verifier_stages"],
        })
    if kind == "cuda":
        check((rlc_launches if mode == "rlc" else launches) > 0, f"{label}: ran without launching a kernel")
    log(f"{label}: {run['transfers']} transfers from {run['clients']} clients "
        f"committed on all {net.n} nodes in {run['wall_s']:.3f} s = {run['tx_per_s']:,.0f} tx/s "
        f"(first submission to last commit); client signing {run['sign_s']:.3f} s measured apart, "
        f"submission {run['submit_s']:.3f} s; {launches} verify kernel launches, {rlc_launches} RLC "
        f"kernel launches")
    for i, p in enumerate(per_node):
        busy = p["kernel_busy_share"]
        log(f"{label} node {i}: {p['signatures']} signatures verified, {p['batches']} batches, "
            f"{p['rlc_launches']} through RLC, {p['rlc_fallbacks']} fallbacks, "
            f"occupancy {p['batch_occupancy']:.3f}, rejected_at_ingress {p['rejected_at_ingress']}"
            + (f", kernel busy {100 * busy:.1f}% of the wall time (phase 3 times)" if busy is not None else ""))
        log(f"{label} node {i} stage histograms since the node started:",
            json.dumps(p.pop("stage_histograms"), sort_keys=True))
    return {"launches": launches, "rlc_launches": rlc_launches, "tx_per_s": run["tx_per_s"],
            "wall_s": run["wall_s"], "transfers": run["transfers"], "sign_s": run["sign_s"],
            "submit_s": run["submit_s"], "nodes": per_node}


# -- phase 9 ---------------------------------------------------------------


PLANE_SHARDS = 2
STORE_FLUSH_S = 1.0
RESTART_PER_CLIENT = NET_PER_CLIENT_BATCHED // 4  # 9c: a quarter of run A's traffic
RESTART_WAL_PER_CLIENT = 8  # 9c: transfers a client node 0 holds in its WAL alone
RING_SLOTS = 4096  # the reference's [plane] defaults: 4,096 slots of 1 KiB
RING_SLOT_BYTES = 1024
RINGS_PER_SHARD = 3  # actions, effects, obs (parallel/plane.py)


def check_shm_room(n_nodes: int) -> None:
    """Prints ``df -B1 /dev/shm`` and fails unless the rings of ``n_nodes``
    nodes and of one node more (a killed node's, until they are removed)
    fit in its free space."""
    df = subprocess.run(["df", "-B1", "/dev/shm"], capture_output=True, text=True, timeout=30)
    log("df -B1 /dev/shm:", " | ".join(df.stdout.strip().splitlines()))
    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    need = (n_nodes + 1) * PLANE_SHARDS * RINGS_PER_SHARD * RING_SLOTS * RING_SLOT_BYTES
    check(need <= free, f"/dev/shm has {free} bytes free, the plane's rings need {need}")


def rings_of(pids) -> list:
    """The plane rings in /dev/shm that the owners ``pids`` created."""
    return sorted(f for f in os.listdir("/dev/shm")
                  if any(f.startswith(f"at2pl-{pid}-") for pid in pids))


def _proc_read(pid: int, name: str) -> str:
    try:
        with open(f"/proc/{pid}/{name}", "rb") as f:
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def proc_alive(pid: int) -> bool:
    """Whether ``pid`` runs (a zombie does not)."""
    stat = _proc_read(pid, "stat")
    return bool(stat) and stat.rsplit(")", 1)[1].split()[0] not in ("Z", "X")


def shard_workers(pid: int) -> list:
    """The spawn children of process ``pid`` (its plane shard workers),
    found by their parent pid in /proc."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        stat = _proc_read(int(name), "stat")
        if stat and int(stat.rsplit(")", 1)[1].split()[1]) == pid and proc_alive(int(name)) \
                and "spawn_main" in _proc_read(int(name), "cmdline"):
            out.append(int(name))
    return sorted(out)


def maps_lib(pid: int, stem: str) -> bool:
    """Whether process ``pid`` has a file whose name holds ``stem`` mapped."""
    return any(stem in line.rsplit("/", 1)[-1] for line in _proc_read(pid, "maps").splitlines()
               if "/" in line)


def check_workers(net: ServerNet, label: str) -> dict:
    """Process executor: each server has its shard workers; none of them
    has mapped libcuda or libtorch (the servers have libcuda), and
    ``nvidia-smi --query-compute-apps`` lists no worker."""
    servers = [p.pid for p in net.procs]
    workers = {pid: shard_workers(pid) for pid in servers}
    for i, pid in enumerate(servers):
        check(len(workers[pid]) == PLANE_SHARDS,
              f"{label} node {i} (pid {pid}) has shard workers {workers[pid]}, not {PLANE_SHARDS}")
        check(net.kind != "cuda" or maps_lib(pid, "libcuda"), f"{label} node {i} has no libcuda mapped")
    every = [w for ws in workers.values() for w in ws]
    for w in every:
        check(not maps_lib(w, "libcuda"), f"{label}: shard worker {w} has libcuda mapped")
        check(not maps_lib(w, "libtorch"), f"{label}: shard worker {w} has libtorch mapped")
    if net.kind != "cuda":
        return {"servers": servers, "workers": every, "gpu_pids": None}
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi --query-compute-apps failed: {smi.stderr.strip()}")
    gpu = sorted(int(x) for x in smi.stdout.split() if x.strip().isdigit())
    check(not set(gpu) & set(every), f"{label}: nvidia-smi lists shard workers: {gpu}, workers {every}")
    # the compute apps: the servers and this process; a worker with a
    # context would add one (in a container the pids may be of another
    # namespace, so they are counted too)
    check(len(gpu) <= len(servers) + 1,
          f"{label}: nvidia-smi lists {len(gpu)} compute apps ({gpu}) for {len(servers)} servers and this process")
    same_ns = bool(set(gpu) & set(servers))
    if same_ns:
        check(set(gpu) <= set(servers) | {os.getpid()},
              f"{label}: nvidia-smi lists {gpu}, the servers are {servers}")
    log(f"{label}: servers {servers}, shard workers {every} (none maps libcuda or libtorch; "
        f"every server maps libcuda); nvidia-smi lists {len(gpu)} compute apps {gpu}: at most the "
        f"{len(servers)} servers and this process"
        + ("" if same_ns else " (pids of another namespace)"))
    return {"servers": servers, "workers": every, "gpu_pids": gpu}


def send_batched(net: ServerNet, clients: list, per_client: list, node_of) -> "asyncio.Future":
    """Client c sends ``per_client[c]`` with ``send_asset_many`` to node
    ``node_of(c)``."""
    from at2_node_tpu_torch.client import Client

    async def one(c: int) -> None:
        async with Client(f"http://127.0.0.1:{net.rpc_ports[node_of(c)]}") as conn:
            await conn.send_asset_many(clients[c], per_client[c])

    return asyncio.gather(*(one(c) for c in range(len(clients))))


async def wait_sequences(net: ServerNet, i: int, clients: list, want: int, deadline_s: float) -> float:
    """Poll node i's GetLastSequence of every client until all are ``want``;
    the seconds it took."""
    from at2_node_tpu_torch.client import Client

    t0 = time.perf_counter()
    async with Client(f"http://127.0.0.1:{net.rpc_ports[i]}") as conn:
        while True:
            seqs = await asyncio.gather(*(conn.get_last_sequence(kp.public) for kp in clients))
            if all(s == want for s in seqs):
                return time.perf_counter() - t0
            check(time.perf_counter() - t0 < deadline_s,
                  f"node {i}: {sum(s != want for s in seqs)} clients short of sequence {want} "
                  f"after {deadline_s} s")
            await asyncio.sleep(0.1)


def store_line(net: ServerNet, label: str, history: int) -> list:
    """Each node's store counters and plane block, logged: the store must
    hold ``history`` committed bodies and have written segments (waiting
    up to three flush intervals for its next flush), and the plane's
    handoff drops must be 0."""
    out = []
    for i in range(net.n):
        t_end = time.perf_counter() + 3 * STORE_FLUSH_S
        while True:
            status = net.statusz(i)
            st = status["stats"]
            if st["store_segments_written"] > 0 or time.perf_counter() > t_end:
                break
            time.sleep(0.1)
        plane = status["plane"]
        dropped = net.metrics(i)["at2_plane_shard_effects_dropped"]
        check(dropped == 0, f"{label} node {i}: plane_shard_effects_dropped {dropped}")
        check(plane.get("shards") == PLANE_SHARDS and "worker_crashed" not in plane,
              f"{label} node {i}: plane block {plane}")
        row = {"store_flushes": st["store_flushes"], "store_segments_written": st["store_segments_written"],
               "store_segment_bytes": st["store_segment_bytes"], "store_gen": st["store_gen"],
               "store_history": st["store_history"], "plane": plane}
        check(row["store_segments_written"] > 0, f"{label} node {i}: the store wrote no segment")
        check(row["store_history"] == history,
              f"{label} node {i}: the store holds {row['store_history']} committed bodies, not {history}")
        log(f"{label} node {i}: store {row['store_flushes']} flushes, {row['store_segments_written']} "
            f"segments, {row['store_segment_bytes']} segment bytes, generation {row['store_gen']}, "
            f"{row['store_history']} committed bodies; plane {json.dumps(plane, sort_keys=True)}")
        out.append(row)
    return out


def launches_since(net: ServerNet, i: int, status0: dict, label: str) -> dict:
    """Node i's verify kernel launches and verifier batches since its
    ``/statusz`` snapshot ``status0`` (taken after its warm-up): a launch
    a batch, and at least one (the CPU kind has no batches)."""
    status = net.statusz(i)
    batches = status["stats"].get("verifier_batches", 0) - status0["stats"].get("verifier_batches", 0)
    if net.kind != "cuda":
        return {"batches": batches, "launches": 0}
    launches = status["build"]["kernel_launches"] - status0["build"]["kernel_launches"]
    check(batches > 0, f"{label} node {i}: the verifier dispatched no batch")
    check(launches == batches, f"{label} node {i}: {batches} batches, {launches} verify kernel launches")
    return {"batches": batches, "launches": launches}


def wal_records(store_dir: str) -> int:
    """The records in the WAL that the store's manifest names (read once
    its node is dead: the files are what a restart replays)."""
    from at2_node_tpu_torch.store.manifest import read_manifest
    from at2_node_tpu_torch.store.wal import replay

    doc = read_manifest(store_dir)
    check(doc is not None, f"no store manifest in {store_dir}")
    return sum(1 for _ in replay(os.path.join(store_dir, doc["wal"])))


STALL_KEYS = ("committed", "pending", "slots_undelivered", "inbox_depth", "delivered", "batch_rx",
              "batch_entries_delivered", "retransmits", "slots_dropped", "slots_retired",
              "poison_resolved", "entry_evictions", "invalid_sig")


async def stall_report(net: ServerNet, clients: list, want: int, label: str, store_dirs=None) -> None:
    """What a run that stopped short leaves to read, logged before it
    fails: each node's plane block and broadcast counters, its commit
    heap, the batch slots its plane still holds part-delivered
    (``/debugz`` ``plane_slots``), the clients it holds short of
    sequence ``want`` and the watermarks its store last flushed."""
    from at2_node_tpu_torch.client import Client
    from at2_node_tpu_torch.store.manifest import read_manifest

    for i in range(net.n):
        try:
            status = net.statusz(i)
            slots = json.loads(net.get(i, "/debugz")).get("plane_slots")
            async with Client(f"http://127.0.0.1:{net.rpc_ports[i]}") as conn:
                seqs = await asyncio.gather(*(conn.get_last_sequence(kp.public) for kp in clients))
        except Exception as exc:  # a dead node: report what the others hold
            log(f"{label} stall, node {i}: unreachable ({exc!r})")
            continue
        st = status["stats"]
        log(f"{label} stall, node {i}: plane {json.dumps(status.get('plane'), sort_keys=True)}; "
            + ", ".join(f"{k} {st.get(k)}" for k in STALL_KEYS))
        log(f"{label} stall, node {i}: clients short of sequence {want} (client: sequence) "
            f"{ {c: s for c, s in enumerate(seqs) if s != want} }")
        log(f"{label} stall, node {i}: part-delivered batch slots {json.dumps(slots, sort_keys=True)}")
        if store_dirs is not None:
            doc = read_manifest(store_dirs[i])
            log(f"{label} stall, node {i}: store watermarks (last flush) "
                f"{json.dumps(doc.get('watermarks') if doc else None, sort_keys=True)}")


async def restart_run(net: ServerNet, clients: list, rng, first_seq: int, per_client: int,
                      store0: str, card_line: str) -> dict:
    """9c: a quarter of run A's traffic. Its first half, but for the last
    RESTART_WAL_PER_CLIENT transfers a client, goes to every node and is
    flushed into node 0's segments; those last transfers go to nodes 1-3
    and node 0 is killed (SIGKILL) before its next flush (a small part,
    so that it commits within the flush interval), so what it committed
    of them lies in its WAL alone. The second
    half goes to nodes 1-3, node 0 restarts from its TOML and store
    directory (``store0``) and must replay its WAL whole, a last transfer
    a client goes to every node, and node 0 must reach every client's
    last sequence and the replay's ledger. Each node's verify kernel
    launches are counted from a snapshot after its warm-up: nodes 1-3
    from the start, node 0 from its restart's ``live``."""
    half = per_client // 2
    first = more_transfers(rng, clients, first_seq, half)
    second = more_transfers(rng, clients, first_seq + half, per_client - half)
    nudge = more_transfers(rng, clients, first_seq + per_client, 1)
    n = net.n
    label = "plane+store node net (9c, kill and restart)"
    to_peers = lambda c: c % n if c % n else 1 + c % (n - 1)  # noqa: E731
    status0 = [net.statusz(i) for i in range(n)]
    cut = half - min(half // 2, RESTART_WAL_PER_CLIENT)
    part1, part2 = [t[:cut] for t in first], [t[cut:] for t in first]
    before = [net.committed(i) for i in range(n)]
    seg0 = status0[0]["stats"]["store_segments_written"]
    await send_batched(net, clients, part1, lambda c: c % n)
    wait_committed(net, [b + sum(map(len, part1)) for b in before], NET_DEADLINE_S)
    # a flush of node 0's store that began after the first part had
    # committed: it folds its WAL into segments, and the next one begins a
    # flush interval after it ended, so after the last poll that did not
    # see it plus an interval
    t_quiet = t_wait = time.perf_counter()
    flushes = net.stats(0)["store_flushes"]
    while True:
        t_poll = time.perf_counter()
        st = net.stats(0)
        if st["store_flushes"] > flushes:
            break
        t_quiet = t_poll
        check(t_poll - t_wait < 5 * STORE_FLUSH_S, "node 0's store did not flush")
        time.sleep(0.02)
    check(st["store_segments_written"] > seg0, "node 0's store wrote no segment for the first part")
    flush_at = t_quiet + STORE_FLUSH_S  # node 0's next flush begins no sooner
    kill_by = flush_at - 0.1
    mid = [net.committed(i) for i in range(n)]
    await send_batched(net, clients, part2, to_peers)
    check(time.perf_counter() < kill_by,
          "the second part took longer to submit than node 0's store takes between flushes")
    want0 = mid[0] + sum(map(len, part2))
    while net.committed(0) < want0 and time.perf_counter() < kill_by:
        time.sleep(0.01)
    at_kill = net.committed(0) - mid[0]
    victim = net.procs[0].pid
    orphans = shard_workers(victim)
    t_kill = time.perf_counter()
    net.kill(0)
    check(t_kill < flush_at, f"node 0 was killed {t_kill - flush_at:.3f} s after its next flush could begin")
    wal_left = wal_records(store0)
    check(wal_left > 0, f"node 0 died with {at_kill} transfers of the second part committed and an "
                        f"empty WAL")
    # the orphaned shard workers see their owner gone and exit; then the
    # resource tracker they shared with it unlinks its rings
    while any(proc_alive(w) for w in orphans):
        check(time.perf_counter() - t_kill < 30, f"node 0's shard workers {orphans} outlived it")
        time.sleep(0.05)
    t_gone = time.perf_counter()
    while rings_of([victim]) and time.perf_counter() - t_gone < 10:
        time.sleep(0.05)
    stale = rings_of([victim])
    check(not stale, f"node 0's rings {stale} were left in /dev/shm 10 s after its workers exited")
    log(f"{label}: node 0 (pid {victim}) killed with SIGKILL {flush_at - t_kill:.3f} s before "
        f"its store's next flush could begin, with {at_kill} of the second part's "
        f"{sum(map(len, part2))} transfers committed and {wal_left} records in its WAL; its shard "
        f"workers {orphans} exited and its rings were gone from /dev/shm "
        f"{time.perf_counter() - t_kill:.3f} s after the kill")
    t_down = time.perf_counter()
    await send_batched(net, clients, second, to_peers)
    want = [None] + [mid[i] + (per_client - cut) * len(clients) for i in range(1, n)]
    pending = set(range(1, n))
    while pending:
        check(time.perf_counter() - t_down < NET_DEADLINE_S, f"nodes {sorted(pending)} stalled with node 0 down")
        pending = {i for i in pending if net.committed(i) < want[i]}
        time.sleep(NODE_POLL_S)
    down_s = time.perf_counter() - t_down
    # restart: the store is read before the RPC port binds, so the first
    # two recovery states are over by the time /statusz answers; its
    # recovery block counts them
    t_restart = time.perf_counter()
    net.restart(0)
    net.wait_rpc(0, t_restart + 180.0)
    rpc_s = time.perf_counter() - t_restart
    states = []
    while True:
        status = net.statusz(0)
        rec = status["recovery"]
        if not states or states[-1] != rec["state"]:
            states.append(rec["state"])
        if rec["state"] == "live":
            break
        check(time.perf_counter() - t_restart < 120, f"node 0 not live after 120 s: {rec}")
        time.sleep(0.05)
    live_s = time.perf_counter() - t_restart
    status0[0] = status
    order = ("cold", "loading_segments", "replaying_wal", "catchup", "live")
    check([order.index(x) for x in states] == sorted(order.index(x) for x in states),
          f"node 0's recovery states went {states}")
    check(rec["segments_loaded"] > 0, f"node 0 restarted without loading a segment: {rec}")
    check(rec["wal_records_replayed"] == wal_left,
          f"node 0 replayed {rec['wal_records_replayed']} WAL records, its WAL held {wal_left}")
    await send_batched(net, clients, nudge, lambda c: c % n)
    final_seq = first_seq + per_client
    catch_s = await wait_sequences(net, 0, clients, final_seq, NET_DEADLINE_S)
    for i in range(1, n):
        await wait_sequences(net, i, clients, final_seq, NET_DEADLINE_S)
    k1 = [launches_since(net, i, status0[i], label) for i in range(n)]
    log(f"{label}: node 0 restarted: RPC up {rpc_s:.3f} s after start, recovery states polled "
        f"{' -> '.join(states)}, live {live_s:.3f} s after start; recovery block "
        f"{json.dumps(rec, sort_keys=True)}; every client at sequence {final_seq} on node 0 "
        f"{catch_s:.3f} s after the last transfers; nodes 1-3 committed the second half in "
        f"{down_s:.3f} s with node 0 down; verify kernel launches a node {[k['launches'] for k in k1]} "
        f"(a launch a batch; node 0 since its restart went live, nodes 1-3 since the run began); "
        f"{card_line}")
    return {"transfers": len(clients) * (per_client + 1), "killed_at_part2": at_kill,
            "wal_records_at_kill": wal_left, "rpc_up_s": rpc_s, "live_s": live_s, "states": states,
            "recovery": rec, "catchup_s": catch_s, "down_commit_s": down_s, "nodes": k1,
            "per_client": [first[c] + second[c] + nudge[c] for c in range(len(clients))]}


async def plane_store_path(seed: int, by_lanes, card, card_line: str, kind: str = "cuda",
                           n_clients: int = NET_CLIENTS, per_batched: int = NET_PER_CLIENT_BATCHED,
                           restart_per_client: int = RESTART_PER_CLIENT) -> dict:
    """Phase 9: phase 6's net and run A's traffic (same seed) with
    ``[plane] shards = 2`` and ``[store] dir``: 9a the thread executor,
    9b the process executor, 9c 9b's config at thresholds of two peers,
    a kill and a restart."""
    import tempfile

    rng = np.random.default_rng(seed + 6)  # phase 6's: the same clients and run A
    clients, run_a, _, _ = node_traffic(rng, n_clients, per_batched, NET_PER_CLIENT_PER_TX,
                                        NODE_TAMPERED)
    check_shm_room(NET_NODES)
    out = {}
    # 9a and 9b keep phase 6's thresholds (all three peers); 9c runs a
    # crash-fault net (f = 1: two peers), which keeps committing while a
    # node is down
    for sub, executor, top in (("9a", "thread", ""), ("9b", "process", ""),
                               ("9c", "process", "echo_threshold = 2\nready_threshold = 2\n")):
        label = f"plane+store node net ({sub}, executor \"{executor}\")"
        with tempfile.TemporaryDirectory(prefix=f"at2-phase{sub}-") as workdir:
            def tables(i: int, executor=executor, workdir=workdir) -> str:
                return (f'[plane]\nshards = {PLANE_SHARDS}\nexecutor = "{executor}"\n'
                        f"ring_slots = {RING_SLOTS}\nring_slot_bytes = {RING_SLOT_BYTES}\n\n"
                        f'[store]\ndir = "{os.path.join(workdir, f"store{i}")}"\n'
                        f"flush_interval = {STORE_FLUSH_S}\n")

            net = ServerNet(kind, workdir, top=top, tables=tables)
            owners = set()  # every server pid of this net: the rings' owners
            t0 = time.perf_counter()
            try:
                net.start(deadline_s=180.0)
                owners.update(p.pid for p in net.procs)
                log(f"{label}: {net.n} `server run` processes, [plane] shards = {PLANE_SHARDS}, "
                    f"ring_slots = {RING_SLOTS}, [store] flush_interval = {STORE_FLUSH_S}"
                    + (", thresholds 2" if top else "")
                    + f", up and meshed in {time.perf_counter() - t0:.1f} s")
                workers = check_workers(net, label) if executor == "process" else None
                if sub == "9c":
                    res = await restart_run(net, clients, rng, 1, restart_per_client,
                                            os.path.join(workdir, "store0"), card_line)
                    owners.update(p.pid for p in net.procs)
                    await check_replay(net, clients, res.pop("per_client"))
                    log(f"{label}: {len(clients)} accounts equal the python-int replay on all "
                        f"{net.n} nodes, node 0 included")
                    name = "plane_store_restart"
                else:
                    try:
                        res = await node_run(net, label, clients, run_a, True, {}, per_batched,
                                             NET_DEADLINE_S)
                    except RuntimeError:
                        await stall_report(net, clients, per_batched, label,
                                           [os.path.join(workdir, f"store{i}") for i in range(net.n)])
                        raise
                    res = node_checks(net, res, by_lanes, card, kind, Counter())
                    await check_replay(net, clients, run_a)
                    busy = [p["kernel_busy_share"] for p in res["nodes"]]
                    log(f"{label}: {res['tx_per_s']:,.0f} tx/s committed; verify kernel launches a "
                        f"node {[p['launches'] for p in res['nodes']]}, kernel busy "
                        f"{[round(100 * b, 2) if b is not None else None for b in busy]}% "
                        f"(phase 3 times); {card_line}")
                    name = f"plane_store_{executor}"
                res["store"] = store_line(net, label, res["transfers"])
                res["workers"] = workers
                out[name] = res
            finally:
                rcs = net.stop()
            check(rcs == [0] * net.n, f"{label}: servers exited with {rcs} on SIGTERM")
            left = rings_of(owners)
            check(not left, f"{label}: rings left in /dev/shm after shutdown: {left}")
    return out


# -- phase 10 --------------------------------------------------------------


BROKER_PER_CLIENT = 256  # 10b: transfers a client through the broker
BROKER_MAX_ENTRIES = 1024  # the broker's --max-entries
CERT_DEADLINE_S = 30.0  # a certificate covers a node's frontier within this
WAIT_FINAL_S = 10.0  # Client.wait_final's timeout through node 1


def node_sign_keys(net: ServerNet) -> list:
    """The nodes' public sign keys, read from their TOMLs: what a light
    client knows from the genesis config, not from any node's answer."""
    from at2_node_tpu_torch.node.config import Config

    keys = []
    for path in net.tomls:
        with open(path) as f:
            keys.append(Config.loads(f.read()).sign_key.public)
    return keys


def certz(net: ServerNet, i: int) -> tuple:
    """Node i's ``/certz``: the document and its chain as Certificates."""
    from at2_node_tpu_torch.finality import Certificate

    doc = json.loads(net.get(i, "/certz"))
    return doc, [Certificate.from_doc(c) for c in doc["chain"]]


def certificate_lag(net: ServerNet, t_last: float, label: str) -> list:
    """Poll every node's ``/certz`` (every NODE_POLL_S) until its newest
    certificate covers its commit frontier; each node's seconds from
    ``t_last`` (the poll that saw the run's last commit) to the poll that
    saw that certificate."""
    lag = [None] * net.n
    t_end = time.perf_counter() + CERT_DEADLINE_S
    while None in lag:
        for i in range(net.n):
            if lag[i] is None:
                doc, chain = certz(net, i)
                if chain and chain[-1].commits >= doc["commits"]:
                    lag[i] = time.perf_counter() - t_last
        if None in lag:
            check(time.perf_counter() < t_end,
                  f"{label}: nodes {[i for i in range(net.n) if lag[i] is None]} hold no certificate "
                  f"covering their frontier {CERT_DEADLINE_S} s after the last commit")
            time.sleep(NODE_POLL_S)
    return lag


def finality_checks(net: ServerNet, keys: list, rng, label: str) -> dict:
    """Every node's chain: non-empty, its newest certificate at the node's
    commit frontier, the four newest certificates alike (one preimage),
    ``verify_chain`` ok under an f+1 light client of the genesis keys and
    under the full member list, refused by both once one co-signature
    byte of the newest certificate is flipped; no equivocation latched."""
    import dataclasses

    from at2_node_tpu_torch.finality import LightVerifier, verify_chain

    subset = LightVerifier(keys, total=net.n)
    full = LightVerifier([], members=keys)
    newest, lengths = [], []
    for i in range(net.n):
        doc, chain = certz(net, i)
        check(chain, f"{label} node {i}: empty certificate chain")
        check(chain[-1].commits == doc["commits"] == net.committed(i),
              f"{label} node {i}: newest certificate at {chain[-1].commits} commits, frontier "
              f"{doc['commits']}, committed {net.committed(i)}")
        for name, verifier in (("f+1", subset), ("full", full)):
            verdict = verify_chain(chain, verifier)
            check(verdict["ok"], f"{label} node {i}: {name} light client refuses the chain: {verdict}")
        sigs = bytearray(chain[-1].sigs)
        sigs[int(rng.integers(0, len(sigs)))] ^= 1 << int(rng.integers(0, 8))
        mutant = chain[:-1] + [dataclasses.replace(chain[-1], sigs=bytes(sigs))]
        strict = LightVerifier(keys, threshold=chain[-1].signer_count())
        for name, verifier in (("full", full), ("every-signer", strict)):
            check(not verify_chain(mutant, verifier)["ok"],
                  f"{label} node {i}: the {name} light client accepts a flipped co-signature byte")
        check(doc["equivocation"] is None, f"{label} node {i}: equivocation {doc['equivocation']}")
        eq = net.metrics(i)["at2_finality_equivocation"]
        check(eq == 0, f"{label} node {i}: finality_equivocation {eq}")
        newest.append(chain[-1])
        lengths.append(len(chain))
    check(len({c.commits for c in newest}) == 1 and len({c.preimage() for c in newest}) == 1,
          f"{label}: the newest certificates differ: {[(c.commits, c.wm_digest.hex()[:12]) for c in newest]}")
    return {"chain_len": lengths, "commits": newest[0].commits, "signers": [c.signer_count() for c in newest]}


def start_broker(net: ServerNet, workdir: str):
    """``tools/broker.py`` in front of node 0, as a process: its URL and
    the process once its port accepts."""
    port = free_ports(1)[0]
    argv = [sys.executable, "-m", "at2_node_tpu_torch.tools.broker",
            "--node", f"http://127.0.0.1:{net.rpc_ports[0]}", "--listen", f"127.0.0.1:{port}",
            "--max-entries", str(BROKER_MAX_ENTRIES)]
    with open(os.path.join(workdir, "broker.log"), "w") as out:
        proc = subprocess.Popen(argv, stdout=out, stderr=subprocess.STDOUT, env=checkout_env())
    t_end = time.perf_counter() + 60.0
    while not ServerNet._accepts(port):
        check(proc.poll() is None, f"the broker exited with {proc.returncode}")
        check(time.perf_counter() < t_end, "the broker's port never came up")
        time.sleep(0.05)
    return f"127.0.0.1:{port}", proc


def http_json(addr: str, path: str) -> dict:
    """GET ``path`` of the HTTP surface at ``addr`` as JSON (a 503 body too)."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://{addr}{path}", timeout=30) as r:
            return json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return json.loads(exc.read())


async def broker_run(net: ServerNet, broker: str, seed: int, rng, n_clients: int, per_client: int,
                     n_tampered: int) -> dict:
    """10b: ``tools/loadgen.py`` through the broker (``broker=True``,
    seeded clients, self-transfers of 1), then ``n_tampered`` transfers
    with a flipped signature byte through the broker's gRPC surface, at
    sequences no valid transfer takes."""
    import grpc

    from at2_node_tpu_torch.proto import at2_pb2 as pb
    from at2_node_tpu_torch.proto.rpc import At2Stub
    from at2_node_tpu_torch.tools import loadgen
    from at2_node_tpu_torch.types import transfer_signing_bytes

    total = n_clients * per_client
    clients = loadgen.client_keys(n_clients, seed)
    before = [net.statusz(i) for i in range(net.n)]
    rejected0 = net.metrics(0)["at2_rejected_at_ingress_total"]
    t0 = time.perf_counter()
    load = await loadgen.run_load([f"http://{broker}"], clients=n_clients, tx_per_client=per_client,
                                  broker=True, seed=seed, commit_timeout=NET_DEADLINE_S)
    check(load.submitted == load.committed == total,
          f"broker run: {load.submitted} submitted, {load.committed} of {total} committed")
    t_last = wait_committed(net, [b["stats"]["committed"] + total for b in before], NET_DEADLINE_S)
    wall = t_last - t0
    tampered = []
    for k in range(n_tampered):
        c = k % n_clients
        seq = per_client + 1 + k // n_clients
        recipient = clients[(c + 1) % n_clients].public
        sig = bytearray(clients[c].sign(transfer_signing_bytes(clients[c].public, seq, recipient, 1)))
        sig[int(rng.integers(0, 64))] ^= 1 << int(rng.integers(0, 8))
        tampered.append(pb.SendAssetRequest(sender=clients[c].public, sequence=seq,
                                            recipient=recipient, amount=1, signature=bytes(sig)))
    async with grpc.aio.insecure_channel(broker) as channel:
        stub = At2Stub(channel)
        for req in tampered:
            await stub.SendAsset(req)  # the broker takes it: only the node verifies
    t_end = time.perf_counter() + 10.0
    while net.metrics(0)["at2_rejected_at_ingress_total"] < rejected0 + n_tampered:
        check(time.perf_counter() < t_end,
              f"broker run: node 0 refused {net.metrics(0)['at2_rejected_at_ingress_total'] - rejected0} "
              f"of {n_tampered} tampered transfers in 10 s")
        await asyncio.sleep(NODE_POLL_S)
    return {"clients": clients, "transfers": total, "wall_s": wall, "tx_per_s": total / wall,
            "loadgen_tx_per_s": load.committed_tx_per_sec, "loadgen_commit_s": load.commit_seconds,
            "t_last": t_last, "before": before,
            "rejected": net.metrics(0)["at2_rejected_at_ingress_total"] - rejected0}


async def finality_broker_path(seed: int, by_lanes, card, card_line: str, kind: str = "cuda",
                               n_clients: int = NET_CLIENTS, per_batched: int = NET_PER_CLIENT_BATCHED,
                               broker_per_client: int = BROKER_PER_CLIENT,
                               n_tampered: int = NODE_TAMPERED, capture_to: str | None = None) -> dict:
    """Phase 10: phase 6's net with ``[finality] enabled`` (10a: run A,
    then the certificates), then a broker in front of node 0 (10b). With
    ``capture_to``, node 0's ``/capturez`` is written there at the end of
    10a, for phase 11c to replay in the sim."""
    import tempfile

    from at2_node_tpu_torch.client import Client
    from at2_node_tpu_torch.finality import LightVerifier
    from at2_node_tpu_torch.tools.trace_collect import stitch

    rng = np.random.default_rng(seed + 6)  # phase 6's: the same clients and run A
    clients, run_a, _, _ = node_traffic(rng, n_clients, per_batched, NET_PER_CLIENT_PER_TX, NODE_TAMPERED)
    rng = np.random.default_rng(seed + 10)
    out = {}
    with tempfile.TemporaryDirectory(prefix="at2-phase10-") as workdir:
        net = ServerNet(kind, workdir, tables=lambda i: "[finality]\nenabled = true\n")
        broker_proc = None
        t0 = time.perf_counter()
        try:
            net.start(deadline_s=180.0)
            keys = node_sign_keys(net)
            label = "finality node net (10a, SendAssetBatch)"
            log(f"{label}: {net.n} `server run` processes, [finality] enabled = true, audit_every 256 "
                f"(the default), up and meshed in {time.perf_counter() - t0:.1f} s")
            run = await node_run(net, label, clients, run_a, True, {}, per_batched, NET_DEADLINE_S)
            # a wallet's light client: the four genesis sign keys, any
            # f + 1 = 2 valid co-signatures
            light = LightVerifier(keys, total=net.n)
            t_final = time.perf_counter()

            async def wait_final():
                async with Client(f"http://127.0.0.1:{net.rpc_ports[1]}") as conn:
                    cert = await conn.wait_final(clients[0].public, per_batched, verifier=light,
                                                 timeout_s=WAIT_FINAL_S)
                    _, _, frontier, _ = await conn.get_certificates()
                return cert, frontier, time.perf_counter() - t_final

            (cert, frontier, final_s), lag = await asyncio.gather(
                wait_final(), asyncio.to_thread(certificate_lag, net, run["t_last"], label))
            check(cert.commits >= run["transfers"],
                  f"{label}: wait_final returned a certificate at {cert.commits} commits")
            res = node_checks(net, run, by_lanes, card, kind, Counter())
            await check_replay(net, clients, run_a)
            fin = finality_checks(net, keys, rng, label)
            res.update(certificate_lag_s=lag, wait_final_s=final_s, finality=fin)
            log(f"{label}: {res['tx_per_s']:,.0f} tx/s committed with [finality] enabled; certificate "
                f"lag (last commit to the certificate covering it) {[round(x, 3) for x in lag]} s a node; "
                f"chains of {fin['chain_len']} certificates, the newest at {fin['commits']} commits with "
                f"{fin['signers']} signers, one preimage on all {net.n} nodes, verified by an f+1 and a "
                f"full light client and refused with one co-signature byte flipped; Client.wait_final "
                f"through node 1 returned a certificate at {cert.commits} commits (frontier {frontier}) "
                f"in {final_s:.3f} s; verify kernel launches a node {[p['launches'] for p in res['nodes']]}; "
                f"{card_line}")
            out["net_finality"] = res
            if capture_to is not None:
                capture = net.get(0, "/capturez")
                with open(capture_to, "w") as f:
                    f.write(capture)
                log(f"{label}: node 0's /capturez ({len(json.loads(capture)['records'])} records, "
                    f"{len(capture):,} bytes) written for phase 11c")

            label = "broker node net (10b, loadgen --broker)"
            broker, broker_proc = start_broker(net, workdir)
            b = await broker_run(net, broker, seed + 11, rng, n_clients, broker_per_client, n_tampered)
            lag_b = certificate_lag(net, b["t_last"], label)
            check(b["rejected"] == n_tampered,
                  f"{label}: node 0 refused {b['rejected']} of {n_tampered} tampered transfers")
            await check_sequences(net, b["clients"], broker_per_client)
            await check_replay(net, b["clients"], [[(seq, kp.public, 1) for seq in
                                                   range(1, broker_per_client + 1)] for kp in b["clients"]])
            await check_replay(net, clients, run_a)
            k1 = [launches_since(net, i, b["before"][i], label) for i in range(net.n)]
            st0, st = b["before"][0]["stats"], net.stats(0)
            distilled = st["distilled_batches_rx"] - st0["distilled_batches_rx"]
            check(distilled > 0, f"{label}: node 0 took no distilled batch")
            bstat = http_json(broker, "/statusz")
            health = http_json(broker, "/healthz")
            check(bstat["stats"]["broker_entries_tx"] == b["transfers"] + n_tampered,
                  f"{label}: the broker forwarded {bstat['stats']['broker_entries_tx']} entries, "
                  f"not {b['transfers'] + n_tampered}")
            check(health["role"] == "broker" and health["status"] == "ok", f"{label}: broker /healthz {health}")
            dumps = [json.loads(net.get(i, "/tracez")) for i in range(net.n)] + [http_json(broker, "/tracez")]
            stitched = stitch(dumps)
            check(stitched["coverage"]["with_broker"] >= 1,
                  f"{label}: no transfer stitched across the broker hop: {stitched['coverage']}")
            fin_b = finality_checks(net, keys, rng, label)
            top = subprocess.run(
                [sys.executable, "-m", "at2_node_tpu_torch.tools.top", "--once", "--no-clear",
                 "--cert-lag-deadline", "0", *[f"127.0.0.1:{p}" for p in net.rpc_ports], broker],
                capture_output=True, text=True, env=checkout_env(), timeout=120)
            check(top.returncode == 0 and "final" in top.stdout,
                  f"{label}: top.py --once exited {top.returncode}: {top.stdout[-2000:]} {top.stderr[-2000:]}")
            hop = stitched.get("broker_hop", {}).get("segments", {})
            log(f"{label}: {b['transfers']} transfers from {n_clients} clients through the broker "
                f"(--max-entries {BROKER_MAX_ENTRIES}) committed on all {net.n} nodes in "
                f"{b['wall_s']:.3f} s = {b['tx_per_s']:,.0f} tx/s (loadgen's own window, after its "
                f"directory warm-up, to node 0 through the broker: {b['loadgen_tx_per_s']:,.0f} tx/s); "
                f"node 0 took {distilled} distilled batches and refused the {n_tampered} tampered "
                f"transfers; verify kernel launches a node {[x['launches'] for x in k1]} (= batches "
                f"{[x['batches'] for x in k1]}); the broker forwarded {bstat['stats']['broker_entries_tx']} "
                f"entries in {bstat['stats']['broker_batches_tx']} frames; {stitched['coverage']['with_broker']} "
                f"transfers stitched across the broker hop; certificate lag {[round(x, 3) for x in lag_b]} s "
                f"a node; {card_line}")
            log(f"{label}: broker hop segments {json.dumps(hop, sort_keys=True)}")
            log(f"{label}: top.py --once exited 0:")
            for line in top.stdout.rstrip().splitlines():
                log("  " + line)
            out["net_broker"] = {
                "launches": sum(x["launches"] for x in k1), "tx_per_s": b["tx_per_s"],
                "wall_s": b["wall_s"], "transfers": b["transfers"],
                "loadgen_tx_per_s": b["loadgen_tx_per_s"], "distilled_batches": distilled,
                "rejected": b["rejected"], "nodes": k1, "certificate_lag_s": lag_b,
                "broker_entries_tx": bstat["stats"]["broker_entries_tx"],
                "broker_batches_tx": bstat["stats"]["broker_batches_tx"],
                "with_broker": stitched["coverage"]["with_broker"], "finality": fin_b,
            }
        finally:
            brc = None
            if broker_proc is not None:
                import signal

                broker_proc.send_signal(signal.SIGINT)
                try:
                    brc = broker_proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    broker_proc.kill()
                    brc = broker_proc.wait()
            rcs = net.stop()
        check(rcs == [0] * net.n, f"phase 10: servers exited with {rcs} on SIGTERM")
        check(broker_proc is None or brc == 0, f"phase 10: the broker exited with {brc} on SIGINT")
        log("phase 10: every server exited 0 on SIGTERM, the broker 0 on SIGINT")
    return out


# -- phase 8 ---------------------------------------------------------------


def seam_lanes(n: int, shard_counts) -> list:
    """The lanes on both sides of every shard seam of every pool size: a
    pool of k pads n to a multiple of 8 k lanes and cuts it in k."""
    from at2_node_tpu_torch.parallel import pool

    lanes = set()
    for k in shard_counts:
        q = pool._pool_quantum(k)
        per = -(-n // q) * q // k
        for s in range(per, n, per):
            lanes.update((s - 1, s))
    return sorted(lanes)


def pool_launch_ms(torch, host, devs, streams, reps: int) -> float:
    """The whole pool launch on the device clock: every shard's upload,
    kernel and copy back, each shard on its streams, from an event that
    every stream waits for to one recorded after every shard's last copy;
    the mean over ``reps`` launches."""
    from at2_node_tpu_torch.parallel import pool

    cur = torch.cuda.current_stream()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(cur)
    for copy_s, compute_s in streams:
        copy_s.wait_event(start)
        compute_s.wait_event(start)
    for _ in range(reps):
        handles = pool.verify_sharded_packed(host, devs, streams)
    for h in handles:
        cur.wait_event(h.done)
    end.record(cur)
    end.synchronize()
    return start.elapsed_time(end) / reps


def pool_vs_kernel(torch, mat: Material, rng, by_lanes: dict) -> dict:
    """Phase 8a: pools of POOL_SHARDS shards on cuda:0 against the verify
    kernel, its plain version on the card and the expected verdicts, at
    phase 3's shapes; the pool's launch timed at POOL_TIMED_LANES."""
    from at2_node_tpu_torch.ops import cuda_verify
    from at2_node_tpu_torch.ops import ed25519 as v
    from at2_node_tpu_torch.parallel import pool

    pools = {k: pool.make_pool_devices(["cuda:0"] * k) for k in POOL_SHARDS}
    streams = {k: pool.shard_streams(devs) for k, devs in pools.items()}
    mismatches, max_err = 0, 0
    by_shards: dict = {}
    plain_ms: dict = {}
    for n in KERNEL_LANES:
        items, expect, pad = mat.batch(n, rng)
        seams = seam_lanes(n, POOL_SHARDS)
        for j, lane in enumerate(seams):  # a tampered lane each side of a seam
            items[lane] = mat.tampered["r_flip" if j % 2 else "s_flip"][j % len(mat.tampered["r_flip"])]
            expect[lane], pad[lane] = False, False
        rows = np.empty((n, v.PACKED_WIDTH), dtype=np.uint8)
        v.fill_packed([i[0] for i in items], [i[1] for i in items], [i[2] for i in items], rows)
        rows[pad, 128] = 0
        dev = torch.from_numpy(rows).cuda()
        k1_bytes = cuda_verify.verify_packed(dev).cpu().numpy()
        plain = v.verify_packed(dev).cpu().numpy()
        k1 = np.unpackbits(k1_bytes, count=n).astype(bool)
        p_bits = np.unpackbits(plain, count=n).astype(bool)
        line = []
        for k, devs in pools.items():
            q = pool._pool_quantum(k)
            padded = np.zeros((-(-n // q) * q, v.PACKED_WIDTH), dtype=np.uint8)
            padded[:n] = rows
            host = torch.from_numpy(padded).pin_memory()
            bits = pool.finish_sharded(pool.verify_sharded_packed(host, devs, streams[k]))
            ok = np.unpackbits(bits, count=padded.shape[0]).astype(bool)
            _, count = pool.verify_and_count(host, devs, streams[k])
            bad = int((ok[:n] != k1).sum() + (ok[:n] != p_bits).sum() + (ok[:n] != expect).sum()
                      + ok[n:].sum()) + int(count != int(ok.sum()))
            err = int(np.abs(bits[:len(k1_bytes)].astype(int) - k1_bytes.astype(int)).max())
            mismatches += bad
            max_err = max(max_err, err)
            line.append(f"{k} shard{'s' if k > 1 else ''}: {bad}")
            if n in POOL_TIMED_LANES:
                reps = max(3, min(50, 200_000 // n))
                pool_launch_ms(torch, host, devs, streams[k], reps)  # warm the allocators
                ms = pool_launch_ms(torch, host, devs, streams[k], reps)
                by_shards.setdefault(n, {})[k] = ms
        log(f"pool vs kernel {n:6d} lanes ({len(seams)} seam lanes tampered): mismatches by pool "
            f"size {', '.join(line)}; count = popcount")
        if n in POOL_TIMED_LANES:
            reps = max(3, min(50, 200_000 // n))
            k1_ms = cuda_ms(torch, lambda: cuda_verify.verify_packed(dev), reps)
            by_shards[n]["k1_kernel_ms"] = k1_ms
            if n == max(POOL_TIMED_LANES):
                # the pool's plain version: the plain verify of each shard
                for k in POOL_SHARDS:
                    shards = [s.contiguous() for s in dev.chunk(k)]
                    plain_ms[k] = cuda_ms(torch, lambda: [v.verify_packed(s) for s in shards], 1)
                log(f"pool plain version {n:6d} lanes (the plain verify a shard, on the card): "
                    + ", ".join(f"{k} shard{'s' if k > 1 else ''} {ms:.1f} ms"
                                for k, ms in plain_ms.items()))
            log(f"pool launch {n:6d} lanes (uploads, kernels, copies back; CUDA events): "
                + ", ".join(f"{k} shard{'s' if k > 1 else ''} {by_shards[n][k]:.3f} ms"
                            for k in POOL_SHARDS)
                + f"; the kernel alone on rows already on the card {k1_ms:.3f} ms "
                f"(bound {by_lanes[n]['bound_ms']:.3f} ms)")
    check(mismatches == 0, f"pool, verify kernel, plain version and expected verdicts differ: {mismatches}")
    return {"mismatches": mismatches, "max_abs_err": max_err, "by_shards": by_shards,
            "plain_ms": plain_ms}


def replay_phase() -> dict:
    """Phase 8b: the 1M replay through the pool of one shard on cuda:0; the
    verify kernel's launch count is set to 0 just before and read just
    after (the warm-up batch included)."""
    from at2_node_tpu_torch.ops import cuda_verify
    from at2_node_tpu_torch.tools import scale_demo

    cuda_verify.launches = 0
    out = scale_demo._phase_replay(REPLAY_SIGNATURES, bucket=REPLAY_BUCKET, devices=["cuda:0"])
    launches = cuda_verify.launches
    rounds = REPLAY_SIGNATURES // REPLAY_BUCKET
    check(out["replayed_signatures"] == REPLAY_SIGNATURES == out["verified_ok"],
          f"replay: {out['verified_ok']} of {out['replayed_signatures']} verified")
    check(launches == rounds + 1, f"replay: {launches} kernel launches for {rounds} + 1 batches")
    log(f"replay: {out['verified_ok']:,} of {REPLAY_SIGNATURES:,} signatures verified through the pool "
        f"of 1 in {out['seconds']:.3f} s = {out['verifies_per_sec']:,.0f} sigs/s (host clock, "
        f"{REPLAY_BUCKET}-lane buckets, host prep included); {launches} kernel launches")
    return {**out, "launches": launches}


async def scale_net_phase(seed: int, by_lanes: dict) -> dict:
    """Phase 8c: 32 in-process nodes behind one pool built from the
    ``[verifier] kind = "pool"`` table. The kernel's launch count is set to
    0 just before and read just after (the pool's warm-up included)."""
    import logging
    import resource

    from at2_node_tpu_torch.ops import cuda_verify
    from at2_node_tpu_torch.tools import _common, scale_demo

    need = scale_demo.open_files_needed(SCALE_NODES)
    soft0, hard0 = resource.getrlimit(resource.RLIMIT_NOFILE)
    soft, hard = scale_demo.raise_open_files(need)
    log(f"scale net: open-file limit {soft0} (hard {hard0}) raised to {soft}; "
        f"{SCALE_NODES} nodes need about {need}; ephemeral ports {_common.ephemeral_range()}, "
        f"the nodes listen outside them where there is room")
    # loadgen's transfers go to their sender: the ledger notes each one
    logging.getLogger("at2_node_tpu_torch.ledger.accounts").setLevel(logging.ERROR)
    f = (SCALE_NODES - 1) // 3
    cuda_verify.launches = 0
    net = await scale_demo._phase_net(
        SCALE_NODES, SCALE_CLIENTS, SCALE_PER_CLIENT, 2 * f + 1, pool_batch=SCALE_POOL_BATCH,
        seed=seed + 8, commit_timeout=SCALE_DEADLINE_S)
    launches = cuda_verify.launches
    want = SCALE_CLIENTS * SCALE_PER_CLIENT
    shards = len(net["pool_devices"])
    check(net["committed"] == net["submitted"] == want,
          f"scale net: {net['committed']} of {want} transfers committed")
    check(net["ledgers_equal_replay_on_all_nodes"], "scale net: a ledger differs from the replay")
    check(net["pool_batches"] > 0, "scale net: the pool dispatched no batch")
    check(net["kernel_launches"] == net["pool_batches"] * shards,
          f"scale net: {net['pool_batches']} batches x {shards} shards but "
          f"{net['kernel_launches']} kernel launches")
    shard_lanes = SCALE_POOL_BATCH // shards
    busy = (net["kernel_launches_in_window"] * by_lanes[shard_lanes]["ms"]
            / (1e3 * net["commit_seconds"]))
    log(f"scale net: {want} transfers from {SCALE_CLIENTS} clients committed on all {SCALE_NODES} "
        f"nodes (thresholds {2 * f + 1}; the net came up at start {net['net_starts']}) in "
        f"{net['commit_seconds']:.3f} s = "
        f"{net['committed_tx_per_sec']:,.1f} tx/s (first submission to the last sequence read on the "
        f"last node; every ledger equal to the replay {net['all_nodes_extra_seconds']:.3f} s later); "
        f"pool {net['pool_devices']}: {net['pool_batches']} batches, {net['pool_signatures']:,} "
        f"signatures, occupancy {net['pool_batch_occupancy']:.4f}, dispatch {net['pool_avg_dispatch_ms']:.3f} "
        f"ms a batch (counted once the pool settled); {net['kernel_launches_in_window']} kernel launches in the window, "
        f"{net['kernel_launches']} once settled, {launches} with the warm-up; kernel busy "
        f"{100 * busy:.2f}% of the window (phase 3 times)")
    return {**net, "launches": launches, "kernel_busy_share": busy,
            "open_files": {"soft_before": soft0, "soft": soft, "hard": hard, "need": need}}


def entry_phase(torch) -> dict:
    """Phase 8d: the entry's function on its example arguments on the card,
    then the dry run over four shards of cuda:0. The kernel's launch count
    is set to 0 just before and read just after."""
    from at2_node_tpu_torch import entry
    from at2_node_tpu_torch.ops import cuda_verify

    cuda_verify.launches = 0
    fn, args = entry.entry()
    check(all(a.device.type == "cuda" for a in args), "entry's example arguments are not on the card")
    bits = fn(*args)
    torch.cuda.synchronize()
    ok = np.unpackbits(bits.cpu().numpy(), count=args[0].shape[0]).astype(bool)
    check((ok == entry._expected(8, args[0].shape[0])).all(), f"entry: verdicts {ok.tolist()}")
    entry.dryrun_multichip(4, devices=["cuda:0"] * 4)
    launches = cuda_verify.launches
    check(launches == 1 + 4, f"entry and dry run: {launches} kernel launches, expected 5")
    log(f"entry: the verify kernel on 8 real lanes (lane 1 tampered) in a 64-row bucket gave the "
        f"expected verdicts; dryrun_multichip(4) over cuda:0 x 4 passed; {launches} kernel launches")
    return {"launches": launches}


def pool_path(torch, mat: Material, rng, seed: int, by_lanes: dict) -> dict:
    t0 = time.perf_counter()
    cmp = pool_vs_kernel(torch, mat, rng, by_lanes)
    replay = replay_phase()
    net = asyncio.run(scale_net_phase(seed, by_lanes))
    ent = entry_phase(torch)
    log(f"phase 8 (the device pool, BASELINE config 5) took {time.perf_counter() - t0:.1f} s")
    return {"compare": cmp, "replay": replay, "scale_net": net, "entry": ent}


# -- phase 11 --------------------------------------------------------------


# The sim gates of the reference's scripts/ci.sh and what the JAX package's
# CLIs print for them under PYTHONHASHSEED=0 (the full grid is the hash that
# BENCH_SCENARIOS.json banks). The port's CLIs must print the same. "short"
# gates also run in the tests on the CPU; "runs" is how often phase 11 runs
# each (twice where scripts/ci.sh checks that a seed reproduces its hash).
SIM_GATES = {
    "determinism": {
        "ci": "scripts/ci.sh:61-77", "tool": "sim_run", "argv": ("--seed", "7", "--episodes", "3"),
        "hash": "3a2947ccb595d15502516cf2a87cec418284cdbb82c6fc2a9db5a6f0305fb39b", "runs": 2, "short": True},
    "campaign": {
        "ci": "scripts/ci.sh:108-114", "tool": "sim_run", "argv": ("--seed", "1", "--episodes", "50"),
        "hash": "21ee6382d32a3ff9217e1fb10f72cde27e9f3c946fb60a62649f6786de3a3578", "runs": 1, "short": False},
    "broker": {
        "ci": "scripts/ci.sh:124-142", "tool": "sim_run", "argv": ("--seed", "11", "--episodes", "5", "--broker"),
        "hash": "858512b61c24ef5aecc8b5e821786f5cd911730d7379c9509914638e8f51a9ac", "runs": 2, "short": True},
    "restart": {
        "ci": "scripts/ci.sh:144-163", "tool": "sim_run",
        "argv": ("--seed", "13", "--episodes", "4", "--durability"),
        "hash": "70c4ae793a812572bb427f402b34e07c50f4706622fb6c4ce87db96f8128bb0a", "runs": 2, "short": True},
    "salting": {
        "ci": "scripts/ci.sh:165-188", "tool": "sim_run", "argv": ("--seed", "7", "--episodes", "3", "--salting"),
        "hash": "018ec3d9a7659dd67c45d172ae86360600324847d8ddcfb991d7d731da2e2f3e", "runs": 2, "short": True},
    "grid_smoke": {
        "ci": "scripts/ci.sh:190-206", "tool": "scenario_grid",
        "argv": ("--seed", "7", "--smoke", "--txs", "24", "--duration", "8"),
        "hash": "0833303a755eecd97dea660db52abe3ee32da403ada454760ff5329d3371eb26", "runs": 2, "short": True},
    "grid_full": {
        "ci": "BENCH_SCENARIOS.json", "tool": "scenario_grid", "argv": ("--seed", "1"),
        "hash": "45c99be73b3bb8dbe48d8f16a0818bf4c2b2cd334e4bd019cd13ffcbd9a6cc1c", "runs": 1, "short": False},
    "wan_steady": {
        "ci": "scripts/ci.sh:208-243", "tool": "scenario_grid",
        "argv": ("--seed", "7", "--replay", "wan3/steady/none+wan", "--txs", "24", "--duration", "8", "--json"),
        "hash": "066b7d9b3db0e231ee92adddb6ad8970cfd26d72b78f5850b2c6b506d51586f1", "p99_ms": 307.873,
        "runs": 2, "short": True},
    "wan_cut": {
        "ci": "scripts/ci.sh:208-243", "tool": "scenario_grid",
        "argv": ("--seed", "7", "--replay", "wan3/steady/cut+wan", "--txs", "24", "--duration", "8", "--json"),
        "hash": "67c93ae0c81681459443d0dd9a0d7e1caa9b565a309179944a64a16ba70bca1c", "p99_ms": 507.459,
        "runs": 2, "short": True},
    "overload": {
        "ci": "scripts/ci.sh:245-284", "tool": "overload_ab",
        "argv": ("--seed", "5", "--clients", "60", "--crowd", "40", "--txs", "80", "--workload", "flash_crowd",
                 "--quiet", "--json"),
        "hash": "831c18351bc94c47ce01dd1f954881a1387726f26a260fb4bf26c8276b2f51ca", "runs": 2, "short": True},
}
# scripts/ci.sh's bar for the WAN steady cell with the [wan] levers on
SIM_WAN_P99_MS = 1000.0
# bench_finality at its defaults (4 nodes, 48 transfers, audit_every 8,
# seed 7): the reference's production block and wire bytes
SIM_FINALITY = {
    "production": {"certificates": 24, "certified": 48, "frontier": 48, "lag_p50_s": 0.05,
                   "lag_p99_s": 0.05, "lag_samples": 24, "violations": []},
    "cert_wire_bytes": 369,
    "cosig_wire_bytes": 265,
}
# the planted-breach artifact check of scripts/ci.sh:79-106, on the port
SIM_BREACH_CHECK = """
from at2_node_tpu_torch.sim.campaign import planted_breach_episode

r = planted_breach_episode(20260805)
assert r.violations, "planted breach must violate invariants"
obs = r.obs
assert obs is not None, "failing episode must attach obs artifact"
recs = obs["recorders"]
assert len(recs) == 4, f"want 4 recorder dumps, got {len(recs)}"
for dump in recs:
    assert dump["recorder"]["events"], f"node {dump['node']}: empty flight-recorder ring"
offending = [tx for tx in obs["stitched"]["txs"] if tx["seq"] == 1]
assert offending, "stitched timeline must contain the offending tx"
assert offending[0]["nodes"] >= 2, "timeline must span multiple nodes"
assert offending[0]["stragglers"], "straggler attribution missing"
print(len(r.violations), offending[0]["nodes"])
"""
SIM_WORKERS = 4  # sim processes at once on the card's machine's 8 cores
SIM_TIMEOUT_S = 600


def sim_tool(module: str, argv) -> dict:
    """One port sim CLI run as a user runs it: ``python -m`` from this
    checkout, the hash seed left to the tool (it re-executes itself under
    PYTHONHASHSEED=0)."""
    env = checkout_env()
    env.pop("PYTHONHASHSEED", None)
    cmd = [sys.executable, "-m", module, *argv] if module else [sys.executable, *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=SIM_TIMEOUT_S)
    return {"rc": proc.returncode, "out": proc.stdout, "err": proc.stderr, "s": time.perf_counter() - t0}


def sim_gate_result(name: str, run: dict) -> dict:
    """A gate run's hash and its own verdict; raises unless the run passed
    its tool's own bar (exit 0, no failing episode, no breaching cell)."""
    gate = SIM_GATES[name]
    tail = f"{run['out'][-1500:]} {run['err'][-1500:]}"
    check(run["rc"] == 0, f"sim gate {name}: exit {run['rc']}: {tail}")
    if gate["tool"] == "sim_run":
        m = re.search(r"(\d+) failures, hash ([0-9a-f]{64})", run["out"])
        check(m is not None and m.group(1) == "0", f"sim gate {name}: {tail}")
        return {"hash": m.group(2)}
    if gate["tool"] == "overload_ab":
        doc = json.loads(run["out"])
        check(doc["ok"], f"sim gate {name}: the A/B claim failed: {tail}")
        arms = {c["arm"]: c for c in doc["cells"]}
        return {"hash": doc["ab_hash"], "arms": {a: {"steady_p99_ms": c["steady_p99_ms"], "slo_ok": c["slo_ok"],
                                                     "shed": c["shed"], "committed": c["committed"],
                                                     "offered": c["offered"]} for a, c in arms.items()}}
    if "--replay" in gate["argv"]:
        cell = json.loads(run["out"])
        check(not cell["violations"] and cell["slo"]["ok"], f"sim gate {name}: {tail}")
        return {"hash": cell["trace_hash"], "p99_ms": cell["latency_p99_ms"],
                "committed": cell["committed"], "offered": cell["offered"]}
    m = re.search(r"(\d+) cells, (\d+) breaching, hash ([0-9a-f]{64})", run["out"])
    check(m is not None and m.group(2) == "0", f"sim gate {name}: {tail}")
    return {"hash": m.group(3), "cells": int(m.group(1))}


def capture_kinds(path: str) -> tuple:
    """A /capturez dump's record count and its messages counted by kind
    name: a frame may coalesce many messages, and a record's kind is its
    first message's."""
    from at2_node_tpu_torch.broadcast import messages as m

    names = {getattr(m, k): k for k in ("GOSSIP", "ECHO", "READY", "REQUEST", "HIST_IDX_REQ", "HIST_IDX",
                                        "HIST_REQ", "HIST_BATCH", "BATCH", "BATCH_ECHO", "BATCH_READY",
                                        "BATCH_REQ", "DIR_ANNOUNCE", "CONFIG_TX", "BEACON", "CERT_SIG")}
    with open(path) as f:
        records = json.load(f)["records"]
    kinds: Counter = Counter()
    for r in records:
        for msg in m.parse_frame(bytes.fromhex(r[3])):
            kind = msg.encode()[0]
            kinds[names.get(kind, f"kind {kind}")] += 1
    return len(records), kinds


def sim_path(capture: str | None, card: str) -> dict:
    """Phase 11: the port's deterministic simulator through its five CLIs,
    each a subprocess, SIM_WORKERS at a time. 11a the campaigns and the
    planted breach, 11b the grids and the overload A/B, 11c phase 10a's
    capture replayed, 11d bench_finality; every hash against SIM_GATES."""
    t0 = time.perf_counter()
    jobs = {}
    for name, gate in SIM_GATES.items():
        for k in range(gate["runs"]):
            jobs[(name, k)] = (f"at2_node_tpu_torch.tools.{gate['tool']}", gate["argv"])
    jobs[("breach", 0)] = (None, ("-c", SIM_BREACH_CHECK))
    if capture is not None:
        jobs[("capture", 0)] = ("at2_node_tpu_torch.tools.capture_replay", (capture, "--repeat", "2", "--json"))
    jobs[("finality", 0)] = ("at2_node_tpu_torch.tools.bench_finality", ())
    # the longest first, so the pool ends together
    order = sorted(jobs, key=lambda j: j[0] not in ("campaign", "grid_full"))
    with ThreadPoolExecutor(max_workers=SIM_WORKERS) as ex:
        futs = {j: ex.submit(sim_tool, *jobs[j]) for j in order}
        runs = {j: f.result() for j, f in futs.items()}
    out: dict = {"gates": {}, "seconds": {}}

    for name, gate in SIM_GATES.items():
        res = [sim_gate_result(name, runs[(name, k)]) for k in range(gate["runs"])]
        hashes = [r["hash"] for r in res]
        secs = [runs[(name, k)]["s"] for k in range(gate["runs"])]
        check(len(set(hashes)) == 1, f"sim gate {name}: the same seed gave {hashes}")
        check(hashes[0] == gate["hash"], f"sim gate {name}: hash {hashes[0]}, the reference's {gate['hash']}")
        extra = ""
        if "p99_ms" in gate:
            check(all(r["p99_ms"] == gate["p99_ms"] for r in res), f"sim gate {name}: p99 {res}")
            check(all(r["committed"] == r["offered"] for r in res), f"sim gate {name}: lost transfers {res}")
            extra = f"; p99 {res[0]['p99_ms']} ms, {res[0]['committed']}/{res[0]['offered']} committed"
            if name == "wan_steady":
                check(res[0]["p99_ms"] < SIM_WAN_P99_MS, f"sim gate {name}: p99 {res[0]['p99_ms']} ms")
                extra += f" (< {SIM_WAN_P99_MS:.0f} ms)"
        if "arms" in res[0]:
            arms = res[0]["arms"]
            check(not arms["uncontrolled"]["slo_ok"] and arms["controlled"]["slo_ok"],
                  f"sim gate {name}: the arms {arms}")
            extra = ("; uncontrolled arm breaches (steady p99 "
                     f"{arms['uncontrolled']['steady_p99_ms']} ms), controlled arm holds (steady p99 "
                     f"{arms['controlled']['steady_p99_ms']} ms, shed {arms['controlled']['shed']})")
        if "cells" in res[0]:
            extra = f"; {res[0]['cells']} cells, none breaching"
        out["gates"][name] = {"hash": hashes[0], "runs": gate["runs"], **{k: v for k, v in res[0].items()
                                                                          if k != "hash"}}
        out["seconds"][name] = secs
        log(f"sim {name} ({gate['ci']}): {gate['tool']} {' '.join(gate['argv'])}: exit 0, hash "
            f"{hashes[0][:16]}… = the reference's"
            + (f", {gate['runs']} runs alike" if gate["runs"] > 1 else "")
            + f"{extra}; {', '.join(f'{s:.1f}' for s in secs)} s")

    br = runs[("breach", 0)]
    check(br["rc"] == 0, f"sim planted breach: exit {br['rc']}: {br['err'][-3000:]}")
    n_viol, n_nodes = (int(x) for x in br["out"].split())
    out["gates"]["planted_breach"] = {"violations": n_viol, "offending_tx_nodes": n_nodes}
    out["seconds"]["planted_breach"] = [br["s"]]
    log(f"sim planted breach (scripts/ci.sh:79-106): planted_breach_episode(20260805) gave {n_viol} "
        f"violations, 4 flight-recorder dumps and the offending transfer stitched across {n_nodes} nodes; "
        f"{br['s']:.1f} s")

    if capture is not None:
        cr = runs[("capture", 0)]
        check(cr["rc"] == 0, f"sim capture replay: exit {cr['rc']}: {cr['err'][-3000:]}")
        verdict = json.loads(cr["out"])
        check(verdict["deterministic"], f"sim capture replay: two replays differ: {cr['err'][-2000:]}")
        check(not verdict["violations"], f"sim capture replay: violations {verdict['violations']}")
        n_records, kinds = capture_kinds(capture)
        for what, names in (("payload", ("GOSSIP", "BATCH")), ("echo", ("ECHO", "BATCH_ECHO")),
                            ("ready", ("READY", "BATCH_READY")), ("co-signature", ("CERT_SIG",))):
            check(any(kinds[n] for n in names), f"sim capture replay: no {what} message in {dict(kinds)}")
        out["capture"] = {"records": n_records, "messages": dict(kinds),
                          "verdict_sha256": verdict["verdict_sha256"], "injected": verdict["injected"],
                          "committed": verdict["committed"]}
        out["seconds"]["capture"] = [cr["s"]]
        log(f"sim capture replay (11c): node 0's /capturez from phase 10a ({n_records} records holding "
            f"{', '.join(f'{k} {c}' for k, c in sorted(kinds.items()))}) replayed twice into a fresh 4-node "
            f"sim by capture_replay --repeat 2: verdict {verdict['verdict_sha256'][:16]}… both times, no "
            f"invariant violation, committed {verdict['committed']}; {cr['s']:.1f} s")

    fb = runs[("finality", 0)]
    check(fb["rc"] == 0, f"sim bench_finality: exit {fb['rc']}: {fb['err'][-3000:]}")
    doc = json.loads(fb["out"])
    for key, want in SIM_FINALITY.items():
        check(doc[key] == want, f"sim bench_finality: {key} {doc[key]}, the reference's {want}")
    out["finality"] = {**SIM_FINALITY, "verify": doc["verify"]}
    out["seconds"]["finality"] = [fb["s"]]
    prod = doc["production"]
    log(f"sim bench_finality (11d, defaults): {prod['certificates']} certificates, lag p50 "
        f"{prod['lag_p50_s']} s p99 {prod['lag_p99_s']} s (virtual), a {doc['cert_wire_bytes']} B certificate "
        f"and a {doc['cosig_wire_bytes']} B co-signature = the reference's; light-client verify "
        f"{doc['verify']['subset_per_s']}/s (f+1 subset) and {doc['verify']['full_per_s']}/s (full member "
        f"list) on the host CPU of the card's machine ({card}); {fb['s']:.1f} s")
    out["phase_s"] = time.perf_counter() - t0
    log(f"phase 11 (the deterministic simulator) took {out['phase_s']:.1f} s, {SIM_WORKERS} sim processes "
        f"at a time on the host CPU; {card}")
    return out


# -- phase 12 --------------------------------------------------------------


TOOLS_TRIALS = 3  # 12a and 12d's --compose: verify_bench's trials (its default)
TOOLS_AGG_ROUNDS = 1  # 12b: the default grid at reduced --rounds (the tool's: 3)
TOOLS_PROFILE_S = 5.0  # 12e: profile_collect --duration
TOOLS_PROFILE_CHUNK = 256  # 12e: transfers a client sends a SendAssetBatch call
TOOLS_PROFILE_MAX_CHUNKS = 32  # 12e: a client's cap while the window is open
# the reference's thresholds for the plane gates (scripts/ci.sh:381-508):
# printed beside the measurement, not gated on here
OBS_BUDGET_PCT = 5.0
SHARD_SPEEDUP_MIN = 1.5
E2E_SIZE: list = []  # 12d: e2e_bench's size flags (empty: its defaults, 16 clients x 50)


def zero_launch_counts() -> None:
    from at2_node_tpu_torch.ops import cuda_rlc, cuda_verify

    cuda_verify.launches = 0
    cuda_rlc.launches = cuda_rlc.fold_launches = 0
    cuda_rlc.layout_launches = [0, 0]


def launch_counts() -> Counter:
    """This process's kernel launches since :func:`zero_launch_counts`."""
    from at2_node_tpu_torch.ops import cuda_rlc, cuda_verify

    return Counter({"ed25519_verify": cuda_verify.launches, "ed25519_rlc_lanes": cuda_rlc.launches,
                    "ed25519_rlc_fold": cuda_rlc.fold_launches})


def quiet(fn, *args):
    """``fn(*args)`` with its standard output captured: (result, text)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = fn(*args)
    return result, buf.getvalue()


def write_json(path: str, doc: dict) -> None:
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")


def tools_verify(outdir: str, card: str, device: str = "cuda") -> dict:
    """12a: ``verify_bench`` at its three buckets; each bucket's bitmask
    must equal the plain version's on the card and the expected one (the
    tool's batches are all valid)."""
    from at2_node_tpu_torch.ops import ed25519 as v
    from at2_node_tpu_torch.tools import verify_bench

    t0 = time.perf_counter()
    zero_launch_counts()
    result, bitmasks = verify_bench.run(device, verify_bench.GRID, TOOLS_TRIALS)
    launches = launch_counts()
    mismatches = 0
    for bucket in verify_bench.GRID:
        pks, msgs, sigs = verify_bench._make_batch(bucket)
        rows = v.prep_packed(pks, msgs, sigs, bucket, v.StagingPool(pinned=False))
        plain = np.unpackbits(v.verify_packed(rows.to(device)).cpu().numpy(), count=bucket).astype(bool)
        got = np.unpackbits(bitmasks[bucket], count=bucket).astype(bool)
        mismatches += int(np.count_nonzero(got != plain)) + int(np.count_nonzero(~plain))
    check(mismatches == 0, f"verify_bench (12a): kernel, plain version and expected verdicts differ on "
          f"{mismatches} lanes")
    check(launches["ed25519_verify"] > 0 or device != "cuda", "verify_bench (12a) launched no verify kernel")
    write_json(os.path.join(outdir, "BENCH_r01.json"),
               {"cmd": "python -m at2_node_tpu_torch.tools.verify_bench", "rc": 0, "parsed": result})
    for bucket, row in result["grid"].items():
        log(f"verify_bench (12a) {bucket} lanes: device_only {row['device_only']:,.1f} sigs/s, pipelined "
            f"{row['pipelined']:,.1f} sigs/s ({row['pipelined_vs_device_pct']}%); {row['card']}")
    log(f"verify_bench (12a): {result['value']:,.1f} sigs/s at {result['bucket']} lanes, vs_baseline "
        f"{result['vs_baseline']} (BASELINE.json's 50,000); host prep {result['host_prep_rate']:,.1f}/s, "
        f"OpenSSL {result['cpu_openssl_1core_rate']:,.1f}/s a core; bitmasks equal the plain version's and "
        f"the expected ones at every bucket; {launches['ed25519_verify']} verify kernel launches; "
        f"{time.perf_counter() - t0:.1f} s")
    return {"tool": "verify_bench", "phase": "12a", "result": result, "mismatches": mismatches,
            "launches": dict(launches), "seconds": time.perf_counter() - t0}


def tools_aggregate(outdir: str, cert: dict, card: str, device: str = "cuda") -> dict:
    """12b: ``aggregate_bench --cert-route`` at n = 64 (its verdicts and
    eq_ok those of phase 3c), then the default grid at reduced rounds."""
    from at2_node_tpu_torch.tools import aggregate_bench as ab

    t0 = time.perf_counter()
    zero_launch_counts()
    routes = ab.cert_route(CERT_N, ab.ROUNDS, device)
    launches = launch_counts()
    ps, ag = routes["per_sig_kernel"], routes["rlc_aggregate"]
    j = CERT_N // 2
    check(ps["verdicts"] == {"clean": [True] * CERT_N, "tampered": [i != j for i in range(CERT_N)]},
          f"aggregate_bench (12b): the verify kernel's certificate verdicts {ps['verdicts']}")
    check(ag["verdicts"] == ag["eq_ok"] == cert["verdicts"] == {"clean": True, "tampered": False},
          f"aggregate_bench (12b): aggregate {ag['verdicts']}, eq_ok {ag['eq_ok']}, phase 3c "
          f"{cert['verdicts']}")
    check((launches["ed25519_rlc_lanes"] > 0 and launches["ed25519_rlc_fold"] > 0) or device != "cuda",
          f"aggregate_bench (12b) launched no RLC kernel: {dict(launches)}")
    log(f"aggregate_bench --cert-route (12b) n={CERT_N}: the verify kernel {ps['ms']:.3f} ms a whole "
        f"call, {ps['device_ms']:.4f} ms on the card; the RLC kernels' one equation {ag['ms']:.3f} ms, "
        f"{ag['device_ms']:.4f} ms on the card; verdicts and eq_ok {ag['verdicts']} as in phase 3c; "
        f"launches {dict(launches)}; {card}")
    t1 = time.perf_counter()
    rc, _ = quiet(ab.main, ["--rounds", str(TOOLS_AGG_ROUNDS), "--bank-dir", outdir,
                            "--label", "phase12", "--quiet", "--device", device])
    with open(os.path.join(outdir, "BENCH_AGGREGATE.json")) as f:
        summary = json.load(f)["runs"]["phase12"]["summary"]
    log(f"aggregate_bench grid (12b, host CPU, --rounds {TOOLS_AGG_ROUNDS}): rlc "
        f"{summary['rlc_sigs_per_sec']:,.1f} sigs/s, native per-signature (1 thread) "
        f"{summary['per_sig_native_1thread_sigs_per_sec']:,.1f}, python per-signature "
        f"{summary['per_sig_python_sigs_per_sec']:,.1f} at {summary['bucket']} lanes; rlc "
        f"{summary['rlc_vs_crypto_floor']}x the crypto floor (the reference's target 5x: "
        f"{'met' if summary['target_met'] else 'missed'}, exit {rc}); {time.perf_counter() - t1:.1f} s")
    return {"tool": "aggregate_bench", "phase": "12b", "cert_route": routes, "grid_summary": summary,
            "grid_rc": rc, "launches": dict(launches), "seconds": time.perf_counter() - t0}


def tools_plane(outdir: str, card: str, device: str = "cuda") -> dict:
    """12c: ``plane_bench`` with scripts/ci.sh's arguments: ``--compare-obs``,
    ``--smoke-profile`` (the loop, 2 thread and 2 process shards), and
    ``--shards-grid 1,2 --cores 2`` under each executor, every node on the
    card's verifier (the port's default). The smokes' counters are a hard
    check; the overhead and the speedup are printed beside the reference's
    thresholds."""
    from at2_node_tpu_torch.tools import plane_bench as pb

    t0 = time.perf_counter()
    zero_launch_counts()
    obs = pb.compare_obs(3, 200, device, 120.0, 0, 2, OBS_BUDGET_PCT, bank_dir=outdir)
    log(f"plane_bench --compare-obs (12c): obs on {obs['best_on_tx_per_sec']:,.1f} tx/s, off "
        f"{obs['best_off_tx_per_sec']:,.1f} tx/s: overhead {obs['overhead_pct']}% against the reference's "
        f"{OBS_BUDGET_PCT}% budget ({'within' if obs['ok'] else 'over'}); {obs['card']}")
    smokes = {}
    # scripts/ci.sh's two (the loop, and 2 process shards) and 2 thread shards
    for shards, executor in ((1, "thread"), (2, "thread"), (2, "process")):
        res = pb.smoke_profile(3, 200, 120.0, shards=shards, executor=executor, verifier=device)
        check(res["ok"], f"plane_bench --smoke-profile ({res['executor']}): zero phases "
              f"{res['zero_phases']}, worker-side {res['shard_zero_phases']}, folded lines "
              f"{res['folded_lines']}, worker frames {res['worker_folded_frames']}")
        smokes[res["executor"]] = res
        log(f"plane_bench --smoke-profile (12c, executor {res['executor']}, shards {shards}): every phase "
            f"counter ticked, {res['samples']} samples, {res['folded_lines']} folded lines, "
            f"{res['worker_folded_frames']} worker frames; {res['committed_tx_per_sec']:,.1f} tx/s")
    grids = {}
    for executor in ("thread", "process"):
        res = pb.shards_grid(3, 300, device, 120.0, 0, [1, 2], 2, 2, executor=executor, bank_dir=outdir)
        grids[executor] = res["summary"]
        speedup = res["summary"]["peak_speedup_vs_1"]
        log(f"plane_bench --shards-grid 1,2 --cores 2 (12c, executor {executor}): "
            + ", ".join(f"{c['shards']} shards {c['best_tx_per_sec']:,.1f} tx/s" for c in res["grid"])
            + f"; speedup {speedup}x against the reference's {SHARD_SPEEDUP_MIN}x "
            f"({'met' if speedup >= SHARD_SPEEDUP_MIN else 'missed'}) on "
            f"{res['summary']['host_cores']} cores")
    launches = launch_counts()
    log(f"plane_bench (12c): {dict(launches)} kernel launches; {time.perf_counter() - t0:.1f} s")
    return {"tool": "plane_bench", "phase": "12c", "compare_obs": obs,
            "smoke": {k: {x: v[x] for x in ("ok", "samples", "folded_lines", "worker_folded_frames",
                                             "committed_tx_per_sec", "zero_phases")}
                      for k, v in smokes.items()},
            "shards_grid": grids, "launches": dict(launches), "seconds": time.perf_counter() - t0}


def tools_e2e(outdir: str, card: str, device: str = "cuda") -> dict:
    """12d: ``e2e_bench``'s two arms at its defaults (16 clients x 50
    transfers, unary), then ``--compose``; every transfer must commit."""
    import logging

    from at2_node_tpu_torch.tools import e2e_bench

    # loadgen's transfers go to their sender: the ledger notes each one
    logging.getLogger("at2_node_tpu_torch.ledger.accounts").setLevel(logging.ERROR)
    t0 = time.perf_counter()
    zero_launch_counts()
    rc, _ = quiet(e2e_bench.main, ["--out", os.path.join(outdir, "BENCH_E2E.json"), "--device", device,
                                   *E2E_SIZE])
    check(rc == 0, f"e2e_bench (12d) exited {rc}")
    with open(os.path.join(outdir, "BENCH_E2E.json")) as f:
        arms = json.load(f)
    for arm in ("cpu_subprocess", "cuda_inprocess"):
        a = arms[arm]
        check(a["committed"] == a["submitted"] > 0,
              f"e2e_bench (12d) {arm}: {a['committed']} of {a['submitted']} committed")
        log(f"e2e_bench (12d) {arm}: {a['committed']} of {a['submitted']} transfers committed, "
            f"{a['committed_tx_per_sec']:,.1f} tx/s ({a['topology']}); {a.get('card')}")
    t1 = time.perf_counter()
    pipeline = os.path.join(outdir, "BENCH_PIPELINE.json")
    rc, _ = quiet(e2e_bench.main, ["--compose", "--trials", str(TOOLS_TRIALS), "--device", device,
                                   "--out", pipeline, "--bank-dir", outdir, *E2E_SIZE])
    check(rc == 0, f"e2e_bench --compose (12d) exited {rc}")
    with open(pipeline) as f:
        doc = json.load(f)
    composed, dec = doc["composed"], doc["decomposition"]
    check(composed["committed"] == composed["submitted"] > 0,
          f"e2e_bench --compose (12d): {composed['committed']} of {composed['submitted']} committed")
    write_json(os.path.join(outdir, "BENCH_r02.json"),
               {"cmd": "python -m at2_node_tpu_torch.tools.e2e_bench --compose", "rc": 0,
                "parsed": doc["verify_grid"]})
    ingress = doc["ingress_decomposition"]
    log(f"e2e_bench --compose (12d): verify grid {doc['verify_grid']['value']:,.1f} sigs/s pipelined; plane "
        f"{doc['plane'].get('committed_tx_per_sec')} tx/s (plane-only); ingress per-tx "
        f"{ingress.get('per_tx', {}).get('ingress_tx_per_sec')}, distilled "
        f"{ingress.get('distilled', {}).get('ingress_tx_per_sec')} tx/s; composed "
        f"{composed['committed']} of {composed['submitted']} committed, {composed['committed_tx_per_sec']:,.1f} "
        f"tx/s; binding term {dec['binding_term']}; {time.perf_counter() - t1:.1f} s; {card}")
    launches = launch_counts()
    return {"tool": "e2e_bench", "phase": "12d",
            "arms": {k: {x: arms[k][x] for x in ("submitted", "committed", "committed_tx_per_sec")}
                     for k in ("cpu_subprocess", "cuda_inprocess")},
            "compose": {"composed_tx_per_sec": composed["committed_tx_per_sec"], "decomposition": dec},
            "launches": dict(launches), "seconds": time.perf_counter() - t0}


def rebuilt_dumps(bundle_dir: str) -> dict:
    """The dumps an incident bundle directory was built from: every
    ``<node>/<surface>.json`` file, keyed as ``incident.collect`` keys them."""
    manifest = json.load(open(os.path.join(bundle_dir, "manifest.json")))
    dumps: dict = {"nodes": {}}
    for node in manifest["nodes"]:
        safe = node.replace(":", "_").replace("/", "_")
        surfaces = dumps["nodes"][node] = {}
        for name in sorted(os.listdir(os.path.join(bundle_dir, safe))):
            with open(os.path.join(bundle_dir, safe, name)) as f:
                surfaces[name[: -len(".json")]] = json.load(f)
    return dumps


async def tools_net_path(seed: int, outdir: str, card: str, device: str = "cuda") -> dict:
    """12e: four ``server run`` nodes with ``kind = "cuda"``: 16 clients
    send SendAssetBatch chunks while ``profile_collect --duration 5``
    profiles every node, then every transfer sent must commit on every
    node (the replay); then ``incident --now`` against the same net, its
    bundle rebuilt twice from the dumps it wrote, with its hash."""
    import copy
    import tempfile

    from at2_node_tpu_torch.client import Client
    from at2_node_tpu_torch.crypto.keys import SignKeyPair
    from at2_node_tpu_torch.tools import incident, profile_collect

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed + 12)
    clients = [SignKeyPair(rng.bytes(32)) for _ in range(NET_CLIENTS)]
    # amounts of 1, so no debit can fail however many a client sends
    n = len(clients)
    plan = [[(seq, clients[(c + 1) % n].public, 1)
             for seq in range(1, TOOLS_PROFILE_CHUNK * TOOLS_PROFILE_MAX_CHUNKS + 1)] for c in range(n)]
    with tempfile.TemporaryDirectory(prefix="at2-phase12e-") as workdir:
        net = ServerNet(device, workdir)
        try:
            net.start(deadline_s=180.0)
            addrs = [("127.0.0.1", p) for p in net.rpc_ports]
            before = [net.statusz(i) for i in range(net.n)]
            profile = asyncio.ensure_future(profile_collect.run(addrs, TOOLS_PROFILE_S))
            sent = [0] * len(clients)

            async def client(c: int) -> None:
                async with Client(f"http://127.0.0.1:{net.rpc_ports[c % net.n]}") as conn:
                    while sent[c] == 0 or not profile.done():
                        check(sent[c] < len(plan[c]), f"12e: client {c} ran out of transfers")
                        chunk = plan[c][sent[c]:sent[c] + TOOLS_PROFILE_CHUNK]
                        await conn.send_asset_many(clients[c], chunk)
                        sent[c] += len(chunk)

            t_load = time.perf_counter()
            await asyncio.gather(*(client(c) for c in range(len(clients))))
            results = await profile
            total = sum(sent)
            wait_committed(net, [b["stats"]["committed"] + total for b in before], NET_DEADLINE_S)
            log(f"profiled node net (12e): {total} transfers from {len(clients)} clients committed on all "
                f"{net.n} nodes, {total / (time.perf_counter() - t_load):,.0f} tx/s while profile_collect "
                f"--duration {TOOLS_PROFILE_S:g} ran")
            await check_replay(net, clients, [plan[c][:sent[c]] for c in range(len(clients))])
            down = [a for a, r in results if isinstance(r, Exception)]
            check(not down, f"profile_collect (12e): nodes {down} failed: {results}")
            check(all(r["capture_started"] and r["plane_total_ms"] > 0 for _, r in results),
                  "profile_collect (12e): a node's capture did not start or its plane spent no time")
            import io

            report = io.StringIO()
            profile_collect.render(results, TOOLS_PROFILE_S, 0.0, report)
            log(report.getvalue().rstrip())
            launches = sum(net.statusz(i)["build"]["kernel_launches"] - before[i]["build"]["kernel_launches"]
                           for i in range(net.n))
            check(launches > 0 or device != "cuda", "12e: the servers launched no verify kernel")
            # incident --now as an operator runs it, then the bundle rebuilt
            # twice from the dumps it wrote
            root = os.path.join(outdir, "incidents")
            proc = subprocess.run(
                [sys.executable, "-m", "at2_node_tpu_torch.tools.incident", "--now",
                 *(f"{h}:{p}" for h, p in addrs), "--out", root],
                capture_output=True, text=True, env=checkout_env(), timeout=120)
            check(proc.returncode == 0, f"incident --now exited {proc.returncode}: {proc.stderr[-2000:]}")
            manifest = json.loads(proc.stdout)
            bundle_dir = os.path.join(root, [d for d in os.listdir(root)
                                             if d.endswith(manifest["bundle_sha256"][:8])][0])
            dumps = rebuilt_dumps(bundle_dir)
            b1 = incident.build_bundle(dumps, reason=manifest["reason"])
            b2 = incident.build_bundle(copy.deepcopy(dumps), reason=manifest["reason"])
            check(b1["files"] == b2["files"]
                  and b1["manifest"] == b2["manifest"] == manifest,
                  "incident (12e): the bundle rebuilt from its dumps differs from the one written")
            log(f"incident --now (12e): {len(manifest['files'])} files from {len(manifest['nodes'])} nodes, "
                f"bundle {manifest['bundle_sha256'][:16]}..., rebuilt twice from its dumps with the same "
                f"hash; {card}")
        finally:
            rcs = net.stop()
        check(rcs == [0] * net.n, f"12e: servers exited with {rcs} on SIGTERM")
    profiles = {a: {"coverage": r["coverage"], "top_serial": r["top_serial"], "plane_total_ms": r["plane_total_ms"],
                    "shares": r["shares"], "off_plane_ms": r["off_plane_ms"]} for a, r in results}
    return {"tool": "profile_collect", "phase": "12e", "profiles": profiles, "transfers": total,
            "incident": {"files": len(manifest["files"]), "bundle_sha256": manifest["bundle_sha256"]},
            "launches": {"ed25519_verify": launches}, "seconds": time.perf_counter() - t0}


def tools_durability(outdir: str, card: str, device: str = "cuda") -> dict:
    """12f: ``bench_durability`` at the reference's defaults, the restarted
    node on the card's verifier."""
    from at2_node_tpu_torch.tools import bench_durability

    t0 = time.perf_counter()
    zero_launch_counts()
    path = os.path.join(outdir, "BENCH_DURABILITY.json")
    rc, _ = quiet(bench_durability.main, ["--out", path, "--verifier", device])
    with open(path) as f:
        doc = json.load(f)
    check(rc == 0 and doc["ok"], f"bench_durability (12f) exited {rc}: ok {doc['ok']}")
    launches = launch_counts()
    inc = doc["incremental_flush"]
    log(f"bench_durability (12f): {doc['accounts']:,} accounts in {doc['shards']} shards migrated in "
        f"{doc['migrate_s']} s; full flush {doc['full_flush']['bytes']:,} bytes in {doc['full_flush']['wall_s']} s; "
        + ", ".join(f"delta {r['delta_commits']}: {r['segments_written']} segments, {r['bytes_vs_full']} of "
                    f"full" for r in inc)
        + f"; store open {doc['store_open']['wall_s']} s; the node healthy after "
        f"{doc['service_restart']['healthy_after_s']} s ({doc['service_restart']['status']}, "
        f"{doc['service_restart']['catchup_transfers']} catch-up transfers); {time.perf_counter() - t0:.1f} s; "
        f"{doc['card']}")
    return {"tool": "bench_durability", "phase": "12f", "ok": doc["ok"], "migrate_s": doc["migrate_s"],
            "healthy_after_s": doc["service_restart"]["healthy_after_s"],
            "incremental_flush": inc, "launches": dict(launches), "seconds": time.perf_counter() - t0}


def tools_regress(outdir: str) -> dict:
    """12g: the port's ``regress --dir`` over what phase 12 wrote: every file
    must load (exit 2 is a schema error), and a regression is printed."""
    from at2_node_tpu_torch.tools import regress

    rc, report = quiet(regress.main, ["--dir", outdir])
    check(rc in (0, 1), f"regress (12g) exited {rc} over {sorted(os.listdir(outdir))}")
    log(report.rstrip())
    return {"tool": "regress", "phase": "12g", "rc": rc,
            "files": sorted(f for f in os.listdir(outdir) if f.endswith(".json")),
            "regressions": report.rstrip().splitlines()[-1]}


def tools_path(seed: int, cert: dict, card: str, device: str = "cuda") -> tuple:
    """Phase 12: the port's measurement tools on the card (``device``
    "cpu" rehearses it on the host), every row into a temporary
    directory; returns (one JSON line's object a tool, the kernel
    launches summed over the phase)."""
    import tempfile

    t12 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="at2-phase12-") as outdir:
        rows = [tools_verify(outdir, card, device), tools_aggregate(outdir, cert, card, device),
                tools_plane(outdir, card, device), tools_e2e(outdir, card, device),
                asyncio.run(tools_net_path(seed, outdir, card, device)),
                tools_durability(outdir, card, device), tools_regress(outdir)]
    totals = Counter()
    for row in rows:
        totals.update(row.get("launches", {}))
    log(f"phase 12 (the measurement tools) took {time.perf_counter() - t12:.1f} s; kernel launches "
        f"{dict(totals)}; {card}")
    return rows, totals


def device_share(run: dict, by_lanes: dict) -> float:
    """Kernel time on the card over the run's wall time, from phase 3's
    per-bucket kernel times (device clock) and the run's flush buckets."""
    return sum(by_lanes[b]["ms"] for b in run["buckets"]) / (1e3 * run["wall_s"])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2026)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    card = device_report(torch)
    ptxas = build_all()
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    mat = Material(args.seed)
    mat.cross_check()
    log(f"material: {len(mat.valid)} valid items, {len(TAMPER_CLASSES)} tamper classes, "
        f"signed in {time.perf_counter() - t0:.1f} s")
    kp = kernel_vs_plain(torch, mat, rng)
    rlc = rlc_vs_plain(torch, mat, rng)
    times = {"ed25519_verify": kp["by_lanes"], **rlc["by_lanes"]}
    cert = certificate(torch, mat, rng, rlc["by_lanes"])
    mp = asyncio.run(main_path(mat, rng))
    net = asyncio.run(net_path(args.seed, kp["by_lanes"]))
    device_name = torch.cuda.get_device_name(0)
    nodes = asyncio.run(node_path(args.seed, times, device_name))
    t9 = time.perf_counter()
    planes = asyncio.run(plane_store_path(args.seed, times, device_name, card))
    log(f"plane+store node net (SendAssetBatch): executor \"thread\" "
        f"{planes['plane_store_thread']['tx_per_s']:,.0f} tx/s, \"process\" "
        f"{planes['plane_store_process']['tx_per_s']:,.0f} tx/s, against "
        f"{nodes['node_grpc_batched']['tx_per_s']:,.0f} tx/s for phase 6's run A ([plane] shards = 1, "
        f"no store) in this call; phase 9 took {time.perf_counter() - t9:.1f} s; {card}")
    t10 = time.perf_counter()
    import tempfile

    simdir = tempfile.TemporaryDirectory(prefix="at2-phase11-")
    capture = os.path.join(simdir.name, "capturez-node0.json")
    finality = asyncio.run(finality_broker_path(args.seed, times, device_name, card, capture_to=capture))
    log(f"finality and broker node net: [finality] enabled {finality['net_finality']['tx_per_s']:,.0f} "
        f"tx/s (SendAssetBatch), through the broker {finality['net_broker']['tx_per_s']:,.0f} tx/s "
        f"(loadgen --broker, unary SendAsset distilled into SendDistilledBatch), against "
        f"{nodes['node_grpc_batched']['tx_per_s']:,.0f} tx/s for phase 6's run A in this call; phase 10 "
        f"took {time.perf_counter() - t10:.1f} s; {card}")
    rlc_nodes = asyncio.run(node_path(args.seed, times, device_name, mode="rlc",
                                      per_unary=NODE_RLC_PER_UNARY))
    log(f"rlc node net (SendAssetBatch): {rlc_nodes['rlc_node_grpc_batched']['tx_per_s']:,.0f} tx/s "
        f"against {nodes['node_grpc_batched']['tx_per_s']:,.0f} tx/s for phase 6's run A (mode "
        f"\"auto\", the verify kernel) in this call")
    pooled = pool_path(torch, mat, rng, args.seed, kp["by_lanes"])
    sim = sim_path(capture, card)
    simdir.cleanup()
    tools, tool_launches = tools_path(args.seed, cert, card)

    from at2_node_tpu_torch.ops import cuda_verify

    runs = {}
    for name, run in mp.items():
        share = device_share(run, kp["by_lanes"])
        log(f"main path ({name}): kernel busy {100 * share:.1f}% of the wall time "
            f"(phase 3 kernel times summed over its {run['launches']} launches)")
        runs[name] = {
            "launches": run["launches"], "sigs_per_s": run["sigs_per_s"],
            "wall_s": run["wall_s"], "kernel_busy_share": share,
            "flush_buckets": {str(b): c for b, c in sorted(Counter(run["buckets"]).items())},
        }
    runs.update(net)
    runs.update(nodes)
    runs.update(planes)
    runs.update(finality)
    top = kp["by_lanes"][65536]
    kernels = [{
        "name": "ed25519_verify",
        "route": "cuda",
        "source": "at2_node_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "at2_node_tpu/ops/pallas_verify.py:232",
        "launches": mp["stress"]["launches"] + tool_launches["ed25519_verify"],
        "mismatches": kp["mismatches"],
        "max_abs_err": kp["max_abs_err"],
        "lanes": 65536,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "threads_per_signature": cuda_verify.THREADS_PER_SIGNATURE,
        **ptxas["ed25519_verify_kernel"],
        "by_lanes": {str(n): r for n, r in kp["by_lanes"].items()},
        "main_path": {**runs, "tools": {row["tool"]: row.get("launches", {}).get("ed25519_verify", 0)
                                        for row in tools}},
        "card": card,
    }]
    # the RLC kernels' main path: phase 7's node net (the processes' counts)
    rlc_launches = sum(r["rlc_launches"] for r in rlc_nodes.values())
    check(rlc_launches > 0, "phase 7 ran without launching the RLC kernels")
    # the lanes kernel's layouts: threads a lane and ptxas figures of each
    # instantiation; the top-level figures are those of the layout the
    # 65,536 bucket takes, the main path's bucket (256) takes its own
    from at2_node_tpu_torch.ops import cuda_rlc

    names = cuda_rlc.LAYOUT_NAMES
    top_layout = rlc["by_lanes"]["ed25519_rlc_lanes"][65536]["layout"]
    main_layout = rlc["by_lanes"]["ed25519_rlc_lanes"][256]["layout"]
    layout_fields = {
        "ed25519_rlc_lanes": {
            "layout": top_layout, "main_path_lanes": 256, "main_path_layout": main_layout,
            "split_wave_lanes": rlc["split_wave_lanes"], "blocks_per_sm": rlc["blocks_per_sm"],
            "threads_per_lane": dict(zip(names, cuda_rlc.THREADS_PER_LANE)),
            **ptxas[f"ed25519_rlc_lanes[{top_layout}]"],
            "ptxas_by_layout": {x: ptxas[f"ed25519_rlc_lanes[{x}]"] for x in names},
        },
        "ed25519_rlc_fold": {"threads_per_point": 4, **ptxas["ed25519_rlc_fold"]},
    }
    for name, replaces in (("ed25519_rlc_lanes", "at2_node_tpu/ops/aggregate.py:287"),
                           ("ed25519_rlc_fold", "at2_node_tpu/ops/aggregate.py:325")):
        top = rlc["by_lanes"][name][65536]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "at2_node_tpu_torch/csrc/ed25519_rlc.cu",
            "replaces": replaces,
            "launches": rlc_launches + tool_launches[name],
            "mismatches": rlc["mismatches"][name],
            "max_abs_err": rlc["max_abs_err"][name],
            "lanes": 65536,
            "ms": top["ms"],
            "plain_ms": top["plain_ms"],
            "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"],
            "library_ms": None,
            **layout_fields[name],
            "by_lanes": {str(n): r for n, r in rlc["by_lanes"][name].items()},
            "main_path": {**rlc_nodes, "certificate": cert, "aggregate_bench": tool_launches[name]},
            "card": card,
        })
    # the pool: the verify kernel once a shard; its main path is phase 8's
    # replay, 32-node net and entry (each count set to 0 just before)
    cmp = pooled["compare"]
    top_lanes = max(POOL_TIMED_LANES)
    top = kp["by_lanes"][top_lanes]
    kernels.append({
        "name": "ed25519_verify_pool",
        "route": "cuda",
        "composition": "the verify kernel once a shard, each shard on its own streams",
        "source": "at2_node_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "at2_node_tpu/parallel/pool.py:81",
        "launches": sum(pooled[k]["launches"] for k in ("replay", "scale_net", "entry")),
        "mismatches": cmp["mismatches"],
        "max_abs_err": cmp["max_abs_err"],
        "lanes": top_lanes,
        "shards": 1,
        "ms": cmp["by_shards"][top_lanes][1],
        "plain_ms": cmp["plain_ms"][1],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "ms_by_shards": {str(n): {str(k): ms for k, ms in r.items()}
                         for n, r in cmp["by_shards"].items()},
        "plain_ms_by_shards": {str(k): ms for k, ms in cmp["plain_ms"].items()},
        "main_path": {k: pooled[k] for k in ("replay", "scale_net", "entry")},
        "card": card,
    })
    print(json.dumps({"sim": sim}))
    for row in tools:
        print(json.dumps(row))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()

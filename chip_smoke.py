#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises, the exit code is non-zero and no result line
is printed):

1. Device report: torch, CUDA, the card's name and power limit.
2. Build: the CUDA kernel (nvcc, sm_90a, always rebuilt), the native
   host prep and the native message-plane ingest (g++), all from the
   sources in this checkout, built side by side; the kernel's registers,
   stack frame and spill bytes are read from ptxas's report.
3. Kernel vs plain: about 1,000 signed transfers plus the RFC 8032 TEST 1
   vector and eight tamper classes, tiled into batches of every bucket the
   main path launches (65,536, 8,192, 4,096, 1,024, 256 and 64 lanes), a
   ragged 1,000 and a 77 (a partial last bitmask byte). On every batch the
   kernel's bitmask must equal the plain PyTorch version's bitmask,
   computed on the card, and the expected verdicts: 0 mismatches. Both are
   timed with CUDA events.
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
6. One JSON line describing the kernel (its times and bound at every
   shape, every main-path run, the ptxas figures and the threads per
   signature), then the result line ``{"ok": true, "device": {...}}``.

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


def parse_ptxas(log_text: str, kernel: str) -> dict:
    """Registers, stack frame and spill bytes of `kernel`'s entry function
    from nvcc's ``-Xptxas -v`` output."""
    entry = next((m for m in re.finditer(r"Compiling entry function '([^']+)'", log_text)
                  if kernel in m.group(1)), None)
    check(entry is not None, f"no ptxas report for {kernel}")
    rest = log_text[entry.end():]
    regs = re.search(r"Used (\d+) registers", rest)
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", rest)
    check(regs is not None and frame is not None, f"ptxas report for {kernel} not understood")
    return {"registers": int(regs.group(1)), "stack_bytes": int(frame.group(1)),
            "spill_bytes": int(frame.group(2)), "spill_load_bytes": int(frame.group(3))}


def build_all() -> dict:
    from at2_node_tpu_torch.native import ingest, prep
    from at2_node_tpu_torch.native._build import BUILD_DIR
    from at2_node_tpu_torch.ops import cuda_verify

    # always build from the sources, so ptxas reports on what runs
    lib = os.path.join(BUILD_DIR, cuda_verify.LIB_NAME)
    if os.path.exists(lib):
        os.remove(lib)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=3) as pool:
        kern = pool.submit(timed, cuda_verify.build)
        nat = pool.submit(timed, prep.native_available)
        ing = pool.submit(timed, ingest.ingest_available)
        _, kern_s = kern.result()
        native_ok, nat_s = nat.result()
        ingest_ok, ing_s = ing.result()
    log(f"build: kernel {kern_s:.1f} s (nvcc sm_90a), native prep {nat_s:.1f} s (g++), "
        f"native ingest {ing_s:.1f} s (g++, libcrypto): "
        f"{'on' if ingest_ok else 'OFF, the broadcast plane parses and tallies in python'}")
    for line in cuda_verify.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())
    ptxas = parse_ptxas(cuda_verify.build_log, "ed25519_verify_kernel")
    ptxas["build_s"] = kern_s
    log(f"kernel: {ptxas['registers']} registers, {ptxas['stack_bytes']} bytes stack frame, "
        f"{ptxas['spill_bytes']} bytes spill stores")
    check(native_ok, "native host prep did not build with g++")
    log("prep path: native")
    return ptxas


# -- test material ---------------------------------------------------------


class Material:
    """Signed transfers (64 seeded keys x 16 sequences), the RFC 8032
    TEST 1 vector, and a pool of lanes for every tamper class."""

    def __init__(self, seed: int) -> None:
        from at2_node_tpu_torch.crypto import _fallback as fb
        from at2_node_tpu_torch.crypto.keys import SignKeyPair
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
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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
    mp = asyncio.run(main_path(mat, rng))
    net = asyncio.run(net_path(args.seed, kp["by_lanes"]))
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
    top = kp["by_lanes"][65536]
    kernels = {"kernels": [{
        "name": "ed25519_verify",
        "route": "cuda",
        "source": "at2_node_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "at2_node_tpu/ops/pallas_verify.py:232",
        "launches": mp["stress"]["launches"],
        "mismatches": kp["mismatches"],
        "max_abs_err": kp["max_abs_err"],
        "lanes": 65536,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": None,
        "threads_per_signature": cuda_verify.THREADS_PER_SIGNATURE,
        **ptxas,
        "by_lanes": {str(n): r for n, r in kp["by_lanes"].items()},
        "main_path": runs,
        "card": card,
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()

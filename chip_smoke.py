#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Phases (any failure raises, the exit code is non-zero and no result line
is printed):

1. Device report: torch, CUDA, the card's name and power limit.
2. Build: the CUDA kernel (nvcc, sm_90a, always rebuilt) and the native
   host prep (g++), both from the sources in this checkout, built side by
   side; the kernel's registers, stack frame and spill bytes are read from
   ptxas's report.
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
5. One JSON line describing the kernel (its times and bound at every
   shape, both main-path runs, the ptxas figures and the threads per
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
    from at2_node_tpu_torch.native import prep
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

    with ThreadPoolExecutor(max_workers=2) as pool:
        kern = pool.submit(timed, cuda_verify.build)
        nat = pool.submit(timed, prep.native_available)
        _, kern_s = kern.result()
        native_ok, nat_s = nat.result()
    log(f"build: kernel {kern_s:.1f} s (nvcc sm_90a), native prep {nat_s:.1f} s (g++)")
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

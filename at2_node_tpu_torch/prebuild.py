"""Build every library of the port from the sources in this package: the
release image's build step, so that a node's first boot compiles nothing.

    python -m at2_node_tpu_torch.prebuild

Into ``at2_node_tpu_torch/build/``, side by side: the verify kernel
(``csrc/ed25519_verify.cu``) and the two RLC kernels
(``csrc/ed25519_rlc.cu``) with nvcc for ``sm_90a``, always rebuilt from
their sources; the host prep (``native/at2_prep.cpp``) and the
message-plane ingest (``native/at2_ingest.cpp``, libcrypto) with g++.
Each library must load; ptxas's registers, stack frame and spill bytes of
every kernel are printed. Without nvcc the module exits 2 and names it;
a build that fails exits 1. Nothing falls back to the plain version.
"""

from __future__ import annotations

import os
import re
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# ptxas names: a kernel, or an instantiation of the RLC lanes template
# (its mangled name) by layout
PTXAS_ENTRIES = {
    "ed25519_verify_kernel": "ed25519_verify_kernel",
    "ed25519_rlc_lanes[whole]": "ed25519_rlc_lanesILi0E",
    "ed25519_rlc_lanes[split]": "ed25519_rlc_lanesILi1E",
    "ed25519_rlc_fold": "ed25519_rlc_fold",
}


def nvcc_path() -> str | None:
    """The nvcc the kernels build with (``CUDA_HOME``, else
    ``/usr/local/cuda``, else PATH), or None when there is none."""
    from .ops.cuda_verify import _nvcc

    nvcc = _nvcc()
    return nvcc if os.path.isabs(nvcc) else shutil.which(nvcc)


def parse_ptxas(log_text: str, kernel: str) -> dict:
    """Registers, stack frame and spill bytes of ``kernel``'s entry function
    (PTXAS_ENTRIES) from nvcc's ``-Xptxas -v`` output."""
    entry = next((m for m in re.finditer(r"Compiling entry function '([^']+)'", log_text)
                  if PTXAS_ENTRIES[kernel] in m.group(1)), None)
    if entry is None:
        raise RuntimeError(f"no ptxas report for {kernel}")
    rest = log_text[entry.end():]
    regs = re.search(r"Used (\d+) registers", rest)
    frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", rest)
    if regs is None or frame is None:
        raise RuntimeError(f"ptxas report for {kernel} not understood")
    return {"registers": int(regs.group(1)), "stack_bytes": int(frame.group(1)),
            "spill_bytes": int(frame.group(2)), "spill_load_bytes": int(frame.group(3))}


def remove_kernel_libs() -> None:
    """Delete the kernels' built libraries: each builds again from the
    sources, so ptxas reports on what runs."""
    from .native._build import BUILD_DIR
    from .ops import cuda_rlc, cuda_verify

    for mod in (cuda_verify, cuda_rlc):
        lib = os.path.join(BUILD_DIR, mod.LIB_NAME)
        if os.path.exists(lib):
            os.remove(lib)


def build_libs(log=print) -> dict:
    """Every library, built side by side and loaded; the ptxas figures of
    each kernel by name (a kernel whose library is fresh is not rebuilt and
    has none). Raises RuntimeError when a library does not build or load."""
    from .native import ingest, prep
    from .ops import cuda_rlc, cuda_verify

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=4) as pool:
        kern = pool.submit(timed, cuda_verify.build)
        rlc = pool.submit(timed, cuda_rlc.build)
        # the libraries' loaders, not ingest_available: AT2_NO_NATIVE_INGEST
        # turns the ingest off at run time, not in the image
        nat = pool.submit(timed, lambda: prep._load() is not None)
        ing = pool.submit(timed, lambda: ingest._load() is not None)
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
    if not native_ok:
        raise RuntimeError("native host prep did not build with g++")
    if not ingest_ok:
        raise RuntimeError("native message-plane ingest did not build with g++ and libcrypto")
    log("prep path: native")
    return ptxas


def build_all(log=print) -> dict:
    """Every library built from the sources (``remove_kernel_libs``, then
    ``build_libs``); the ptxas figures of each kernel by name."""
    remove_kernel_libs()
    return build_libs(log)


def main() -> int:
    if nvcc_path() is None:
        print("prebuild: nvcc not found (CUDA_HOME, /usr/local/cuda/bin or PATH): the port's kernels "
              "build only with the CUDA toolkit's nvcc, and the image has no plain fallback", file=sys.stderr)
        return 2
    try:
        build_all()
    except RuntimeError as exc:
        print(f"prebuild: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port stands alone: no file of ``at2_node_tpu_torch`` imports jax or
anything of the JAX package, and importing every port module loads
neither."""

import os
import re
import subprocess
import sys

import pytest

import at2_node_tpu_torch

PACKAGE_DIR = os.path.dirname(at2_node_tpu_torch.__file__)
REPO = os.path.dirname(PACKAGE_DIR)

FORBIDDEN = [
    re.compile(r"^\s*import\s+jax\b", re.M),
    re.compile(r"^\s*from\s+jax\b", re.M),
    re.compile(r"\bat2_node_tpu\.(?!_)"),  # at2_node_tpu.<module>, not at2_node_tpu_torch
    re.compile(r"\bat2_node_tpu\s+import\b"),
]


def _source_files():
    for root, dirs, files in os.walk(PACKAGE_DIR):
        dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
        for name in files:
            if name.endswith((".py", ".cu", ".cuh", ".cpp")):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "chip_loop.py")


def test_sources_never_import_jax_or_the_jax_package():
    files = list(_source_files())
    assert len(files) > 15
    offenders = []
    for path in files:
        with open(path, encoding="utf-8") as f:
            text = f.read()
        for pat in FORBIDDEN:
            for m in pat.finditer(text):
                offenders.append(f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}")
    assert not offenders, offenders


@pytest.mark.parametrize("probe", ["at2_node_tpu_torch", "chip_smoke", "chip_loop"])
def test_importing_the_port_loads_no_jax(probe):
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import at2_node_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(at2_node_tpu_torch.__path__, 'at2_node_tpu_torch.')]\n"
        "for name in mods: importlib.import_module(name)\n"
        f"importlib.import_module({probe!r})\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'at2_node_tpu' or m.startswith('at2_node_tpu.')]\n"
        "assert len(mods) >= 15, mods\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: val for k, val in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the measurement tools: the reference's seven last tools/ modules and the
# port's copy of the root bench.py
MEASUREMENT_TOOLS = ("regress", "profile_collect", "incident", "bench_durability", "verify_bench",
                     "aggregate_bench", "plane_bench", "e2e_bench")


@pytest.mark.parametrize("tool", MEASUREMENT_TOOLS)
def test_measurement_tool_imports_neither_jax_nor_the_jax_package(tool):
    path = os.path.join(PACKAGE_DIR, "tools", f"{tool}.py")
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert not [m.group(0) for pat in FORBIDDEN for m in pat.finditer(text)]
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"importlib.import_module('at2_node_tpu_torch.tools.{tool}')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'at2_node_tpu' or m.startswith('at2_node_tpu.')]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: val for k, val in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_tool_writes_into_the_repo_root_by_default():
    """Every default output path of the port's tools lies in a directory
    git ignores, never among the repo's root files (the TPU's record)."""
    import importlib

    from at2_node_tpu_torch.tools import _common

    paths = {"_common.OUT_DIR": _common.OUT_DIR}
    for tool in MEASUREMENT_TOOLS:
        mod = importlib.import_module(f"at2_node_tpu_torch.tools.{tool}")
        for name, value in vars(mod).items():
            if (name.endswith("_PATH") or name.startswith("DEFAULT_OUT")) and isinstance(value, str):
                paths[f"{tool}.{name}"] = value
    assert len(paths) >= 5, paths
    for name, path in paths.items():
        path = os.path.abspath(path)
        assert os.path.dirname(path) != REPO, name
        assert path.startswith(_common.OUT_DIR), name
    ignored = subprocess.run(["git", "check-ignore", "-q", os.path.join(_common.OUT_DIR, "x.json")],
                             cwd=REPO, timeout=60)
    assert ignored.returncode == 0


_NO_CARD_CALLS = {
    "verify_bench": ["--grid", "64"],
    "aggregate_bench": ["--cert-route"],
    "aggregate_bench_grid": ["--batches", "64", "--rounds", "1"],
    "bench_durability": ["--accounts", "10"],
    "plane_bench": ["--smoke-profile"],
    "e2e_bench": ["--skip-cpu"],
    "e2e_bench_compose": ["--compose"],
}


@pytest.mark.parametrize("call", sorted(_NO_CARD_CALLS))
def test_device_tools_raise_without_a_card_unless_asked_for_the_cpu(call, monkeypatch, tmp_path):
    """The tools that run work default to cuda:0; without a card and
    without the flag that asks for the host they raise before writing."""
    import importlib

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module("at2_node_tpu_torch.tools." + call.split("_grid")[0].split("_compose")[0])
    argv = _NO_CARD_CALLS[call] + (["--out", str(tmp_path / "out.json")] if call != "aggregate_bench_grid"
                                   else ["--bank-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device is available; pass --(device|verifier) cpu"):
        mod.main(argv)
    assert os.listdir(tmp_path) == []


# -- the package APIs -----------------------------------------------------

PACKAGE_APIS = ("ledger", "obs", "native")


def test_package_apis_load_no_torch():
    """A plane shard worker imports the ledger, obs and native packages;
    their package-level exports must not load torch (nor CUDA with it)."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from at2_node_tpu_torch.ledger import Accounts, RecentTransactions\n"
        "from at2_node_tpu_torch.obs import Registry, SloEngine, PhaseAccounting\n"
        "from at2_node_tpu_torch.native import ingest_available, prep_packed_native\n"
        "import at2_node_tpu_torch.parallel.plane_worker\n"
        "bad = sorted(m for m in sys.modules if m == 'torch' or m.startswith('torch.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: val for k, val in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("package", PACKAGE_APIS)
def test_package_api_exports_the_references_names(package):
    """Each package exports the reference's names; the one deliberate
    difference is native's ``prep_packed_native`` (the port's prep writes
    packed rows) where the reference has ``prep_batch_native``."""
    import importlib

    port = importlib.import_module(f"at2_node_tpu_torch.{package}")
    ref = importlib.import_module(f"at2_node_tpu.{package}")
    renamed = {"prep_batch_native": "prep_packed_native"}
    want = {renamed.get(n, n) for n in ref.__all__}
    assert want <= set(port.__all__), want - set(port.__all__)
    assert all(hasattr(port, name) for name in port.__all__)
    assert not hasattr(port, "prep_batch_native")


def test_roofline_imports_neither_jax_nor_the_jax_package():
    path = os.path.join(PACKAGE_DIR, "ops", "roofline.py")
    with open(path, encoding="utf-8") as f:
        text = f.read()
    assert not [m.group(0) for pat in FORBIDDEN for m in pat.finditer(text)]
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from at2_node_tpu_torch.ops import roofline\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'at2_node_tpu' or m.startswith('at2_node_tpu.')]\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: val for k, val in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

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


@pytest.mark.parametrize("probe", ["at2_node_tpu_torch", "chip_smoke"])
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

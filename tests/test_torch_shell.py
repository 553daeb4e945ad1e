"""The shell tier against the port: the four ``tests/shell/`` scripts, as
they stand, with ``server`` and ``client`` on PATH being shims in a
temporary directory that exec ``at2_node_tpu_torch``'s CLIs. The
``server`` shim turns ``config new`` into ``config new --verifier cpu``:
this host has no card, and the port's default table is the card's. A
script passes when it exits 0 and prints ``ok``."""

import os
import stat
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHELL_DIR = os.path.join(REPO, "tests", "shell")

_SHIMS = {
    "server": (
        '#!/bin/sh\n'
        'if [ "$1" = config ] && [ "$2" = new ]; then\n'
        '    shift 2\n'
        '    exec "{python}" -m at2_node_tpu_torch.cli.server config new --verifier cpu "$@"\n'
        'fi\n'
        'exec "{python}" -m at2_node_tpu_torch.cli.server "$@"\n'
    ),
    "client": '#!/bin/sh\nexec "{python}" -m at2_node_tpu_torch.cli.client "$@"\n',
}


def _scripts():
    return sorted(n for n in os.listdir(SHELL_DIR)
                  if os.stat(os.path.join(SHELL_DIR, n)).st_mode & stat.S_IXUSR)


@pytest.mark.parametrize("script", _scripts())
def test_shell_script_against_the_port(script, tmp_path):
    """The shell tier as it stands, with ``server`` / ``client`` on PATH
    being shims that exec this package's CLIs."""
    for name, text in _SHIMS.items():
        shim = tmp_path / name
        shim.write_text(text.replace("{python}", sys.executable))
        shim.chmod(0o755)
    env = dict(os.environ, PYTHONPATH=REPO, PATH=str(tmp_path) + os.pathsep + os.environ["PATH"])
    proc = subprocess.run(["/bin/bash", os.path.join(SHELL_DIR, script)], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, f"{script} failed\nstdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-4000:]}"
    assert proc.stdout.strip().endswith("ok")

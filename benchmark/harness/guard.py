"""Run one process of the program under test and record what it loaded.

    python3 benchmark/harness/guard.py <modules-file> <module | script.py> [args...]

Runs the module (as ``python -m`` would) or the script with ``args`` as
its command line and, as it exits, writes the sorted top-level names of
every module in its ``sys.modules`` to ``modules-file`` as a JSON list.
The harness starts every node through it and refuses a run in which any
process loaded a name of :data:`FORBIDDEN`: the harness's own check of
``sys.modules`` cannot see what the node processes load.
"""

from __future__ import annotations

import json
import os
import runpy
import sys
from typing import Iterable, List

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# compared with each loaded module's top-level name whole, so the port
# (at2_node_tpu_torch) is not taken for the JAX package (at2_node_tpu)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "at2_node_tpu"})


def top_level(names: Iterable[str]) -> List[str]:
    return sorted({name.split(".")[0] for name in names})


def forbidden(names: Iterable[str]) -> List[str]:
    """The names of ``names`` (module names or top-level names) that a run
    may not load."""
    return sorted(set(top_level(names)) & FORBIDDEN)


def main() -> None:
    out, target, args = sys.argv[1], sys.argv[2], sys.argv[3:]
    # the checkout's root in place of this file's directory, as for
    # ``python -m`` from the root
    sys.path[0] = ROOT
    sys.argv = [target] + args
    try:
        if target.endswith(".py"):
            runpy.run_path(target, run_name="__main__")
        else:
            runpy.run_module(target, run_name="__main__", alter_sys=True)
    finally:
        with open(out, "w") as f:
            json.dump(top_level(sys.modules), f)


if __name__ == "__main__":
    main()

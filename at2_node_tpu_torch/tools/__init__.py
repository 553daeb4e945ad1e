"""Operational tooling: load generation and benchmark harnesses.

Counterpart of ``at2_node_tpu/tools/``; ported so far: ``_common``,
``loadgen`` and ``scale_demo`` (ROADMAP.md, queue 1, item 14 lists the
rest)."""

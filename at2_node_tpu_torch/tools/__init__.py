"""Operational tooling: load generation, benchmark harnesses, the
regression sentry and the fleet's observability collectors.

Counterpart of ``at2_node_tpu/tools/``: every module there has its own
copy here, and ``verify_bench`` is the port's copy of the repo's root
``bench.py``."""

"""The port's metrics registry (``at2_node_tpu_torch/obs/registry.py``:
``Counter``, ``Gauge``, ``Histogram``, ``CounterGroup``, ``Registry``)
against the JAX package's: the same operations give the same snapshot and
the same Prometheus text."""

import numpy as np
import pytest

from at2_node_tpu.obs import registry as ref_registry
from at2_node_tpu_torch.obs import registry as port_registry


def _exercise(mod, seed: int):
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    group = reg.counter_group(("gossip_rx", "delivered", "invalid_sig"), "broadcast")
    depth = [0]
    reg.gauge("inbox_depth", "queued frames", fn=lambda: depth[0])
    level = reg.gauge("level", "a set gauge")
    hist = reg.histogram("dispatch", "latency")
    own = mod.Histogram("finish", "latency")
    reg.register_provider("mesh_", lambda: {"channels": 6, "name": "x", "ratio": 0.25})
    reg.register_histogram_provider("verifier_", lambda: {"finish": own})
    reg.register_provider("dead_", lambda: 1 / 0)
    for _ in range(200):
        key = ("gossip_rx", "delivered", "invalid_sig")[int(rng.integers(0, 3))]
        group[key] += int(rng.integers(0, 3))
        hist.observe(float(rng.exponential(0.01)))
        own.observe(float(rng.exponential(0.001)))
        depth[0] = int(rng.integers(0, 100))
        level.set(float(rng.random()))
    reg.counter("retransmits").inc(4)
    with pytest.raises(ValueError):
        reg.counter("retransmits").inc(-1)
    with pytest.raises(ValueError):
        group["delivered"] = group["delivered"] - 1
    with pytest.raises(TypeError):
        reg.gauge("retransmits")
    with pytest.raises(RuntimeError):
        reg.gauge("inbox_depth").set(1)
    return reg, group


@pytest.mark.parametrize("seed", [0, 1])
def test_registry_matches_the_reference(seed):
    port, port_group = _exercise(port_registry, seed)
    ref, ref_group = _exercise(ref_registry, seed)
    assert port.snapshot() == ref.snapshot()
    assert port.render_prometheus() == ref.render_prometheus()
    assert port_group.as_dict() == ref_group.as_dict()
    assert list(port_group) == list(ref_group) and len(port_group) == 3
    assert "delivered" in port_group and port_group.get("missing", -1) == -1
    assert port_registry.DEFAULT_BOUNDS == ref_registry.DEFAULT_BOUNDS

"""Scale-out: the device pool (pool.py) and the multi-process runtime
(multihost.py).

Counterpart of ``at2_node_tpu/parallel/__init__.py``. Lazy exports (PEP
562): importing this package imports neither torch's device code nor the
pool. The reference's broadcast-plane executors (``parallel/plane.py``)
are not ported yet: their names raise ``NotImplementedError``.
"""

__all__ = [
    "PoolVerifier",
    "make_pool_devices",
    "pool_bucket_for",
    "verify_and_count",
    "verify_batch_sharded",
    "InlinePlaneExecutor",
    "SPSCQueue",
    "ThreadPlaneExecutor",
    "make_plane_executor",
]

_PLANE = {
    "InlinePlaneExecutor",
    "SPSCQueue",
    "ThreadPlaneExecutor",
    "make_plane_executor",
}


def __getattr__(name):
    if name in _PLANE:
        raise NotImplementedError(
            f"parallel.{name}: the sharded broadcast plane's executors are not "
            "ported yet (ROADMAP.md, queue 1, item 7c.1)"
        )
    if name in __all__:
        from . import pool

        return getattr(pool, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

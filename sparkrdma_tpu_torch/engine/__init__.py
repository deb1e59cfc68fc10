"""The engine: the RDD lineage (``engine/rdd.py``), the in-process
``TpuContext`` (``engine/context.py``), and the multi-process
``ClusterContext`` (``engine/cluster.py``) with its executor workers
(``engine/worker.py``), copies of the JAX package's ``engine/`` with
their imports rewritten, beside the serializer the shuffle handle and
the resolver need. ``TpuContext`` is exported lazily, as in JAX, to
avoid a circular import with ``shuffle/handle.py``."""

from sparkrdma_tpu_torch.engine.serializer import PickleSerializer, Serializer

__all__ = ["PickleSerializer", "Serializer", "TpuContext"]


def __getattr__(name):
    # lazy to avoid a circular import with shuffle.handle
    if name == "TpuContext":
        from sparkrdma_tpu_torch.engine.context import TpuContext

        return TpuContext
    raise AttributeError(name)

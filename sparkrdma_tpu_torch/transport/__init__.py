"""The host transport of the port: the python plane (copies of the JAX
package's ``transport/completion.py``, ``wire.py``, ``channel.py`` and
``node.py``, and ``staging.py``). It speaks the JAX package's wire
format, so a port node and a JAX node talk to each other. The native
plane comes with ROADMAP item M4b."""

from sparkrdma_tpu_torch.transport.completion import CompletionListener, FnListener
from sparkrdma_tpu_torch.transport.channel import TpuChannel, ChannelError
from sparkrdma_tpu_torch.transport.node import TpuNode


def create_node(conf, host, is_executor, executor_id, recv_listener=None,
                peer_lost_listener=None):
    """Node factory: the python transport. ``tpu.shuffle.transport``
    resolves ``auto`` to ``python`` in the port and raises for
    ``native`` (ROADMAP M4b), so the getter is read for that check."""
    if conf.transport != "python":
        raise ValueError(f"unknown transport {conf.transport!r}")
    return TpuNode(
        conf, host, is_executor, executor_id,
        recv_listener=recv_listener,
        peer_lost_listener=peer_lost_listener,
    )


def mapped_delivery_enabled(conf, channel) -> bool:
    """True when a fetch should use mapped (zero-copy) delivery: the
    conf allows it and the channel's plane implements it. No port
    channel has ``read_mapped_in_queue`` (it is the native plane's), so
    this is False until ROADMAP item M4b."""
    return conf.mapped_fetch and hasattr(channel, "read_mapped_in_queue")


__all__ = [
    "CompletionListener",
    "FnListener",
    "TpuChannel",
    "ChannelError",
    "TpuNode",
    "create_node",
    "mapped_delivery_enabled",
]

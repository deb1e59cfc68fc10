"""The host transport of the port: the python plane (copies of the JAX
package's ``transport/completion.py``, ``wire.py``, ``channel.py`` and
``node.py``, and ``staging.py``) and the native plane
(``native_node.py`` over ``native/transport.cpp``). Both speak the JAX
package's wire format, so a port node and a JAX node of either plane
talk to each other."""

from sparkrdma_tpu_torch.transport.completion import CompletionListener, FnListener
from sparkrdma_tpu_torch.transport.channel import TpuChannel, ChannelError
from sparkrdma_tpu_torch.transport.node import TpuNode


def create_node(conf, host, is_executor, executor_id, recv_listener=None,
                peer_lost_listener=None):
    """Node factory honoring ``tpu.shuffle.transport`` (python | native).

    Unlike the JAX factory, ``native`` never falls back to the python
    plane: when the library cannot be built, ``NativeTpuNode`` raises
    ``NativeBuildError`` with g++'s stderr."""
    transport = conf.transport
    if transport == "native":
        from sparkrdma_tpu_torch.transport.native_node import NativeTpuNode

        return NativeTpuNode(
            conf, host, is_executor, executor_id,
            recv_listener=recv_listener,
            peer_lost_listener=peer_lost_listener,
        )
    if transport != "python":
        raise ValueError(f"unknown transport {transport!r}")
    return TpuNode(
        conf, host, is_executor, executor_id,
        recv_listener=recv_listener,
        peer_lost_listener=peer_lost_listener,
    )


def mapped_delivery_enabled(conf, channel) -> bool:
    """True when a fetch should use mapped (zero-copy) delivery: the
    conf allows it and the channel's plane implements it (native
    transport only: ``NativeTpuChannel.read_mapped_in_queue``). Single
    definition so the record-plane fetcher and the device-block fetcher
    cannot drift."""
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

"""Descriptor staging: ship bulk bytes over the data plane, not the
task protocol.

The engine task protocol (engine/worker.py) is a control plane: one
length-prefixed cloudpickle request per connection. Early cluster-mode
builds of the push/merge plane (shuffle/merge.py) and the replication
plane (elastic/replication.py) embedded their block *payloads* inside
those requests, so shuffle-sized volume rode a pickled control socket —
the exact anti-pattern the reference eliminates by keeping bulk bytes
on one-sided READs (SURVEY.md §2 "Data plane").

This module is the staging seam both planes now share:

- the **sender** registers each payload in its node's ProtectionDomain
  and ships only ``(mkey, length)`` descriptors plus its data-plane
  address through the task request (`stage_payloads`), releasing the
  registrations once the receiver's reply confirms the pull;
- the **receiver** resolves the descriptors with a one-sided READ group
  on a ``purpose="data"`` channel (`pull_payloads`) — the same verb,
  channel flavor, and completion contract the shuffle fetcher uses
  (shuffle/fetcher.py), so injected read faults and transport metrics
  cover pushed and replicated bytes exactly like fetched ones.

The task request that carries the descriptors stays O(#blocks), and
benchmarks/soak.py's ``push_absent_from_rpc_handle_ms`` bar keeps the
driver RPC plane (rpc.handle_ms) strictly control-plane.

A copy of the JAX package's ``transport/staging.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import threading
from typing import List, Sequence, Tuple

from sparkrdma_tpu_torch.transport.channel import ChannelError
from sparkrdma_tpu_torch.transport.completion import FnListener

# one staged transfer must never wedge a worker's task thread: the
# sender's socket timeout is 10 s, so fail the pull first and let the
# best-effort contract (silent push miss / durability miss) apply
PULL_TIMEOUT_S = 8.0


def stage_payloads(
    node, payloads: Sequence[bytes]
) -> Tuple[Tuple[str, int], List[Tuple[int, int]], "_Release"]:
    """Register ``payloads`` in ``node``'s ProtectionDomain.

    Returns ``(data_addr, descs, release)``: the node's data-plane
    address, one ``(mkey, length)`` descriptor per payload, and a
    callable that deregisters them all (idempotent — call it in a
    ``finally`` once the receiver has replied)."""
    mkeys = [node.pd.register(memoryview(p)) for p in payloads]
    descs = [(mkey, len(p)) for mkey, p in zip(mkeys, payloads)]
    return (node.host, node.port), descs, _Release(node.pd, mkeys)


class _Release:
    def __init__(self, pd, mkeys: List[int]):
        self._pd = pd
        self._mkeys = mkeys

    def __call__(self) -> None:
        mkeys, self._mkeys = self._mkeys, []
        for mkey in mkeys:
            self._pd.deregister(mkey)


def pull_payloads(
    node,
    data_addr: Tuple[str, int],
    descs: Sequence[Tuple[int, int]],
    timeout_s: float = PULL_TIMEOUT_S,
) -> List[bytes]:
    """One-sided READ of staged ``(mkey, length)`` descriptors.

    Blocks until the whole group lands (the task-protocol reply that
    follows is the sender's release signal) or raises ChannelError on
    failure/timeout."""
    if not descs:
        return []
    host, port = data_addr
    channel = node.get_channel(host, port, purpose="data")
    bufs = [bytearray(length) for _, length in descs]
    done = threading.Event()
    err: List[Exception] = []

    def on_failure(exc: Exception) -> None:
        if not err:
            err.append(exc)
        done.set()

    channel.read_in_queue(
        FnListener(lambda _=None: done.set(), on_failure),
        [memoryview(b) for b in bufs],
        [(mkey, 0, length) for mkey, length in descs],
    )
    if not done.wait(timeout_s):
        raise ChannelError(
            f"staged pull of {len(descs)} block(s) from {host}:{port} "
            f"timed out after {timeout_s}s"
        )
    if err:
        raise ChannelError(f"staged pull failed: {err[0]}") from err[0]
    return [bytes(b) for b in bufs]

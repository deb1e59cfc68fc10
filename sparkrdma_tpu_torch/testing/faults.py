"""Fault injection as a first-class subsystem (docs/RESILIENCE.md).

Promotes the ad-hoc monkeypatching the fault tests started with into a
seeded, config-driven *fault plan* hooked at four seams:

  - ``read``  — one-sided READ verbs (``TpuChannel.read_in_queue``,
    ``NativeTpuChannel.read_in_queue`` / ``read_mapped_in_queue``)
  - ``send``  — two-sided SEND verbs (RPC segment posts)
  - ``rpc``   — message dispatch (``TpuShuffleManager._receive_listener``)
  - ``stage`` — the reduce pipeline's post-transport stages
    (``DeviceShuffleIO.verify_host_block`` = ``stage=decode``,
    ``DeviceShuffleIO.stage_host_block`` = ``stage=stage``): corrupt a
    block AFTER the wire delivered it intact, proving the decode-stage
    checksum gate catches what the transport-level gates cannot see
  - ``push``  — the push/merge plane (shuffle/merge.py): ``drop`` /
    ``fail`` / ``delay`` fire at the client's send phase (lost push →
    originals stay authoritative); ``corrupt`` fires at the endpoint's
    seal phase AFTER the merged checksum tag (reduce path must detect
    and fall back)
  - ``exec``  — executor-death seam (engine/worker.py task entry):
    ``exec:kill:N[:peer=<id>]`` hard-exits the worker process,
    ``exec:hang:N`` wedges the task thread — the elastic layer's chaos
    rig (docs/RESILIENCE.md "Elasticity")
  - ``driver`` — driver/hub-death seam (engine phase boundaries):
    ``driver:kill:N[:stage=reduce_phase]`` wipes the metadata hub
    mid-job; the job must resume through the re-adoption ladder
    (sparkrdma_tpu_torch/metastore, docs/RESILIENCE.md "Control-plane HA")
  - ``meta``  — metadata-peer-death seam (metastore route time):
    ``meta:kill:N[:shard=meta-K]`` revokes one metadata peer's lease
    and remaps its shard ranges; in-flight writes fence with a stale
    epoch and retry against the former follower
  - ``block`` — block-format seam (shuffle/fetcher.py checksum gate):
    ``block:corrupt_header:N`` flips one byte inside a landed columnar
    frame's header/descriptor span (DESIGN.md §25) BEFORE
    verification — the checksum gate must detect, the retry ladder
    refetch, and the reduce path deliver byte-identical rows. Groups
    with no writable columnar frame burn no budget

Fault kinds: ``fail`` (listener.on_failure with :class:`InjectedFault`),
``delay`` (sleep ``delay_ms`` then proceed), ``corrupt`` (flip one
deterministic byte of the delivered payload — the checksum layer's
adversary), ``drop`` (connection drop for verbs; silent message loss
for sends/rpc), ``kill``/``hang`` (exec seam only: process death /
live-but-stuck), ``enosys`` (read seam only: force the native
submission plane's io_uring probe to report unavailable — DESIGN.md
§24 — then let the read proceed; the bytes must arrive identical via
the pread fallback and ``transport.sq.backend_fallbacks`` must tick).

Plans are spec strings — ``op:kind:count[:k=v[,k=v...]]`` joined with
``;`` — so they travel through conf keys (``tpu.shuffle.faultPlan`` +
``faultPlanSeed``), pytest parametrization, and ``bench.py
--fault-plan`` identically. ``count`` 0 means unlimited. Options:
``after=N`` (skip the first N matching ops), ``delay_ms=N``,
``peer=SUBSTR`` (match on the channel's peer description),
``stage=NAME`` (restrict a ``stage`` rule to one pipeline stage, e.g.
``stage:corrupt:1:stage=decode``), ``shard=NAME`` (restrict a ``meta``
rule to one metadata peer, e.g. ``meta:kill:1:shard=meta-0``).

The plan installs process-globally (:func:`install` /
:func:`uninstall` / the :func:`installed` context manager); the hot
path pays one module-attribute None check when no plan is active.
Everything a plan does is deterministic given (spec, seed).

A copy of the JAX package's ``testing/faults.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import contextlib
import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

OPS = ("read", "send", "rpc", "stage", "push", "exec", "driver", "meta", "block")
KINDS = (
    "fail", "delay", "corrupt", "drop", "kill", "hang", "enosys",
    "corrupt_header",
)


class InjectedFault(IOError):
    """The error surfaced by ``fail``/``drop`` rules."""


@dataclass
class FaultRule:
    """One rule of a plan; see module docstring for the spec grammar."""

    op: str
    kind: str
    count: int = 1  # 0 = unlimited
    after: int = 0
    delay_ms: int = 0
    peer: str = ""
    stage: str = ""  # restrict a "stage" rule to one pipeline stage
    shard: str = ""  # restrict a "meta" rule to one metadata peer

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"unknown fault op {self.op!r}; expected one of {OPS}")
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of {KINDS}"
            )

    @classmethod
    def parse(cls, item: str) -> "FaultRule":
        parts = item.strip().split(":")
        if len(parts) < 2:
            raise ValueError(f"fault rule {item!r}: expected op:kind[:count[:opts]]")
        op, kind = parts[0].strip().lower(), parts[1].strip().lower()
        count = int(parts[2]) if len(parts) > 2 and parts[2].strip() else 1
        opts: Dict[str, str] = {}
        if len(parts) > 3 and parts[3].strip():
            for kv in parts[3].split(","):
                k, _, v = kv.partition("=")
                opts[k.strip()] = v.strip()
        return cls(
            op=op,
            kind=kind,
            count=count,
            after=int(opts.pop("after", 0)),
            delay_ms=int(opts.pop("delay_ms", 0)),
            peer=opts.pop("peer", ""),
            stage=opts.pop("stage", ""),
            shard=opts.pop("shard", ""),
        )


class FaultPlan:
    """A seeded set of rules plus its firing bookkeeping. Thread-safe."""

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0, spec: str = ""):
        self.rules: List[FaultRule] = list(rules)
        self.seed = seed
        self.spec = spec or ";".join(
            f"{r.op}:{r.kind}:{r.count}" for r in self.rules
        )
        self._lock = threading.Lock()
        # per-rule: how many matching ops were seen / faults fired
        self._seen = [0] * len(self.rules)
        self._fired = [0] * len(self.rules)
        self.injected: Dict[Tuple[str, str], int] = {}

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        rules = [
            FaultRule.parse(item)
            for item in spec.split(";")
            if item.strip()
        ]
        return cls(rules, seed=seed, spec=spec)

    # -- bookkeeping ----------------------------------------------------
    @property
    def total_injected(self) -> int:
        with self._lock:
            return sum(self.injected.values())

    def injected_count(self, op: str = None, kind: str = None) -> int:
        with self._lock:
            return sum(
                n
                for (o, k), n in self.injected.items()
                if (op is None or o == op) and (kind is None or k == kind)
            )

    def _match(
        self, op: str, peer: str, stage: str = "",
        kinds: Sequence[str] = (), shard: str = ""
    ) -> Optional[Tuple[FaultRule, int]]:
        """First applicable rule for this op, or None. Decrements its
        budget and returns (rule, global fire index) when it fires.
        ``kinds`` restricts matching to those fault kinds — seams with
        several phases (push send vs seal) use it so a rule for the
        other phase neither fires nor burns budget here."""
        with self._lock:
            for i, rule in enumerate(self.rules):
                if rule.op != op:
                    continue
                if kinds and rule.kind not in kinds:
                    continue
                if rule.peer and rule.peer not in peer:
                    continue
                if rule.stage and rule.stage != stage:
                    continue
                if rule.shard and rule.shard != shard:
                    continue
                self._seen[i] += 1
                if self._seen[i] <= rule.after:
                    continue
                if rule.count and self._fired[i] >= rule.count:
                    continue
                self._fired[i] += 1
                key = (rule.op, rule.kind)
                self.injected[key] = self.injected.get(key, 0) + 1
                fire_index = sum(self.injected.values())
                return rule, fire_index
            return None

    def _flip_byte(self, view, fire_index: int) -> None:
        """Deterministically corrupt one byte of a writable buffer."""
        if len(view) == 0:
            return
        rng = random.Random((self.seed << 20) ^ fire_index)
        idx = rng.randrange(len(view))
        view[idx] ^= 0xFF

    # -- seam entry points ---------------------------------------------
    def on_read(
        self, channel, listener, dst_views, blocks
    ) -> Tuple[object, bool]:
        """READ-verb seam. Returns (listener, handled); handled=True
        means the fault consumed the verb and the caller must return."""
        hit = self._match("read", getattr(channel, "peer_desc", ""))
        if hit is None:
            return listener, False
        rule, fire_index = hit
        logger.info("fault plan: %s read on %s", rule.kind, channel.peer_desc)
        if rule.kind == "enosys":
            # force the submission plane's io_uring probe to latch
            # unavailable (as if io_uring_setup returned ENOSYS), then
            # let the read proceed: the pread fallback must deliver
            # byte-identical data. Pure-Python channels have no plane
            # to degrade, so the rule is a counted no-op there.
            node = getattr(channel, "_node", None)
            force = getattr(node, "force_uring_probe_fail", None)
            if force is not None:
                force(True)
            return listener, False
        if rule.kind == "fail":
            listener.on_failure(InjectedFault("injected read fault"))
            return listener, True
        if rule.kind == "drop":
            _drop_channel(channel)
            listener.on_failure(InjectedFault("injected connection drop"))
            return listener, True
        if rule.kind == "delay":
            time.sleep(rule.delay_ms / 1000.0)
            return listener, False
        # corrupt: let the READ complete, then flip one byte of the
        # landed payload before the fetcher sees it (checksum adversary)
        if dst_views is None:
            # mapped delivery exposes read-only page-cache windows; the
            # closest honest corruption is a failed delivery
            listener.on_failure(InjectedFault("injected read fault (mapped)"))
            return listener, True
        inner = listener
        views = list(dst_views)

        class _Corrupting:
            def on_success(self_inner, payload):
                for v in views:
                    if len(v):
                        self._flip_byte(v, fire_index)
                        break
                inner.on_success(payload)

            def on_failure(self_inner, e):
                inner.on_failure(e)

        return _Corrupting(), False

    def on_send(self, channel, listener, segments) -> Tuple[object, bool]:
        """SEND-verb seam. Same contract as :meth:`on_read`."""
        hit = self._match("send", getattr(channel, "peer_desc", ""))
        if hit is None:
            return listener, False
        rule, _ = hit
        logger.info("fault plan: %s send on %s", rule.kind, channel.peer_desc)
        if rule.kind in ("fail", "corrupt"):
            listener.on_failure(InjectedFault("injected send fault"))
            return listener, True
        if rule.kind == "drop":
            # the message is silently lost: success to the sender, the
            # receiver never sees it (lost-datagram semantics)
            listener.on_success(None)
            return listener, True
        time.sleep(rule.delay_ms / 1000.0)
        return listener, False

    def on_rpc(self, peer: str, payload: bytes) -> Tuple[bytes, bool]:
        """RPC-dispatch seam. Returns (payload, handled); handled=True
        discards the message."""
        hit = self._match("rpc", peer)
        if hit is None:
            return payload, False
        rule, fire_index = hit
        logger.info("fault plan: %s rpc from %s", rule.kind, peer)
        if rule.kind in ("fail", "drop"):
            return payload, True
        if rule.kind == "delay":
            time.sleep(rule.delay_ms / 1000.0)
            return payload, False
        mutated = bytearray(payload)
        self._flip_byte(mutated, fire_index)
        return bytes(mutated), False

    def on_stage(self, stage: str, views, peer: str = "") -> None:
        """Reduce-pipeline seam (DeviceShuffleIO decode/staging): fired
        with the block's host views AFTER transport delivered them
        intact. ``corrupt`` flips one byte in place — the adversary the
        decode-stage checksum gate exists for; ``fail``/``drop`` raise
        :class:`InjectedFault` (a failed decode); ``delay`` stalls the
        stage body. Read-only views (mapped page-cache windows) can't
        be corrupted honestly, so ``corrupt`` degrades to a raise.

        The engine task seams also fire here (stages ``map_task`` /
        ``reduce_task``, empty ``views``) passing the owning executor
        id as ``peer`` — ``stage:delay:0:delay_ms=...:stage=map_task,
        peer=exec-1`` slows exactly one executor, the skew injector the
        telemetry straggler tests use."""
        hit = self._match("stage", peer, stage=stage)
        if hit is None:
            return
        rule, fire_index = hit
        logger.info("fault plan: %s in pipeline stage %s", rule.kind, stage)
        if rule.kind == "delay":
            time.sleep(rule.delay_ms / 1000.0)
            return
        if rule.kind == "corrupt":
            for v in views:
                if len(v) and not getattr(v, "readonly", True):
                    self._flip_byte(v, fire_index)
                    return
        raise InjectedFault(f"injected {rule.kind} in pipeline stage {stage}")

    def on_push(self, phase: str, views, peer: str = "") -> bool:
        """Push-plane seam (shuffle/merge.py), two phases:

        - ``send`` (PushClient, before transmission): ``drop``/``fail``
          return True — the push message is silently lost, the merge
          endpoint's coverage stays incomplete and the reduce path
          keeps the original per-map locations; ``delay`` stalls then
          proceeds. ``push:drop:N`` is the canonical lost-push plan.
        - ``seal`` (MergeEndpoint, AFTER the merged segment's checksum
          was computed): ``corrupt`` flips one byte of the sealed
          segment in place, the adversary the reduce path's ordinary
          checksum gate must catch and answer with a fallback to the
          originals. ``push:corrupt:1`` is the canonical plan.

        Each phase matches only its own kinds, so a ``push:corrupt``
        rule never burns budget at the send phase and vice versa.
        Returns True when the push must be dropped (send phase only)."""
        kinds = ("corrupt",) if phase == "seal" else ("fail", "delay", "drop")
        hit = self._match("push", peer, kinds=kinds)
        if hit is None:
            return False
        rule, fire_index = hit
        logger.info("fault plan: %s push (%s phase) peer=%s", rule.kind, phase, peer)
        if rule.kind == "delay":
            time.sleep(rule.delay_ms / 1000.0)
            return False
        if rule.kind == "corrupt":
            for v in views or ():
                if len(v) and not getattr(v, "readonly", True):
                    self._flip_byte(v, fire_index)
                    break
            return False
        return True  # fail/drop: lost push

    def on_exec(self, peer: str = "", stage: str = "") -> None:
        """Executor-death seam (engine/worker.py, fired at task entry —
        the elastic layer's chaos rig, docs/RESILIENCE.md):

        - ``exec:kill:N[:peer=<id>]`` — ``os._exit(1)``: the process
          dies mid-task with no cleanup, exactly like an OOM kill or a
          preempted node. The driver's peer-loss path plus the elastic
          recovery in engine/cluster.py must carry the job.
        - ``exec:hang:N`` — the task thread blocks for ``delay_ms``
          (default 600 s, i.e. effectively forever at test scale): a
          live process that stops making progress, the straggler
          detector's prey.

        Only ``kill``/``hang`` match here, so exec rules never burn
        budget at other seams and vice versa. ``stage`` narrows the
        rule to one task kind (``map_task``/``reduce_task``), e.g.
        ``exec:kill:1:peer=proc-exec-1,stage=reduce_task`` kills that
        executor at its first *reduce* — the mid-reduce chaos case."""
        hit = self._match("exec", peer, stage=stage, kinds=("kill", "hang"))
        if hit is None:
            return
        rule, _ = hit
        logger.warning("fault plan: exec %s on %s", rule.kind, peer)
        if rule.kind == "kill":
            import os

            os._exit(1)
        time.sleep((rule.delay_ms or 600_000) / 1000.0)

    def on_driver(self, stage: str = "") -> bool:
        """Driver-death seam (control-plane HA chaos rig,
        docs/RESILIENCE.md "Control-plane HA"): consulted by the job
        engines at phase boundaries (stage ``reduce_phase`` between map
        and reduce). ``driver:kill:N[:stage=]`` returns True — the
        engine wipes the metadata hub (every registry entry, barrier
        count, and parked replica gone; leases re-grant under bumped
        epochs) and runs the re-adoption ladder. Only ``kill`` matches
        here, so driver rules never burn budget at other seams."""
        hit = self._match("driver", "", stage=stage, kinds=("kill",))
        if hit is None:
            return False
        logger.warning("fault plan: driver kill at stage %s", stage or "?")
        return True

    def on_block(self, views, peer: str = "") -> None:
        """Block-format seam (shuffle/fetcher.py ``_bad_block``): fired
        with a fetched group's landed block views BEFORE the checksum
        gate verifies them. ``block:corrupt_header:N`` finds the first
        *writable* view whose leading frame is columnar
        (shuffle/columnar.py magic behind the 4-byte length prefix) and
        flips one deterministic byte inside the frame's
        header + column-descriptor span — the narrowest adversary of
        the zero-copy decode path: a corrupted dtype code or offset
        table would mis-alias every row, so the gate must catch it
        before a single ``np.frombuffer`` view is built. A group with
        no writable columnar frame (pickle blocks, read-only mapped
        page-cache windows) matches nothing and burns no budget."""
        from sparkrdma_tpu_torch.shuffle import columnar

        target = None
        for v in views or ():
            if getattr(v, "readonly", True) or len(v) < 4 + columnar._HDR.size:
                continue
            if bytes(v[4:6]) == columnar.MAGIC_BYTES:
                target = v
                break
        if target is None:
            return
        hit = self._match("block", peer, kinds=("corrupt_header",))
        if hit is None:
            return
        _rule, fire_index = hit
        logger.info("fault plan: corrupt columnar header from %s", peer or "?")
        span = columnar.header_span(memoryview(target)[4:])
        rng = random.Random((self.seed << 20) ^ fire_index)
        target[4 + rng.randrange(span)] ^= 0xFF

    def on_meta(self, shard: str = "") -> bool:
        """Metadata-peer-death seam (sparkrdma_tpu_torch/metastore): consulted
        by the store at route time with the owner peer's name.
        ``meta:kill:N[:shard=meta-K]`` returns True — the store revokes
        that peer's lease, remaps its ranges, and the in-flight write
        fences with a stale epoch and retries against the former
        follower's copy. Only ``kill`` matches here."""
        hit = self._match("meta", "", kinds=("kill",), shard=shard)
        if hit is None:
            return False
        logger.warning("fault plan: metadata peer kill (%s)", shard or "?")
        return True


def _drop_channel(channel) -> None:
    try:
        channel.stop()
    except Exception:
        logger.exception("fault plan: dropping channel failed")


# ----------------------------------------------------------------------
# process-global installation
# ----------------------------------------------------------------------
_active: Optional[FaultPlan] = None
_install_lock = threading.Lock()


def active() -> Optional[FaultPlan]:
    """The installed plan, or None — THE hot-path check at every seam."""
    return _active


def install(plan: FaultPlan) -> FaultPlan:
    global _active
    with _install_lock:
        _active = plan
    logger.info("fault plan installed: %s (seed %d)", plan.spec, plan.seed)
    return plan


def uninstall() -> Optional[FaultPlan]:
    global _active
    with _install_lock:
        plan, _active = _active, None
    return plan


def ensure_installed(spec: str, seed: int = 0) -> Optional[FaultPlan]:
    """Conf-driven install (manager init): idempotent per spec+seed so
    every manager of an in-process cluster can call it."""
    if not spec:
        return None
    with _install_lock:
        global _active
        if _active is not None and _active.spec == spec and _active.seed == seed:
            return _active
        _active = FaultPlan.parse(spec, seed=seed)
    logger.info("fault plan installed from conf: %s (seed %d)", spec, seed)
    return _active


@contextlib.contextmanager
def installed(plan_or_spec, seed: int = 0):
    """``with faults.installed("read:fail:2"): ...`` — scoped install."""
    plan = (
        plan_or_spec
        if isinstance(plan_or_spec, FaultPlan)
        else FaultPlan.parse(plan_or_spec, seed=seed)
    )
    prev = active()
    install(plan)
    try:
        yield plan
    finally:
        with _install_lock:
            global _active
            _active = prev

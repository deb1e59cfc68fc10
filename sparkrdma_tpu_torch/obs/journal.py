"""Cluster event journal: HLC-ordered control-plane state transitions.

Every production incident in the driver-hub design is explained by a
handful of control-plane transitions — a lease takeover, a replica
promotion, a circuit trip, a quota block, an autotuner re-cut, an SLO
page — but until this module they existed only as counters: magnitudes
without order. The journal makes them an ordered record:

- Each process holds ONE bounded :class:`EventJournal` (process-local
  singleton, like the metrics registry). Control-plane code calls the
  module-level :func:`emit` at its transition sites; when no journal is
  configured (``tpu.shuffle.obs.journal.enabled=false`` or telemetry
  never started) the call is a single module-global load + None check —
  zero hot-path cost by construction.
- Events carry a **hybrid logical clock** ``(l_ms, c)``: ``l`` tracks
  the max wall clock observed, ``c`` breaks ties within one
  millisecond. Heartbeats are the causality-carrying messages — the hub
  folds every ingested event's HLC into its own process clock, so a
  driver event emitted *after* ingesting an executor's events always
  sorts *after* them, regardless of wall-clock skew.
- Events ship on the existing heartbeat payloads (push and pull modes,
  ``payload["journal"]``) with **one-beat redundancy**: each beat
  re-ships the previous beat's batch alongside the new events, so a
  single lost heartbeat loses nothing, and the hub-side
  :class:`JournalHub` merge is idempotent (dedup by ``(origin, seq)``)
  and gap-tolerant (a seq jump is counted, never fatal).
- The merged journal sorts by ``(l, c, origin, seq)`` — a total order
  consistent with causality as carried by heartbeats, with per-emitter
  order always preserved (``seq`` is strictly increasing per process
  and the process HLC never goes backward).

Event taxonomy (``kind`` values; docs/OBSERVABILITY.md "Event journal
& capacity plane"):

==================  ===================================================
kind                transition
==================  ===================================================
meta.takeover       a metastore shard lease expired and was taken over
meta.epoch_bump     hub wipe / driver restart bumped the generation
meta.peer_kill      a metadata peer's lease was revoked (chaos / loss)
meta.adopt          an executor re-published committed state post-wipe
elastic.promote     replicas of a lost executor promoted to primary
elastic.spec        a reduce range was speculatively cloned
elastic.spec_win    a speculative clone finished first
circuit.open        a source circuit breaker opened
circuit.half_open   an open breaker allowed its trial fetch
circuit.close       a breaker closed after a successful trial
admission.enqueue   a job waited for an admission slot
admission.deadline  a job timed out waiting for admission
quota.block         a tenant blocked on a resource quota
quota.release       a blocked tenant's charge finally succeeded
quota.overrun       a blocked tenant overran its deadline grace
autotune.adjust     the WaveAutoTuner re-cut a stage shape's waveBytes
straggler.flag      the robust-z detector flagged an executor
straggler.clear     a flagged executor recovered
slo.page / slo.warn an SLO objective transitioned into breach
slo.recover         a breaching objective recovered
fault.injected      a testing/faults.py rule actually fired
==================  ===================================================

Stdlib-only and jax-free, like the rest of ``obs/``.
A copy of the JAX package's ``obs/journal.py``, its imports rewritten
to this package. Event dicts and the heartbeat's ``journal`` batches
are the JAX package's, so a JAX executor's events merge into a port
hub and the reverse.

"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = [
    "HLC",
    "EventJournal",
    "JournalHub",
    "active_journal",
    "configure",
    "emit",
    "events_to_chrome",
    "extract_events",
    "get_journal",
    "render_timeline",
    "reset",
    "set_enabled",
    "sort_key",
]

DEFAULT_RING_SIZE = 512
DEFAULT_FLIGHT_EVENTS = 64


class HLC:
    """Hybrid logical clock: ``(l_ms, c)`` per Kulkarni et al.

    ``l`` never falls behind the local wall clock; ``c`` disambiguates
    events within one l. :meth:`observe` merges a remote timestamp so
    local events issued after a message sort after the message's
    events. Thread-safe; ticks are a few dict-free integer ops."""

    __slots__ = ("_l", "_c", "_lock")

    def __init__(self) -> None:
        self._l = 0
        self._c = 0
        self._lock = threading.Lock()

    def tick(self, wall_ms: int) -> Tuple[int, int]:
        """Timestamp one local event."""
        with self._lock:
            if wall_ms > self._l:
                self._l = wall_ms
                self._c = 0
            else:
                self._c += 1
            return (self._l, self._c)

    def observe(self, remote: Tuple[int, int], wall_ms: int) -> Tuple[int, int]:
        """Merge a remote HLC (message receive); returns the new local
        clock, which is strictly greater than both inputs' orderings."""
        rl, rc = int(remote[0]), int(remote[1])
        with self._lock:
            l = max(self._l, rl, wall_ms)
            if l == self._l == rl:
                self._c = max(self._c, rc) + 1
            elif l == self._l:
                self._c += 1
            elif l == rl:
                self._c = rc + 1
            else:
                self._c = 0
            self._l = l
            return (self._l, self._c)

    def read(self) -> Tuple[int, int]:
        with self._lock:
            return (self._l, self._c)


def sort_key(event: Mapping) -> Tuple[int, int, str, int]:
    """Total order of merged events: HLC first (causality), then
    ``(origin, seq)`` as a deterministic tie-break."""
    hlc = event.get("hlc") or (0, 0)
    return (int(hlc[0]), int(hlc[1]),
            str(event.get("origin", "")), int(event.get("seq", 0)))


class EventJournal:
    """Process-local bounded journal of control-plane events.

    One per process (module singleton via :func:`configure` /
    :func:`get_journal`); in-process clusters share it across roles, so
    every event carries its own ``role``/``executor`` attribution and
    ``origin`` identifies the emitting *process* for merge dedup."""

    def __init__(
        self,
        role: str = "proc",
        *,
        origin: Optional[str] = None,
        ring_size: int = DEFAULT_RING_SIZE,
        registry=None,
        clock: Callable[[], float] = time.time,
    ):
        self.role = role
        self.origin = origin or f"proc-{os.getpid()}"
        self._clock = clock
        self._hlc = HLC()
        self._lock = threading.Lock()
        self._ring: "deque[dict]" = deque(maxlen=max(8, int(ring_size)))
        self._seq = 0
        if registry is None:
            from sparkrdma_tpu_torch.obs.metrics import get_registry

            registry = get_registry()
        self._c_events = registry.counter("journal.events", role=role)

    # -- write side ----------------------------------------------------
    def emit(
        self,
        kind: str,
        *,
        role: Optional[str] = None,
        executor: str = "",
        tenant: str = "",
        shuffle_id: int = -1,
        span_id: int = 0,
        wall_ms: Optional[int] = None,
        **attrs,
    ) -> dict:
        """Record one typed event. Returns the event dict (wire form).

        Empty/zero identity fields are omitted from the wire form to
        keep heartbeat payloads small; ``attrs`` values must be
        JSON-able scalars/strings."""
        if wall_ms is None:
            wall_ms = int(self._clock() * 1000)
        event: dict = {
            "kind": str(kind),
            "wall_ms": int(wall_ms),
            "origin": self.origin,
            "role": role if role is not None else self.role,
        }
        if executor:
            event["executor"] = str(executor)
        if tenant:
            event["tenant"] = str(tenant)
        if shuffle_id >= 0:
            event["shuffle_id"] = int(shuffle_id)
        if span_id:
            event["span_id"] = int(span_id)
        if attrs:
            event["attrs"] = attrs
        with self._lock:
            # seq assignment and HLC tick must be one atomic step: if a
            # later seq could carry an earlier clock, the merged sort
            # would reorder one emitter's own events
            hlc = self._hlc.tick(wall_ms)
            self._seq += 1
            event["hlc"] = [hlc[0], hlc[1]]
            event["seq"] = self._seq
            self._ring.append(event)
        self._c_events.inc()
        return event

    def observe(self, remote_hlc) -> None:
        """Fold a received event's HLC into this process's clock — the
        message-receive half of the HLC protocol."""
        self._hlc.observe(remote_hlc, int(self._clock() * 1000))

    # -- read side -----------------------------------------------------
    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    def events(self, last: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._ring)
        return out[-last:] if last else out

    def events_since(self, seq: int) -> List[dict]:
        """Non-destructive cursor read: events with ``seq`` greater than
        the given cursor, oldest first. A cursor older than the ring
        simply yields what survived — the shipping layer's one-beat
        redundancy plus the hub's gap counter cover the difference."""
        with self._lock:
            return [e for e in self._ring if e["seq"] > seq]


# ---------------------------------------------------------------------------
# process-local singleton + the zero-overhead emit seam
# ---------------------------------------------------------------------------
_lock = threading.Lock()
_journal: Optional[EventJournal] = None
_suspended: Optional[EventJournal] = None
_disabled = False


def configure(
    conf=None,
    *,
    role: str = "proc",
    origin: Optional[str] = None,
    enabled: Optional[bool] = None,
    ring_size: Optional[int] = None,
    registry=None,
    clock: Callable[[], float] = time.time,
) -> Optional[EventJournal]:
    """Install (or disable) the process journal from conf/overrides.

    Called where telemetry starts (TelemetryHub / worker heartbeat
    setup). Idempotent: a live journal is kept (its ring survives
    reconfiguration) unless the new config disables it."""
    global _journal, _disabled
    on = bool(
        enabled if enabled is not None
        else (conf.journal_enabled if conf is not None else True)
    )
    size = int(
        ring_size if ring_size is not None
        else (conf.journal_ring_size if conf is not None
              else DEFAULT_RING_SIZE)
    )
    with _lock:
        if not on:
            _journal = None
            _disabled = True
            return None
        _disabled = False
        if _journal is None:
            _journal = EventJournal(
                role, origin=origin, ring_size=size,
                registry=registry, clock=clock,
            )
        return _journal


def get_journal() -> EventJournal:
    """The process journal, creating a default-configured one if none
    exists yet (and journaling was not explicitly disabled)."""
    global _journal
    with _lock:
        if _journal is None and not _disabled:
            _journal = EventJournal()
        if _journal is None:
            raise RuntimeError("event journal is disabled")
        return _journal


def active_journal() -> Optional[EventJournal]:
    """The process journal or None — never creates one."""
    return _journal


def emit(kind: str, **kwargs) -> Optional[dict]:
    """Module-level emit used by every control-plane transition site.

    The off path is ONE module-global load and a None check — the
    journal's entire disabled-mode hot-path cost."""
    j = _journal
    if j is None:
        return None
    return j.emit(kind, **kwargs)


def set_enabled(on: bool) -> None:
    """Flip the emit seam WITHOUT discarding the journal.

    Unlike :func:`configure` (which drops the journal when disabling),
    this parks the live journal aside and restores the same object on
    re-enable, preserving ``seq`` continuity and the ring contents — the
    seam the overhead A/B bench and the off-switch test flip."""
    global _journal, _suspended
    with _lock:
        if on:
            if _journal is None and _suspended is not None:
                _journal = _suspended
                _suspended = None
        else:
            if _journal is not None:
                _suspended = _journal
                _journal = None


def reset() -> None:
    """Drop the process journal and re-arm lazy creation (tests)."""
    global _journal, _suspended, _disabled
    with _lock:
        _journal = None
        _suspended = None
        _disabled = False


# ---------------------------------------------------------------------------
# hub-side merge
# ---------------------------------------------------------------------------
class JournalHub:
    """Driver-side merged journal over heartbeat-shipped event batches.

    Merge contract:

    - **idempotent** — events dedup by ``(origin, seq)``, so the
      one-beat redundancy in the shipping layer (and any outright
      heartbeat replay) folds to one copy;
    - **gap-tolerant** — a per-origin seq jump increments
      ``journal.gaps`` and the merge proceeds; nothing blocks on a
      lost event;
    - **causality-folding** — every ingested event's HLC is observed
      into the local process journal's clock, so hub-side events
      emitted after ingest sort after the executor events that caused
      them.
    """

    def __init__(
        self,
        registry=None,
        *,
        role: str = "driver",
        ring_size: int = 4 * DEFAULT_RING_SIZE,
        clock: Callable[[], float] = time.time,
    ):
        self.role = role
        self._clock = clock
        self._ring_size = max(8, int(ring_size))
        self._lock = threading.Lock()
        self._events: Dict[Tuple[str, int], dict] = {}
        self._last_seq: Dict[str, int] = {}
        if registry is None:
            from sparkrdma_tpu_torch.obs.metrics import get_registry

            registry = get_registry()
        self._c_merged = registry.counter("journal.merged", role=role)
        self._c_dups = registry.counter("journal.duplicates", role=role)
        self._c_gaps = registry.counter("journal.gaps", role=role)
        self._g_size = registry.gauge("journal.size", role=role)
        # cursor into the LOCAL process journal: hub-side events fold
        # into the merged view without riding any heartbeat
        self._local_cursor = 0

    def ingest(self, events: Iterable[Mapping]) -> int:
        """Merge one shipped batch; returns how many were new."""
        local = _journal
        merged = 0
        max_hlc: Optional[Tuple[int, int]] = None
        with self._lock:
            for raw in events:
                try:
                    origin = str(raw["origin"])
                    seq = int(raw["seq"])
                    hlc = raw.get("hlc") or (0, 0)
                    hl, hc = int(hlc[0]), int(hlc[1])
                except (KeyError, TypeError, ValueError, IndexError):
                    continue
                key = (origin, seq)
                if key in self._events:
                    self._c_dups.inc()
                    continue
                last = self._last_seq.get(origin, 0)
                if seq > last + 1 and last:
                    self._c_gaps.inc(seq - last - 1)
                if seq > last:
                    self._last_seq[origin] = seq
                self._events[key] = dict(raw)
                merged += 1
                if max_hlc is None or (hl, hc) > max_hlc:
                    max_hlc = (hl, hc)
            self._trim_locked()
            self._g_size.set(len(self._events))
        if merged:
            self._c_merged.inc(merged)
        if max_hlc is not None and local is not None:
            local.observe(max_hlc)
        return merged

    def _trim_locked(self) -> None:
        over = len(self._events) - self._ring_size
        if over <= 0:
            return
        for key, _ in sorted(
            self._events.items(), key=lambda kv: sort_key(kv[1])
        )[:over]:
            del self._events[key]

    def fold_local(self) -> int:
        """Fold the local process journal's new events into the merged
        view (the driver's own transitions never ride a heartbeat)."""
        local = _journal
        if local is None:
            return 0
        events = local.events_since(self._local_cursor)
        if not events:
            return 0
        self._local_cursor = events[-1]["seq"]
        # local events share the hub's process clock: no observe needed
        merged = 0
        with self._lock:
            for e in events:
                key = (str(e["origin"]), int(e["seq"]))
                if key in self._events:
                    continue
                self._events[key] = e
                self._last_seq[key[0]] = max(
                    self._last_seq.get(key[0], 0), key[1]
                )
                merged += 1
            self._trim_locked()
            self._g_size.set(len(self._events))
        if merged:
            self._c_merged.inc(merged)
        return merged

    def merged(
        self,
        last: Optional[int] = None,
        *,
        kinds: Optional[Iterable[str]] = None,
        since_wall_ms: Optional[int] = None,
        until_wall_ms: Optional[int] = None,
    ) -> List[dict]:
        """The causally-ordered merged journal (filters optional;
        ``last`` keeps the N most recent by merged order)."""
        self.fold_local()
        with self._lock:
            out = sorted(self._events.values(), key=sort_key)
        if kinds is not None:
            want = set(kinds)
            out = [e for e in out if e.get("kind") in want]
        if since_wall_ms is not None:
            out = [e for e in out if e.get("wall_ms", 0) >= since_wall_ms]
        if until_wall_ms is not None:
            out = [e for e in out if e.get("wall_ms", 0) <= until_wall_ms]
        return out[-last:] if last else out

    def summary(self) -> dict:
        with self._lock:
            n = len(self._events)
            origins = sorted(self._last_seq)
        return {
            "events": n,
            "origins": [origins],
            "merged": self._c_merged.value,
            "duplicates": self._c_dups.value,
            "gaps": self._c_gaps.value,
        }


# ---------------------------------------------------------------------------
# exports: Chrome trace instants, artifact extraction, timeline render
# ---------------------------------------------------------------------------
def events_to_chrome(events: Iterable[Mapping],
                     pid: int = 0) -> List[dict]:
    """Journal events as Chrome trace *instant* events (``ph:"i"``) on
    the wall-clock timeline the span exporter already uses
    (``ts`` = wall microseconds) — global scope so each event draws a
    full-height marker through the trace."""
    out = []
    for e in sorted(events, key=sort_key):
        args = {
            "hlc": list(e.get("hlc") or (0, 0)),
            "origin": e.get("origin", ""),
            "seq": e.get("seq", 0),
        }
        for k in ("executor", "tenant", "shuffle_id", "span_id"):
            if e.get(k):
                args[k] = e[k]
        args.update(e.get("attrs") or {})
        out.append({
            "name": e.get("kind", "?"),
            "cat": "journal",
            "ph": "i",
            "s": "g",
            "ts": int(e.get("wall_ms", 0)) * 1000,
            "pid": pid,
            "tid": 0,
            "args": args,
        })
    return out


def extract_events(doc) -> List[dict]:
    """Pull journal events out of any artifact that carries them: a
    flight record (``doc["journal"]``), a soak ledger
    (``doc["journal"]`` at top level or under ``doc["slo"]``), a live
    snapshot dict, or a bare event list."""
    if isinstance(doc, list):
        return [e for e in doc if isinstance(e, Mapping) and "kind" in e]
    if not isinstance(doc, Mapping):
        return []
    for key in ("journal", "events"):
        v = doc.get(key)
        if isinstance(v, list):
            return extract_events(v)
        if isinstance(v, Mapping) and isinstance(v.get("events"), list):
            return extract_events(v["events"])
    slo = doc.get("slo")
    if isinstance(slo, Mapping):
        return extract_events(slo)
    return []


def render_timeline(events: Iterable[Mapping],
                    limit: Optional[int] = None) -> str:
    """Human-readable causally-ordered incident timeline."""
    ordered = sorted(events, key=sort_key)
    if limit:
        ordered = ordered[-limit:]
    if not ordered:
        return "journal timeline: no events"
    t0 = min(int(e.get("wall_ms", 0)) for e in ordered)
    out = [f"journal timeline ({len(ordered)} events, t0={t0} ms epoch)"]
    for e in ordered:
        hlc = e.get("hlc") or (0, 0)
        who = e.get("executor") or e.get("role", "")
        extras = []
        if e.get("tenant"):
            extras.append(f"tenant={e['tenant']}")
        if e.get("shuffle_id") is not None and "shuffle_id" in e:
            extras.append(f"shuffle={e['shuffle_id']}")
        for k, v in sorted((e.get("attrs") or {}).items()):
            extras.append(f"{k}={v}")
        out.append(
            f"  +{int(e.get('wall_ms', 0)) - t0:>7} ms "
            f"hlc=({int(hlc[0]) - t0},{hlc[1]:>2}) "
            f"{e.get('kind', '?'):<20} {who:<10} "
            + " ".join(extras)
        )
    return "\n".join(out)

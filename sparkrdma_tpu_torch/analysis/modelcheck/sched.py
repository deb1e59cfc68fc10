"""Cooperative scheduler: run real protocol threads one at a time.

Deterministic-simulation testing in the loom/shuttle style: the model's
threads are real ``threading.Thread`` objects running the REAL protocol
code, but only ONE ever runs at a time. Each thread parks at every
*schedule point* — ``OrderedLock`` acquire/release (grafted into
analysis/lockorder.py), pipeline queue handoffs, task-protocol
send/recv, timer fires, and explicit ``proto`` seams in the protocol
bodies — and the scheduler picks which parked thread resumes next. A
seeded picker makes any schedule replayable; an exhaustive picker
enumerates them.

Time is virtual: ``time.sleep``/``Condition.wait(timeout)``/
``Event.wait(timeout)`` park the thread with a logical deadline, and
the clock jumps to the earliest deadline only when nothing is runnable.
No wall-clock waits, so a full schedule runs in microseconds and
timers/backoffs/deadlines fire in a controlled logical order.

Blocking primitives are virtualized only for scheduler-registered
threads: while a scheduler is active, ``threading.Condition`` wait /
notify, ``threading.Event`` wait/set, and ``time`` sleep/monotonic/
perf_counter dispatch to cooperative implementations for sim threads
and to the saved real functions for everything else. The harness's own
handshakes use raw ``threading.Lock`` gates (never Condition/Event —
those are patched) so the machinery cannot intercept itself.

Atomicity rule: code between two schedule points is atomic under this
scheduler. Raw ``threading.Lock`` critical sections are therefore safe
exactly when they contain no schedule point; sections that do must use
``named_lock`` so the scheduler tracks ownership (see the lock
skip-list: hot bookkeeping locks like ``metrics.registry`` are tracked
but never parked on, so metric increments under raw locks stay atomic).

Quiescent points — park points where no sim thread holds any
``OrderedLock`` — are where invariant oracles run: protocol state is
between critical sections, so the oracle sees only states the protocol
itself considers consistent.

A copy of the JAX package's ``analysis/modelcheck/sched.py``, its
imports rewritten to this package, with one change: ``_patch`` saves
every function it replaces when it installs (the JAX module saves all
but ``time.sleep`` at import), and ``_unpatch`` restores each only
where its own replacement is still installed. The JAX and port
schedulers, and both lock-order detectors, patch the same attributes;
run one after another in one process, neither leaves the other's
functions installed. ``run`` refuses to start while this package's
scheduler is active; the two packages' schedulers must not run at
once.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

__all__ = [
    "Action",
    "CooperativeScheduler",
    "DeadlockError",
    "ModelCrash",
    "OracleViolation",
    "ReplayDivergence",
    "ScheduleTooLong",
    "SimFuture",
    "SimPool",
    "active",
    "schedule_point",
]


class OracleViolation(AssertionError):
    """An invariant oracle failed at a quiescent point."""


class DeadlockError(AssertionError):
    """No thread runnable and no pending virtual deadline."""


class ScheduleTooLong(AssertionError):
    """Schedule exceeded the per-run step bound (livelock guard)."""


class ReplayDivergence(AssertionError):
    """A replayed choice named a thread that is not runnable."""


class ModelCrash(AssertionError):
    """A sim thread died on an unhandled exception."""


class _Killed(BaseException):
    """Raised inside sim threads to unwind them during drain.

    BaseException so protocol-level ``except Exception`` fallbacks do
    not swallow it.
    """


#: the active scheduler, or None. Interception sites load this ONE
#: module attribute and branch — the disabled cost, exactly like the
#: lock-order detector's ``_det.enabled``.
active: Optional["CooperativeScheduler"] = None


def schedule_point(kind: str, name: str) -> None:
    """Explicit seam in protocol code; no-op unless a scheduler runs."""
    sched = active
    if sched is not None:
        sched.point(kind, name)


class Action:
    """What a parked thread will do next — the exploration alphabet.

    ``key`` identifies the resource for enabledness and independence
    (the lock instance id for lock actions, None otherwise).
    """

    __slots__ = ("kind", "name", "key")

    def __init__(self, kind: str, name: str, key: Optional[int] = None):
        self.kind = kind
        self.name = name
        self.key = key

    def __repr__(self) -> str:
        return f"{self.kind}:{self.name}"


class SimThread:
    """One scheduler-controlled thread. Parks on a raw-Lock gate."""

    def __init__(self, sched: "CooperativeScheduler", name: str, fn: Callable):
        self.sched = sched
        self.name = name
        self.fn = fn
        # held closed except for the instant the scheduler resumes us
        self.gate = threading.Lock()
        self.gate.acquire()
        self.state = "runnable"  # runnable | blocked | finished
        self.pending = Action("start", name)
        self.deadline: Optional[float] = None
        self.notified = False
        self.block_count = 0
        self.exc: Optional[BaseException] = None
        self.thread = threading.Thread(
            target=self._main, name=f"mc:{name}", daemon=True
        )

    def _main(self) -> None:
        self.sched._register(self)
        self.gate.acquire()  # first resume
        try:
            if self.sched._draining:
                raise _Killed()
            self.fn()
        except _Killed:
            pass
        except BaseException as e:  # noqa: BLE001 — surfaced as ModelCrash
            self.exc = e
        finally:
            self.state = "finished"
            self.sched._control.release()


class CooperativeScheduler:
    """Owns the sim threads, the virtual clock, and the step loop."""

    #: lock NAMES whose acquire/release never park (hot bookkeeping
    #: locks acquired under raw locks in protocol code; parking there
    #: would really-block another sim thread). Still ownership-tracked.
    no_park_locks: Set[str] = {"metrics.registry", "quota.table"}

    def __init__(self, trace_actions: bool = False):
        self.threads: List[SimThread] = []
        self._by_ident: Dict[int, SimThread] = {}
        # scheduler waits here; a parking sim thread releases it
        self._control = threading.Lock()
        self._control.acquire()
        self._meta = threading.Lock()  # spawn/waiter tables
        self.now = 0.0
        # id(OrderedLock) -> (owner SimThread, reentry count)
        self.owners: Dict[int, Tuple[SimThread, int]] = {}
        self.lock_names: Dict[int, str] = {}
        # id(waitable) -> FIFO of blocked SimThreads
        self.waiters: Dict[int, List[SimThread]] = {}
        self.trace: List[str] = []
        self.actions: List[str] = [] if trace_actions else None  # type: ignore[assignment]
        self.on_quiescent: Optional[Callable[[], None]] = None
        self._draining = False
        self._started = False
        # True while a sim thread is inside Thread.start() (see spawn)
        self._spawning = False

    # -- setup ----------------------------------------------------------
    def spawn(self, name: str, fn: Callable) -> SimThread:
        t = SimThread(self, name, fn)
        with self._meta:
            self.threads.append(t)
        if self._started:
            # Thread.start() blocks on the child's internal _started
            # Event, which the child's bootstrap sets at a WALL-CLOCK
            # moment. The global Event/Condition patches must not turn
            # that into a schedule point, or whether the spawner parks
            # there is a real race and identical prefixes stop being
            # replayable. Only one sim thread runs at a time, so a
            # plain flag is race-free.
            self._spawning = True
            try:
                t.thread.start()
            finally:
                self._spawning = False
        return t

    def _register(self, t: SimThread) -> None:
        with self._meta:
            self._by_ident[threading.get_ident()] = t

    def _current(self) -> Optional[SimThread]:
        return self._by_ident.get(threading.get_ident())

    # -- park/resume handshake -----------------------------------------
    def _park(
        self,
        t: SimThread,
        action: Action,
        blocked: bool = False,
        deadline: Optional[float] = None,
    ) -> None:
        if self._draining:
            raise _Killed()
        t.pending = action
        t.deadline = deadline
        # NB: ``notified`` is NOT cleared here — a notifier may run while
        # this thread is parked releasing the waitable's lock (cond.wait
        # registers as waiter first), and that early notification must
        # survive until the wait-park checks it. Waiters clear the flag
        # at wait ENTRY instead.
        if blocked:
            t.block_count += 1
        t.state = "blocked" if blocked else "runnable"
        self._control.release()
        t.gate.acquire()
        if self._draining:
            raise _Killed()
        t.state = "running"

    def point(self, kind: str, name: str, key: Optional[int] = None) -> None:
        t = self._current()
        if t is None:
            return
        self._park(t, Action(kind, name, key))

    # -- lock interception (called from OrderedLock) --------------------
    def before_lock_acquire(self, lock) -> None:
        t = self._current()
        if t is None:
            return
        if lock.name in self.no_park_locks:
            return
        self._park(t, Action("lock.acquire", lock.name, key=id(lock)))

    def after_lock_acquire(self, lock) -> None:
        t = self._current()
        if t is None:
            return
        self.lock_names[id(lock)] = lock.name
        owner = self.owners.get(id(lock))
        if owner is not None and owner[0] is not t:
            # a non-sim thread slipped in, or tracking drifted: surface
            raise OracleViolation(
                f"lock {lock.name!r} acquired by {t.name} while scheduler "
                f"thought {owner[0].name} held it"
            )
        self.owners[id(lock)] = (t, (owner[1] + 1) if owner else 1)

    def after_lock_release(self, lock) -> None:
        t = self._current()
        if t is None:
            return
        owner = self.owners.get(id(lock))
        if owner is not None and owner[0] is t:
            if owner[1] > 1:
                self.owners[id(lock)] = (t, owner[1] - 1)
            else:
                del self.owners[id(lock)]
        if lock.name in self.no_park_locks:
            return
        self._park(t, Action("lock.release", lock.name, key=id(lock)))

    # -- cooperative waitables -----------------------------------------
    def _wait_on(self, key: int, name: str, timeout: Optional[float]) -> bool:
        """Block the current sim thread on ``key``; True = notified."""
        t = self._current()
        assert t is not None
        t.notified = False
        with self._meta:
            self.waiters.setdefault(key, []).append(t)
        deadline = self.now + timeout if timeout is not None else None
        self._park(
            t, Action("wait", name, key=key), blocked=True, deadline=deadline
        )
        if not t.notified:
            with self._meta:
                q = self.waiters.get(key, [])
                if t in q:
                    q.remove(t)
        return t.notified

    def _notify_key(self, key: int, n: Optional[int] = None) -> None:
        with self._meta:
            q = self.waiters.get(key, [])
            woken = q[:] if n is None else q[:n]
            del q[: len(woken)]
        for t in woken:
            t.notified = True
            t.state = "runnable"

    # -- the step loop --------------------------------------------------
    def _enabled(self, t: SimThread) -> bool:
        if t.state != "runnable":
            return False
        a = t.pending
        if a.kind == "lock.acquire" and a.key is not None:
            owner = self.owners.get(a.key)
            return owner is None or owner[0] is t
        return True

    def runnable_threads(self) -> List[SimThread]:
        return [
            t
            for t in self.threads
            if t.state != "finished" and self._enabled(t)
        ]

    def run(self, picker, max_steps: int = 20000) -> None:
        """Drive every sim thread to completion under ``picker``.

        ``picker.pick(step, runnable)`` returns the SimThread to resume.
        Raises the first oracle violation / deadlock / crash / replay
        divergence; the caller owns interpretation.
        """
        global active
        if active is not None:
            raise RuntimeError("another CooperativeScheduler is active")
        active = self
        _patch()
        self._started = True
        try:
            for t in list(self.threads):
                t.thread.start()
            step = 0
            while True:
                live = [t for t in self.threads if t.state != "finished"]
                for t in self.threads:
                    if t.exc is not None:
                        raise ModelCrash(
                            f"thread {t.name} crashed: {t.exc!r}"
                        ) from t.exc
                if not live:
                    return
                runnable = [t for t in live if self._enabled(t)]
                if not runnable:
                    deadlines = [
                        t.deadline
                        for t in live
                        if t.state == "blocked" and t.deadline is not None
                    ]
                    if not deadlines:
                        held = {
                            self.lock_names.get(k, str(k)): o[0].name
                            for k, o in self.owners.items()
                        }
                        raise DeadlockError(
                            f"deadlock: {[t.name for t in live]} all blocked, "
                            f"no pending deadline; held locks: {held}"
                        )
                    self.now = max(self.now, min(deadlines))
                    for t in live:
                        if (
                            t.state == "blocked"
                            and t.deadline is not None
                            and t.deadline <= self.now
                        ):
                            t.state = "runnable"  # timed out, not notified
                    continue
                chosen = picker.pick(step, runnable)
                self.trace.append(chosen.name)
                if self.actions is not None:
                    self.actions.append(f"{chosen.name}@{chosen.pending!r}")
                step += 1
                if step > max_steps:
                    raise ScheduleTooLong(
                        f"schedule exceeded {max_steps} steps (livelock?)"
                    )
                chosen.gate.release()
                self._control.acquire()
                if (
                    self.on_quiescent is not None
                    and not self.owners
                    and not self._draining
                ):
                    self.on_quiescent()
        finally:
            self._drain()
            _unpatch()
            active = None

    def _drain(self) -> None:
        """Unwind unfinished sim threads via _Killed, one at a time —
        every parked thread is woken exactly once and releases the
        control lock exactly once on its way out, keeping the handshake
        balanced even while threads unwind through protocol cleanup."""
        self._draining = True
        for _ in range(len(self.threads) + 1000):
            live = [
                t
                for t in self.threads
                if t.state != "finished" and t.thread.ident is not None
            ]
            if not live:
                break
            try:
                live[0].gate.release()
            except RuntimeError:
                pass
            self._control.acquire()
        for t in self.threads:
            if t.thread.is_alive() or t.thread.ident is not None:
                t.thread.join(timeout=5.0)


class SimFuture:
    """Future for :class:`SimPool`; callbacks run on the worker thread,
    exactly like ``concurrent.futures`` — so first-finisher callback
    races are part of the explored schedule space."""

    def __init__(self) -> None:
        self._done = False
        self._result = None
        self._exc: Optional[BaseException] = None
        self._cbs: List[Callable] = []

    def done(self) -> bool:
        return self._done

    def result(self):
        if self._exc is not None:
            raise self._exc
        return self._result

    def exception(self) -> Optional[BaseException]:
        return self._exc

    def add_done_callback(self, cb: Callable) -> None:
        if self._done:
            cb(self)
        else:
            self._cbs.append(cb)

    def _finish(self, result, exc: Optional[BaseException]) -> None:
        self._result = result
        self._exc = exc
        self._done = True
        for cb in self._cbs:
            cb(self)


class SimPool:
    """Executor facade that spawns a sim thread per submit."""

    def __init__(self, sched: CooperativeScheduler, prefix: str = "pool"):
        self._sched = sched
        self._prefix = prefix
        self._n = 0

    def submit(self, fn: Callable, *args, **kwargs) -> SimFuture:
        fut = SimFuture()
        self._n += 1
        name = f"{self._prefix}-{self._n}"

        def run() -> None:
            try:
                result = fn(*args, **kwargs)
            except _Killed:
                raise
            except BaseException as e:  # noqa: BLE001 — future carries it
                fut._finish(None, e)
            else:
                fut._finish(result, None)

        self._sched.spawn(name, run)
        return fut


# ----------------------------------------------------------------------
# blocking-primitive virtualization (installed only while a scheduler
# is active; sim threads get cooperative semantics, everything else the
# saved real functions)
# ----------------------------------------------------------------------
# the functions the patch replaced, saved when it is installed (not at
# import): the lock-order detectors patch time.sleep too
# (lockorder._activate), and the JAX package's scheduler patches the same
# attributes, so the scheduler puts back whatever was there when it
# started, and only where its own function is still installed
_real_cond_wait = threading.Condition.wait
_real_cond_notify = threading.Condition.notify
_real_cond_notify_all = threading.Condition.notify_all
_real_event_wait = threading.Event.wait
_real_event_set = threading.Event.set
_real_sleep = time.sleep
_real_monotonic = time.monotonic
_real_perf_counter = time.perf_counter
_patched = False


def _sim() -> Optional[SimThread]:
    sched = active
    if sched is None or sched._draining:
        return None
    return sched._current()


def _coop_cond_wait(self, timeout=None):
    t = _sim()
    sched = active
    if t is None or sched is None or sched._spawning:
        return _real_cond_wait(self, timeout)
    # register as waiter BEFORE releasing the lock: a notifier scheduled
    # during the release park must see us (no lost wakeup)
    t.notified = False
    with sched._meta:
        sched.waiters.setdefault(id(self), []).append(t)
    lock = self._lock
    lock.release()
    deadline = sched.now + timeout if timeout is not None else None
    try:
        # the release above is itself a park point — the notification may
        # already have landed while we were parked there; only park as
        # blocked if it hasn't (else we'd clobber our runnable state and
        # sleep to the deadline on a wakeup that already happened)
        if not t.notified:
            sched._park(
                t,
                Action("wait", "cond", key=id(self)),
                blocked=True,
                deadline=deadline,
            )
    finally:
        if not t.notified:
            with sched._meta:
                q = sched.waiters.get(id(self), [])
                if t in q:
                    q.remove(t)
    notified = t.notified
    lock.acquire()
    return notified


def _coop_cond_notify(self, n=1):
    sched = active
    if sched is None or sched._current() is None:
        return _real_cond_notify(self, n)
    sched._notify_key(id(self), n)
    if self._waiters:  # real (non-sim) waiters, if any
        _real_cond_notify(self, n)


def _coop_cond_notify_all(self):
    sched = active
    if sched is None or sched._current() is None:
        return _real_cond_notify_all(self)
    sched._notify_key(id(self), None)
    if self._waiters:
        _real_cond_notify_all(self)


def _coop_event_wait(self, timeout=None):
    t = _sim()
    sched = active
    if t is None or sched is None or sched._spawning:
        return _real_event_wait(self, timeout)
    if self.is_set():
        return True
    sched._wait_on(id(self), "event", timeout)
    return self.is_set()


def _coop_event_set(self):
    _real_event_set(self)
    sched = active
    if sched is not None and not sched._draining:
        sched._notify_key(id(self), None)


def _coop_sleep(secs):
    t = _sim()
    sched = active
    if t is None or sched is None:
        return _real_sleep(secs)
    sched._park(
        t,
        Action("timer", f"sleep:{secs:g}"),
        blocked=True,
        deadline=sched.now + max(0.0, secs),
    )


def _coop_monotonic():
    sched = active
    if sched is None or _sim() is None:
        return _real_monotonic()
    return sched.now


def _coop_perf_counter():
    sched = active
    if sched is None or _sim() is None:
        return _real_perf_counter()
    return sched.now


#: (owner, attribute, the name of the saved function, the replacement)
_PATCHES = (
    (threading.Condition, "wait", "_real_cond_wait", _coop_cond_wait),
    (threading.Condition, "notify", "_real_cond_notify", _coop_cond_notify),
    (threading.Condition, "notify_all", "_real_cond_notify_all", _coop_cond_notify_all),
    (threading.Event, "wait", "_real_event_wait", _coop_event_wait),
    (threading.Event, "set", "_real_event_set", _coop_event_set),
    (time, "sleep", "_real_sleep", _coop_sleep),
    (time, "monotonic", "_real_monotonic", _coop_monotonic),
    (time, "perf_counter", "_real_perf_counter", _coop_perf_counter),
)


def _patch() -> None:
    global _patched
    if _patched:
        return
    g = globals()
    for owner, attr, saved, coop in _PATCHES:
        g[saved] = getattr(owner, attr)
        setattr(owner, attr, coop)
    _patched = True


def _unpatch() -> None:
    global _patched
    if not _patched:
        return
    g = globals()
    for owner, attr, saved, coop in _PATCHES:
        # a probe patched over ours stays, and calls ours, which passes
        # through to the saved function while no scheduler is active
        if getattr(owner, attr) is coop:
            setattr(owner, attr, g[saved])
    _patched = False

"""ReduceTaskPipeline — the pipelined reduce plane.

BENCH_r05/WORKLOADS_r05 pinned the reduce-side loss: raw one-sided READ
sustains 4.02 GB/s but the *consumed* rate is 1.46 GB/s against a
2.41 GB/s roofline, and the TeraSort e2e reduce wall saved only 0.83 s
of fetch/merge overlap — fetch, checksum/decode, host→HBM staging and
device merge ran strictly in sequence, the exact shape the map plane's
``MapTaskPipeline`` (shuffle/writer/pipeline.py) already eliminated.
This is its reduce-side mirror:

    fetch (group READs in flight)        group k+2   (wire / fetcher)
      -> decode pool                     group k+1   (checksum +
                                                      decompress +
                                                      deserialize)
        -> stage                         group k     (host -> HBM)
          -> merge / deliver             group k-1   (device compute /
                                                      the consumer)

Stage concurrency:

- the *fetch* stage is one thread pulling the source iterator — for the
  record plane that iterator is :class:`TpuShuffleFetcherIterator`,
  which already issues group READs ahead under ``maxBytesInFlight``;
  the thread's blocking wait on arrivals IS the measured fetch time,
- ``parallelism`` decode workers (conf ``reduce.parallelism``) take
  checksum verify + decompress + deserialize OFF the fetch thread,
- a sequencer re-orders decode-pool output back to source order before
  the stage body runs, so **delivery order is invariant under
  parallelism** — ``parallelism=1`` and ``parallelism=N`` deliver the
  exact same sequence the serial loop did,
- the stage and merge bodies run on separate threads when
  ``double_buffer`` is on (conf ``reduce.doubleBufferStaging``): the
  host→HBM transfer of group k+1 rides under the device merge of
  group k — classic double-buffered staging. Off, one thread runs
  stage+merge back to back (strictly serialized staging).

Abort semantics mirror the map plane: the first error latches,
everything in flight drains WITHOUT delivering (``discard_fn`` releases
each undelivered item's resources — streams, host blocks, device
buffers), and the error re-raises to the consumer. An early-closing
consumer (generator finalization, ``close()``) takes the same path, so
registered slices and mapped windows always release deterministically.

Observability (docs/OBSERVABILITY.md): per-item latency histograms
``reader.pipeline.stage_ms{stage=fetch|decode|stage|merge}``, the live
``reader.pipeline.inflight`` gauge, and ``reader.pipeline.overlap_ms``
— per-run sum-of-stage-busy minus wall, the time the overlap SAVED.

A copy of the JAX package's ``shuffle/reader/pipeline.py``, its imports
rewritten to this package (the lock-order and model-checker calls go to the
port's ``analysis/lockorder.py`` and ``analysis/modelcheck``).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterable, Iterator, List, Optional

from sparkrdma_tpu_torch import tenancy
from sparkrdma_tpu_torch.analysis.modelcheck import schedule_point
from sparkrdma_tpu_torch.obs import get_registry, get_tracer
from sparkrdma_tpu_torch.shuffle.writer.pipeline import PipelineReport, _STAGE_BOUNDS

STAGES = ("fetch", "decode", "stage", "merge")

_CLOSE = object()  # queue sentinel: upstream is done
_SKIP = object()  # sequencer marker: item discarded (abort/error)


class ReduceTaskPipeline:
    """Bounded four-stage reduce pipeline over fetched items.

    ``fetch_fn(item)``, ``decode_fn(item, fetched)``, ``stage_fn(item,
    decoded)``, ``merge_fn(item, staged)`` are the stage bodies; any may
    be None to pass its input through. ``run(source)`` collects a
    :class:`PipelineReport`; ``stream(source)`` yields merged outputs
    lazily IN SOURCE ORDER (the record plane's consumption mode) and
    records the report on :attr:`last_report` once exhausted.

    ``discard_fn(stage, item, value)`` releases an undelivered item's
    resources during an abort drain; ``stage`` names the pipeline stage
    whose OUTPUT ``value`` is (``"fetch"`` = fetched-but-undecoded,
    ``"decode"`` = decoded, ``"stage"`` = staged).
    """

    def __init__(
        self,
        fetch_fn: Optional[Callable[[Any], Any]],
        decode_fn: Optional[Callable[[Any, Any], Any]],
        stage_fn: Optional[Callable[[Any, Any], Any]],
        merge_fn: Optional[Callable[[Any, Any], Any]] = None,
        *,
        parallelism: int = 2,
        depth: int = 2,
        double_buffer: bool = True,
        role: str = "reader",
        discard_fn: Optional[Callable[[str, Any, Any], None]] = None,
    ):
        self._fetch_fn = fetch_fn
        self._decode_fn = decode_fn
        self._stage_fn = stage_fn
        self._merge_fn = merge_fn
        self._parallelism = max(1, int(parallelism))
        self._depth = max(1, int(depth))
        self._double_buffer = bool(double_buffer)
        self._role = role
        self._discard_fn = discard_fn
        self.last_report: Optional[PipelineReport] = None
        # live-run state, set while stream() is active so close() can
        # abort a pipeline its consumer abandoned
        self._abort: Optional[threading.Event] = None

    # ------------------------------------------------------------------
    def abort(self) -> None:
        """Latch the abort flag of a live ``stream``; in-flight items
        drain without delivering. No-op when nothing is running."""
        ev = self._abort
        if ev is not None:
            ev.set()

    def run(self, source: Iterable[Any]) -> PipelineReport:
        """Drive the pipeline to completion, collecting ordered results."""
        results = list(self.stream(source))
        report = self.last_report
        report.results = results
        return report

    # ------------------------------------------------------------------
    def stream(self, source: Iterable[Any]) -> Iterator[Any]:
        # fetch/decode/stage/merge run on bare threads: inherit the
        # consuming task's tenant for buffer charges and breaker keys
        tenant = tenancy.current_tenant()
        reg = get_registry()
        inflight = reg.gauge("reader.pipeline.inflight", role=self._role)
        hists = {
            s: reg.histogram(
                "reader.pipeline.stage_ms",
                bounds=_STAGE_BOUNDS,
                role=self._role,
                stage=s,
            )
            for s in STAGES
        }
        busy = {s: 0.0 for s in STAGES}
        busy_lock = threading.Lock()
        abort = threading.Event()
        self._abort = abort
        errbox: List[BaseException] = []
        err_lock = threading.Lock()

        def fail(e: BaseException) -> None:
            with err_lock:
                if not errbox:
                    errbox.append(e)
            abort.set()

        tracer = get_tracer(self._role)

        def timed(stage: str, follows, fn: Callable, *args):
            """Run one stage body inside a ``reader.pipeline.<stage>``
            span that causally follows the item's previous stage span
            (the queue hand-off edge). Returns (result, span)."""
            t0 = time.perf_counter()
            try:
                with tracer.span(
                    "reader.pipeline." + stage, follows=follows
                ) as sp:
                    return fn(*args), sp
            finally:
                dt = time.perf_counter() - t0
                hists[stage].observe(dt * 1e3)
                with busy_lock:
                    busy[stage] += dt

        def discard(stage: str, item: Any, value: Any) -> None:
            # _SKIP marks an item a previous stage already discarded —
            # its resources are gone and its inflight slot is freed
            if value is _SKIP:
                return
            try:
                if self._discard_fn is not None:
                    self._discard_fn(stage, item, value)
            except Exception as e:  # noqa: BLE001 — drain must finish
                fail(e)
            finally:
                inflight.add(-1)

        # fetch -> decode handoff: bounded, so decode backpressures the
        # fetch thread instead of decoding the whole shuffle ahead of a
        # slow consumer
        decode_q: "queue.Queue" = queue.Queue(self._depth)
        # decode -> sequencer reorder buffer: decode-pool completions
        # land keyed by source index; the sequencer releases them in
        # order. Bounded implicitly: at most parallelism + depth items
        # are past the fetch stage at once.
        seq_lock = threading.Lock()
        seq_ready = threading.Condition(seq_lock)
        seq_buf: dict = {}
        total_box = {"n": None}  # set when the source is exhausted
        # stage -> merge double buffer (only when split across threads)
        merge_q: "queue.Queue" = queue.Queue(1)
        # merge -> consumer handoff
        out_q: "queue.Queue" = queue.Queue(self._depth)

        def fetch_main() -> None:
            it = iter(source)
            idx = 0
            try:
                while not abort.is_set():
                    t0 = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    finally:
                        dt = time.perf_counter() - t0
                        with busy_lock:
                            busy["fetch"] += dt
                    inflight.add(1)
                    try:
                        fetched, sp = (
                            timed("fetch", None, self._fetch_fn, item)
                            if self._fetch_fn is not None
                            else (item, None)
                        )
                    except BaseException as e:  # noqa: BLE001
                        fail(e)
                        inflight.add(-1)
                        break
                    schedule_point("queue", "reader.decode_q.put")
                    decode_q.put((idx, item, fetched, sp))
                    idx += 1
            except BaseException as e:  # noqa: BLE001
                fail(e)
            finally:
                with seq_ready:
                    total_box["n"] = idx
                    seq_ready.notify_all()
                decode_q.put(_CLOSE)

        def decode_main() -> None:
            while True:
                schedule_point("queue", "reader.decode_q.get")
                got = decode_q.get()
                if got is _CLOSE:
                    decode_q.put(_CLOSE)  # release sibling workers
                    return
                idx, item, fetched, prev = got
                if abort.is_set():
                    discard("fetch", item, fetched)
                    decoded, sp = _SKIP, None
                else:
                    try:
                        decoded, sp = (
                            timed("decode", prev, self._decode_fn, item, fetched)
                            if self._decode_fn is not None
                            else (fetched, prev)
                        )
                    except BaseException as e:  # noqa: BLE001
                        fail(e)
                        discard("fetch", item, fetched)
                        decoded, sp = _SKIP, None
                with seq_ready:
                    seq_buf[idx] = (item, decoded, sp)
                    seq_ready.notify_all()

        def next_in_order():
            """Sequencer: block for the next source-order item. Returns
            (idx, item, decoded) or None when the run is complete —
            ordering is enforced HERE, so any decode parallelism
            delivers the exact sequence the serial loop would."""
            want = next_in_order.want
            with seq_ready:
                while True:
                    if want in seq_buf:
                        item, decoded, sp = seq_buf.pop(want)
                        next_in_order.want = want + 1
                        return want, item, decoded, sp
                    n = total_box["n"]
                    if n is not None and want >= n:
                        return None
                    seq_ready.wait()

        next_in_order.want = 0

        def stage_one(idx, item, decoded, prev):
            if decoded is _SKIP or abort.is_set():
                discard("decode", item, decoded)
                return None, None, False
            try:
                staged, sp = (
                    timed("stage", prev, self._stage_fn, item, decoded)
                    if self._stage_fn is not None
                    else (decoded, prev)
                )
                return staged, sp, True
            except BaseException as e:  # noqa: BLE001
                fail(e)
                discard("decode", item, decoded)
                return None, None, False

        def merge_one(idx, item, staged, prev) -> None:
            if abort.is_set():
                discard("stage", item, staged)
                return
            try:
                out, _sp = (
                    timed("merge", prev, self._merge_fn, item, staged)
                    if self._merge_fn is not None
                    else (staged, prev)
                )
            except BaseException as e:  # noqa: BLE001
                fail(e)
                discard("stage", item, staged)
                return
            schedule_point("queue", "reader.out_q.put")
            out_q.put((idx, out))

        def stage_main() -> None:
            while True:
                nxt = next_in_order()
                if nxt is None:
                    if self._double_buffer:
                        merge_q.put(_CLOSE)
                    return
                idx, item, decoded, prev = nxt
                staged, sp, ok = stage_one(idx, item, decoded, prev)
                if not ok:
                    continue
                if self._double_buffer:
                    # hand off: the NEXT item's host->HBM stage fills
                    # its buffer while the merge thread drains this one
                    schedule_point("queue", "reader.merge_q.put")
                    merge_q.put((idx, item, staged, sp))
                else:
                    merge_one(idx, item, staged, sp)

        def merge_main() -> None:
            while True:
                schedule_point("queue", "reader.merge_q.get")
                got = merge_q.get()
                if got is _CLOSE:
                    return
                merge_one(*got)

        threads = [
            threading.Thread(
                target=tenancy.scoped(tenant, fetch_main),
                name="reduce-pipeline-fetch",
                daemon=True,
            ),
            threading.Thread(
                target=tenancy.scoped(tenant, stage_main),
                name="reduce-pipeline-stage",
                daemon=True,
            ),
        ]
        threads += [
            threading.Thread(
                target=tenancy.scoped(tenant, decode_main),
                name=f"reduce-pipeline-decode-{i}",
                daemon=True,
            )
            for i in range(self._parallelism)
        ]
        if self._double_buffer:
            threads.append(
                threading.Thread(
                    target=tenancy.scoped(tenant, merge_main),
                    name="reduce-pipeline-merge",
                    daemon=True,
                )
            )
        t_wall0 = time.perf_counter()
        for t in threads:
            t.start()

        done = threading.Event()

        def joiner() -> None:
            for t in threads:
                t.join()
            done.set()
            out_q.put(_CLOSE)

        # analysis: ignore[tenant-scope]: joins scoped workers and posts a sentinel, no tenant work
        threading.Thread(
            target=joiner, name="reduce-pipeline-join", daemon=True
        ).start()

        closing = False
        try:
            while True:
                got = out_q.get()
                if got is _CLOSE:
                    break
                idx, out = got
                # a consumer that stops here (abandons the generator)
                # unwinds through the finally below: abort + drain
                inflight.add(-1)
                yield out
        except GeneratorExit:
            closing = True
            raise
        finally:
            abort.set()
            # drain the consumer handoff so stage/merge never block on
            # a full out_q while the joiner waits on them; keep going
            # until the sentinel (or an empty queue with all workers
            # gone) so no delivered-but-unconsumed item evades discard
            while True:
                try:
                    got = out_q.get(timeout=0.05)
                except queue.Empty:
                    if done.is_set():
                        break
                    continue
                if got is _CLOSE:
                    break
                _idx, out = got
                discard("merge", None, out)
            wall = time.perf_counter() - t_wall0
            self._abort = None
            overlap = max(0.0, sum(busy.values()) - wall)
            reg.histogram(
                "reader.pipeline.overlap_ms",
                bounds=_STAGE_BOUNDS,
                role=self._role,
            ).observe(overlap * 1e3)
            self.last_report = PipelineReport(
                wall_s=wall,
                stage_busy_s=dict(busy),
                overlap_s=overlap,
                results=[],
            )
            # an early-closing consumer is an abort, not an error: the
            # latched exception (if any) must not replace GeneratorExit
            if errbox and not closing:
                raise errbox[0]

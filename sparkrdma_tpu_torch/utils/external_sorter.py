"""ExternalSorter — spillable total ordering for the reduce path.

The reference's reader delegates key ordering to Spark's
ExternalSorter, which spills sorted runs to disk under memory pressure
and merge-reads them (RdmaShuffleReader.scala:99-112, spill metrics
:106-108). This is that component for the TPU framework's host engine:
records accumulate in memory up to a threshold, overflow as sorted
pickled runs in scratch files, and the final iterator is a lazy
heap-merge of every run.

A copy of the JAX package's ``utils/external_sorter.py``, its imports
rewritten to this package.
"""

from __future__ import annotations

import heapq
import os
import pickle
import tempfile
from typing import Callable, Iterable, Iterator, List, Optional


def _default_key(record):
    return record[0]


class ExternalSorter:
    """Sort arbitrarily many records with bounded memory."""

    def __init__(
        self,
        key: Optional[Callable] = None,
        spill_threshold: int = 1 << 20,
        tmp_dir: Optional[str] = None,
    ):
        self._key = key or _default_key
        self._threshold = max(1, spill_threshold)
        self._tmp_dir = tmp_dir
        self._spill_paths: List[str] = []
        self.spill_count = 0
        self.spilled_records = 0

    # ------------------------------------------------------------------
    def _spill_run(self, run: List) -> None:
        run.sort(key=self._key)
        fd, path = tempfile.mkstemp(prefix="srt_sort_", dir=self._tmp_dir)
        with os.fdopen(fd, "wb") as f:
            for rec in run:
                pickle.dump(rec, f, protocol=pickle.HIGHEST_PROTOCOL)
        self._spill_paths.append(path)
        self.spill_count += 1
        self.spilled_records += len(run)

    def _read_run(self, path: str) -> Iterator:
        try:
            with open(path, "rb") as f:
                while True:
                    try:
                        yield pickle.load(f)
                    except EOFError:
                        break
        finally:
            try:
                os.unlink(path)
            except OSError:
                pass

    # ------------------------------------------------------------------
    def sort(self, records: Iterable) -> Iterator:
        """Consume ``records``; yield them in key order (lazy merge)."""
        run: List = []
        for rec in records:
            run.append(rec)
            if len(run) >= self._threshold:
                self._spill_run(run)
                run = []
        if not self._spill_paths:
            run.sort(key=self._key)
            return iter(run)
        run.sort(key=self._key)
        streams = [self._read_run(p) for p in self._spill_paths]
        streams.append(iter(run))
        self._spill_paths = []
        return heapq.merge(*streams, key=self._key)

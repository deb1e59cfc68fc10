"""Entries: set-up and one stage of a path under test.

An entry module defines ``Entry(cell, inputs, device)``: its
constructor is the set-up (program objects, tables, a map stage), and

- ``stage_bytes``: the bytes a completed stage counts as work done;
- ``stage(end)``: one stage, to its sync; ``end`` (a CUDA event, or
  None off the card) is recorded behind the stage's last device work,
  before the host waits for it. Returns :class:`Out`;
- ``judged(output)``: the stage's output as the check module takes it;
- ``close()``: frees the program's state (the harness's inputs and the
  kept output stay for the check).
"""

from typing import Any, List, NamedTuple


class Out(NamedTuple):
    output: Any  # device tensors, kept only for the sampled stage
    ok: bool  # False: the program reported an overflow
    counts: List  # small host list of the stage's counts, for every stage
    enqueue_s: float  # host clock from the call to its return, before the sync

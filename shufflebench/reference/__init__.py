"""The plain reference and the comparisons that decide ``correct``.

Plain PyTorch on the harness's own inputs (made by ``generator.py``
from ``--seed``). Nothing here imports ``jax``, the JAX package or
anything of ``sparkrdma_tpu_torch``, and nothing takes what the
program made: range edges, partitions, capacities, padding and the
join are worked out again from the inputs. The program's outputs are
read only to be judged.

A check module defines ``compare(judged, stage_counts, inputs, config)
-> (numbers, failed_stages)``: every number is an exact count of
departures from the reference (limit 0 in each workload file), and
``failed_stages`` the stages found wrong; and ``control(inputs,
config) -> (judged, counts)``: the reference at the next width down,
in the program's place (``python3 -m shufflebench.control``).
"""

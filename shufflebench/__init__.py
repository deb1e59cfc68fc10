"""shufflebench: the benchmark of ``sparkrdma_tpu_torch`` on NVIDIA GPUs.

One command runs one cell once::

    python3 -m shufflebench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, entry or
metric lives in a file of its own under this folder and is found by
the name ``BENCHMARK.json`` gives it (see ``README.md``).
"""

"""Skips, with the reason, the cases of the harness's shared tests that
run a configuration at its ``tests/conftest.py`` ``TINY`` size where
``TINY`` gives that configuration none. A configuration without one
tests its cell at a size of its own in its own test module."""

import pytest


def pytest_collection_modifyitems(config, items):
    from shufflebench import cells
    from shufflebench.tests.conftest import TINY

    bench = cells.benchmark()
    config_of = {w["name"]: w["config"] for w in bench["workloads"]}
    config_of.update((c["name"], c["name"]) for c in bench["configs"])
    for item in items:
        spec = getattr(item, "callspec", None)
        code = getattr(getattr(item, "function", None), "__code__", None)
        # the cases that read TINY: through the fixture, or by name
        reads_tiny = "tiny_cell" in item.fixturenames or (
            code is not None and "TINY" in code.co_names)
        if spec is None or not reads_tiny:
            continue
        for value in spec.params.values():
            cfg = config_of.get(value) if isinstance(value, str) else None
            if cfg is not None and cfg not in TINY:
                item.add_marker(pytest.mark.skip(
                    reason=f"tests/conftest.py's TINY has no CPU size for {cfg}; "
                           f"its own test module runs the cell at one"))

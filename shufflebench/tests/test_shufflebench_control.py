"""The control: the reference at the next width down (16-bit keys) put
in the program's place has to come out not correct, while the exact
reference in the same place comes out correct."""

import pytest

from shufflebench import cells, generator
from shufflebench.reference import sorted_ranges

CELLS = [w["name"] for w in cells.benchmark()["workloads"]]


def control_numbers(cell, inputs):
    check = cells.check_module(cell.check)
    judged, counts = check.control(inputs, cell.config)
    numbers, _ = check.compare(judged, [counts] * 3, inputs, cell.config)
    return numbers


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 5, 99])
def test_control_fails_a_limit(name, seed, tiny_cell, cpu):
    cell = tiny_cell(name)
    inputs = generator.make(cell.traffic, cell.config, seed, cpu)
    numbers = control_numbers(cell, inputs)
    assert any(numbers[k] > limit for k, limit in cell.limits.items()), numbers


def test_exact_reference_in_the_programs_place_passes(tiny_cell, cpu):
    cell = tiny_cell("sort.u32.spmd")
    inputs = generator.make(cell.traffic, cell.config, 3, cpu)
    k64 = sorted_ranges.u64(inputs["keys"])
    parts = int(cell.config["executors"])
    dest = sorted_ranges.part_of(k64, parts)
    ranges = [sorted_ranges.as_u32(k64[dest == r].sort().values) for r in range(parts)]
    numbers, bad = sorted_ranges.compare({"ranges": ranges}, [[r.numel() for r in ranges]],
                                         inputs, cell.config)
    assert numbers == {"count_mismatch": 0, "key_mismatch": 0} and bad == 0

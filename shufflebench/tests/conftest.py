"""Tests of the benchmark harness. Run from the checkout's root:
``python3 -m pytest shufflebench/tests`` (on the CPU: every test but
the ``card`` ones; on the card: ``-m card`` runs those)."""

import copy

import pytest
import torch

from shufflebench import cells

# tiny sizes of each configuration, for runs on the CPU
TINY = {
    "sort.cub-u32-2p28": {"records": 1 << 14},
    # over 2^16 build keys, so 16-bit fingerprints of them collide (the
    # control); a probe side that is no multiple of 8 shards, so it pads
    "join.balkesen13-b": {"probe_rows": 70001, "build_rows": 70001},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name)``: the cell with its configuration cut to a
    size the CPU runs in a blink."""

    def make(name):
        cell = cells.load_cell(name)
        cell = copy.deepcopy(cell)
        cell.config.update(TINY[cell.config_name])
        return cell

    return make


@pytest.fixture
def cpu():
    return torch.device("cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; this process sees none")
    return torch.device("cuda", 0)

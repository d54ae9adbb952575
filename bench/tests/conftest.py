"""Shared set-up of the benchmark's tests: the harness (``bench/``) and the
port (``src/``) on the path, a card fixture, and cells cut to a size the
CPU runs in seconds."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for path in (BENCH.parent / "src", BENCH):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

# the §4.1 law at a size the CPU fits in well under a second
TINY = dict(m=4, n=32, p=15, s=5)


@pytest.fixture
def cuda():
    """The card; skips the test where there is none (decided here, when
    the test runs, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells' own reading runs only "
                    "on the card")
    return torch.device("cuda:0")


def tiny_cell(name: str, **traffic):
    """The cell ``name`` of BENCHMARK.json with its configuration cut to
    ``TINY`` and its mix's parameters replaced by ``traffic``."""
    from harness import spec
    cell = spec.find(name)
    cell.config = dict(cell.config, **TINY)
    cell.traffic = dict(cell.traffic, **traffic)
    return cell

"""The benchmark's own tests (``python -m pytest rtbench/tests``): on the
CPU, at small sizes, through the program's plain PyTorch walks."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips itself without one")


@pytest.fixture()
def tiny():
    """A cell's configuration and traffic cut to a CPU test's size: 7,938
    triangles (63 cells a side, odd like the 1M terrain's 707, so that no
    grid line lies in the plane of the frame's centre column, where
    rounding decides each ray), 48x32 pixels, through the walk
    (``PALLAS``: its plain PyTorch version on the CPU), the query ``AUTO``
    takes on the card."""
    from rtbench import workload

    def make(config, traffic, triangles=7938, width=48, height=32):
        c = workload.load("configs", config)
        c["terrain"]["triangles"] = triangles
        t = workload.load("traffic", traffic)
        t.update(width=width, height=height, tile_pixels=width * height,
                 intersector="PALLAS")
        return c, t

    return make

"""The benchmark's own tests (``python -m pytest perfbench/tests`` from the
repository root). Tests marked ``cuda`` run on a card and skip elsewhere;
the decision is made inside the ``card`` fixture."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

#: Each family at a size a CPU test holds (widths cut: tests only).
TINY = {
    "dense": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=128, vocab_size=256),
}


def tiny(name: str, seq: int = 64):
    """Cell ``name`` of BENCHMARK.json with its model and batch cut to a
    test's size (its traffic, placement and limits as they are)."""
    from perfbench import spec
    cell = spec.load_cell(name)
    cell.model = {**cell.model, **TINY[cell.model["family"]]}
    cell.traffic = {**cell.traffic, "seq": seq}
    return cell


@pytest.fixture
def card():
    """The device of a ``cuda`` test: skips where there is no card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"

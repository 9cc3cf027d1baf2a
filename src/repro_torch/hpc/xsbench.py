"""XSBench (ECP proxy): Monte Carlo macroscopic cross-section lookups.

Paper Table 1: random, lookup-intensive access; 5.5 GB total, 5.1 remote,
R/W 1:1, object index_grid (the unionized energy grid).

A copy of ``repro.hpc.xsbench`` for this package, numpy as there.
"""
from __future__ import annotations

import numpy as np

from repro_torch.hpc.base import HPCWorkload


class XSBench(HPCWorkload):
    name = "XSBench"
    characteristics = "Random access, lookup intensive"
    paper_total_gb = 5.5
    paper_remote_gb = 5.1
    read_write_ratio = "1:1"
    parallel_efficiency = 0.99  # embarrassingly parallel lookups

    N_NUCLIDES = 64
    LOOKUPS = 50_000

    def __init__(self, scale: float = 1.0, seed: int = 0):
        super().__init__(scale, seed)
        grid_bytes = self._target_bytes(5.1)
        self.n_gp = max(grid_bytes // (8 * self.N_NUCLIDES), 1024)
        self.energy = np.sort(self.rng.random(self.n_gp))
        self.grid0 = self.rng.random((self.n_gp, self.N_NUCLIDES))

    def register(self, rt):
        rt.alloc("index_grid", self.grid0, reads_per_iter=1, writes_per_iter=0)
        rt.alloc("energy_grid", self.energy, reads_per_iter=1, writes_per_iter=0)
        rt.alloc("tally", np.zeros(8), reads_per_iter=1, writes_per_iter=1)
        self.flops_per_iter = self.LOOKUPS * (np.log2(self.n_gp) + 10)
        self.bytes_per_iter = self.LOOKUPS * (8 * self.N_NUCLIDES + 64)
        self.fetch_bytes_per_iter = self.grid0.nbytes
        self.write_bytes_per_iter = 0

    def iterate(self, rt, it):
        energy = rt.fetch("energy_grid")
        rng = np.random.default_rng(1234 + it)
        samples = rng.random(self.LOOKUPS)
        # binary searches on the energy grid — the big xs grid prefetches
        idx = np.clip(np.searchsorted(energy, samples) - 1, 0, self.n_gp - 2)
        frac = (samples - energy[idx]) / np.maximum(
            energy[idx + 1] - energy[idx], 1e-12
        )
        self.charge(rt, 0.3)
        grid = rt.fetch("index_grid")
        xs = grid[idx] * (1 - frac)[:, None] + grid[idx + 1] * frac[:, None]
        macro = xs.sum(axis=1)
        self.charge(rt, 0.5)
        tally = rt.fetch("tally")
        tally = tally + np.array([
            macro.sum(), macro.max(), macro.min(), float(idx.sum() % 997),
            0, 0, 0, 0,
        ])
        rt.commit("tally", tally)
        self.charge(rt, 0.2)

    def checksum(self, rt):
        return float(rt.fetch("tally")[0])

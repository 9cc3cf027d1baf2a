"""NPB BT: block tri-diagonal solver (simplified ADI sweep).

Paper Table 1: predictable intra-block, irregular inter-block access;
10.7 GB total, 7.6 remote, R/W 5:3, objects u, forcing, rhs.

A copy of ``repro.hpc.bt`` for this package, numpy as there.
"""
from __future__ import annotations

import numpy as np

from repro_torch.hpc.base import HPCWorkload


class BT(HPCWorkload):
    name = "BT"
    characteristics = "Intra-block, irregular inter-block access"
    paper_total_gb = 10.7
    paper_remote_gb = 7.6
    read_write_ratio = "5:3"
    parallel_efficiency = 0.8

    NVAR = 5

    def __init__(self, scale: float = 1.0, seed: int = 0):
        super().__init__(scale, seed)
        per_obj = self._target_bytes(10.7) // 3
        n = int(round((per_obj / (8 * self.NVAR)) ** (1 / 3)))
        self.n = max(n, 12)
        shape = (self.NVAR,) + (self.n,) * 3
        self.u0 = self.rng.standard_normal(shape) * 0.01 + 1.0
        self.forcing0 = self.rng.standard_normal(shape) * 0.001

    def register(self, rt):
        rt.alloc("u", self.u0, reads_per_iter=3, writes_per_iter=1)
        rt.alloc("forcing", self.forcing0, reads_per_iter=1, writes_per_iter=0)
        rt.alloc("rhs", np.zeros_like(self.u0), reads_per_iter=2, writes_per_iter=1)
        vol = self.NVAR * self.n ** 3
        self.flops_per_iter = 3 * 15 * vol
        self.bytes_per_iter = 8 * 10 * vol
        self.fetch_bytes_per_iter = 3 * vol * 8
        self.write_bytes_per_iter = 2 * vol * 8

    def iterate(self, rt, it):
        u = rt.fetch("u")
        # spatial stencil of u — forcing prefetches while this runs
        su = np.zeros_like(u)
        for ax in (1, 2, 3):
            su = su + (np.roll(u, 1, axis=ax) - 2 * u + np.roll(u, -1, axis=ax))
        self.charge(rt, 0.5)
        forcing = rt.fetch("forcing")
        rhs = forcing + 0.1 * su
        # ADI-style sweeps: tridiagonal relaxation along each axis
        for ax in (1, 2, 3):
            u = u + 0.3 * (rhs + 0.05 * np.roll(rhs, 1, axis=ax))
        rt.commit("rhs", rhs)
        rt.commit("u", u)
        self.charge(rt, 0.5)  # sweeps: write-backs + next window hide under it

    def checksum(self, rt):
        return float(np.sum(rt.fetch("u") ** 2))

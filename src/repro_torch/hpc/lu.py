"""NPB LU: SSOR-based lower-upper solver (simplified).

Paper Table 1: non-uniform access; 8.8 GB total, 7.6 remote, R/W 15:8,
objects u, rsd, frct.

A copy of ``repro.hpc.lu`` for this package, numpy as there.
"""
from __future__ import annotations

import numpy as np

from repro_torch.hpc.base import HPCWorkload


class LU(HPCWorkload):
    name = "LU"
    characteristics = "Non-uniform access"
    paper_total_gb = 8.8
    paper_remote_gb = 7.6
    read_write_ratio = "15:8"
    parallel_efficiency = 0.75

    NVAR = 5

    def __init__(self, scale: float = 1.0, seed: int = 0):
        super().__init__(scale, seed)
        per_obj = self._target_bytes(8.8) // 3
        n = int(round((per_obj / (8 * self.NVAR)) ** (1 / 3)))
        self.n = max(n, 12)
        shape = (self.NVAR,) + (self.n,) * 3
        self.u0 = self.rng.standard_normal(shape) * 0.01 + 1.0
        self.frct0 = self.rng.standard_normal(shape) * 0.001

    def register(self, rt):
        rt.alloc("u", self.u0, reads_per_iter=4, writes_per_iter=1)
        rt.alloc("rsd", np.zeros_like(self.u0), reads_per_iter=3, writes_per_iter=2)
        rt.alloc("frct", self.frct0, reads_per_iter=1, writes_per_iter=0)
        vol = self.NVAR * self.n ** 3
        self.flops_per_iter = 2 * 18 * vol
        self.bytes_per_iter = 8 * 12 * vol
        self.fetch_bytes_per_iter = 3 * vol * 8
        self.write_bytes_per_iter = 2 * vol * 8

    def iterate(self, rt, it):
        u = rt.fetch("u")
        # spatial stencil of u — rsd/frct prefetch while this runs
        su = np.zeros_like(u)
        for ax in (1, 2, 3):
            su = su + (np.roll(u, 1, axis=ax) - 2 * u + np.roll(u, -1, axis=ax))
        self.charge(rt, 0.4)
        rt.fetch("rsd")  # RMW read of the residual object (overwritten below)
        frct = rt.fetch("frct")
        rsd = frct + 0.08 * su
        # lower sweep then upper sweep (SSOR flavour)
        lower = rsd + 0.05 * np.roll(rsd, 1, axis=1)
        upper = lower + 0.05 * np.roll(lower, -1, axis=1)
        u = u + 0.5 * upper
        rt.commit("rsd", upper)
        rt.commit("u", u)
        self.charge(rt, 0.6)  # sweeps: write-backs + next window hide under it

    def checksum(self, rt):
        return float(np.sum(rt.fetch("u") ** 2))

"""NPB MG: multigrid V-cycle on a 3D grid.

Paper Table 1: hierarchical, semi-regular access; 26.5 GB total, 26.4 remote,
R/W 9:8, objects u, v, r.

A copy of ``repro.hpc.mg`` for this package, numpy as there.
"""
from __future__ import annotations

import numpy as np

from repro_torch.hpc.base import HPCWorkload


def _laplacian(u):
    out = -6.0 * u
    for ax in range(3):
        out += np.roll(u, 1, axis=ax) + np.roll(u, -1, axis=ax)
    return out


class MG(HPCWorkload):
    name = "MG"
    characteristics = "Hierarchical, semi-regular access"
    paper_total_gb = 26.5
    paper_remote_gb = 26.4
    read_write_ratio = "9:8"
    parallel_efficiency = 0.85

    def __init__(self, scale: float = 1.0, seed: int = 0):
        super().__init__(scale, seed)
        per_obj = self._target_bytes(26.5) // 3
        n = int(round((per_obj / 8) ** (1 / 3)))
        self.n = max(n - n % 2, 16)
        self.v0 = self.rng.standard_normal((self.n,) * 3)

    def register(self, rt):
        n = self.n
        rt.alloc("u", np.zeros((n,) * 3), reads_per_iter=2, writes_per_iter=2)
        rt.alloc("v", self.v0, reads_per_iter=1, writes_per_iter=0)
        rt.alloc("r", np.zeros((n,) * 3), reads_per_iter=2, writes_per_iter=1)
        vol = n ** 3
        self.flops_per_iter = 8 * 2 * vol + 8 * 2 * (vol // 8)
        self.bytes_per_iter = 8 * 8 * vol
        self.fetch_bytes_per_iter = 3 * vol * 8
        self.write_bytes_per_iter = 2 * vol * 8

    def iterate(self, rt, it):
        u, v = rt.fetch("u"), rt.fetch("v")
        # residual + smooth (fine) — the residual object prefetches under it
        r = v - _laplacian(u)
        u = u + 0.8 / 6.0 * r
        self.charge(rt, 0.6)
        rt.fetch("r")  # RMW read of the residual object (overwritten below)
        # coarse correction (restrict -> smooth -> prolong)
        rc = r[::2, ::2, ::2]
        ec = 0.8 / 6.0 * rc
        e = np.repeat(np.repeat(np.repeat(ec, 2, 0), 2, 1), 2, 2)
        u = u + e
        rt.commit("u", u)
        rt.commit("r", r)
        self.charge(rt, 0.4)

    def checksum(self, rt):
        return float(np.sum(rt.fetch("u") ** 2))

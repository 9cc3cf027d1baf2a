"""NPB CG: conjugate gradient with a banded SPD matrix.

Paper Table 1: irregular, non-sequential access; total 8.6 GB, remote 5.4 GB,
R/W 1:1, dominant object 'a' (the sparse matrix).

A copy of ``repro.hpc.cg`` for this package, numpy as there.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.objects import ObjectKind
from repro_torch.hpc.base import HPCWorkload


class CG(HPCWorkload):
    name = "CG"
    characteristics = "Irregular, non-sequential access"
    paper_total_gb = 8.6
    paper_remote_gb = 5.4
    read_write_ratio = "1:1"
    parallel_efficiency = 0.97

    def __init__(self, scale: float = 1.0, seed: int = 0, nb: int = 64):
        super().__init__(scale, seed)
        a_bytes = self._target_bytes(5.4)
        self.nb = nb
        self.n = max(a_bytes // (8 * nb), 1024)
        # banded SPD: diag-dominant symmetric band
        band = self.rng.standard_normal((self.n, nb)) * 0.1
        band[:, 0] = nb * 1.5 + np.abs(band[:, 0])  # diagonal
        self.band0 = band
        self.b = self.rng.standard_normal(self.n)
        self.offsets = np.arange(nb)

    def register(self, rt):
        rt.alloc("a", self.band0, reads_per_iter=1, writes_per_iter=0,
                 kind=ObjectKind.INPUT)
        # solver vectors: small, frequently accessed -> local by policy
        rt.alloc("x", np.zeros(self.n), reads_per_iter=3, writes_per_iter=1)
        rt.alloc("r", self.b.copy(), reads_per_iter=3, writes_per_iter=1)
        rt.alloc("p", self.b.copy(), reads_per_iter=3, writes_per_iter=1)
        nnz = self.n * (2 * self.nb - 1)
        self.flops_per_iter = 2 * nnz + 10 * self.n
        self.bytes_per_iter = self.band0.nbytes + 6 * 8 * self.n
        self.fetch_bytes_per_iter = self.band0.nbytes
        self.write_bytes_per_iter = 0

    def _matvec(self, band, v):
        y = band[:, 0] * v
        for j in range(1, self.nb):
            y[:-j] += band[:-j, j] * v[j:]
            y[j:] += band[:-j, j] * v[:-j]
        return y

    def iterate(self, rt, it):
        a = rt.fetch("a")
        p = rt.fetch("p")
        q = self._matvec(a, p)          # the SpMV dominates the iteration...
        self.charge(rt, 0.7)            # ...and the solver vectors prefetch under it
        x, r = rt.fetch("x"), rt.fetch("r")
        denom = float(p @ q) or 1.0
        alpha = float(r @ r) / denom
        x = x + alpha * p
        r_new = r - alpha * q
        beta = float(r_new @ r_new) / (float(r @ r) or 1.0)
        p = r_new + beta * p
        rt.commit("x", x)
        rt.commit("r", r_new)
        rt.commit("p", p)
        self.charge(rt, 0.3)

    def checksum(self, rt):
        return float(np.sum(rt.fetch("x")))

"""NPB FT: 3D FFT spectral evolution.

Paper Table 1: non-sequential multi-dimensional access; 80 GB total, 80
remote, R/W 11:7, objects twiddle, u_0, u_1.

A copy of ``repro.hpc.ft`` for this package, numpy as there.
"""
from __future__ import annotations

import numpy as np

from repro_torch.hpc.base import HPCWorkload


class FT(HPCWorkload):
    name = "FT"
    characteristics = "Non-sequential, multi-dimensional access"
    paper_total_gb = 80.0
    paper_remote_gb = 80.0
    read_write_ratio = "11:7"
    parallel_efficiency = 0.9

    def __init__(self, scale: float = 1.0, seed: int = 0):
        super().__init__(scale, seed)
        per_obj = self._target_bytes(80.0) // 3
        n = int(round((per_obj / 16) ** (1 / 3)))
        self.n = max(n - n % 2, 16)
        shape = (self.n,) * 3
        self.u0 = (
            self.rng.standard_normal(shape) + 1j * self.rng.standard_normal(shape)
        ).astype(np.complex128)
        k = np.fft.fftfreq(self.n) * self.n
        k2 = (k[:, None, None] ** 2 + k[None, :, None] ** 2 + k[None, None, :] ** 2)
        self.twiddle0 = np.exp(-4e-6 * np.pi ** 2 * k2).astype(np.complex128)

    def register(self, rt):
        rt.alloc("twiddle", self.twiddle0, reads_per_iter=1, writes_per_iter=0)
        rt.alloc("u_0", np.fft.fftn(self.u0), reads_per_iter=1, writes_per_iter=1)
        rt.alloc("u_1", np.zeros_like(self.u0), reads_per_iter=0, writes_per_iter=1)
        vol = self.n ** 3
        self.flops_per_iter = 5 * vol * np.log2(max(vol, 2)) * 2 + 6 * vol
        self.bytes_per_iter = 16 * 6 * vol
        self.fetch_bytes_per_iter = 2 * vol * 16
        self.write_bytes_per_iter = 2 * vol * 16

    def iterate(self, rt, it):
        tw = rt.fetch("twiddle")
        u0 = rt.fetch("u_0")
        u0 = u0 * tw                       # evolve in spectral space
        self.charge(rt, 0.4)
        u1 = np.fft.ifftn(u0)              # back to physical space
        rt.commit("u_0", u0)
        rt.commit("u_1", u1)
        self.charge(rt, 0.6)  # ifft: write-backs + next window hide under it

    def checksum(self, rt):
        u1 = rt.fetch("u_1")
        return float(np.abs(u1).sum())

"""miniAMR (ECP proxy): block-structured AMR stencil.

Paper Table 1: hierarchical access, irregular patterns; 32.2 GB total,
30.9 remote, R/W 11:9, object 'blocks'.

A copy of ``repro.hpc.miniamr`` for this package, numpy as there.
"""
from __future__ import annotations

import numpy as np

from repro_torch.hpc.base import HPCWorkload


class MiniAMR(HPCWorkload):
    name = "miniAMR"
    characteristics = "Hierarchical access, irregular patterns"
    paper_total_gb = 32.2
    paper_remote_gb = 30.9
    read_write_ratio = "11:9"
    parallel_efficiency = 0.9

    BLOCK = 16

    def __init__(self, scale: float = 1.0, seed: int = 0):
        super().__init__(scale, seed)
        total = self._target_bytes(30.9)
        self.n_blocks = max(total // (8 * self.BLOCK ** 3), 8)
        self.blocks0 = self.rng.standard_normal(
            (self.n_blocks, self.BLOCK, self.BLOCK, self.BLOCK)
        )

    def register(self, rt):
        rt.alloc("blocks", self.blocks0, reads_per_iter=2, writes_per_iter=2)
        rt.alloc("levels", np.zeros(self.n_blocks, np.int32),
                 reads_per_iter=1, writes_per_iter=1)
        vol = self.blocks0.size
        self.flops_per_iter = 8 * vol + 2 * vol
        self.bytes_per_iter = 8 * 6 * vol
        self.fetch_bytes_per_iter = self.blocks0.nbytes
        self.write_bytes_per_iter = self.blocks0.nbytes

    def iterate(self, rt, it):
        blocks = rt.fetch("blocks")
        # 7-point stencil within each block — levels prefetch while it runs
        new = -6.0 * blocks
        for ax in (1, 2, 3):
            new += np.roll(blocks, 1, axis=ax) + np.roll(blocks, -1, axis=ax)
        blocks = blocks + 0.05 * new
        self.charge(rt, 0.7)
        levels = rt.fetch("levels")
        # refinement: the top-k energetic blocks get smoothed copies of
        # themselves (stand-in for split/merge data motion)
        energy = np.abs(blocks).mean(axis=(1, 2, 3))
        k = max(self.n_blocks // 16, 1)
        hot = np.argpartition(energy, -k)[-k:]
        blocks[hot] = 0.5 * (blocks[hot] + blocks[hot].mean(axis=0))
        levels = levels.copy()
        levels[hot] += 1
        rt.commit("blocks", blocks)
        rt.commit("levels", levels)
        self.charge(rt, 0.3)

    def checksum(self, rt):
        return float(np.sum(rt.fetch("blocks") ** 2))

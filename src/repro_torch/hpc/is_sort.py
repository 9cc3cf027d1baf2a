"""NPB IS: integer (counting) sort.

Paper Table 1: sequential, parallel access; 32.3 GB total, 32.0 remote,
R/W 1:1, objects key_array, key_buf2.

A copy of ``repro.hpc.is_sort`` for this package, numpy as there.
"""
from __future__ import annotations

import numpy as np

from repro_torch.hpc.base import HPCWorkload


class IS(HPCWorkload):
    name = "IS"
    characteristics = "Sequential, parallel access"
    paper_total_gb = 32.3
    paper_remote_gb = 32.0
    read_write_ratio = "1:1"
    parallel_efficiency = 0.7

    MAX_KEY = 1 << 16

    def __init__(self, scale: float = 1.0, seed: int = 0):
        super().__init__(scale, seed)
        per_obj = self._target_bytes(32.3) // 2
        self.n = max(per_obj // 4, 1 << 16)
        self.keys0 = self.rng.integers(
            0, self.MAX_KEY, size=self.n, dtype=np.int32
        )

    def register(self, rt):
        rt.alloc("key_array", self.keys0, reads_per_iter=1, writes_per_iter=1)
        rt.alloc("key_buf2", np.zeros(self.n, np.int32),
                 reads_per_iter=0, writes_per_iter=1)
        self.flops_per_iter = 4 * self.n
        self.bytes_per_iter = 4 * 6 * self.n
        self.fetch_bytes_per_iter = self.n * 4
        self.write_bytes_per_iter = 2 * self.n * 4

    def iterate(self, rt, it):
        keys = rt.fetch("key_array")
        counts = np.bincount(keys, minlength=self.MAX_KEY)
        self.charge(rt, 0.6)
        sorted_keys = np.repeat(
            np.arange(self.MAX_KEY, dtype=np.int32), counts
        )
        # NPB IS perturbs keys between rankings; rotate deterministically
        new_keys = np.roll(keys, 7) ^ (it + 1)
        new_keys = np.clip(new_keys, 0, self.MAX_KEY - 1).astype(np.int32)
        rt.commit("key_buf2", sorted_keys)
        rt.commit("key_array", new_keys)
        self.charge(rt, 0.4)

    def checksum(self, rt):
        buf = rt.fetch("key_buf2")
        return float(buf[:: max(len(buf) // 1024, 1)].sum())

"""The general generator of a cell's work, read from a traffic file
(``traffic/<name>.json``).

A training traffic file gives the batch (``batch`` rows of ``seq``
tokens), the token distribution (``tokens``: a Zipf unigram with
``exponent`` over the vocabulary, its ranks laid on the ids by a
permutation drawn from the seed), where the state lives (``tiering``), the
step's settings (``step``) and the optimizer's (``optimizer``), and how
many first steps the reference follows (``checked_steps``). Step ``i``'s
batch is drawn from the seed and ``i`` alone, on the device; every step's
rows differ. Labels are the tokens, as the port's ``make_batch`` lays them
(the loss shifts them by one).
"""
from __future__ import annotations

import torch

from perfbench.seeds import generator


class TokenStream:
    def __init__(self, traffic: dict, vocab: int, seed: int, device):
        tok = traffic["tokens"]
        if tok["dist"] != "zipf":
            raise ValueError(f"unknown token distribution {tok['dist']!r}")
        self.rows, self.seq = traffic["batch"], traffic["seq"]
        self.seed, self.device = seed, device
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
        w = ranks.pow(-float(tok["exponent"]))
        self.cdf = torch.cumsum(w, 0) / w.sum()
        self.ids = torch.randperm(vocab, device=device,
                                  generator=generator(seed, "vocab", device))

    @property
    def tokens_per_step(self) -> int:
        return self.rows * self.seq

    def batch(self, step: int) -> dict:
        """Step ``step``'s batch (``step`` counts from 1)."""
        u = torch.rand(self.rows * self.seq, dtype=torch.float64,
                       device=self.device,
                       generator=generator(self.seed, f"batch.{step}",
                                           self.device))
        r = torch.searchsorted(self.cdf, u).clamp_(max=self.ids.numel() - 1)
        tokens = self.ids[r].reshape(self.rows, self.seq).to(torch.int32)
        return {"tokens": tokens, "labels": tokens}

"""Synthetic token pipeline with a dual-buffered host prefetch.

A port of ``repro.data.pipeline``. The input pipeline is a DOLMA data path
too: batches are produced on the host and fetched into device memory. The
loader keeps a two-deep prefetch queue (the dual buffer), so that batch
k+1 is made and copied while step k computes — the overlap of §4.2's remote
read prefetch, one tier up.

Batches are deterministic functions of (seed, step), drawn with numpy
exactly as the reference draws them: a restart reproduces the token
stream, and both packages train on the same tokens.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exec import resolve_device


class SyntheticTokenDataset:
    """Deterministic synthetic LM batches (Zipf-ish marginals)."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed << 32) ^ step)
        # zipf-like distribution clipped to vocab
        raw = rng.zipf(1.3, size=(self.batch, self.seq))
        tokens = (raw % self.cfg.vocab_size).astype(np.int32)
        out = {"tokens": tokens, "labels": tokens}
        if self.cfg.family in ("encdec", "audio"):
            out["frames"] = rng.standard_normal(
                (self.batch, self.cfg.frontend_len, self.cfg.d_model), np.float32)
        if self.cfg.family == "vlm":
            out["patches"] = rng.standard_normal(
                (self.batch, self.cfg.frontend_len, self.cfg.d_model), np.float32)
        return out


class PrefetchingLoader:
    """Dual-buffered loader: a host thread stays ``depth`` batches ahead."""

    def __init__(
        self,
        dataset: SyntheticTokenDataset,
        *,
        start_step: int = 0,
        depth: int = 2,
        put_fn: Callable[[Any], Any] | None = None,
    ):
        self.dataset = dataset
        self.put_fn = put_fn or (lambda b: b)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = self.dataset.batch_at(step)
            try:
                self._q.put((step, self.put_fn(batch)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[tuple[int, Any]]:
        return self

    def __next__(self) -> tuple[int, Any]:
        return self._q.get()

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def to_device_fn(device: str | torch.device = "cuda",
                 dtype: torch.dtype = torch.float32
                 ) -> Callable[[dict], dict]:
    """``put_fn`` that lands a host batch on ``device``: token ids and
    labels as int32, the vlm family's patches (and the enc-dec family's
    frames) in the model's ``dtype``."""
    dev = resolve_device(device)

    def put(batch: dict) -> dict:
        out = {}
        for k, a in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(a))
            out[k] = t.to(dev) if t.dtype == torch.int32 else t.to(dev, dtype)
        return out

    return put


def device_put_fn(mesh, pspec_tree_fn: Callable[[dict], Any], *,
                  dtype: torch.dtype = torch.float32
                  ) -> Callable[[dict], dict]:
    """``put_fn`` that lands a host batch in its sharded layout over
    ``mesh``: each leaf a DTensor with the placements of its spec in
    ``pspec_tree_fn(batch)`` (``lambda b: batch_pspec_tree(b, mesh)``),
    every rank keeping its own block of the batch it drew (the draw is a
    function of (seed, step), so every rank draws the same). The types are
    :func:`to_device_fn`'s."""
    from repro_torch.models.sharding import distribute_tree

    to_dev = to_device_fn(mesh.device_type, dtype)

    def put(batch: dict) -> dict:
        out = to_dev(batch)
        return distribute_tree(out, pspec_tree_fn(out), mesh)

    return put

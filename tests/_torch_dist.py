"""A world of N ``gloo`` ranks on the CPU for the port's mesh tests (not a
test module; imports neither package).

:class:`World` starts N processes once, each joined to one process group
through a ``FileStore`` in a directory of the caller's (no fixed port, so
that several test workers can each run a world at once), and runs a
function on every rank: ``world.run(fn, *args)`` returns each rank's
result, in rank order. ``fn`` must be importable by name (a module-level
function) and its arguments and result picklable. A rank that raises
fails the call with its traceback, and the world is closed: its other
ranks may be blocked in a collective.

:func:`one_rank_group` starts a process group of this process alone, for
a (1, 1) mesh inside an ordinary test; :func:`fake_group` one of torch's
``fake`` backend, in which this process is rank 0 of many and collectives
move nothing (meshes of production size over fake tensors).
"""
from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import queue
import traceback

#: Longest a call waits for a rank's answer, in seconds.
TIMEOUT_S = 600


def _worker(rank: int, n: int, store_path: str, inq, outq) -> None:
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, n),
                            rank=rank, world_size=n)
    try:
        while True:
            job = inq.get()
            if job is None:
                break
            fn, args = job
            try:
                outq.put((rank, True, fn(*args)))
            except BaseException:  # noqa: BLE001 - reported to the caller
                outq.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    def __init__(self, n: int, directory: str):
        ctx = mp.get_context("spawn")
        self.n = n
        self._in = [ctx.Queue() for _ in range(n)]
        self._out = ctx.Queue()
        store = os.path.join(directory, "store")
        self._procs = [ctx.Process(target=_worker, daemon=True,
                                   args=(r, n, store, self._in[r], self._out))
                       for r in range(n)]
        for p in self._procs:
            p.start()
        self.alive = True

    def run(self, fn, *args) -> list:
        if not self.alive:
            raise RuntimeError("World: closed after a failed call")
        for q in self._in:
            q.put((fn, args))
        results: list = [None] * self.n
        errors = []
        try:
            for _ in range(self.n):
                rank, ok, val = self._out.get(timeout=TIMEOUT_S)
                if ok:
                    results[rank] = val
                else:
                    errors.append(f"rank {rank}:\n{val}")
                    break
        except queue.Empty:
            errors.append(f"no answer within {TIMEOUT_S} s")
        if errors:
            self.close()
            raise RuntimeError("\n".join(errors))
        return results

    def close(self) -> None:
        if not self.alive:
            return
        self.alive = False
        for q in self._in:
            q.put(None)
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()


@contextlib.contextmanager
def one_rank_group(directory: str):
    """A ``gloo`` process group of this process alone (world size 1), its
    ``FileStore`` in ``directory``; destroyed on the way out."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(directory, "store1"), 1), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_group(world_size: int):
    """A process group of ``world_size`` ranks of torch's ``fake`` backend,
    this process rank 0; destroyed on the way out, so that the test worker
    is left with no default group."""
    import torch.distributed as dist
    # registers the "fake" backend's constructor
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    dist.init_process_group("fake", store=dist.HashStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()

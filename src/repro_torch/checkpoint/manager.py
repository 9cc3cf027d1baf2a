"""Asynchronous checkpoint/restart with metadata-table consistency (§4.2).

A port of ``repro.checkpoint.manager``, with the reference's on-disk
format: ``<dir>/step_<n>/meta.json`` (the caller's metadata, ``step``,
``time`` and a ``manifest`` of ``{keystr: {"file", "hash"}}``) and one
``.npy`` per leaf, named by the sha1 of its keystr. Leaves are keyed
``"params" + keystr`` and ``"opt" + keystr`` as the reference keys them
(an int8 moment's ``.codes`` and ``.scale`` each), so a checkpoint either
package wrote restores in the other.

bf16 leaves are saved as their 2-byte words with the ``<V2`` descriptor,
which is what ``np.save`` writes for the reference's ``ml_dtypes``
bfloat16 arrays; restore reads them back through the template leaf's
dtype. The port never needs ``ml_dtypes``.

It mirrors DOLMA's reliability design:

  * checkpoints are taken asynchronously: the step loop hands off a host
    snapshot and keeps training while a writer thread persists it;
  * the caller's DOLMA metadata is saved *with* the arrays;
  * only objects dirty since the last checkpoint are rewritten (delta
    checkpoints by per-leaf content hashes, as hard links);
  * writes go to ``<dir>/tmp.<prefix>.<step>`` and are renamed into place,
    so a crash mid-write never corrupts the latest complete checkpoint;
  * arrays are saved whole (logical, unsharded), so a restart may use
    another mesh: :meth:`CheckpointManager.restore` lays each leaf onto the
    new mesh's placements (``shardings=``), the elastic restart.

Under a device mesh every rank calls :meth:`CheckpointManager.save`: each
DTensor leaf is gathered whole on every rank (every rank must join the
collective), and rank 0 alone writes.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.objects import _leaves_with_keys
from repro_torch.core.tiering import map_leaves

_V2 = np.dtype("V2")


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor leaf gathered whole (a collective every rank joins); a
    shard that lives in host memory (a REMOTE leaf) goes to the mesh's
    device for it."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return t
    local = t.to_local().detach()
    if local.device.type != t.device_mesh.device_type:
        t = DTensor.from_local(local.to(t.device_mesh.device_type),
                               t.device_mesh, t.placements, run_check=False)
    return t.full_tensor()


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` on the host: a leaf that already lives there (a
    REMOTE parameter or moment) is updated in place by the next step while
    the writer thread still reads the snapshot."""
    t = _whole(t).detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_V2)
    return t.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``a`` as a tensor of ``like``'s dtype on ``like``'s device; a bf16
    leaf's file holds its 2-byte words."""
    if like.dtype == torch.bfloat16 and a.dtype == _V2:
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(like.device)
    return torch.from_numpy(np.array(a)).to(like.device, like.dtype)


def _flatten(tree: Any, prefix: str) -> dict[str, np.ndarray]:
    return {prefix + key: _to_numpy(leaf)
            for key, leaf in _leaves_with_keys(tree)}


def _unflatten_like(template: Any, flat: dict[str, np.ndarray], prefix: str):
    def leaf(key: str, like: torch.Tensor) -> torch.Tensor:
        arr = flat[prefix + key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {prefix + key}: {arr.shape} != "
                             f"{tuple(like.shape)}")
        out = _from_numpy(arr, like)
        return _laid_like(out, like)

    return map_leaves(leaf, template)


def _laid_like(whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``whole`` laid out as the template leaf ``like``: a DTensor template
    gives a DTensor with its placements on its mesh's device."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if not isinstance(like, DTensor):
        return whole
    mesh = like.device_mesh
    return distribute_tensor(whole.to(mesh.device_type), mesh,
                             like.placements, src_data_rank=None)


def _resharded(tree: Any, shardings: Any) -> Any:
    """Each leaf of ``tree`` as a DTensor with its sharding in
    ``shardings`` (the same structure)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    by_key = dict(_leaves_with_keys(shardings))

    def put(key: str, t: torch.Tensor) -> torch.Tensor:
        sh = by_key[key]
        if isinstance(t, DTensor):
            t = t.full_tensor()
        return distribute_tensor(t.to(sh.mesh.device_type), sh.mesh,
                                 sh.placements, src_data_rank=None)

    return map_leaves(put, tree)


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, *, keep: int = 3,
                 delta: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.delta = delta
        self._writer: threading.Thread | None = None
        self._hashes: dict[str, str] = {}
        self._lock = threading.Lock()
        self.write_log: list[dict] = []

    # -- save --------------------------------------------------------------
    def save(self, step: int, params: Any, opt_state: Any, *,
             metadata: dict | None = None, blocking: bool = False) -> None:
        """Snapshot to host, then persist asynchronously (on rank 0 alone
        when a process group is up)."""
        snap = {"params": _flatten(params, "params"),
                "opt": _flatten(opt_state, "opt")}
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        meta = dict(metadata or {})
        meta["step"] = step
        meta["time"] = time.time()
        self.wait()  # one writer at a time; snapshot already taken
        self._writer = threading.Thread(
            target=self._write, args=(step, snap, meta), daemon=True)
        self._writer.start()
        if blocking:
            self.wait()

    def _write(self, step: int, snap: dict, meta: dict,
               prefix: str = "step") -> None:
        t0 = time.time()
        tmp = self.dir / f"tmp.{prefix}.{step}"
        final = self.dir / f"{prefix}_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        written = 0
        skipped = 0
        prev = self.latest_dir(exclude=final, prefix=prefix)
        manifest = {}
        for group, flat in snap.items():
            for key, arr in flat.items():
                h = hashlib.sha1(arr.tobytes()).hexdigest()[:16]
                fname = hashlib.sha1(key.encode()).hexdigest()[:24] + ".npy"
                manifest[key] = {"file": fname, "hash": h}
                if (
                    self.delta
                    and prev is not None
                    and self._hashes.get(key) == h
                    and (prev / fname).exists()
                ):
                    # unchanged since last checkpoint: hard-link the old blob
                    (tmp / fname).hardlink_to(prev / fname)
                    skipped += 1
                else:
                    np.save(tmp / fname, arr)
                    written += 1
                self._hashes[key] = h
        meta["manifest"] = manifest
        (tmp / "meta.json").write_text(json.dumps(meta, default=str))
        tmp.rename(final)
        with self._lock:
            self.write_log.append(
                {"step": step, "written": written, "delta_skipped": skipped,
                 "seconds": round(time.time() - t0, 3)})
        self._gc()

    def wait(self) -> None:
        if self._writer is not None and self._writer.is_alive():
            self._writer.join()

    def _gc(self) -> None:
        # training and store snapshots live in separate step_*/store_*
        # namespaces; each keeps its own most-recent ``keep``
        for prefix in ("step", "store"):
            ckpts = sorted(self.dir.glob(f"{prefix}_*"))
            for old in ckpts[: -self.keep]:
                shutil.rmtree(old, ignore_errors=True)

    # -- remote-store / memory-pool checkpointing ---------------------------
    STORE_PREFIX = "store:"

    def save_store(self, step: int, store: Any, *,
                   metadata: dict | None = None, blocking: bool = False) -> None:
        """Checkpoint a RemoteStore/MemoryPool's logical objects.

        The snapshot reassembles striped/replicated extents into logical
        objects (``snapshot_objects``), so a restore works on any pool
        geometry, one that lost nodes since the save included. Store
        snapshots live in their own ``store_<n>`` namespace, so they never
        collide with (or get shadowed by) training checkpoints.
        """
        snap = {"store": {self.STORE_PREFIX + name: np.asarray(arr)
                          for name, arr in store.snapshot_objects().items()}}
        meta = dict(metadata or {})
        meta["step"] = step
        meta["kind"] = "store"
        meta["time"] = time.time()
        try:
            meta["store_stats"] = store.stats()
        except Exception:  # noqa: BLE001 - stats are an optional extra
            pass
        self.wait()
        self._writer = threading.Thread(
            target=self._write, args=(step, snap, meta, "store"), daemon=True)
        self._writer.start()
        if blocking:
            self.wait()

    def restore_store_blobs(self) -> dict[str, np.ndarray] | None:
        """Latest store snapshot as ``{object_name: array}``: the input to
        :meth:`MemoryPool.recover(from_blobs=...)` and ``restore_objects``."""
        d = self.latest_dir(prefix="store")
        if d is None:
            return None
        meta = json.loads((d / "meta.json").read_text())
        out = {}
        for key, entry in meta["manifest"].items():
            if key.startswith(self.STORE_PREFIX):
                out[key[len(self.STORE_PREFIX):]] = np.load(d / entry["file"])
        return out or None

    # -- restore ------------------------------------------------------------
    def latest_dir(self, exclude: pathlib.Path | None = None,
                   prefix: str = "step"):
        ckpts = sorted(d for d in self.dir.glob(f"{prefix}_*") if d != exclude)
        return ckpts[-1] if ckpts else None

    def latest_step(self) -> int | None:
        d = self.latest_dir()
        return int(d.name.split("_")[1]) if d else None

    def restore(self, params_template: Any, opt_template: Any, *,
                shardings: tuple | None = None):
        """Load the latest checkpoint: each leaf a tensor of its template
        leaf's dtype, on its device (a DTensor template leaf: on its mesh's
        device). With ``shardings`` = (params', opt state's) trees of
        :class:`~repro_torch.models.sharding.NamedSharding` (the
        reference's elastic restart onto a new mesh), each leaf becomes a
        DTensor with its sharding, every rank keeping its own block of
        the whole array it read."""
        d = self.latest_dir()
        if d is None:
            return None
        meta = json.loads((d / "meta.json").read_text())
        flat = {key: np.load(d / entry["file"])
                for key, entry in meta["manifest"].items()}
        params = _unflatten_like(params_template, flat, "params")
        opt = _unflatten_like(opt_template, flat, "opt")
        if shardings is not None:
            p_sh, o_sh = shardings
            params, opt = _resharded(params, p_sh), _resharded(opt, o_sh)
        return {"step": meta["step"], "params": params, "opt_state": opt,
                "metadata": meta}

"""The port's asynchronous checkpoint manager
(``repro_torch.checkpoint.manager``): the reference's cases of
``tests/test_checkpoint.py`` pointed at the port, checkpoints written by
one package restored by the other (float32, bf16 and int8 moments), and
the two cases of ``tests/test_pool.py::TestFailure`` that need it."""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as ref_optim
from repro.checkpoint import CheckpointManager as RefManager

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import MemoryPool
from repro_torch.core.objects import _leaves_with_keys
from repro_torch.optim import AdamWConfig
from repro_torch.optim import init as adamw_init
from repro_torch.optim.quantized import QTensor

KIB = 1 << 10


def _state(seed=0, scale=1.0):
    w = np.random.default_rng(seed).standard_normal((32, 32)).astype(
        np.float32)
    return (
        {"w": scale * torch.from_numpy(w), "b": torch.zeros((8,))},
        {"m": {"w": torch.ones((32, 32)), "b": torch.zeros((8,))},
         "step": torch.tensor(5, dtype=torch.int32)},
    )


def _add(tree, x):
    return {k: _add(v, x) if isinstance(v, dict) else v + x
            for k, v in tree.items()}


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    params, opt = _state()
    mgr.save(10, params, opt, metadata={"arch": "test"}, blocking=True)
    out = mgr.restore(params, opt)
    assert out["step"] == 10
    assert out["metadata"]["arch"] == "test"
    got = dict(_leaves_with_keys(out["params"]))
    for k, t in _leaves_with_keys(params):
        assert torch.equal(got[k], t)
    assert out["opt_state"]["step"].dtype == torch.int32


def test_latest_wins_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    params, opt = _state()
    for step in (10, 20, 30):
        mgr.save(step, _add(params, step), opt, blocking=True)
    assert mgr.latest_step() == 30
    assert len(list(tmp_path.glob("step_*"))) == 2  # gc keeps 2
    out = mgr.restore(params, opt)
    np.testing.assert_allclose(out["params"]["b"], params["b"] + 30)


def test_delta_checkpoint_skips_unchanged(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    params, opt = _state()
    mgr.save(1, params, opt, blocking=True)
    params2 = dict(params)
    params2["b"] = params["b"] + 1  # only 'b' changes
    mgr.save(2, params2, opt, blocking=True)
    log = {e["step"]: e for e in mgr.write_log}
    assert log[2]["delta_skipped"] > 0
    assert log[2]["written"] < log[1]["written"]
    out = mgr.restore(params, opt)
    np.testing.assert_allclose(out["params"]["b"], params["b"] + 1)


def test_atomicity_no_partial_checkpoints(tmp_path):
    mgr = CheckpointManager(tmp_path)
    params, opt = _state()
    mgr.save(10, params, opt, blocking=True)
    # simulate a crash leaving a tmp dir behind
    (tmp_path / "tmp.99").mkdir()
    (tmp_path / "tmp.99" / "garbage.npy").write_bytes(b"x")
    assert mgr.latest_step() == 10  # tmp dirs never count


def test_restore_onto_template_devices_and_dtypes(tmp_path):
    """The reference's elastic restore re-places leaves onto new
    shardings; the port restores each leaf onto its template's device and
    dtype, and with ``shardings`` onto a mesh's placements (here a (1, 1)
    mesh of this process; test_torch_mesh.py restores (2, 2) onto (1, 4))."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate

    from repro_torch.core.tiering import map_leaves
    from repro_torch.models.sharding import NamedSharding

    from _torch_dist import one_rank_group

    mgr = CheckpointManager(tmp_path / "ckpt")
    params, opt = _state(1)
    mgr.save(3, params, opt, blocking=True)
    template = {"w": params["w"].to(torch.bfloat16), "b": params["b"]}
    out = mgr.restore(template, opt)
    assert out["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["w"], params["w"].to(torch.bfloat16))
    with one_rank_group(str(tmp_path)):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
        sh = NamedSharding(mesh, (Replicate(), Replicate()))
        out = mgr.restore(params, opt, shardings=(
            map_leaves(lambda _k, _t: sh, params),
            map_leaves(lambda _k, _t: sh, opt)))
        w = out["params"]["w"]
        assert tuple(w.placements) == (Replicate(), Replicate())
        assert torch.equal(w.full_tensor(), params["w"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_snapshot_is_a_copy_of_host_leaves(tmp_path, dtype):
    """A leaf on the host (a REMOTE parameter or moment) that the next step
    updates in place while the writer thread runs: the checkpoint holds the
    values at ``save``. The writer is held until after the update."""
    mgr = CheckpointManager(tmp_path)
    params, opt = _state(2)
    params = {k: v.to(dtype) for k, v in params.items()}
    want = {k: v.clone() for k, v in params.items()}
    gate = threading.Event()
    write = mgr._write
    mgr._write = lambda *args: (gate.wait(), write(*args))
    mgr.save(4, params, opt)
    for t in (*params.values(), opt["m"]["w"]):
        t.add_(1)  # the next step, in place
    gate.set()
    mgr.wait()
    out = mgr.restore(params, opt)
    for k, t in want.items():
        assert torch.equal(out["params"][k], t), k
    assert torch.equal(out["opt_state"]["m"]["w"], torch.ones((32, 32)))


def test_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    params, opt = _state()
    mgr.save(1, params, opt, blocking=True)
    with pytest.raises(ValueError, match="checkpoint leaf"):
        mgr.restore({"w": torch.zeros((4, 4)), "b": params["b"]}, opt)


# -- across the two packages ----------------------------------------------------

def _ref_trees(dtype):
    """Reference parameters (a bf16 or float32 tree), its int8 AdamW state
    with one quantized leaf, and the same values as numpy."""
    rng = np.random.default_rng(7)
    np_params = {"w": rng.standard_normal((1024, 256)).astype(np.float32),
                 "b": rng.standard_normal((4,)).astype(np.float32)}
    params = {k: jnp.asarray(v).astype(dtype) for k, v in np_params.items()}
    cfg = ref_optim.AdamWConfig(moment_style="int8", warmup_steps=0)
    opt = ref_optim.init(cfg, params)
    grads = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
             .astype(dtype) for k, v in np_params.items()}
    params, opt, _ = ref_optim.update(cfg, grads, opt, params)
    return params, opt


def _port_like(ref_tree):
    """A port template with the reference tree's structure, dtypes and
    shapes (zeros)."""
    if isinstance(ref_tree, dict):
        return {k: _port_like(v) for k, v in ref_tree.items()}
    if hasattr(ref_tree, "codes"):
        return QTensor(_port_like(ref_tree.codes), _port_like(ref_tree.scale))
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int8": torch.int8, "int32": torch.int32}[str(ref_tree.dtype)]
    return torch.zeros(tuple(ref_tree.shape), dtype=dt)


def _as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_reference_checkpoint_restores_in_the_port(tmp_path, dtype):
    params, opt = _ref_trees(dtype)
    ref = RefManager(tmp_path)
    ref.save(7, params, opt, metadata={"arch": "x"}, blocking=True)
    out = CheckpointManager(tmp_path).restore(_port_like(params),
                                              _port_like(opt))
    assert out["step"] == 7 and out["metadata"]["arch"] == "x"
    for tree, got in ((params, out["params"]), (opt, out["opt_state"])):
        got = dict(_leaves_with_keys(got))
        want = {jax.tree_util.keystr(p): v for p, v in
                jax.tree_util.tree_leaves_with_path(tree)}
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(_as_f32(got[k]), _as_f32(v))
            assert str(got[k].dtype).removeprefix("torch.") == str(v.dtype)
    assert isinstance(out["opt_state"]["m"]["w"], QTensor)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """float32 and int8 leaves round-trip into the reference (its restore
    casts with numpy, which has no bf16 without ml_dtypes' cast from the
    2-byte words, so bf16 is held one way, above)."""
    params, opt = _ref_trees(jnp.float32)
    mgr = CheckpointManager(tmp_path)
    port_params = {k: torch.from_numpy(np.array(v)) for k, v in
                   params.items()}
    port_opt = adamw_init(AdamWConfig(moment_style="int8"), port_params)
    mgr.save(4, port_params, port_opt, blocking=True)
    out = RefManager(tmp_path).restore(params, opt)
    assert out["step"] == 4
    for k in params:
        np.testing.assert_array_equal(np.asarray(out["params"][k]),
                                      port_params[k].numpy())
    np.testing.assert_array_equal(np.asarray(out["opt_state"]["m"]["w"].codes),
                                  port_opt["m"]["w"].codes.numpy())


# -- tests/test_pool.py::TestFailure, the two cases that need the manager -------

def _blob(nbytes, seed=0):
    return np.random.default_rng(seed).integers(0, 255, size=nbytes,
                                                dtype=np.uint8)


def test_recover_from_checkpoint_blobs(tmp_path):
    pool = MemoryPool(2, stripe_bytes=32 * KIB, replication=1)
    arr = np.random.default_rng(7).standard_normal(64 * KIB // 8)
    pool.alloc("x", arr)
    mgr = CheckpointManager(tmp_path)
    mgr.save_store(0, pool, blocking=True)
    pool.fail_node(0)

    blobs = mgr.restore_store_blobs()
    assert blobs is not None and "x" in blobs
    stats = pool.recover(from_blobs=blobs)
    assert stats["restored_extents"] > 0
    got, _ = pool.read_object("x")
    assert np.array_equal(got, arr)


def test_store_snapshot_survives_newer_training_checkpoint(tmp_path):
    """store_* and step_* namespaces are independent: a later training
    checkpoint must not shadow the store snapshot (or collide with it
    when both land on the same step number)."""
    pool = MemoryPool(2, stripe_bytes=32 * KIB, replication=1)
    arr = _blob(64 * KIB, seed=9)
    pool.alloc("x", arr)
    mgr = CheckpointManager(tmp_path)
    mgr.save_store(5, pool, blocking=True)
    params = {"w": torch.ones((4,))}
    mgr.save(5, params, {"m": torch.zeros((4,))}, blocking=True)  # same step
    mgr.save(6, params, {"m": torch.zeros((4,))}, blocking=True)  # newer

    blobs = mgr.restore_store_blobs()
    assert blobs is not None and np.array_equal(blobs["x"], arr)
    assert mgr.latest_step() == 6  # training restore path unaffected
    pool.fail_node(0)
    pool.recover(from_blobs=blobs)
    assert np.array_equal(pool.read_object("x")[0], arr)

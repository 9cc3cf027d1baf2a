"""The port's input pipeline (``repro_torch.data.pipeline``): the
reference's cases of ``tests/test_data_pipeline.py`` pointed at the port
(``device_put_fn`` over a (1, 1) mesh here; test_torch_mesh.py runs it on a
four-rank mesh), batches ``==`` to the reference's, and the loader's
device put."""
import tempfile

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.data import SyntheticTokenDataset as RefDataset

from repro_torch.configs import get_config, reduced_config
from repro_torch.data import PrefetchingLoader, SyntheticTokenDataset
from repro_torch.data.pipeline import device_put_fn, to_device_fn


def _cfg(arch="granite-8b"):
    return reduced_config(get_config(arch))


def test_batches_deterministic_in_step():
    ds1 = SyntheticTokenDataset(_cfg(), batch=4, seq=32, seed=7)
    ds2 = SyntheticTokenDataset(_cfg(), batch=4, seq=32, seed=7)
    for step in (0, 5, 1000):
        np.testing.assert_array_equal(
            ds1.batch_at(step)["tokens"], ds2.batch_at(step)["tokens"])
    assert not np.array_equal(
        ds1.batch_at(1)["tokens"], ds1.batch_at(2)["tokens"])


def test_tokens_in_vocab_range():
    cfg = _cfg()
    ds = SyntheticTokenDataset(cfg, batch=4, seq=64, seed=0)
    toks = ds.batch_at(3)["tokens"]
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size


def test_prefetching_loader_orders_and_resumes():
    ds = SyntheticTokenDataset(_cfg(), batch=2, seq=16, seed=1)
    loader = PrefetchingLoader(ds, start_step=10)
    try:
        steps = [next(loader)[0] for _ in range(5)]
        assert steps == [10, 11, 12, 13, 14]  # exact resume point
        _, batch = next(loader)
        np.testing.assert_array_equal(batch["tokens"],
                                      ds.batch_at(15)["tokens"])
    finally:
        loader.close()


def test_loader_put_fn_applied():
    ds = SyntheticTokenDataset(_cfg(), batch=2, seq=16, seed=1)
    loader = PrefetchingLoader(ds, put_fn=lambda b: {"n": b["tokens"].sum()})
    try:
        _, batch = next(loader)
        assert set(batch) == {"n"}
    finally:
        loader.close()


@pytest.mark.parametrize("arch", ["granite-8b", "internvl2-1b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("seed", [0, 3])
def test_batches_equal_reference(arch, seed):
    ref = RefDataset(ref_reduced_config(ref_get_config(arch)), 3, 24,
                     seed=seed)
    port = SyntheticTokenDataset(_cfg(arch), 3, 24, seed=seed)
    for step in (0, 7, 123456):
        want, got = ref.batch_at(step), port.batch_at(step)
        assert want.keys() == got.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), (k, step)


def test_to_device_fn_types():
    cfg = reduced_config(get_config("internvl2-1b"), dtype=torch.bfloat16)
    batch = SyntheticTokenDataset(cfg, 2, 16).batch_at(0)
    out = to_device_fn("cpu", cfg.dtype)(batch)
    assert out["tokens"].dtype == torch.int32
    assert out["patches"].dtype == torch.bfloat16
    assert np.array_equal(out["labels"].numpy(), batch["labels"])
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate

    from repro_torch.models.sharding import batch_pspec_tree

    from _torch_dist import one_rank_group

    # over a mesh, the same batch as DTensors in their sharded layout
    with tempfile.TemporaryDirectory() as d, one_rank_group(d):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
        put = device_put_fn(mesh, lambda b: batch_pspec_tree(b, mesh),
                            dtype=cfg.dtype)(batch)
        # an axis of one splits nothing: replicated
        assert tuple(put["tokens"].placements) == (Replicate(), Replicate())
        for k, t in out.items():
            assert torch.equal(put[k].full_tensor(), t), k

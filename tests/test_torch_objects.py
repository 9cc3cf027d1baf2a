"""The port's ``ObjectCatalog.from_step_fn`` against the reference's.

The reference counts the equations of a jaxpr trace, a ``scan`` body
once; the port counts the ATen ops of one eager run, so a stacked layer
leaf is counted once per layer. The two are held equal where no layer
loop is traced (the reference's own case), and on the reduced granite-8b
loss step of ``benchmarks/fig5_objects.lm_census`` everything but the
read counts is equal and the counts keep the stated relation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.core.objects import ObjectCatalog as RefCatalog
from repro.core.objects import ObjectKind as RefKind
from repro.models import get_model as ref_get_model
from repro.models import make_batch as ref_make_batch

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.core.objects import ObjectCatalog, ObjectKind
from repro_torch.models import get_model

from _torch_model_parity import one_torch_thread  # noqa: F401


def test_from_step_fn_counts_reads_as_the_reference():
    """``tests/test_core_placement.py``'s case: w1 read twice, w2 once,
    every field equal to the reference's catalog."""
    def ref_step(params, x):
        h = x @ params["w1"]
        h = h @ params["w2"] + x @ params["w1"]  # w1 read twice
        return h.sum()

    ref = RefCatalog.from_step_fn(
        ref_step, {"w1": jnp.zeros((32, 32)), "w2": jnp.zeros((32, 32))},
        jnp.zeros((4, 32)), kinds=[RefKind.PARAM, RefKind.INPUT])
    got = ObjectCatalog.from_step_fn(
        ref_step, {"w1": torch.zeros((32, 32)), "w2": torch.zeros((32, 32))},
        torch.zeros((4, 32)), kinds=[ObjectKind.PARAM, ObjectKind.INPUT])
    assert got["arg0['w1']"].n_reads == 2
    assert got["arg0['w2']"].n_reads == 1
    assert got.names() == ref.names()
    for o in ref:
        g = got[o.name]
        assert (g.shape, g.kind.value, g.n_reads, g.n_writes,
                g.lifetime_iters, g.size_bytes) == (
            o.shape, o.kind.value, o.n_reads, o.n_writes, o.lifetime_iters,
            o.size_bytes), o.name
    assert got.census() == ref.census()


def _lm_census(n_layers: int):
    """``fig5_objects.lm_census`` in both packages at ``n_layers``: the
    reference's reduced granite-8b loss step, its parameters and batch
    carried into the port."""
    ref_cfg = ref_reduced_config(ref_get_config("granite-8b"),
                                 dtype=jnp.float32, n_layers=n_layers)
    model = ref_get_model(ref_cfg)
    params = model.init_params(jax.random.PRNGKey(0), ref_cfg)
    batch = ref_make_batch(ref_cfg, jax.random.PRNGKey(1), 2, 32)
    ref = RefCatalog.from_step_fn(
        lambda p, b: model.loss_fn(p, b, ref_cfg)[0], params, batch,
        kinds=[RefKind.PARAM, RefKind.INPUT], donate_argnums=(0,))
    cfg = reduced_config(get_config("granite-8b"), dtype=torch.float32,
                         n_layers=n_layers)
    port = get_model(cfg)
    tokens = torch.from_numpy(np.array(batch["tokens"]))
    got = ObjectCatalog.from_step_fn(
        lambda p, b: port.loss_fn(p, b, cfg)[0],
        params_from_reference(params, device="cpu"),
        {"tokens": tokens, "labels": tokens},
        kinds=[ObjectKind.PARAM, ObjectKind.INPUT], donate_argnums=(0,))
    return ref, got


@pytest.fixture(scope="module")
def censuses():
    return {n: _lm_census(n) for n in (2, 4)}


def test_lm_census_matches_the_reference_but_the_reads(censuses):
    """Names, shapes, kinds, writes, lifetimes and ``census()`` equal to
    the reference's; every leaf is read in both."""
    for ref, got in censuses.values():
        assert got.names() == ref.names()
        for o in ref:
            g = got[o.name]
            assert (g.shape, g.kind.value, g.n_writes, g.lifetime_iters,
                    g.size_bytes) == (o.shape, o.kind.value, o.n_writes,
                                      o.lifetime_iters, o.size_bytes), o.name
            assert g.n_reads >= 1 and o.n_reads >= 1, o.name
        assert got.census() == ref.census()


def test_lm_census_reads_keep_the_stated_relation(censuses):
    """The reference counts a stacked leaf's scan body once, so its counts
    do not change from 2 to 4 layers; the port counts each layer, so a
    stacked leaf's count doubles and every other leaf's stays."""
    (ref2, got2), (ref4, got4) = censuses[2], censuses[4]
    for o in ref2:
        assert ref4[o.name].n_reads == o.n_reads, o.name
        stacked = o.name.startswith("arg0['layers']")
        want = 2 * got2[o.name].n_reads if stacked else got2[o.name].n_reads
        assert got4[o.name].n_reads == want, o.name
        if stacked:
            assert got2[o.name].n_reads % 2 == 0, o.name

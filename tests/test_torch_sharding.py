"""The port's logical sharding rules (``repro_torch.models.sharding``)
against the reference's, on abstract meshes (no process group).

The reference's cases of ``tests/test_sharding.py`` pointed at the port,
then spec parity: for every architecture at its full config shapes, the
reference's ``jax.eval_shape`` trees (parameters, int8 optimizer moments,
decode cache, batch) given to the port as ``meta`` tensors with the same
paths, and both packages' spec trees compared entry for entry (``==``) at
meshes (16, 16), (2, 16, 16), (2, 4) and (1, 1), with ``fsdp`` on and off
and under rule overrides. The reduced configs' parameter trees of the two
packages have the same paths and shapes.
"""
import functools

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.configs.base import SHAPE_CELLS as REF_SHAPE_CELLS
from repro.core import tiering as ref_tiering
from repro.models import api as ref_api
from repro.models import get_model as ref_get_model
from repro.models import sharding as R
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import init as ref_adamw_init

from repro_torch.configs import ARCH_IDS, get_config, reduced_config
from repro_torch.configs.base import SHAPE_CELLS
from repro_torch.core import tiering
from repro_torch.core.objects import _leaves_with_keys
from repro_torch.models import api, get_model
from repro_torch.models import sharding as S
from repro_torch.models.sharding import P, abstract_mesh, resolve_spec
from repro_torch.optim import AdamWConfig
from repro_torch.optim import init as adamw_init
from repro_torch.optim.quantized import QTensor

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
#: Rule sets: the defaults, and FSDP streaming with the ff dim left whole.
RULES = {"default": {}, "fsdp_data": {"fsdp": "data", "layers": "data",
                                       "ff": None}}
_DTYPES = {jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16,
           jnp.dtype(jnp.int32): torch.int32,
           jnp.dtype(jnp.int8): torch.int8}


@pytest.fixture(scope="module")
def mesh():
    return abstract_mesh((1, 1), ("data", "model"))


class TestResolveSpec:
    def test_basic(self, mesh):
        assert resolve_spec((8, 16), ("batch", "ff"), mesh) == P("data",
                                                                 "model")

    def test_divisibility_drops_axis(self):
        m = abstract_mesh((16, 16), ("data", "model"))
        spec = resolve_spec((64, 1), ("batch", "kv_heads"), m)
        assert spec[1] is None and spec[0] == "data"
        assert resolve_spec((64, 36), ("batch", "heads"), m)[1] is None

    def test_axis_conflict_single_use(self, mesh):
        with S.use_mesh(mesh):
            spec = resolve_spec((8, 8), ("batch", "kv_len"))
        flat = [a for e in spec if e
                for a in (e if isinstance(e, tuple) else (e,))]
        assert len(flat) == len(set(flat))

    def test_no_mesh_is_replicated(self):
        assert resolve_spec((8, 8), ("batch", "ff"), None) == P(None, None)

    def test_rules_override(self, mesh):
        with S.use_rules(ff=None):
            assert resolve_spec((8, 16), (None, "ff"), mesh) == P(None, None)


def test_fsdp_names_shard_weight_dims():
    assert S.param_logical_names(("layers", "attn", "wq"), 3,
                                 fsdp=True) == ("layers", "fsdp", "heads")


def test_rules_and_defaults_are_the_reference_s():
    assert S.DEFAULT_RULES == R.DEFAULT_RULES
    assert S.get_rules() == R.get_rules()
    ref, port = ref_tiering.TieringConfig(), tiering.TieringConfig()
    for field in ("mode", "local_fraction", "degradation_target", "prefetch",
                  "prefetch_under_remat", "fsdp_axis"):
        assert getattr(port, field) == getattr(ref, field), field


def test_constrain_without_a_mesh_is_the_identity():
    x = torch.ones((2, 3))
    assert S.constrain(x, "batch", None) is x
    with S.use_mesh(abstract_mesh((1, 1), ("data", "model"))), \
            pytest.raises(TypeError, match="plain"):
        S.constrain(x, "batch", None)


# -- spec parity ---------------------------------------------------------------

def _meta(tree):
    """A JAX shape tree as nested dicts of meta tensors (a QTensor node as
    the port's QTensor)."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if type(tree).__name__ == "QTensor":
        return QTensor(_meta(tree.codes), _meta(tree.scale))
    return torch.empty(tree.shape, dtype=_DTYPES[jnp.dtype(tree.dtype)],
                       device="meta")


def _ref_flat(specs) -> dict[str, tuple]:
    return {jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, R.P))}


def _port_flat(specs, key: str = "") -> dict[str, tuple]:
    if isinstance(specs, dict):
        out = {}
        for k in sorted(specs):
            out.update(_port_flat(specs[k], f"{key}[{k!r}]"))
        return out
    if isinstance(specs, QTensor):
        return {f"{key}.codes": tuple(specs.codes),
                f"{key}.scale": tuple(specs.scale)}
    return {key: tuple(specs)}


@functools.cache
def _shapes(arch: str):
    """The reference's abstract parameters, int8 moments, decode cache and
    batch of ``arch`` at full size."""
    cfg = ref_get_config(arch)
    model = ref_get_model(cfg)
    params = jax.eval_shape(functools.partial(model.init_params, cfg=cfg),
                            jax.random.key(0))
    opt = jax.eval_shape(functools.partial(
        ref_adamw_init, RefAdamWConfig(moment_style="int8")), params)
    cache, _ = ref_api.decode_specs(cfg, REF_SHAPE_CELLS["decode_32k"])
    batch = ref_api.batch_specs(cfg, REF_SHAPE_CELLS["train_4k"])
    return cfg, params, opt, cache, batch


@pytest.mark.parametrize("mesh_id", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_trees_equal_the_reference_s(arch, mesh_id):
    cfg, params, opt, cache, batch = _shapes(arch)
    shape, axes = MESHES[mesh_id]
    rm, pm = R.abstract_mesh(shape, axes), abstract_mesh(shape, axes)
    p_meta, o_meta = _meta(params), _meta(opt)
    port_cfg = get_config(arch)
    # the port's own cache and batch stand-ins, on the meta device
    c_meta, _ = api.decode_specs(port_cfg, SHAPE_CELLS["decode_32k"])
    b_meta = api.batch_specs(port_cfg, SHAPE_CELLS["train_4k"])
    assert _shape_map(c_meta) == _shape_map(_meta(cache))
    assert _shape_map(b_meta) == _shape_map(_meta(batch))
    n = 0
    for rules in RULES.values():
        for fsdp in (False, True):
            with R.use_rules(**rules), S.use_rules(**rules):
                rp = R.params_pspec_tree(params, fsdp=fsdp, mesh=rm,
                                         expert_sharding=cfg.expert_sharding)
                pp = S.params_pspec_tree(p_meta, fsdp=fsdp, mesh=pm,
                                         expert_sharding=cfg.expert_sharding)
                pairs = [(rp, pp),
                         (R.opt_pspec_tree(opt, rp, rm),
                          S.opt_pspec_tree(o_meta, pp, pm)),
                         (R.cache_pspec_tree(cache, rm),
                          S.cache_pspec_tree(c_meta, pm)),
                         (R.batch_pspec_tree(batch, rm),
                          S.batch_pspec_tree(b_meta, pm))]
                for r, p in pairs:
                    want, got = _ref_flat(r), _port_flat(p)
                    assert got == want
                    n += len(want)
                for spec in _port_flat(pp).values():
                    assert S.shard_factor(spec, pm) == R.shard_factor(
                        R.P(*spec), rm)
    assert n > 0


def _shape_map(tree) -> dict[str, tuple]:
    return {k: tuple(t.shape) for k, t in _leaves_with_keys(tree)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_param_tree_is_the_reference_s(arch):
    ref_cfg = ref_reduced_config(ref_get_config(arch))
    ref = jax.eval_shape(functools.partial(
        ref_get_model(ref_cfg).init_params, cfg=ref_cfg), jax.random.key(0))
    cfg = reduced_config(get_config(arch))
    port = get_model(cfg).init_params(torch.Generator().manual_seed(0), cfg,
                                      device="cpu")
    assert _shape_map(port) == {jax.tree_util.keystr(p): tuple(x.shape)
                                for p, x in
                                jax.tree_util.tree_leaves_with_path(ref)}


def test_opt_specs_mirror_params(mesh):
    cfg = reduced_config(get_config("granite-8b"))
    params = get_model(cfg).init_params(torch.Generator().manual_seed(0), cfg,
                                        device="cpu")
    pspecs = S.params_pspec_tree(params, mesh=mesh)
    opt = adamw_init(AdamWConfig(moment_style="int8"), params)
    specs = _port_flat(S.opt_pspec_tree(opt, pspecs, mesh))
    for k, leaf in _leaves_with_keys(opt):
        assert len(specs[k]) == len(leaf.shape), k

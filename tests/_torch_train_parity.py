"""Shared set-up of the port's training tests (``test_torch_train.py``,
``test_torch_train_step.py``): a reduced architecture in both packages,
the reference's parameters carried over with ``params_from_reference``,
one numpy batch, and the reference's ``jax.value_and_grad`` of its
``loss_fn`` to hold the port's against."""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import get_model as ref_get_model

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.core.objects import _leaves_with_keys
from repro_torch.models import get_model

B, S = 2, 16


def as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


class Ref:
    """A reduced architecture in both packages: the reference's parameters
    (and the port's copy), one numpy batch (with the enc-dec family's
    ``frames``, the vlm family's ``patches``), and the reference's loss,
    metrics and gradients
    (``jax.value_and_grad`` of its ``loss_fn``, computed at their first
    use)."""

    def __init__(self, arch: str, dtype: str = "float32", batch: int = B,
                 seq: int = S, **overrides):
        jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                    else (jnp.bfloat16, torch.bfloat16))
        self.ref_cfg = ref_reduced_config(ref_get_config(arch), dtype=jdt,
                                          **overrides)
        self.cfg = reduced_config(get_config(arch), dtype=tdt, **overrides)
        self.ref_model = ref_get_model(self.ref_cfg)
        self.model = get_model(self.cfg)
        self.ref_params = self.ref_model.init_params(jax.random.PRNGKey(0),
                                                     self.ref_cfg)
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, self.cfg.vocab_size,
                              (batch, seq)).astype(np.int32)
        self.ref_batch = {"tokens": jnp.asarray(tokens),
                          "labels": jnp.asarray(tokens)}
        self.batch = {"tokens": torch.from_numpy(tokens),
                      "labels": torch.from_numpy(tokens)}
        stub = {"encdec": "frames", "audio": "frames", "vlm": "patches"}
        if self.cfg.family in stub:
            emb = rng.standard_normal(
                (batch, self.cfg.frontend_len, self.cfg.d_model)).astype(
                np.float32)
            self.ref_batch[stub[self.cfg.family]] = jnp.asarray(emb).astype(
                jdt)
            self.batch[stub[self.cfg.family]] = torch.from_numpy(emb).to(tdt)

    @functools.cached_property
    def _value_and_grad(self):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: self.ref_model.loss_fn(p, self.ref_batch, self.ref_cfg,
                                             remat="none"), has_aux=True))(
            self.ref_params)
        return (float(loss), {k: float(v) for k, v in metrics.items()},
                {k: as_np(g) for k, g in _leaves_with_keys(grads)})

    @property
    def loss(self) -> float:
        return self._value_and_grad[0]

    @property
    def metrics(self) -> dict:
        return self._value_and_grad[1]

    @property
    def grads(self) -> dict:
        return self._value_and_grad[2]

    def params(self):
        return params_from_reference(self.ref_params, device="cpu")

    def port_loss_and_grads(self, remat: str):
        params = self.params()
        leaves = [t.requires_grad_(True) for _, t in _leaves_with_keys(params)]
        loss, metrics = self.model.loss_fn(params, self.batch, self.cfg,
                                           remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        keys = [k for k, _ in _leaves_with_keys(params)]
        return (loss.detach(), {k: float(v) for k, v in metrics.items()},
                dict(zip(keys, grads)))


def check_f32(ref: Ref, loss, metrics, grads) -> None:
    """Loss at rtol 1e-5; every gradient at 1e-4 of its leaf's max |g|."""
    np.testing.assert_allclose(float(loss), ref.loss, rtol=1e-5)
    for k, v in ref.metrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert set(grads) == set(ref.grads)
    for k, g in grads.items():
        want = ref.grads[k]
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(as_np(g) - want).max()) <= 1e-4 * scale, k

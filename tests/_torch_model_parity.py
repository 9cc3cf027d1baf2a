"""Shared set-up of the port's model parity tests (``test_torch_dense.py``,
``test_torch_hybrid.py``): a reduced reference model and the port's, the
reference's parameters carried over with ``params_from_reference`` (torch
cannot replay ``jax.random``), and the same numpy inputs for both."""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import transformer as ref_tf

from repro_torch.configs import get_config, reduced_config
from repro_torch.convert import params_from_reference
from repro_torch.core.exec import HostFetchEngine
from repro_torch.core.tiering import TieringConfig, place_params
from repro_torch.models import transformer as tf

B, S = 2, 32
FRACTIONS = [1.0, 0.5, 0.0]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """A module's torch work on one CPU thread, the count restored after
    it (autouse where a test module imports it): the port's tests hold
    small tensors, and under several test workers torch's per-process
    thread pools oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


@dataclasses.dataclass
class Pair:
    """One reduced architecture in both packages, on the same inputs."""

    ref_cfg: Any
    cfg: Any
    ref_params: Any
    params: dict
    tokens: np.ndarray
    ref_batch: dict
    batch: dict
    ref_logits: np.ndarray

    def ref_decode(self, tokens: np.ndarray, cache=None):
        """The reference's (jitted) decode over ``tokens`` (B, T), one
        step a column: ([logits (B,1,V)], cache)."""
        step = jax.jit(lambda p, c, t: ref_tf.decode_step(p, c, t,
                                                          self.ref_cfg))
        cache = cache or ref_tf.init_decode_cache(self.ref_cfg, B, S)
        out = []
        for t in range(tokens.shape[1]):
            lg, cache = step(self.ref_params, cache,
                             jnp.asarray(tokens[:, t:t + 1]))
            out.append(as_np(lg))
        return out, cache


def make_pair(arch: str, dtype: str = "float32", seed: int = 0) -> Pair:
    jdt, tdt = DTYPES[dtype]
    ref_cfg = ref_reduced_config(ref_get_config(arch), dtype=jdt)
    cfg = reduced_config(get_config(arch), dtype=tdt)
    ref_params = ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    ref_batch = {"tokens": jnp.asarray(tokens)}
    batch = {"tokens": torch.from_numpy(tokens)}
    if cfg.family == "vlm":
        patches = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        ref_batch["patches"] = jnp.asarray(patches).astype(jdt)
        batch["patches"] = torch.from_numpy(patches).to(tdt)
    ref_logits = as_np(ref_tf.forward(ref_params, ref_batch, ref_cfg)[0])
    return Pair(ref_cfg, cfg, ref_params,
                params_from_reference(ref_params, device="cpu"), tokens,
                ref_batch, batch, ref_logits)


def scale_of(logits: np.ndarray, V: int) -> float:
    """The reference's decode-test scale rule: max(1, max|logits|)."""
    return max(1.0, float(np.abs(logits[..., :V]).max()))


def check_forward_f32(pair: Pair) -> None:
    """Forward logits within 1e-4 x max(1, max|logits|), the padded
    vocabulary equal, greedy tokens equal."""
    logits, aux = tf.forward(pair.params, pair.batch, pair.cfg)
    got, want = as_np(logits), pair.ref_logits
    V = pair.cfg.vocab_size
    assert logits.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[..., V:], want[..., V:])  # NEG_INF pad
    assert np.abs(got[..., :V] - want[..., :V]).max() <= 1e-4 * scale_of(
        want, V)
    np.testing.assert_array_equal(got[..., :V].argmax(-1),
                                  want[..., :V].argmax(-1))
    assert float(aux) == 0.0


def check_decode_steps(pair: Pair, keys: tuple[str, ...]) -> None:
    """Every decode step's logits within 1e-4 x the forward's scale, and
    the cache entries ``keys`` and ``pos`` equal to the reference's."""
    want, ref_cache = pair.ref_decode(pair.tokens)
    cache = tf.init_decode_cache(pair.cfg, B, S, device="cpu")
    scale = scale_of(pair.ref_logits, pair.cfg.vocab_size)
    for t in range(S):
        got, cache = tf.decode_step(pair.params, cache, torch.from_numpy(
            pair.tokens[:, t:t + 1]), pair.cfg)
        assert np.abs(as_np(got) - want[t]).max() <= 1e-4 * scale, t
    for k in keys:
        assert tuple(cache[k].shape) == ref_cache[k].shape, k
        np.testing.assert_allclose(as_np(cache[k]), as_np(ref_cache[k]),
                                   atol=1e-4, rtol=1e-4, err_msg=k)
    assert int(cache["pos"]) == int(ref_cache["pos"]) == S


def check_decode_matches_forward(pair: Pair) -> None:
    """Token-by-token decode reproduces the teacher-forced logits,
    max|diff| < 1e-3 x max(1, scale) (the reference's contract; a vlm
    forward runs without its patch prefix, as decode has none)."""
    batch = dict(pair.batch)
    if pair.cfg.family == "vlm":
        batch["patches"] = batch["patches"][:, :0]
    full, _ = tf.forward(pair.params, batch, pair.cfg)
    cache = tf.init_decode_cache(pair.cfg, B, S, device="cpu")
    tok = batch["tokens"]
    errs = []
    for t in range(S):
        lg, cache = tf.decode_step(pair.params, cache, tok[:, t:t + 1],
                                   pair.cfg)
        errs.append(float((lg[:, 0] - full[:, t]).abs().max()))
    scale = float(full[..., :pair.cfg.vocab_size].abs().max())
    assert max(errs) < 1e-3 * max(scale, 1.0)


def check_lane_decode(pair: Pair, starts=(0, 5), steps: int = 8) -> None:
    """Per-lane decode (a ``(B,)`` position vector, lane b starting at
    ``starts[b]``) is bit-identical, lane by lane, to the scalar-position
    decode of that lane's tokens at the same batch shape."""
    cfg = pair.cfg
    tok = torch.from_numpy(pair.tokens)
    cache = tf.init_decode_cache(cfg, B, S, device="cpu")
    cache["pos"] = torch.tensor(starts, dtype=torch.int32)
    lanes = []
    for t in range(steps):
        lg, cache = tf.decode_step(pair.params, cache, tok[:, t:t + 1], cfg)
        lanes.append(lg)
    assert cache["pos"].tolist() == [s + steps for s in starts]
    for b, start in enumerate(starts):
        one = tf.init_decode_cache(cfg, B, S, device="cpu")
        one["pos"] = torch.tensor(start, dtype=torch.int32)
        for t in range(steps):
            lg, one = tf.decode_step(pair.params, one,
                                     tok[b:b + 1, t:t + 1].expand(B, 1), cfg)
            assert torch.equal(lanes[t][b], lg[b]), (b, t)


def check_offload_forward(pair: Pair, fraction: float, prefetch: bool):
    """Logits ``torch.equal`` to the untiered run's; returns the plan."""
    oracle, _ = tf.forward(pair.params, pair.batch, pair.cfg)
    placed, plan = place_params(
        pair.params, TieringConfig(mode="host_offload",
                                   local_fraction=fraction), device="cpu")
    assert (len(plan.remote_names()) > 0) == (fraction < 1.0)
    logits, _ = tf.forward(placed, pair.batch, pair.cfg, prefetch=prefetch,
                           plan=plan)
    assert torch.equal(logits, oracle)
    return plan


def check_offload_decode(pair: Pair, prefetch: bool,
                         keys: tuple[str, ...]) -> None:
    placed, plan = place_params(
        pair.params, TieringConfig(mode="host_offload", local_fraction=0.0),
        device="cpu")
    c0 = tf.init_decode_cache(pair.cfg, B, S, device="cpu")
    c1 = tf.init_decode_cache(pair.cfg, B, S, device="cpu")
    for t in range(8):
        tok = torch.from_numpy(pair.tokens[:, t:t + 1])
        want, c0 = tf.decode_step(pair.params, c0, tok, pair.cfg)
        got, c1 = tf.decode_step(placed, c1, tok, pair.cfg,
                                 prefetch=prefetch, plan=plan)
        assert torch.equal(got, want)
    for k in keys:
        assert torch.equal(c0[k], c1[k]), k


def check_init_shapes(arch: str) -> dict:
    """init_params builds the reference's tree: the same leaves, shapes
    and dtypes. Returns the port's params."""
    ref_cfg = ref_reduced_config(ref_get_config(arch))
    cfg = reduced_config(get_config(arch))
    want = ref_tf.init_params(jax.random.PRNGKey(0), ref_cfg)
    got = tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    flat_w = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_leaves_with_path(want)}
    flat_g = {}

    def walk(t, key=""):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{key}[{k!r}]")
        else:
            flat_g[key] = t

    walk(got)
    assert flat_g.keys() == flat_w.keys()
    for k, v in flat_w.items():
        assert tuple(flat_g[k].shape) == v.shape, k
        assert str(flat_g[k].dtype) == "torch." + str(v.dtype), k
    return got


class FetchRecorder(HostFetchEngine):
    """A CPU fetch engine that logs the name of every read it posts."""

    log: list[str] = []

    def __init__(self, throttle: float = 0.0, device="cpu"):
        super().__init__(throttle=throttle, device=device)

    def fetch(self, name, payloads, *, pace=True):
        FetchRecorder.log.append(name)
        return super().fetch(name, payloads, pace=pace)


@pytest.fixture
def fetch_log(monkeypatch):
    """The names of the reads the model posts, in order."""
    FetchRecorder.log = []
    monkeypatch.setattr(tf, "HostFetchEngine", FetchRecorder)
    return FetchRecorder.log

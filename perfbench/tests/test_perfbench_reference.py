"""The plain references against themselves at a test's size: the
recomputed layers against the same layers kept, a second training run
against the first, and the float8 control apart from float32."""
import math

import torch

from conftest import tiny
from perfbench import weights
from perfbench.reference import common, dense
from perfbench.traffic import TokenStream


def _setup(name):
    cell = tiny(name)
    ref = {"dense": dense}[cell.model["family"]]
    specs = ref.param_specs(cell.model)
    tree = weights.draw(specs, 5, "cpu")
    units = {n: (weights.leaf(tree, s) if i is None
                 else weights.leaf(tree, s)[i])
             for s in specs for n, i in weights.units(s)}
    stream = TokenStream(cell.traffic, cell.model["vocab_size"], 5, "cpu")
    return cell, ref, units, stream


def test_recompute_changes_nothing():
    cell, ref, units, stream = _setup("granite-8b-12l.train-offload20")
    batch = stream.batch(1)
    P = {k: t.float().requires_grad_(True) for k, t in units.items()}
    loss = ref.loss(P, batch, cell.model, "f32")
    g1 = torch.autograd.grad(loss, list(P.values()))
    saved = dense.checkpointed
    try:
        dense.checkpointed = lambda fn, x, w: fn(x, w)
        loss2 = ref.loss(P, batch, cell.model, "f32")
        g2 = torch.autograd.grad(loss2, list(P.values()))
    finally:
        dense.checkpointed = saved
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


def test_training_repeats_and_fp8_differs():
    cell, ref, units, stream = _setup("granite-8b-12l.train-local")
    batches = [stream.batch(i) for i in (1, 2, 3)]
    opt = cell.traffic["optimizer"]
    a = common.train(ref.loss, units, batches, cell.model, opt)
    b = common.train(ref.loss, units, batches, cell.model, opt)
    c = common.train(ref.loss, units, batches, cell.model, opt, "fp8")
    assert a["losses"] == b["losses"]
    assert a["first_grad"] == b["first_grad"]
    assert all(torch.equal(a["units"][k], b["units"][k]) for k in units)
    gap = max(abs(x - y) / y for x, y in zip(c["losses"], a["losses"]))
    assert 1e-5 < gap < 0.1
    # the clipped first gradient's norms square-sum to 1
    assert math.isclose(math.sqrt(sum(v * v for v in a["first_grad"]
                                      .values())), 1.0, rel_tol=1e-6)


def test_lr_schedule():
    opt = {"lr": 1.0, "warmup_steps": 10, "decay_steps": 110,
           "min_lr_ratio": 0.1}
    assert common.lr_at(opt, 5) == 0.5
    assert common.lr_at(opt, 10) == 1.0
    assert math.isclose(common.lr_at(opt, 60), 0.55)
    assert math.isclose(common.lr_at(opt, 500), 0.1)

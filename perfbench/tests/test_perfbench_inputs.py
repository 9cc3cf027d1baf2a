"""Inputs are made from the seed alone: the same seed gives the same
weights and batches, another seed others, and a leaf drawn again alone is
the leaf drawn in the tree."""
import torch

from conftest import tiny
from perfbench import seeds, weights
from perfbench.reference import dense
from perfbench.traffic import TokenStream

BIG = 2 ** 40 + 3  # seeds past 32 bits


def test_derive_takes_any_whole_number():
    for s in (0, 1, -5, 2 ** 31 + 1, 2 ** 70):
        assert 0 <= seeds.derive(s, "x") < 2 ** 63
    assert seeds.derive(BIG, "a") != seeds.derive(BIG, "b")


def test_batches_repeat_by_seed_and_step():
    t = tiny("granite-8b-12l.train-local").traffic
    a, b = TokenStream(t, 256, BIG, "cpu"), TokenStream(t, 256, BIG, "cpu")
    assert torch.equal(a.batch(3)["tokens"], b.batch(3)["tokens"])
    assert not torch.equal(a.batch(3)["tokens"], a.batch(4)["tokens"])
    c = TokenStream(t, 256, BIG + 1, "cpu")
    assert not torch.equal(a.batch(3)["tokens"], c.batch(3)["tokens"])
    x = a.batch(1)
    assert x["tokens"].dtype == torch.int32 and x["labels"] is x["tokens"]
    assert x["tokens"].shape == (t["batch"], t["seq"])
    assert 0 <= int(x["tokens"].min()) and int(x["tokens"].max()) < 256


def test_zipf_ranks_are_skewed():
    t = {"batch": 8, "seq": 512, "tokens": {"dist": "zipf", "exponent": 1.1}}
    counts = torch.bincount(TokenStream(t, 1000, 3, "cpu").batch(1)[
        "tokens"].long().flatten(), minlength=1000).sort(descending=True)[0]
    assert counts[0] > 20 * counts[100]


def test_leaves_redraw_alone():
    cell = tiny("granite-8b-12l.train-local")
    specs = dense.param_specs(cell.model)
    tree = weights.draw(specs, BIG, "cpu")
    for s in specs:
        got = weights.draw_leaf(s, BIG, "cpu")
        assert torch.equal(got, weights.leaf(tree, s))
        assert got.dtype == s.dtype and tuple(got.shape) == s.shape

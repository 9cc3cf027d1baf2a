"""On the card (marked ``cuda``; skips elsewhere): a short run of each
cell through the port's kernels at a reduced size comes out correct, and
with a fault planted under the timed path, not correct; the float8
control, put in the program's place, is not correct. The cells' own size
is ``perfbench/control.py``'s."""
import pytest

from conftest import tiny
from perfbench import check, faults, run, spec
from perfbench.traffic import TokenStream

#: A size whose attention the kernels take (heads of 64).
CARD = {"dense": dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
                      head_dim=64, d_ff=512)}
CELLS = ["granite-8b-12l.train-offload20", "granite-8b-12l.train-local"]


def _cell(name):
    cell = tiny(name, seq=256)
    cell.model = {**cell.model, **CARD[cell.model["family"]]}
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_sound_and_faulty_runs_on_the_card(card, name):
    assert run.run_cell(_cell(name), 3, 0.5, False, card)["correct"]
    for fault in faults.FAULTS.values():
        assert not run.run_cell(_cell(name), 3, 0.2, False, card,
                                fault=fault)["correct"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(card, name):
    cell = _cell(name)
    ref = spec.reference(cell.model["family"])
    specs = ref.param_specs(cell.model)
    stream = TokenStream(cell.traffic, cell.model["vocab_size"], 4, card)
    want = run.reference_readings(cell, ref, specs, stream, 4, card)
    got = run.reference_readings(cell, ref, specs, stream, 4, card, "fp8")
    assert not check.judge(check.gaps(got, want), cell.limits)[0]

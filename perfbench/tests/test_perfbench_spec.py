"""Every configuration, traffic mix, limit file and metric of
BENCHMARK.json loads, and one added as new files is found by its name."""
import json
import shutil

import pytest

from perfbench import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads(name):
    cell = spec.load_cell(name)
    assert cell.chips == 1
    assert cell.model["name"] == cell.config_name
    assert set(cell.limits) == {"loss_gap", "grad_gap", "update_gap"}
    kind = "offload" if "offload" in name else "local"
    assert [m["name"] for m in cell.end_to_end] == [
        f"train_tokens_per_s.{kind}", "peak_hbm_gib", "setup_s"]
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] == f"train_tokens_per_s.{kind}"
        assert callable(spec.metric_reader(m["name"]))
    ref = spec.reference(cell.model["family"])
    assert ref.param_specs(cell.model)


@pytest.mark.parametrize("conf", BENCH["configs"])
def test_config_file_states_its_cut(conf):
    model = json.loads((spec.ROOT / conf["file"]).read_text())
    assert model["source"] == conf["source"]
    assert sorted(model["reduced"]) == sorted(conf["reduced"])
    for key, (published, run) in model["reduced"].items():
        assert model["published"][key] == published and model[key] == run
    for key, value in model["published"].items():
        if key not in model["reduced"]:
            assert model[key] == value


def test_offload_cells_move_their_layer_weights():
    """The offload cells' traffic keeps a fifth of the state local."""
    for name in CELLS:
        t = spec.load_cell(name).traffic["tiering"]
        assert (t["mode"], t["local_fraction"]) == (
            ("host_offload", 0.2) if "offload20" in name else ("none", 1.0))


def test_an_added_cell_and_metric_are_found_by_name(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = root / "perfbench"
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({**bench["configs"][0], "name": "granite-8b-2l",
                             "file": "perfbench/configs/granite-8b-2l.json"})
    model = json.loads((here / "configs/granite-8b-12l.json").read_text())
    model.update(name="granite-8b-2l", n_layers=2)
    (here / "configs/granite-8b-2l.json").write_text(json.dumps(model))
    traffic = json.loads((here / "traffic/train-2x2048-local.json")
                         .read_text())
    traffic["seq"] = 4096
    (here / "traffic/train-1x4096-local.json").write_text(json.dumps(traffic))
    (here / "limits/granite-8b-2l.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1, "grad_gap": 2, "update_gap": 3}}))
    (here / "metrics/steps_seen.py").write_text(
        "def read(tl, cell):\n    return float(tl.steps)\n")
    bench["workloads"].append({"name": "granite-8b-2l.long",
                               "config": "granite-8b-2l",
                               "traffic": "train-1x4096-local", "chips": 1,
                               "why": "an added cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "train_tokens_per_s.local":
            m["workloads"].append("granite-8b-2l.long")
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "device (one H100)",
                               "moves": "train_tokens_per_s.local"})
    monkeypatch.setattr(spec, "HERE", here)
    monkeypatch.setattr(spec, "ROOT", root)
    cell = spec.load_cell("granite-8b-2l.long", bench)
    assert cell.model["n_layers"] == 2 and cell.traffic["seq"] == 4096
    assert cell.limits["update_gap"] == 3  # the configuration's limits
    (here / "limits/granite-8b-2l.long.json").write_text(json.dumps(
        {"limits": {"loss_gap": 1, "grad_gap": 2, "update_gap": 4}}))
    assert spec.load_cell("granite-8b-2l.long", bench).limits[
        "update_gap"] == 4  # the cell's own, where it has them
    names = [m["name"] for m in cell.per_layer]
    # no "workloads" key: every cell that reports what it moves
    assert "steps_seen" in names and "copy_exposed_share" not in names

    class TL:
        steps = 7
    assert spec.metric_reader("steps_seen")(TL, cell) == 7.0


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")

"""What a cell is made of, found by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration, whose file holds
its sizes (``configs/<name>.json``), and a traffic mix
(``traffic/<name>.json``). Its correctness limits are its configuration's
(``limits/<config>.json``), or its own where a ``limits/<cell>.json``
is there; each per-layer metric is a reader of its own
(``metrics/<name>.py``, a function ``read(timeline, cell)``), and each
model family a plain reference (``reference/<family>.py``). Adding any of
them adds files and entries; no file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    model: dict            # the configuration file
    traffic_name: str
    traffic: dict          # the traffic file
    limits: dict           # number -> its limit
    end_to_end: list       # the cell's end-to-end metric entries
    per_layer: list        # the cell's per-layer metric entries

    @property
    def tokens_per_step(self) -> int:
        return self.traffic["batch"] * self.traffic["seq"]


def _reports(metric: dict, cell: str, end_to_end: list[str]) -> bool:
    """Whether ``cell`` reports per-layer ``metric``: the cells it lists,
    or else every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in end_to_end


def _limits_file(cell: str, config: str) -> Path:
    """``limits/<cell>.json`` where a cell has limits of its own, else its
    configuration's ``limits/<config>.json``."""
    own = HERE / "limits" / f"{cell}.json"
    return own if own.exists() else HERE / "limits" / f"{config}.json"


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``)."""
    bench = bench if bench is not None else _json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; choose "
                       f"from {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    e2e_names = [m["name"] for m in e2e]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"],
        model=_json(ROOT / conf["file"]), traffic_name=w["traffic"],
        traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_json(_limits_file(name, w["config"]))["limits"],
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"]
                   if _reports(m, name, e2e_names)])


def _from_file(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def base(name: str) -> str:
    """What metric ``name`` measures: its part before the first dot. The
    part after says which cells report it (``train_tokens_per_s.offload``
    and ``train_tokens_per_s.local`` are one quantity under two bounds)."""
    return name.split(".")[0]


def metric_reader(name: str):
    """The ``read(timeline, cell)`` of per-layer metric ``name``:
    ``metrics/<base>.py``."""
    b = base(name)
    return _from_file(HERE / "metrics" / f"{b}.py",
                      "perfbench_metric_" + b.replace("-", "_")).read


def reference(family: str):
    """The plain reference module of model family ``family``."""
    return importlib.import_module(f"perfbench.reference.{family}")

"""Nothing the benchmark runs on the card loads JAX or the JAX package,
and the references import nothing of the program."""
import ast
import json
import subprocess
import sys

from conftest import ROOT

HERE = ROOT / "perfbench"


def test_run_loads_neither_jax_nor_repro():
    code = (
        "import json, sys\n"
        "sys.path[:0] = ['.', 'src']\n"
        "from perfbench import run, control, check, spec, trace, traffic\n"
        "from perfbench import weights, faults, program\n"
        "from perfbench.reference import common, dense\n"
        "from perfbench.counts import calls, categories, mfu, peaks, work\n"
        "for m in json.load(open('BENCHMARK.json'))['per_layer']:\n"
        "    spec.metric_reader(m['name'])\n"
        "cell = spec.load_cell('granite-8b-12l.train-offload20')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert "repro_torch" in top and "perfbench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_references_import_nothing_of_the_program():
    for path in sorted((HERE / "reference").glob("*.py")):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in {"repro_torch", "repro", "jax"}, (path, name)
            assert name != "perfbench.program", path


def test_only_the_adapter_imports_the_program():
    for path in sorted(HERE.rglob("*.py")):
        if path.name == "program.py" or "tests" in path.parts:
            continue
        for name in _imports(path):
            assert name.split(".")[0] != "repro_torch", (path, name)
            assert name.split(".")[0] not in {"jax", "jaxlib", "flax",
                                              "repro"}, (path, name)

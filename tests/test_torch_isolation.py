"""The port stands alone: importing it loads neither JAX nor ``repro``."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "kernel_ab.py", ROOT / "profile_models.py",
    ROOT / "tests" / "_torch_hpc_parity.py",
    ROOT / "tests" / "_torch_serving_parity.py",
    ROOT / "tests" / "_torch_paging_parity.py"]


def test_import_loads_no_jax_and_no_reference():
    code = (
        "import json, sys\n"
        "import repro_torch, repro_torch.core, repro_torch.core.exec\n"
        "import repro_torch.kernels.ops, repro_torch.convert\n"
        "import repro_torch.configs.granite_8b, repro_torch.configs.mamba2_130m\n"
        "import repro_torch.models, repro_torch.models.transformer\n"
        "import repro_torch.core.tiering, repro_torch.kernels.ssd_scan\n"
        "import repro_torch.models.flash, repro_torch.models.layers\n"
        "import repro_torch.hpc, repro_torch.core.pool, repro_torch.core.sizing\n"
        "import repro_torch.core.dual_buffer, repro_torch.core.scheduler\n"
        "from repro_torch.configs import ARCH_IDS, get_config\n"
        "configs = [get_config(a) for a in ARCH_IDS]\n"
        "sys.path.insert(0, 'tests')\n"
        "import _torch_hpc_parity as H\n"
        "H.run_mode(H.package('repro_torch'), 'CG', 'auto', n_iters=1)\n"
        "import repro_torch.serving, repro_torch.launch.serve\n"
        "import _torch_serving_parity as S\n"
        "S.restart_resource_names(S.package('repro_torch'))\n"
        "import repro_torch.models.moe, repro_torch.models.mla\n"
        "import repro_torch.serving.expert_paging\n"
        "import repro_torch.configs.deepseek_v3_671b\n"
        "import _torch_paging_parity as PG\n"
        "PG.n_hot(32)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    return names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_reaches_every_port_package():
    """The AST scan covers each package of the port (models/ included)."""
    packages = {p.parent for p in (ROOT / "src" / "repro_torch").rglob(
        "__init__.py")}
    assert {p.parent for p in PORT_FILES} >= packages
    assert ROOT / "src" / "repro_torch" / "models" in packages
    assert ROOT / "src" / "repro_torch" / "hpc" in packages
    assert ROOT / "src" / "repro_torch" / "serving" in packages
    assert ROOT / "src" / "repro_torch" / "launch" in packages

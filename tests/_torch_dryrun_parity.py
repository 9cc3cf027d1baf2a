"""The reference's placement decisions, for ``test_torch_dryrun.py`` (not a
test module).

``python tests/_torch_dryrun_parity.py`` (with ``src`` on the path and
``JAX_PLATFORMS=cpu``) prints one JSON object: for every arch of
``ARCH_IDS``, each of its runnable cells, both production meshes and both
values of the host-offload probe, the reference's ``decide_tiering`` dict,
keyed ``"arch|cell|mesh|probe"``, and the reference's ``HBM_BYTES``.
It runs in a process of its own because ``repro.launch.dryrun`` sets
``XLA_FLAGS`` when it is imported. The meshes are abstract
(``repro.models.sharding.abstract_mesh``) and the parameters
``jax.eval_shape``'s.
"""
from __future__ import annotations

import functools
import json

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def main() -> None:
    import jax

    from repro.configs import ARCH_IDS, SHAPE_CELLS, get_config, runnable_cells
    from repro.launch import dryrun
    from repro.models import get_model
    from repro.models.sharding import abstract_mesh

    out = {"HBM_BYTES": dryrun.HBM_BYTES, "decisions": {}}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params_abs = jax.eval_shape(
            functools.partial(get_model(cfg).init_params, cfg=cfg),
            jax.random.key(0))
        for cell in runnable_cells(cfg):
            for mesh_name, (sizes, names) in MESHES.items():
                mesh = abstract_mesh(sizes, names)
                for probe in (False, True):
                    dryrun.supports_host_offload_spmd = (
                        lambda _m, _p=probe: _p)
                    out["decisions"][f"{arch}|{cell}|{mesh_name}|{probe}"] = (
                        dryrun.decide_tiering(cfg, SHAPE_CELLS[cell], mesh,
                                              params_abs))
    print(json.dumps(out))


if __name__ == "__main__":
    main()

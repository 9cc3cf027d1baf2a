"""The benchmark of the PyTorch and CUDA port (``repro_torch``): train steps
timed on one card, checked against a plain PyTorch reference.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Nothing here imports
JAX or the JAX package ``repro``.
"""

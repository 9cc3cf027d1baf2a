"""DOLMA on PyTorch and CUDA: the port of the JAX package ``repro``.

The port's entry points run on an NVIDIA card (``device="cuda"``, the
default) unless the caller asks for the CPU. Importing this package loads
neither JAX nor the reference package, and builds no kernel.
"""

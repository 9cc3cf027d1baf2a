"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

``csrc/`` holds the CUDA sources; :mod:`repro_torch.kernels._build` compiles
them with nvcc at first use. Importing this package builds nothing.
"""

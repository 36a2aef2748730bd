"""aniso_torch: the PyTorch/CUDA port of aniso_tpu for NVIDIA Hopper GPUs.

Imports torch and numpy only, never JAX or aniso_tpu.  Entry point:
aniso_torch.solver.operator.TransportSolver (FMM backend, one Fourier
mode).  The CUDA kernels K1 (kernels.m2l) and K2 (kernels.near) are built
from aniso_torch/csrc at first use (_build.py).
"""

"""aniso_torch: the PyTorch/CUDA port of aniso_tpu for NVIDIA Hopper GPUs.

Imports torch and numpy only, never JAX or aniso_tpu.  Entry points:
aniso_torch.solver.operator.TransportSolver (backend "dense", the default
as in aniso_tpu, or "fmm"; N coupled Fourier modes; refine=True and the
DSA preconditioner) and the CLI, `python -m aniso_torch run data.cfg`.  The
CUDA kernels (K1 kernels.m2l, K2 kernels.near, K3 kernels.offsets, K9d
kernels.diffusion, K7 kernels.attenuation) are built from aniso_torch/csrc
at first use (_build.py).
"""

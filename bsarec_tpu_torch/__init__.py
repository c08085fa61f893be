"""bsarec_tpu_torch — the PyTorch/CUDA port of `bsarec_tpu`.

It mirrors the JAX package's module names (`config`, `data`, `ops`,
`models`, `train`, `utils`, `main`) so each module's counterpart is
easy to find. Plain tensor code is PyTorch; each Pallas kernel of the
JAX package becomes a CUDA C++ kernel for Hopper (`csrc/`), built with
nvcc at first use and held against a plain PyTorch version that sits
beside it.

Host-side data preparation runs `native/seqrec.cpp`, which the package
builds with g++ and loads through ctypes (`native.py`), with numpy paths
beside it. The package imports torch, numpy and the standard library
only — never jax, flax, optax or `bsarec_tpu`.
"""

from bsarec_tpu_torch.config import ModelConfig, TrainConfig, resolve_device

__all__ = ["ModelConfig", "TrainConfig", "resolve_device"]

"""The bf16 compute policy's numerics (`--dtype bf16`; the JAX package's
`compute_dtype`, `bsarec_tpu/config.py:28-32`).

Under "bfloat16" the dense and attention matmuls take bf16 operands;
parameters, LayerNorm, softmax, the residual adds and every loss
accumulation stay float32. Two forms of a bf16 product appear in the JAX
package, and both are written here as float32 matmuls of bf16-rounded
operands (with TF32 off, `config.set_fp32_matmul`), whose products are
exact in float32, so the result is the fp32 sum of exact products on any
device:

- `matmul`: `einsum(a.astype(bf16), b.astype(bf16),
  preferred_element_type=f32)`, a float32 result;
- `dense`: Flax's `nn.Dense(dtype=bf16)`: the product rounded once to a
  bf16 output, then the bf16 bias added (a second rounding). A fused
  `F.linear(x, W, b)` rounds once, and torch's own bf16 matmul on the CPU
  sums in another way than XLA's, so neither is used.

Gradients follow from autograd: each cast back to bf16 rounds the
gradient that crosses it, as the JAX package's converts do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

DTYPES = ("float32", "bfloat16")


def is_bf16(dtype: str | None) -> bool:
    """True for "bfloat16", False for "float32" or None (as given); any
    other name raises."""
    if dtype in (None, "float32"):
        return False
    if dtype == "bfloat16":
        return True
    raise NotImplementedError(f"compute dtype {dtype!r} is not ported; use one of {DTYPES}")


def rounded(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """x rounded to bf16 (ties to even) and held in float32 when `bf16`,
    else x itself."""
    return x.to(torch.bfloat16).float() if bf16 else x


def matmul(a: torch.Tensor, b: torch.Tensor, bf16: bool) -> torch.Tensor:
    """a @ b, of bf16-rounded operands with a float32 result when `bf16`."""
    return rounded(a, bf16) @ rounded(b, bf16)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, bf16: bool) -> torch.Tensor:
    """`F.linear(x, weight, bias)`, or with `bf16` Flax's bf16 Dense: the
    product of rounded operands rounded to bf16, plus the bf16 bias, a
    bf16 result."""
    if not bf16:
        return F.linear(x, weight, bias)
    return matmul(x, weight.T, True).to(torch.bfloat16) + bias.to(torch.bfloat16)

"""Fused dropout with its random bits made in the kernel (counterpart of
`bsarec_tpu/ops/pallas_dropout.py`).

`fused_dropout(x, rate, seeds, call)` keeps element i of x where its
32-bit random word is >= min(floor(rate * 2^32), 2^32 - 1) and scales
kept values by 1 / (1 - rate) rounded to x's type; the rest become 0.
Element i's word is word i mod 4 of Philox4x32-10 at counter
(q mod 2^32, q >> 32, call, 0), q = i // 4, keyed by the low 32 bits of
the two int64 words of `seeds`. It depends on (seeds, call, i) only, so:

- the backward regenerates the forward's mask from the saved seeds and
  call index (the JAX custom VJP, `pallas_dropout.py:115-122`): nothing
  of the mask is stored;
- the plain version below gives the kernel's bits exactly, whatever the
  launch shape or the tensor's alignment.

The CUDA kernel is `csrc/fused_dropout.cu`. On a CPU tensor the wrapper
runs the plain version; on a CUDA tensor it launches the kernel or
raises. fp32 and bf16 are taken, as `pallas_dropout.supported` admits
both; any element count >= 1, with no shape gating.

The TPU's hardware generator has no counterpart off the TPU (Pallas's
CPU interpreter gives all-zero bits), so the CPU tests hold the apply
half, `dropout_from_bits`, against the JAX package's threshold path on
the same bits, and the generator against Philox's published
known-answer vectors.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def threshold(rate: float) -> int:
    """The drop threshold on a 32-bit word (`pallas_dropout.py:89`)."""
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


@functools.cache
def inv_keep(rate: float, dtype: torch.dtype) -> float:
    """1 / (1 - rate) rounded to `dtype`, as a Python float (exact in fp32)."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=dtype).float())


# ---- plain PyTorch version -------------------------------------------------


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit halves of the 64-bit product of the constant
    a < 2^32 and the int64 tensor b of values in [0, 2^32), from 16-bit
    halves so that no int64 product overflows."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    b_hi, b_lo = b >> 16, b & 0xFFFF
    mid = a_hi * b_lo + a_lo * b_hi  # < 2^33
    low = a_lo * b_lo + ((mid & 0xFFFF) << 16)  # < 2^33
    high = a_hi * b_hi + (mid >> 16) + (low >> 32)
    return high & _U32, low & _U32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11; Random123's definition).
    `counter`: four int64 tensors (broadcastable) of values in [0, 2^32);
    `key`: two such tensors or ints. Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + PHILOX_W0) & _U32, (k1 + PHILOX_W1) & _U32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(n: int, seeds: torch.Tensor, call: int) -> torch.Tensor:
    """The kernel's random words of elements 0..n-1: int64 [n] in [0, 2^32)."""
    q = torch.arange((n + 3) // 4, dtype=torch.int64, device=seeds.device)
    key = seeds.to(torch.int64) & _U32
    words = philox4x32_10((q & _U32, q >> 32, torch.full_like(q, call), torch.zeros_like(q)),
                          (key[0], key[1]))
    return torch.stack(words, dim=1).reshape(-1)[:n]


def dropout_from_bits(x: torch.Tensor, bits: torch.Tensor, rate: float) -> torch.Tensor:
    """The apply half: x * inv_keep where bits >= threshold(rate), else 0.
    `bits` holds one word in [0, 2^32) per element of x, in x's flat order."""
    keep = (bits.to(torch.int64) >= threshold(rate)).reshape(x.shape)
    scale = torch.tensor(inv_keep(rate, x.dtype), dtype=x.dtype, device=x.device)
    return torch.where(keep, x * scale, torch.zeros((), dtype=x.dtype, device=x.device))


def fused_dropout_plain(x: torch.Tensor, seeds: torch.Tensor, rate: float, call: int) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device."""
    return dropout_from_bits(x, philox_bits(x.numel(), seeds, call), rate)


# ---- CUDA kernel -----------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at first use) with its C signatures."""
    from bsarec_tpu_torch.ops import _build

    lib = _build.load("fused_dropout")
    p = ctypes.c_void_p
    lib.fused_dropout.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int, p, ctypes.c_uint,
                                  ctypes.c_uint, ctypes.c_float, p]
    lib.fused_dropout.restype = ctypes.c_int
    lib.fused_dropout_error.argtypes = [ctypes.c_int]
    lib.fused_dropout_error.restype = ctypes.c_char_p
    return lib


def _launch(x: torch.Tensor, seeds: torch.Tensor, rate: float, call: int) -> torch.Tensor:
    dev = x.device
    if not x.is_contiguous():
        raise ValueError("the dropout kernel takes a contiguous tensor")
    if seeds.device != dev or seeds.dtype != torch.int64 or seeds.shape != (2,) \
            or not seeds.is_contiguous():
        raise ValueError(f"seeds must be a contiguous int64 [2] tensor on {dev}")
    lib = _lib()
    y = torch.empty_like(x, memory_format=torch.contiguous_format)
    args = (x.data_ptr(), y.data_ptr(), x.numel(), _DTYPE_CODES[x.dtype], seeds.data_ptr(), call,
            threshold(rate), inv_keep(rate, x.dtype), torch.cuda.current_stream(dev).cuda_stream)
    if dev.index == torch.cuda.current_device():  # the common case skips the device switch
        rc = lib.fused_dropout(*args)
    else:
        with torch.cuda.device(dev):
            rc = lib.fused_dropout(*args)
    if rc != 0:
        raise RuntimeError(f"fused_dropout launch failed ({rc}: "
                           f"{lib.fused_dropout_error(rc).decode()}); n={x.numel()} {x.dtype}")
    fused_dropout.launches += 1
    return y


def dropout_apply(x: torch.Tensor, seeds: torch.Tensor, rate: float, call: int) -> torch.Tensor:
    """One dropout pass over a contiguous x with 0 <= rate < 1: the plain
    version for a CPU tensor, the kernel for a CUDA tensor."""
    if x.dtype not in _DTYPE_CODES:
        raise NotImplementedError(f"fused dropout takes float32 and bfloat16, not {x.dtype}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), got {rate}")
    if not 0 <= call < (1 << 32):
        raise ValueError(f"call index {call} outside [0, 2^32)")
    if x.numel() == 0:
        return torch.empty_like(x)
    if x.device.type == "cpu":
        return fused_dropout_plain(x, seeds, rate, call)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, seeds, rate, call)


class _FusedDropout(torch.autograd.Function):
    """Saves only the seeds and the call index; the backward runs the same
    pass on the cotangent, so the mask is made again. `plain` selects the
    plain version on any device (the card's check of the wiring)."""

    @staticmethod
    def forward(ctx, x, seeds, rate, call, plain):
        ctx.save_for_backward(seeds)
        ctx.rate, ctx.call, ctx.plain = rate, call, plain
        fn = fused_dropout_plain if plain else dropout_apply
        return fn(x, seeds, rate, call)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        (seeds,) = ctx.saved_tensors
        fn = fused_dropout_plain if ctx.plain else dropout_apply
        return fn(grad.contiguous(), seeds, ctx.rate, ctx.call), None, None, None, None


def fused_dropout(x: torch.Tensor, rate: float, seeds: torch.Tensor, call: int,
                  plain: bool = False) -> torch.Tensor:
    """Training-mode dropout of x, differentiable in x. `seeds`: int64 [2]
    on x's device (the step's stream words); `call`: the site's index
    within the step. Rate 0 returns x and rate >= 1 zeros, with no launch
    (`core/dropout.py:151-152,214`)."""
    if rate == 0.0:
        return x
    if rate >= 1.0:  # zeros, with a zero gradient
        none = torch.zeros((), dtype=torch.bool, device=x.device)
        return torch.where(none, x, torch.zeros((), dtype=x.dtype, device=x.device))
    return _FusedDropout.apply(x.contiguous(), seeds, rate, call, plain)


fused_dropout.launches = 0  # kernel launches (CUDA path only)

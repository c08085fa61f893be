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

A training step runs 14 such passes in SASRec, so their host cost is
kept near `F.dropout`'s: what is fixed per site (the rate, its threshold
and scale per dtype: `DropoutSite`) or per step (the seeds:
`check_seeds` in `DropoutState.begin_step`) is checked once there, and
a call checks only x's dtype, contiguity and device and goes from the
autograd function to ctypes through `_launch` alone, which reads the raw
stream handle and switches devices only when needed (`ops/_launch.py`).

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

from bsarec_tpu_torch.ops._launch import call_on, raw_stream

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CALLS = 1 << 32  # the call index is one 32-bit word of Philox's counter


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


class DropoutSite:
    """One rate's kernel constants, checked and computed once: the drop
    threshold and, per dtype the kernel takes, its code and 1 / (1 - rate)
    rounded to that dtype. A model's dropout site builds one when it is
    built; the per-call entries take a cached one per rate (`_checked`)."""

    __slots__ = ("rate", "consts")

    def __init__(self, rate: float):
        if not 0.0 <= rate < 1.0:  # NaN fails too
            raise ValueError(f"a dropout pass takes a rate in [0, 1), got {rate}")
        self.rate = float(rate)
        t = threshold(self.rate)
        self.consts = {dt: (code, t, inv_keep(self.rate, dt)) for dt, code in _DTYPE_CODES.items()}


@functools.cache
def _site(rate: float) -> DropoutSite:
    return DropoutSite(rate)


def dropped(x: torch.Tensor) -> torch.Tensor:
    """Dropout at rate >= 1: zeros of x's shape, with a zero gradient, and
    no launch (`core/dropout.py:214`)."""
    none = torch.zeros((), dtype=torch.bool, device=x.device)
    return torch.where(none, x, torch.zeros((), dtype=x.dtype, device=x.device))


def check_seeds(seeds: torch.Tensor) -> None:
    """Raise unless `seeds` is a contiguous int64 [2] tensor on the CPU or
    a card: the check a step's seeds get once, in
    `DropoutState.begin_step`, and not at each call."""
    if (not isinstance(seeds, torch.Tensor) or seeds.dtype != torch.int64
            or seeds.shape != (2,) or not seeds.is_contiguous()
            or seeds.device.type not in ("cpu", "cuda")):
        raise ValueError("seeds must be a contiguous int64 [2] tensor on the CPU or a card")


def check_call(call: int) -> None:
    if not 0 <= call < MAX_CALLS:
        raise ValueError(f"call index {call} outside [0, 2^32)")


def _check_dtype(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise NotImplementedError(f"fused dropout takes float32 and bfloat16, not {x.dtype}")


def _checked(x: torch.Tensor, seeds: torch.Tensor, rate: float, call: int) -> DropoutSite:
    """The rate's site, once every argument of a per-call entry is checked."""
    _check_dtype(x)
    check_call(call)
    check_seeds(seeds)
    return _site(rate)


def _launch(x: torch.Tensor, seeds: torch.Tensor, site: DropoutSite, call: int) -> torch.Tensor:
    """One kernel pass over a contiguous CUDA tensor x of a dtype the site
    takes (its callers see to both). It checks only x's device against the
    seeds'; the rate, call index and seeds were checked where they were
    made."""
    index = x.get_device()
    if seeds.get_device() != index:
        raise ValueError(f"seeds on {seeds.device}, x on {x.device}")
    y = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return y
    code, thresh, scale = site.consts[x.dtype]
    rc = call_on(index, _lib().fused_dropout, x.data_ptr(), y.data_ptr(), n, code,
                 seeds.data_ptr(), call, thresh, scale, raw_stream(index))
    if rc != 0:
        raise RuntimeError(f"fused_dropout launch failed ({rc}: "
                           f"{_lib().fused_dropout_error(rc).decode()}); n={n} {x.dtype}")
    fused_dropout.launches += 1
    fused_dropout.bf16_launches += x.dtype == torch.bfloat16
    return y


def dropout_apply(x: torch.Tensor, seeds: torch.Tensor, rate: float, call: int) -> torch.Tensor:
    """One dropout pass over a contiguous x with 0 <= rate < 1: the plain
    version for a CPU tensor, the kernel for a CUDA tensor. Every argument
    is checked here; the pass is the one the autograd function runs."""
    site = _checked(x, seeds, rate, call)
    if x.device.type == "cpu":
        return fused_dropout_plain(x, seeds, rate, call)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("the dropout kernel takes a contiguous tensor")
    return _launch(x, seeds, site, call)


class FusedDropoutFn(torch.autograd.Function):
    """Dropout of x at a checked `DropoutSite`, differentiable in x. It keeps
    only the seeds, the site and the call index (the seeds as an
    attribute: a step's seed row is an input that no one writes), and the
    backward runs the same pass on the cotangent, so the mask is made
    again. The forward and backward reach the kernel through `_launch`
    alone. `plain` selects the plain version on any device (the card's
    check of the wiring); a tensor off the card always takes it."""

    @staticmethod
    def forward(ctx, x, seeds, site, call, plain):
        _check_dtype(x)
        plain = plain or not x.is_cuda
        ctx.args = (seeds, site, call, plain)
        if plain:
            return fused_dropout_plain(x, seeds, site.rate, call)
        return _launch(x if x.is_contiguous() else x.contiguous(), seeds, site, call)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        seeds, site, call, plain = ctx.args
        if not grad.is_contiguous():
            grad = grad.contiguous()
        if plain:
            dx = fused_dropout_plain(grad, seeds, site.rate, call)
        else:
            dx = _launch(grad, seeds, site, call)
        return dx, None, None, None, None


def fused_dropout(x: torch.Tensor, rate: float, seeds: torch.Tensor, call: int,
                  plain: bool = False) -> torch.Tensor:
    """Training-mode dropout of x, differentiable in x. `seeds`: int64 [2]
    on x's device (the step's stream words); `call`: the site's index
    within the step. Rate 0 returns x and rate >= 1 zeros, with no launch
    (`core/dropout.py:151-152,214`). Checks every argument at each call;
    a model's site (`models/modules.py`) checks them once and applies
    `FusedDropoutFn` itself."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return dropped(x)
    return FusedDropoutFn.apply(x, seeds, _checked(x, seeds, rate, call), call, plain)


fused_dropout.launches = 0  # kernel launches (CUDA path only)
fused_dropout.bf16_launches = 0  # the launches on bf16 tensors

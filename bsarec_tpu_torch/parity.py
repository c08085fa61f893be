"""How the port's streaming-CE kernels are held against their plain
versions: the error measures and the limits of the bf16-operand form, in
one place for `chip_smoke.py`, `tools/time_kernels.py` and the tests; and
the limits of the vocab-sharded mesh (at the end).

The bf16 form's backward rounds s, T and p = softmax * dloss to bf16 and
keeps the one-hot terms in fp32, unrounded. Its gradients are compared at
one logZ (the kernel's, given to both sides): logZs that differ by their
own fp32 rounding shift every p of a row, and a p then lands one bf16 ulp
(2^-8 to 2^-7 of it) apart wherever it sits near a rounding boundary. The
gradients are judged in three groups, each relative to its own largest
plain entry: ds, the dT rows of the answers (dominated by the one-hot
term dloss * s) and dT's other rows. A kernel that skips a rounding moves
every term by up to 2^-9: the fp32 form against the bf16 plain version
shows it on ds and on dT's other rows, where the one-hot term that hides
it on the answer rows is absent. The one-hot term itself is read off the
kernel exactly (`one_hot_excess`).

A logit is an H-term fp32 sum, and two summation orders round it apart.
Rounding p to bf16 turns such a difference into a whole bf16 ulp of p
wherever p sits near a rounding boundary, and one large p of a peaked
softmax moves a gradient row by up to 2^-8 of it. At H <= 256 the
readings stay far inside BF16_GRAD_TOL; at H >= 384 the kernel against
the plain version read up to 2.1e-3 on the H100, and the plain version
is as far from itself with its hidden sum reordered (PERF.md).

The bf16 form's tensor-core kernels (the wide routes', and at B <= 256
the on-chip route's pair, H <= 64, and the middle route's, 64 < H <= 256)
sum their logits on the tensor cores,
in their own order, so no order-faithful reference exists for them. They
are held two ways, both against `ce_grads_bf16_in_order` (the plain
version with each logit summed over h in ascending order, one rounding
per step; on exact logits it equals the plain version):
- on `exact_logit_case` inputs, where every logit is exact in fp32 in
  any summation order: both sides see the same logits and, through the
  same exp, the same p, so BF16_GRAD_TOL holds and stays sharp (the fp32
  form, which differs there only by not rounding p, must fail it);
- on random-normal inputs, within BF16_WIDE_GRAD_TOL, which allows single
  bf16 roundings of p to land apart and which the fp32 form must still
  fail on the wide routes; at H <= 256 the fp32 form can lie nearer than
  the limit, so there its control is the exact-logit cases' alone (their
  states scaled by 2 at H <= 64: `exact_logit_case(..., scale=2)`).

The wide routes' fp32 kernels take their products on the tensor cores in
3xTF32: the backward is held within WIDE_GRAD_TOL of the plain version,
the forward's logZ within chip_smoke.py's CE_TOL. On the CPU
`ce_grads_tf32` and `matmul_tf32` emulate that number format (and
1xTF32, the control that must fail the limits) against the JAX package
(`tests/test_torch_port_tf32.py`). That checks the format and the
limits, not the kernels: no fault of a kernel can fail it, only the card
checks can.
"""

from __future__ import annotations

import numpy as np
import torch

# the bf16 form's gradients against the plain bf16 version at one logZ,
# the largest |error| of each group relative to its largest |plain| entry.
# Readings (chip_smoke.py's phase-3 cases, NVIDIA H100 80GB HBM3, 700 W;
# PERF.md): the FMA kernels at most 7.9e-7; the fp32 form at least 8.0e-4
# on ds and 5.3e-3 on dT's other rows. The on-chip route's tensor-core
# pair sums its logits in the tensor cores' order and read up to 1.07e-4
# on random inputs (chip_smoke.py's "H=32" case, dT's other rows), so it
# is held here on exact-logit inputs only, and on random ones as the wide
# routes' bf16 form is (BF16_WIDE_GRAD_TOL). The port's plain version is
# held to JAX's interpret-mode kernel by the same limit on the CPU
BF16_GRAD_TOL = 1e-4
# the one-hot term's exact check: each element of dT[a] - dT_none[a] +
# sum_i dloss_i * s_i (the kernel subtracts the terms in fp32, the check
# adds them in another order) is held within ONE_HOT_ULPS fp32 unit
# roundoffs (2^-24) per term of |dT_none[a]| + sum_i |dloss_i * s_i|.
# Readings on the card: at most 0.125 of that; with the rounded states in
# the check (the fault it guards against) at least 51.9
ONE_HOT_ULPS = 8
# the bf16 form's tensor-core kernels (the wide routes', the on-chip and
# middle routes' pairs) on random-normal inputs, against `ce_grads_bf16_in_order`
# at one logZ, each group relative to its largest |plain| entry. A logit summed in another order rounds apart in fp32, and
# where p sits near a bf16 rounding boundary it lands one bf16 ulp away:
# 2^-8 to 2^-7 (7.8e-3) of a term that a single p dominates, so this limit
# rests on readings, not on a bound (the exact-logit cases carry the sharp
# check). Readings: the tensor-core kernel at most 4.75e-3 on dT's other
# rows (chip_smoke.py's "H=512, repeated answers", NVIDIA H100 80GB HBM3,
# 700 W; PERF.md); the plain version against itself with each logit summed
# in descending h, at most 2.09e-3 there (on the CPU); the fp32 form, at
# least 7.22e-3 on ds (tests/test_torch_port_cuda.py's H = 260 case, on the
# CPU) and 9.49e-3 over chip_smoke.py's cases (PERF.md). The limit sits
# between the kernel's worst reading and the fp32 form's least.
BF16_WIDE_GRAD_TOL = 6e-3
# the fp32 form's gradients on the wide routes (H > 256), each group
# relative to its largest |plain| entry: elementwise, an H-term logit's
# fp32 rounding, which grows with H, passed on through exp() to p, puts
# single elements of dT near cancellation past atol 1e-5 (1.49e-5 at
# H = 384, B = 300 on the H100, from the wide kernel that summed fp32 FMAs)
WIDE_GRAD_TOL = 1e-4


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) of fp32 `x` as a 3xTF32 product on the tensor cores takes
    them (csrc/tensor_core.cuh): hi = x rounded to TF32, 10 mantissa bits,
    nearest with ties away from zero (cvt.rna.tf32.f32); lo = x - hi, exact
    in fp32, then truncated to TF32 as the tensor core reads it."""
    keep = -(1 << 13)  # the 13 low mantissa bits that TF32 drops
    hi = ((x.float().contiguous().view(torch.int32) + (1 << 12)) & keep).view(torch.float32)
    lo = ((x - hi).contiguous().view(torch.int32) & keep).view(torch.float32)
    return hi, lo


def matmul_tf32(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """a @ b as the tensor cores take an fp32 product: passes=3 (3xTF32)
    sums lo_a @ hi_b + hi_a @ lo_b, then hi_a @ hi_b, in fp32 (the products
    of TF32 values are exact); passes=1 (1xTF32) takes hi_a @ hi_b alone."""
    ah, al = tf32_split(a)
    bh, bl = tf32_split(b)
    if passes == 1:
        return ah @ bh
    if passes != 3:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    return (al @ bh + ah @ bl) + ah @ bh


def ce_grads_tf32(states, table, answers, logz, dloss, n_valid,
                  passes: int = 3) -> tuple[torch.Tensor, torch.Tensor]:
    """`ce_grads_plain`'s fp32 form with its three products (the logits,
    p @ T and p^T @ s) in `matmul_tf32`'s number format: passes=3 is the
    format of the wide fp32 kernel on the card (ce_bwd_wide_tf32_kernel),
    passes=1 the control that keeps only TF32's three digits. The one-hot
    terms stay fp32, as in the kernel. It checks the format, not the
    kernel: nothing here runs ce_bwd_wide_tf32_kernel or its CPU path."""
    tile = table[:n_valid]
    p = torch.exp(matmul_tf32(states, tile.T, passes) - logz[:, None]) * dloss[:, None]
    ds = matmul_tf32(p, tile, passes)
    dt = torch.zeros_like(table)
    dt[:n_valid] = matmul_tf32(p.T, states, passes)
    a = answers.long()
    keep = (a >= 0) & (a < n_valid)
    dt.index_add_(0, a[keep], -(dloss[keep, None] * states[keep]))
    rows = table[torch.where(keep, a, 0)] * keep[:, None]
    return ds - dloss[:, None] * rows, dt


# ---- the vocab-sharded mesh (parallel/logits.py, core/mesh.py) -------------
# The sharded CE against the JAX package or an unsharded call: the loss and
# logZ add the merge's roundings (logZ = max + log of a sum of m exps; gold
# = logZ - loss a shard) to fp32 sums taken in another order (rtol, atol);
# the gradients sum one more m-term sum (ds over the shards). As the CE
# kernels' CPU tests state them (tests/test_pallas.py); the bf16 form's
# gradients at one logZ hold BF16_GRAD_TOL, as the unsharded form's do.
SHARD_LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
SHARD_GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# a mesh run against the single run of the port, from the same weights:
# the epoch losses (JAX holds its own mesh to it, tests/test_train.py:255-283)
# and the eval metrics (the same ranking: equal but for a score tie that
# rounding flips; tests/test_train.py:336-367)
MESH_LOSS_RTOL = 2e-4
MESH_METRIC_ATOL = 1e-5
# one Adam step of a mesh run against the single run's: each gradient is a
# sum over the data ranks (or the shards) in another order, within
# SHARD_GRAD_TOL of the single run's; Adam's first step moves a parameter
# by lr * g / (|g| + eps), so the parameters agree to rounding (atol) where
# |g| stands clear of the gradient's rounding noise, and within 2 lr where
# it does not (a gradient that is zero in exact arithmetic, as the
# attention key biases', has a sign set by rounding alone)
MESH_STEP_PARAM_ATOL = 1e-6
MESH_GRAD_NOISE = 1e-5  # |g| below this share of the tensor's largest |g| is noise

def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))


def rel_err(got, want, rows=None) -> float:
    """max |got - want| over `rows`, relative to max |want| there (tensors or
    arrays)."""
    got, want = _tensor(got), _tensor(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    if want.numel() == 0:
        return 0.0
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def answer_rows(answers: torch.Tensor, v: int, n_valid: int) -> torch.Tensor:
    """[v] bool: the table rows that some answer in [0, n_valid) names."""
    a = answers.long()
    rows = torch.zeros(v, dtype=torch.bool, device=answers.device)
    rows[a[(a >= 0) & (a < n_valid)]] = True
    return rows


def grad_errors(ds, dt, want_ds, want_dt, answers, n_valid) -> dict:
    """{group: `rel_err`} for ds, dT's answer rows and dT's other rows."""
    is_answer = answer_rows(answers, dt.shape[0], n_valid)
    return {"ds": rel_err(ds, want_ds), "dT answer rows": rel_err(dt, want_dt, is_answer),
            "dT other rows": rel_err(dt, want_dt, ~is_answer)}


def one_hot_excess(dt, dt_none, states, answers, dloss, n_valid, round_states=False) -> float:
    """The dT one-hot term read off a ce_grads launch: `dt` on `answers`
    against `dt_none`, the same call on answers that are all -1 (no one-hot
    term, the same logZ and dloss). The rows no answer names must be
    bit-equal (else inf); on the answer rows, dt - dt_none must be
    -sum_i dloss_i * s_i over the unrounded states (`round_states` puts the
    bf16-rounded ones there, the control). Returns the largest error over
    its allowance (module comment at ONE_HOT_ULPS): <= 1 holds."""
    a = answers.long()
    keep = (a >= 0) & (a < n_valid)
    is_answer = answer_rows(answers, dt.shape[0], n_valid)
    if not torch.equal(dt[~is_answer], dt_none[~is_answer]):
        return float("inf")
    rows = torch.nonzero(is_answer).flatten()
    if rows.numel() == 0:
        return 0.0
    where = torch.searchsorted(rows, a[keep])
    s = states[keep].bfloat16().float() if round_states else states[keep]
    terms = dloss[keep, None] * s
    term = torch.zeros((rows.numel(), dt.shape[1]), device=dt.device).index_add_(0, where, terms)
    size = torch.zeros_like(term).index_add_(0, where, terms.abs())
    count = torch.bincount(where, minlength=rows.numel())[:, None]
    none = dt_none[rows]
    allowed = ONE_HOT_ULPS * 2.0 ** -24 * (count + 1) * (none.abs() + size) + 1e-30
    return float(((dt[rows] - (none - term)).abs() / allowed).max())


def logits_in_order(s: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[B, C] logits s @ t.T of bf16-rounded s [B, H] and t [C, H], each
    summed over h in ascending order with one fp32 rounding per step, as
    the CE kernels' FMA chains sum them (the products are exact)."""
    acc = torch.zeros((s.shape[0], t.shape[0]), dtype=torch.float32, device=s.device)
    for h in range(s.shape[1]):
        acc.addcmul_(s[:, h, None], t[None, :, h])
    return acc


def exact_logit_case(b: int, v: int, h: int, n_valid: int, seed: int, device="cpu",
                     scale: int = 1):
    """(states [b, h], table [v, h], answers [b] int64, dloss [b]) whose
    logits are exact in fp32 in any summation order: states are integers in
    [-8, 8] times 2^-3 and table entries integers in [-8, 8] times 2^-4, so
    both are bf16-exact and every partial sum of a logit is a multiple of
    2^-7 below 2^9 at h <= 1024 (16 significant bits; fp32 keeps 24, and a
    tensor core's fp32 sum of such terms loses none). The logits spread
    with standard deviation ~4 at h = 512 (~3 at 260, ~6 at 1024), peaked
    enough that the fp32 form, which here differs from the bf16 form only
    by not rounding p, misses BF16_GRAD_TOL on ds and on dT's other rows.
    `scale` (1, 2 or 4) multiplies the states, which keeps both properties
    (at 2 every partial sum is a multiple of 2^-6 below 2^10): at h <= 64
    the unscaled logits spread too little (std ~1) for the fp32 form to
    miss the limit on ds, and the H <= 64 cases take scale 2 (std ~2).
    Answers in [1, n_valid) with a repeat, item 0, -1, n_valid, v and v + 7
    among the first rows; dloss uniform in [0.5, 1.5]."""
    if scale not in (1, 2, 4):
        raise ValueError(f"scale must be 1, 2 or 4, got {scale}")
    rng = np.random.default_rng(seed)
    states = rng.integers(-8, 9, size=(b, h)).astype(np.float32) * np.float32(scale * 2.0 ** -3)
    table = rng.integers(-8, 9, size=(v, h)).astype(np.float32) * np.float32(2.0 ** -4)
    answers = rng.integers(1, n_valid, size=b)
    special = [answers[0], answers[0], 0, -1, n_valid, v, v + 7]
    answers[: min(b, len(special))] = special[:b]
    dloss = rng.uniform(0.5, 1.5, size=b).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (states, table, answers, dloss))


def ce_grads_bf16_in_order(states, table, answers, logz, dloss, n_valid,
                           chunk: int = 65536) -> tuple[torch.Tensor, torch.Tensor]:
    """`ce_grads_plain(..., bf16=True)` with the logits from
    `logits_in_order`: ds = p @ T and dT = p^T @ s of the rounded s, T
    and p, then the one-hot terms of the unrounded states and rows."""
    s = states.bfloat16().float()
    ds = torch.zeros_like(states)
    dt = torch.zeros_like(table)
    for j0 in range(0, n_valid, chunk):
        j1 = min(n_valid, j0 + chunk)
        tile = table[j0:j1].bfloat16().float()
        p = (torch.exp(logits_in_order(s, tile) - logz[:, None]) * dloss[:, None]).bfloat16().float()
        ds += p @ tile
        dt[j0:j1] = p.T @ s
    a = answers.long()
    keep = (a >= 0) & (a < n_valid)
    dt.index_add_(0, a[keep], -(dloss[keep, None] * states[keep]))
    rows = table[torch.where(keep, a, 0)] * keep[:, None]
    return ds - dloss[:, None] * rows, dt

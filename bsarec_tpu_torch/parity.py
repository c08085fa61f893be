"""How the port's streaming-CE kernels are held against their plain
versions: the error measures and the limits of the bf16-operand form, in
one place for `chip_smoke.py`, `tools/time_kernels.py` and the tests.

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
is as far from itself with its hidden sum reordered (PERF.md). So the
wide routes' bf16 form is held against `ce_grads_bf16_in_order`:
the plain version with each logit summed as the kernels sum it, over h in
ascending order with one rounding per step. A product of two bf16 values
is exact in fp32, so the kernels' FMA chain and a multiply-then-add round
alike, and both sides see the same logits and, through the same expf, the
same p.
"""

from __future__ import annotations

import numpy as np
import torch

# the bf16 form's gradients against the plain bf16 version at one logZ,
# the largest |error| of each group relative to its largest |plain| entry.
# Readings (chip_smoke.py's phase-3 cases, NVIDIA H100 80GB HBM3, 700 W;
# PERF.md): the kernel at most 7.9e-7; the fp32 form at least 8.0e-4
# on ds and 5.3e-3 on dT's other rows. The port's plain version is held
# to JAX's interpret-mode kernel by the same limit on the CPU
BF16_GRAD_TOL = 1e-4
# the one-hot term's exact check: each element of dT[a] - dT_none[a] +
# sum_i dloss_i * s_i (the kernel subtracts the terms in fp32, the check
# adds them in another order) is held within ONE_HOT_ULPS fp32 unit
# roundoffs (2^-24) per term of |dT_none[a]| + sum_i |dloss_i * s_i|.
# Readings on the card: at most 0.125 of that; with the rounded states in
# the check (the fault it guards against) at least 51.9
ONE_HOT_ULPS = 8


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

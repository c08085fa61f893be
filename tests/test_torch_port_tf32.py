"""3xTF32, the number format of the wide fp32 `ce_grads` and `ce_logz`
kernels on the card (`ce_bwd_wide_tf32_kernel`, `ce_fwd_wide_tf32_kernel`,
`csrc/tensor_core.cuh`), against the JAX package on the CPU.

The kernel takes each of its three products on the tensor cores, each
fp32 operand split into a TF32 hi and lo and every product taken as
lo . hi + hi . lo + hi . hi. `parity.ce_grads_tf32` emulates that format in
torch (the order of the sums is torch's, not the tensor core's). Built
from it, `ce_grads` must hold JAX's interpret-mode `streaming_ce_grads` at
fp32 within the fp32 tolerances of `tests/test_torch_port_wide.py`
(elementwise rtol 1e-4, atol 1e-5, and `parity.WIDE_GRAD_TOL` of each
group's largest entry, the card's limit), while 1xTF32 (hi alone, about
three digits) must fail `parity.WIDE_GRAD_TOL`: the limit tells the two
formats apart. In the same way, logZ from 3xTF32 logits must hold JAX's
interpret-mode `streaming_ce_stats` within `chip_smoke.py`'s CE_TOL, and
from 1xTF32 logits must fail it. This checks the number format and the
limits, not the kernels, which only the card checks
(`tests/test_torch_port_cuda.py`, `chip_smoke.py`) run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsarec_tpu.ops.pallas_ce import streaming_ce_grads as jax_streaming_ce_grads
from bsarec_tpu.ops.pallas_ce import streaming_ce_stats as jax_streaming_ce_stats
from bsarec_tpu_torch import parity
from bsarec_tpu_torch.ops import ce

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# chip_smoke.py's limit on logZ and the loss, relative to max(1, |plain|)
CE_TOL = 1e-5


def _ce_inputs(b, v, h, n_valid, seed):
    """`tests/test_torch_port_wide.py`'s: N(0, 1) states, 0.25 N(0, 1)
    table; answers in [1, n_valid), with a repeat, item 0, -1 and ids
    >= n_valid and >= V."""
    rng = np.random.default_rng(seed)
    states = rng.standard_normal((b, h), dtype=np.float32)
    table = 0.25 * rng.standard_normal((v, h), dtype=np.float32)
    answers = rng.integers(1, n_valid, size=b).astype(np.int32)
    answers[:6] = [answers[6], 0, -1, n_valid, v + 7, answers[6]]
    return states, table, answers


def test_tf32_split_rounds_hi_and_truncates_lo():
    """hi keeps 10 mantissa bits, rounded to nearest with ties away from
    zero; hi + lo is x exactly where lo needs no more than TF32's bits;
    lo loses the bits past them, as the tensor core's read does."""
    ulp = 2.0 ** -10
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 4, 1 + 3 * ulp / 4, 0.0, 3.0],
                     dtype=torch.float32)
    hi, lo = parity.tf32_split(x)
    assert hi.tolist() == [1 + ulp, -(1 + ulp), 1.0, 1 + ulp, 0.0, 3.0]
    assert torch.equal(hi + lo, x)
    rng = np.random.default_rng(0)
    r = torch.from_numpy(rng.standard_normal(4096, dtype=np.float32))
    hi, lo = parity.tf32_split(r)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & ((1 << 13) - 1)).any()
    assert float(((hi + lo - r).abs() / r.abs()).max()) <= 2.0 ** -21
    assert float(((hi - r).abs() / r.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("h", [384, 512])
def test_3xtf32_ce_grads_match_jax_and_1xtf32_does_not(h):
    """`ce_grads` in 3xTF32 against JAX's interpret-mode f32 kernel, odd B,
    n_valid < V, an uneven dloss, at the plain version's logZ: within
    GRAD_TOL elementwise and parity.WIDE_GRAD_TOL by group; 1xTF32 exceeds
    parity.WIDE_GRAD_TOL on ds and on dT's other rows."""
    b, v, n_valid = 13, 1000, 990
    states, table, answers = _ce_inputs(b, v, h, n_valid, seed=h)
    dloss = np.random.default_rng(h + 1).uniform(0.5, 1.5, size=b).astype(np.float32)
    s, t = torch.from_numpy(states), torch.from_numpy(table)
    a, d = torch.from_numpy(answers).long(), torch.from_numpy(dloss)
    logz = ce.ce_logz_plain(s, t, n_valid)
    j_ds, j_dt = jax_streaming_ce_grads(jnp.asarray(states), jnp.asarray(table),
                                        jnp.asarray(answers), jnp.asarray(logz.numpy()),
                                        jnp.asarray(dloss), n_valid, 8, 128, True, None)
    want = (torch.from_numpy(np.array(j_ds)), torch.from_numpy(np.array(j_dt)))
    ds, dt = parity.ce_grads_tf32(s, t, a, logz, d, n_valid)
    for got, ref in zip((ds, dt), want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **GRAD_TOL)
    assert max(parity.grad_errors(ds, dt, *want, a, n_valid).values()) <= parity.WIDE_GRAD_TOL
    assert not dt[n_valid:].any()
    control = parity.grad_errors(*parity.ce_grads_tf32(s, t, a, logz, d, n_valid, passes=1),
                                 *want, a, n_valid)
    assert min(control["ds"], control["dT other rows"]) > parity.WIDE_GRAD_TOL


def _logz_tf32(states, table, n_valid, passes):
    """logZ [B] over the columns < n_valid of logits in `parity.matmul_tf32`'s
    format: passes=3 is the number format of the wide fp32 forward on the
    card (ce_fwd_wide_tf32_kernel), passes=1 the control. It emulates the
    format, not the kernel: nothing here runs the kernel or its CPU path."""
    return torch.logsumexp(parity.matmul_tf32(states, table[:n_valid].T, passes), dim=1)


@pytest.mark.parametrize("h", [384, 512])
def test_3xtf32_logz_matches_jax_and_1xtf32_does_not(h):
    """logZ of 3xTF32 logits against JAX's interpret-mode f32
    `streaming_ce_stats`, odd B, n_valid < V: within CE_TOL relative to
    max(1, |logZ|); of 1xTF32 logits, past it (a logit keeps about three
    digits there, and logZ follows the largest logits)."""
    b, v, n_valid = 13, 1000, 990
    states, table, answers = _ce_inputs(b, v, h, n_valid, seed=h + 2)
    _, j_logz = jax_streaming_ce_stats(jnp.asarray(states), jnp.asarray(table),
                                       jnp.asarray(answers), n_valid, 8, 128, True)
    want = torch.from_numpy(np.array(j_logz))
    s, t = torch.from_numpy(states), torch.from_numpy(table)

    def err(passes):
        got = _logz_tf32(s, t, n_valid, passes)
        return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())

    assert err(3) <= CE_TOL
    assert err(1) > CE_TOL

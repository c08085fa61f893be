"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here needs an NVIDIA card and nvcc and skips without
them. The file imports no JAX, so that it runs on a machine with the card
and PyTorch alone:

    python -m pytest tests/test_torch_port_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from bsarec_tpu_torch import parity
from bsarec_tpu_torch.ops import ce, rank
from bsarec_tpu_torch.ops import dropout as fd

# top-k: fp32 dot products of 64 N(0, 1) terms in another order
RTOL, ATOL = 1e-5, 1e-5
# CE: fp32 sums of V exponentials (logZ) and of B or V products (gradients)
# in another order than torch's
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)



@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: the CUDA kernels have no CPU mode")
    from bsarec_tpu_torch.train.trainer import set_fp32_matmul

    set_fp32_matmul()
    return torch.device("cuda")


def _rank_inputs(b, v, h, seed, integer):
    rng = np.random.default_rng(seed)
    if integer:  # dot products are exact, so ids (ties included) must match
        states = rng.integers(-2, 3, size=(b, h)).astype(np.float32)
        table = rng.integers(-2, 3, size=(v, h)).astype(np.float32)
    else:
        states = rng.normal(size=(b, h)).astype(np.float32)
        table = rng.normal(size=(v, h)).astype(np.float32)
    seen = rng.integers(1, v, size=(b, 20)).astype(np.int32)
    seen[:, 1] = seen[:, 0]
    seen[:, 14:] = 0
    return states, table, seen


def _masked_logits(states, table, seen, n_valid):
    logits = states @ table.T
    logits[np.arange(len(seen))[:, None], seen] = 0.0
    logits[:, 0] = 0.0
    logits[:, n_valid:] = -np.inf
    return logits


@pytest.mark.cuda
@pytest.mark.parametrize("b,v,h,k,n_valid,integer", [
    (37, 5000, 64, 20, 4990, False),
    (3, 12101, 48, 1, 12101, False),
    (64, 20011, 64, 128, 20006, True),
    (37, 20011, 64, 20, 20011, True),
    # past H = 256 at k <= 32 the tensor-core route (H = 512 and 1024, k =
    # 20); at k = 128 the older route's wide form (states staged in hidden
    # chunks)
    (37, 5003, 512, 20, 4990, True),
    (37, 5003, 512, 128, 4990, True),
    (5, 3001, 1024, 20, 3001, True),
    (70, 3001, 1024, 128, 2990, False),
])
def test_cuda_kernel_matches_plain(cuda_device, b, v, h, k, n_valid, integer):
    states, table, seen = _rank_inputs(b, v, h, seed=b, integer=integer)
    s, t = torch.from_numpy(states).to(cuda_device), torch.from_numpy(table).to(cuda_device)
    bm = rank.seen_ids_to_bitmask(torch.from_numpy(rank.dedupe_seen_rows(seen)).to(cuda_device), v)
    np.testing.assert_array_equal(bm.cpu().numpy(), rank.build_seen_bitmask(seen, v))
    f = rank.streaming_masked_topk
    before = (f.launches, f.wide_launches, f.tc_launches)
    got_v, got_i = rank.streaming_masked_topk(s, t, bm, k=k, n_valid=n_valid)
    got_v2, got_i2 = rank.streaming_masked_topk(s, t, bm, k=k, n_valid=n_valid)
    torch.cuda.synchronize()
    tc = rank.tc_route(b, h, k)
    assert tc == (h > 256 and k <= 32)
    assert rank.wide_route(h, k) == (h == 1024 or (h == 512 and k == 128))
    wide = not tc and rank.wide_route(h, k)  # the older route's form launched
    assert (f.launches, f.wide_launches, f.tc_launches) == (
        before[0] + 2, before[1] + 2 * wide, before[2] + 2 * tc)
    assert torch.equal(got_v, got_v2) and torch.equal(got_i, got_i2)
    want_v, want_i = rank.streaming_masked_topk_plain(s, t, bm, k=k, n_valid=n_valid)
    if integer:
        assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    else:
        torch.testing.assert_close(got_v, want_v, rtol=RTOL, atol=ATOL)
        logits = _masked_logits(states, table, seen, n_valid)
        by_score = np.take_along_axis(logits, got_i.cpu().numpy().astype(np.int64), axis=1)
        np.testing.assert_allclose(by_score, want_v.cpu().numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,v,h,n_valid", [
    (37, 5000, 64, 4990), (3, 12101, 48, 12101), (130, 70001, 32, 70001),
    (64, 20011, 128, 20006), (256, 9000, 256, 9000),
])
def test_cuda_ce_kernels_match_plain(cuda_device, b, v, h, n_valid):
    rng = np.random.default_rng(b)
    states = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(cuda_device)
    table = torch.from_numpy((0.5 * rng.normal(size=(v, h))).astype(np.float32)).to(cuda_device)
    answers = rng.integers(0, n_valid, size=b)
    answers[: min(b, 3)] = answers[0]  # repeats
    answers[-1] = -1
    a = ce.map_answers(torch.from_numpy(answers).to(cuda_device), n_valid)
    before = (ce.ce_logz.launches, ce.gold_rows.launches, ce.ce_grads.launches)
    logz = ce.ce_logz(states, table, n_valid)
    rows = ce.gold_rows(table, a)
    d = torch.full((b,), 1.0 / b, device=cuda_device)
    ds, dt = ce.ce_grads(states, table, a, logz, d, n_valid)
    torch.cuda.synchronize()
    assert (ce.ce_logz.launches, ce.gold_rows.launches, ce.ce_grads.launches) == tuple(
        x + 1 for x in before)
    torch.testing.assert_close(logz, ce.ce_logz_plain(states, table, n_valid), **LOSS_TOL)
    assert torch.equal(rows, ce.gold_rows_plain(table, a))
    want_ds, want_dt = ce.ce_grads_plain(states, table, a, logz, d, n_valid)
    torch.testing.assert_close(ds, want_ds, **GRAD_TOL)
    torch.testing.assert_close(dt, want_dt, **GRAD_TOL)


def _held_as_3xtf32(ds, dt, want_ds, want_dt, states, table, a, logz, d, n_valid):
    """Gradients of a 3xTF32 tensor-core kernel (the middle and wide
    routes' fp32 form) against the plain fp32 version's: within
    `parity.WIDE_GRAD_TOL` of each group's largest entry, and, against an
    fp64 reference, with a largest group error no larger than the plain
    version's. Elementwise GRAD_TOL does not hold there: H-term logits
    rounded in another order move single elements near cancellation past
    its atol, and the plain fp32 version misses it against fp64 too (at
    this file's H = 256 cases, on the H100)."""
    errs = parity.grad_errors(ds, dt, want_ds, want_dt, a, n_valid)
    assert max(errs.values()) <= WIDE_GRAD_TOL, errs
    exact = ce.ce_grads_plain(states.double(), table.double(), a, logz.double(), d.double(), n_valid)
    kernel = max(parity.grad_errors(ds, dt, *exact, a, n_valid).values())
    plain = max(parity.grad_errors(want_ds, want_dt, *exact, a, n_valid).values())
    assert kernel <= plain, (kernel, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("b,v,h,n_valid", [
    (256, 70001, 64, 70001), (37, 5000, 64, 4990), (3, 12101, 48, 12101), (64, 20011, 256, 20006),
])
def test_cuda_fused_ce_matches_plain_and_the_unfused_composition(cuda_device, b, v, h, n_valid):
    """The fused entries (loss and logZ from one ce_logz call; the finished
    ds from one ce_grads call) on raw int64 answers (-1, >= n_valid,
    >= V, item 0, repeats) against the plain versions, and the fused ds
    bit-equal to the unfused composition of the same kernels: ce_grads
    on answers of -1 (no gold terms), minus dloss[:, None] * gold_rows(...).
    The gradients within GRAD_TOL elementwise, but on the middle route (H =
    256: 3xTF32 on the tensor cores) as `_held_as_3xtf32` holds them."""
    rng = np.random.default_rng(b + h)
    states = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(cuda_device)
    table = torch.from_numpy((0.5 * rng.normal(size=(v, h))).astype(np.float32)).to(cuda_device)
    answers = rng.integers(1, n_valid, size=b)
    special = [answers[0], answers[0], 0, -1, n_valid, v, v + 7]
    answers[: min(b, len(special))] = special[:b]
    a = torch.from_numpy(answers).to(cuda_device)  # int64, unmapped
    d = torch.from_numpy(rng.uniform(0.5, 1.5, size=b).astype(np.float32)).to(cuda_device)
    before = (ce.ce_logz.launches, ce.gold_rows.launches, ce.ce_grads.launches)
    loss, logz = ce.ce_loss_logz(states, table, a, n_valid)
    ds, dt = ce.ce_grads(states, table, a, logz, d, n_valid)
    torch.cuda.synchronize()
    assert (ce.ce_logz.launches, ce.gold_rows.launches, ce.ce_grads.launches) == (
        before[0] + 1, before[1], before[2] + 1)
    want_loss, want_logz = ce.ce_loss_logz_plain(states, table, a, n_valid)
    torch.testing.assert_close(loss, want_loss, **LOSS_TOL)
    torch.testing.assert_close(logz, want_logz, **LOSS_TOL)
    off = (a < 0) | (a >= n_valid)
    assert torch.equal(loss[off], logz[off])  # gold 0
    want_ds, want_dt = ce.ce_grads_plain(states, table, a, logz, d, n_valid)
    if ce.mid_route(b, h):
        _held_as_3xtf32(ds, dt, want_ds, want_dt, states, table, a, logz, d, n_valid)
    else:
        torch.testing.assert_close(ds, want_ds, **GRAD_TOL)
        torch.testing.assert_close(dt, want_dt, **GRAD_TOL)
    assert torch.equal(ce.ce_logz(states, table, n_valid), logz)
    # answers of -1 leave out both gold terms: the unfused ds subtracts them
    ds_sum, _ = ce.ce_grads(states, table, torch.full_like(a, -1), logz, d, n_valid)
    unfused = ds_sum - d[:, None] * ce.gold_rows(table, ce.map_answers(a, n_valid))
    torch.cuda.synchronize()
    assert torch.equal(ds, unfused)


@pytest.mark.cuda
@pytest.mark.parametrize("b,v,h,n_valid", [
    (256, 70001, 64, 70001), (37, 5000, 64, 4990), (3, 12101, 48, 12101),
    (64, 20011, 128, 20006), (256, 9000, 256, 9000),
])
def test_cuda_ce_bf16_form_matches_plain(cuda_device, b, v, h, n_valid):
    """ce_loss_logz and ce_grads in the bf16-operand form, on both
    tensor-core routes at B <= 256 (at H <= 64 the on-chip route's kernels,
    ce_fwd_onchip_tc_kernel and ce_bwd_onchip_tc_kernel; at H in {128, 256}
    the middle route's, ce_fwd_mid_tc_kernel and ce_bwd_mid_tc_kernel), on
    raw int64 answers (-1, >= n_valid, >= V, item 0, repeats), against the
    plain bf16 versions (the loss and logZ within LOSS_TOL, as the fp32 sums
    of exact products they are); the gradients at the kernel's logZ, whose
    tensor cores sum each logit in their own order (a p on a bf16 rounding
    boundary can land one bf16 ulp away), as the wide route's bf16 form is
    held, within `parity.BF16_WIDE_GRAD_TOL` of
    `parity.ce_grads_bf16_in_order` (the sharp check and its fp32 control
    are the exact-logit cases of test_cuda_ce_bf16_onchip_tc_edges and
    test_cuda_ce_bf16_mid_tc_edges); dT's one-hot term
    on the unrounded states; two calls bit-equal; through the autograd
    function too; and apart from the fp32 form on the same inputs."""
    rng = np.random.default_rng(b + h + 1)
    states = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(cuda_device)
    table = torch.from_numpy((0.5 * rng.normal(size=(v, h))).astype(np.float32)).to(cuda_device)
    answers = rng.integers(1, n_valid, size=b)
    special = [answers[0], answers[0], 0, -1, n_valid, v, v + 7]
    answers[: min(b, len(special))] = special[:b]
    a = torch.from_numpy(answers).to(cuda_device)
    d = torch.from_numpy(rng.uniform(0.5, 1.5, size=b).astype(np.float32)).to(cuda_device)
    bf16 = "bfloat16"
    counts = lambda: (ce.ce_logz.bf16_launches, ce.ce_grads.bf16_launches,
                      ce.ce_grads.onchip_launches, ce.ce_grads.wide_launches,
                      ce.ce_logz.onchip_launches, ce.ce_logz.mid_launches,
                      ce.ce_grads.mid_launches)
    before = counts()
    loss, logz = ce.ce_loss_logz(states, table, a, n_valid, dtype=bf16)
    ds, dt = ce.ce_grads(states, table, a, logz, d, n_valid, dtype=bf16)
    ds2, dt2 = ce.ce_grads(states, table, a, logz, d, n_valid, dtype=bf16)
    torch.cuda.synchronize()
    onchip, mid = ce.onchip_route(b, h), ce.mid_route(b, h)
    assert onchip == (h <= 64) and mid == (h > 64)
    assert counts() == (before[0] + 1, before[1] + 2, before[2] + 2 * onchip, before[3],
                        before[4] + onchip, before[5] + mid, before[6] + 2 * mid)
    assert torch.equal(ds, ds2) and torch.equal(dt, dt2)
    want_loss, want_logz = ce.ce_loss_logz_plain(states, table, a, n_valid, bf16=True)
    torch.testing.assert_close(loss, want_loss, **LOSS_TOL)
    torch.testing.assert_close(logz, want_logz, **LOSS_TOL)
    off = (a < 0) | (a >= n_valid)
    assert torch.equal(loss[off], logz[off])
    want = parity.ce_grads_bf16_in_order(states, table, a, logz, d, n_valid)
    errs = parity.grad_errors(ds, dt, *want, a, n_valid)
    assert max(errs.values()) <= parity.BF16_WIDE_GRAD_TOL, errs
    assert not dt[n_valid:].any()
    _, none_dt = ce.ce_grads(states, table, torch.full_like(a, -1), logz, d, n_valid, dtype=bf16)
    assert parity.one_hot_excess(dt, none_dt, states, a, d, n_valid) <= 1.0
    assert parity.one_hot_excess(dt, none_dt, states, a, d, n_valid, round_states=True) > 1.0
    # the fp32 form rounds nothing: its logZ differs
    assert not torch.equal(ce.ce_logz(states, table, n_valid), logz)
    s = states.clone().requires_grad_()
    t = table.clone().requires_grad_()
    auto = ce.streaming_softmax_ce(s, t, a, n_valid, dtype=bf16)
    (auto * d).sum().backward()
    assert torch.equal(auto.detach(), loss)
    assert torch.equal(s.grad, ds) and torch.equal(t.grad, dt)


def _onchip_tc_inputs(b, v, h, n_valid, inputs, device):
    """`parity.exact_logit_case` inputs (states scaled by 2, by 4 at H = 4,
    so that the fp32 control misses BF16_GRAD_TOL on ds: unscaled, it read
    7.1e-5 on ds at B=3, V=1,000,001, H=256 on the card), or N(0, 1) states
    and a 0.5 N(0, 1) table with exact_logit_case's answers and dloss."""
    states, table, a, d = parity.exact_logit_case(b, v, h, max(n_valid, 2), seed=b + v + h,
                                                  device=device, scale=4 if h == 4 else 2)
    if inputs == "normal":
        rng = np.random.default_rng(b + v + h)
        states = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(device)
        table = torch.from_numpy((0.5 * rng.normal(size=(v, h))).astype(np.float32)).to(device)
    return states, table, a, d


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["exact", "normal"])
@pytest.mark.parametrize("b,v,h,n_valid", [
    (1, 1, 64, 1), (3, 1, 48, 1), (1, 127, 4, 127), (3, 128, 48, 128), (255, 129, 64, 128),
    (256, 129, 4, 129), (256, 127, 48, 127), (255, 128, 64, 128), (1, 129, 48, 129),
    (3, 1_000_001, 64, 1_000_000), (256, 1_000_001, 48, 1_000_000), (255, 1_000_001, 4, 1_000_000),
    (37, 129, 64, 0), (256, 128, 4, 0), (1, 127, 48, 0),
])
def test_cuda_ce_bf16_onchip_tc_edges(cuda_device, b, v, h, n_valid, inputs):
    """The bf16 form's on-chip tensor-core kernels (ce_fwd_onchip_tc_kernel
    through ce_loss_logz, ce_bwd_onchip_tc_kernel through ce_grads) at edge
    shapes: B in {1, 3, 255, 256}, H in {4, 48, 64}, V in {1, 127, 128,
    129, 1,000,001 with n_valid = V - 1}, n_valid = 0 (logZ -inf, dT zero, ds
    the gold term alone). On `parity.exact_logit_case` inputs, whose logits
    are exact in any summation order, the gradients within
    `parity.BF16_GRAD_TOL` of the plain bf16 version at the kernel's logZ,
    which the fp32 form (apart there only by not rounding p) must fail on ds
    and on dT's other rows; on normal inputs, where the tensor cores' own
    summation order can move a p one bf16 ulp, within
    `parity.BF16_WIDE_GRAD_TOL` of `parity.ce_grads_bf16_in_order`, as
    the wide route's bf16 form is held, and dT's one-hot term must fail
    its check with the rounded states. Every case:
    one on-chip bf16 launch a call; loss and logZ within LOSS_TOL; two
    ce_grads calls bit-equal; dT past n_valid zero; dT's one-hot term on the
    unrounded states; the autograd function equal to the wrappers."""
    assert ce.onchip_route(b, h)
    _bf16_tc_edges(cuda_device, b, v, h, n_valid, inputs, "onchip_launches")


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["exact", "normal"])
@pytest.mark.parametrize("b,v,h,n_valid", [
    (1, 1, 68, 1), (3, 1, 256, 1), (1, 127, 128, 127), (3, 128, 192, 128), (255, 129, 256, 128),
    (256, 129, 68, 129), (256, 127, 128, 127), (255, 128, 256, 128), (1, 129, 192, 129),
    (3, 1_000_001, 256, 1_000_000), (256, 1_000_001, 128, 1_000_000), (255, 1_000_001, 68, 1_000_000),
    (37, 129, 256, 0), (256, 128, 68, 0), (1, 127, 192, 0),
])
def test_cuda_ce_bf16_mid_tc_edges(cuda_device, b, v, h, n_valid, inputs):
    """The bf16 form's middle-route tensor-core kernels (ce_fwd_mid_tc_kernel
    through ce_loss_logz, ce_bwd_mid_tc_kernel through ce_grads) at edge
    shapes, with test_cuda_ce_bf16_onchip_tc_edges' checks: B in {1, 3, 255,
    256}, H in {68, 128, 192, 256}, V in {1, 127, 128, 129, 1,000,001 with
    n_valid = V - 1}, n_valid = 0; on the exact-logit inputs the fp32 form
    must fail `parity.BF16_GRAD_TOL` on ds and on dT's other rows; one
    middle-route bf16 launch a call."""
    assert ce.mid_route(b, h) and not ce.onchip_route(b, h) and not ce.wide_route(h)
    _bf16_tc_edges(cuda_device, b, v, h, n_valid, inputs, "mid_launches")


def _fp32_mid_counts():
    return (ce.ce_logz.mid_tf32_launches, ce.ce_grads.mid_tf32_launches,
            ce.ce_logz.bf16_launches, ce.ce_grads.bf16_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("inputs", ["exact", "normal", "repeated"])
@pytest.mark.parametrize("b,v,h,n_valid", [
    (1, 1, 68, 1), (3, 1, 256, 1), (1, 127, 128, 127), (3, 128, 192, 128), (255, 129, 256, 128),
    (256, 129, 68, 129), (256, 127, 128, 127), (255, 128, 256, 128), (1, 129, 192, 129),
    (3, 1_000_001, 256, 1_000_000), (256, 1_000_001, 128, 1_000_000), (255, 1_000_001, 68, 1_000_000),
    (37, 129, 256, 0), (256, 128, 68, 0), (1, 127, 192, 0), (128, 9001, 256, 8999),
    (129, 9001, 128, 9001), (100, 257, 252, 257),
])
def test_cuda_ce_fp32_mid_edges(cuda_device, b, v, h, n_valid, inputs):
    """The fp32 form's middle route at edge shapes: ce_fwd_mid_tf32_kernel
    through ce_loss_logz (wgmma in 3xTF32) and, through ce_grads,
    ce_bwd_wide_tf32_kernel (mma.sync in 3xTF32).
    B in {1, 3, 37, 100, 128, 129, 255, 256}, H in {68, 128, 192, 252, 256},
    V in {1, 127, 128, 129, 257, 9001, 1,000,001 with n_valid = V - 1},
    n_valid < V and n_valid = 0 (logZ -inf, dT zero, ds the gold term
    alone); on `parity.exact_logit_case` inputs (exact logits in any
    summation order), N(0, 1) ones, and ones whose answers repeat five ids
    in [1, n_valid) (none valid at n_valid <= 1).
    Loss and logZ within LOSS_TOL of the plain fp32 version; the gradients
    at the kernel's logZ within `parity.WIDE_GRAD_TOL` of the plain version
    (each group relative to its largest entry); two ce_grads calls
    bit-equal; dT past n_valid zero; dT's one-hot term on the states (the
    rounded states failing it on inexact inputs); the autograd function
    equal to the wrappers; one launch a call on its kernel's counter."""
    assert ce.mid_route(b, h) and not ce.onchip_route(b, h) and not ce.wide_route(h)
    states, table, a, d = _onchip_tc_inputs(b, v, h, n_valid, "exact" if inputs == "exact" else "normal",
                                            cuda_device)
    if inputs == "repeated":  # five ids in [1, n_valid), as chip_smoke.py's ce_case draws them
        rng = np.random.default_rng(b + v)
        ids = rng.integers(1, max(n_valid, 2), size=5)
        a = torch.from_numpy(rng.choice(ids, size=b)).to(cuda_device)
    before = _fp32_mid_counts()
    loss, logz = ce.ce_loss_logz(states, table, a, n_valid)
    ds, dt = ce.ce_grads(states, table, a, logz, d, n_valid)
    ds2, dt2 = ce.ce_grads(states, table, a, logz, d, n_valid)
    torch.cuda.synchronize()
    assert _fp32_mid_counts() == (before[0] + 1, before[1] + 2, before[2], before[3])
    assert torch.equal(ds, ds2) and torch.equal(dt, dt2)
    want_loss, want_logz = ce.ce_loss_logz_plain(states, table, a, n_valid)
    if n_valid == 0:
        assert torch.equal(logz, torch.full_like(logz, float("-inf")))
    torch.testing.assert_close(loss, want_loss, **LOSS_TOL)
    torch.testing.assert_close(logz, want_logz, **LOSS_TOL)
    off = (a < 0) | (a >= n_valid)
    assert torch.equal(loss[off], logz[off])
    assert not dt[n_valid:].any()
    want = ce.ce_grads_plain(states, table, a, logz, d, n_valid)
    if n_valid == 0:
        assert torch.equal(ds, want[0]) and not dt.any()
    else:
        errs = parity.grad_errors(ds, dt, *want, a, n_valid)
        assert max(errs.values()) <= parity.WIDE_GRAD_TOL, errs
    _, none_dt = ce.ce_grads(states, table, torch.full_like(a, -1), logz, d, n_valid)
    assert parity.one_hot_excess(dt, none_dt, states, a, d, n_valid) <= 1.0
    if inputs != "exact" and bool(((a >= 0) & (a < n_valid)).any()):
        assert parity.one_hot_excess(dt, none_dt, states, a, d, n_valid, round_states=True) > 1.0
    s = states.clone().requires_grad_()
    t = table.clone().requires_grad_()
    auto = ce.streaming_softmax_ce(s, t, a, n_valid)
    (auto * d).sum().backward()
    assert torch.equal(auto.detach(), loss)
    assert torch.equal(s.grad, ds) and torch.equal(t.grad, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,route", [
    (256, 64, "onchip"), (256, 68, "mid"), (1, 68, "mid"), (128, 128, "mid"), (129, 128, "mid"),
    (128, 256, "mid"), (129, 256, "mid"), (256, 256, "mid"), (256, 260, "wide"), (257, 128, "sweep"),
    (257, 256, "sweep"),
])
def test_cuda_ce_fp32_mid_route_boundary(cuda_device, b, h, route):
    """The fp32 form on both sides of the middle route's bounds (H 64 / 68,
    256 / 260, B 256 / 257), at B = 1, 128, 129 and 256 on it: ce_loss_logz
    takes ce_fwd_mid_tf32_kernel on the route and ce_grads
    ce_bwd_wide_tf32_kernel (each with its middle-route counter, the wide
    route's counters unmoved), the on-chip, wide or sweep kernels off it; loss and logZ within LOSS_TOL
    of the plain version; the gradients within `parity.WIDE_GRAD_TOL` of it
    (each group relative to its largest entry); two calls bit-equal."""
    v, n_valid = 9001, 8999
    rng = np.random.default_rng(b * 1000 + h + 13)
    states = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(cuda_device)
    table = torch.from_numpy((0.5 * rng.normal(size=(v, h))).astype(np.float32)).to(cuda_device)
    a = torch.from_numpy(rng.integers(-1, v + 3, size=b)).to(cuda_device)
    d = torch.from_numpy(rng.uniform(0.5, 1.5, size=b).astype(np.float32)).to(cuda_device)
    mid = route == "mid"
    assert (ce.onchip_route(b, h), ce.mid_route(b, h), ce.wide_route(h)) == (
        route == "onchip", mid, route == "wide")
    counts = lambda: _fp32_mid_counts() + (ce.ce_grads.wide_launches, ce.ce_logz.wide_launches)
    before = counts()
    loss, logz = ce.ce_loss_logz(states, table, a, n_valid)
    loss2, logz2 = ce.ce_loss_logz(states, table, a, n_valid)
    ds, dt = ce.ce_grads(states, table, a, logz, d, n_valid)
    ds2, dt2 = ce.ce_grads(states, table, a, logz, d, n_valid)
    torch.cuda.synchronize()
    wide = route == "wide"
    assert counts() == (before[0] + 2 * mid, before[1] + 2 * mid, before[2], before[3],
                        before[4] + 2 * wide, before[5] + 2 * wide)
    assert torch.equal(loss, loss2) and torch.equal(logz, logz2)
    assert torch.equal(ds, ds2) and torch.equal(dt, dt2)
    want_loss, want_logz = ce.ce_loss_logz_plain(states, table, a, n_valid)
    torch.testing.assert_close(loss, want_loss, **LOSS_TOL)
    torch.testing.assert_close(logz, want_logz, **LOSS_TOL)
    errs = parity.grad_errors(ds, dt, *ce.ce_grads_plain(states, table, a, logz, d, n_valid), a, n_valid)
    assert max(errs.values()) <= parity.WIDE_GRAD_TOL, errs


def _bf16_tc_edges(cuda_device, b, v, h, n_valid, inputs, route):
    """The body of the on-chip and middle routes' edge tests; `route` names
    the wrappers' counter of the route's launches."""
    states, table, a, d = _onchip_tc_inputs(b, v, h, n_valid, inputs, cuda_device)
    bf16 = "bfloat16"
    counts = lambda: (getattr(ce.ce_logz, route), ce.ce_logz.bf16_launches,
                      getattr(ce.ce_grads, route), ce.ce_grads.bf16_launches)
    before = counts()
    loss, logz = ce.ce_loss_logz(states, table, a, n_valid, dtype=bf16)
    ds, dt = ce.ce_grads(states, table, a, logz, d, n_valid, dtype=bf16)
    ds2, dt2 = ce.ce_grads(states, table, a, logz, d, n_valid, dtype=bf16)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 2, before[3] + 2)
    assert torch.equal(ds, ds2) and torch.equal(dt, dt2)
    want_loss, want_logz = ce.ce_loss_logz_plain(states, table, a, n_valid, bf16=True)
    if n_valid == 0:
        assert torch.equal(logz, torch.full_like(logz, float("-inf")))
    torch.testing.assert_close(loss, want_loss, **LOSS_TOL)
    torch.testing.assert_close(logz, want_logz, **LOSS_TOL)
    off = (a < 0) | (a >= n_valid)
    assert torch.equal(loss[off], logz[off])
    assert not dt[n_valid:].any()
    exact = inputs == "exact"
    want = (ce.ce_grads_plain(states, table, a, logz, d, n_valid, bf16=True) if exact
            else parity.ce_grads_bf16_in_order(states, table, a, logz, d, n_valid))
    if n_valid == 0:
        assert torch.equal(ds, want[0]) and not dt.any()
    else:
        errs = parity.grad_errors(ds, dt, *want, a, n_valid)
        assert max(errs.values()) <= (parity.BF16_GRAD_TOL if exact else parity.BF16_WIDE_GRAD_TOL), errs
    if exact and n_valid > 0:
        control = parity.grad_errors(*ce.ce_grads(states, table, a, logz, d, n_valid), *want, a,
                                     n_valid)
        assert control["ds"] > parity.BF16_GRAD_TOL, control
        other = ~parity.answer_rows(a, v, n_valid)
        assert not other.any() or control["dT other rows"] > parity.BF16_GRAD_TOL, control
    _, none_dt = ce.ce_grads(states, table, torch.full_like(a, -1), logz, d, n_valid, dtype=bf16)
    assert parity.one_hot_excess(dt, none_dt, states, a, d, n_valid) <= 1.0
    if inputs == "normal" and bool(((a >= 0) & (a < n_valid)).any()):
        assert parity.one_hot_excess(dt, none_dt, states, a, d, n_valid, round_states=True) > 1.0
    s = states.clone().requires_grad_()
    t = table.clone().requires_grad_()
    auto = ce.streaming_softmax_ce(s, t, a, n_valid, dtype=bf16)
    (auto * d).sum().backward()
    assert torch.equal(auto.detach(), loss)
    assert torch.equal(s.grad, ds) and torch.equal(t.grad, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,route", [
    (256, 64, "onchip"), (257, 64, "sweep"), (256, 68, "mid"), (1, 4, "onchip"), (255, 48, "onchip"),
    (64, 128, "mid"), (256, 256, "mid"), (257, 128, "sweep"), (256, 260, "wide"),
])
def test_cuda_ce_bf16_onchip_tc_route_boundary(cuda_device, b, h, route):
    """The bf16 form on both sides of the on-chip route's bounds (B <= 256,
    H <= 64), the middle route's (B <= 256, 64 < H <= 256) and the wide
    route's (H > 256): ce_loss_logz and ce_grads take the on-chip
    tensor-core kernels (ce_fwd_onchip_tc_kernel, ce_bwd_onchip_tc_kernel:
    an on-chip bf16 launch), the middle route's (ce_fwd_mid_tc_kernel,
    ce_bwd_mid_tc_kernel: a middle-route bf16 launch), the wide route's, or
    past B = 256 the sweeps' bf16 form; loss and logZ within LOSS_TOL; the
    gradients at the kernel's logZ within `parity.BF16_GRAD_TOL` of the
    plain bf16 version on the sweeps, and on the tensor cores, which sum in
    their own order, within `parity.BF16_WIDE_GRAD_TOL` of
    `parity.ce_grads_bf16_in_order`; two calls bit-equal."""
    v, n_valid = 9001, 8999
    rng = np.random.default_rng(b * 1000 + h + 11)
    states = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(cuda_device)
    table = torch.from_numpy((0.5 * rng.normal(size=(v, h))).astype(np.float32)).to(cuda_device)
    a = torch.from_numpy(rng.integers(-1, v + 3, size=b)).to(cuda_device)
    d = torch.from_numpy(rng.uniform(0.5, 1.5, size=b).astype(np.float32)).to(cuda_device)
    bf16 = "bfloat16"
    onchip, mid, wide = route == "onchip", route == "mid", route == "wide"
    assert (ce.onchip_route(b, h), ce.mid_route(b, h), ce.wide_route(h)) == (onchip, mid, wide)
    counts = lambda: (ce.ce_logz.onchip_launches, ce.ce_logz.bf16_launches,
                      ce.ce_grads.onchip_launches, ce.ce_grads.bf16_launches,
                      ce.ce_logz.mid_launches, ce.ce_grads.mid_launches,
                      ce.ce_logz.wide_launches, ce.ce_grads.wide_launches)
    before = counts()
    loss, logz = ce.ce_loss_logz(states, table, a, n_valid, dtype=bf16)
    loss2, logz2 = ce.ce_loss_logz(states, table, a, n_valid, dtype=bf16)
    ds, dt = ce.ce_grads(states, table, a, logz, d, n_valid, dtype=bf16)
    ds2, dt2 = ce.ce_grads(states, table, a, logz, d, n_valid, dtype=bf16)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 2 * onchip, before[1] + 2, before[2] + 2 * onchip, before[3] + 2,
                        before[4] + 2 * mid, before[5] + 2 * mid, before[6] + 2 * wide,
                        before[7] + 2 * wide)
    assert torch.equal(loss, loss2) and torch.equal(logz, logz2)
    assert torch.equal(ds, ds2) and torch.equal(dt, dt2)
    want_loss, want_logz = ce.ce_loss_logz_plain(states, table, a, n_valid, bf16=True)
    torch.testing.assert_close(loss, want_loss, **LOSS_TOL)
    torch.testing.assert_close(logz, want_logz, **LOSS_TOL)
    if route != "sweep":
        want, tol = parity.ce_grads_bf16_in_order(states, table, a, logz, d, n_valid), parity.BF16_WIDE_GRAD_TOL
    else:
        want, tol = ce.ce_grads_plain(states, table, a, logz, d, n_valid, bf16=True), parity.BF16_GRAD_TOL
    errs = parity.grad_errors(ds, dt, *want, a, n_valid)
    assert max(errs.values()) <= tol, errs

# the CE kernels' wide routes (H > 256): H just past the older routes (no
# multiple of 128), 384 with B over one group of 256 p rows, 512 and 1024
WIDE_CE_SHAPES = [(37, 5000, 260, 4990), (300, 7001, 384, 7000), (256, 9000, 512, 9000),
                  (200, 3001, 512, 3001), (5, 3001, 1024, 2990)]
# the wide cases' fp32 gradients, relative to each group's largest |plain|
# entry (parity.WIDE_GRAD_TOL, chip_smoke.py's GRAD_TOL)
WIDE_GRAD_TOL = parity.WIDE_GRAD_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,v,h,n_valid", WIDE_CE_SHAPES)
def test_cuda_ce_wide_routes_match_plain(cuda_device, b, v, h, n_valid, dtype):
    """ce_loss_logz, gold_rows and ce_grads on the wide routes, in both
    forms, on raw int64 answers (-1, >= n_valid, >= V, item 0, repeats):
    the route the shape names (ce_loss_logz and ce_grads on a tensor-core
    kernel in both forms); loss and logZ within LOSS_TOL; the
    gather bit-equal; two ce_grads calls bit-equal; the gradients within
    WIDE_GRAD_TOL of the plain version (fp32) or, in the bf16 form, within
    `parity.BF16_WIDE_GRAD_TOL` of `parity.ce_grads_bf16_in_order` at the
    kernel's logZ, which the fp32 form must fail; the fused ds bit-equal to
    the unfused composition; dT's one-hot term on the unrounded states."""
    rng = np.random.default_rng(b + h + 2)
    states = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(cuda_device)
    table = torch.from_numpy((0.25 * rng.normal(size=(v, h))).astype(np.float32)).to(cuda_device)
    answers = rng.integers(1, n_valid, size=b)
    special = [answers[0], answers[0], 0, -1, n_valid, v, v + 7]
    answers[: min(b, len(special))] = special[:b]
    a = torch.from_numpy(answers).to(cuda_device)
    d = torch.from_numpy(rng.uniform(0.5, 1.5, size=b).astype(np.float32)).to(cuda_device)
    bf16 = dtype is not None
    assert ce.wide_route(h) and not ce.onchip_route(b, h)
    counts = lambda: (ce.ce_logz.wide_launches, ce.ce_grads.wide_launches, ce.gold_rows.launches,
                      ce.ce_logz.bf16_launches, ce.ce_grads.bf16_launches)
    before = counts()
    loss, logz = ce.ce_loss_logz(states, table, a, n_valid, dtype=dtype)
    rows = ce.gold_rows(table, ce.map_answers(a, n_valid))
    ds, dt = ce.ce_grads(states, table, a, logz, d, n_valid, dtype=dtype)
    ds2, dt2 = ce.ce_grads(states, table, a, logz, d, n_valid, dtype=dtype)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 2, before[2] + 1, before[3] + bf16,
                        before[4] + 2 * bf16)
    assert torch.equal(ds, ds2) and torch.equal(dt, dt2)
    assert torch.equal(rows, ce.gold_rows_plain(table, ce.map_answers(a, n_valid)))
    want_loss, want_logz = ce.ce_loss_logz_plain(states, table, a, n_valid, bf16=bf16)
    torch.testing.assert_close(loss, want_loss, **LOSS_TOL)
    torch.testing.assert_close(logz, want_logz, **LOSS_TOL)
    off = (a < 0) | (a >= n_valid)
    assert torch.equal(loss[off], logz[off])
    assert not dt[n_valid:].any()
    if bf16:
        want = parity.ce_grads_bf16_in_order(states, table, a, logz, d, n_valid)
        errs = parity.grad_errors(ds, dt, *want, a, n_valid)
        assert max(errs.values()) <= parity.BF16_WIDE_GRAD_TOL
        control = parity.grad_errors(*ce.ce_grads(states, table, a, logz, d, n_valid), *want, a,
                                     n_valid)
        assert min(control["ds"], control["dT other rows"]) > parity.BF16_WIDE_GRAD_TOL
    else:
        want = ce.ce_grads_plain(states, table, a, logz, d, n_valid)
        assert max(parity.grad_errors(ds, dt, *want, a, n_valid).values()) <= WIDE_GRAD_TOL
    ds_sum, none_dt = ce.ce_grads(states, table, torch.full_like(a, -1), logz, d, n_valid,
                                  dtype=dtype)
    assert torch.equal(ds, ds_sum - d[:, None] * rows)
    assert parity.one_hot_excess(dt, none_dt, states, a, d, n_valid) <= 1.0
    assert parity.one_hot_excess(dt, none_dt, states, a, d, n_valid, round_states=True) > 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("b,v,h,n_valid", [
    (37, 5000, 260, 4990), (300, 7001, 260, 6990), (37, 9000, 512, 8990), (300, 7001, 512, 7000),
    (37, 3001, 1024, 2990), (300, 3001, 1024, 2999),
])
def test_cuda_ce_wide_bf16_exact_logits(cuda_device, b, v, h, n_valid):
    """The tensor-core kernel (ce_grads' bf16 form on the wide route) on
    `parity.exact_logit_case` inputs, whose logits are exact in fp32 in any
    summation order: within `parity.BF16_GRAD_TOL` of
    `parity.ce_grads_bf16_in_order` at the kernel's logZ, which the fp32
    form (here apart only by not rounding p) must fail; one tensor-core
    launch a call; two calls bit-equal; the fused ds bit-equal to the
    unfused composition; dT past n_valid zero; dT's one-hot term on the
    unrounded states (the states are bf16-exact here, so the rounded-states
    control cannot fail and is not asked to)."""
    states, table, a, d = parity.exact_logit_case(b, v, h, n_valid, seed=b + h, device=cuda_device)
    bf16 = "bfloat16"
    _, logz = ce.ce_loss_logz(states, table, a, n_valid, dtype=bf16)
    before = (ce.ce_grads.wide_launches, ce.ce_grads.bf16_launches)
    ds, dt = ce.ce_grads(states, table, a, logz, d, n_valid, dtype=bf16)
    ds2, dt2 = ce.ce_grads(states, table, a, logz, d, n_valid, dtype=bf16)
    torch.cuda.synchronize()
    assert (ce.ce_grads.wide_launches, ce.ce_grads.bf16_launches) == (before[0] + 2, before[1] + 2)
    assert torch.equal(ds, ds2) and torch.equal(dt, dt2)
    assert not dt[n_valid:].any()
    want = parity.ce_grads_bf16_in_order(states, table, a, logz, d, n_valid)
    assert max(parity.grad_errors(ds, dt, *want, a, n_valid).values()) <= parity.BF16_GRAD_TOL
    control = parity.grad_errors(*ce.ce_grads(states, table, a, logz, d, n_valid), *want, a, n_valid)
    assert min(control["ds"], control["dT other rows"]) > parity.BF16_GRAD_TOL
    assert ce.ce_grads.wide_launches == before[0] + 3  # the fp32 control took its own tensor-core kernel
    rows = ce.gold_rows(table, ce.map_answers(a, n_valid))
    ds_sum, none_dt = ce.ce_grads(states, table, torch.full_like(a, -1), logz, d, n_valid,
                                  dtype=bf16)
    assert torch.equal(ds, ds_sum - d[:, None] * rows)
    assert parity.one_hot_excess(dt, none_dt, states, a, d, n_valid) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,v,h,n_valid", [
    (1, 1, 260, 1), (3, 257, 512, 256), (256, 255, 288, 0), (513, 640, 512, 600),
])
def test_cuda_ce_grads_tc_edge_shapes(cuda_device, b, v, h, n_valid, dtype):
    """The tensor-core kernels (ce_grads' wide route, both forms) at edge
    shapes, on `parity.exact_logit_case` inputs: one catalog row, a tile
    one row past 256, no valid column (n_valid = 0: ds is the gold term
    alone and dT zero), three groups of batch rows; the bf16 form within
    `parity.BF16_GRAD_TOL` of `parity.ce_grads_bf16_in_order`, the fp32
    form within WIDE_GRAD_TOL of the plain version; two calls bit-equal,
    dT past n_valid zero."""
    states, table, a, d = parity.exact_logit_case(b, v, h, max(n_valid, 2), seed=v + h,
                                                  device=cuda_device)
    logz = ce.ce_logz(states, table, n_valid, dtype=dtype)
    before = ce.ce_grads.wide_launches
    ds, dt = ce.ce_grads(states, table, a, logz, d, n_valid, dtype=dtype)
    ds2, dt2 = ce.ce_grads(states, table, a, logz, d, n_valid, dtype=dtype)
    torch.cuda.synchronize()
    assert ce.ce_grads.wide_launches == before + 2
    assert torch.equal(ds, ds2) and torch.equal(dt, dt2)
    assert not dt[n_valid:].any()
    if dtype is None:
        want, tol = ce.ce_grads_plain(states, table, a, logz, d, n_valid), WIDE_GRAD_TOL
    else:
        want = parity.ce_grads_bf16_in_order(states, table, a, logz, d, n_valid)
        tol = parity.BF16_GRAD_TOL
    if n_valid == 0:
        assert torch.equal(ds, want[0]) and not dt.any()
    else:
        assert max(parity.grad_errors(ds, dt, *want, a, n_valid).values()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,onchip", [
    (256, 64, True), (257, 64, False), (255, 64, True), (1, 64, True),
    (256, 60, True), (64, 128, False), (64, 64, True),
    (256, 256, False), (256, 260, False), (257, 260, False), (256, 68, False), (257, 128, False),
])
def test_cuda_ce_grads_route_boundary(cuda_device, b, h, onchip):
    """ce_grads on both sides of the on-chip route's bounds (B <= 256,
    H <= 64) and of the wide route's (H > 256): the route the shape names
    (past H = 256 the fp32 form's tensor-core kernel; on the middle route's
    shapes the fp32 form's 3xTF32 kernel ce_bwd_wide_tf32_kernel on its
    middle-route counter, no bf16 middle-route launch),
    the plain version's gradients within the tolerance, and two calls
    bit-equal. Past H = 256 the tolerance is the wide route's, WIDE_GRAD_TOL
    of each group's largest entry: at these inputs the plain fp32 version
    itself misses GRAD_TOL elementwise against an fp64 reference (PERF.md),
    and the 3xTF32 kernel comes nearer that reference than it does; on the
    middle route the gradients are held by `_held_as_3xtf32`, which checks
    the same two things."""
    v, n_valid = 9001, 8999
    rng = np.random.default_rng(b * 1000 + h)
    states = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(cuda_device)
    table = torch.from_numpy((0.5 * rng.normal(size=(v, h))).astype(np.float32)).to(cuda_device)
    answers = rng.integers(0, v + 3, size=b)  # some at or past n_valid
    answers[: min(b, 4)] = answers[0]  # repeats
    a = torch.from_numpy(answers).to(cuda_device)
    d = torch.from_numpy(rng.uniform(0.5, 1.5, size=b).astype(np.float32)).to(cuda_device)
    logz = ce.ce_logz(states, table, n_valid)
    assert ce.onchip_route(b, h) == onchip
    wide = h > 256
    assert ce.wide_route(h) == wide
    counts = lambda: (ce.ce_grads.launches, ce.ce_grads.onchip_launches,
                      ce.ce_grads.wide_launches, ce.ce_grads.mid_launches,
                      ce.ce_grads.mid_tf32_launches)
    before = counts()
    ds, dt = ce.ce_grads(states, table, a, logz, d, n_valid)
    ds2, dt2 = ce.ce_grads(states, table, a, logz, d, n_valid)
    torch.cuda.synchronize()
    mid = b <= 256 and 64 < h <= 256
    assert ce.mid_route(b, h) == mid
    assert counts() == (before[0] + 2, before[1] + 2 * onchip, before[2] + 2 * wide, before[3],
                        before[4] + 2 * mid)
    assert torch.equal(ds, ds2) and torch.equal(dt, dt2)
    want_ds, want_dt = ce.ce_grads_plain(states, table, a, logz, d, n_valid)
    if wide:
        errs = parity.grad_errors(ds, dt, want_ds, want_dt, a, n_valid)
        assert max(errs.values()) <= WIDE_GRAD_TOL, errs
    elif mid:
        _held_as_3xtf32(ds, dt, want_ds, want_dt, states, table, a, logz, d, n_valid)
    else:
        torch.testing.assert_close(ds, want_ds, **GRAD_TOL)
        torch.testing.assert_close(dt, want_dt, **GRAD_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("b,h,onchip", [
    (1, 64, True), (255, 64, True), (256, 64, True), (257, 64, False),
    (256, 48, True), (256, 128, False), (256, 256, False), (256, 260, False), (1, 260, False),
    (256, 68, False), (257, 128, False), (1, 192, False),
])
def test_cuda_ce_logz_route_boundary(cuda_device, b, h, onchip, dtype):
    """ce_loss_logz on both sides of the on-chip route's bounds (B <= 256,
    H <= 64), of the middle route's (B <= 256, 64 < H <= 256: in the bf16
    form ce_fwd_mid_tc_kernel, a middle-route launch; the fp32 form's
    sweep) and of the wide route's (H > 256), in both forms: the route
    the shape names (past H = 256 a tensor-core kernel in either form),
    loss and logZ within the tolerance of the plain version, and two calls
    bit-equal."""
    v, n_valid = 9001, 8999
    rng = np.random.default_rng(b * 1000 + h + 7)
    states = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(cuda_device)
    table = torch.from_numpy((0.5 * rng.normal(size=(v, h))).astype(np.float32)).to(cuda_device)
    a = torch.from_numpy(rng.integers(-1, v + 3, size=b)).to(cuda_device)  # some off the catalog
    bf16 = dtype is not None
    assert ce.onchip_route(b, h) == onchip
    wide = h > 256
    assert ce.wide_route(h) == wide
    mid = bf16 and b <= 256 and 64 < h <= 256
    assert ce.mid_route(b, h) == (b <= 256 and 64 < h <= 256)
    counts = lambda: (ce.ce_logz.launches, ce.ce_logz.onchip_launches, ce.ce_logz.wide_launches,
                      ce.ce_logz.bf16_launches, ce.ce_logz.mid_launches)
    before = counts()
    loss, logz = ce.ce_loss_logz(states, table, a, n_valid, dtype=dtype)
    loss2, logz2 = ce.ce_loss_logz(states, table, a, n_valid, dtype=dtype)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 2, before[1] + 2 * onchip, before[2] + 2 * wide,
                        before[3] + 2 * bf16, before[4] + 2 * mid)
    assert torch.equal(loss, loss2) and torch.equal(logz, logz2)
    want_loss, want_logz = ce.ce_loss_logz_plain(states, table, a, n_valid, bf16=bf16)
    torch.testing.assert_close(loss, want_loss, **LOSS_TOL)
    torch.testing.assert_close(logz, want_logz, **LOSS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"], ids=["fp32", "bf16"])
@pytest.mark.parametrize("inputs", ["exact", "normal"])
@pytest.mark.parametrize("b,v,h,n_valid", [
    (1, 1, 260, 1), (3, 257, 512, 256), (256, 255, 288, 0), (513, 640, 512, 600),
    (37, 3001, 1024, 2990),
    # test_cuda_ce_wide_bf16_exact_logits' shapes
    (37, 5000, 260, 4990), (300, 7001, 260, 6990), (37, 9000, 512, 8990), (300, 7001, 512, 7000),
    (37, 3001, 1024, 2990), (300, 3001, 1024, 2999),
])
def test_cuda_ce_logz_tc_edge_shapes(cuda_device, b, v, h, n_valid, inputs, dtype):
    """The tensor-core forward kernels (ce_loss_logz past H = 256, the
    fp32 form's in 3xTF32 and the bf16 form's) at edge shapes: one catalog
    row, a tile one row past 256, no valid column (logZ -inf), three
    groups of batch rows, H off the 64-column step, on
    `parity.exact_logit_case` inputs (every logit exact in any summation
    order) and on normal ones: one wide launch a call in the form asked
    for; loss and logZ within LOSS_TOL of the plain version of that form;
    two calls bit-equal; ce_logz equal to ce_loss_logz's logZ; gold 0 for
    answers off the catalog. On the exact inputs the fp32 form's loss and
    logZ are bit-equal to the bf16 form's: every operand is TF32- and
    bf16-exact there and every partial sum exact, so both kernels hold the
    same logits and fold them by one function in one order."""
    if inputs == "exact":
        states, table, a, _ = parity.exact_logit_case(b, v, h, max(n_valid, 2), seed=b + v + h,
                                                      device=cuda_device)
    else:
        rng = np.random.default_rng(b + v + h)
        states = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(cuda_device)
        table = torch.from_numpy((0.25 * rng.normal(size=(v, h))).astype(np.float32)).to(cuda_device)
        a = torch.from_numpy(rng.integers(-1, v + 3, size=b)).to(cuda_device)
    bf16 = dtype is not None
    assert ce.wide_route(h)
    before = (ce.ce_logz.wide_launches, ce.ce_logz.bf16_launches)
    loss, logz = ce.ce_loss_logz(states, table, a, n_valid, dtype=dtype)
    loss2, logz2 = ce.ce_loss_logz(states, table, a, n_valid, dtype=dtype)
    alone = ce.ce_logz(states, table, n_valid, dtype=dtype)
    torch.cuda.synchronize()
    assert (ce.ce_logz.wide_launches, ce.ce_logz.bf16_launches) == (before[0] + 3,
                                                                   before[1] + 3 * bf16)
    assert torch.equal(loss, loss2) and torch.equal(logz, logz2) and torch.equal(alone, logz)
    if inputs == "exact" and not bf16:
        loss_b, logz_b = ce.ce_loss_logz(states, table, a, n_valid, dtype="bfloat16")
        assert torch.equal(loss, loss_b) and torch.equal(logz, logz_b)
    want_loss, want_logz = ce.ce_loss_logz_plain(states, table, a, n_valid, bf16=bf16)
    if n_valid == 0:
        assert torch.equal(logz, torch.full_like(logz, float("-inf")))
    torch.testing.assert_close(logz, want_logz, **LOSS_TOL)
    if inputs == "exact":
        torch.testing.assert_close(loss, want_loss, **LOSS_TOL)
    else:
        # loss = logZ - gold cancels where the answer's logit dominates the
        # row (0.056 of a logZ near 8 at (513, 640, 512, 600)), and two fp32
        # sums of 512 products round apart by ~1e-5 there: LOSS_TOL is
        # applied at the scale of the terms, |logZ|, as logZ is judged
        finite = torch.isfinite(want_loss)
        assert torch.equal(torch.isfinite(loss), finite)
        assert torch.equal(loss[~finite], want_loss[~finite])
        err = (loss - want_loss)[finite].abs()
        assert bool((err <= LOSS_TOL["atol"] + LOSS_TOL["rtol"] * want_logz[finite].abs()).all())
    off = (a < 0) | (a >= n_valid)
    assert torch.equal(loss[off], logz[off])


@pytest.mark.cuda
@pytest.mark.parametrize("b,v,h,k,n_valid,all_seen,onchip", [
    (256, 64 * 150 + 17, 64, 32, 64 * 150 + 5, True, True),
    (256, 9601, 64, 33, 9601, False, False),
    (1, 5003, 64, 1, 5003, False, True),
    (257, 5003, 64, 20, 4990, False, False),
    (255, 12101, 48, 20, 12090, True, True),
    (64, 20011, 64, 20, 20011, False, True),
])
def test_cuda_rank_route_boundary(cuda_device, b, v, h, k, n_valid, all_seen, onchip):
    """The rank kernel on both sides of the on-chip route's bounds (B <=
    256, H <= 64, k <= 32), with V off the 64-column tile, n_valid < V and
    an all-seen row: the route the shape names, the plain version's values
    and ids, and, on the on-chip route, values and ids bit-equal to the
    older route's on the same inputs."""
    states, table, seen = _rank_inputs(b, v, h, seed=b + k, integer=False)
    s, t = torch.from_numpy(states).to(cuda_device), torch.from_numpy(table).to(cuda_device)
    bm = rank.seen_ids_to_bitmask(torch.from_numpy(rank.dedupe_seen_rows(seen)).to(cuda_device), v)
    if all_seen:
        bm[b // 2] = -1
        seen = np.concatenate([seen, np.zeros((b, v), np.int32)], axis=1)
        seen[b // 2, 20:] = np.arange(v)
    assert rank.onchip_route(b, h, k) == onchip
    before = (rank.streaming_masked_topk.launches, rank.streaming_masked_topk.onchip_launches)
    got_v, got_i = rank.streaming_masked_topk(s, t, bm, k=k, n_valid=n_valid)
    torch.cuda.synchronize()
    assert (rank.streaming_masked_topk.launches, rank.streaming_masked_topk.onchip_launches) == (
        before[0] + 1, before[1] + onchip)
    want_v, want_i = rank.streaming_masked_topk_plain(s, t, bm, k=k, n_valid=n_valid)
    torch.testing.assert_close(got_v, want_v, rtol=RTOL, atol=ATOL)
    logits = _masked_logits(states, table, seen, n_valid)
    by_score = np.take_along_axis(logits, got_i.cpu().numpy().astype(np.int64), axis=1)
    np.testing.assert_allclose(by_score, want_v.cpu().numpy(), rtol=RTOL, atol=ATOL)
    if all_seen:  # every valid score is 0.0: the first k ids, in order
        assert got_i[b // 2].tolist() == list(range(min(k, n_valid)))
    if onchip:
        old_v, old_i = rank._launch(s, t, bm, k, n_valid, allow_onchip=False)
        torch.cuda.synchronize()
        assert torch.equal(got_v, old_v) and torch.equal(got_i, old_i)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,k,tc", [
    (256, 256, 20, False), (256, 260, 20, True), (256, 512, 32, True), (256, 512, 33, False),
    (1, 512, 20, True), (256, 512, 20, True), (257, 512, 20, True), (300, 260, 32, True),
    (300, 256, 32, False),
])
def test_cuda_rank_tc_route_boundary(cuda_device, b, h, k, tc):
    """The tensor-core route's bounds (H > 256, k <= 32, any B): the route
    the shape names, its counter, and on integer inputs (exact scores, many
    ties) values and ids bit-equal to the plain version and to the older
    route on the same inputs (n_valid < V, an all-seen row). At H = 256 and
    B <= 256 the middle route runs, so the older route is asked for with
    both tensor-core routes off."""
    v, n_valid = 3001, 2990
    states, table, seen = _rank_inputs(b, v, h, seed=b + h + k, integer=True)
    s, t = torch.from_numpy(states).to(cuda_device), torch.from_numpy(table).to(cuda_device)
    bm = torch.from_numpy(rank.build_seen_bitmask(seen, v)).to(cuda_device)
    bm[b // 2] = -1
    assert rank.tc_route(b, h, k) == tc and not rank.onchip_route(b, h, k)
    f = rank.streaming_masked_topk
    before = (f.launches, f.tc_launches, f.wide_launches)
    got_v, got_i = rank.streaming_masked_topk(s, t, bm, k=k, n_valid=n_valid)
    torch.cuda.synchronize()
    assert (f.launches, f.tc_launches, f.wide_launches) == (
        before[0] + 1, before[1] + tc, before[2] + (not tc and rank.wide_route(h, k)))
    want_v, want_i = rank.streaming_masked_topk_plain(s, t, bm, k=k, n_valid=n_valid)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert got_i[b // 2].tolist() == list(range(k)) and not got_v[b // 2].any()
    old_v, old_i = rank._launch(s, t, bm, k, n_valid, allow_tc=False, allow_mid=False)
    torch.cuda.synchronize()
    assert torch.equal(got_v, old_v) and torch.equal(got_i, old_i)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,k,mid", [
    (256, 64, 20, False), (256, 68, 20, True), (256, 256, 32, True), (256, 256, 33, False),
    (256, 260, 20, False), (257, 256, 20, False), (257, 128, 32, False), (1, 256, 20, True),
    (16, 128, 20, True), (255, 192, 1, True),
])
def test_cuda_rank_mid_route_boundary(cuda_device, b, h, k, mid):
    """The middle route's bounds (B <= 256, 64 < H <= 256, k <= 32): the
    route the shape names, its counter (and no other route's), and on
    integer inputs (exact scores, many ties) values and ids bit-equal to
    the plain version and to the older route on the same inputs (n_valid
    < V, V off the 128-column tile, an all-seen row)."""
    v, n_valid = 3001, 2990
    states, table, seen = _rank_inputs(b, v, h, seed=b + h + k, integer=True)
    s, t = torch.from_numpy(states).to(cuda_device), torch.from_numpy(table).to(cuda_device)
    bm = torch.from_numpy(rank.build_seen_bitmask(seen, v)).to(cuda_device)
    bm[b // 2] = -1
    assert rank.mid_route(b, h, k) == mid and not (mid and rank.tc_route(b, h, k))
    f = rank.streaming_masked_topk
    before = (f.launches, f.mid_launches, f.tc_launches, f.onchip_launches)
    got_v, got_i = rank.streaming_masked_topk(s, t, bm, k=k, n_valid=n_valid)
    torch.cuda.synchronize()
    assert (f.launches, f.mid_launches) == (before[0] + 1, before[1] + mid)
    if mid:
        assert (f.tc_launches, f.onchip_launches) == before[2:]
    want_v, want_i = rank.streaming_masked_topk_plain(s, t, bm, k=k, n_valid=n_valid)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert got_i[b // 2].tolist() == list(range(k)) and not got_v[b // 2].any()
    old_v, old_i = rank._launch(s, t, bm, k, n_valid, allow_onchip=False, allow_tc=False,
                                allow_mid=False)
    torch.cuda.synchronize()
    assert torch.equal(got_v, old_v) and torch.equal(got_i, old_i)


@pytest.mark.cuda
@pytest.mark.parametrize("seen_value", [0.0, float("-inf")], ids=["eval", "serving"])
@pytest.mark.parametrize("b,v,h,k,n_valid,integer", [
    (256, 20011, 256, 20, 20006, False),
    (256, 40009, 128, 32, 40000, False),
    (1, 12101, 256, 20, 12101, False),
    (37, 5003, 68, 32, 4990, True),  # H off the 32-column step
    (200, 5003, 192, 1, 5003, True),
    (5, 300, 256, 20, 10, False),  # fewer valid items than k
    (9, 4099, 128, 20, 4099, True),
    (256, 70001, 256, 20, 70001, True),
])
def test_cuda_rank_mid_matches_plain_and_the_older_route(cuda_device, b, v, h, k, n_valid, integer,
                                                         seen_value):
    """The middle route (rank_mid_tf32_kernel, wgmma in 3xTF32) in both
    modes, with an all-seen row where B > 1: on integer inputs values and
    ids bit-equal to the plain version and to the older route; on float
    inputs (the table scaled by sqrt(64 / H), so that the scores keep H =
    64's spread) values within RTOL/ATOL of both, each returned id checked
    by its plain score, no id twice in a row; two calls bit-equal; unfilled
    slots (-inf, 0)."""
    states, table, seen = _rank_inputs(b, v, h, seed=v + k + h, integer=integer)
    if not integer:
        table *= np.float32(np.sqrt(64 / h))
    s, t = torch.from_numpy(states).to(cuda_device), torch.from_numpy(table).to(cuda_device)
    bm = torch.from_numpy(rank.build_seen_bitmask(seen, v)).to(cuda_device)
    all_seen = b > 1
    if all_seen:
        bm[b // 2] = -1
    assert rank.mid_route(b, h, k)
    before = rank.streaming_masked_topk.mid_launches
    got_v, got_i = rank.streaming_masked_topk(s, t, bm, k=k, n_valid=n_valid, seen_value=seen_value)
    again_v, again_i = rank.streaming_masked_topk(s, t, bm, k=k, n_valid=n_valid,
                                                  seen_value=seen_value)
    old_v, old_i = rank._launch(s, t, bm, k, n_valid, allow_mid=False, seen_value=seen_value)
    want_v, want_i = rank.streaming_masked_topk_plain(s, t, bm, k=k, n_valid=n_valid,
                                                      seen_value=seen_value)
    torch.cuda.synchronize()
    assert rank.streaming_masked_topk.mid_launches == before + 2
    assert torch.equal(got_v, again_v) and torch.equal(got_i, again_i)
    finite = torch.isfinite(want_v)
    assert torch.equal(torch.isfinite(got_v), finite) and torch.equal(torch.isfinite(old_v), finite)
    assert (got_i[~finite] == 0).all()
    if all_seen and seen_value == 0.0:  # every valid score 0.0: the first ids, in order
        assert got_i[b // 2, :min(k, n_valid)].tolist() == list(range(min(k, n_valid)))
    elif all_seen:
        assert not finite[b // 2].any()
    if integer:
        assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
        assert torch.equal(got_v, old_v) and torch.equal(got_i, old_i)
        return
    torch.testing.assert_close(got_v, want_v, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got_v, old_v, rtol=RTOL, atol=ATOL)
    seen_all = np.concatenate([seen, np.zeros((b, v), np.int32)], axis=1)
    if all_seen:
        seen_all[b // 2, 20:] = np.arange(v)
    logits = _masked_logits(states, table, seen_all, n_valid)
    if seen_value != 0.0:  # serving: seen items (and item 0) never rank
        logits[np.arange(b)[:, None], seen_all] = -np.inf
        logits[:, 0] = -np.inf
    ids = got_i.cpu().numpy().astype(np.int64)
    by_score = np.take_along_axis(logits, ids, axis=1)
    fin = finite.cpu().numpy()
    np.testing.assert_allclose(by_score[fin], want_v.cpu().numpy()[fin], rtol=RTOL, atol=ATOL)
    for r in range(b):
        assert len(set(ids[r][fin[r]].tolist())) == int(fin[r].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("seen_value", [0.0, float("-inf")], ids=["eval", "serving"])
@pytest.mark.parametrize("b,v,h,k,n_valid,integer", [
    (300, 20011, 512, 20, 20006, False),  # two groups of 256 rows
    (1, 12101, 512, 20, 12101, False),
    (256, 40009, 512, 32, 40000, False),
    (37, 5003, 260, 32, 4990, True),  # H off the 16-column step
    (37, 5003, 1024, 1, 5003, True),
    (5, 300, 512, 20, 10, False),  # fewer valid items than k
    (9, 4099, 512, 20, 4099, True),
])
def test_cuda_rank_tc_matches_plain_and_the_older_route(cuda_device, b, v, h, k, n_valid, integer,
                                                        seen_value):
    """The tensor-core route (rank_wide_tf32_kernel, 3xTF32) in both modes,
    with an all-seen row where B > 1: on integer inputs values and ids bit-equal to the
    plain version and to the older route; on float inputs (the table scaled
    by sqrt(64 / H), so that the scores keep H = 64's spread) values within
    RTOL/ATOL of both, each returned id checked by its plain score, no id
    twice in a row; two calls bit-equal; unfilled slots (-inf, 0)."""
    states, table, seen = _rank_inputs(b, v, h, seed=v + k, integer=integer)
    if not integer:
        table *= np.float32(np.sqrt(64 / h))
    s, t = torch.from_numpy(states).to(cuda_device), torch.from_numpy(table).to(cuda_device)
    bm = torch.from_numpy(rank.build_seen_bitmask(seen, v)).to(cuda_device)
    all_seen = b > 1
    if all_seen:
        bm[b // 2] = -1
    assert rank.tc_route(b, h, k)
    before = rank.streaming_masked_topk.tc_launches
    got_v, got_i = rank.streaming_masked_topk(s, t, bm, k=k, n_valid=n_valid, seen_value=seen_value)
    again_v, again_i = rank.streaming_masked_topk(s, t, bm, k=k, n_valid=n_valid,
                                                  seen_value=seen_value)
    old_v, old_i = rank._launch(s, t, bm, k, n_valid, allow_tc=False, seen_value=seen_value)
    want_v, want_i = rank.streaming_masked_topk_plain(s, t, bm, k=k, n_valid=n_valid,
                                                      seen_value=seen_value)
    torch.cuda.synchronize()
    assert rank.streaming_masked_topk.tc_launches == before + 2
    assert torch.equal(got_v, again_v) and torch.equal(got_i, again_i)
    finite = torch.isfinite(want_v)
    assert torch.equal(torch.isfinite(got_v), finite) and torch.equal(torch.isfinite(old_v), finite)
    assert (got_i[~finite] == 0).all()
    if all_seen and seen_value == 0.0:  # every valid score 0.0: the first ids, in order
        assert got_i[b // 2, :min(k, n_valid)].tolist() == list(range(min(k, n_valid)))
    elif all_seen:
        assert not finite[b // 2].any()
    if integer:
        assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
        assert torch.equal(got_v, old_v) and torch.equal(got_i, old_i)
        return
    torch.testing.assert_close(got_v, want_v, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(got_v, old_v, rtol=RTOL, atol=ATOL)
    seen_all = np.concatenate([seen, np.zeros((b, v), np.int32)], axis=1)
    if all_seen:
        seen_all[b // 2, 20:] = np.arange(v)
    logits = _masked_logits(states, table, seen_all, n_valid)
    if seen_value != 0.0:  # serving: seen items (and item 0) never rank
        logits[np.arange(b)[:, None], seen_all] = -np.inf
        logits[:, 0] = -np.inf
    ids = got_i.cpu().numpy().astype(np.int64)
    by_score = np.take_along_axis(logits, ids, axis=1)
    fin = finite.cpu().numpy()
    np.testing.assert_allclose(by_score[fin], want_v.cpu().numpy()[fin], rtol=RTOL, atol=ATOL)
    for r in range(b):
        assert len(set(ids[r][fin[r]].tolist())) == int(fin[r].sum())


@pytest.mark.cuda
@pytest.mark.parametrize("direction", [1.0, -1.0], ids=["rising", "falling"])
def test_cuda_rank_onchip_scores_along_the_catalog(cuda_device, direction):
    """Scores that rise along the catalog give every later tile's 64 values
    to each row's list (the on-chip route's buffer overflows in every tile
    and the values go in one at a time); falling scores give it none. Both
    bit-equal to the older route and to the plain version (exact: the
    scores are multiples of 2^-14)."""
    b, v, h, k = 256, 64 * 40 + 9, 64, 32
    states = torch.ones((b, h), device=cuda_device) / h
    ramp = direction * torch.arange(v, device=cuda_device, dtype=torch.float32) / 16384
    table = ramp[:, None].expand(v, h).contiguous()
    bm = rank.seen_ids_to_bitmask(torch.zeros((b, 1), dtype=torch.int32, device=cuda_device), v)
    got_v, got_i = rank.streaming_masked_topk(states, table, bm, k=k)
    old_v, old_i = rank._launch(states, table, bm, k, v, allow_onchip=False)
    want_v, want_i = rank.streaming_masked_topk_plain(states, table, bm, k=k)
    torch.cuda.synchronize()
    assert rank.onchip_route(b, h, k)
    assert torch.equal(got_v, old_v) and torch.equal(got_i, old_i)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)


@pytest.mark.cuda
@pytest.mark.parametrize("b,v,k,onchip,h", [
    (37, 5000, 20, True, 64), (9, 300, 20, True, 64), (257, 30011, 20, False, 64),
    (64, 20011, 128, False, 64), (37, 5003, 128, False, 512), (9, 300, 20, False, 1024),
])
def test_cuda_rank_serving_mode_matches_plain(cuda_device, b, v, k, onchip, h):
    """The rank kernel with seen -> -inf (serving) on both routes, integer
    inputs (exact scores, many ties): values and ids bit-equal to the plain
    version and, on the on-chip route, to the older route; an all-seen row
    and rows with fewer than k unmasked items end in (-inf, 0) slots. The
    custom op on top gives them JAX's fill: 0, then the row's seen ids
    ascending, and on the card launches the kernel once. At H = 512 and
    1024 the older route runs in its wide form."""
    from bsarec_tpu_torch.ops import serving_topk

    states, table, seen = _rank_inputs(b, v, h, seed=v + k, integer=True)
    if v == 300:  # rows 1..4 see all but 10 items, row 0 every item
        seen = np.concatenate([seen, np.zeros((b, v), np.int32)], axis=1)
        seen[:5, :20] = 0
        seen[0, 20:] = np.arange(v)
        for r in range(1, 5):
            seen[r, 20:] = np.arange(v)
            seen[r, 20 + 11 * r:20 + 11 * r + 10] = 0
    s, t = torch.from_numpy(states).to(cuda_device), torch.from_numpy(table).to(cuda_device)
    sd = torch.from_numpy(seen).to(cuda_device)
    bm = serving_topk.seen_bitmask(sd, v)
    np.testing.assert_array_equal(bm.cpu().numpy(), rank.build_seen_bitmask(seen, v))
    assert rank.onchip_route(b, h, k) == onchip
    assert rank.wide_route(h, k) == (h > 256)
    got_v, got_i = rank.streaming_masked_topk(s, t, bm, k=k, seen_value=float("-inf"))
    want_v, want_i = rank.streaming_masked_topk_plain(s, t, bm, k=k, seen_value=float("-inf"))
    torch.cuda.synchronize()
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    if onchip:
        old_v, old_i = rank._launch(s, t, bm, k, v, allow_onchip=False, seen_value=float("-inf"))
        torch.cuda.synchronize()
        assert torch.equal(got_v, old_v) and torch.equal(got_i, old_i)
    if v == 300:
        assert torch.isinf(got_v[0]).all() and (got_i[0] == 0).all()
        assert torch.isfinite(got_v[1, :10]).all() and torch.isinf(got_v[1, 10:]).all()
    before = rank.streaming_masked_topk.launches
    op_v, op_i = serving_topk.serving_masked_topk(s, t, sd, k)
    torch.cuda.synchronize()
    assert rank.streaming_masked_topk.launches == before + 1
    cpu_v, cpu_i = serving_topk.serving_masked_topk(s.cpu(), t.cpu(), sd.cpu(), k)
    assert torch.equal(op_v.cpu(), cpu_v) and torch.equal(op_i.cpu(), cpu_i)
    if v == 300:
        masked = sorted(set(seen[1].tolist()) | {0})
        assert op_i[1, 10:].tolist() == masked[:k - 10]
        assert op_i[0].tolist() == list(range(k))


@pytest.mark.cuda
def test_cuda_serving_artifact_round_trip(cuda_device, tmp_path):
    """A small BSARec's bitmask artifact exported on the card ranks as its
    eager module and launches the rank kernel in the artifact; the same
    artifact loaded on the CPU ranks alike, and one exported on the CPU
    loads onto the card."""
    from bsarec_tpu_torch import serving
    from bsarec_tpu_torch.config import ModelConfig
    from bsarec_tpu_torch.models import build_model

    cfg = ModelConfig(model_type="bsarec", item_size=5000, num_users=2, max_seq_length=10,
                      hidden_size=16, num_hidden_layers=1, num_attention_heads=1, c=3, alpha=0.7)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 5000, size=(33, 10)).astype(np.int32)
    seen = rng.integers(0, 5000, size=(33, 12)).astype(np.int32)
    want = serving.load_scorer(serving.export_scorer(model, 5000, 10, 12,
                                                     str(tmp_path / "cpu.pt2"))["path"],
                               "cpu").topk(ids, None, seen)
    on_card = serving.load_scorer(str(tmp_path / "cpu.pt2"), cuda_device)
    before = rank.streaming_masked_topk.launches
    np.testing.assert_array_equal(on_card.topk(ids, None, seen), want)
    assert rank.streaming_masked_topk.launches == before + 1
    model.to(cuda_device)
    path = serving.export_scorer(model, 5000, 10, 12, str(tmp_path / "cuda.pt2"))["path"]
    for device in (cuda_device, "cpu"):
        np.testing.assert_array_equal(
            serving.load_scorer(path, device).topk(ids, None, seen), want)
    for b in (1, 257):
        got = serving.load_scorer(path, cuda_device).topk(ids[:1].repeat(b, 0))
        assert got.shape == (b, 20)


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype,offset,rate", [
    (256 * 50 * 64, torch.float32, 0, 0.5),
    (256 * 2 * 50 * 50, torch.float32, 0, 0.5),
    (4097, torch.float32, 1, 0.2),  # a misaligned view, a ragged last group
    (3, torch.bfloat16, 0, 0.9),
    (1, torch.float32, 0, 0.5),
    (70001, torch.bfloat16, 3, 0.2),
])
def test_cuda_dropout_kernel_matches_plain(cuda_device, n, dtype, offset, rate):
    """The fused dropout kernel gives the plain version's values bit for
    bit, and the backward regenerates the forward's mask."""
    seeds = torch.tensor([123456789, 4000000000], dtype=torch.int64, device=cuda_device)
    base = torch.randn(n + offset, generator=torch.Generator().manual_seed(n)).to(dtype)
    x = base.to(cuda_device)[offset:]
    before = fd.fused_dropout.launches
    got = fd.dropout_apply(x, seeds, rate, 7)
    torch.cuda.synchronize()
    assert fd.fused_dropout.launches == before + 1
    assert torch.equal(got, fd.fused_dropout_plain(x, seeds, rate, 7))
    assert torch.equal(got.cpu(), fd.fused_dropout_plain(x.cpu(), seeds.cpu(), rate, 7))
    xg = x.clone().requires_grad_()
    y = fd.fused_dropout(xg, rate, seeds, 7)
    y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    assert torch.equal(y.detach(), got)
    assert torch.equal(xg.grad, fd.fused_dropout_plain(torch.ones_like(x), seeds, rate, 7))


# the zoo's step on the card against the CPU step: item counts that make
# every CE model's table V mod 64 == 1 (BERT4Rec adds its [mask] row), the
# CLI's widths (Caser's fc_dropout site is then [B, 4 * 64 + 8 * 50] =
# [B, 656]), dropout 0.5 on the fused kernel with the same seeds on both
# sides (the CPU runs its plain version, which gives the kernel's bits)
ZOO_ITEMS = {"bert4rec": 4096, "fmlprec": 4097, "gru4rec": 4097, "caser": 4097,
             "duorec": 4097, "fearec": 4097}
ZOO_B, ZOO_LR, ADAM_EPS = 64, 5e-4, 1e-8


def _zoo_batch(item_size, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, item_size, size=(ZOO_B, 50))
    for r, pad in enumerate(rng.integers(0, 45, size=ZOO_B)):
        ids[r, :pad] = 0
    return tuple(torch.from_numpy(x) for x in (
        ids, rng.integers(1, item_size, size=ZOO_B), rng.integers(1, item_size, size=ZOO_B),
        np.roll(ids, 5, axis=0), rng.integers(0, 101, size=ZOO_B)))


def _zoo_step(model, batch, seeds, masked):
    from bsarec_tpu_torch.config import TrainConfig
    from bsarec_tpu_torch.ops.losses import full_softmax_ce
    from bsarec_tpu_torch.train.loop import make_optimizer

    model.train()
    opt = make_optimizer(model.parameters(), TrainConfig(lr=ZOO_LR))
    model.dropout_state.begin_step(seeds)
    if masked is not None:  # BERT4Rec: the CE on ids cloze-masked once, on the host
        loss = full_softmax_ce(model(masked)[:, -1, :], model.item_table, batch[1],
                               impl="streaming")
    else:
        loss = model.calculate_loss(*batch)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    grads = {k: p.grad.cpu().clone() for k, p in model.named_parameters() if p.grad is not None}
    opt.step()
    return float(loss.detach()), grads, {k: v.cpu().clone() for k, v in model.state_dict().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("model_type", sorted(ZOO_ITEMS))
def test_cuda_zoo_step_matches_cpu(cuda_device, monkeypatch, model_type):
    """One Adam step of a zoo model through the kernels (streaming CE,
    fused dropout) against the same step on the CPU through their plain
    versions: the loss within LOSS_TOL; gradients within t = GRAD_TOL of
    each tensor's largest CPU entry (a zero-gradient tensor's: of the
    model's largest; the item table's rows that the batch reads and its
    other rows, the CE's softmax share or Caser's norm penalty, apart);
    parameters within 1e-6 beyond lr * |f(G + d) - f(G)|, Adam's first
    step f(G) = G / (|G| + eps) of the CPU gradient G moved by the
    measured difference d clamped to +-t (a zeroed gradient with |G| > t
    fails)."""
    import copy

    from bsarec_tpu_torch.config import ModelConfig
    from bsarec_tpu_torch.models import build_model
    from bsarec_tpu_torch.models.bert4rec import cloze_mask

    monkeypatch.setenv("BSAREC_DROPOUT", "pallas")
    item_size = ZOO_ITEMS[model_type]
    cfg = ModelConfig(model_type=model_type, item_size=item_size, num_users=101,
                      loss_impl="streaming")
    cpu_model = build_model(cfg, generator=torch.Generator().manual_seed(1), prng="rbg")
    card_model = copy.deepcopy(cpu_model).to(cuda_device)
    if model_type in ("bert4rec", "duorec", "fearec"):
        assert card_model.item_table.shape[0] % 64 == 1
    batch = _zoo_batch(item_size, 3)
    masked = None
    if model_type == "bert4rec":
        masked = cloze_mask(batch[0], 10, item_size, torch.Generator().manual_seed(2))
    seeds = torch.tensor([123, 456])
    want_loss, want_grads, want_params = _zoo_step(cpu_model, batch, seeds, masked)
    launches = (ce.ce_logz.launches, ce.ce_grads.launches, fd.fused_dropout.launches)
    loss, grads, params = _zoo_step(
        card_model, tuple(x.to(cuda_device) for x in batch), seeds.to(cuda_device),
        None if masked is None else masked.to(cuda_device))
    torch.cuda.synchronize()
    ce_calls = 1 if model_type in ("bert4rec", "duorec", "fearec") else 0
    assert ce.ce_logz.launches - launches[0] == ce_calls == ce.ce_grads.launches - launches[1]
    assert fd.fused_dropout.launches > launches[2]
    assert abs(loss - want_loss) <= LOSS_TOL["rtol"] * max(1.0, abs(want_loss))
    assert grads.keys() == want_grads.keys()
    read = [batch[0] if masked is None else masked, batch[1]]
    read += [batch[2]] if cpu_model.reads_negatives else []
    read += [batch[3]] if cpu_model.reads_same_target else []
    read_rows = torch.zeros(cpu_model.vocab_rows(), dtype=torch.bool)
    read_rows[torch.cat([x.reshape(-1) for x in read]).long()] = True
    top = max(float(g.abs().max()) for g in want_grads.values())
    tol = {}
    for k, want in want_grads.items():
        if k == "item_embeddings.weight":
            t = torch.zeros(want.shape[0], 1, dtype=torch.float64)
            for rows in (read_rows, ~read_rows):
                t[rows] = GRAD_TOL["rtol"] * float(want[rows].abs().max())
        else:
            scale = float(want.abs().max())
            t = torch.tensor(GRAD_TOL["rtol"] * (top if scale <= 1e-6 * top else scale),
                             dtype=torch.float64)
        assert bool(((grads[k] - want).abs().double() <= t).all()), k
        tol[k] = t

    def f(g):
        return g / (g.abs() + ADAM_EPS)

    for k, want in want_params.items():
        diff = (params[k].double() - want.double()).abs()
        if k in want_grads:
            g = want_grads[k].double()  # TrainConfig's weight decay is 0
            d = (grads[k].double() - g).clamp(min=-tol[k], max=tol[k])
            diff = diff - ZOO_LR * (f(g + d) - f(g)).abs()
        assert float(diff.max()) <= 1e-6, k

"""Streaming softmax CE: the port's plain pieces vs the JAX Pallas kernels
(interpret mode on the CPU). The CUDA kernels are held against the plain
pieces in `tests/test_torch_port_cuda.py` and `chip_smoke.py`.

Tolerances: the loss and logZ are fp32 sums of up to H products and of
V exponentials, taken in another order by XLA and by torch (rtol 1e-5,
atol 1e-5); the gradients add one more sum of B or V such terms (rtol
1e-4, atol 1e-5), as `tests/test_pallas.py` states them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsarec_tpu.ops.losses import full_softmax_ce as jax_full_softmax_ce
from bsarec_tpu.ops.pallas_ce import streaming_ce_grads as jax_streaming_ce_grads
from bsarec_tpu.ops.pallas_ce import streaming_ce_stats as jax_streaming_ce_stats
from bsarec_tpu.ops.pallas_ce import streaming_softmax_ce as jax_streaming_softmax_ce
from bsarec_tpu_torch.ops import ce
from bsarec_tpu_torch.ops.losses import STREAMING_CE_MIN_VOCAB, full_softmax_ce, resolve_loss_impl

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(b, v, h, n_valid, seed, odd_answers=False):
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(b, h)).astype(np.float32)
    table = (0.5 * rng.normal(size=(v, h))).astype(np.float32)
    answers = rng.integers(1, n_valid, size=b).astype(np.int32)
    if odd_answers:  # repeats, item 0, -1 and ids >= n_valid (gold 0, no one-hot term)
        answers[1] = answers[0]
        answers[2] = answers[0]
        answers[3] = 0
        answers[4] = -1
        answers[5] = n_valid
        answers[6] = v + 7
    return states, table, answers


def _jax_loss_and_grads(states, table, answers, n_valid):
    def mean_loss(s, t):
        return jnp.mean(jax_streaming_softmax_ce(s, t, jnp.asarray(answers), n_valid, 8, 128, True))

    loss = jax_streaming_softmax_ce(jnp.asarray(states), jnp.asarray(table), jnp.asarray(answers),
                                    n_valid, 8, 128, True)
    gs, gt = jax.grad(mean_loss, argnums=(0, 1))(jnp.asarray(states), jnp.asarray(table))
    return np.asarray(loss), np.asarray(gs), np.asarray(gt)


def _port_loss_and_grads(states, table, answers, n_valid):
    s = torch.from_numpy(states).requires_grad_()
    t = torch.from_numpy(table).requires_grad_()
    loss = ce.streaming_softmax_ce(s, t, torch.from_numpy(answers), n_valid)
    loss.mean().backward()
    return loss.detach().numpy(), s.grad.numpy(), t.grad.numpy()


@pytest.mark.parametrize("b,v,h,n_valid,odd", [
    (8, 256, 64, 256, False),
    (13, 300, 32, 290, False),
    (13, 300, 64, 290, True),
    (8, 256, 128, 250, True),
])
def test_plain_loss_and_grads_match_jax(b, v, h, n_valid, odd):
    """Odd B, V off the JAX tile, n_valid < V, H in {32, 64, 128}, and
    repeated, zero, negative and out-of-range answers."""
    states, table, answers = _inputs(b, v, h, n_valid, seed=b + h, odd_answers=odd)
    want = _jax_loss_and_grads(states, table, answers, n_valid)
    got = _port_loss_and_grads(states, table, answers, n_valid)
    np.testing.assert_allclose(got[0], want[0], **LOSS_TOL)
    np.testing.assert_allclose(got[1], want[1], **GRAD_TOL)
    np.testing.assert_allclose(got[2], want[2], **GRAD_TOL)
    assert not got[2][n_valid:].any()  # rows past n_valid get no gradient


def test_stats_and_grads_building_blocks_match_jax():
    b, v, h, n_valid = 13, 300, 64, 290
    states, table, answers = _inputs(b, v, h, n_valid, seed=3, odd_answers=True)
    j_loss, j_logz = jax_streaming_ce_stats(jnp.asarray(states), jnp.asarray(table),
                                            jnp.asarray(answers), n_valid, 8, 128, True)
    s, t, a = torch.from_numpy(states), torch.from_numpy(table), torch.from_numpy(answers)
    loss, logz = ce.streaming_ce_stats(s, t, a, n_valid)
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), **LOSS_TOL)
    np.testing.assert_allclose(logz.numpy(), np.asarray(j_logz), **LOSS_TOL)
    # out-of-range and negative answers have gold 0: loss == logZ there
    off = (answers < 0) | (answers >= n_valid)
    np.testing.assert_array_equal(loss.numpy()[off], logz.numpy()[off])

    dloss = np.random.default_rng(4).uniform(0.5, 1.5, size=b).astype(np.float32)
    j_ds, j_dt = jax_streaming_ce_grads(jnp.asarray(states), jnp.asarray(table), jnp.asarray(answers),
                                        j_logz, jnp.asarray(dloss), n_valid, 8, 128, True)
    ds, dt = ce.streaming_ce_grads(s, t, a, logz, torch.from_numpy(dloss), n_valid)
    np.testing.assert_allclose(ds.numpy(), np.asarray(j_ds), **GRAD_TOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(j_dt), **GRAD_TOL)


@pytest.mark.parametrize("b,v,h,n_valid", [
    (257, 300, 64, 290),
    (256, 200, 32, 197),
    (255, 260, 64, 260),
    (1, 260, 128, 250),
])
def test_plain_loss_logz_matches_jax_at_the_onchip_route_edges(b, v, h, n_valid):
    """`ce_loss_logz` (the plain version on the CPU) against the JAX
    package's `streaming_ce_stats` at the CUDA kernels' on-chip route
    bounds (B <= 256, H <= 64) and past them, V off the 64-column tile,
    n_valid < V, with repeated, zero, negative and out-of-range answers."""
    states, table, answers = _inputs(b, v, h, n_valid, seed=30 + b, odd_answers=b >= 7)
    j_loss, j_logz = jax_streaming_ce_stats(jnp.asarray(states), jnp.asarray(table),
                                            jnp.asarray(answers), n_valid, 64, 128, True)
    s, t = torch.from_numpy(states), torch.from_numpy(table)
    loss, logz = ce.ce_loss_logz(s, t, torch.from_numpy(answers).long(), n_valid)
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), **LOSS_TOL)
    np.testing.assert_allclose(logz.numpy(), np.asarray(j_logz), **LOSS_TOL)


@pytest.mark.parametrize("chunk", [7, 64, 1 << 20])
def test_plain_pieces_are_chunk_invariant(chunk):
    """Chunking the catalog changes only the order of fp32 sums."""
    b, v, h, n_valid = 9, 200, 16, 190
    states, table, answers = _inputs(b, v, h, n_valid, seed=5, odd_answers=True)
    s, t = torch.from_numpy(states), torch.from_numpy(table)
    a = ce.map_answers(torch.from_numpy(answers), n_valid)
    logz = ce.ce_logz_plain(s, t, n_valid, chunk=chunk)
    want = torch.logsumexp(s @ t[:n_valid].T, dim=1)
    torch.testing.assert_close(logz, want, **LOSS_TOL)
    d = torch.full((b,), 1.0 / b)
    ds, dt = ce.ce_grads_plain(s, t, a, logz, d, n_valid, chunk=chunk)
    p = torch.softmax(s @ t[:n_valid].T, dim=1) * d[:, None]
    onehot = torch.zeros(b, v)
    keep = a >= 0
    onehot[torch.arange(b)[keep], a[keep].long()] = 1.0
    onehot = onehot * d[:, None]
    # the finished ds: p @ T minus dloss_i * T[a_i] for the answers in range
    torch.testing.assert_close(ds, (p - onehot[:, :n_valid]) @ t[:n_valid], **GRAD_TOL)
    torch.testing.assert_close(dt[:n_valid], p.T @ s - (onehot.T @ s)[:n_valid], **GRAD_TOL)
    assert not dt[n_valid:].any()


@pytest.mark.parametrize("b,v,h,n_valid,odd", [
    (8, 256, 64, 256, False),
    (13, 300, 32, 290, True),
    (9, 260, 128, 250, True),
])
def test_fused_forward_and_finished_ds_match_jax(b, v, h, n_valid, odd):
    """`ce_loss_logz` (one call: loss and logZ) and the finished ds of
    `ce_grads` against the JAX package's loss, `jax.grad` of
    sum(dloss * loss), and its `streaming_ce_stats`/`streaming_ce_grads`."""
    states, table, answers = _inputs(b, v, h, n_valid, seed=20 + b, odd_answers=odd)
    dloss = np.random.default_rng(21).uniform(0.5, 1.5, size=b).astype(np.float32)
    js, jt, ja = jnp.asarray(states), jnp.asarray(table), jnp.asarray(answers)
    j_loss = jax_streaming_softmax_ce(js, jt, ja, n_valid, 8, 128, True)
    _, j_logz = jax_streaming_ce_stats(js, jt, ja, n_valid, 8, 128, True)

    def weighted(s_, t_):
        return jnp.sum(jnp.asarray(dloss) * jax_streaming_softmax_ce(s_, t_, ja, n_valid, 8, 128, True))

    j_gs, j_gt = jax.grad(weighted, argnums=(0, 1))(js, jt)
    j_ds, j_dt = jax_streaming_ce_grads(js, jt, ja, j_logz, jnp.asarray(dloss), n_valid, 8, 128, True)

    s, t = torch.from_numpy(states), torch.from_numpy(table)
    a = torch.from_numpy(answers).long()  # the model's int64 ids, unmapped
    loss, logz = ce.ce_loss_logz(s, t, a, n_valid)
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), **LOSS_TOL)
    np.testing.assert_allclose(logz.numpy(), np.asarray(j_logz), **LOSS_TOL)
    ds, dt = ce.ce_grads_plain(s, t, a, logz, torch.from_numpy(dloss), n_valid)
    for want_ds, want_dt in ((j_gs, j_gt), (j_ds, j_dt)):
        np.testing.assert_allclose(ds.numpy(), np.asarray(want_ds), **GRAD_TOL)
        np.testing.assert_allclose(dt.numpy(), np.asarray(want_dt), **GRAD_TOL)


def _dense_reference(s, t, a, n_valid, dloss):
    """loss, logZ and the gradients of sum(dloss * loss) from the dense
    [B, n_valid] logits, float64, gold 0 where a is outside [0, n_valid)."""
    s64 = s.double().requires_grad_()
    t64 = t.double().requires_grad_()
    logits = s64 @ t64[:n_valid].T
    logz = torch.logsumexp(logits, dim=1)
    keep = (a >= 0) & (a < n_valid)
    gold = torch.where(keep, logits.gather(1, torch.where(keep, a, 0)[:, None])[:, 0], 0.0)
    loss = logz - gold
    ds, dt = torch.autograd.grad((dloss.double() * loss).sum(), (s64, t64))
    return loss.detach().float(), logz.detach().float(), ds.float(), dt.float()


def test_raw_int64_answers_through_the_plain_paths():
    """The model's int64 answers go in unmapped: -1, n_valid, an id in
    [n_valid, V), V, V + 7 and 2^40 have gold 0 and no one-hot term; item 0
    and repeated answers count. int32 answers give the same results."""
    b, v, h, n_valid = 12, 70, 16, 60
    states, table, answers = _inputs(b, v, h, n_valid, seed=30)
    a = torch.from_numpy(answers).long()
    a[:9] = torch.tensor([-1, n_valid, n_valid + 3, v, v + 7, 1 << 40, 0, 0, int(a[9])])
    s, t = torch.from_numpy(states), torch.from_numpy(table)
    dloss = torch.from_numpy(np.random.default_rng(31).uniform(0.5, 1.5, size=b).astype(np.float32))
    want_loss, want_logz, want_ds, want_dt = _dense_reference(s, t, a, n_valid, dloss)
    loss, logz = ce.ce_loss_logz_plain(s, t, a, n_valid)
    torch.testing.assert_close(loss, want_loss, **LOSS_TOL)
    torch.testing.assert_close(logz, want_logz, **LOSS_TOL)
    assert torch.equal(loss[:6], logz[:6])  # gold 0 exactly
    ds, dt = ce.ce_grads_plain(s, t, a, logz, dloss, n_valid)
    torch.testing.assert_close(ds, want_ds, **GRAD_TOL)
    torch.testing.assert_close(dt, want_dt, **GRAD_TOL)
    assert not dt[n_valid:].any()
    a32 = a.clamp(max=v + 7).int()  # 2^40 does not fit; v + 7 is out of range as well
    loss32, _ = ce.ce_loss_logz(s, t, a32, n_valid)
    assert torch.equal(loss32, loss)
    ds32, dt32 = ce.ce_grads(s, t, a32, logz, dloss, n_valid)
    assert torch.equal(ds32, ds) and torch.equal(dt32, dt)
    # answers of -1 leave out both gold terms; dT differs only at the answers
    ds_sum, dt_sum = ce.ce_grads_plain(s, t, torch.full_like(a, -1), logz, dloss, n_valid)
    answered = torch.zeros(v, dtype=torch.bool)
    answered[a[(a >= 0) & (a < n_valid)]] = True
    assert torch.equal(dt_sum[~answered], dt[~answered])
    torch.testing.assert_close(ds_sum - dloss[:, None] * ce.gold_rows_plain(
        t, ce.map_answers(a, n_valid)), ds, rtol=0, atol=0)


def test_gather_and_answer_mapping():
    table = torch.arange(40, dtype=torch.float32).view(10, 4)
    answers = torch.tensor([3, -1, 9, 10, 0, 3])
    rows = ce.gold_rows_plain(table, answers)
    assert torch.equal(rows[0], table[3]) and torch.equal(rows[2], table[9])
    assert torch.equal(rows[4], table[0]) and torch.equal(rows[5], table[3])
    assert not rows[1].any() and not rows[3].any()
    mapped = ce.map_answers(answers, n_valid=9)
    assert mapped.dtype == torch.int32
    assert mapped.tolist() == [3, -1, -1, -1, 0, 3]
    # ids past int32 are out of range, not wrapped into it
    assert ce.map_answers(torch.tensor([(1 << 32) + 3, 3]), n_valid=9).tolist() == [-1, 3]


def test_wrappers_on_cpu_run_plain_and_validate():
    states, table, answers = _inputs(6, 50, 8, 50, seed=6)
    s, t, a = torch.from_numpy(states), torch.from_numpy(table), torch.from_numpy(answers)
    counts = lambda: (ce.ce_logz.launches, ce.gold_rows.launches, ce.ce_grads.launches,
                      ce.ce_grads.onchip_launches, ce.ce_logz.bf16_launches,
                      ce.ce_grads.bf16_launches)
    before = counts()
    assert torch.equal(ce.ce_logz(s, t), ce.ce_logz_plain(s, t, 50))
    assert torch.equal(ce.ce_logz(s, t, dtype="bfloat16"), ce.ce_logz_plain(s, t, 50, bf16=True))
    assert torch.equal(ce.gold_rows(t, a), ce.gold_rows_plain(t, a))
    loss = ce.streaming_softmax_ce(s, t, a)
    assert torch.equal(loss, ce.streaming_softmax_ce_plain(s, t, a))
    assert torch.equal(ce.ce_loss_logz(s, t, a)[0], loss)
    logz, d = ce.ce_logz(s, t), torch.ones(6)
    for got, want in zip(ce.ce_grads(s, t, a, logz, d), ce.ce_grads_plain(s, t, a, logz, d, 50)):
        assert torch.equal(got, want)
    assert counts() == before
    for n_valid in (-1, 51):
        with pytest.raises(ValueError):
            ce.ce_logz(s, t, n_valid)
    # bfloat16 is ported; a dtype the policy does not know still raises
    with pytest.raises(NotImplementedError, match="is not ported"):
        ce.streaming_softmax_ce(s, t, a, dtype="float16")
    with pytest.raises(NotImplementedError, match="is not ported"):
        full_softmax_ce(s, t, a, dtype="float16")
    # the sharded impls run on a Trainer's mesh: without an active one they
    # raise, as JAX's `active_mesh()` does; an impl nobody knows is refused
    with pytest.raises(RuntimeError, match="no active mesh"):
        full_softmax_ce(s, t, a, impl="sharded_streaming")
    with pytest.raises(NotImplementedError, match="is not ported"):
        full_softmax_ce(s, t, a, impl="sharded")


@pytest.mark.parametrize("impl", ["dense", "streaming"])
def test_full_softmax_ce_matches_jax(impl):
    """Both port impls against the JAX dense loss and its gradients."""
    b, v, h = 10, 120, 32
    states, table, answers = _inputs(b, v, h, v, seed=8)

    def jax_loss(s_, t_):
        return jax_full_softmax_ce(s_, t_, jnp.asarray(answers), impl="dense")

    j_loss, (j_gs, j_gt) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(states), jnp.asarray(table))
    s = torch.from_numpy(states).requires_grad_()
    t = torch.from_numpy(table).requires_grad_()
    loss = full_softmax_ce(s, t, torch.from_numpy(answers).long(), impl=impl)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), **LOSS_TOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(j_gs), **GRAD_TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(j_gt), **GRAD_TOL)


def test_auto_loss_impl_rule():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert resolve_loss_impl("auto", STREAMING_CE_MIN_VOCAB, cuda) == "streaming"
    assert resolve_loss_impl("auto", STREAMING_CE_MIN_VOCAB - 1, cuda) == "dense"
    assert resolve_loss_impl("auto", STREAMING_CE_MIN_VOCAB, cpu) == "dense"
    assert resolve_loss_impl("streaming", 10, cpu) == "streaming"

"""The port at hidden widths past 256, against the JAX package, on the CPU.

On the card the streaming-CE kernels take their wide routes at H > 256,
the rank kernel its tensor-core route at H > 256 and k <= 32, and
elsewhere its older route, which stages its states in hidden chunks where
all of them do not fit in shared memory; those are held against the plain versions
in `tests/test_torch_port_cuda.py` and `chip_smoke.py`. Here the plain
versions, which the wrappers run on the CPU, are held against the JAX
package's Pallas kernels in interpret mode at such widths, and both CLIs
train BSARec at hidden 384 through the streaming CE from the same
weights.

Tolerances: the fp32 CE as `tests/test_torch_port_ce.py` states them
(loss and logZ rtol 1e-5, gradients rtol 1e-4: fp32 sums of H products
and of V exponentials in another order); the bf16-operand form's
gradients within `parity.BF16_GRAD_TOL` of each tensor's largest entry
(on random inputs and on `parity.exact_logit_case`'s, whose logits are
exact in any summation order; `parity.BF16_WIDE_GRAD_TOL`, the card's
limit for random inputs, is held between the plain version reordered and
the fp32 form); the rank kernel on integer inputs (exact dot products), values and ids
equal, tie order included (in the serving mode against JAX's
`serving_masked_topk`, ids where the value is finite); the two CLIs'
epoch losses within rtol 1e-5,
as `tests/test_torch_port_train.py` holds an Adam step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsarec_tpu.ops.pallas_ce import streaming_ce_grads as jax_streaming_ce_grads
from bsarec_tpu.ops.pallas_ce import streaming_ce_stats as jax_streaming_ce_stats
from bsarec_tpu.ops.pallas_ce import streaming_softmax_ce as jax_streaming_softmax_ce
from bsarec_tpu.ops.pallas_rank import build_seen_bitmask as jax_build_seen_bitmask
from bsarec_tpu.ops.pallas_rank import streaming_masked_topk as jax_streaming_masked_topk
from bsarec_tpu.serving import serving_masked_topk as jax_serving_masked_topk
from bsarec_tpu_torch.config import ModelConfig
from bsarec_tpu_torch.data.corpus import Corpus
from bsarec_tpu_torch.data.pipeline import SeqRecData
from bsarec_tpu_torch.models import build_model
from bsarec_tpu_torch.ops import ce, rank
from bsarec_tpu_torch import parity
from bsarec_tpu_torch.parity import BF16_GRAD_TOL, rel_err
from bsarec_tpu_torch.train.checkpoint import save_params

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
BF16 = "bfloat16"


def _ce_inputs(b, v, h, n_valid, seed):
    """N(0, 1) states, 0.25 N(0, 1) table; answers in [1, n_valid), with a
    repeat, item 0, -1 and ids >= n_valid and >= V (gold 0, no one-hot
    term)."""
    rng = np.random.default_rng(seed)
    states = rng.standard_normal((b, h), dtype=np.float32)
    table = 0.25 * rng.standard_normal((v, h), dtype=np.float32)
    answers = rng.integers(1, n_valid, size=b).astype(np.int32)
    answers[:6] = [answers[6], 0, -1, n_valid, v + 7, answers[6]]
    return states, table, answers


@pytest.mark.parametrize("h", [384, 512])
@pytest.mark.parametrize("dtype", [None, BF16], ids=["fp32", "bf16"])
def test_ce_plain_matches_jax_at_wide_h(h, dtype):
    """The loss through autograd, its gradients, and the building blocks
    (`ce_loss_logz` through `streaming_ce_stats`, `ce_grads` at an uneven
    dloss through `streaming_ce_grads`) against JAX's interpret-mode
    kernels, odd B and n_valid < V."""
    b, v, n_valid = 13, 1000, 990
    states, table, answers = _ce_inputs(b, v, h, n_valid, seed=h)
    js, jt, ja = jnp.asarray(states), jnp.asarray(table), jnp.asarray(answers)
    args = (n_valid, 8, 128, True, dtype)

    def jax_mean(s, t):
        return jnp.mean(jax_streaming_softmax_ce(s, t, ja, *args))

    j_loss = jax_streaming_softmax_ce(js, jt, ja, *args)
    j_ds, j_dt = jax.grad(jax_mean, argnums=(0, 1))(js, jt)
    s = torch.from_numpy(states).requires_grad_()
    t = torch.from_numpy(table).requires_grad_()
    loss = ce.streaming_softmax_ce(s, t, torch.from_numpy(answers), n_valid, dtype=dtype)
    loss.mean().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(j_loss), **LOSS_TOL)
    assert not t.grad[n_valid:].any()

    j_stats = jax_streaming_ce_stats(js, jt, ja, *args)
    a = torch.from_numpy(answers).long()
    got_loss, logz = ce.ce_loss_logz(s.detach(), t.detach(), a, n_valid, dtype=dtype)
    for got, want in zip((got_loss, logz), j_stats):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOSS_TOL)
    dloss = np.random.default_rng(h + 1).uniform(0.5, 1.5, size=b).astype(np.float32)
    j_grads = jax_streaming_ce_grads(js, jt, ja, jnp.asarray(logz.numpy()), jnp.asarray(dloss),
                                     *args)
    grads = ce.ce_grads(s.detach(), t.detach(), a, logz, torch.from_numpy(dloss), n_valid,
                        dtype=dtype)
    if dtype is None:
        for got, want in zip((s.grad, t.grad), (j_ds, j_dt)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
        for got, want in zip(grads, j_grads):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)
    else:
        assert max(rel_err(s.grad, j_ds), rel_err(t.grad, j_dt)) <= BF16_GRAD_TOL
        assert max(rel_err(g, w) for g, w in zip(grads, j_grads)) <= BF16_GRAD_TOL
        # the fp32 form rounds nothing and fails that limit at the same logZ
        fp32 = ce.ce_grads(s.detach(), t.detach(), a, logz, torch.from_numpy(dloss), n_valid)
        assert min(rel_err(g, w) for g, w in zip(fp32, j_grads)) > BF16_GRAD_TOL


def _logits_descending(s, t):
    """`parity.logits_in_order` with h summed in descending order."""
    acc = torch.zeros((s.shape[0], t.shape[0]))
    for h in reversed(range(s.shape[1])):
        acc.addcmul_(s[:, h, None], t[None, :, h])
    return acc


@pytest.mark.parametrize("b,v,h,n_valid", [(37, 700, 260, 690), (300, 500, 512, 500),
                                           (37, 300, 1024, 290)])
def test_exact_logit_case_is_exact_and_the_fp32_form_fails_there(b, v, h, n_valid):
    """The premise of the tensor-core kernel's sharp check: on
    `parity.exact_logit_case` inputs every logit is the same in ascending,
    descending and matmul order, bit for bit, and the plain fp32 ce_grads,
    which differs from the bf16 form there only by not rounding p, misses
    BF16_GRAD_TOL against the plain bf16 version on ds and on dT's other
    rows (so the card's control can fail on these inputs)."""
    states, table, answers, dloss = parity.exact_logit_case(b, v, h, n_valid, seed=h)
    assert torch.equal(states.bfloat16().float(), states)
    assert torch.equal(table.bfloat16().float(), table)
    ascending = parity.logits_in_order(states, table)
    assert torch.equal(ascending, states @ table.T)
    assert torch.equal(ascending, _logits_descending(states, table))
    logz = ce.ce_logz(states, table, n_valid, dtype=BF16)
    want = ce.ce_grads(states, table, answers, logz, dloss, n_valid, dtype=BF16)
    assert all(torch.equal(x, y) for x, y in zip(
        want, parity.ce_grads_bf16_in_order(states, table, answers, logz, dloss, n_valid)))
    control = parity.grad_errors(*ce.ce_grads(states, table, answers, logz, dloss, n_valid), *want,
                                 answers, n_valid)
    assert min(control["ds"], control["dT other rows"]) > BF16_GRAD_TOL


def test_ce_plain_matches_jax_on_exact_logits():
    """On `parity.exact_logit_case` inputs at H = 512, the plain bf16
    ce_grads against JAX's interpret-mode `streaming_ce_grads` with
    dtype="bfloat16" (its logits on the MXU's path, in its own order, exact
    here) within BF16_GRAD_TOL of each tensor's largest entry, at one logZ;
    the fp32 form misses that limit."""
    b, v, h, n_valid = 37, 1000, 512, 990
    states, table, answers, dloss = parity.exact_logit_case(b, v, h, n_valid, seed=7)
    logz = ce.ce_logz(states, table, n_valid, dtype=BF16)
    j_grads = jax_streaming_ce_grads(
        jnp.asarray(states.numpy()), jnp.asarray(table.numpy()), jnp.asarray(answers.numpy()),
        jnp.asarray(logz.numpy()), jnp.asarray(dloss.numpy()), n_valid, 8, 128, True, BF16)
    grads = ce.ce_grads(states, table, answers, logz, dloss, n_valid, dtype=BF16)
    assert max(rel_err(g, w) for g, w in zip(grads, j_grads)) <= BF16_GRAD_TOL
    fp32 = ce.ce_grads(states, table, answers, logz, dloss, n_valid)
    assert min(rel_err(g, w) for g, w in zip(fp32, j_grads)) > BF16_GRAD_TOL


def test_bf16_wide_limit_lies_between_reordering_and_the_fp32_form():
    """`parity.BF16_WIDE_GRAD_TOL` is above BF16_GRAD_TOL and holds the
    plain bf16 version with its logits summed in descending h against
    `parity.ce_grads_bf16_in_order` on `chip_smoke.py`'s "H=512, repeated
    answers" inputs (its largest such reading, 2.09e-3); the fp32 form
    misses it on ds and on dT's other rows there and on
    `tests/test_torch_port_cuda.py`'s H = 260 inputs (its smallest reading,
    7.22e-3 on ds)."""
    assert BF16_GRAD_TOL < parity.BF16_WIDE_GRAD_TOL
    # chip_smoke.py's ce_case(200, 3001, 512, 3001, seed=204, "repeated"), dloss 1/B
    rng = np.random.default_rng(204)
    states = torch.from_numpy(rng.standard_normal((200, 512), dtype=np.float32))
    table = torch.from_numpy(0.25 * rng.standard_normal((3001, 512), dtype=np.float32))
    rng.integers(1, 3001, size=200)  # ce_case draws these first, then replaces them
    answers = torch.from_numpy(rng.choice(rng.integers(1, 3001, size=5), size=200))
    dloss = torch.full((200,), 1.0 / 200)
    # tests/test_torch_port_cuda.py's wide case (37, 5000, 260, 4990)
    rng = np.random.default_rng(37 + 260 + 2)
    states2 = torch.from_numpy(rng.normal(size=(37, 260)).astype(np.float32))
    table2 = torch.from_numpy((0.25 * rng.normal(size=(5000, 260))).astype(np.float32))
    answers2 = rng.integers(1, 4990, size=37)
    answers2[:7] = [answers2[0], answers2[0], 0, -1, 4990, 5000, 5007]
    answers2 = torch.from_numpy(answers2)
    dloss2 = torch.from_numpy(rng.uniform(0.5, 1.5, size=37).astype(np.float32))
    for s, t, a, d, n_valid, reordered in ((states, table, answers, dloss, 3001, True),
                                           (states2, table2, answers2, dloss2, 4990, False)):
        logz = ce.ce_logz(s, t, n_valid, dtype=BF16)
        want = parity.ce_grads_bf16_in_order(s, t, a, logz, d, n_valid)
        if reordered:
            sb, tb = s.bfloat16().float(), t.bfloat16().float()
            p = (torch.exp(_logits_descending(sb, tb) - logz[:, None]) * d[:, None]).bfloat16().float()
            dt = p.T @ sb
            keep = (a >= 0) & (a < n_valid)
            dt.index_add_(0, a[keep], -(d[keep, None] * s[keep]))
            ds = p @ tb - d[:, None] * t[torch.where(keep, a, 0)] * keep[:, None]
            got = parity.grad_errors(ds, dt, *want, a, n_valid)
            assert 2e-3 < max(got.values()) <= parity.BF16_WIDE_GRAD_TOL
        control = parity.grad_errors(*ce.ce_grads(s, t, a, logz, d, n_valid), *want, a, n_valid)
        assert min(control["ds"], control["dT other rows"]) > parity.BF16_WIDE_GRAD_TOL


@pytest.mark.parametrize("h", [512, 1024])
@pytest.mark.parametrize("k", [20, 128])
def test_rank_plain_matches_jax_at_wide_h(h, k):
    """Integer inputs (exact dot products, many ties), V off JAX's 4096-wide
    tile, n_valid < V and a row that has seen every item: values and ids
    equal to JAX's kernel, in the eval mode (seen items score 0.0)."""
    b, v, n_valid = 6, 5000, 4990
    rng = np.random.default_rng(h + k)
    states = rng.integers(-2, 3, size=(b, h)).astype(np.float32)
    table = rng.integers(-2, 3, size=(v, h)).astype(np.float32)
    seen = rng.integers(1, v, size=(b, 20)).astype(np.int32)
    seen[:, 1] = seen[:, 0]
    seen[:, 14:] = 0
    seen = np.concatenate([seen, np.zeros((b, v), np.int32)], axis=1)
    seen[2, 20:] = np.arange(v)
    want_v, want_i = jax_streaming_masked_topk(
        jnp.asarray(states), jnp.asarray(table), jnp.asarray(jax_build_seen_bitmask(seen, v)),
        k=k, n_valid=n_valid, interpret=True,
    )
    got_v, got_i = rank.streaming_masked_topk(
        torch.from_numpy(states), torch.from_numpy(table),
        torch.from_numpy(rank.build_seen_bitmask(seen, v)), k=k, n_valid=n_valid,
    )
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_i[2].tolist() == list(range(k)) and not got_v[2].any()


@pytest.mark.parametrize("seen_value", [0.0, float("-inf")], ids=["eval", "serving"])
@pytest.mark.parametrize("h,k", [(260, 1), (260, 32), (512, 1), (512, 32)])
def test_rank_plain_matches_jax_at_the_tc_route_edges(h, k, seen_value):
    """The plain version at the shapes of the rank kernel's tensor-core
    route's edges (H = 260, off its 16-column step, and 512; k = 1 and its
    bound 32; B = 300, over one group of 256 rows; V = 5000, n_valid < V; a
    row that has seen every item), integer inputs (exact scores, many
    ties): values and ids equal. Eval mode (seen -> 0.0) against JAX's
    `_rank_kernel` in interpret mode; serving mode (seen -> -inf) against
    JAX's `serving_masked_topk` on the same scores with the columns >=
    n_valid at -inf (its ids compared where the value is finite: the port
    fills the rest with 0)."""
    b, v, n_valid = 300, 5000, 4990
    rng = np.random.default_rng(h + k)
    states = rng.integers(-2, 3, size=(b, h)).astype(np.float32)
    table = rng.integers(-2, 3, size=(v, h)).astype(np.float32)
    seen = rng.integers(1, v, size=(b, 20)).astype(np.int32)
    seen[:, 1] = seen[:, 0]
    seen[:, 14:] = 0
    seen = np.concatenate([seen, np.zeros((b, v), np.int32)], axis=1)
    seen[270, 20:] = np.arange(v)  # in the second group
    got_v, got_i = rank.streaming_masked_topk(
        torch.from_numpy(states), torch.from_numpy(table),
        torch.from_numpy(rank.build_seen_bitmask(seen, v)), k=k, n_valid=n_valid,
        seen_value=seen_value,
    )
    if seen_value == 0.0:
        want_v, want_i = jax_streaming_masked_topk(
            jnp.asarray(states), jnp.asarray(table), jnp.asarray(jax_build_seen_bitmask(seen, v)),
            k=k, n_valid=n_valid, interpret=True,
        )
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        assert got_i[270].tolist() == list(range(k)) and not got_v[270].any()
        return
    scores = jnp.asarray(states) @ jnp.asarray(table).T
    scores = jnp.where(jnp.arange(v) < n_valid, scores, -jnp.inf)
    want_v, want_i = jax_serving_masked_topk(scores, jnp.asarray(seen), k)
    want_v, want_i = np.asarray(want_v), np.asarray(want_i)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    finite = np.isfinite(want_v)
    np.testing.assert_array_equal(got_i.numpy()[finite], want_i[finite])
    assert (got_i.numpy()[~finite] == 0).all() and not finite[270].any()


def _toy_seqs(n_users=24, n_items=80, seed=3):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_users):
        start, stride, length = rng.integers(1, n_items), rng.integers(1, 5), rng.integers(4, 10)
        seqs.append([int((start + stride * i - 1) % (n_items - 1) + 1) for i in range(length)])
    seqs[-1][-1] = n_items - 1  # the file's largest id is the catalog's last item
    return seqs


def test_main_trains_at_hidden_384_like_jax_main(tmp_path, monkeypatch):
    """`bsarec_tpu_torch.main --device cpu` and `bsarec_tpu.main` train
    BSARec at hidden 384 for two epochs through the streaming CE (the
    port's plain versions, JAX's Pallas kernels in interpret mode) from the
    same weights, dropout 0, one full batch an epoch (so the sample order
    drops out): epoch 0's loss is taken at those weights, epoch 1's after
    one Adam step, and each agrees within LOSS_RTOL. Each CLI's Trainer is
    wrapped to install the weights after it is built, to train through
    the streaming CE (`loss_impl`, which no flag sets) and to record each
    epoch's loss."""
    import bsarec_tpu.main as jax_main_module
    import bsarec_tpu_torch.main as port_main_module
    from bsarec_tpu.train.torch_import import import_torch_checkpoint

    seqs = _toy_seqs()
    (tmp_path / "Toy.txt").write_text(
        "".join(f"{u + 1} {' '.join(map(str, s))}\n" for u, s in enumerate(seqs)))
    n_items = max(map(max, seqs)) + 1
    n_samples = SeqRecData(Corpus(user_seq=seqs, max_item=n_items - 1), 10).train.num_samples
    widths = dict(max_seq_length=10, hidden_size=384, num_hidden_layers=2, num_attention_heads=1,
                  c=5, alpha=0.7, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = build_model(ModelConfig(model_type="bsarec", item_size=n_items,
                                    num_users=len(seqs) + 1, **widths),
                        generator=torch.Generator().manual_seed(5))
    save_params(model.state_dict(), tmp_path / "init.pt")
    losses = {}

    def wrap(module, name, weights):
        base = module.Trainer

        class Wrapped(base):
            def __init__(self, model_cfg, *args, **kwargs):
                super().__init__(dataclasses.replace(model_cfg, loss_impl="streaming"), *args,
                                 **kwargs)
                self.install_params(weights())

            def train(self, epoch):
                loss = super().train(epoch)
                losses.setdefault(name, []).append(loss)
                return loss

        monkeypatch.setattr(module, "Trainer", Wrapped)

    wrap(port_main_module, "port", lambda: model.state_dict())
    wrap(jax_main_module, "jax", lambda: import_torch_checkpoint(
        "bsarec", str(tmp_path / "init.pt"), 2, max_seq_length=10))
    flags = [f"--{k}={v}" for k, v in widths.items()] + [
        "--data_dir", str(tmp_path), "--data_name", "Toy", "--output_dir", str(tmp_path),
        "--model_type", "BSARec", "--epochs", "2", "--batch_size", str(n_samples),
        "--lr", "5e-4", "--scan_unroll", "1",
    ]
    port_main_module.main(flags + ["--device", "cpu", "--train_name", "port"])
    jax_main_module.main(flags + ["--train_name", "jax"])
    assert len(losses["port"]) == len(losses["jax"]) == 2
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=LOSS_RTOL)
    assert losses["port"][1] < losses["port"][0]

"""The bf16 compute policy of the port (`--dtype bf16`, `ops/precision.py`)
against the JAX package's `compute_dtype="bfloat16"`, on the CPU at small
widths, inputs seeded with numpy and given to both packages.

- The streaming CE's bf16-operand form (the plain versions that stand
  beside the CUDA kernels) against JAX's `streaming_softmax_ce(...,
  dtype="bfloat16")` and its vocab-sharded building blocks, their Pallas
  kernels in interpret mode as `tests/test_pallas.py:122` runs them, with
  n_valid < V and answers off the catalog. The products of rounded
  operands are exact in fp32 on both sides, so the loss and logZ differ
  only by summation order (rtol CE_RTOL); the gradients are held within
  `bsarec_tpu_torch.parity.BF16_GRAD_TOL` of each tensor's largest entry
  (the limit and its readings are stated there), which the fp32 form
  exceeds at the same logZ.
- The dense `full_softmax_ce` at bf16 against JAX's dense path.
- The JAX side is compiled with `xla_allow_excess_precision` off
  (`_exact`). XLA's default lets a fusion skip the bf16 roundings between
  its elementwise ops, so a jitted JAX function rounds at fewer places
  than its program says, and where depends on what the compiler fuses
  (BSARec's bf16 forward here: 6e-3 off its own op-by-op result, SASRec's
  1e-3). With it off, JAX rounds at every bf16 operation as the Flax code
  is written (within 1.5e-6 of the op-by-op result), which the port
  follows.
- Each of the eight models at bf16 on weights carried across with
  `params_from_jax`, dropout off. Every layer's output: both sides round
  at the same places, but an fp32 sum taken in another order (FEARec's
  band maps, a LayerNorm) can put a value feeding a bf16 cast on the
  other side of a rounding boundary, and that one bf16 ulp (2^-8
  relative) then spreads through the row's LayerNorm. So at most
  FLIP_SHARE of the entries may differ by more than FWD_ATOL, none by
  more than FLIP_ATOL (measured over three weight seeds: 0.3% of
  FEARec's entries, up to 2.3e-4; 0.04% of BERT4Rec's; none elsewhere),
  while the port's fp32 forward differs from JAX's bf16 one at more than
  FP32_SHARE of the entries (measured 63-66%), so the bf16 path was
  taken. The loss within LOSS_RTOL and the float32 gradients within
  GRAD_TOL of each tensor's largest entry. A bias's gradient sums a bf16
  gradient over the batch's B * L rows whose terms cancel, so a bf16
  rounding that falls differently in the two frameworks (the gradients
  crossing each bf16 cast are rounded there, in another summation order)
  leaves up to ~4% of the sum's largest entry (measured: 3.6% on FEARec's
  and BSARec's value biases); weight gradients stay far closer. Tensors
  whose true gradient is zero hold rounding noise and are held to
  GRAD_TOL * 1e-3 of the model's largest entry. Caser and GRU4Rec read no
  compute dtype in the JAX package: the port's bf16 run of each is
  bit-identical to its fp32 run.
- The dense bf16 eval (and the streaming eval, which stays fp32 as in
  JAX): metric sums and exported top-20 against JAX's trainer.
- The bf16 scorer in every layout (and int8, which ignores the dtype)
  against the JAX bf16 artifact on the same weights.
- `main --dtype bf16 --device cpu` trains, resumes, evaluates and exports.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsarec_tpu import serving as jax_serving
from bsarec_tpu.config import ModelConfig as JaxModelConfig
from bsarec_tpu.config import TrainConfig as JaxTrainConfig
from bsarec_tpu.data.corpus import Corpus as JaxCorpus
from bsarec_tpu.data.pipeline import SeqRecData as JaxSeqRecData
from bsarec_tpu.models import build_model as jax_build_model
from bsarec_tpu.ops import losses as jlosses
from bsarec_tpu.ops.pallas_ce import streaming_ce_grads as jax_streaming_ce_grads
from bsarec_tpu.ops.pallas_ce import streaming_softmax_ce as jax_streaming_softmax_ce
from bsarec_tpu.train.loop import build_eval_fn as jax_build_eval_fn
from bsarec_tpu.train.trainer import Trainer as JaxTrainer
from bsarec_tpu_torch import serving
from bsarec_tpu_torch.config import ModelConfig, TrainConfig
from bsarec_tpu_torch.data.corpus import Corpus
from bsarec_tpu_torch.data.pipeline import SeqRecData
from bsarec_tpu_torch.ops import ce
from bsarec_tpu_torch.ops.losses import full_softmax_ce
from bsarec_tpu_torch.ops.precision import rounded
from bsarec_tpu_torch import parity
from bsarec_tpu_torch.parity import BF16_GRAD_TOL, rel_err
from bsarec_tpu_torch.train.jax_import import params_from_jax
from bsarec_tpu_torch.train.trainer import Trainer
from test_torch_port_zoo import (
    _uses_sem,
    check_main_trains_and_resumes,
    corpus_seqs,
    fields_of,
    jax_inputs,
    jax_model_and_params,
    make_batch,
    one_torch_thread,  # noqa: F401 (autouse fixture)
    port_loss,
    port_model,
    quiet_logger,
)

BF16 = "bfloat16"
CE_RTOL = 1e-5
FWD_ATOL = 1e-5
FLIP_SHARE, FLIP_ATOL = 0.01, 1e-3
FP32_SHARE = 0.5
LOSS_RTOL = 1e-4
GRAD_TOL = 5e-2
MODELS = ("bsarec", "sasrec", "fmlprec", "bert4rec", "duorec", "fearec", "caser", "gru4rec")
# the models whose JAX counterparts read no compute dtype
FP32_ONLY = ("caser", "gru4rec")
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}


def _exact(fn, *args):
    """fn(*args) compiled by XLA with every bf16 rounding kept (module
    docstring)."""
    return jax.jit(fn).lower(*args).compile(compiler_options=NO_EXCESS_PRECISION)(*args)


def _ce_inputs(b, v, h, n_valid, seed):
    """N(0, 1) states, 0.25 N(0, 1) table; answers in [1, n_valid) but one
    past n_valid, one past V and a -1 (gold 0, no one-hot term)."""
    rng = np.random.default_rng(seed)
    states = rng.standard_normal((b, h), dtype=np.float32)
    table = 0.25 * rng.standard_normal((v, h), dtype=np.float32)
    answers = rng.integers(1, n_valid, size=b).astype(np.int32)
    answers[:3] = [n_valid + 1, v + 5, -1]
    return states, table, answers


def test_streaming_ce_bf16_matches_jax():
    """The loss, both gradients and the sharded building blocks of the
    bf16-operand form against JAX's interpret-mode kernels."""
    b, v, h, n_valid = 12, 300, 32, 290
    states, table, answers = _ce_inputs(b, v, h, n_valid, seed=1)
    js, jt, ja = jnp.asarray(states), jnp.asarray(table), jnp.asarray(answers)

    def jax_mean(s, t):
        return jnp.mean(jax_streaming_softmax_ce(s, t, ja, n_valid, 8, 128, True, BF16))

    j_loss = jax_streaming_softmax_ce(js, jt, ja, n_valid, 8, 128, True, BF16)
    j_ds, j_dt = jax.grad(jax_mean, argnums=(0, 1))(js, jt)
    s = torch.from_numpy(states).requires_grad_()
    t = torch.from_numpy(table).requires_grad_()
    loss = ce.streaming_softmax_ce(s, t, torch.from_numpy(answers), n_valid, dtype=BF16)
    loss.mean().backward()
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(j_loss), rtol=CE_RTOL)
    assert rel_err(s.grad, j_ds) <= BF16_GRAD_TOL
    assert rel_err(t.grad, j_dt) <= BF16_GRAD_TOL
    assert not t.grad[n_valid:].any()
    # off-catalog answers have gold 0: their loss is logZ
    _, logz = ce.ce_loss_logz(s.detach(), t.detach(), torch.from_numpy(answers), n_valid,
                              dtype=BF16)
    assert torch.equal(loss[:3].detach(), logz[:3])
    # the rounding is real: the fp32 form is farther from JAX's bf16 loss
    fp32 = ce.streaming_softmax_ce(s.detach(), t.detach(), torch.from_numpy(answers), n_valid)
    assert rel_err(fp32, j_loss) > 10 * rel_err(loss.detach(), j_loss)

    # the vocab-sharded building blocks: (loss, logZ) as the forward's, and
    # the gradients at an uneven dloss against JAX's
    l, z = ce.streaming_ce_stats(s.detach(), t.detach(), torch.from_numpy(answers), n_valid,
                                 dtype=BF16)
    assert torch.equal(l, loss.detach()) and torch.equal(z, logz)
    dloss = np.random.default_rng(2).uniform(0.5, 1.5, size=b).astype(np.float32)
    j_ds, j_dt = jax_streaming_ce_grads(js, jt, ja, jnp.asarray(z.numpy()), jnp.asarray(dloss),
                                        n_valid, 8, 128, True, BF16)
    ds, dt = ce.streaming_ce_grads(s.detach(), t.detach(), torch.from_numpy(answers), z,
                                   torch.from_numpy(dloss), n_valid, dtype=BF16)
    assert rel_err(ds, j_ds) <= BF16_GRAD_TOL and rel_err(dt, j_dt) <= BF16_GRAD_TOL
    # the fp32 form, which rounds nothing, fails that limit at the same logZ
    ds32, dt32 = ce.streaming_ce_grads(s.detach(), t.detach(), torch.from_numpy(answers), z,
                                       torch.from_numpy(dloss), n_valid)
    assert min(rel_err(ds32, j_ds), rel_err(dt32, j_dt)) > BF16_GRAD_TOL


@pytest.mark.parametrize("b,v,h,n_valid,seed", [(12, 300, 64, 290, 3), (5, 257, 48, 257, 4),
                                                (12, 300, 128, 290, 3), (5, 257, 256, 257, 4)])
def test_streaming_ce_bf16_matches_jax_on_exact_logits(b, v, h, n_valid, seed):
    """The sharp check of the bf16 form at H <= 256, where the card's
    on-chip (H <= 64) and middle-route (64 < H <= 256) kernels sum each
    logit on the tensor cores in their own order: on
    `parity.exact_logit_case` inputs (every logit exact in fp32 in any
    order; the states scaled by 2 at H <= 64, where the unscaled logits
    spread too little for the control, by 1 above) the plain bf16
    `ce_loss_logz` and `ce_grads` (at the port's logZ, given to both
    sides) against JAX's interpret-mode kernels, loss within CE_RTOL and
    each gradient group within `parity.BF16_GRAD_TOL`, which the fp32
    form, apart here only by not rounding p, must fail on ds and on dT's
    other rows. JAX's kernels take an H that divides 128 or is a multiple
    of it, so at H = 48 they get the inputs zero-padded to 64 columns (the
    port's kernels pad H to 64 on chip as well) and the first 48 columns
    of their gradients are compared; H = 128 and 256 go unpadded."""
    states, table, answers, dloss = parity.exact_logit_case(b, v, h, n_valid, seed=seed,
                                                            scale=2 if h <= 64 else 1)
    pad = ((0, 0), (0, max(64 - h, 0)))
    js = jnp.asarray(np.pad(states.numpy(), pad))
    jt = jnp.asarray(np.pad(table.numpy(), pad))
    ja = jnp.asarray(answers.numpy().astype(np.int32))
    j_loss = jax_streaming_softmax_ce(js, jt, ja, n_valid, 8, 128, True, BF16)
    loss, logz = ce.ce_loss_logz(states, table, answers, n_valid, dtype=BF16)
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), rtol=CE_RTOL)
    j_ds, j_dt = jax_streaming_ce_grads(js, jt, ja, jnp.asarray(logz.numpy()), jnp.asarray(dloss.numpy()),
                                        n_valid, 8, 128, True, BF16)
    j_ds = torch.from_numpy(np.asarray(j_ds)[:, :h].copy())
    j_dt = torch.from_numpy(np.asarray(j_dt)[:, :h].copy())
    ds, dt = ce.ce_grads(states, table, answers, logz, dloss, n_valid, dtype=BF16)
    errs = parity.grad_errors(ds, dt, j_ds, j_dt, answers, n_valid)
    assert max(errs.values()) <= BF16_GRAD_TOL, errs
    control = parity.grad_errors(*ce.ce_grads(states, table, answers, logz, dloss, n_valid), j_ds,
                                 j_dt, answers, n_valid)
    assert min(control["ds"], control["dT other rows"]) > BF16_GRAD_TOL, control

def test_ce_grads_plain_bf16_rounds_p_and_keeps_the_one_hot_terms_unrounded():
    """The plain bf16 backward, written out with numpy in float64 on the
    rounded operands: p rounded to bf16 before both products, the one-hot
    terms from the unrounded states and rows, duplicate answers summed."""
    b, v, h, n_valid = 6, 40, 8, 37
    states, table, answers = _ce_inputs(b, v, h, n_valid, seed=3)
    answers[3:] = [5, 5, 36]
    s, t, a = (torch.from_numpy(x) for x in (states, table, answers))
    logz = ce.ce_logz(s, t, n_valid, dtype=BF16)
    dloss = torch.linspace(0.5, 1.5, b)
    ds, dt = ce.ce_grads(s, t, a, logz, dloss, n_valid, dtype=BF16)
    sr, tr = rounded(s, True).double(), rounded(t[:n_valid], True).double()
    p = torch.exp(sr @ tr.T - logz.double()[:, None]) * dloss.double()[:, None]
    p = rounded(p.float(), True).double()
    want_ds, want_dt = p @ tr, torch.zeros(v, h, dtype=torch.float64)
    want_dt[:n_valid] = p.T @ sr
    for i, ai in enumerate(answers.tolist()):
        if 0 <= ai < n_valid:
            want_dt[ai] -= float(dloss[i]) * s[i].double()
            want_ds[i] -= float(dloss[i]) * t[ai].double()
    np.testing.assert_allclose(ds.numpy(), want_ds.numpy(), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(dt.numpy(), want_dt.numpy(), atol=1e-6, rtol=1e-5)


def test_one_hot_check_reads_the_term_off_ce_grads():
    """`parity.one_hot_excess`, which chip_smoke.py and the card's tests
    apply to the kernel, on the plain bf16 backward: dT on the answers
    (repeats included) against dT on answers of -1 holds, and fails where
    the one-hot term took the bf16-rounded states or a row no answer names
    moved."""
    b, v, h, n_valid = 16, 200, 32, 190
    states, table, answers = _ce_inputs(b, v, h, n_valid, seed=6)
    answers[3:6] = answers[6]
    s, t, a = (torch.from_numpy(x) for x in (states, table, answers))
    logz = ce.ce_logz(s, t, n_valid, dtype=BF16)
    dloss = torch.linspace(0.5, 1.5, b)
    _, dt = ce.ce_grads(s, t, a, logz, dloss, n_valid, dtype=BF16)
    _, none = ce.ce_grads(s, t, torch.full_like(a, -1), logz, dloss, n_valid, dtype=BF16)
    assert parity.one_hot_excess(dt, none, s, a, dloss, n_valid) <= 1.0
    assert parity.one_hot_excess(dt, none, s, a, dloss, n_valid, round_states=True) > 1.0
    keep = (a >= 0) & (a < n_valid)
    wrong = none.clone().index_add_(0, a[keep].long(), -(dloss[keep, None] * rounded(s[keep], True)))
    assert parity.one_hot_excess(wrong, none, s, a, dloss, n_valid) > 1.0
    moved = dt.clone()
    moved[0] += 1e-7  # _ce_inputs names no answer 0
    assert parity.one_hot_excess(moved, none, s, a, dloss, n_valid) == float("inf")


def test_dense_full_softmax_ce_bf16_matches_jax():
    b, v, h = 10, 120, 32
    states, table, answers = _ce_inputs(b, v, h, v, seed=4)
    answers[:3] = [1, 2, 3]  # the dense path gathers every answer
    js, jt, ja = jnp.asarray(states), jnp.asarray(table), jnp.asarray(answers)
    j_loss, (j_ds, j_dt) = jax.value_and_grad(
        lambda x, y: jlosses.full_softmax_ce(x, y, ja, impl="dense", dtype=BF16),
        argnums=(0, 1))(js, jt)
    s = torch.from_numpy(states).requires_grad_()
    t = torch.from_numpy(table).requires_grad_()
    loss = full_softmax_ce(s, t, torch.from_numpy(answers), impl="dense", dtype=BF16)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=CE_RTOL)
    # dense autodiff on both sides: the same roundings at the casts
    assert rel_err(s.grad, j_ds) <= 1e-4 and rel_err(t.grad, j_dt) <= 1e-4


def _jax_loss_fn(jmodel, fields):
    """The JAX training loss with dropout off; BERT4Rec's CE of the forward
    on the ids as given (cloze-masked by `jax_inputs`), at the model's
    compute dtype."""
    if fields["model_type"] == "bert4rec":
        def b4r(mdl, ids, answers):
            out = mdl.forward(ids, train=True)[:, -1, :]
            return jlosses.full_softmax_ce(out, mdl.item_table, answers, impl="dense",
                                           dtype=fields["compute_dtype"])

        return lambda p, ids, a, n, s, u: jmodel.apply({"params": p}, ids, a, method=b4r)

    def loss_fn(p, ids, a, n, s, u):
        if not _uses_sem(fields):
            s = jnp.zeros((ids.shape[0], 0), jnp.int32)
        return jmodel.apply({"params": p}, ids, a, n, s, u, train=True, method="calculate_loss",
                            rngs={"dropout": jax.random.PRNGKey(0)})
    return loss_fn


def _off_share(got, want) -> tuple[float, float]:
    """(share of the entries off by more than FWD_ATOL, largest |diff|)
    over all layers."""
    d = np.concatenate([np.abs(g.numpy() - np.asarray(w)).ravel() for g, w in zip(got, want)])
    return float((d > FWD_ATOL).mean()), float(d.max())


def _port_forward(fields, params, ids, users):
    model = port_model(fields, params)
    model.eval()
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long(), torch.from_numpy(users).long(), all_layers=True)
    return out if isinstance(out, (list, tuple)) else [out]


def _port_loss_and_grads(fields, params, batch):
    model = port_model(fields, params)
    model.train()
    loss = port_loss(model, batch)
    loss.backward()
    return loss, {k: p.grad for k, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("model_type", MODELS)
def test_model_bf16_matches_jax(model_type):
    """Forward, loss and gradients of the model at bf16 against JAX's
    (module docstring); Caser and GRU4Rec bit-identical to fp32."""
    fp32 = fields_of(model_type)
    fields = fields_of(model_type, compute_dtype=BF16)
    _, params = jax_model_and_params(fp32, 2)
    jmodel = jax_build_model(JaxModelConfig(**fields))
    ids, _, _, _, users = make_batch(fields, 0)
    want = _exact(lambda p, i, u: jmodel.apply({"params": p}, i, u, train=False,
                                               all_layers=True), params, ids, users)
    want = want if isinstance(want, (list, tuple)) else [want]
    got = _port_forward(fields, params, ids, users)
    got32 = _port_forward(fp32, params, ids, users)
    assert len(got) == len(want)
    share, worst = _off_share(got, want)
    assert share <= FLIP_SHARE and worst <= FLIP_ATOL, (share, worst)

    batch = make_batch(fields, 1)
    j_loss, j_grads = _exact(jax.value_and_grad(_jax_loss_fn(jmodel, fields)),
                             jax.tree.map(jnp.asarray, params), *jax_inputs(fields, batch))
    loss, grads = _port_loss_and_grads(fields, params, batch)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    want_grads = params_from_jax(jax.device_get(j_grads), base=port_model(fields).state_dict())
    top = max(float(want_grads[k].abs().max()) for k in grads)
    for name, g in grads.items():
        assert g.dtype == torch.float32
        scale = float(want_grads[name].abs().max())
        scale = scale if scale > 1e-6 * top else 1e-3 * top
        assert float((g - want_grads[name]).abs().max()) <= GRAD_TOL * scale, name

    if model_type in FP32_ONLY:
        assert all(torch.equal(a, b) for a, b in zip(got, got32))
        loss32, grads32 = _port_loss_and_grads(fp32, params, batch)
        assert torch.equal(loss, loss32) and grads.keys() == grads32.keys()
        assert all(torch.equal(g, grads32[k]) for k, g in grads.items())
    else:
        assert _off_share(got32, want)[0] >= FP32_SHARE


def _eval_fields():
    seqs = corpus_seqs()
    max_item = max(map(max, seqs))
    fields = fields_of("bsarec", hidden_size=16, item_size=max_item + 1,
                      num_users=len(seqs) + 1, compute_dtype=BF16)
    return seqs, max_item, fields


@pytest.mark.parametrize("eval_impl", ["dense", "streaming"])
def test_eval_bf16_matches_jax(eval_impl, tmp_path):
    """Both packages at bf16 on one corpus and the JAX trainer's weights:
    the test pass's metric sums and top-20 ids, the port's trainer against
    JAX's `build_eval_fn` on the JAX trainer's eval arrays. The dense path
    scores rounded operands, the streaming path (the rank kernel's plain
    version) stays fp32, on both sides."""
    seqs, max_item, fields = _eval_fields()
    seq_len = fields["max_seq_length"]
    jtrainer = JaxTrainer(JaxModelConfig(**fields),
                          JaxTrainConfig(eval_batch_size=32, eval_impl=eval_impl, seed=5),
                          JaxSeqRecData(JaxCorpus(user_seq=[list(s) for s in seqs],
                                                  max_item=max_item), seq_len),
                          quiet_logger(), str(tmp_path / "j.ckpt"))
    trainer = Trainer(ModelConfig(**fields),
                      TrainConfig(eval_batch_size=32, eval_impl=eval_impl, device="cpu"),
                      SeqRecData(Corpus(user_seq=[list(s) for s in seqs], max_item=max_item),
                                 seq_len),
                      quiet_logger(), str(tmp_path / "p.ckpt"))
    trainer.install_params(params_from_jax(jax.device_get(jtrainer.params),
                                           base=trainer.model.state_dict()))
    assert trainer.eval_impl == eval_impl
    dev = jtrainer._eval_dev["test"]
    want = []
    for collect in (False, True):
        fn, _, _ = jax_build_eval_fn(jtrainer.model, fields["item_size"], 32, len(seqs),
                                     impl=eval_impl, dtype=BF16, collect_topk=collect,
                                     seen_format=jtrainer._seen_format)
        want.append(np.asarray(_exact(fn, jtrainer.params, dev["inputs"], dev["answers"],
                                      dev["seen"])))
    np.testing.assert_allclose(trainer.evaluate_sums("test"), want[0], atol=1e-6, rtol=0)
    got = trainer.export_topk("test")
    assert got.shape == (len(seqs), 20)
    np.testing.assert_array_equal(got, want[1])


def _jax_artifact_topk(path, split, users):
    """The JAX artifact at `path` over the split, its program compiled with
    every bf16 rounding kept."""
    from jax import export as jexport

    with open(path, "rb") as fh:
        exported = jexport.deserialize(bytearray(fh.read()))
    return np.asarray(_exact(exported.call, *(jnp.asarray(x, jnp.int32) for x in (
        split.input_ids, users, split.seen_items))))


@pytest.fixture(scope="module")
def bf16_scorers(tmp_path_factory):
    """A bf16 BSARec on numpy-seeded weights in both packages, the test
    split, the JAX bf16 artifact's top-20 (default layout) and the port's
    bf16 artifact (default layout), loaded."""
    tmp = tmp_path_factory.mktemp("bf16_serving")
    seqs, max_item, fields = _eval_fields()
    jmodel, params = jax_model_and_params(fields, 6)
    model = port_model(fields, params)
    model.eval()
    data = SeqRecData(Corpus(user_seq=[list(s) for s in seqs], max_item=max_item),
                      fields["max_seq_length"])
    split = data.test
    seen_width = split.seen_items.shape[1]
    jpath, path = str(tmp / "scorer.jaxexp"), str(tmp / "scorer.pt2")
    jax_serving.export_scorer(jmodel, params, fields["item_size"], fields["max_seq_length"],
                              seen_width, jpath, dtype=BF16)
    meta = serving.export_scorer(model, fields["item_size"], fields["max_seq_length"],
                                 seen_width, path, dtype=BF16)
    users = np.arange(split.num_users, dtype=np.int32)
    return dict(fields=fields, model=model, split=split, users=users, meta=meta,
                want=_jax_artifact_topk(jpath, split, users), jmodel=jmodel, params=params,
                scorer=serving.load_scorer(path, "cpu"))


@pytest.mark.parametrize("impl,quant", [(impl, None) for impl in serving.IMPLS]
                         + [("bitmask", "int8")])
def test_bf16_scorer_matches_jax_artifact(bf16_scorers, impl, quant):
    """Each layout at bf16 ranks the test split as the JAX bf16 artifact
    does, ids equal (the logits are fp32 sums of exact products of the
    same rounded operands): the default layout through its exported
    artifact, the others through the module that `export_scorer`
    exports. int8 ignores the dtype on both sides, so it is held against
    JAX's bf16 int8 scoring function."""
    d = bf16_scorers
    f, split = d["fields"], d["split"]
    if (impl, quant) == ("bitmask", None):
        assert d["meta"]["dtype"] == BF16
        got = d["scorer"].topk(split.input_ids, d["users"], split.seen_items)
        np.testing.assert_array_equal(got, d["want"])
        return
    args = [np.asarray(x, np.int32) for x in (split.input_ids, d["users"], split.seen_items)]
    module = serving.build_scoring_fn(d["model"], f["item_size"], quant=quant, impl=impl,
                                      item_chunk=8 if impl == "chunked" else 65536, dtype=BF16)
    with torch.no_grad():
        got = module(*(torch.from_numpy(x) for x in args)).numpy()
    if quant is None:
        np.testing.assert_array_equal(got, d["want"])
        return
    fn = jax_serving.build_scoring_fn(d["jmodel"], f["item_size"], dtype=BF16, quant=quant)
    np.testing.assert_array_equal(got, np.asarray(_exact(fn, d["params"], *map(jnp.asarray, args))))


def test_bf16_scorer_rounds_the_table_once_at_export(bf16_scorers):
    """The bf16 scorer holds the rounded table beside the model's own (the
    fp32 one holds none), and an fp32 scorer of the same bf16 model ranks
    the split another way somewhere."""
    d = bf16_scorers
    f, split = d["fields"], d["split"]
    module = serving.build_scoring_fn(d["model"], f["item_size"], dtype=BF16)
    table = d["model"].item_table[:f["item_size"]]
    assert torch.equal(module.rounded_table, table.detach().to(torch.bfloat16).float())
    fp32 = serving.build_scoring_fn(d["model"], f["item_size"])
    assert not hasattr(fp32, "rounded_table")
    with torch.no_grad():
        got = fp32(*(torch.from_numpy(np.asarray(x, np.int32))
                     for x in (split.input_ids, d["users"], split.seen_items))).numpy()
    assert (got != d["want"]).any()


def test_main_bf16_trains_resumes_and_exports(tmp_path):
    """`main --dtype bf16 --device cpu`: 1 epoch, --resume to 2, equal to a
    straight 2-epoch run; its weights differ from an fp32 run's; then the
    test pass with --export_topk and --export_serving."""
    from bsarec_tpu_torch.main import main as port_main
    from bsarec_tpu_torch.train.checkpoint import load_train_state

    log = check_main_trains_and_resumes("BSARec", tmp_path, "--dtype", "bf16")
    assert "'dtype': 'bf16'" in log
    common = ["--device", "cpu", "--data_dir", str(tmp_path), "--data_name", "Toy",
              "--output_dir", str(tmp_path), "--model_type", "BSARec", "--max_seq_length", "10",
              "--hidden_size", "16", "--batch_size", "16", "--lr", "0.005"]
    port_main(common + ["--train_name", "fp32", "--epochs", "2"])
    bf16 = load_train_state(tmp_path / "straight.ckpt.state")["params"]
    fp32 = load_train_state(tmp_path / "fp32.ckpt.state")["params"]
    assert all(v.dtype == torch.float32 for v in bf16.values())
    assert any(not torch.equal(v, fp32[k]) for k, v in bf16.items())

    topk_path, scorer_path = tmp_path / "topk.npy", tmp_path / "scorer.pt2"
    scores = port_main(common + ["--dtype", "bf16", "--train_name", "eval", "--do_eval",
                                 "--load_model", "straight", "--export_topk", str(topk_path),
                                 "--export_serving", str(scorer_path)])
    assert len(scores) == 6 and all(0.0 <= s <= 1.0 for s in scores)
    topk = np.load(topk_path)
    assert topk.shape[1] == 20 and topk.min() >= 0
    scorer = serving.load_scorer(str(scorer_path), "cpu")
    assert scorer.meta["dtype"] == BF16
    assert scorer.topk(np.zeros((3, 10), np.int32) + 5).shape == (3, 20)

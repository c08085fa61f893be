"""The model zoo of the port against the JAX package, and the harness that
`tests/test_torch_port_<model>.py` run for each of the six models ported
after BSARec and SASRec (FMLP-Rec, BERT4Rec, GRU4Rec, Caser, DuoRec,
FEARec).

Here: the zoo's losses, masks and spectral ops on the same seeded
inputs; the parameter counts of all eight models; `sample_same_target`
pick for pick against JAX's numpy path.

The harness (`check_*`), on numpy-seeded weights carried both ways
(`params_from_jax`, then JAX's `import_torch_checkpoint` on the port's
`state_dict`), dropout off, the same batch (negatives, same-target view
and user ids included):
- the forward (all layers) and `predict` within atol FWD_ATOL = 1e-5;
- the loss within rtol 1e-5 and the gradients within rtol 1e-4 of each
  tensor's largest entry. A tensor whose true gradient is zero (FEARec's
  query and key biases where the layer's band leaves out bin 0, the
  attention key biases) holds rounding noise on both sides; it is held
  to 1e-4 of the model's largest gradient entry instead;
- the parameters after 3 Adam steps (lr 5e-4, weight decay 0.01) within
  atol 1e-6 of optax's. Adam's step is lr * f(G), f(G) = G / (|G| + 1e-8),
  G the gradient with the decay added: where an entry's G falls below
  ADAM_FRAGILE_GRAD = 1e-6 at some step, fp32 rounding of ~1e-9 in G moves
  that step by up to 1e-5 (4.2e-6 on one BERT4Rec dense_2 entry whose
  gradients read 2.74e-9 and 2.87e-9, within 2e-7 of the tensor's
  largest), and the later steps carry it on through Adam's moments. So
  every entry is also held after the first step, where both sides start
  from the same weights: the gradients within the tolerance t above, and
  the parameters within atol 1e-6 plus lr * |f(G + d) - f(G)|, d the
  measured gradient difference clamped to +-t (a zeroed gradient with
  |G| > t then fails). After 3 steps the entries whose G stayed at or
  above ADAM_FRAGILE_GRAD are held within atol 1e-6; the others (their
  count per model pinned in its file, under 2% of the entries) were held
  at the first step only;
- the dense and the streaming eval top-20 (JAX's Pallas kernel in
  interpret mode, the port's plain version of the rank kernel) equal to
  JAX's;
- `main --model_type <M> --device cpu` trains 1 epoch, resumes for a
  second and ends where an uninterrupted 2-epoch run ends.
The sums run in another order than XLA's in every comparison (and through
`torch.fft` for FMLP-Rec's filter, `Conv2d` for Caser's bank), which the
tolerances above take: fp32 rounding of 10-60 term sums stays near 1e-6
relative, two orders under them.

BERT4Rec's JAX loss draws its cloze positions from its own stream, so
both sides there take the loss of the forward on the ids that the port's
`cloze_mask` gives from one seeded generator; the port's
`calculate_loss`, given a generator with that seed, is held to it.
"""

from __future__ import annotations

import functools
import logging
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bsarec_tpu import native as jax_native
from bsarec_tpu.config import ModelConfig as JaxModelConfig
from bsarec_tpu.config import TrainConfig as JaxTrainConfig
from bsarec_tpu.data.corpus import Corpus as JaxCorpus
from bsarec_tpu.data.pipeline import SeqRecData as JaxSeqRecData
from bsarec_tpu.models import build_model as jax_build_model
from bsarec_tpu.ops import frequency as jfreq
from bsarec_tpu.ops import losses as jlosses
from bsarec_tpu.ops import masks as jmasks
from bsarec_tpu.train.loop import make_optimizer as jax_make_optimizer
from bsarec_tpu.train.torch_import import import_torch_checkpoint
from bsarec_tpu.train.trainer import Trainer as JaxTrainer
from bsarec_tpu_torch import native as port_native
from bsarec_tpu_torch.config import ModelConfig, TrainConfig
from bsarec_tpu_torch.data.corpus import Corpus
from bsarec_tpu_torch.data.pipeline import SeqRecData
from bsarec_tpu_torch.models import MODEL_REGISTRY, build_model
from bsarec_tpu_torch.models.bert4rec import cloze_mask
from bsarec_tpu_torch.ops import frequency, losses, masks
from bsarec_tpu_torch.train.jax_import import params_from_jax
from bsarec_tpu_torch.train.loop import make_optimizer
from bsarec_tpu_torch.train.trainer import Trainer

FWD_ATOL, LOSS_RTOL, GRAD_RTOL, PARAM_ATOL = 1e-5, 1e-5, 1e-4, 1e-6
OPS_ATOL = 1e-6
# a tensor's gradient counts as zero below this share of the model's largest
ZERO_GRAD_SHARE = 1e-6
SMALL = dict(item_size=60, num_users=30, max_seq_length=10, hidden_size=32,
             num_hidden_layers=2, num_attention_heads=2, hidden_dropout_prob=0.0,
             attention_probs_dropout_prob=0.0, nh=2, nv=2, gru_hidden_size=24)
OPT = dict(lr=5e-4, weight_decay=0.01)
# entries whose gradient falls below this at some Adam step are held at the
# first step only (module docstring)
ADAM_FRAGILE_GRAD = 1e-6
ADAM_STEPS = 3
# the reference layout's entries that GRU4Rec's and Caser's forward never
# reads and JAX's trees lack: [L, H] position rows and the LayerNorm's 2H
UNUSED_BASE = ("gru4rec", "caser")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test (restored after): at these sizes more
    threads gain nothing, and six workers of eight threads each on the
    test host's cores made the `main` runs 10x slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fields_of(model_type: str, **extra) -> dict:
    return dict(SMALL, model_type=model_type, **extra)


def jax_model_and_params(fields: dict, seed: int = 0):
    """The JAX model and its initialized params with numpy noise on every
    leaf (nonzero biases, LayerNorm terms and padding rows)."""
    fns = _jax_fns(_key(fields))
    params = jax.device_get(fns.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.normal(size=x.shape).astype(np.float32),
                          params)
    return fns.jmodel, params


def port_model(fields: dict, params=None, seed: int = 0):
    model = build_model(ModelConfig(**fields), generator=torch.Generator().manual_seed(seed))
    if params is not None:  # strict: every key carried
        model.load_state_dict(params_from_jax(params, base=model.state_dict()))
    return model


def make_batch(fields: dict, seed: int, b: int = 12):
    """ids [b, L] (left-padded), answers (the last one 0, a row the masked
    losses skip), negatives, the same-target view and user ids."""
    rng = np.random.default_rng(seed)
    n_items, seq_len = fields["item_size"], fields["max_seq_length"]
    ids = rng.integers(1, n_items, size=(b, seq_len)).astype(np.int32)
    for r in range(b):
        ids[r, : rng.integers(0, seq_len)] = 0
    answers = rng.integers(1, n_items, size=b).astype(np.int32)
    answers[-1] = 0
    negs = rng.integers(1, n_items, size=b).astype(np.int32)
    sem = np.roll(ids, 3, axis=0)
    users = rng.integers(0, fields["num_users"], size=b).astype(np.int32)
    return ids, answers, negs, sem, users


def _uses_sem(fields):
    return fields["model_type"] in ("duorec", "fearec")


def _key(fields: dict) -> tuple:
    return tuple(sorted(fields.items()))


@functools.lru_cache(maxsize=None)
def _jax_fns(key: tuple):
    """The JAX model of `dict(key)` and its jitted init, forward, predict
    and loss gradient, built once a process: the tests of one model share
    their compiles."""
    fields = dict(key)
    jmodel = jax_build_model(JaxModelConfig(**fields))
    dummy = jnp.zeros((2, fields["max_seq_length"]), jnp.int32)
    return types.SimpleNamespace(
        jmodel=jmodel,
        init=jax.jit(lambda k: jmodel.init({"params": k, "dropout": k}, dummy,
                                           train=False)["params"]),
        forward=jax.jit(lambda p, ids, users: jmodel.apply(
            {"params": p}, ids, users, train=False, all_layers=True)),
        predict=jax.jit(lambda p, ids, users: jmodel.apply(
            {"params": p}, ids, users, method="predict")),
        grad=jax.jit(jax.value_and_grad(jax_loss_fn(jmodel, fields))))


def jax_loss_fn(jmodel, fields):
    """(params, ids, answers, negs, sem, users) -> the JAX training loss,
    dropout off. BERT4Rec: the CE of the forward on `ids` as given (the
    caller masks them, module docstring)."""
    if fields["model_type"] == "bert4rec":
        def b4r(mdl, ids, answers):
            out = mdl.forward(ids, train=True)[:, -1, :]
            return jlosses.full_softmax_ce(out, mdl.item_table, answers, impl="dense")

        def loss_fn(params, ids, answers, negs, sem, users):
            return jmodel.apply({"params": params}, ids, answers, method=b4r)
        return loss_fn

    def loss_fn(params, ids, answers, negs, sem, users):
        if not _uses_sem(fields):
            sem = jnp.zeros((ids.shape[0], 0), jnp.int32)
        return jmodel.apply({"params": params}, ids, answers, negs, sem, users, train=True,
                            method="calculate_loss", rngs={"dropout": jax.random.PRNGKey(0)})
    return loss_fn


def _mask_seed(step: int) -> int:
    return 100 + step


def jax_inputs(fields, batch, step=0):
    """The batch as JAX arrays; BERT4Rec's ids cloze-masked as the port
    masks them with the generator seeded `_mask_seed(step)`."""
    ids, answers, negs, sem, users = batch
    if fields["model_type"] == "bert4rec":
        mask_num = int(fields["max_seq_length"] * 0.2)
        ids = cloze_mask(torch.from_numpy(ids).long(), mask_num, fields["item_size"],
                         torch.Generator().manual_seed(_mask_seed(step))).numpy().astype(np.int32)
    return tuple(jnp.asarray(x) for x in (ids, answers, negs, sem, users))


def port_loss(model, batch, step=0):
    ids, answers, negs, sem, users = (torch.from_numpy(x).long() for x in batch)
    return model.calculate_loss(ids, answers, negs, sem, users,
                                generator=torch.Generator().manual_seed(_mask_seed(step)))


# ---- the per-model harness ---------------------------------------------------


def check_forward_both_ways(fields):
    """JAX weights -> port, and port weights -> JAX (`import_torch_checkpoint`):
    every layer's output and `predict` within FWD_ATOL."""
    mt = fields["model_type"]
    jmodel, params = jax_model_and_params(fields)
    model = port_model(fields, params)
    ids, _, _, _, users = make_batch(fields, 0)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(users).long(), all_layers=True)
        got_pred = model.predict(torch.from_numpy(ids).long(), torch.from_numpy(users).long())
    fns = _jax_fns(_key(fields))
    want = fns.forward(params, jnp.asarray(ids), jnp.asarray(users))
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want) == fields["num_hidden_layers"] + 1
    else:
        got, want = [got], [want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FWD_ATOL, rtol=0)
    want_pred = fns.predict(params, jnp.asarray(ids), jnp.asarray(users))
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred), atol=FWD_ATOL, rtol=0)

    fresh = port_model(fields, seed=3)
    back = import_torch_checkpoint(mt, fresh.state_dict(), num_layers=fields["num_hidden_layers"],
                                   max_seq_length=fields["max_seq_length"])
    fresh.eval()
    with torch.no_grad():
        got = fresh.predict(torch.from_numpy(ids).long(), torch.from_numpy(users).long())
    want = fns.predict(back, jnp.asarray(ids), jnp.asarray(users))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL, rtol=0)
    return model


def trained_names(model) -> set:
    """The parameters the model's loss reads: all but the unused base
    entries of GRU4Rec and Caser."""
    names = {k for k, _ in model.named_parameters()}
    if model.config.model_type in UNUSED_BASE:
        names -= {"position_embeddings.weight", "LayerNorm.weight", "LayerNorm.bias"}
    return names


def _zero_grad_names(want: dict, used: set) -> set:
    top = max(float(want[k].abs().max()) for k in used)
    return {k for k in used if float(want[k].abs().max()) <= ZERO_GRAD_SHARE * top}


def check_loss_and_gradients(fields):
    jmodel, params = jax_model_and_params(fields, 2)
    model = port_model(fields, params)
    batch = make_batch(fields, 1)
    jloss, jgrads = _jax_fns(_key(fields)).grad(
        jax.tree.map(jnp.asarray, params), *jax_inputs(fields, batch))
    model.train()
    loss = port_loss(model, batch)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want = params_from_jax(jax.device_get(jgrads), base=model.state_dict())
    used = {k for k, p in model.named_parameters() if p.grad is not None}
    assert used == trained_names(model)
    zero = _zero_grad_names(want, used)
    top = max(float(want[k].abs().max()) for k in used)
    for name, p in model.named_parameters():
        if name not in used:
            continue
        scale = top if name in zero else float(want[name].abs().max())
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_RTOL * scale,
                                   rtol=0, err_msg=name)
    return model, used, zero


def _adam_f(g):
    """Adam's first step over lr: G / (|G| + eps), in float64."""
    g = g.double()
    return g / (g.abs() + 1e-8)


def check_first_adam_step(model, want_grads, decayed, got_grads, want_params):
    """Both sides took one Adam step from the same weights: the gradients
    within t = GRAD_RTOL of each tensor's largest JAX entry (of the model's
    largest for a zero-gradient tensor) and every parameter within
    PARAM_ATOL + lr * |f(G + d) - f(G)|, d = port - JAX gradient clamped
    to +-t (module docstring)."""
    used = set(got_grads)
    assert used == trained_names(model)
    zero = _zero_grad_names(want_grads, used)
    top = max(float(want_grads[k].abs().max()) for k in used)
    got = model.state_dict()
    for name, value in want_params.items():
        allow = torch.zeros(value.shape, dtype=torch.float64)
        if name in used:
            tol = GRAD_RTOL * (top if name in zero else float(want_grads[name].abs().max()))
            diff = got_grads[name] - want_grads[name]
            assert float(diff.abs().max()) <= tol, name
            g = decayed[name]
            allow = OPT["lr"] * (_adam_f(g + diff.clamp(-tol, tol)) - _adam_f(g)).abs()
        excess = (got[name].double() - value.double()).abs() - allow
        assert float(excess.max()) <= PARAM_ATOL, name


def check_adam_steps(fields):
    """3 Adam steps against optax (module docstring); returns the number
    of entries held at the first step only."""
    jmodel, params = jax_model_and_params(fields, 4)
    model = port_model(fields, params)
    model.train()
    optimizer = make_optimizer(model.parameters(), TrainConfig(**OPT))
    tx = jax_make_optimizer(JaxTrainConfig(**OPT))
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    grad_fn = _jax_fns(_key(fields)).grad
    start = params_from_jax(params, base=model.state_dict())
    fragile = {k: torch.zeros_like(v, dtype=torch.bool) for k, v in start.items()}
    for i in range(ADAM_STEPS):
        batch = make_batch(fields, 10 + i)
        jloss, grads = grad_fn(jparams, *jax_inputs(fields, batch, i))
        g = params_from_jax(jax.device_get(grads), base=model.state_dict())
        w = params_from_jax(jax.device_get(jparams), base=start)
        decayed = {k: g[k] + OPT["weight_decay"] * w[k] for k in trained_names(model)}
        for k, v in decayed.items():  # the gradient Adam sees
            fragile[k] |= v.abs() < ADAM_FRAGILE_GRAD
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        loss = port_loss(model, batch, i)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        got_grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
                     if p.grad is not None}
        optimizer.step()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
        if i == 0:
            check_first_adam_step(model, g, decayed, got_grads,
                                  params_from_jax(jax.device_get(jparams), base=start))
    want = params_from_jax(jax.device_get(jparams), base=start)
    got = model.state_dict()
    assert got.keys() == want.keys()
    n_fragile = sum(int(f.sum()) for f in fragile.values())
    assert n_fragile <= 0.02 * sum(v.numel() for v in start.values()), n_fragile
    for name, value in want.items():
        f = fragile[name]
        np.testing.assert_allclose(got[name][~f].numpy(), value[~f].numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)
    return n_fragile


def corpus_seqs(n_users=70, n_items=60, seed=0):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_users):
        start, length = rng.integers(1, n_items - 1), rng.integers(3, 14)
        seqs.append([int((start + 3 * i) % (n_items - 1) + 1) for i in range(length)])
    return seqs


def quiet_logger(name="test_torch_port_zoo"):
    logger = logging.getLogger(name)
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


def check_eval_top20(fields, eval_impl, tmp_path):
    """Both trainers on one corpus and the JAX trainer's weights: the
    metric sums and the exported top-20 ids."""
    seqs = corpus_seqs()
    max_item = max(map(max, seqs))
    fields = dict(fields, hidden_size=16, item_size=max_item + 1, num_users=len(seqs) + 1)
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
    np.testing.assert_allclose(trainer.test(0)[0], jtrainer.test(0)[0], atol=1e-6, rtol=0)
    got = trainer.export_topk("test")
    assert got.shape == (len(seqs), 20)
    np.testing.assert_array_equal(got, np.asarray(jtrainer.export_topk("test")))
    return trainer


def write_toy(tmp_path, n_users=40, n_items=50):
    (tmp_path / "Toy.txt").write_text(
        "".join(f"{u + 1} {' '.join(map(str, s))}\n"
                for u, s in enumerate(corpus_seqs(n_users, n_items))))


def check_main_trains_and_resumes(model_type, tmp_path, *extra_flags, prng="threefry"):
    """`main --model_type <M> --device cpu`: 1 epoch, then --resume to 2,
    equal to an uninterrupted 2-epoch run (scores and parameters).
    Returns the resumed run's log."""
    from bsarec_tpu_torch.main import main as port_main
    from bsarec_tpu_torch.train.checkpoint import load_train_state

    write_toy(tmp_path)
    common = ["--device", "cpu", "--data_dir", str(tmp_path), "--data_name", "Toy",
              "--output_dir", str(tmp_path), "--model_type", model_type, "--max_seq_length", "10",
              "--hidden_size", "16", "--batch_size", "16", "--lr", "0.005", "--prng", prng,
              *extra_flags]

    def run(name, *extra):
        return port_main(common + ["--train_name", name, *extra])

    scores = run("run", "--epochs", "1")
    assert len(scores) == 6 and all(0.0 <= s <= 1.0 for s in scores)
    resumed = run("run", "--epochs", "2", "--resume")
    log = (tmp_path / "run.log").read_text()
    assert "resumed full train state" in log and log.count("'epoch': 0,") == 1
    straight = run("straight", "--epochs", "2")
    assert resumed == straight
    a = load_train_state(tmp_path / "run.ckpt.state")
    b = load_train_state(tmp_path / "straight.ckpt.state")
    assert a["epoch"] == b["epoch"] == 1
    assert all(torch.equal(v, b["params"][k]) for k, v in a["params"].items())
    return log


def check_serving_matches_jax(fields, tmp_path):
    """Both packages' default (bitmask) serving artifacts on the same
    weights: the top-20 of the eval corpus's test split, with the users'
    ids, equal. Returns the port's scorer and the split's arrays."""
    from bsarec_tpu import serving as jax_serving
    from bsarec_tpu_torch import serving

    seqs = corpus_seqs()
    max_item = max(map(max, seqs))
    fields = dict(fields, hidden_size=16, item_size=max_item + 1, num_users=len(seqs) + 1)
    jmodel, params = jax_model_and_params(fields, 6)
    model = port_model(fields, params)
    data = SeqRecData(Corpus(user_seq=[list(s) for s in seqs], max_item=max_item),
                      fields["max_seq_length"])
    split = data.test
    seen_width = split.seen_items.shape[1]
    jpath, path = str(tmp_path / "scorer.jaxexp"), str(tmp_path / "scorer.pt2")
    jax_serving.export_scorer(jmodel, params, fields["item_size"], fields["max_seq_length"],
                              seen_width, jpath)
    serving.export_scorer(model, fields["item_size"], fields["max_seq_length"], seen_width, path)
    jscorer, scorer = jax_serving.load_scorer(jpath), serving.load_scorer(path, "cpu")
    users = np.arange(split.num_users, dtype=np.int32)
    got = scorer.topk(split.input_ids, users, split.seen_items)
    np.testing.assert_array_equal(got, np.asarray(jscorer.topk(split.input_ids, users,
                                                                split.seen_items)))
    assert got.max() < fields["item_size"]
    return scorer, split, users


# ---- the zoo's ops -------------------------------------------------------------


def _pair_logits(seed=0, b=9):
    rng = np.random.default_rng(seed)
    pos, neg = (3.0 * rng.normal(size=b).astype(np.float32) for _ in range(2))
    pos[0], neg[1] = 40.0, -40.0  # saturated sigmoids: the eps terms count
    return pos, neg


@pytest.mark.parametrize("name", ["pair_logsigmoid_bce", "bpr_loss"])
def test_pair_losses_match_jax(name):
    pos, neg = _pair_logits()
    got = getattr(losses, name)(torch.from_numpy(pos), torch.from_numpy(neg))
    want = getattr(jlosses, name)(jnp.asarray(pos), jnp.asarray(neg))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("sim", ["dot", "cos"])
def test_info_nce_matches_jax(sim):
    rng = np.random.default_rng(1)
    z_i, z_j = (rng.normal(size=(7, 16)).astype(np.float32) for _ in range(2))
    zi_t = torch.from_numpy(z_i).requires_grad_()
    got = losses.info_nce_logits(zi_t, torch.from_numpy(z_j), 0.7, sim)
    got.backward()
    want, want_grad = jax.value_and_grad(
        lambda a: jlosses.info_nce_logits(a, jnp.asarray(z_j), 0.7, sim))(jnp.asarray(z_i))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(zi_t.grad.numpy(), np.asarray(want_grad), atol=OPS_ATOL, rtol=0)


def test_bidirectional_mask_matches_jax():
    ids = np.random.default_rng(2).integers(0, 5, size=(4, 9)).astype(np.int32)
    got = masks.bidirectional_additive_mask(torch.from_numpy(ids)).numpy()
    want = np.asarray(jmasks.bidirectional_additive_mask(jnp.asarray(ids)))
    assert got.shape == want.shape == (4, 1, 1, 9)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seq_len", [10, 50, 7])
def test_torch_fft_filter_matches_jax_dft_matmuls(seq_len):
    """`complex_filter_apply` on torch.fft against JAX's DFT matmuls
    (atol 1e-6, fp32 sums of L terms), and its gradient in the weight."""
    rng = np.random.default_rng(seq_len)
    x = rng.normal(size=(3, seq_len, 8)).astype(np.float32)
    w = 0.5 * rng.normal(size=(1, seq_len // 2 + 1, 8, 2)).astype(np.float32)
    w_t = torch.from_numpy(w).requires_grad_()
    got = frequency.complex_filter_apply(torch.from_numpy(x), w_t)
    got.square().sum().backward()

    def jax_out(wr, wi):
        return jfreq.complex_filter_apply(jnp.asarray(x), wr, wi)

    want = jax_out(jnp.asarray(w[..., 0]), jnp.asarray(w[..., 1]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=OPS_ATOL, rtol=0)
    g_re, g_im = jax.grad(lambda a, b: jnp.sum(jax_out(a, b) ** 2), argnums=(0, 1))(
        jnp.asarray(w[..., 0]), jnp.asarray(w[..., 1]))
    want_grad = np.stack([g_re, g_im], -1)  # sums of B * H squares: 1e-6 of the largest entry
    np.testing.assert_allclose(w_t.grad.numpy(), want_grad, atol=1e-6 * np.abs(want_grad).max(),
                               rtol=0)
    re, im = frequency.rfft_real_imag(torch.from_numpy(x), dim=1)
    want_re, want_im = jfreq.rfft_real_imag(jnp.asarray(x), axis=1)
    np.testing.assert_allclose(re.numpy(), np.asarray(want_re), atol=OPS_ATOL, rtol=0)
    np.testing.assert_allclose(im.numpy(), np.asarray(want_im), atol=OPS_ATOL, rtol=0)


@pytest.mark.parametrize("seq_len,left,right", [(50, 10, 26), (50, 0, 16), (9, 1, 4)])
def test_bandpass_matrices_match_jax(seq_len, left, right):
    for got, want in zip(frequency.bandpass_matrices(seq_len, left, right),
                         jfreq.bandpass_matrices(seq_len, left, right)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ---- the zoo's models ----------------------------------------------------------


def test_registry_takes_the_eight_model_types():
    assert sorted(MODEL_REGISTRY) == sorted(
        ["bsarec", "sasrec", "bert4rec", "fmlprec", "caser", "gru4rec", "duorec", "fearec"])


@pytest.mark.parametrize("model_type", sorted(MODEL_REGISTRY))
def test_parameter_count_matches_jax(model_type):
    """Port parameters = JAX parameters at the test widths (counterpart of
    `tests/test_models.py:68`), plus the unused base entries where JAX's
    tree has none."""
    fields = fields_of(model_type)
    _, params = jax_model_and_params(fields)
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    model = port_model(fields)
    n_port = sum(p.numel() for p in model.parameters())
    extra = (fields["max_seq_length"] + 2) * fields["hidden_size"] if model_type in UNUSED_BASE else 0
    assert n_port == n_jax + extra


def test_bsarec_beauty_parameter_count():
    """878,208 parameters for the Beauty config, as `tests/test_models.py:68`."""
    cfg = ModelConfig(model_type="bsarec", item_size=12102, num_users=22364, max_seq_length=50,
                      hidden_size=64, num_hidden_layers=2, num_attention_heads=1, c=5, alpha=0.7)
    assert sum(p.numel() for p in build_model(cfg).parameters()) == 878208


# ---- the same-target view ------------------------------------------------------


def _same_target_corpus(n_users=120, n_items=25, seed=3):
    """Short histories over few items: many shared answers, repeated input
    rows (groups with and without a distinct member) and re-picks."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(1, n_items - 4, size=rng.integers(3, 8)).tolist() for _ in range(n_users)]
    # identical rows sharing answers; item 23 is only ever a first item, so
    # its group holds three all-padding rows and nothing else
    seqs += [[1, 2, 3, 4]] * 5 + [[7, 9]] * 3 + [[23, 5, 6, 7]] * 3
    return seqs


def test_sample_same_target_matches_jax_numpy_path(monkeypatch):
    """Pick for pick, three epochs from one seed, with the JAX side's
    native sampler and the port's native library switched off (the native
    samplers are held together in tests/test_torch_port_native.py)."""
    monkeypatch.setattr(jax_native, "same_target_pick", lambda *a, **k: None)
    monkeypatch.setattr(port_native, "lib", lambda: None)
    seqs = _same_target_corpus()
    jdata = JaxSeqRecData(JaxCorpus(user_seq=[list(s) for s in seqs], max_item=24), 6)
    data = SeqRecData(Corpus(user_seq=[list(s) for s in seqs], max_item=24), 6)
    jrng, rng = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(3):
        np.testing.assert_array_equal(data.sample_same_target(rng), jdata.sample_same_target(jrng))
    assert rng.bit_generator.state == jrng.bit_generator.state
    jgroups, groups = jdata._same_target_groups, data._same_target_groups
    for j in range(3):  # order, starts, ends
        np.testing.assert_array_equal(groups[j], jgroups[j])
    np.testing.assert_array_equal(groups[3], jgroups[3])  # the diversity flags
    multi = (groups[2] - groups[1]) > 1
    assert (multi & groups[3]).any() and (multi & ~groups[3]).any()

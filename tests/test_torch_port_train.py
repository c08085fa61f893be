"""Port training vs the JAX package: Adam steps from the same weights and
batches (dropout 0), the padding-row rule, the epoch order, early
stopping, train-state snapshots and `main` without `--do_eval`.

Tolerance of the step parity: both sides compute the loss and gradients
in fp32 with sums taken in another order, and Adam divides each gradient
by its own running magnitude, so rounding in a gradient moves its
parameter by its relative size times lr. Parameters agree within atol
1e-6 (lr 5e-4), the loss within rtol 1e-5. The attention key biases are
the exception: their true gradient is exactly zero (softmax does not
change when every key's score moves by the same q . b), so on both
sides Adam steps on rounding noise; they are held to |b| <= steps · lr."""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsarec_tpu.config import ModelConfig as JaxModelConfig
from bsarec_tpu.config import TrainConfig as JaxTrainConfig
from bsarec_tpu.models import build_model as jax_build_model
from bsarec_tpu.train.loop import build_train_step
from bsarec_tpu.train.loop import make_optimizer as jax_make_optimizer
from bsarec_tpu_torch.config import ModelConfig, TrainConfig
from bsarec_tpu_torch.data.corpus import Corpus
from bsarec_tpu_torch.data.pipeline import SeqRecData
from bsarec_tpu_torch.models import build_model
from bsarec_tpu_torch.ops.losses import full_softmax_ce
from bsarec_tpu_torch.train.jax_import import params_from_jax
from bsarec_tpu_torch.train.loop import epoch_permutation, make_optimizer, sample_negatives
from bsarec_tpu_torch.train.trainer import Trainer
from bsarec_tpu_torch.utils.early_stopping import EarlyStopping

PARAM_ATOL, LOSS_RTOL = 1e-6, 1e-5
FIELDS = dict(model_type="bsarec", item_size=60, num_users=30, max_seq_length=10,
              hidden_size=32, num_hidden_layers=2, num_attention_heads=2, c=3, alpha=0.7,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
OPT = dict(lr=5e-4, weight_decay=0.01)


def _batch(seed, b=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, FIELDS["item_size"], size=(b, FIELDS["max_seq_length"])).astype(np.int32)
    for r in range(b):
        ids[r, : rng.integers(0, FIELDS["max_seq_length"])] = 0  # left padding
    answers = rng.integers(1, FIELDS["item_size"], size=b).astype(np.int32)
    return ids, answers


@pytest.mark.parametrize("loss_impl", ["dense", "streaming"])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_adam_steps_match_jax(loss_impl, n_steps):
    """JAX's `build_train_step` (its streaming CE in interpret mode) and
    the port's loss.backward() + Adam from the same weights and batches."""
    jcfg = JaxModelConfig(**FIELDS, loss_impl=loss_impl)
    jmodel = jax_build_model(jcfg)
    key = jax.random.PRNGKey(0)
    dummy = jnp.zeros((2, FIELDS["max_seq_length"]), jnp.int32)
    params = jmodel.init({"params": key, "dropout": key}, dummy, train=False)["params"]
    rng = np.random.default_rng(1)  # a nonzero padding row, as after training
    params = jax.device_get(params)
    table = np.asarray(params["item_embeddings"]["embedding"]).copy()
    table[0] = 0.02 * rng.normal(size=table.shape[1])
    params["item_embeddings"]["embedding"] = table

    model = build_model(ModelConfig(**FIELDS, loss_impl=loss_impl))
    model.load_state_dict(params_from_jax(params))
    model.train()
    optimizer = make_optimizer(model.parameters(), TrainConfig(**OPT))

    tx = jax_make_optimizer(JaxTrainConfig(**OPT))
    opt_state = tx.init(params)
    step = build_train_step(jmodel, tx, FIELDS["item_size"], with_sem=False)
    jparams = jax.tree.map(jnp.asarray, params)
    for i in range(n_steps):
        ids, answers = _batch(seed=10 + i)
        jparams, opt_state, jloss = step(jparams, opt_state, jax.random.PRNGKey(i), {
            "input_ids": jnp.asarray(ids), "answers": jnp.asarray(answers),
            "user_ids": jnp.zeros(len(ids), jnp.int32)})
        loss = model.calculate_loss(torch.from_numpy(ids).long(), torch.from_numpy(answers).long())
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want = params_from_jax(jax.device_get(jparams))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name, value in want.items():
        if name.endswith("attention_layer.key.bias"):  # zero at init, zero true gradient
            bound = n_steps * OPT["lr"]
            assert got[name].abs().max() <= bound and value.abs().max() <= bound, name
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)
    assert not np.allclose(want["item_embeddings.weight"].numpy()[0], table[0])  # row 0 moved


@pytest.mark.parametrize("loss_impl", ["dense", "streaming"])
def test_padding_row_gets_only_the_ce_gradient(loss_impl):
    """Lookups of item 0 send no gradient to row 0; the tied CE does."""
    model = build_model(ModelConfig(**FIELDS, loss_impl=loss_impl),
                        generator=torch.Generator().manual_seed(2))
    ids, answers = _batch(seed=3)
    ids_t, answers_t = torch.from_numpy(ids).long(), torch.from_numpy(answers).long()
    assert (ids == 0).any()
    model.calculate_loss(ids_t, answers_t).backward()
    states = model(ids_t)[:, -1, :].detach()
    table = model.item_table.detach().clone().requires_grad_()
    full_softmax_ce(states, table, answers_t, impl=loss_impl).backward()
    row0 = model.item_table.grad[0]
    assert row0.abs().max() > 0
    torch.testing.assert_close(row0, table.grad[0], rtol=1e-5, atol=1e-9)
    model.zero_grad()
    model(ids_t).sum().backward()  # lookups only
    assert not model.item_table.grad[0].any()


def test_epoch_permutation_wraps_into_full_batches():
    gen = torch.Generator().manual_seed(0)
    perm = epoch_permutation(10, 4, gen, torch.device("cpu"))
    assert perm.shape == (3, 4)
    flat = perm.reshape(-1)
    assert sorted(flat[:10].tolist()) == list(range(10))
    assert torch.equal(flat[10:], flat[:2])  # the last batch wraps to the start
    assert epoch_permutation(3, 8, gen, torch.device("cpu")).shape == (1, 8)


def test_sample_negatives_excludes_sample_items():
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(1, 40, (200, 6), generator=gen)
    ids[:, :2] = 0
    answers = torch.randint(1, 40, (200,), generator=gen)
    neg = sample_negatives(gen, ids, answers, item_size=40)
    assert ((neg >= 1) & (neg < 40)).all()
    assert not (neg == answers).any()
    assert not (ids == neg[:, None]).any()


def test_early_stopping():
    saved = []
    stopper = EarlyStopping(save_fn=saved.append, patience=2)
    for epoch, score in enumerate([0.1, 0.3, 0.3, 0.2]):
        stopper(np.array([score]), epoch)
    assert saved == [0, 1] and stopper.counter == 2 and stopper.early_stop
    stopper = EarlyStopping(save_fn=saved.append, patience=2)
    for epoch, score in enumerate([0.1, 0.1, 0.2]):
        stopper(np.array([score]), 10 + epoch)
    assert saved[-1] == 12 and stopper.counter == 0 and not stopper.early_stop


def _toy_seqs(n_users=40, n_items=50, seed=0):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_users):
        start, length = rng.integers(1, n_items - 1), rng.integers(4, 12)
        seqs.append([int((start + 2 * i) % (n_items - 1) + 1) for i in range(length)])
    return seqs


def _logger():
    logger = logging.getLogger("test_torch_port_train")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


def _trainer(tmp_path, **model_overrides):
    seqs = _toy_seqs()
    data = SeqRecData(Corpus(user_seq=seqs, max_item=max(map(max, seqs))), 10)
    fields = dict(FIELDS, hidden_dropout_prob=0.5, attention_probs_dropout_prob=0.5,
                  item_size=data.item_size, num_users=len(seqs) + 1) | model_overrides
    return Trainer(ModelConfig(**fields), TrainConfig(batch_size=16, device="cpu", seed=3),
                   data, _logger(), str(tmp_path / "m.ckpt"))


def test_save_state_resume_round_trip(tmp_path):
    """A resumed trainer continues exactly as the one that saved (dropout,
    epoch order and Adam included); a changed architecture is refused."""
    first = _trainer(tmp_path)
    first.train(0)
    stopper = EarlyStopping(save_fn=lambda _: None, patience=5)
    stopper(np.array([0.25]), None)
    stopper(np.array([0.2]), None)
    first.save_state(0, stopper)
    assert not (tmp_path / "m.ckpt.state.tmp").exists()
    want = first.train(1)  # dropout draws from torch's process-wide generator: run in turn

    second = _trainer(tmp_path)
    second.train(0)  # diverge from the snapshot first
    assert second.resume() == 1
    assert second._resume_stopper[1] == 1
    np.testing.assert_array_equal(second._resume_stopper[0], np.array([0.25], np.float32))
    assert second.train(1) == want
    for (name, a), b in zip(first.model.state_dict().items(), second.model.state_dict().values()):
        assert torch.equal(a, b), name

    changed = _trainer(tmp_path, num_attention_heads=1)
    with pytest.raises(ValueError, match="num_attention_heads"):
        changed.resume()


def test_main_trains_on_cpu_and_resumes(tmp_path):
    """`main` without --do_eval: 2 epochs, then --resume --epochs 3 starts
    at epoch 2 and ends where an uninterrupted 3-epoch run ends."""
    from bsarec_tpu_torch.main import main as port_main
    from bsarec_tpu_torch.train.checkpoint import load_train_state

    (tmp_path / "Toy.txt").write_text(
        "".join(f"{u + 1} {' '.join(map(str, s))}\n" for u, s in enumerate(_toy_seqs())))
    common = ["--device", "cpu", "--data_dir", str(tmp_path), "--data_name", "Toy",
              "--output_dir", str(tmp_path), "--max_seq_length", "10", "--hidden_size", "16",
              "--num_attention_heads", "1", "--batch_size", "16", "--lr", "0.005"]
    scores = port_main(common + ["--train_name", "run", "--epochs", "2"])
    assert len(scores) == 6 and all(0.0 <= s <= 1.0 for s in scores)
    assert (tmp_path / "run.ckpt").exists()
    assert load_train_state(tmp_path / "run.ckpt.state")["epoch"] == 1
    resumed = port_main(common + ["--train_name", "run", "--epochs", "3", "--resume",
                                  "--export_topk", str(tmp_path / "topk.npy")])
    log = (tmp_path / "run.log").read_text()
    assert "resumed full train state" in log and "'epoch': 2," in log
    assert log.count("'epoch': 0,") == 1  # epoch 0 ran once, before the resume
    assert np.load(tmp_path / "topk.npy").shape == (40, 20)

    straight = port_main(common + ["--train_name", "straight", "--epochs", "3"])
    assert resumed == straight
    a = load_train_state(tmp_path / "run.ckpt.state")
    b = load_train_state(tmp_path / "straight.ckpt.state")
    assert a["epoch"] == b["epoch"] == 2
    assert all(torch.equal(v, b["params"][k]) for k, v in a["params"].items())
    assert json.loads(a["config_fp"])["hidden_size"] == 16

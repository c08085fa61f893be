"""Port SASRec vs the JAX SASRec on the same numpy-seeded weights, carried
by `params_from_jax`, with dropout off and the same negatives: forward,
loss, gradients, parameters after 1 and 3 Adam steps against optax, and
the dense and streaming eval top-20 against the JAX eval. Then `main
--model_type SASRec` on the CPU with the fused dropout path, trained,
resumed and compared with an uninterrupted run.

Tolerances as in `tests/test_torch_port_train.py`: the loss within rtol
1e-5 (fp32 sums in another order), gradients within rtol 1e-4 of the
largest entry of each tensor, parameters within atol 1e-6 after Adam at
lr 5e-4, the attention key biases (zero true gradient) within steps · lr
of 0, and the forward within atol 1e-5."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bsarec_tpu.config import ModelConfig as JaxModelConfig
from bsarec_tpu.config import TrainConfig as JaxTrainConfig
from bsarec_tpu.data.corpus import Corpus as JaxCorpus
from bsarec_tpu.data.pipeline import SeqRecData as JaxSeqRecData
from bsarec_tpu.models import build_model as jax_build_model
from bsarec_tpu.train.loop import make_optimizer as jax_make_optimizer
from bsarec_tpu.train.trainer import Trainer as JaxTrainer
from bsarec_tpu_torch.config import ModelConfig, TrainConfig
from bsarec_tpu_torch.data.corpus import Corpus
from bsarec_tpu_torch.data.pipeline import SeqRecData
from bsarec_tpu_torch.models import build_model
from bsarec_tpu_torch.train.jax_import import params_from_jax
from bsarec_tpu_torch.train.loop import make_optimizer
from bsarec_tpu_torch.train.trainer import Trainer

FWD_ATOL, LOSS_RTOL, GRAD_RTOL, PARAM_ATOL = 1e-5, 1e-5, 1e-4, 1e-6
FIELDS = dict(model_type="sasrec", item_size=60, num_users=30, max_seq_length=10,
              hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
OPT = dict(lr=5e-4, weight_decay=0.01)


def _jax_params(seed=0):
    """JAX-initialized params with numpy noise on every leaf (nonzero
    biases, LayerNorm terms and padding row)."""
    model = jax_build_model(JaxModelConfig(**FIELDS))
    key = jax.random.PRNGKey(seed)
    dummy = jnp.zeros((2, FIELDS["max_seq_length"]), jnp.int32)
    params = jax.device_get(model.init({"params": key, "dropout": key}, dummy, train=False)["params"])
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(lambda x: np.asarray(x) + 0.02 * rng.normal(size=x.shape).astype(np.float32),
                          params)
    return model, params


def _batch(seed, b=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, FIELDS["item_size"], size=(b, FIELDS["max_seq_length"])).astype(np.int32)
    for r in range(b):
        ids[r, : rng.integers(0, FIELDS["max_seq_length"])] = 0  # left padding
    answers = rng.integers(1, FIELDS["item_size"], size=b).astype(np.int32)
    answers[-1] = 0  # a row the loss masks out
    negs = rng.integers(1, FIELDS["item_size"], size=b).astype(np.int32)
    return ids, answers, negs


def _jax_loss_fn(model):
    def loss_fn(params, ids, answers, negs):
        b = ids.shape[0]
        return model.apply({"params": params}, ids, answers, negs, jnp.zeros((b, 0), jnp.int32),
                           jnp.zeros(b, jnp.int32), train=True, method="calculate_loss",
                           rngs={"dropout": jax.random.PRNGKey(0)})
    return loss_fn


def _port_model(params):
    model = build_model(ModelConfig(**FIELDS))
    model.load_state_dict(params_from_jax(params))  # strict: every key carried
    return model


def test_forward_matches_jax():
    jmodel, params = _jax_params()
    model = _port_model(params)
    ids, _, _ = _batch(0)
    want = jmodel.apply({"params": params}, jnp.asarray(ids), train=False, all_layers=True)
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(ids), all_layers=True)
    assert len(got) == len(want) == FIELDS["num_hidden_layers"] + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FWD_ATOL, rtol=0)
    assert "item_encoder.blocks.1.layer.query.weight" in model.state_dict()
    assert "item_encoder.blocks.0.feed_forward.dense_2.bias" in model.state_dict()


def test_loss_and_gradients_match_jax():
    jmodel, params = _jax_params(2)
    model = _port_model(params)
    ids, answers, negs = _batch(1)
    jloss, jgrads = jax.value_and_grad(_jax_loss_fn(jmodel))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(ids), jnp.asarray(answers), jnp.asarray(negs))
    model.train()
    loss = model.calculate_loss(torch.from_numpy(ids), torch.from_numpy(answers).long(),
                                torch.from_numpy(negs).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want = params_from_jax(jax.device_get(jgrads))
    for name, p in model.named_parameters():
        scale = max(float(want[name].abs().max()), 1e-6)
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=GRAD_RTOL * scale, rtol=0,
                                   err_msg=name)
    # lookups never move the padding row; neither side's loss reads it otherwise
    assert not model.item_table.grad[0].any()
    with pytest.raises(ValueError, match="negative"):
        model.calculate_loss(torch.from_numpy(ids), torch.from_numpy(answers).long())


@pytest.mark.parametrize("n_steps", [1, 3])
def test_adam_steps_match_optax(n_steps):
    jmodel, params = _jax_params(4)
    model = _port_model(params)
    model.train()
    optimizer = make_optimizer(model.parameters(), TrainConfig(**OPT))
    tx = jax_make_optimizer(JaxTrainConfig(**OPT))
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    grad_fn = jax.jit(jax.value_and_grad(_jax_loss_fn(jmodel)))
    for i in range(n_steps):
        ids, answers, negs = _batch(10 + i)
        jloss, grads = grad_fn(jparams, jnp.asarray(ids), jnp.asarray(answers), jnp.asarray(negs))
        updates, opt_state = tx.update(grads, opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        loss = model.calculate_loss(torch.from_numpy(ids), torch.from_numpy(answers).long(),
                                    torch.from_numpy(negs).long())
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want = params_from_jax(jax.device_get(jparams))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name, value in want.items():
        if name.endswith("layer.key.bias"):  # zero true gradient: Adam steps on rounding noise
            start = params_from_jax(params)[name]
            bound = n_steps * OPT["lr"]
            assert (got[name] - start).abs().max() <= bound, name
            assert (value - start).abs().max() <= bound, name
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)


def _seqs(n_users=70, n_items=60, seed=0):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_users):
        start, length = rng.integers(1, n_items - 1), rng.integers(3, 14)
        seqs.append([int((start + 3 * i) % (n_items - 1) + 1) for i in range(length)])
    return seqs


def _logger():
    logger = logging.getLogger("test_torch_port_sasrec")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


@pytest.mark.parametrize("eval_impl", ["dense", "streaming"])
def test_eval_top20_matches_jax(tmp_path, eval_impl):
    """Both trainers on one corpus and the JAX trainer's weights: metric
    sums and the exported top-20 ids (the JAX streaming path runs its
    Pallas kernel in interpret mode, the port its plain version)."""
    seqs = _seqs()
    max_item = max(map(max, seqs))
    fields = dict(FIELDS, max_seq_length=10, hidden_size=16, item_size=max_item + 1,
                  num_users=len(seqs) + 1)
    jtrainer = JaxTrainer(JaxModelConfig(**fields),
                          JaxTrainConfig(eval_batch_size=32, eval_impl=eval_impl, seed=5),
                          JaxSeqRecData(JaxCorpus(user_seq=[list(s) for s in seqs], max_item=max_item), 10),
                          _logger(), str(tmp_path / "j.ckpt"))
    trainer = Trainer(ModelConfig(**fields),
                      TrainConfig(eval_batch_size=32, eval_impl=eval_impl, device="cpu"),
                      SeqRecData(Corpus(user_seq=[list(s) for s in seqs], max_item=max_item), 10),
                      _logger(), str(tmp_path / "p.ckpt"))
    trainer.install_params(params_from_jax(jax.device_get(jtrainer.params)))
    assert trainer.eval_impl == eval_impl
    np.testing.assert_allclose(trainer.test(0)[0], jtrainer.test(0)[0], atol=1e-6, rtol=0)
    got = trainer.export_topk("test")
    assert got.shape == (70, 20)
    np.testing.assert_array_equal(got, np.asarray(jtrainer.export_topk("test")))


def test_main_trains_fused_dropout_on_cpu_and_resumes(tmp_path, monkeypatch):
    """`main --model_type SASRec --prng rbg` with BSAREC_DROPOUT=pallas: the
    fused path's plain version on the CPU, negatives drawn each step; a
    run resumed after epoch 1 ends where an uninterrupted run ends."""
    from bsarec_tpu_torch.main import main as port_main
    from bsarec_tpu_torch.train.checkpoint import load_train_state

    monkeypatch.setenv("BSAREC_DROPOUT", "pallas")
    (tmp_path / "Toy.txt").write_text(
        "".join(f"{u + 1} {' '.join(map(str, s))}\n" for u, s in enumerate(_seqs(40, 50))))
    common = ["--device", "cpu", "--data_dir", str(tmp_path), "--data_name", "Toy",
              "--output_dir", str(tmp_path), "--model_type", "SASRec", "--max_seq_length", "10",
              "--hidden_size", "16", "--batch_size", "16", "--lr", "0.005"]

    def run(name, *extra, prng="rbg"):
        return port_main(common + ["--prng", prng, "--train_name", name, *extra])

    scores = run("run", "--epochs", "2")
    assert len(scores) == 6 and all(0.0 <= s <= 1.0 for s in scores)
    resumed = run("run", "--epochs", "3", "--resume")
    log = (tmp_path / "run.log").read_text()
    assert "dropout: fused kernel" in log and "pair BCE" in log
    assert "resumed full train state" in log and log.count("'epoch': 0,") == 1
    straight = run("straight", "--epochs", "3")
    assert resumed == straight
    a = load_train_state(tmp_path / "run.ckpt.state")
    b = load_train_state(tmp_path / "straight.ckpt.state")
    assert a["epoch"] == b["epoch"] == 2
    assert all(torch.equal(v, b["params"][k]) for k, v in a["params"].items())
    run("plain", "--epochs", "1", prng="threefry")  # the default keeps nn.Dropout
    assert "dropout: torch nn.Dropout" in (tmp_path / "plain.log").read_text()

"""The port's tools against the JAX package, on the CPU: `--remat`
(whole-loss recomputation, `train/loop.py:remat_loss`), `--profile`
(`utils/profiling.py:trace`), `--dump_seqout` (`Trainer.dump_sequence_outputs`
and `utils/visualize.py`) and `data/preprocess.py`, each through the
port's `main` or its own CLI as well."""

from __future__ import annotations

import json
import logging
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from bsarec_tpu.config import ModelConfig as JaxModelConfig
from bsarec_tpu.config import TrainConfig as JaxTrainConfig
from bsarec_tpu.data import preprocess as jax_preprocess
from bsarec_tpu.data.corpus import Corpus as JaxCorpus
from bsarec_tpu.data.pipeline import SeqRecData as JaxSeqRecData
from bsarec_tpu.models import build_model as jax_build_model
from bsarec_tpu.train.loop import build_train_epoch as jax_build_train_epoch
from bsarec_tpu.train.loop import make_optimizer as jax_make_optimizer
from bsarec_tpu.train.trainer import Trainer as JaxTrainer
from bsarec_tpu.utils import visualize as jax_visualize
from bsarec_tpu_torch.config import ModelConfig, TrainConfig
from bsarec_tpu_torch.data import preprocess
from bsarec_tpu_torch.data.corpus import Corpus
from bsarec_tpu_torch.data.pipeline import SeqRecData
from bsarec_tpu_torch.models import build_model
from bsarec_tpu_torch.train.jax_import import params_from_jax
from bsarec_tpu_torch.train.loop import dropout_seeds, make_optimizer, remat_loss
from bsarec_tpu_torch.train.trainer import Trainer
from bsarec_tpu_torch.utils import visualize
from bsarec_tpu_torch.utils.profiling import annotate, trace

ROOT = Path(__file__).resolve().parents[1]
PARAM_ATOL, LOSS_RTOL = 1e-6, 1e-5  # the step tests' fp32 tolerances (test_torch_port_train)
DUMP_ATOL = 1e-5
SMALL = dict(max_seq_length=10, hidden_size=16, num_hidden_layers=2, num_attention_heads=2)
# remat cases: (model_type, --prng); rbg runs every dropout site on the
# fused dropout's plain version (BSAREC_DROPOUT=pallas)
REMAT_CASES = [("bsarec", "threefry"), ("bert4rec", "threefry"), ("duorec", "threefry"),
               ("sasrec", "rbg")]


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def quiet_logger():
    logger = logging.getLogger("test_torch_port_tools")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


def toy_seqs(n_users=40, n_items=50, seed=0):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_users):
        start, length = rng.integers(1, n_items - 1), rng.integers(3, 12)
        seqs.append([int((start + 2 * i) % (n_items - 1) + 1) for i in range(length)])
    return seqs


# ---- --remat ------------------------------------------------------------------

def _remat_trainer(tmp_path, model_type, prng, remat):
    seqs = toy_seqs()
    data = SeqRecData(Corpus(user_seq=seqs, max_item=max(map(max, seqs))), SMALL["max_seq_length"])
    cfg = ModelConfig(model_type=model_type, item_size=data.item_size, num_users=len(seqs) + 1,
                      hidden_dropout_prob=0.5, attention_probs_dropout_prob=0.5, **SMALL)
    trainer = Trainer(cfg, TrainConfig(batch_size=16, device="cpu", seed=3, remat=remat,
                                       prng=prng), data, quiet_logger(), str(tmp_path / "m.ckpt"))
    calls = []
    loss_of = trainer.model.calculate_loss
    trainer.model.calculate_loss = lambda *a, **k: calls.append(1) or loss_of(*a, **k)
    return trainer, calls


@pytest.mark.parametrize("model_type,prng", REMAT_CASES)
def test_remat_epochs_bit_equal_to_eager(model_type, prng, tmp_path, monkeypatch):
    """Two epochs with dropout on from one seed: the same losses, parameters,
    Adam state and generator states with and without --remat, the remat
    run computing each step's loss twice (its forward and its recompute).
    BERT4Rec draws its cloze positions inside the loss, DuoRec reads the
    same-target view, SASRec under rbg takes the fused dropout."""
    if prng == "rbg":
        monkeypatch.setenv("BSAREC_DROPOUT", "pallas")
    runs = {}
    for remat in (False, True):  # one after the other: nn.Dropout reads torch's global stream
        trainer, calls = _remat_trainer(tmp_path, model_type, prng, remat)
        assert trainer.model.dropout_state.fused == (prng == "rbg")
        losses = [trainer.train(epoch) for epoch in range(2)]
        runs[remat] = (losses, len(calls), trainer, torch.get_rng_state())
    eager_losses, eager_calls, eager, eager_rng = runs[False]
    losses, calls, remat, rng = runs[True]
    assert losses == eager_losses
    assert calls == 2 * eager_calls == 4 * eager.steps_per_epoch
    for name, value in eager.model.state_dict().items():
        assert torch.equal(remat.model.state_dict()[name], value), name
    for a, b in zip(eager.optimizer.state.values(), remat.optimizer.state.values()):
        assert torch.equal(a["exp_avg"], b["exp_avg"]) and torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])
    assert torch.equal(eager.generator.get_state(), remat.generator.get_state())
    assert torch.equal(eager_rng, rng)
    assert eager.np_rng.bit_generator.state == remat.np_rng.bit_generator.state


@pytest.mark.parametrize("model_type,prng", [("bert4rec", "threefry"), ("sasrec", "rbg")])
def test_a_bare_checkpoint_would_part_ways(model_type, prng, tmp_path, monkeypatch):
    """The control of the test above: `checkpoint` without `remat_loss`'s
    restores gives BERT4Rec's recompute new cloze positions (so other
    gradients) and the fused dropout's recompute new call indices."""
    if prng == "rbg":
        monkeypatch.setenv("BSAREC_DROPOUT", "pallas")
    trainer, _ = _remat_trainer(tmp_path, model_type, prng, remat=False)
    model, gen = trainer.model, trainer.generator
    model.train()
    data = trainer.data.train
    ids = torch.from_numpy(data.input_ids[:16]).long()
    ans = torch.from_numpy(data.answers[:16]).long()
    neg = torch.randint(1, data.answers.max() + 1, (16,), generator=torch.Generator().manual_seed(0))

    def grads(loss_call):
        if model.dropout_state.fused:
            model.dropout_state.begin_step(dropout_seeds(torch.Generator().manual_seed(1), 1,
                                                         ids.device)[0])
        gen.manual_seed(5)
        torch.manual_seed(6)
        model.zero_grad(set_to_none=True)
        loss_call().backward()
        return torch.cat([p.grad.reshape(-1) for p in model.parameters() if p.grad is not None])

    eager = grads(lambda: model.calculate_loss(ids, ans, neg, generator=gen))
    kept = grads(lambda: remat_loss(model, ids, ans, neg, None, None, gen))
    assert torch.equal(kept, eager)
    bare = grads(lambda: checkpoint(lambda i, a, n: model.calculate_loss(i, a, n, generator=gen),
                                    ids, ans, neg, use_reentrant=False))
    assert not torch.equal(bare, eager)


@pytest.mark.parametrize("model_type,prng,want_eager,want_remat", [
    ("bsarec", "threefry", {"logz": 1, "grads": 1, "dropout": 0},
     {"logz": 2, "grads": 1, "dropout": 0}),
    ("sasrec", "rbg", {"logz": 0, "grads": 0, "dropout": 14},
     {"logz": 0, "grads": 0, "dropout": 21}),
])
def test_remat_step_calls_of_the_kernels_plain_versions(model_type, prng, want_eager, want_remat,
                                                        monkeypatch):
    """What a remat step runs, counted on the kernels' plain versions (on
    the card, their launches): the CE forward twice (the forward and the
    recompute) and its backward once; SASRec's 7 fused dropout sites
    three times (forward, recompute, backward) where eager runs two."""
    from bsarec_tpu_torch.ops import ce
    from bsarec_tpu_torch.ops import dropout as fd

    monkeypatch.setenv("BSAREC_DROPOUT", "pallas")
    calls = dict.fromkeys(("logz", "grads", "dropout"), 0)
    for module, name, key in ((ce, "ce_loss_logz_plain", "logz"), (ce, "ce_grads_plain", "grads"),
                              (fd, "fused_dropout_plain", "dropout")):
        monkeypatch.setattr(module, name, lambda *a, _f=getattr(module, name), _k=key, **k:
                            calls.__setitem__(_k, calls[_k] + 1) or _f(*a, **k))
    model = build_model(ModelConfig(model_type=model_type, item_size=50, num_users=5,
                                    loss_impl="streaming", **SMALL), prng=prng)
    model.train()
    gen = torch.Generator().manual_seed(0)
    ids, ans, neg = (torch.randint(1, 50, shape, generator=gen) for shape in ((8, 10), (8,), (8,)))
    for remat, want in ((False, want_eager), (True, want_remat)):
        calls.update(dict.fromkeys(calls, 0))
        if model.dropout_state.fused:
            model.dropout_state.begin_step(dropout_seeds(gen, 1, ids.device)[0])
        loss = (remat_loss(model, ids, ans, neg, None, None, None) if remat
                else model.calculate_loss(ids, ans, neg))
        loss.backward()
        assert calls == want, (remat, calls)


FIELDS = dict(model_type="bsarec", item_size=60, num_users=30, max_seq_length=10,
              hidden_size=32, num_hidden_layers=2, num_attention_heads=2, c=3, alpha=0.7,
              hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
OPT = dict(lr=5e-4, weight_decay=0.01)


@pytest.mark.parametrize("loss_impl", ["dense", "streaming"])
def test_remat_step_matches_jax_remat_epoch(loss_impl):
    """One Adam step with dropout off: JAX's `build_train_epoch(...,
    remat=True)` over one full batch (its streaming CE in interpret mode)
    against the port's `remat_loss` + Adam on the same weights and batch.
    The epoch's permutation only reorders the batch's rows, which the
    mean loss does not see beyond fp32 rounding."""
    b, seq_len, item_size = 12, FIELDS["max_seq_length"], FIELDS["item_size"]
    jmodel = jax_build_model(JaxModelConfig(**FIELDS, loss_impl=loss_impl))
    key = jax.random.PRNGKey(0)
    params = jax.device_get(jmodel.init({"params": key, "dropout": key},
                                        jnp.zeros((2, seq_len), jnp.int32), train=False)["params"])
    rng = np.random.default_rng(1)
    ids = rng.integers(1, item_size, size=(b, seq_len)).astype(np.int32)
    for r in range(b):
        ids[r, : rng.integers(0, seq_len)] = 0
    answers = rng.integers(1, item_size, size=b).astype(np.int32)

    model = build_model(ModelConfig(**FIELDS, loss_impl=loss_impl))
    model.load_state_dict(params_from_jax(params))
    model.train()
    optimizer = make_optimizer(model.parameters(), TrainConfig(**OPT))
    loss = remat_loss(model, torch.from_numpy(ids).long(), torch.from_numpy(answers).long(),
                      None, None, None, None)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()

    tx = jax_make_optimizer(JaxTrainConfig(**OPT))
    epoch, steps = jax_build_train_epoch(jmodel, tx, item_size, b, b, with_sem=False, remat=True)
    assert steps == 1
    jparams, _, jloss = epoch(jax.tree.map(jnp.asarray, params), tx.init(params),
                              jax.random.PRNGKey(3), jnp.asarray(ids), jnp.asarray(answers),
                              jnp.zeros(b, jnp.int32), jnp.zeros((b, seq_len), jnp.int32))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want = params_from_jax(jax.device_get(jparams))
    got = model.state_dict()
    assert got.keys() == want.keys()
    for name, value in want.items():
        if name.endswith("attention_layer.key.bias"):  # zero at init, zero true gradient
            assert got[name].abs().max() <= OPT["lr"] and value.abs().max() <= OPT["lr"], name
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)


# ---- --profile ----------------------------------------------------------------

def test_trace_writes_a_chrome_trace_with_the_annotations(tmp_path):
    with trace(None):  # no directory: no profiler, no file
        pass
    with trace(str(tmp_path / "prof"), "cpu"):
        with annotate("train_step"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {event.get("name") for event in json.loads(files[0].read_text())["traceEvents"]}
    assert "train_step" in names


# ---- --dump_seqout and visualize ------------------------------------------------

@pytest.mark.parametrize("model_type", ["bsarec", "sasrec"])
def test_dump_sequence_outputs_match_jax(model_type, tmp_path):
    """Both trainers on one corpus with the JAX trainer's weights carried
    over: the same files (names, count, shapes) within DUMP_ATOL, three
    batches of 32 over 70 users, the last one short."""
    seqs = toy_seqs(n_users=70, n_items=60, seed=1)
    max_item = max(map(max, seqs))
    fields = dict(SMALL, model_type=model_type, item_size=max_item + 1, num_users=len(seqs) + 1)
    jtrainer = JaxTrainer(JaxModelConfig(**fields), JaxTrainConfig(seed=5),
                          JaxSeqRecData(JaxCorpus(user_seq=[list(s) for s in seqs],
                                                  max_item=max_item), SMALL["max_seq_length"]),
                          quiet_logger(), str(tmp_path / "j.ckpt"))
    trainer = Trainer(ModelConfig(**fields), TrainConfig(device="cpu"),
                      SeqRecData(Corpus(user_seq=[list(s) for s in seqs], max_item=max_item),
                                 SMALL["max_seq_length"]),
                      quiet_logger(), str(tmp_path / "p.ckpt"))
    trainer.install_params(params_from_jax(jax.device_get(jtrainer.params),
                                           base=trainer.model.state_dict()))
    tag = f"Toy_{model_type}"
    assert jtrainer.dump_sequence_outputs(str(tmp_path / "jax"), tag, batch_size=32) == 3
    assert trainer.dump_sequence_outputs(str(tmp_path / "port"), tag, batch_size=32) == 3
    want = sorted(p.name for p in (tmp_path / "jax" / tag).iterdir())
    assert sorted(p.name for p in (tmp_path / "port" / tag).iterdir()) == want
    assert len(want) == 3 * (SMALL["num_hidden_layers"] + 1)
    for name in want:
        got, ref = (np.load(tmp_path / side / tag / name) for side in ("port", "jax"))
        assert got.shape == ref.shape and got.dtype == ref.dtype == np.float32, name
        np.testing.assert_allclose(got, ref, atol=DUMP_ATOL, rtol=0, err_msg=name)
    layers = visualize.load_sequence_outputs(tmp_path / "port" / tag, SMALL["num_hidden_layers"])
    assert [x.shape for x in layers] == [(70, SMALL["hidden_size"])] * 3


VISUALIZE_CASES = {
    "attention_spectral_response": lambda rng: (rng.random((12, 12)),),
    "filter_spectral_response": lambda rng: (rng.normal(size=(1, 7, 8)), rng.normal(size=(1, 7, 8))),
    "fig2_filter_response": lambda rng: (rng.normal(size=(1, 7, 8, 2)),),
    "layerwise_cosine_similarity": lambda rng: ([rng.normal(size=(3, 10, 8)) for _ in range(3)],),
    "layerwise_singular_values": lambda rng: ([rng.normal(size=(3, 10, 8)) for _ in range(3)],),
    "fig3_sequence_cosine": lambda rng: (rng.normal(size=(9, 6)),),
    "fig3_normalized_svdvals": lambda rng: (rng.normal(size=(9, 6)),),
    "fig2_attention_response": lambda rng: (rng.random((12, 12)),),
    "fig2_fftshift": lambda rng: (rng.random(26), 50),
}


def test_visualize_has_jax_public_functions():
    public = {n for n, v in vars(jax_visualize).items() if callable(v) and not n.startswith("_")
              and getattr(v, "__module__", "") == jax_visualize.__name__}
    assert public == set(VISUALIZE_CASES) | {"load_sequence_outputs", "dump_sequence_outputs"}
    assert all(getattr(visualize, name).__module__ == visualize.__name__ for name in public)


@pytest.mark.parametrize("name", sorted(VISUALIZE_CASES))
def test_visualize_matches_jax(name):
    args = VISUALIZE_CASES[name](np.random.default_rng(len(name)))
    got, want = getattr(visualize, name)(*args), getattr(jax_visualize, name)(*args)
    assert type(got) is type(want)
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_array_equal(got, want)


def test_dump_and_load_sequence_outputs_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    batches = [[rng.normal(size=(b, 5, 3)).astype(np.float32) for _ in range(3)] for b in (4, 2)]
    for i, outs in enumerate(batches):
        visualize.dump_sequence_outputs(outs, tmp_path / "port", "t", i)
        jax_visualize.dump_sequence_outputs(outs, tmp_path / "jax", "t", i)
    (tmp_path / "port" / "t" / "README").write_text("stray")
    for side in ("port", "jax"):
        assert sorted(p.name for p in (tmp_path / side / "t").glob("*.npy")) == sorted(
            f"{layer}layer_{i}iter.npy" for layer in range(3) for i in range(2))
    for got, want in zip(visualize.load_sequence_outputs(tmp_path / "port" / "t", 2),
                         jax_visualize.load_sequence_outputs(tmp_path / "jax" / "t", 2)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        visualize.load_sequence_outputs(tmp_path / "port" / "t", 3)


# ---- data/preprocess.py ---------------------------------------------------------

def write_raw(kind: str, path: Path, seed: int = 0) -> None:
    """A raw source file of `kind` from a seed: 40 users over 30 items,
    with low ratings (dropped), repeats (LastFM dedups them) and, for
    Yelp, dates outside its window."""
    rng = np.random.default_rng(seed)
    lines = ["user\tartist\ttag\ttimestamp"] if kind == "LastFM" else []
    for _ in range(900):
        u, i = f"u{rng.integers(0, 40)}", f"i{rng.integers(0, 30)}"
        ts = int(1.3e9 + rng.integers(0, 10**7))
        if kind == "Beauty":
            lines.append(json.dumps({"reviewerID": u, "asin": i, "overall": float(rng.integers(0, 6)),
                                     "unixReviewTime": ts}))
        elif kind == "ML-1M":
            lines.append(f"{u[1:]}::{i[1:]}::{rng.integers(1, 6)}::{ts}")
        elif kind == "Yelp":
            month, day = rng.integers(1, 13), rng.integers(1, 29)
            year = 2019 if rng.random() < 0.9 else 2018
            lines.append(json.dumps({"user_id": u, "business_id": i,
                                     "stars": float(rng.integers(0, 6)),
                                     "date": f"{year}-{month:02d}-{day:02d} "
                                             f"{rng.integers(0, 24):02d}:00:00"}))
        else:
            lines.append(f"{u[1:]}\t{i[1:]}\t{rng.integers(0, 99)}\t{ts}")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("kind", ["Beauty", "ML-1M", "Yelp", "LastFM"])
def test_process_dataset_writes_jax_bytes(kind, tmp_path):
    raw = tmp_path / "raw"
    write_raw(kind, raw)
    stats = preprocess.process_dataset(kind, str(raw), str(tmp_path / "port.txt"), 3, 3)
    want = jax_preprocess.process_dataset(kind, str(raw), str(tmp_path / "jax.txt"), 3, 3)
    assert stats == want and stats["users"] > 5 and stats["items"] > 5
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert preprocess.PARSERS[kind](str(raw)) == jax_preprocess.PARSERS[kind](str(raw))


def test_preprocess_cli_writes_jax_bytes(tmp_path):
    """`python -m bsarec_tpu_torch.data.preprocess --dataset all` against
    the JAX package's CLI on one raw directory: the same files, byte for
    byte, and the missing raw files reported, not fatal."""
    raw = tmp_path / "raw"
    raw.mkdir()
    present = {"Beauty": "reviews_Beauty_5.json", "ML-1M": "ratings.dat",
               "Yelp": "yelp_academic_dataset_review.json",
               "LastFM": "user_taggedartists-timestamps.dat"}
    for kind, name in present.items():
        write_raw(kind, raw / name, seed=len(kind))
    argv = ["--dataset", "all", "--raw_dir", str(raw), "--user_core", "3", "--item_core", "3"]
    out = subprocess.run([sys.executable, "-m", "bsarec_tpu_torch.data.preprocess", *argv,
                          "--out_dir", str(tmp_path / "port")], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=120).stdout
    want = jax_preprocess.main([*argv, "--out_dir", str(tmp_path / "jax")])
    assert set(want) == set(present)
    assert "Toys_and_Games: missing raw file" in out
    for kind, stats in want.items():
        assert f"{kind}: {stats}" in out
        assert ((tmp_path / "port" / f"{kind}.txt").read_bytes()
                == (tmp_path / "jax" / f"{kind}.txt").read_bytes())
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == sorted(
        p.name for p in (tmp_path / "jax").iterdir())


# ---- the flags through main -------------------------------------------------------

def test_main_runs_remat_profile_and_dump_seqout(tmp_path):
    """`main --device cpu --remat --profile <dir> --dump_seqout <dir>` trains
    to the eager run's scores and parameters, bit for bit; its trace holds
    the training loop's annotations; its dumps (the best model's, after the
    test) equal those of `--do_eval --load_model` of the eager run."""
    from bsarec_tpu_torch.main import main as port_main
    from bsarec_tpu_torch.train.checkpoint import load_train_state

    (tmp_path / "Toy.txt").write_text(
        "".join(f"{u + 1} {' '.join(map(str, s))}\n" for u, s in enumerate(toy_seqs())))
    common = ["--device", "cpu", "--data_dir", str(tmp_path), "--data_name", "Toy",
              "--output_dir", str(tmp_path), "--max_seq_length", "10", "--hidden_size", "16",
              "--num_attention_heads", "1", "--batch_size", "16", "--lr", "0.005"]
    eager = port_main(common + ["--train_name", "eager", "--epochs", "2"])
    remat = port_main(common + ["--train_name", "remat", "--epochs", "2", "--remat",
                                "--profile", str(tmp_path / "prof"),
                                "--dump_seqout", str(tmp_path / "dump")])
    assert remat == eager
    a = load_train_state(tmp_path / "eager.ckpt.state")["params"]
    b = load_train_state(tmp_path / "remat.ckpt.state")["params"]
    assert all(torch.equal(v, b[k]) for k, v in a.items())

    files = list((tmp_path / "prof").glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {event.get("name") for event in json.loads(files[0].read_text())["traceEvents"]}
    assert {"train_epoch", "train_step", "eval_epoch"} <= names

    port_main(common + ["--train_name", "eval", "--do_eval", "--load_model", "eager",
                        "--dump_seqout", str(tmp_path / "dump_eval")])
    tag = "Toy_BSARec"
    dumped = sorted(p.name for p in (tmp_path / "dump" / tag).iterdir())
    assert len(dumped) == 1 * (2 + 1)  # one eval batch of 256 over 40 users, 2 layers + embedding
    for name in dumped:
        got = np.load(tmp_path / "dump" / tag / name)
        assert got.shape == (40, 10, 16)
        np.testing.assert_array_equal(got, np.load(tmp_path / "dump_eval" / tag / name))
    assert "dumped 1 per-layer sequence-output batches" in (tmp_path / "remat.log").read_text()

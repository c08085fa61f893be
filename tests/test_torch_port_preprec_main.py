"""`python -m bsarec_tpu_torch.preprec.main` on the CPU: training with an
eval under each method, the checkpoint read by the JAX package, eval
only, the sparse partition, the flag surface and the refused flags.

Tolerance of the checkpoint check: the JAX model's predict on the port's
best.ckpt against the port's predict, fp32, dropout off, within rtol 1e-5
(and 1e-6 of the scores' largest magnitude for scores near zero): the
same arithmetic in another order."""

import logging
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsarec_tpu.preprec import main as jax_main
from bsarec_tpu.preprec.config import PrepRecConfig as JaxPrepRecConfig
from bsarec_tpu.preprec.models import NewRecModel as JaxNewRec
from bsarec_tpu.preprec.torch_import import import_preprec_torch
from bsarec_tpu_torch.preprec import main as port_main
from bsarec_tpu_torch.preprec import preprocess
from bsarec_tpu_torch.preprec.config import PrepRecConfig
from bsarec_tpu_torch.preprec.models import NewRecModel

SMALL = ["--maxlen", "12", "--hidden_units", "16", "--num_blocks", "1", "--input_units1", "33",
         "--batch_size", "16", "--device", "cpu"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test (restored after): at these sizes more
    threads gain nothing, and parallel test workers of eight threads each
    slow one another down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("preprec_port_main")
    prefix = str(root / "synth")
    rng = np.random.default_rng(0)
    n = 6000
    raw = (rng.integers(0, 50, n), rng.integers(0, 60, n),
           1_500_000_000 + rng.integers(0, 3600 * 24 * 366, n))
    stats = preprocess.preprocess(*raw, prefix, t1_cutoff=30.0, t2_cutoff=7.0)
    preprocess.eval_negatives(f"{prefix}_intwtime.csv", f"{prefix}_userneg.pickle", n=20, seed=0)
    preprocess.week_adjustment(f"{prefix}_intwtime.csv", f"{prefix}_userneg.pickle",
                               f"{prefix}_week_curr_raw.txt", f"{prefix}_week_wt_embed_adj.txt")
    np.savetxt(f"{prefix}_lastuserpop.txt", rng.integers(1, 30, stats["n_users"]))
    for name in ("intwtime.csv", "wtembed.txt", "week_embed2.txt"):  # a sparse partition
        shutil.copy(f"{prefix}_{name}", f"{prefix}_sparse_{name}")
    return str(root)


def _run(data_dir, tmp_path, monkeypatch, *argv):
    monkeypatch.chdir(tmp_path)  # checkpoints go to res/<dataset>/<train_dir>
    return port_main.main(["--dataset", "synth", "--data_dir", data_dir, *SMALL, *argv])


def _scores_of(ckpt, cfg_fields, seed=0):
    """The port's and the JAX package's predict on the checkpoint."""
    rng = np.random.default_rng(seed)
    pad = np.zeros((5, 12), bool)
    pad[1, :4] = True
    feats = rng.random((5, 12, 39)).astype(np.float32)
    cand = rng.random((5, 21, 39)).astype(np.float32)
    model = NewRecModel(PrepRecConfig(**cfg_fields)).eval()
    model.load_state_dict(torch.load(ckpt))
    with torch.no_grad():
        got = model.predict(torch.from_numpy(feats), torch.from_numpy(pad), torch.from_numpy(cand))
    params = import_preprec_torch("newrec", ckpt, cfg_fields["num_blocks"])
    want = JaxNewRec(JaxPrepRecConfig(**cfg_fields)).apply(
        {"params": params}, jnp.asarray(feats), jnp.asarray(pad), jnp.asarray(cand), method="predict")
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("method", [1, 3])
def test_main_trains_evals_and_jax_reads_the_checkpoint(data_dir, tmp_path, monkeypatch, caplog, method):
    caplog.set_level(logging.INFO, logger="preprec")
    metrics = _run(data_dir, tmp_path, monkeypatch, "--num_epochs", "2", "--epoch_test", "1",
                   "--eval_method", str(method), "--eval_item_chunk", "16", "--save_ranks")
    assert len(metrics) == 3 and all(0 <= v <= 1 for m in metrics for v in m)
    run = tmp_path / "res" / "synth" / "test"
    assert {"epoch=1.ckpt", "epoch=2.ckpt", "best.ckpt", "ranks.txt"} <= set(os.listdir(run))
    ranks = np.loadtxt(run / "ranks.txt")
    assert ranks.shape == (60,) and ranks.min() >= 0
    assert ranks.max() <= (20 if method == 1 else 50)
    text = caplog.text
    assert text.count("valid eval: 60 users") == 2 and "test eval: 60 users" in text
    assert "epoch 2: loss" in text and "Test NDCG@10" in text
    got, want = _scores_of(str(run / "best.ckpt"), dict(
        maxlen=12, hidden_units=16, num_blocks=1, input_units1=33, input_units2=6))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_main_eval_only_sparse_and_week_eval(data_dir, tmp_path, monkeypatch, caplog):
    caplog.set_level(logging.INFO, logger="preprec")
    m = _run(data_dir, tmp_path, monkeypatch, "--inference_only", "--mode", "valid",
             "--use_week_eval", "--eval_quality", "--prng", "rbg")
    assert len(m) == 3
    assert "valid NDCG@10" in caplog.text
    assert "[[" in caplog.text  # the grouped metrics line
    assert not (tmp_path / "res" / "synth" / "test" / "best.ckpt").exists()
    sparse = _run(data_dir, tmp_path, monkeypatch, "--sparse", "--num_epochs", "1",
                  "--epoch_test", "1", "--train_dir", "sparse_run")
    assert len(sparse) == 3
    assert "epoch 1 test: NDCG@10" in caplog.text  # sparse validates on the test split


@pytest.mark.parametrize("argv", [
    ["--model", "sasrec"], ["--model", "newb4rec"], ["--model", "bert4rec"], ["--model", "bprmf"],
    ["--model", "cl4srec"], ["--model", "mostpop"], ["--transfer"], ["--fs_transfer"],
    ["--state_dict_path", "x.ckpt"], ["--dataset2", "other"], ["--save_scores"],
    ["--use_scores"], ["--export_user_embed"], ["--save_emb"], ["--export_serving", "x.bin"],
], ids=lambda a: "_".join(a).strip("-"))
def test_flags_not_ported_raise(data_dir, tmp_path, monkeypatch, argv):
    with pytest.raises(NotImplementedError, match="A5b"):
        _run(data_dir, tmp_path, monkeypatch, *argv)


def test_device_defaults_to_cuda(data_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert port_main.parse(["--dataset", "synth"]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_main.main(["--dataset", "synth", "--data_dir", data_dir])


def test_parse_is_flag_compatible_with_jax():
    """Every flag of the JAX CLI parses to the same value in the port's."""
    argv = [
        "--dataset", "x/y", "--train_dir", "t", "--batch_size", "8", "--lr", "0.01",
        "--wd", "1e-5", "--maxlen", "16", "--hidden_units", "8", "--num_blocks", "1",
        "--num_epochs", "2", "--epoch_test", "1", "--stop_early", "2", "--num_heads", "1",
        "--dropout_rate", "0.1", "--l2_emb", "0.1", "--device", "cuda", "--train_only",
        "--inference_only", "--save_neg", "--first_eval", "--mode", "valid", "--prev_time",
        "--no_valid_in_test", "--state_dict_path", "p.ckpt", "--model", "newrec",
        "--monthpop", "wtembed", "--weekpop", "week_embed2", "--use_week_eval",
        "--week_eval_pop", "week_wt_embed_adj", "--rawpop", "rawpop", "--userpop",
        "lastuserpop", "--userneg", "userneg", "--base_dim1", "11", "--input_units1", "132",
        "--base_dim2", "6", "--input_units2", "6", "--mask_prob", "0.2", "--seed", "1",
        "--topk", "10", "5", "1", "--augment", "--augfulllen", "0", "--transfer",
        "--fs_transfer", "--fs_num_epochs", "3", "--fs_prop", "0.5", "--loss_size", "10",
        "--max_split_size", "128.0", "--no_emb", "--no_fixed_emb", "--eval_method", "3",
        "--eval_quality", "--quality_size", "20", "--triplet_loss", "--cos_loss",
        "--reg_file", "userhist", "--reg_num", "5", "--reg_coef", "0.5", "--only_reg",
        "--dataset2", "a/b", "--lag", "2", "--time_embed", "--time_no_fixed_embed",
        "--time_embed_concat", "--save_scores", "--use_scores", "--not_rank_scores",
        "--use_score_dir", "d", "--alphas", "0.3", "0.7", "--sparse", "--override_sparse",
        "--sparse_name", "sparse_", "--save_ranks", "--ranks_name", "r", "--save_emb",
        "--label", "z", "--fs_emb", "--time_df_mod", "_m", "--aug_coef", "0.2",
        "--state_override", "--eval_batch_size", "7", "--eval_item_chunk", "99", "--prng", "rbg",
        "--export_serving", "s.bin",
    ]
    assert vars(port_main.parse(argv)) == vars(jax_main.parse(argv))
    defaults = vars(port_main.parse(["--dataset", "d"]))
    jax_defaults = vars(jax_main.parse(["--dataset", "d"]))
    assert defaults.pop("device") == "cuda" and jax_defaults.pop("device") == "tpu"
    assert defaults == jax_defaults

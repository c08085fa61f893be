"""`python -m bsarec_tpu_torch.preprec.main` on the CPU: training with an
eval under each method for each of the six models and mostpop, each
model's checkpoint read by the JAX package, eval only, the sparse
partition, the flag surface, and each of the transfer, score, embedding,
serving and second-dataset flags run to its end.

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
from bsarec_tpu.preprec.models import PREPREC_REGISTRY as JAX_REGISTRY
from bsarec_tpu.preprec.models import NewRecModel as JaxNewRec
from bsarec_tpu.preprec.torch_import import import_preprec_torch
from bsarec_tpu_torch.preprec import main as port_main
from bsarec_tpu_torch.preprec import preprocess
from bsarec_tpu_torch.preprec.config import PrepRecConfig
from bsarec_tpu_torch.preprec.models import PREPREC_REGISTRY, NewRecModel
from bsarec_tpu_torch.preprec.serving import load_candidate_scorer
from test_torch_port_preprec_zoo import model_inputs

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
    for path in root.glob("synth_*"):  # a second dataset for --dataset2
        shutil.copy(path, root / path.name.replace("synth_", "other_", 1))
    return str(root)


@pytest.fixture(scope="module")
def source_run(data_dir, tmp_path_factory):
    """A trained NewRec run: (its best.ckpt, its method-1 preds.txt)."""
    work = tmp_path_factory.mktemp("preprec_port_main_source")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        port_main.main(["--dataset", "synth", "--data_dir", data_dir, *SMALL, "--num_epochs", "1",
                        "--epoch_test", "1", "--train_dir", "src", "--save_scores"])
    finally:
        os.chdir(cwd)
    run = work / "res" / "synth" / "src"
    return str(run / "best.ckpt"), str(run / "preds.txt")


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


def _jax_predict_matches(name, ckpt, fields):
    """The port's and the JAX package's predict on the checkpoint agree."""
    x = model_inputs(4, usernum=fields["usernum"], itemnum=fields["itemnum"])
    feats = x["feats"][..., :39]
    cand_feats = x["cand_feats"][..., :39]
    model = PREPREC_REGISTRY[name](PrepRecConfig(model=name, **fields)).eval()
    model.load_state_dict(torch.load(ckpt))
    params = import_preprec_torch(name, ckpt, fields["num_blocks"])
    jm = JAX_REGISTRY[name](JaxPrepRecConfig(model=name, **fields))
    if name == "newb4rec":
        args = (feats, x["seq"] > 0, cand_feats)
    elif name == "bprmf":
        args = (x["users"], x["cand"])
    else:
        args = (x["seq"], x["cand"])
    with torch.no_grad():
        got = model.predict(*(torch.from_numpy(np.asarray(a)) for a in args)).numpy()
    want = np.asarray(jm.apply({"params": params}, *args, method="predict"))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("method", [1, 3])
@pytest.mark.parametrize("name", ["sasrec", "bert4rec", "newb4rec", "bprmf", "cl4srec", "mostpop"])
def test_main_trains_each_model_and_jax_reads_its_checkpoint(data_dir, tmp_path, monkeypatch,
                                                            caplog, name, method):
    caplog.set_level(logging.INFO, logger="preprec")
    metrics = _run(data_dir, tmp_path, monkeypatch, "--model", name, "--num_epochs", "1",
                   "--epoch_test", "1", "--eval_method", str(method), "--eval_item_chunk", "16",
                   "--mask_prob", "0.2", "--loss_size", "10", "--save_ranks")
    assert len(metrics) == 3 and all(0 <= v <= 1 for m in metrics for v in m)
    run = tmp_path / "res" / "synth" / "test"
    if name == "mostpop":
        assert not run.exists() and "test NDCG@10" in caplog.text
        return
    assert {"epoch=1.ckpt", "best.ckpt", "ranks.txt"} <= set(os.listdir(run))
    loss = float(caplog.text.split("epoch 1: loss ")[1].split()[0])
    assert np.isfinite(loss) and loss > 0
    ranks = np.loadtxt(run / "ranks.txt")
    assert ranks.shape == (60,) and ranks.min() >= 0 and ranks.max() <= (20 if method == 1 else 50)
    _jax_predict_matches(name, str(run / "best.ckpt"), dict(
        usernum=60, itemnum=50, maxlen=12, hidden_units=16, num_blocks=1, input_units1=33,
        input_units2=6))


def _flag_run(argv, source_run):
    """The companion flags that let `argv` run to its end."""
    ckpt, preds = source_run
    flag = argv[0].lstrip("-")
    if flag == "model":
        return [*argv, "--mask_prob", "0.2", "--loss_size", "10"]
    return {
        "transfer": [*argv, "--state_dict_path", ckpt],
        "fs_transfer": [*argv, "--state_dict_path", ckpt, "--fs_emb", "--fs_num_epochs", "1"],
        "state_dict_path": ["--state_dict_path", ckpt],
        "use_scores": [*argv, "--inference_only", "--use_score_dir", preds, "--alphas", "0.2", "0.8"],
    }.get(flag, argv)


@pytest.mark.parametrize("argv", [
    ["--model", "sasrec"], ["--model", "newb4rec"], ["--model", "bert4rec"], ["--model", "bprmf"],
    ["--model", "cl4srec"], ["--model", "mostpop"], ["--transfer"], ["--fs_transfer"],
    ["--state_dict_path", "x.ckpt"], ["--dataset2", "other"], ["--save_scores"],
    ["--use_scores"], ["--export_user_embed"], ["--save_emb"], ["--export_serving", "x.bin"],
], ids=lambda a: "_".join(a).strip("-"))
def test_flags_run_to_their_end(data_dir, source_run, tmp_path, monkeypatch, caplog, argv):
    """Each flag that the CLI once refused now runs to its end and writes
    what it should."""
    caplog.set_level(logging.INFO, logger="preprec")
    metrics = _run(data_dir, tmp_path, monkeypatch, "--num_epochs", "1", "--epoch_test", "1",
                   *_flag_run(argv, source_run))
    run = tmp_path / "res" / "synth" / "test"
    flag, log = argv[0].lstrip("-"), caplog.text
    if flag in ("export_user_embed", "save_emb"):
        assert metrics is None
        assert np.loadtxt(run / "user_embed_embed.txt").shape == (60, 16)
        return
    assert len(metrics) == 3 and all(0 <= v <= 1 for m in metrics for v in m)
    if flag == "model":
        assert argv[1] == "mostpop" or (run / "best.ckpt").exists()
    elif flag == "transfer":  # zero-shot: evaluation only
        assert "loaded transfer weights" in log and not (run / "best.ckpt").exists()
        assert "epoch 1: loss" not in log
    elif flag in ("fs_transfer", "state_dict_path"):
        assert "loaded transfer weights" in log and "epoch 1: loss" in log
        best, src = torch.load(run / "best.ckpt"), torch.load(source_run[0])
        assert all(k in best for k in src)
        if flag == "fs_transfer":  # only the adapter trained
            assert any(k.startswith("fs_layer") for k in best)
            for k, v in src.items():
                torch.testing.assert_close(best[k], v, rtol=0, atol=0)
    elif flag == "dataset2":
        assert "epoch 1 dataset-2 loss" in log and "valid dataset-2: [[" in log
        assert (tmp_path / "res" / "other" / "test").is_dir()
    elif flag == "save_scores":
        assert np.loadtxt(run / "preds.txt").shape == (60, 21)
    elif flag == "use_scores":
        assert "alpha=0.2: [[" in log and "alpha=0.8: [[" in log
    elif flag == "export_serving":
        assert "exported candidate scorer" in log
        scorer = load_candidate_scorer(str(tmp_path / "x.bin"), "cpu")
        assert (scorer.seq_len, scorer.n_cands) == (12, 21)


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

"""Port eval vs the JAX package on the same weights and corpus: Trainer
metric sums and `export_topk` ids for eval_impl dense and streaming
(the JAX streaming path runs its Pallas kernel in interpret mode), and
both CLIs' `--do_eval --export_topk` on one corpus file and checkpoint.

Scores differ only by fp32 summation order (atol 1e-6 on metric sums);
the exported ids are compared exactly, since both packages break ties
towards the smallest item id."""

import logging

import jax
import numpy as np
import pytest
import torch

from bsarec_tpu.config import ModelConfig as JaxModelConfig
from bsarec_tpu.config import TrainConfig as JaxTrainConfig
from bsarec_tpu.data.corpus import Corpus as JaxCorpus
from bsarec_tpu.data.pipeline import SeqRecData as JaxSeqRecData
from bsarec_tpu.train.trainer import Trainer as JaxTrainer
from bsarec_tpu_torch.config import ModelConfig, TrainConfig
from bsarec_tpu_torch.data.corpus import Corpus
from bsarec_tpu_torch.data.pipeline import SeqRecData
from bsarec_tpu_torch.models import build_model
from bsarec_tpu_torch.ops import rank
from bsarec_tpu_torch.train.checkpoint import save_params
from bsarec_tpu_torch.train.jax_import import params_from_jax
from bsarec_tpu_torch.train.loop import STREAMING_RANK_MIN_VOCAB, resolve_eval_impl
from bsarec_tpu_torch.train.trainer import Trainer

MODEL = dict(model_type="bsarec", max_seq_length=10, hidden_size=16, num_hidden_layers=2,
             num_attention_heads=2, c=5, alpha=0.7)
EVAL_BATCH = 32  # 70 users: the last batch is padded


def synthetic_seqs(n_users=70, n_items=60, seed=0):
    rng = np.random.default_rng(seed)
    seqs = []
    for _ in range(n_users):
        start, length = rng.integers(1, n_items - 1), rng.integers(3, 14)
        seqs.append([int((start + 3 * i) % (n_items - 1) + 1) for i in range(length)])
    seqs[0] = list(range(1, 14))  # the longest history: fills the seen width
    return seqs


def _logger():
    logger = logging.getLogger("test_torch_port_eval")
    logger.addHandler(logging.NullHandler())
    logger.propagate = False
    return logger


def _trainers(tmp_path, eval_impl):
    seqs = synthetic_seqs()
    max_item = max(map(max, seqs))
    jdata = JaxSeqRecData(JaxCorpus(user_seq=[list(s) for s in seqs], max_item=max_item), 10)
    data = SeqRecData(Corpus(user_seq=[list(s) for s in seqs], max_item=max_item), 10)
    fields = MODEL | dict(item_size=max_item + 1, num_users=len(seqs) + 1)
    jtrainer = JaxTrainer(JaxModelConfig(**fields),
                          JaxTrainConfig(eval_batch_size=EVAL_BATCH, eval_impl=eval_impl, seed=5),
                          jdata, _logger(), str(tmp_path / "j.ckpt"))
    trainer = Trainer(ModelConfig(**fields),
                      TrainConfig(eval_batch_size=EVAL_BATCH, eval_impl=eval_impl, device="cpu"),
                      data, _logger(), str(tmp_path / "p.ckpt"))
    trainer.install_params(params_from_jax(jax.device_get(jtrainer.params)))
    assert trainer.eval_impl == jtrainer.eval_impl == eval_impl
    return jtrainer, trainer


@pytest.mark.parametrize("eval_impl", ["dense", "streaming"])
def test_trainer_eval_matches_jax(tmp_path, eval_impl):
    jtrainer, trainer = _trainers(tmp_path, eval_impl)
    for split in ("valid", "test"):
        dev = jtrainer._eval_dev[split]
        want = np.asarray(jtrainer._eval_fn(jtrainer.params, dev["inputs"], dev["answers"], dev["seen"]))
        np.testing.assert_allclose(trainer.evaluate_sums(split), want, atol=1e-6, rtol=0)
        assert trainer.evaluate_sums(split)[-1] == 70
    np.testing.assert_allclose(trainer.test(0)[0], jtrainer.test(0)[0], atol=1e-6, rtol=0)
    np.testing.assert_allclose(trainer.valid(0)[0], jtrainer.valid(0)[0], atol=1e-6, rtol=0)
    got = trainer.export_topk("test")
    assert got.shape == (70, 20) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(jtrainer.export_topk("test")))


@pytest.mark.parametrize("eval_impl", ["dense", "streaming"])
def test_column0_quirk_copied_per_path(tmp_path, eval_impl):
    """With a nonzero table row 0, dense keeps item 0's logit for the user
    whose history fills the seen width (no 0-padding re-zeroes it), while
    streaming always masks item 0. Each port path copies its JAX path."""
    jtrainer, trainer = _trainers(tmp_path, eval_impl)
    # user 0's test input has no padding, so its state does not read row 0
    with torch.no_grad():
        state0 = trainer.model.predict(torch.from_numpy(trainer.data.test.input_ids[:1]).long())[0, -1]
    params = jax.device_get(jtrainer.params)
    table = np.asarray(params["item_embeddings"]["embedding"]).copy()
    table[0] = 10.0 * state0.numpy()  # as after training, which updates row 0
    params["item_embeddings"]["embedding"] = table
    jtrainer.install_params(params)
    trainer.install_params(params_from_jax(params))
    assert trainer.data.test.seen_items[0].all()  # user 0 fills the seen width
    got = trainer.export_topk("test")
    np.testing.assert_array_equal(got, np.asarray(jtrainer.export_topk("test")))
    assert (got[0, 0] == 0) == (eval_impl == "dense")
    padded = (trainer.data.test.seen_items == 0).any(axis=1)
    assert (got[padded, 0] != 0).all()
    if eval_impl == "streaming":
        assert (got[:, 0] != 0).all()


def test_streaming_seen_ids_format_matches_bitmask(tmp_path):
    """The per-batch device bitmask ("ids", used above the staging limit)
    ranks exactly as the staged bitmask."""
    _, trainer = _trainers(tmp_path, "streaming")
    assert trainer._seen_format == "bitmask"
    split = trainer.data.test
    want = trainer.export_topk("test")
    trainer._seen_format = "ids"
    fn, steps, impl = trainer._build_eval(collect_topk=True)
    seen = torch.from_numpy(rank.dedupe_seen_rows(split.seen_items))
    dev = trainer._eval_dev["test"]
    assert (steps, impl) == (3, "streaming")
    np.testing.assert_array_equal(fn(dev["inputs"], dev["answers"], seen).numpy(), want)


def test_auto_impl_and_device_rules():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert resolve_eval_impl("auto", STREAMING_RANK_MIN_VOCAB, cuda) == "streaming"
    assert resolve_eval_impl("auto", STREAMING_RANK_MIN_VOCAB - 1, cuda) == "dense"
    assert resolve_eval_impl("auto", STREAMING_RANK_MIN_VOCAB, cpu) == "dense"
    assert resolve_eval_impl("streaming", 10, cpu) == "streaming"
    # the sharded impls are the Trainer's under a vocab-sharded mesh
    for impl in ("sharded_streaming", "sharded_dense"):
        assert resolve_eval_impl(impl, 10, cpu) == impl
    with pytest.raises(NotImplementedError):
        resolve_eval_impl("sharded", 10, cpu)
    if not torch.cuda.is_available():
        from bsarec_tpu_torch.config import resolve_device

        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device("cuda")


@pytest.mark.parametrize("eval_impl", ["dense", "streaming"])
def test_main_do_eval_matches_jax_main(tmp_path, eval_impl):
    from bsarec_tpu.main import main as jax_main
    from bsarec_tpu_torch.main import main as port_main

    seqs = synthetic_seqs()
    (tmp_path / "Toy.txt").write_text(
        "".join(f"{u + 1} {' '.join(map(str, s))}\n" for u, s in enumerate(seqs)))
    fields = MODEL | dict(item_size=max(map(max, seqs)) + 1, num_users=len(seqs) + 1)
    model = build_model(ModelConfig(**fields), generator=torch.Generator().manual_seed(7))
    save_params(model.state_dict(), tmp_path / "init.ckpt")
    common = [
        "--data_dir", str(tmp_path), "--data_name", "Toy", "--output_dir", str(tmp_path),
        "--do_eval", "--eval_impl", eval_impl, "--model_type", "BSARec",
        "--max_seq_length", "10", "--hidden_size", "16", "--num_hidden_layers", "2",
        "--num_attention_heads", "2", "--c", "5", "--alpha", "0.7",
    ]
    got = port_main(common + ["--device", "cpu", "--load_model", "init", "--train_name", "port",
                              "--export_topk", str(tmp_path / "port.npy")])
    want = jax_main(common + ["--load_torch_model", str(tmp_path / "init.ckpt"),
                              "--train_name", "jax", "--export_topk", str(tmp_path / "jax.npy")])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy"))
    # the reference torch layout also loads directly
    again = port_main(common + ["--device", "cpu", "--train_name", "port2",
                                "--load_torch_model", str(tmp_path / "init.ckpt")])
    assert again == got


def test_main_reads_a_pre_rename_reference_checkpoint(tmp_path):
    """A reference BSARec checkpoint from before the rename holds
    `filter_layer.beta` where newer ones hold `sqrt_beta`. Both CLIs read
    it with `--load_torch_model` and export the same top-k with the same
    scores; the port's own checkpoints stay strict: `--load_model` of one
    with an unknown key raises."""
    from bsarec_tpu.main import main as jax_main
    from bsarec_tpu_torch.main import main as port_main

    seqs = synthetic_seqs()
    (tmp_path / "Toy.txt").write_text(
        "".join(f"{u + 1} {' '.join(map(str, s))}\n" for u, s in enumerate(seqs)))
    fields = MODEL | dict(item_size=max(map(max, seqs)) + 1, num_users=len(seqs) + 1)
    model = build_model(ModelConfig(**fields), generator=torch.Generator().manual_seed(11))
    old = {k.replace(".filter_layer.sqrt_beta", ".filter_layer.beta"): v
           for k, v in model.state_dict().items()}
    assert sum(k.endswith(".filter_layer.beta") for k in old) == MODEL["num_hidden_layers"]
    save_params(old, tmp_path / "old.pt")
    common = [
        "--data_dir", str(tmp_path), "--data_name", "Toy", "--output_dir", str(tmp_path),
        "--do_eval", "--model_type", "BSARec", "--max_seq_length", "10", "--hidden_size", "16",
        "--num_hidden_layers", "2", "--num_attention_heads", "2", "--c", "5", "--alpha", "0.7",
        "--load_torch_model", str(tmp_path / "old.pt"),
    ]
    got = port_main(common + ["--device", "cpu", "--train_name", "port",
                              "--export_topk", str(tmp_path / "port.npy")])
    want = jax_main(common + ["--train_name", "jax", "--export_topk", str(tmp_path / "jax.npy")])
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy"))
    # the same weights under today's names give the same scores
    save_params(model.state_dict(), tmp_path / "new.pt")
    assert port_main([*common[:-1], str(tmp_path / "new.pt"), "--device", "cpu",
                      "--train_name", "port_new"]) == got
    # a port checkpoint is loaded as it is: the old name is an unknown key
    save_params(old, tmp_path / "old_port.ckpt")
    with pytest.raises(RuntimeError, match="sqrt_beta"):
        port_main([*common[:-2], "--device", "cpu", "--train_name", "port_strict",
                   "--load_model", "old_port"])


def test_main_refuses_training_and_unported_flags(tmp_path):
    """Training asks for the card unless --device cpu is given, with
    --multihost too; no flag is left unported (--multihost runs:
    tests/test_torch_port_multihost.py)."""
    from bsarec_tpu_torch.main import main as port_main

    if not torch.cuda.is_available():
        for extra in ([], ["--multihost"]):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                port_main(["--output_dir", str(tmp_path), "--data_dir", str(tmp_path), *extra])
    # --mesh runs (a one-rank group here; tests/test_torch_port_mesh.py has
    # the rest) and leaves no group behind
    import torch.distributed as dist

    (tmp_path / "toy.txt").write_text("1 3 4 5\n2 4 5 6 7\n3 1 2\n")
    assert port_main(["--device", "cpu", "--do_eval", "--mesh", "auto", "--data_dir",
                      str(tmp_path), "--data_name", "toy", "--output_dir", str(tmp_path)]) is None
    assert not dist.is_initialized()

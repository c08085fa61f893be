"""`--multihost`, the host-fed pipeline (`bsarec_tpu_torch/data/multihost.py`,
`train/loop.py:build_host_fed_epoch`), on the CPU:

- the schedule functions against `bsarec_tpu.data.multihost`'s at one
  process (the same numpy generator: array-equal), and at 2 and 4 data
  ranks the local slices, in rank order, against the one-rank batches;
- `global_batch`'s row check and its int32 -> int64 staging;
- one step of the port's `build_train_step` against JAX's;
- `Trainer(multihost=True)` against `Trainer(multihost=False)` for five
  models (losses array-equal, the training set never on the device), a
  snapshot round trip, and `main --multihost`, alone and under `--mesh`.

The gloo groups' host-fed cases are in `tests/test_torch_port_mesh.py`."""

import logging
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from bsarec_tpu.config import ModelConfig as JaxModelConfig
from bsarec_tpu.config import TrainConfig as JaxTrainConfig
from bsarec_tpu.data import multihost as jax_multihost
from bsarec_tpu.models import build_model as jax_build_model
from bsarec_tpu.train.loop import build_train_step as jax_build_train_step
from bsarec_tpu.train.loop import make_optimizer as jax_make_optimizer
from bsarec_tpu_torch.config import ModelConfig, TrainConfig
from bsarec_tpu_torch.core.mesh import Mesh, using_mesh
from bsarec_tpu_torch.data import multihost
from bsarec_tpu_torch.data.corpus import Corpus
from bsarec_tpu_torch.data.pipeline import SeqRecData
from bsarec_tpu_torch.models import build_model
from bsarec_tpu_torch.train.jax_import import params_from_jax
from bsarec_tpu_torch.train.loop import build_train_step, make_optimizer, sample_negatives
from bsarec_tpu_torch.train.trainer import Trainer
from test_torch_port_train import FIELDS, LOSS_RTOL, OPT, PARAM_ATOL, _batch


# one Adam step against JAX at one layer (JAX compiles the step once)
STEP_FIELDS = FIELDS | dict(num_hidden_layers=1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fields(n=50, width=3):
    rng = np.random.default_rng(4)
    ids = rng.integers(1, 1000, size=(n, width)).astype(np.int32)
    return {"input_ids": ids, "answers": np.arange(n, dtype=np.int32),
            "user_ids": (np.arange(n, dtype=np.int32) * 7) % 13}


# ---- the schedule functions ------------------------------------------------------


@pytest.mark.parametrize("n_rows", [1, 7, 103, 1024])
def test_host_shard_matches_jax_and_covers_the_rows(n_rows):
    assert multihost.host_shard(n_rows) == jax_multihost.host_shard(n_rows) == (0, n_rows)
    for count in (2, 4):
        parts = [multihost.host_shard(n_rows, p, count) for p in range(count)]
        rows = [r for lo, hi in parts for r in range(lo, hi)]
        assert rows == list(range(n_rows)), parts
    with pytest.raises(ValueError, match="out of"):
        multihost.host_shard(n_rows, 2, 2)


def test_schedules_match_jax_at_one_process():
    """`epoch_batches` (the (seed, epoch) permutation, the partial batch
    dropped) and `epoch_batches_from_perm` (a wrapped schedule) yield
    JAX's batches, array-equal."""
    fields = _fields()
    port = multihost.HostShardedDataset(fields, batch_size=16, seed=5)
    ref = jax_multihost.HostShardedDataset(fields, batch_size=16, seed=5)
    assert (port.local_batch, port.n_rows) == (ref.local_batch, ref.n_rows) == (16, 50)
    for epoch in (0, 3):
        got, want = list(port.epoch_batches(epoch)), list(ref.epoch_batches(epoch))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
                assert g[k].dtype == w[k].dtype
    perm = np.random.default_rng(1).permutation(50)
    perm = np.concatenate([perm, perm[:14]])  # wrapped to 4 full batches
    got, want = (list(ds.epoch_batches_from_perm(perm)) for ds in (port, ref))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("count", [2, 4])
def test_local_slices_concatenate_to_the_one_rank_batch(count):
    """At `count` data ranks (explicit index and count) every rank's slice
    of each batch, concatenated in rank order, is the one-rank batch."""
    fields = _fields()
    one = multihost.HostShardedDataset(fields, batch_size=16, seed=2)
    ranks = [multihost.HostShardedDataset(fields, batch_size=16, seed=2, process_index=p,
                                          process_count=count) for p in range(count)]
    assert all(ds.local_batch == 16 // count for ds in ranks)
    perm = np.arange(64) % 50
    for schedule in (lambda ds: ds.epoch_batches(1), lambda ds: ds.epoch_batches_from_perm(perm)):
        want = list(schedule(one))
        parts = [list(schedule(ds)) for ds in ranks]
        for s, w in enumerate(want):
            for k in w:
                np.testing.assert_array_equal(np.concatenate([p[s][k] for p in parts]), w[k])


def test_schedule_errors():
    """Both of JAX's ValueErrors: a global batch that the data ranks do not
    divide, a schedule that is not whole batches."""
    fields = _fields()
    with pytest.raises(ValueError, match="must divide the global batch"):
        multihost.HostShardedDataset(fields, batch_size=18, seed=0, process_index=0,
                                     process_count=4)
    ds = multihost.HostShardedDataset(fields, batch_size=16, seed=0)
    with pytest.raises(ValueError, match="not a multiple"):
        next(ds.epoch_batches_from_perm(np.arange(50)))


def test_global_batch_checks_rows_and_widens_on_the_device():
    """`global_batch` takes this data rank's share of the global batch and
    no other row count; it gives each field as int64 on the device, equal
    to the host rows, through a staging ring whose buffers are reused."""
    fields = _fields()
    local = {k: v[:16] for k, v in fields.items()}
    out = multihost.global_batch(local, None, 16, device="cpu")
    for k, v in local.items():
        assert out[k].dtype == torch.int64 and out[k].shape == v.shape
        np.testing.assert_array_equal(out[k].numpy(), v)
    with pytest.raises(ValueError, match="share of a global batch of 32 is 32"):
        multihost.global_batch(local, None, 32, device="cpu")
    mesh = Mesh.__new__(Mesh)  # data rank 1 of 2: 8 rows of 16
    mesh.data, mesh.data_rank, mesh.device = 2, 1, torch.device("cpu")
    with pytest.raises(ValueError, match="share of a global batch of 16 is 8"):
        multihost.global_batch(local, mesh, 16)
    half = {k: v[8:16] for k, v in fields.items()}
    assert torch.equal(multihost.global_batch(half, mesh, 16)["answers"],
                       torch.arange(8, 16))
    staging = multihost.PinnedStaging(torch.device("cpu"))
    steps = [{k: v[s * 8:(s + 1) * 8] for k, v in fields.items()} for s in range(5)]
    outs = [multihost.global_batch(rows, None, 8, staging=staging) for rows in steps]
    for rows, out in zip(steps, outs):  # later steps did not overwrite earlier ones
        np.testing.assert_array_equal(out["input_ids"].numpy(), rows["input_ids"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            multihost.global_batch(local, None, 16)  # the card by default


def test_init_distributed_joins_the_launchers_group(monkeypatch):
    """No launcher environment: a no-op. With one (a one-rank gloo group on
    a localhost port): joined; a second call is a no-op."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    multihost.init_distributed("cpu")
    assert not dist.is_initialized()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    try:
        multihost.init_distributed("cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
        multihost.init_distributed("cpu")
        assert dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_negatives_of_a_data_rank_are_the_global_draws_rows():
    """Under a mesh with 2 data ranks each rank's negatives, drawn for its 8
    rows of a global batch of 16, are the global draw's rows: each round
    draws the global vector and the collision test is per row (a small
    catalog, so that rows collide and redraw)."""
    rng = np.random.default_rng(3)
    ids = torch.from_numpy(rng.integers(0, 12, size=(16, 6)))
    answers = torch.from_numpy(rng.integers(1, 12, size=16))
    want = sample_negatives(torch.Generator().manual_seed(9), ids, answers, 12)
    assert not ((ids == want[:, None]).any(dim=1) | (want == answers)).all()
    for rank in range(2):
        mesh = Mesh.__new__(Mesh)
        mesh.data, mesh.data_rank = 2, rank
        rows = mesh.data_slice(16)
        with using_mesh(mesh):
            got = sample_negatives(torch.Generator().manual_seed(9), ids[rows], answers[rows], 12)
        assert torch.equal(got, want[rows]), rank


# ---- one step against JAX -------------------------------------------------------


def test_train_step_matches_jax():
    """BSARec, dropout 0, the same weights (`params_from_jax`) and batch:
    one step of the port's `build_train_step` against JAX's, the loss and
    every parameter after Adam."""
    jmodel = jax_build_model(JaxModelConfig(**STEP_FIELDS, loss_impl="dense"))
    key = jax.random.PRNGKey(0)
    dummy = jnp.zeros((2, STEP_FIELDS["max_seq_length"]), jnp.int32)
    params = jax.device_get(jmodel.init({"params": key, "dropout": key}, dummy,
                                        train=False)["params"])
    tx = jax_make_optimizer(JaxTrainConfig(**OPT))
    step = jax_build_train_step(jmodel, tx, STEP_FIELDS["item_size"], with_sem=False)
    ids, answers = _batch(seed=21, b=16)
    jparams, _, jloss = step(jax.tree.map(jnp.asarray, params), tx.init(params), key, {
        "input_ids": jnp.asarray(ids), "answers": jnp.asarray(answers),
        "user_ids": jnp.zeros(len(ids), jnp.int32)})

    model = build_model(ModelConfig(**STEP_FIELDS, loss_impl="dense"))
    model.load_state_dict(params_from_jax(params))
    model.train()
    port_step = build_train_step(model, make_optimizer(model.parameters(), TrainConfig(**OPT)))
    loss = port_step(torch.from_numpy(ids).long(), torch.from_numpy(answers).long(),
                     torch.Generator().manual_seed(0))
    assert not loss.requires_grad
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL)
    want, got = params_from_jax(jax.device_get(jparams)), model.state_dict()
    assert got.keys() == want.keys()
    for name, value in want.items():
        if name.endswith("attention_layer.key.bias"):  # zero at init, zero true gradient
            assert got[name].abs().max() <= OPT["lr"] and value.abs().max() <= OPT["lr"], name
            continue
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=PARAM_ATOL, rtol=0,
                                   err_msg=name)


# ---- the Trainer ----------------------------------------------------------------------


def _logger():
    logger = logging.getLogger("test_torch_port_multihost")
    logger.handlers[:] = [logging.NullHandler()]
    logger.propagate = False
    return logger


def _data():
    rng = np.random.default_rng(8)
    seqs = [[int(x) for x in rng.integers(1, 50, size=rng.integers(4, 12))] for _ in range(40)]
    return SeqRecData(Corpus(user_seq=seqs, max_item=max(map(max, seqs))), 10)


MODEL_FIELDS = {"BSARec": dict(c=3, alpha=0.7), "SASRec": {}, "Caser": dict(nh=2, nv=2),
                "DuoRec": {}, "BERT4Rec": {}}


def _trainer(tmp_path, data, model_type, multihost_on, name="m"):
    cfg = ModelConfig(model_type=model_type, item_size=data.item_size,
                      num_users=data.corpus.num_users + 1, max_seq_length=10, hidden_size=16,
                      num_hidden_layers=1, num_attention_heads=2, **MODEL_FIELDS[model_type])
    train = TrainConfig(batch_size=16, device="cpu", seed=3, multihost=multihost_on, lr=5e-3)
    return Trainer(cfg, train, data, _logger(), str(tmp_path / f"{name}.ckpt"))


@pytest.mark.parametrize("model_type", list(MODEL_FIELDS))
def test_trainer_host_fed_equals_device_resident(tmp_path, model_type):
    """Two epochs, dropout 0.5: the host-fed losses array-equal to the
    device-resident ones, the valid sums equal, and the training set never
    on the device. BSARec (dropout), SASRec (negatives), Caser (user ids),
    DuoRec (the same-target view, a host field) and BERT4Rec (cloze
    draws)."""
    data = _data()
    runs = {}
    for on in (False, True):
        tr = _trainer(tmp_path, data, model_type, on, name=f"m{int(on)}")
        losses = [tr.train(e) for e in range(2)]
        runs[on] = (losses, tr.evaluate_sums("valid"), tr)
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    np.testing.assert_array_equal(runs[True][1], runs[False][1])
    host = runs[True][2]
    assert host._train_dev is None and runs[False][2]._train_dev is not None
    fields = set(host._host_ds.fields)
    assert ("user_ids" in fields) == (model_type == "Caser")
    assert ("same_target" in fields) == (model_type == "DuoRec")
    assert all(isinstance(v, np.ndarray) for v in host._host_ds.fields.values())


def test_host_fed_snapshot_resume_continues_bit_equal(tmp_path):
    """`save_state` -> `resume` under --multihost: the resumed trainer's
    next epoch and parameters equal the uninterrupted one's."""
    data = _data()
    first = _trainer(tmp_path, data, "BSARec", True)
    first.train(0)
    first.save_state(0)
    want = first.train(1)
    second = _trainer(tmp_path, data, "BSARec", True)
    second.train(0)
    second.train(1)  # move away from the snapshot first
    assert second.resume() == 1
    assert second.train(1) == want
    for (name, a), b in zip(first.model.state_dict().items(), second.model.state_dict().values()):
        assert torch.equal(a, b), name


def test_main_multihost_equals_the_plain_run(tmp_path, monkeypatch):
    """`main --device cpu --multihost`, alone and with `--mesh auto` (a
    one-rank group): the scores equal the plain run's and the checkpoint is
    bit-equal; the log names the host-fed input; no group is left. Alone
    it is one process even under a launcher's environment of two ranks: it
    joins no group."""
    from bsarec_tpu_torch.main import main as port_main

    data = _data()
    (tmp_path / "toy.txt").write_text(
        "".join(f"{u + 1} {' '.join(map(str, s))}\n" for u, s in enumerate(data.corpus.user_seq)))
    common = ["--device", "cpu", "--data_dir", str(tmp_path), "--data_name", "toy",
              "--output_dir", str(tmp_path), "--epochs", "2", "--hidden_size", "16",
              "--num_hidden_layers", "1", "--max_seq_length", "10", "--batch_size", "16"]
    plain = port_main([*common, "--train_name", "plain"])
    want = torch.load(tmp_path / "plain.ckpt")

    def refuse(*args, **kwargs):
        raise AssertionError("--multihost without --mesh joined a process group")

    for name, extra in (("host", []), ("host_mesh", ["--mesh", "auto"])):
        with monkeypatch.context() as m:
            if not extra:
                m.setenv("RANK", "0")
                m.setenv("WORLD_SIZE", "2")
                m.setattr(dist, "init_process_group", refuse)
            assert port_main([*common, "--train_name", name, "--multihost", *extra]) == plain, name
        got = torch.load(tmp_path / f"{name}.ckpt")
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want), name
        log = (tmp_path / f"{name}.log").read_text()
        assert "input: host-fed (--multihost)" in log and "data rank 0 of 1" in log, name
        assert not dist.is_initialized()
    assert "input: host-fed" not in (tmp_path / "plain.log").read_text()


@pytest.mark.parametrize("model_type", ["BSARec", "Caser", "DuoRec"])
def test_every_flag_of_the_jax_main_is_the_ports(model_type):
    """The port's `main` takes every flag of JAX's (its values' names): none
    is left unported."""
    from bsarec_tpu.main import parse_args as jax_parse_args
    from bsarec_tpu_torch import main as port

    argv = ["--model_type", model_type]
    missing = set(vars(jax_parse_args(argv))) - set(vars(port.parse_args(argv)))
    assert not missing
    assert not hasattr(port, "_NOT_PORTED_FLAGS")

"""PREPRec's transfer and two-dataset training in the port: a partial
checkpoint load, the `fs_emb` freeze (against the JAX package's masked
optimizer on the same weights and draws), and `fit(second=...)`, which
runs both datasets' epochs through one model and one optimizer.

Tolerance of the freeze check against JAX: after two Adam steps the
few-shot adapter's parameters within atol 1e-5 (Adam's first steps move
a parameter by about lr = 1e-3 times the sign of its gradient, so
rounding moves it only where its gradient is near zero); the frozen
parameters bit-equal to the loaded values on both sides."""

import logging

import jax
import numpy as np
import pytest
import torch

from bsarec_tpu.train import checkpoint as jax_ckpt
from bsarec_tpu_torch.preprec.jax_import import preprec_from_jax
from bsarec_tpu_torch.preprec.models import init_params
from bsarec_tpu_torch.preprec.sampler import draw_user_batches
from test_torch_port_preprec_zoo import (  # noqa: F401  (domain is a fixture)
    build_domain,
    domain,
    jax_step,
    one_torch_thread,
    patch_jax_draws,
    step_draws,
    trainer_pair,
)

PARAM_ATOL = 1e-5


def _source_checkpoint(tr, tmp_path):
    """A NewRec checkpoint without fs_layer, its weights moved off the
    trainer's so that a load shows: (torch path, JAX msgpack path, sd)."""
    src = type(tr.model)(tr.cfg.replace(fs_emb=False))
    init_params(src, torch.Generator().manual_seed(11))
    sd = src.state_dict()
    assert not any(k.startswith("fs_layer") for k in sd)
    path = str(tmp_path / "src.ckpt")
    torch.save(sd, path)
    from bsarec_tpu.preprec.torch_import import import_preprec_torch

    jpath = str(tmp_path / "src.msgpack")
    jax_ckpt.save_params(import_preprec_torch("newrec", sd, tr.cfg.num_blocks), jpath)
    return path, jpath, sd


def test_partial_load_keeps_fs_layer_at_its_init(domain, tmp_path):
    prefix, _ = domain
    _, tr = trainer_pair(prefix, tmp_path, "newrec", fs_emb=True)
    fs_init = {k: v.clone() for k, v in tr.model.state_dict().items() if k.startswith("fs_layer")}
    path, _, sd = _source_checkpoint(tr, tmp_path)
    tr.load_transfer(path)
    now = tr.model.state_dict()
    assert fs_init and sorted(now) == sorted([*sd, *fs_init])
    for k, v in fs_init.items():
        torch.testing.assert_close(now[k], v, rtol=0, atol=0)
    for k, v in sd.items():
        torch.testing.assert_close(now[k], v, rtol=0, atol=0)
    bad = {k: v for k, v in sd.items()}
    bad["embed_layer.fc1.weight"] = torch.zeros(3, 3)
    torch.save(bad, tmp_path / "bad.ckpt")
    with pytest.raises(ValueError, match="embed_layer.fc1.weight"):
        tr.load_transfer(str(tmp_path / "bad.ckpt"))


def test_fs_emb_freezes_all_but_the_adapter_as_jax(domain, tmp_path, monkeypatch):
    """Two steps after a transfer load under fs_emb: every parameter but
    fs_layer's stays bit-equal to the loaded value, fs_layer moves, and
    fs_layer's values match the JAX trainer's after the same two steps
    on the same draws (JAX loads the same weights from its msgpack)."""
    prefix, _ = domain
    jtr, tr = trainer_pair(prefix, tmp_path, "newrec", fs_emb=True)
    path, jpath, sd = _source_checkpoint(tr, tmp_path)
    tr.load_transfer(path)
    jtr.load_transfer(jpath)
    fs_before = {k: v.clone() for k, v in tr.model.state_dict().items() if k.startswith("fs_layer")}
    users = draw_user_batches(np.random.default_rng(4), tr.ds.eligible_users, 2, 16)
    tr.model.train()
    for s in range(2):
        u = torch.from_numpy(users[s].astype(np.int64))
        draws = step_draws(tr, u, seed=20 + s)
        d = patch_jax_draws(monkeypatch, draws)
        jtr._epoch_fn = jtr._build_epoch_fn()  # retraced on this step's draws
        loss = tr.step(u, **draws).item()
        np.testing.assert_allclose(loss, jax_step(jtr, users[s], d), rtol=1e-5)
    now = tr.model.state_dict()
    for k, v in sd.items():
        torch.testing.assert_close(now[k], v, rtol=0, atol=0, msg=k)
        assert not tr.model.get_parameter(k).requires_grad
    assert all(not torch.equal(now[k], v) for k, v in fs_before.items())
    want = preprec_from_jax("newrec", jax.device_get(jtr.params))
    for k in fs_before:
        torch.testing.assert_close(now[k], want[k], rtol=0, atol=PARAM_ATOL, msg=k)
    for k, v in sd.items():  # JAX's frozen parameters kept the loaded values too
        torch.testing.assert_close(want[k], v, rtol=0, atol=0, msg=k)


def test_transfer_without_fs_emb_trains_everything_afresh(domain, tmp_path):
    prefix, _ = domain
    _, tr = trainer_pair(prefix, tmp_path, "newrec")
    path, _, sd = _source_checkpoint(tr, tmp_path)
    tr.train_epoch()  # the optimizer has state
    tr.load_transfer(path)
    assert not tr.optimizer.state  # a fresh Adam over every parameter
    assert len(tr.optimizer.param_groups[0]["params"]) == len(sd)
    tr.train_epoch()
    assert all(not torch.equal(tr.model.state_dict()[k], v) for k, v in sd.items()
               if not k.endswith("K_w.bias"))


@pytest.fixture(scope="module")
def second_domain(tmp_path_factory):
    return build_domain(tmp_path_factory.mktemp("preprec_port_second"), n_users=40, n_items=70,
                        seed=3, n=4000)


def test_fit_with_a_second_dataset_shares_one_model(domain, second_domain, tmp_path, caplog):
    prefix, _ = domain
    prefix2, _ = second_domain
    tc = {"num_epochs": 2, "epoch_test": 1}
    _, tr = trainer_pair(prefix, tmp_path / "a", "newrec", tc=tc)
    _, tr2 = trainer_pair(prefix2, tmp_path / "b", "newrec", tc=tc)
    assert tr2.ds.itemnum != tr.ds.itemnum and tr2.ds.usernum != tr.ds.usernum
    logger = logging.getLogger("preprec_port_fit_second")
    logger.propagate = True
    tr.logger = tr2.logger = logger
    caplog.set_level(logging.INFO, logger="preprec_port_fit_second")
    metrics, ranks = tr.fit(second=tr2)
    assert tr2.model is tr.model and tr2.optimizer is tr.optimizer
    lines = caplog.text
    assert lines.count("dataset-2 loss") == 2 and lines.count("valid dataset-2: [[") == 2
    losses = [float(x.split("loss ")[1].split()[0]) for x in lines.splitlines() if "dataset-2 loss" in x]
    assert all(np.isfinite(losses))
    steps = 2 * (tr.num_batch + tr2.num_batch)
    state = tr.optimizer.state[tr.model.embed_layer.fc1.weight]
    assert int(state["step"]) == steps  # both datasets' steps through one Adam
    assert len(metrics) == 3 and ranks.shape == (tr.ds.usernum,)
    m2, r2 = tr2.evaluate("test")
    assert r2.shape == (tr2.ds.usernum,)

"""NewRec in the port against the JAX package: the model's encode,
forward and predict in every config branch with weights carried both
ways, the init scheme, the pairwise BCE, the trajectory regularisers,
one Adam step and the quirk-186 toggle.

Tolerances: model outputs at fp32 with dropout off within rtol 1e-5, and
within 1e-6 of the output's largest magnitude for entries near zero (a
logit is a sum that cancels): the same arithmetic with sums taken in
another order. The BCE and the losses of a step within rtol 1e-6. After
one Adam step (lr 1e-3, wd 1e-5) parameters within atol 1e-5: Adam's
first step moves each parameter by about lr times the sign of its
gradient, so rounding moves a parameter only where its gradient is near
zero. The attention key biases are that case everywhere: their true
gradient is exactly zero (softmax does not change when every key's score
in a row moves by the same q . b), so both sides step on rounding noise;
they are held to |step| <= lr."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsarec_tpu.preprec.train as jax_train
from bsarec_tpu.preprec.config import PrepRecConfig as JaxPrepRecConfig
from bsarec_tpu.preprec.config import PrepRecTrainConfig as JaxPrepRecTrainConfig
from bsarec_tpu.preprec.data import load_intwtime as jax_load_intwtime
from bsarec_tpu.preprec.models import NewRecModel as JaxNewRec
from bsarec_tpu.preprec.popularity import PopularityEncoding as JaxPopularityEncoding
from bsarec_tpu.preprec.torch_import import import_preprec_torch
from bsarec_tpu_torch.preprec import preprocess
from bsarec_tpu_torch.preprec.config import PrepRecConfig, PrepRecTrainConfig
from bsarec_tpu_torch.preprec.data import load_intwtime, load_userneg
from bsarec_tpu_torch.preprec.jax_import import newrec_from_jax
from bsarec_tpu_torch.preprec.models import NewRecModel, init_params
from bsarec_tpu_torch.preprec.popularity import PopularityEncoding
from bsarec_tpu_torch.preprec.sampler import draw_user_batches
from bsarec_tpu_torch.preprec.train import PrepRecTrainer, masked_pair_bce

RTOL, ATOL = 1e-5, 1e-6
LOSS_RTOL, PARAM_ATOL = 1e-6, 1e-5
B, L, H = 6, 12, 16
FEATS = dict(base_dim1=11, input_units1=33, base_dim2=6, input_units2=6)
BRANCHES = {
    "sinusoid": {},
    "fs_emb": {"fs_emb": True},
    "no_emb": {"no_emb": True},
    "no_fixed_emb": {"no_fixed_emb": True},
    "time_embed": {"time_embed": True},
    "time_no_fixed_embed": {"time_embed": True, "time_no_fixed_embed": True},
    "time_embed_concat": {"time_embed": True, "time_embed_concat": True},
    "all_learned_concat": {"time_embed": True, "time_no_fixed_embed": True,
                           "time_embed_concat": True, "no_fixed_emb": True, "fs_emb": True},
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test (restored after): at these sizes more
    threads gain nothing, and parallel test workers of eight threads each
    slow one another down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _logger():
    lg = logging.getLogger("preprec_port_test")
    lg.addHandler(logging.NullHandler())
    lg.propagate = False
    return lg


def _cfgs(blocks=2, **kw):
    fields = dict(maxlen=L, hidden_units=H, num_blocks=blocks, num_heads=2, dropout_rate=0.0,
                  **FEATS) | kw
    return JaxPrepRecConfig(**fields), PrepRecConfig(**fields)


def _inputs(seed, time_embed):
    rng = np.random.default_rng(seed)
    f = FEATS["input_units1"] + FEATS["input_units2"]
    seq = rng.integers(1, 40, (B, L))
    for r, n_pad in enumerate([0, 3, 7, 11, L, 1]):  # a fully padded row among them
        seq[r, :n_pad] = 0
    seq_feats = rng.random((B, L, f)).astype(np.float32) * (seq > 0)[..., None]
    pos = rng.random((B, L, f)).astype(np.float32)
    neg = rng.random((B, L, f)).astype(np.float32)
    cand = rng.random((B, 9, f)).astype(np.float32)
    te = rng.integers(0, L + 1, (B, L)) if time_embed else None
    return seq == 0, seq_feats, pos, neg, cand, te


def _jax_init(jcfg, pad, feats, te):
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)}
    return JaxNewRec(jcfg).init(rngs, feats, pad, feats, feats, te, train=False)["params"]


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_newrec_matches_jax(branch, direction):
    jcfg, cfg = _cfgs(**BRANCHES[branch])
    pad, feats, pos, neg, cand, te = _inputs(3, cfg.time_embed)
    model = NewRecModel(cfg).eval()
    if direction == "jax_to_port":
        params = _jax_init(jcfg, pad, feats, te)
        model.load_state_dict(newrec_from_jax(jax.device_get(params)), strict=True)
    else:
        init_params(model, torch.Generator().manual_seed(1))
        params = import_preprec_torch("newrec", model.state_dict(), cfg.num_blocks)
        # the JAX tree the port's weights land in has the JAX model's structure
        want_tree = jax.tree.structure(_jax_init(jcfg, pad, feats, te))
        assert jax.tree.structure(params) == want_tree
    jm, v = JaxNewRec(jcfg), {"params": params}
    t = {k: torch.from_numpy(a) for k, a in
         dict(pad=pad, feats=feats, pos=pos, neg=neg, cand=cand).items()}
    tte = None if te is None else torch.from_numpy(te)
    with torch.no_grad():
        _close(model.encode(t["feats"], t["pad"], tte),
               jm.apply(v, feats, pad, te, method="encode"))
        got = model(t["feats"], t["pad"], t["pos"], t["neg"], tte)
        want = jm.apply(v, feats, pad, pos, neg, te, train=False)
        for g, w in zip(got, want):
            _close(g, w)
        _close(model.predict(t["feats"], t["pad"], t["cand"], tte),
               jm.apply(v, feats, pad, cand, te, method="predict"))


def test_state_dict_is_the_reference_layout():
    """The port's keys are what `import_newrec` reads, and carrying weights
    there and back returns them bit for bit."""
    _, cfg = _cfgs(**BRANCHES["all_learned_concat"])
    model = NewRecModel(cfg)
    init_params(model, torch.Generator().manual_seed(2))
    sd = model.state_dict()
    assert "forward_layers.0.conv1.weight" in sd and sd["forward_layers.0.conv1.weight"].shape == (H, H, 1)
    assert not [k for k in sd if "table" in k]  # the fixed tables are not state
    back = newrec_from_jax(import_preprec_torch("newrec", sd, cfg.num_blocks))
    assert sorted(back) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)


def test_init_scheme(monkeypatch):
    """xavier-normal on >= 2-D parameters, module defaults on biases,
    embed_layer.fc1.bias zero (the JAX package's std on the same layer);
    BSAREC_PREPREC_INIT=torch: kaiming-uniform weights, N(0, 1) embeddings."""
    jcfg, cfg = _cfgs(hidden_units=64, no_fixed_emb=True, maxlen=200)
    model = NewRecModel(cfg)
    init_params(model, torch.Generator().manual_seed(0))
    w = model.embed_layer.fc1.weight  # [128, 39]
    want = np.sqrt(2.0 / (128 + 39))
    assert abs(w.std().item() - want) / want < 0.05
    feats = jnp.zeros((2, 200, 39))
    jp = _jax_init(jcfg, jnp.zeros((2, 200), bool), feats, None)
    jstd = float(np.asarray(jp["embed_layer"]["fc1"]["kernel"]).std())
    assert abs(w.std().item() - jstd) / jstd < 0.05
    assert (model.embed_layer.fc1.bias == 0).all()
    assert (model.embed_layer.fc2.bias != 0).all()
    assert model.embed_layer.fc2.bias.abs().max() <= 1 / np.sqrt(128)
    emb = model.pos_emb.weight  # [200, 64]
    assert abs(emb.std().item() - np.sqrt(2 / 264)) / np.sqrt(2 / 264) < 0.05
    conv = model.forward_layers[0].conv1.weight
    assert abs(conv.std().item() - np.sqrt(2 / 128)) / np.sqrt(2 / 128) < 0.1

    monkeypatch.setenv("BSAREC_PREPREC_INIT", "torch")
    init_params(model, torch.Generator().manual_seed(0))
    assert model.embed_layer.fc1.weight.abs().max() <= 1 / np.sqrt(39)
    assert abs(model.pos_emb.weight.std().item() - 1.0) < 0.05
    assert (model.embed_layer.fc1.bias == 0).all()


def test_masked_pair_bce_matches_jax():
    rng = np.random.default_rng(0)
    pos = (rng.normal(size=(8, 30)) * 12).astype(np.float32)  # past softplus's linear switch
    neg = (rng.normal(size=(8, 30)) * 12).astype(np.float32)
    valid = (rng.random((8, 30)) > 0.3).astype(np.float32)
    want = float(jax_train.masked_pair_bce(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(valid)))
    got = masked_pair_bce(torch.from_numpy(pos), torch.from_numpy(neg), torch.from_numpy(valid))
    np.testing.assert_allclose(got.item(), want, rtol=LOSS_RTOL)
    zero = masked_pair_bce(torch.from_numpy(pos), torch.from_numpy(neg), torch.zeros(8, 30))
    assert zero.item() == 0.0


@pytest.fixture(scope="module")
def domain(tmp_path_factory):
    root = tmp_path_factory.mktemp("preprec_port_model")
    prefix = str(root / "synth")
    rng = np.random.default_rng(0)
    n = 6000
    raw = (rng.integers(0, 50, n), rng.integers(0, 60, n),
           1_500_000_000 + rng.integers(0, 3600 * 24 * 366, n))
    stats = preprocess.preprocess(*raw, prefix, t1_cutoff=30.0, t2_cutoff=7.0)
    preprocess.eval_negatives(f"{prefix}_intwtime.csv", f"{prefix}_userneg.pickle", n=20, seed=0)
    user_feat = np.random.default_rng(1).normal(size=(5, stats["n_users"]))
    return prefix, stats, user_feat


def _trainers(domain, tmp_path, monkeypatch, neg, **kw):
    """The JAX trainer with `neg` as its negatives and the port's trainer
    on the JAX trainer's initial weights."""
    prefix, stats, user_feat = domain
    monkeypatch.setattr(jax_train, "positional_negatives",
                        lambda key, rows, pos, itemnum: jnp.asarray(neg, jnp.int32))
    jds = jax_load_intwtime(f"{prefix}_intwtime.csv", L)
    ds = load_intwtime(f"{prefix}_intwtime.csv", L)
    negs = load_userneg(f"{prefix}_userneg.pickle", ds.usernum)
    jcfg, cfg = _cfgs(blocks=1, usernum=ds.usernum, itemnum=ds.itemnum, **kw)
    jpop = JaxPopularityEncoding.load(f"{prefix}_wtembed.txt", f"{prefix}_week_embed2.txt", jcfg)
    pop = PopularityEncoding.load(f"{prefix}_wtembed.txt", f"{prefix}_week_embed2.txt", cfg)
    jtr = jax_train.PrepRecTrainer(jcfg, JaxPrepRecTrainConfig(batch_size=16, seed=1), jds,
                                   _logger(), str(tmp_path / "jax"), pop_enc=jpop,
                                   usernegs=negs, user_feat=user_feat)
    tr = PrepRecTrainer(cfg, PrepRecTrainConfig(batch_size=16, seed=1, device="cpu"), ds,
                        _logger(), str(tmp_path / "port"), pop_enc=pop, usernegs=negs,
                        user_feat=user_feat)
    tr.model.load_state_dict(newrec_from_jax(jax.device_get(jtr.params)))
    return jtr, tr


def _batch(domain, seed=7):
    prefix, stats, _ = domain
    ds = load_intwtime(f"{prefix}_intwtime.csv", L)
    users = draw_user_batches(np.random.default_rng(seed), ds.eligible_users, 1, 16)
    pos = ds.train_seq[users[0] - 1][:, 1:]
    rng = np.random.default_rng(seed + 1)
    neg = np.where(pos != 0, rng.integers(1, ds.itemnum + 1, pos.shape), 0)
    return users, neg


def _jax_step(jtr, users):
    jtr.params, jtr.opt_state, loss = jtr._epoch_fn(
        jtr.params, jtr.opt_state, jax.random.PRNGKey(0), jnp.asarray(users))
    return float(loss)


@pytest.mark.parametrize("kw", [{}, {"cos_loss": True, "reg_num": 4},
                                {"prev_time": True, "lag": 5}, {"time_embed": True}],
                         ids=["bce", "cos_loss", "prev_time_lag5", "time_embed"])
def test_one_adam_step_matches_jax(domain, tmp_path, monkeypatch, kw):
    users, neg = _batch(domain)
    jtr, tr = _trainers(domain, tmp_path, monkeypatch, neg, **kw)
    tr.model.train()
    loss = tr.step(torch.from_numpy(users[0].astype(np.int64)), torch.from_numpy(neg)).item()
    want_loss = _jax_step(jtr, users)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    want = newrec_from_jax(jax.device_get(jtr.params))
    got = tr.model.state_dict()
    lr = tr.tcfg.lr
    for k, w in want.items():
        if ".K_w.bias" in k:
            assert (got[k] - w).abs().max() <= 2 * lr * (1 + 1e-3), k
        else:
            torch.testing.assert_close(got[k], w, rtol=0, atol=PARAM_ATOL, msg=k)


def test_regularisers_match_jax_loss(domain, tmp_path, monkeypatch):
    """The regularisers alone (only_reg): the JAX loss of a step and the
    port's on the same users and weights."""
    users, neg = _batch(domain, seed=11)
    kw = {"triplet_loss": True, "cos_loss": True, "reg_num": 5, "reg_coef": 0.7, "only_reg": True}
    jtr, tr = _trainers(domain, tmp_path, monkeypatch, neg, **kw)
    tr.model.train()
    got = tr.newrec_loss(torch.from_numpy(users[0].astype(np.int64)), torch.from_numpy(neg))
    np.testing.assert_allclose(got.item(), _jax_step(jtr, users), rtol=LOSS_RTOL)
    assert got.item() > 0


def test_triplet_step_stays_finite_where_jax_gives_nan(domain, tmp_path, monkeypatch):
    """A deliberate divergence: each user is its own nearest in-batch user,
    so the triplet term takes the norm of a zero vector. The JAX package's
    `jnp.linalg.norm` has a NaN gradient there and its step turns every
    parameter into NaN; the port's `torch.linalg.vector_norm` (the
    reference's torch norm) takes the subgradient 0. The loss before the
    step is the same on both sides."""
    users, neg = _batch(domain, seed=5)
    jtr, tr = _trainers(domain, tmp_path, monkeypatch, neg, triplet_loss=True, reg_num=4)
    tr.model.train()
    loss = tr.step(torch.from_numpy(users[0].astype(np.int64)), torch.from_numpy(neg)).item()
    np.testing.assert_allclose(loss, _jax_step(jtr, users), rtol=LOSS_RTOL)
    assert np.isnan(np.asarray(jtr.params["embed_layer"]["fc1"]["kernel"])).all()
    assert all(torch.isfinite(v).all() for v in tr.model.state_dict().values())


def test_quirk186_toggle_matches_jax(domain, tmp_path, monkeypatch):
    """BSAREC_PREPREC_QUIRK186=1 gathers the positives' and negatives'
    week popularity with month periods, in both packages: the port's loss
    equals JAX's under the toggle and differs from its own without it;
    the default path is deterministic under a fixed seed."""
    users, neg = _batch(domain, seed=3)
    _, tr = _trainers(domain, tmp_path, monkeypatch, neg)
    tr.model.train()
    u, n = torch.from_numpy(users[0].astype(np.int64)), torch.from_numpy(neg)
    base = tr.newrec_loss(u, n).item()
    assert tr.newrec_loss(u, n).item() == base
    monkeypatch.setenv("BSAREC_PREPREC_QUIRK186", "1")
    jtr, tr = _trainers(domain, tmp_path, monkeypatch, neg)
    tr.model.train()
    quirk = tr.newrec_loss(u, n).item()
    assert np.isfinite(quirk) and quirk != base
    np.testing.assert_allclose(quirk, _jax_step(jtr, users), rtol=LOSS_RTOL)


def test_train_epoch_is_seeded(domain, tmp_path, monkeypatch):
    """Two trainers with one seed give the same epoch loss (dropout on);
    the epoch draws the JAX package's users for that seed."""
    prefix, _, _ = domain
    ds = load_intwtime(f"{prefix}_intwtime.csv", L)
    pop = PopularityEncoding.load(f"{prefix}_wtembed.txt", f"{prefix}_week_embed2.txt", _cfgs()[1])
    _, cfg = _cfgs(blocks=1, usernum=ds.usernum, itemnum=ds.itemnum, dropout_rate=0.1)
    tcfg = PrepRecTrainConfig(batch_size=16, seed=7, device="cpu")
    losses = []
    for tag in ("a", "b"):
        tr = PrepRecTrainer(cfg, tcfg, ds, _logger(), str(tmp_path / tag), pop_enc=pop)
        losses.append(tr.train_epoch())
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    assert tr.num_batch == ds.usernum // 16
    rng = np.random.default_rng(7)
    want = jax_train.draw_user_batches(rng, ds.eligible_users, tr.num_batch, 16)
    np.testing.assert_array_equal(draw_user_batches(np.random.default_rng(7), ds.eligible_users,
                                                    tr.num_batch, 16), want)

"""The other five PREPRec models in the port against the JAX package:
SASRecB, BERT4RecB, NewB4Rec (fixed and learned positions), BPRMF and
CL4SRec. Their encode, forward and predict with weights carried both
ways, the key layout, the init, the samplers by law, CL4SRec's host
views bit for bit, and each loss branch with one Adam step on the same
draws. The shared pieces (`domain`, `jax_init`, `trainer_pair`) serve the
other `test_torch_port_preprec_*` files.

Tolerances: model outputs at fp32 with dropout off within rtol 1e-5 and
within 1e-6 of the output's largest magnitude for entries near zero (a
logit is a sum that cancels): the same arithmetic with sums in another
order. The loss of a step within rtol 1e-5 (BPRMF's is a sum over a
batch, the rest means). After one Adam step (lr 1e-3, wd 1e-5)
parameters within atol 1e-5: Adam's first step moves a parameter by
about lr times the sign of its gradient, so rounding moves it only where
its gradient is near zero. The attention key biases are that case
everywhere (their true gradient is exactly zero: softmax does not change
when every key's score in a row moves by q . b), so both sides step on
rounding noise; they are held to |step| <= lr."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bsarec_tpu.preprec.sampler as jax_sampler
import bsarec_tpu.preprec.train as jax_train
from bsarec_tpu.preprec.config import PrepRecConfig as JaxPrepRecConfig
from bsarec_tpu.preprec.config import PrepRecTrainConfig as JaxPrepRecTrainConfig
from bsarec_tpu.preprec.data import load_intwtime as jax_load_intwtime
from bsarec_tpu.preprec.models import PREPREC_REGISTRY as JAX_REGISTRY
from bsarec_tpu.preprec.popularity import PopularityEncoding as JaxPopularityEncoding
from bsarec_tpu.preprec.torch_import import import_preprec_torch
from bsarec_tpu_torch.preprec import preprocess, sampler
from bsarec_tpu_torch.preprec.config import PrepRecConfig, PrepRecTrainConfig
from bsarec_tpu_torch.preprec.data import load_intwtime, load_userneg
from bsarec_tpu_torch.preprec.jax_import import preprec_from_jax
from bsarec_tpu_torch.preprec.models import PREPREC_REGISTRY, init_params
from bsarec_tpu_torch.preprec.popularity import PopularityEncoding
from bsarec_tpu_torch.preprec.train import PrepRecTrainer, newb4rec_ce

RTOL, ATOL = 1e-5, 1e-6
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
B, L, H = 6, 12, 16
USERS, ITEMS = 60, 50
FEATS = dict(base_dim1=11, input_units1=33, base_dim2=6, input_units2=6)
# model name -> config fields of each case
CASES = {
    "sasrec": {}, "cl4srec": {}, "bert4rec": {}, "bprmf": {},
    "newb4rec": {}, "newb4rec_learned_pos": {"no_fixed_emb": True},
}
KEY_BIASES = (".K_w.bias", ".linear_layers.1.bias")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread per test (restored after): at these sizes more
    threads gain nothing, and parallel test workers of eight threads each
    slow one another down."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def quiet_logger(name="preprec_port_zoo_test"):
    lg = logging.getLogger(name)
    lg.addHandler(logging.NullHandler())
    lg.propagate = False
    return lg


def model_name(case: str) -> str:
    return case.split("_")[0]


def cfg_pair(model: str, blocks=2, **kw):
    fields = dict(model=model, usernum=USERS, itemnum=ITEMS, maxlen=L, hidden_units=H,
                  num_blocks=blocks, num_heads=2, dropout_rate=0.0, **FEATS) | kw
    return JaxPrepRecConfig(**fields), PrepRecConfig(**fields)


def jax_init(jcfg):
    """The JAX model's params as its trainer draws them (its `_init_params`)."""
    return jax_train.PrepRecTrainer._init_params(type("T", (), {
        "cfg": jcfg, "model": JAX_REGISTRY[jcfg.model](jcfg)})())


def model_inputs(seed, usernum=USERS, itemnum=ITEMS):
    rng = np.random.default_rng(seed)
    f = FEATS["input_units1"] + FEATS["input_units2"]
    seq = rng.integers(1, itemnum + 1, (B, L))
    for r, n_pad in enumerate([0, 3, 7, 11, L, 1]):  # a fully padded row among them
        seq[r, :n_pad] = 0
    seq[0, 5] = 0  # a masked position inside a history
    return dict(
        seq=seq, seq2=np.where(seq > 0, rng.integers(1, itemnum + 1, (B, L)), 0),
        pos=rng.integers(0, itemnum + 1, (B, L)), neg=rng.integers(0, itemnum + 1, (B, L)),
        cand=rng.integers(1, itemnum + 1, (B, 9)), users=rng.integers(1, usernum + 1, B),
        feats=rng.random((B, L, f)).astype(np.float32) * (seq > 0)[..., None],
        cand_feats=rng.random((B, 9, f)).astype(np.float32),
        seq_cand_feats=rng.random((B, L, 4, f)).astype(np.float32))


def outputs(name, module, x, jax_apply):
    """[(port output, JAX output)] of the model's encode, forward and
    predict on the inputs `x`; `module` is the port's model."""
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    seq, pos, neg, cand, users = (x[k] for k in ("seq", "pos", "neg", "cand", "users"))
    with torch.no_grad():
        if name in ("sasrec", "cl4srec"):
            pairs = [(module.encode(t["seq"]), jax_apply(seq, method="encode")),
                     (module.predict(t["seq"], t["cand"]), jax_apply(seq, cand, method="predict"))]
            if name == "sasrec":
                got, want = module(t["seq"], t["pos"], t["neg"]), jax_apply(seq, pos, neg, train=False)
            else:
                got = module(t["seq"], t["seq2"], torch.flip(t["seq"], [0]), t["pos"], t["neg"])
                want = jax_apply(seq, x["seq2"], seq[::-1], pos, neg, train=False)
            return pairs + list(zip(got, want))
        if name == "bert4rec":
            return [(module.encode(t["seq"]), jax_apply(seq, method="encode")),
                    (module(t["seq"]), jax_apply(seq, train=False)),
                    (module.predict(t["seq"], t["cand"]), jax_apply(seq, cand, method="predict"))]
        if name == "newb4rec":
            valid, f = seq > 0, x["feats"]
            return [(module.encode(t["feats"], t["seq"] > 0), jax_apply(f, valid, method="encode")),
                    (module(t["feats"], t["seq"] > 0, t["seq_cand_feats"]),
                     jax_apply(f, valid, x["seq_cand_feats"], train=False)),
                    (module.predict(t["feats"], t["seq"] > 0, t["cand_feats"]),
                     jax_apply(f, valid, x["cand_feats"], method="predict"))]
        got = module(t["users"], t["pos"], t["neg"])
        want = jax_apply(users, pos, neg, train=False)
        return list(zip(got, want)) + [(module.predict(t["users"], t["cand"]),
                                        jax_apply(users, cand, method="predict"))]


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_jax(case, direction):
    name = model_name(case)
    jcfg, cfg = cfg_pair(name, **CASES[case])
    model = PREPREC_REGISTRY[name](cfg).eval()
    if direction == "jax_to_port":
        params = jax_init(jcfg)
        model.load_state_dict(preprec_from_jax(name, jax.device_get(params)), strict=True)
    else:
        init_params(model, torch.Generator().manual_seed(1))
        params = import_preprec_torch(name, model.state_dict(), cfg.num_blocks)
        # the JAX tree the port's weights land in has the JAX model's structure
        assert jax.tree.structure(params) == jax.tree.structure(jax_init(jcfg))
    jm = JAX_REGISTRY[name](jcfg)

    def jax_apply(*a, **kw):
        return jm.apply({"params": params}, *a, **kw)

    for got, want in outputs(name, model, model_inputs(3), jax_apply):
        close(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_state_dict_layout_round_trips(case):
    """The port's keys are what `import_preprec_torch` reads, there and
    back bit for bit; the fixed position table is no state."""
    name = model_name(case)
    _, cfg = cfg_pair(name, **CASES[case])
    model = PREPREC_REGISTRY[name](cfg)
    init_params(model, torch.Generator().manual_seed(2))
    sd = model.state_dict()
    assert not [k for k in sd if "table" in k]
    back = preprec_from_jax(name, import_preprec_torch(name, sd, cfg.num_blocks))
    assert sorted(back) == sorted(sd)
    for k in sd:
        torch.testing.assert_close(back[k], sd[k], rtol=0, atol=0)
    if name in ("bert4rec", "newb4rec"):
        assert "attention_layers.1.linear_layers.2.weight" in sd and "out.weight" in sd
        assert "forward_layers.0.w_1.weight" in sd and "attention_layers.0.output_linear.bias" in sd


def test_init_zero_pads_the_item_tables(monkeypatch):
    """Row 0 of the padded item tables is zero under both schemes, the
    rest is xavier-normal (or N(0, 1) under BSAREC_PREPREC_INIT=torch);
    BPRMF's tables keep row 0; NewB4Rec keeps its fc1 bias (only NewRec's
    is zeroed), as the JAX package's init does."""
    for scheme, std in (("xavier", np.sqrt(2 / (ITEMS + 1 + 64))), ("torch", 1.0)):
        monkeypatch.setenv("BSAREC_PREPREC_INIT", scheme)
        for name in ("sasrec", "bert4rec", "cl4srec"):
            jcfg, cfg = cfg_pair(name, hidden_units=64)
            model = PREPREC_REGISTRY[name](cfg)
            init_params(model, torch.Generator().manual_seed(0))
            w = model.item_emb.weight
            assert (w[0] == 0).all() and (w[1:] != 0).all()
            assert abs(w[1:].std().item() - std) / std < 0.1
            jw = np.asarray(jax_init(jcfg)["item_emb"]["embedding"])
            assert (jw[0] == 0).all() and abs(jw[1:].std() - std) / std < 0.1
        _, cfg = cfg_pair("bprmf", hidden_units=64)
        bpr = PREPREC_REGISTRY["bprmf"](cfg)
        init_params(bpr, torch.Generator().manual_seed(0))
        assert (bpr.item_emb.weight[0] != 0).all() and (bpr.user_emb.weight[0] != 0).all()
    _, cfg = cfg_pair("newb4rec")
    nb = PREPREC_REGISTRY["newb4rec"](cfg)
    init_params(nb, torch.Generator().manual_seed(0))
    assert (nb.embed_layer.fc1.bias != 0).all()


def test_newb4rec_adds_its_fixed_positions():
    """NewB4Rec adds the sinusoid table to the embedded sequence (the
    JAX package's divergence from the reference's overwrite): moving the
    features moves the encoding, and the encoding equals the blocks over
    embed + table."""
    _, cfg = cfg_pair("newb4rec")
    model = PREPREC_REGISTRY["newb4rec"](cfg).eval()
    init_params(model, torch.Generator().manual_seed(4))
    x = model_inputs(5)
    f, valid = torch.from_numpy(x["feats"]), torch.from_numpy(x["seq"] > 0)
    with torch.no_grad():
        got = model.encode(f, valid)
        seqs = model.embed_layer(f) + model.position_table[None, :L]
        from bsarec_tpu_torch.preprec.models import tanh_gelu
        torch.testing.assert_close(got, tanh_gelu(model.blocks(seqs, valid)), rtol=0, atol=0)
        assert not torch.allclose(model.encode(f * 2, valid), got)


# ---- samplers ---------------------------------------------------------------

def test_cloze_mask_law():
    """Padding is never masked; labels carry the token where selected and
    0 elsewhere; selected positions carry 0 (about 80%), a random item
    (10%) or the token (10%); the selection rate is mask_prob; at
    mask_prob 0 nothing is selected."""
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(1, ITEMS + 1, (400, 50), generator=gen)
    tokens[:, :10] = 0
    masked, labels = sampler.cloze_mask(gen, tokens, ITEMS, 0.2)
    real = tokens > 0
    selected = labels != 0
    assert not selected[~real].any() and (masked[~real] == 0).all()
    assert (labels[selected] == tokens[selected]).all()
    assert (masked[~selected] == tokens[~selected]).all()
    rate = selected.sum().item() / real.sum().item()
    assert abs(rate - 0.2) < 0.01
    m = masked[selected]
    zero = (m == 0).float().mean().item()
    assert abs(zero - 0.8) < 0.02
    assert ((m >= 0) & (m <= ITEMS)).all()
    none_m, none_l = sampler.cloze_mask(gen, tokens, ITEMS, 0.0)
    assert (none_l == 0).all() and (none_m == tokens).all()


def test_newb4rec_candidates_gold_column_is_the_masked_token():
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(1, ITEMS + 1, (8, L), generator=gen)
    masked, labels = sampler.cloze_mask(gen, tokens, ITEMS, 0.5)
    cands = sampler.newb4rec_candidates(gen, masked, ITEMS, 7)
    assert cands.shape == (8, L, 8)
    assert (cands[..., -1] == masked).all()
    assert ((cands[..., :-1] >= 1) & (cands[..., :-1] <= ITEMS)).all()
    # where the mask token went in, the gold column holds 0, not the label
    sel = (labels != 0) & (masked == 0)
    assert sel.any() and (cands[..., -1][sel] == 0).all() and (labels[sel] != 0).all()


def test_permute_user_items_is_a_permutation_of_each_row():
    gen = torch.Generator().manual_seed(2)
    rows = torch.randint(1, ITEMS + 1, (50, L + 1), generator=gen)
    for r in range(50):
        rows[r, : r % (L + 2)] = 0
    out = sampler.permute_user_items(gen, rows)
    n = (rows > 0).sum(1)
    for r in range(50):
        assert (out[r, n[r]:] == 0).all() and (out[r, : n[r]] > 0).all()
        assert sorted(out[r].tolist()) == sorted(rows[r].tolist())
    assert not (out == rows).all()


def test_augment_batch_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    seqs = rng.integers(0, ITEMS + 1, (40, L)).astype(np.int32)
    lens = rng.integers(0, L + 1, 40)
    for i, n in enumerate(lens):
        seqs[i, : L - n] = 0
    got = sampler.augment_batch(np.random.default_rng(9), seqs, lens)
    want = jax_sampler.augment_batch(np.random.default_rng(9), seqs, lens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not (got[0] == seqs).all() and not (got[1] == got[0]).all()
    for op in ("_crop_row", "_mask_row", "_reorder_row"):
        for i in range(10):
            g = getattr(sampler, op)(np.random.default_rng(i), seqs[i], int(lens[i]), L)
            w = getattr(jax_sampler, op)(np.random.default_rng(i), seqs[i], int(lens[i]), L)
            np.testing.assert_array_equal(g, w)


# ---- the trainers -----------------------------------------------------------

def build_domain(root, n_users=USERS, n_items=ITEMS, seed=0, n=6000):
    prefix = str(root / "synth")
    rng = np.random.default_rng(seed)
    raw = (rng.integers(0, n_items, n), rng.integers(0, n_users, n),
           1_500_000_000 + rng.integers(0, 3600 * 24 * 366, n))
    stats = preprocess.preprocess(*raw, prefix, t1_cutoff=30.0, t2_cutoff=7.0)
    preprocess.eval_negatives(f"{prefix}_intwtime.csv", f"{prefix}_userneg.pickle", n=20, seed=0)
    return prefix, stats


@pytest.fixture(scope="module")
def domain(tmp_path_factory):
    return build_domain(tmp_path_factory.mktemp("preprec_port_zoo"))


def trainer_pair(prefix, root, name, eval_method=1, blocks=1, tc=None, **kw):
    """The JAX trainer and the port's on the JAX trainer's initial weights."""
    jds = jax_load_intwtime(f"{prefix}_intwtime.csv", L)
    ds = load_intwtime(f"{prefix}_intwtime.csv", L)
    negs = load_userneg(f"{prefix}_userneg.pickle", ds.usernum) if eval_method == 1 else None
    jcfg, cfg = cfg_pair(name, blocks=blocks, usernum=ds.usernum, itemnum=ds.itemnum,
                         eval_method=eval_method, **kw)
    jpop = pop = None
    if name in ("newrec", "newb4rec"):
        month, week = f"{prefix}_wtembed.txt", f"{prefix}_week_embed2.txt"
        jpop, pop = JaxPopularityEncoding.load(month, week, jcfg), PopularityEncoding.load(month, week, cfg)
    tc = dict(batch_size=16, seed=1) | (tc or {})
    jtr = jax_train.PrepRecTrainer(jcfg, JaxPrepRecTrainConfig(**tc), jds, quiet_logger(),
                                   str(root / "jax"), jpop, None, negs)
    tr = PrepRecTrainer(cfg, PrepRecTrainConfig(**tc, device="cpu"), ds, quiet_logger(),
                        str(root / "port"), pop, None, negs)
    tr.model.load_state_dict(preprec_from_jax(name, jax.device_get(jtr.params)))
    return jtr, tr


def step_draws(tr, users, seed):
    """The random draws of one step of `tr`'s branch, made by the port's
    samplers on a generator of `seed`: {name: tensor}."""
    gen = torch.Generator().manual_seed(seed)
    rows = tr._dev["train_seq"][users - 1]
    itemnum, name = tr.ds.itemnum, tr.cfg.model
    if name in ("bert4rec", "newb4rec"):
        masked, labels = sampler.cloze_mask(gen, rows[:, 1:], itemnum, tr.cfg.mask_prob)
        draws = {"masked": masked, "labels": labels}
        if name == "newb4rec":
            compare = max(itemnum // tr.cfg.loss_size, 1)
            draws["cands"] = sampler.newb4rec_candidates(gen, masked, itemnum, compare)
        return draws
    if name == "bprmf":
        pos = sampler.permute_user_items(gen, rows)
        return {"pos": pos, "neg": sampler.positional_negatives(gen, rows, pos, itemnum)}
    draws = {"neg": sampler.positional_negatives(gen, rows, rows[:, 1:], itemnum)}
    if name == "cl4srec":
        seq = rows[:, :-1].numpy()
        lens = tr.ds.seq_lens[users.numpy() - 1] - 1
        a1, a2 = sampler.augment_batch(np.random.default_rng(seed), seq, np.maximum(lens, 0))
        draws |= {"aug1": torch.from_numpy(a1.astype(np.int64)),
                  "aug2": torch.from_numpy(a2.astype(np.int64))}
    return draws


def patch_jax_draws(monkeypatch, draws):
    """The JAX trainer's samplers return `draws` (numpy) instead of drawing."""
    d = {k: jnp.asarray(v.numpy(), jnp.int32) for k, v in draws.items()}
    monkeypatch.setattr(jax_train, "positional_negatives", lambda *a: d["neg"])
    monkeypatch.setattr(jax_train, "cloze_mask", lambda *a: (d["masked"], d["labels"]))
    monkeypatch.setattr(jax_train, "newb4rec_candidates", lambda *a: d["cands"])
    monkeypatch.setattr(jax_train, "permute_user_items", lambda *a: d["pos"])
    return d


def jax_step(jtr, users, d):
    """One step of the JAX trainer's jitted epoch on `users` [B]."""
    args = (jtr.params, jtr.opt_state, jax.random.PRNGKey(0), jnp.asarray(users[None]))
    if jtr.cfg.model == "cl4srec":
        args += (d["aug1"][None], d["aug2"][None])
    jtr.params, jtr.opt_state, loss = jtr._epoch_fn(*args)
    return float(loss)


STEP_CASES = {
    "sasrec": {}, "sasrec_l2_emb": {}, "bert4rec": {"mask_prob": 0.3},
    "newb4rec": {"mask_prob": 0.3, "loss_size": 7},
    "newb4rec_learned_pos": {"mask_prob": 0.3, "loss_size": 7, "no_fixed_emb": True},
    "bprmf": {}, "cl4srec": {"aug_coef": 0.5},
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_one_adam_step_matches_jax(domain, tmp_path, monkeypatch, case):
    """Each loss branch on the same users and draws: the loss, then the
    parameters after one Adam step. Covers NewB4Rec's time-axis
    log-softmax, BPRMF's sum, the l2_emb Frobenius norm and the CL4SRec
    InfoNCE."""
    prefix, _ = domain
    name = model_name(case)
    tc = {"l2_emb": 0.3} if case == "sasrec_l2_emb" else None
    ds = load_intwtime(f"{prefix}_intwtime.csv", L)
    users = jax_sampler.draw_user_batches(np.random.default_rng(7), ds.eligible_users, 1, 16)[0]
    jtr, tr = trainer_pair(prefix, tmp_path, name, tc=tc, **STEP_CASES[case])
    u = torch.from_numpy(users.astype(np.int64))
    draws = step_draws(tr, u, seed=11)
    d = patch_jax_draws(monkeypatch, draws)
    tr.model.train()
    loss = tr.step(u, **draws).item()
    want_loss = jax_step(jtr, users, d)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    assert loss > 0
    want = preprec_from_jax(name, jax.device_get(jtr.params))
    got = tr.model.state_dict()
    assert sorted(got) == sorted(want)
    lr = tr.tcfg.lr
    for k, w in want.items():
        if k.endswith(KEY_BIASES):
            assert (got[k] - w).abs().max() <= 2 * lr * (1 + 1e-3), k
        else:
            torch.testing.assert_close(got[k], w, rtol=0, atol=PARAM_ATOL, msg=k)


@pytest.mark.parametrize("name", ["bert4rec", "newb4rec"])
def test_mask_prob_zero_gives_a_zero_loss(domain, tmp_path, monkeypatch, name):
    """At mask_prob 0 (the CLI's default) nothing is masked, so the loss
    is exactly 0 in both packages and these models never train."""
    prefix, _ = domain
    ds = load_intwtime(f"{prefix}_intwtime.csv", L)
    users = jax_sampler.draw_user_batches(np.random.default_rng(3), ds.eligible_users, 1, 16)[0]
    jtr, tr = trainer_pair(prefix, tmp_path, name, mask_prob=0.0, loss_size=7)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    assert tr.loss(torch.from_numpy(users.astype(np.int64))).item() == 0.0
    loss = tr.step(torch.from_numpy(users.astype(np.int64)))
    assert loss.item() == 0.0
    assert jax_step(jtr, users, {}) == 0.0
    # Adam still applies the weight decay: the parameters move by it alone
    assert any(not torch.equal(before[k], v) for k, v in tr.model.state_dict().items())


def test_newb4rec_ce_takes_the_time_axis_log_softmax():
    """The pinned loss: a log-softmax over dim 1 (time) of [B, T, C], then
    the CE over candidates with the last column as target. It differs
    from the plain CE over candidates, and equals the JAX trainer's
    expression."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, L, 6)).astype(np.float32) * 3
    labels = rng.integers(0, 3, (4, L))
    got = newb4rec_ce(torch.from_numpy(logits), torch.from_numpy(labels)).item()
    x = logits - jax.nn.logsumexp(logits, axis=1, keepdims=True)
    valid = (labels != 0).astype(np.float32)
    want = float(np.sum((jax.nn.logsumexp(x, axis=-1) - x[..., -1]) * valid) / valid.sum())
    np.testing.assert_allclose(got, want, rtol=1e-6)
    plain = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits)[labels != 0], torch.full((int(valid.sum()),), 5)).item()
    assert abs(got - plain) > 1e-3


def test_cl4srec_epoch_users_and_views_equal_jax(domain, tmp_path, monkeypatch):
    """The epoch's users and both augmented views are bit-equal to the
    ones the JAX trainer hands its epoch for the same seed (two epochs:
    the generator's order carries across)."""
    prefix, _ = domain
    jtr, tr = trainer_pair(prefix, tmp_path, "cl4srec", tc={"fs_prop": 0.5})
    seen = []

    def capture(params, opt_state, key, users, a1, a2):
        seen.append((np.asarray(users), np.asarray(a1), np.asarray(a2)))
        return params, opt_state, jnp.float32(0.0)

    jtr._epoch_fn = capture
    for _ in range(2):
        jtr.train_epoch()
        users, (a1, a2) = tr.epoch_batches()
        w_users, w1, w2 = seen[-1]
        assert users.shape == (max(int(tr.num_batch * 0.5), 1), 16)
        np.testing.assert_array_equal(users, w_users)
        np.testing.assert_array_equal(a1, w1)
        np.testing.assert_array_equal(a2, w2)
    assert (a1 != tr.ds.train_seq[users - 1][:, :, :-1]).any()


@pytest.mark.parametrize("name", ["sasrec", "bert4rec", "bprmf", "cl4srec"])
def test_train_epoch_is_seeded_and_finite(domain, tmp_path, name):
    """Two trainers of one seed give the same epoch loss with dropout on."""
    prefix, _ = domain
    ds = load_intwtime(f"{prefix}_intwtime.csv", L)
    _, cfg = cfg_pair(name, blocks=1, usernum=ds.usernum, itemnum=ds.itemnum, dropout_rate=0.1,
                      mask_prob=0.2)
    losses = []
    for tag in ("a", "b"):
        tr = PrepRecTrainer(cfg, PrepRecTrainConfig(batch_size=16, seed=7, device="cpu"), ds,
                            quiet_logger(), str(tmp_path / tag))
        losses.append(tr.train_epoch())
    assert np.isfinite(losses[0]) and losses[0] == losses[1] and losses[0] > 0

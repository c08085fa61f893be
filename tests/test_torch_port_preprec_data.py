"""PREPRec's data side in the port against the JAX package: the
preprocessing artifacts byte for byte, the loaders, the popularity
tables, the user-batch and negative samplers, the eval inputs and the
metrics, on a synthetic domain made with numpy from a seed.

Tolerances: every comparison here is exact (the same numpy arithmetic,
or a gather that copies values), but for the negative sampler, whose
draws come from different generators: there the two are held to the
same law (range, zeros at padded positions, the collisions a fixed six
rounds of redraws leave)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsarec_tpu.preprec import data as jax_data
from bsarec_tpu.preprec import evaluate as jax_eval
from bsarec_tpu.preprec import popularity as jax_pop
from bsarec_tpu.preprec import preprocess as jax_pre
from bsarec_tpu.preprec import sampler as jax_sampler
from bsarec_tpu.preprec.config import PrepRecConfig as JaxPrepRecConfig
from bsarec_tpu_torch.preprec import data, evaluate, popularity, preprocess, sampler
from bsarec_tpu_torch.preprec.config import PrepRecConfig

ARTIFACTS = ("intwtime.csv", "int2.csv", "rawpop.txt", "wtembed.txt", "week_embed2.txt",
             "week_curr_raw.txt", "userneg.pickle", "week_wt_embed_adj.txt")
MAXLEN = 12


def raw_interactions(seed=0, n=6000, n_users=60, n_items=50):
    rng = np.random.default_rng(seed)
    users = rng.integers(0, n_users, n)
    items = rng.integers(0, n_items, n)
    times = 1_500_000_000 + rng.integers(0, 3600 * 24 * 366, n)  # about a year
    return items, users, times


def build(pre, prefix, raw):
    stats = pre.preprocess(*raw, prefix, t1_cutoff=30.0, t2_cutoff=7.0)
    pre.eval_negatives(f"{prefix}_intwtime.csv", f"{prefix}_userneg.pickle", n=20, seed=0)
    pre.week_adjustment(f"{prefix}_intwtime.csv", f"{prefix}_userneg.pickle",
                        f"{prefix}_week_curr_raw.txt", f"{prefix}_week_wt_embed_adj.txt")
    # a sparse partition of the same rows, under the reference's file name
    with open(f"{prefix}_intwtime.csv") as src, open(f"{prefix}_sparse_intwtime.csv", "w") as dst:
        dst.write(src.read())
    return stats


@pytest.fixture(scope="module")
def domains(tmp_path_factory):
    """The same raw interactions through both packages' preprocessing."""
    root = tmp_path_factory.mktemp("preprec_port_data")
    raw = raw_interactions()
    (root / "jax").mkdir()
    (root / "port").mkdir()
    jprefix, pprefix = str(root / "jax" / "synth"), str(root / "port" / "synth")
    return jprefix, pprefix, build(jax_pre, jprefix, raw), build(preprocess, pprefix, raw)


@pytest.mark.parametrize("suffix", ARTIFACTS)
def test_artifacts_byte_equal(domains, suffix):
    jprefix, pprefix, jstats, pstats = domains
    assert jstats == pstats
    with open(f"{jprefix}_{suffix}", "rb") as a, open(f"{pprefix}_{suffix}", "rb") as b:
        assert a.read() == b.read()


def test_eval_negatives_exclude_owned_and_draw_with_replacement_when_short(tmp_path):
    """A user owning all but 3 items still gets n negatives (drawn with
    replacement), as in the JAX package; nobody gets an owned item."""
    rows = [(0, i, 0, 0, i) for i in range(47)] + [(1, i, 0, 0, 100 + i) for i in range(0, 50, 7)]
    path = tmp_path / "x_intwtime.csv"
    np.savetxt(path, np.asarray(rows), fmt="%d", delimiter=",")
    want = jax_pre.eval_negatives(str(path), str(tmp_path / "j.pickle"), n=20, seed=3)
    got = preprocess.eval_negatives(str(path), str(tmp_path / "p.pickle"), n=20, seed=3)
    assert got == want
    assert set(np.asarray(got[1]).tolist()) <= {48, 49, 50}
    assert not set(np.asarray(got[2]).tolist()) & set(range(1, 51, 7))
    assert (tmp_path / "j.pickle").read_bytes() == (tmp_path / "p.pickle").read_bytes()


@pytest.mark.parametrize("fn,args", [
    ("kcore_filter", lambda r: (r.integers(0, 50, 2000), r.integers(0, 40, 2000), 5)),
    ("contiguous_map", lambda r: (r.integers(-5, 1000, 300),)),
    ("pop_embed_vec", lambda r: (np.concatenate([[0.0, 10.0, 25.0, 100.0], r.random(50) * 100]), 5)),
    ("time_buckets", lambda r: (1_500_000_000 + r.integers(0, 3600 * 24 * 800, 200), 7.0)),
    ("windowed_popularity", lambda r: (r.integers(0, 30, 400), r.integers(0, 40, 400), 30, 0.5)),
    ("windowed_popularity", lambda r: (r.integers(0, 30, 400), r.integers(0, 40, 400), 30, None)),
])
def test_preprocess_pieces_equal(fn, args):
    a = args(np.random.default_rng(5))
    want, got = getattr(jax_pre, fn)(*a), getattr(preprocess, fn)(*a)
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("sparse", [False, True])
def test_load_intwtime_equal(domains, sparse):
    jprefix, pprefix, _, _ = domains
    name = "sparse_intwtime" if sparse else "intwtime"
    want = jax_data.load_intwtime(f"{jprefix}_{name}.csv", MAXLEN, sparse=sparse)
    got = data.load_intwtime(f"{pprefix}_{name}.csv", MAXLEN, sparse=sparse)
    for field in ("train_seq", "train_t1", "train_t2", "train_te", "valid_item", "valid_t1",
                  "valid_t2", "valid_te", "test_item", "test_t1", "test_t2", "test_te",
                  "seq_lens", "eligible_users"):
        w, g = getattr(want, field), getattr(got, field)
        assert w.dtype == g.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert (got.usernum, got.itemnum) == (want.usernum, want.itemnum)
    if sparse:
        assert not got.valid_item.any()


def test_load_userneg_equal(domains):
    jprefix, pprefix, stats, _ = domains
    want = jax_data.load_userneg(f"{jprefix}_userneg.pickle", stats["n_users"])
    got = data.load_userneg(f"{pprefix}_userneg.pickle", stats["n_users"])
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def _table_case(seed, t=7, bd=3, v=9, nwin=4):
    rng = np.random.default_rng(seed)
    flat = rng.normal(size=(t * bd, v))
    # items 0 (padding) .. v; times from below 0 (the window clips at the
    # front) to past T (it clips at the back)
    items = rng.integers(0, v + 1, size=(3, 40))
    times = rng.integers(-3, t + nwin + 2, size=(3, 40))
    return flat, bd, bd * nwin, items, times


@pytest.mark.parametrize("seed,nwin", [(1, 4), (2, 1), (3, 7)])
def test_popularity_gather_equal(seed, nwin):
    flat, bd, units, items, times = _table_case(seed, nwin=nwin)
    want = jax_pop.PopularityTable.from_flat(flat, bd, units).gather(
        jnp.asarray(items), jnp.asarray(times))
    table = popularity.PopularityTable.from_flat(flat, bd, units)
    got = table.gather(torch.from_numpy(items), torch.from_numpy(times))
    assert got.shape == want.shape == items.shape + (units,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert table.table.shape == (flat.shape[0] // bd + nwin - 1, flat.shape[1] + 1, bd)


def test_popularity_table_without_features_equal():
    """base_dim or input_units 0: a one-column table of zeros, as in JAX."""
    flat = np.ones((4, 6))
    items, times = np.array([[0, 3, 6]]), np.array([[0, 1, 5]])
    want = jax_pop.PopularityTable.from_flat(flat, 0, 0).gather(jnp.asarray(items), jnp.asarray(times))
    got = popularity.PopularityTable.from_flat(flat, 0, 0).gather(
        torch.from_numpy(items), torch.from_numpy(times))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _cfgs(stats, **kw):
    fields = dict(usernum=stats["n_users"], itemnum=stats["n_items"], maxlen=MAXLEN,
                  base_dim1=11, input_units1=33, base_dim2=6, input_units2=6, **kw)
    return JaxPrepRecConfig(**fields), PrepRecConfig(**fields)


def test_popularity_encoding_and_eval_popularity_equal(domains):
    jprefix, pprefix, stats, _ = domains
    jcfg, cfg = _cfgs(stats)
    rng = np.random.default_rng(4)
    users = rng.integers(1, stats["n_users"] + 1, 8)
    items = rng.integers(0, stats["n_items"] + 1, (8, 21))
    t1 = rng.integers(0, 16, (8, 21))
    t2 = rng.integers(0, 60, (8, 21))

    jenc = jax_pop.PopularityEncoding.load(f"{jprefix}_wtembed.txt", f"{jprefix}_week_embed2.txt", jcfg)
    enc = popularity.PopularityEncoding.load(f"{pprefix}_wtembed.txt", f"{pprefix}_week_embed2.txt", cfg)
    want = jenc(jnp.asarray(items), jnp.asarray(t1), jnp.asarray(t2))
    got = enc(*(torch.from_numpy(a) for a in (items, t1, t2)))
    assert got.shape == (8, 21, 39)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    jev = jax_pop.EvalPopularity.load(f"{jprefix}_wtembed.txt", f"{jprefix}_week_wt_embed_adj.txt", jcfg)
    ev = popularity.EvalPopularity.load(f"{pprefix}_wtembed.txt", f"{pprefix}_week_wt_embed_adj.txt", cfg)
    want = jev(jnp.asarray(items), jnp.asarray(t1), jnp.asarray(users))
    got = ev(torch.from_numpy(items), torch.from_numpy(t1), torch.from_numpy(users))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sinusoid_table_equal():
    np.testing.assert_array_equal(popularity.sinusoid_table(13, 16), jax_pop.sinusoid_table(13, 16))


def test_draw_user_batches_bit_equal():
    eligible = np.arange(1, 200, 3, dtype=np.int32)
    want = jax_sampler.draw_user_batches(np.random.default_rng(2023), eligible, 5, 16)
    got = sampler.draw_user_batches(np.random.default_rng(2023), eligible, 5, 16)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


def test_positional_negatives_law():
    """Both packages: negatives in [1, itemnum], 0 where pos == 0, and a
    collision with the user's items survives only where all seven draws
    collided. Users who own half of a 20-item catalog keep a collision
    at a rate near 0.5 ** 7; users who own 2 items almost never."""
    import jax

    itemnum, b, length = 20, 256, 40
    rng = np.random.default_rng(0)
    rows = np.zeros((b, length + 1), np.int64)
    for r in range(b):
        owned = rng.choice(itemnum, 10 if r < b // 2 else 2, replace=False) + 1
        rows[r, -30:] = rng.choice(owned, 30)
    pos = rows[:, 1:].copy()
    pos[:, :5] = 0
    jneg = np.asarray(jax_sampler.positional_negatives(
        jax.random.PRNGKey(0), jnp.asarray(rows), jnp.asarray(pos), itemnum))
    gen = torch.Generator().manual_seed(0)
    neg = sampler.positional_negatives(gen, torch.from_numpy(rows), torch.from_numpy(pos),
                                       itemnum).numpy()
    for draw in (jneg, neg):
        assert draw.shape == pos.shape
        assert (draw[pos == 0] == 0).all()
        assert ((draw[pos != 0] >= 1) & (draw[pos != 0] <= itemnum)).all()
        hit = (rows[:, None, :] == draw[:, :, None]).any(-1) & (pos != 0)
        half = hit[: b // 2][pos[: b // 2] != 0].mean()
        # 0.5 ** 7 = 0.0078 over 4,480 positions: sd 0.0013
        assert 0.002 < half < 0.016, half
        assert hit[b // 2:].mean() < 0.001


def _datasets(domains, sparse):
    jprefix, pprefix, stats, _ = domains
    name = "sparse_intwtime" if sparse else "intwtime"
    return (jax_data.load_intwtime(f"{jprefix}_{name}.csv", MAXLEN, sparse=sparse),
            data.load_intwtime(f"{pprefix}_{name}.csv", MAXLEN, sparse=sparse),
            data.load_userneg(f"{pprefix}_userneg.pickle", stats["n_users"]), stats)


@pytest.mark.parametrize("mode", ["valid", "test"])
@pytest.mark.parametrize("prev_time", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("eval_method", [1, 3])
def test_build_eval_inputs_equal(domains, mode, prev_time, sparse, eval_method):
    jds, ds, negs, stats = _datasets(domains, sparse)
    jcfg, cfg = _cfgs(stats, prev_time=prev_time, sparse=sparse, eval_method=eval_method, lag=5)
    want = jax_eval.build_eval_inputs(jds, jcfg, mode, negs)
    got = evaluate.build_eval_inputs(ds, cfg, mode, negs)
    for field in ("seqs", "t1", "t2", "te", "target", "cand_t1", "cand_t2", "users"):
        w, g = getattr(want, field), getattr(got, field)
        assert w.dtype == g.dtype, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert got.num_cands == want.num_cands
    if eval_method == 3:
        assert got.cands is None and want.cands is None
    else:
        np.testing.assert_array_equal(got.cands, want.cands)
    dev = got.to_device("cpu")
    assert ("cands" in dev) == (eval_method == 1)
    assert all(t.dtype == torch.int64 for t in dev.values())


def test_metrics_equal():
    rng = np.random.default_rng(9)
    ranks = rng.integers(0, 30, 200)
    userpop = rng.integers(1, 40, 200).astype(np.float64)
    jcfg, cfg = _cfgs({"n_users": 200, "n_items": 50}, topk=(10, 5, 1), quality_size=20)
    assert evaluate.metrics_from_ranks(ranks, (10, 5, 1)) == jax_eval.metrics_from_ranks(ranks, (10, 5, 1))
    assert evaluate.grouped_metrics(ranks, userpop, cfg) == jax_eval.grouped_metrics(ranks, userpop, jcfg)


def test_ranks_from_scores_tie_window():
    """The rank lies between the strictly better count and that plus the
    ties, and equals the better count on tie-free rows."""
    rng = np.random.default_rng(1)
    scores = np.round(rng.normal(size=(64, 30)), 1).astype(np.float32)
    scores[:32] = rng.normal(size=(32, 30)).astype(np.float32)
    got = evaluate.ranks_from_scores(torch.from_numpy(scores), torch.Generator().manual_seed(0)).numpy()
    better = (scores[:, 1:] > scores[:, :1]).sum(1)
    tied = (scores[:, 1:] == scores[:, :1]).sum(1)
    assert ((got >= better) & (got <= better + tied)).all()
    np.testing.assert_array_equal(got[tied == 0], better[tied == 0])
    assert (tied[32:] > 0).any()


def test_artifact_files_are_the_reference_names(domains):
    _, pprefix, _, _ = domains
    for suffix in ARTIFACTS:
        assert os.path.exists(f"{pprefix}_{suffix}"), suffix

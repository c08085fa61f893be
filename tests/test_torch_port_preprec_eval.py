"""PREPRec's eval in the port against the JAX package, on the same
weights (the JAX trainer's init, carried across) and the same synthetic
domain: eval_method 1 (sampled negatives, with and without the
week-adjusted table) and eval_method 3 (the full catalog in several
chunks with a ragged tail, user batches with a ragged tail).

The tie-break uniforms come from different generators, so ranks are held
to the tie window of the scores that produced them: at least the count
of strictly better candidates, at most that plus the count of exact ties.
Where no candidate lies within NEAR of the ground truth's score, the rank
is deterministic and equals the JAX package's. The port's and JAX's
scores differ by rounding only (the same fp32 arithmetic in another
order; up to 3.4e-7 of the scores' largest magnitude here) and are held
within AGREE = 5e-7 of it; NEAR is twice that, so no candidate outside it
can change sides.

Under eval_method 3 the ground truth also competes against its own
catalog copy, scored in another call (one candidate against a chunk of
16): whether the copy ties it depends on those two products' rounding
(on the CPU the port's tie on every user here, JAX's on 6 of 60), and a
tie is broken at random. So no rank under eval_method 3 is deterministic;
where no other catalog item lies within NEAR of the ground truth, the
count of strictly better other items equals JAX's, and each side's rank
is that count plus its own copy's term (1 if the copy scored above, 0 if
below, either if tied)."""

import logging
import math

import jax
import numpy as np
import pytest
import torch

import bsarec_tpu.preprec.train as jax_train
from bsarec_tpu.preprec.config import PrepRecConfig as JaxPrepRecConfig
from bsarec_tpu.preprec.config import PrepRecTrainConfig as JaxPrepRecTrainConfig
from bsarec_tpu.preprec.data import load_intwtime as jax_load_intwtime
from bsarec_tpu.preprec.popularity import EvalPopularity as JaxEvalPopularity
from bsarec_tpu.preprec.popularity import PopularityEncoding as JaxPopularityEncoding
from bsarec_tpu_torch.preprec import evaluate, preprocess
from bsarec_tpu_torch.preprec.config import PrepRecConfig, PrepRecTrainConfig
from bsarec_tpu_torch.preprec.data import load_intwtime, load_userneg
from bsarec_tpu_torch.preprec.jax_import import newrec_from_jax
from bsarec_tpu_torch.preprec.popularity import EvalPopularity, PopularityEncoding
from bsarec_tpu_torch.preprec.train import PrepRecTrainer

L, EVAL_BATCH, ITEM_CHUNK = 12, 8, 16
AGREE, NEAR = 5e-7, 1e-6


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
    lg = logging.getLogger("preprec_port_eval_test")
    lg.addHandler(logging.NullHandler())
    lg.propagate = False
    return lg


@pytest.fixture(scope="module")
def domain(tmp_path_factory):
    root = tmp_path_factory.mktemp("preprec_port_eval")
    prefix = str(root / "synth")
    rng = np.random.default_rng(0)
    n = 6000
    raw = (rng.integers(0, 50, n), rng.integers(0, 60, n),
           1_500_000_000 + rng.integers(0, 3600 * 24 * 366, n))
    preprocess.preprocess(*raw, prefix, t1_cutoff=30.0, t2_cutoff=7.0)
    preprocess.eval_negatives(f"{prefix}_intwtime.csv", f"{prefix}_userneg.pickle", n=20, seed=0)
    preprocess.week_adjustment(f"{prefix}_intwtime.csv", f"{prefix}_userneg.pickle",
                               f"{prefix}_week_curr_raw.txt", f"{prefix}_week_wt_embed_adj.txt")
    return prefix, root


def _pair(domain, eval_method, use_week_eval=False):
    """The JAX trainer and the port's on its initial weights."""
    prefix, root = domain
    jds = jax_load_intwtime(f"{prefix}_intwtime.csv", L)
    ds = load_intwtime(f"{prefix}_intwtime.csv", L)
    negs = load_userneg(f"{prefix}_userneg.pickle", ds.usernum) if eval_method == 1 else None
    fields = dict(usernum=ds.usernum, itemnum=ds.itemnum, maxlen=L, hidden_units=16,
                  num_blocks=1, num_heads=1, dropout_rate=0.0, base_dim1=11, input_units1=33,
                  base_dim2=6, input_units2=6, eval_method=eval_method,
                  use_week_eval=use_week_eval)
    jcfg, cfg = JaxPrepRecConfig(**fields), PrepRecConfig(**fields)
    month, week = f"{prefix}_wtembed.txt", f"{prefix}_week_embed2.txt"
    adj = f"{prefix}_week_wt_embed_adj.txt"
    jpop, pop = JaxPopularityEncoding.load(month, week, jcfg), PopularityEncoding.load(month, week, cfg)
    jev = JaxEvalPopularity.load(month, adj, jcfg) if use_week_eval else None
    ev = EvalPopularity.load(month, adj, cfg) if use_week_eval else None
    tc = dict(batch_size=16, seed=1, eval_batch_size=EVAL_BATCH, eval_item_chunk=ITEM_CHUNK)
    jtr = jax_train.PrepRecTrainer(jcfg, JaxPrepRecTrainConfig(**tc), jds, _logger(),
                                   str(root / "jax"), jpop, jev, negs)
    tr = PrepRecTrainer(cfg, PrepRecTrainConfig(**tc, device="cpu"), ds, _logger(),
                        str(root / "port"), pop, ev, negs)
    tr.model.load_state_dict(newrec_from_jax(jax.device_get(jtr.params)))
    return jtr, tr


@torch.no_grad()
def _port_rows(tr, mode):
    """The port's score rows, made by the eval's own functions in its own
    batches: [U, C] under eval_method 1; under eval_method 3 [U, 1 + V],
    column 0 the one-candidate call, then the catalog sweep."""
    cfg, pop, ev = tr.cfg, tr.pop_enc, tr.eval_pop
    arrays = evaluate.build_eval_inputs(tr.ds, cfg, mode, tr.usernegs).to_device("cpu")
    tr.model.eval()
    rows = []
    for lo in range(0, tr.ds.usernum, EVAL_BATCH):
        sl = slice(lo, lo + EVAL_BATCH)
        state = evaluate.final_state(tr.model, cfg, pop, arrays["seqs"][sl], arrays["t1"][sl],
                                     arrays["t2"][sl], arrays["te"][sl])
        args = (arrays["cand_t1"][sl], arrays["cand_t2"][sl], arrays["users"][sl])
        if "cands" in arrays:
            rows.append(evaluate.score_cands(tr.model, cfg, pop, ev, state, arrays["cands"][sl], *args))
            continue
        parts = [evaluate.score_cands(tr.model, cfg, pop, ev, state, arrays["target"][sl][:, None], *args)]
        for c in range(math.ceil(tr.ds.itemnum / ITEM_CHUNK)):
            ids, _ = evaluate.sweep_chunk_ids(c, ITEM_CHUNK, tr.ds.itemnum, "cpu")
            parts.append(evaluate.score_cands(tr.model, cfg, pop, ev, state,
                                              ids[None].expand(state.shape[0], -1), *args))
        rows.append(torch.cat(parts, 1)[:, : 1 + tr.ds.itemnum])
    return torch.cat(rows).numpy()


def _window(rows):
    """(n_better, n_tied) of column 0 among the other columns."""
    return (rows[:, 1:] > rows[:, :1]).sum(1), (rows[:, 1:] == rows[:, :1]).sum(1)


@pytest.mark.parametrize("mode", ["valid", "test"])
@pytest.mark.parametrize("use_week_eval", [False, True])
def test_sampled_negative_ranks_match_jax(domain, mode, use_week_eval):
    jtr, tr = _pair(domain, 1, use_week_eval)
    _, jranks = jtr.evaluate(mode)
    jrows = jtr.eval_scores(mode)
    metrics, ranks = tr.evaluate(mode)
    rows = _port_rows(tr, mode)
    assert rows.shape == jrows.shape == (tr.ds.usernum, 21)
    scale = np.abs(jrows).max()
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=AGREE * scale)
    better, tied = _window(rows)
    assert ((ranks >= better) & (ranks <= better + tied)).all()
    exact = ~(np.abs(rows[:, 1:] - rows[:, :1]) <= NEAR * scale).any(1)
    assert exact.sum() >= tr.ds.usernum // 2
    np.testing.assert_array_equal(ranks[exact], jranks[exact])
    np.testing.assert_array_equal(ranks[exact], better[exact])
    assert metrics == evaluate.metrics_from_ranks(ranks, tr.cfg.topk)


@pytest.mark.parametrize("mode", ["valid", "test"])
def test_full_catalog_ranks_match_jax(domain, mode):
    jtr, tr = _pair(domain, 3)
    itemnum = tr.ds.itemnum
    assert math.ceil(itemnum / ITEM_CHUNK) >= 3 and itemnum % ITEM_CHUNK  # several chunks, a ragged tail
    assert tr.ds.usernum % EVAL_BATCH  # a ragged last user batch
    _, jranks = jtr.evaluate(mode)
    jrows = jtr.eval_scores(mode)  # JAX's sweep rows: [target] + the catalog
    _, ranks = tr.evaluate(mode)
    rows = _port_rows(tr, mode)
    assert rows.shape == jrows.shape == (tr.ds.usernum, itemnum + 1)
    scale = np.abs(jrows).max()
    np.testing.assert_allclose(rows, jrows, rtol=0, atol=AGREE * scale)
    better, tied = _window(rows)
    assert ((ranks >= better) & (ranks <= better + tied)).all()

    # the ground truth's catalog copy, on each side
    target = evaluate.build_eval_inputs(tr.ds, tr.cfg, mode, None).target
    u = np.arange(tr.ds.usernum)
    counts = []
    for r, rk in ((rows, ranks), (jrows, jranks)):
        others = r[:, 1:].copy()
        others[u, target - 1] = np.nan  # the copy is judged apart
        n_others = (others > r[:, :1]).sum(1)
        near = (np.abs(others - r[:, :1]) <= NEAR * scale).any(1)
        copy_term = rk - n_others
        copy, gt = r[u, target], r[:, 0]
        assert np.isin(copy_term[~near], (0, 1)).all()
        decided = ~near & (copy != gt)
        np.testing.assert_array_equal(copy_term[decided], (copy > gt)[decided])
        counts.append((n_others, near))
    (n_others, near), (jn_others, jnear) = counts
    exact = ~near & ~jnear
    assert exact.sum() >= tr.ds.usernum // 4
    np.testing.assert_array_equal(n_others[exact], jn_others[exact])


def test_week_eval_refused_under_full_catalog(domain):
    for trainer in _pair(domain, 3, use_week_eval=True):
        with pytest.raises(ValueError, match="use_week_eval"):
            trainer.evaluate("valid")

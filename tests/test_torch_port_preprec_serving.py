"""PREPRec's candidate scorer in the port: exported on the CPU as a
`torch.export` `.pt2` (parameters and popularity tables baked in, the
batch dimension dynamic), loaded back, and held against the eval path's
score rows on the same candidates and against the JAX package's
`build_candidate_scorer` on the same weights; `topk` is a stable argsort.

Tolerances: against the eval path's rows within rtol 1e-5 and 1e-6 of the
rows' largest magnitude (the same ops, traced); against JAX's scorer
likewise (fp32 sums in another order)."""

import jax
import numpy as np
import pytest
import torch

from bsarec_tpu.preprec.popularity import EvalPopularity as JaxEvalPopularity
from bsarec_tpu.preprec.serving import build_candidate_scorer as jax_build_candidate_scorer
from bsarec_tpu_torch.preprec import evaluate, preprocess
from bsarec_tpu_torch.preprec.popularity import EvalPopularity
from bsarec_tpu_torch.preprec.serving import (
    build_candidate_scorer,
    export_candidate_scorer,
    load_candidate_scorer,
)
from test_torch_port_preprec_zoo import (  # noqa: F401  (domain is a fixture)
    domain,
    one_torch_thread,
    trainer_pair,
)

RTOL, ATOL = 1e-5, 1e-6
MODELS = ["newrec", "newrec_week_eval", "newb4rec", "sasrec", "bert4rec", "bprmf", "cl4srec"]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max())


def _call_args(tr, mode="valid"):
    """The artifact's inputs for every user of `mode`, from the eval arrays
    (numpy int32): seqs, t1, t2 [U, L]; cands, ct1, ct2 [U, C]; users [U]."""
    a = evaluate.build_eval_inputs(tr.ds, tr.cfg, mode, tr.usernegs)
    c = a.cands.shape[1]
    return (a.seqs, a.t1, a.t2, a.cands, np.repeat(a.cand_t1[:, None], c, 1),
            np.repeat(a.cand_t2[:, None], c, 1), a.users)


@pytest.mark.parametrize("case", MODELS)
def test_exported_scorer_matches_the_eval_path_and_jax(domain, tmp_path, case):
    prefix, _ = domain
    name = case.split("_")[0]
    week = case.endswith("week_eval")
    jtr, tr = trainer_pair(prefix, tmp_path, name, use_week_eval=week)
    if week:
        preprocess.week_adjustment(f"{prefix}_intwtime.csv", f"{prefix}_userneg.pickle",
                                   f"{prefix}_week_curr_raw.txt", str(tmp_path / "adj.txt"))
        month = f"{prefix}_wtembed.txt"
        tr.eval_pop = EvalPopularity.load(month, str(tmp_path / "adj.txt"), tr.cfg)
        jtr.eval_pop = JaxEvalPopularity.load(month, str(tmp_path / "adj.txt"), jtr.cfg)
    path = str(tmp_path / f"{case}.pt2")
    meta = export_candidate_scorer(tr.model, tr.cfg, tr.pop_enc, tr.eval_pop, tr.cfg.maxlen, 21, path)
    assert meta["model"] == name and meta["use_week_eval"] == week and meta["bytes"] > 0
    scorer = load_candidate_scorer(path, "cpu")
    assert (scorer.seq_len, scorer.n_cands) == (tr.cfg.maxlen, 21)
    args = _call_args(tr)
    got = scorer.scores(*args)
    assert got.shape == (tr.ds.usernum, 21) and got.dtype == np.float32
    _close(got, tr.eval_scores("valid"))
    jax_score = jax_build_candidate_scorer(jtr.model, jtr.cfg, jtr.pop_enc, jtr.eval_pop)
    _close(got, np.asarray(jax_score(jax.device_get(jtr.params), *args)))
    # any batch size, the same rows
    for lo, hi in ((0, 1), (3, 10)):
        np.testing.assert_array_equal(scorer.scores(*(x[lo:hi] for x in args)), got[lo:hi])
    top = scorer.topk(*args, k=5)
    np.testing.assert_array_equal(top, np.argsort(-got, axis=1, kind="stable")[:, :5])


def test_topk_orders_ties_by_column(domain, tmp_path):
    """Equal scores keep their submitted order: a candidate list with
    repeats scores them alike, and topk returns the earlier column first."""
    prefix, _ = domain
    _, tr = trainer_pair(prefix, tmp_path, "sasrec")
    path = str(tmp_path / "s.pt2")
    export_candidate_scorer(tr.model, tr.cfg, None, None, tr.cfg.maxlen, 6, path)
    scorer = load_candidate_scorer(path, "cpu")
    seqs, t1, t2, *_ = _call_args(tr)
    cands = np.tile(np.array([[7, 3, 7, 3, 9, 9]], np.int32), (4, 1))
    s = scorer.scores(seqs[:4], t1[:4], t2[:4], cands, cands * 0, cands * 0)
    assert (s[:, 0] == s[:, 2]).all() and (s[:, 1] == s[:, 3]).all()
    top = scorer.topk(seqs[:4], t1[:4], t2[:4], cands, cands * 0, cands * 0, k=6)
    for row, order in zip(s, top):
        assert list(order) == sorted(range(6), key=lambda j: (-row[j], j))


def test_time_embed_is_refused_and_the_loader_defaults_to_cuda(domain, tmp_path):
    prefix, _ = domain
    _, tr = trainer_pair(prefix, tmp_path, "newrec", time_embed=True)
    with pytest.raises(NotImplementedError, match="time_embed"):
        build_candidate_scorer(tr.model, tr.cfg, tr.pop_enc, None)
    if not torch.cuda.is_available():
        _, plain = trainer_pair(prefix, tmp_path, "bprmf")
        path = str(tmp_path / "b.pt2")
        export_candidate_scorer(plain.model, plain.cfg, None, None, plain.cfg.maxlen, 21, path)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_candidate_scorer(path)

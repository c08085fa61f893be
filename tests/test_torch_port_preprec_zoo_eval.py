"""PREPRec's eval for all six models in the port against the JAX package,
on the same weights (the JAX trainer's init, carried across): the raw
score rows of `eval_scores` under eval_method 1 and 3 (the full catalog
in several chunks with a ragged tail, user batches with a ragged tail),
each model's ranks inside the tie windows of its score rows, NewRec's
user embeddings, and the host-side rankers (`mostpop_ranks`,
`ensemble_ranks`) rank for rank for the same numpy seed.

Tolerances: score rows within rtol 1e-5 and 1e-6 of the rows' largest
magnitude (fp32 sums in another order); user embeddings likewise. The
tie window of a rank: at least the count of strictly better candidates
in the port's own rows, at most that plus the count of exact ties (the
tie-break uniforms are the port's own)."""

import math

import numpy as np
import pytest
import torch

from bsarec_tpu.preprec import evaluate as jax_evaluate
from bsarec_tpu_torch.preprec import evaluate
from test_torch_port_preprec_zoo import (  # noqa: F401  (domain is a fixture)
    domain,
    one_torch_thread,
    trainer_pair,
)

RTOL, ATOL = 1e-5, 1e-6
EVAL_TC = {"eval_batch_size": 8, "eval_item_chunk": 16}
MODELS = ["newrec", "newb4rec", "sasrec", "bert4rec", "bprmf", "cl4srec"]


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * np.abs(want).max())


@pytest.mark.parametrize("method", [1, 3])
@pytest.mark.parametrize("name", MODELS)
def test_eval_scores_and_ranks_match_jax(domain, tmp_path, name, method):
    prefix, _ = domain
    jtr, tr = trainer_pair(prefix, tmp_path, name, eval_method=method, tc=EVAL_TC)
    itemnum, usernum = tr.ds.itemnum, tr.ds.usernum
    assert math.ceil(itemnum / 16) >= 3 and itemnum % 16 and usernum % 8  # ragged tails
    for mode in ("valid", "test"):
        rows = tr.eval_scores(mode)
        want = jtr.eval_scores(mode)
        assert rows.shape == want.shape == (usernum, 21 if method == 1 else itemnum + 1)
        _close(rows, want)
        _, ranks = tr.evaluate(mode)
        better = (rows[:, 1:] > rows[:, :1]).sum(1)
        tied = (rows[:, 1:] == rows[:, :1]).sum(1)
        assert ((ranks >= better) & (ranks <= better + tied)).all()
        assert ranks.max() <= rows.shape[1] - 1


def test_user_embeddings_match_jax(domain, tmp_path):
    """NewRec's [U, H] states in batches of 16 (U = 60: a tail of 12
    filled up from the start), against the JAX package's at the same
    batch; other models refuse."""
    prefix, _ = domain
    jtr, tr = trainer_pair(prefix, tmp_path, "newrec", tc=EVAL_TC)
    assert tr.ds.usernum % 16
    for mode in ("valid", "test"):
        got = tr.user_embeddings(mode, batch=16)
        assert got.shape == (tr.ds.usernum, tr.cfg.hidden_units)
        _close(got, jtr.user_embeddings(mode, batch=16))
    np.testing.assert_array_equal(tr.user_embeddings("test", batch=7), got)
    _, other = trainer_pair(prefix, tmp_path, "sasrec")
    with pytest.raises(ValueError, match="NewRec"):
        other.user_embeddings("test")


@pytest.mark.parametrize("method,exclude_rated", [(1, False), (3, False), (3, True)])
@pytest.mark.parametrize("mode", ["valid", "test"])
def test_mostpop_ranks_equal_jax(domain, tmp_path, method, exclude_rated, mode):
    prefix, _ = domain
    jtr, tr = trainer_pair(prefix, tmp_path, "sasrec", eval_method=method)
    rawpop = np.loadtxt(f"{prefix}_rawpop.txt").reshape(-1)
    inputs = evaluate.build_eval_inputs(tr.ds, tr.cfg, mode, tr.usernegs)
    jinputs = jax_evaluate.build_eval_inputs(jtr.ds, jtr.cfg, mode, jtr.usernegs)
    got = evaluate.mostpop_ranks(inputs, rawpop, np.random.default_rng(5), exclude_rated)
    want = jax_evaluate.mostpop_ranks(jinputs, rawpop, np.random.default_rng(5), exclude_rated)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0 and got.max() <= inputs.num_cands - 1
    if method == 1:
        with pytest.raises(ValueError, match="exclude_rated"):
            evaluate.mostpop_ranks(inputs, rawpop, np.random.default_rng(5), True)


def test_ensemble_ranks_equal_jax_and_ties_are_optimistic():
    rng = np.random.default_rng(0)
    scores = rng.normal(size=(40, 21)).round(1)  # rounded: ties occur
    loaded = rng.normal(size=(40, 21)).round(1)
    alphas = [0.0, 0.3, 1.0]
    for r in (None, 9):
        got = evaluate.ensemble_ranks(scores, loaded, alphas,
                                      None if r is None else np.random.default_rng(r))
        want = jax_evaluate.ensemble_ranks(scores, loaded, alphas,
                                           None if r is None else np.random.default_rng(r))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # the pinned tie rule: with rng None the ground truth takes the best
    # place of its tie group
    tied = np.array([[1.0, 1.0, 1.0, 0.0, 2.0]])
    assert evaluate.ensemble_ranks(tied, tied, [0.5])[0].tolist() == [1]
    draws = {int(evaluate.ensemble_ranks(tied, tied, [0.5], np.random.default_rng(s))[0][0])
             for s in range(40)}
    assert draws == {1, 2, 3}


def test_tiebroken_ranks_equal_jax():
    scores = np.random.default_rng(1).integers(0, 4, (30, 11)).astype(np.float64)
    got = evaluate._tiebroken_ranks(scores, np.random.default_rng(2))
    want = jax_evaluate._tiebroken_ranks(scores, np.random.default_rng(2))
    np.testing.assert_array_equal(got, want)


def test_bprmf_final_state_is_the_user_row(domain, tmp_path):
    prefix, _ = domain
    _, tr = trainer_pair(prefix, tmp_path, "bprmf")
    users = torch.tensor([1, 5, 60])
    with torch.no_grad():
        state = evaluate.final_state(tr.model, tr.cfg, None, None, None, None, None, users)
    torch.testing.assert_close(state, tr.model.user_emb.weight[users], rtol=0, atol=0)

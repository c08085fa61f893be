"""Port ops vs the JAX package on the same seeded numpy inputs
(atol 1e-6: fp32 ops on the CPU, the same arithmetic in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsarec_tpu.ops import frequency as jfreq
from bsarec_tpu.ops import masks as jmasks
from bsarec_tpu.ops import topk as jtopk
from bsarec_tpu_torch.ops import frequency, masks, topk

ATOL = 1e-6


def _ids(seed=0, b=6, length=9, vocab=30):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, size=(b, length)).astype(np.int32)
    ids[0, :4] = 0  # left padding
    return ids


def test_causal_mask_matches_jax():
    ids = _ids()
    got = masks.causal_additive_mask(torch.from_numpy(ids)).numpy()
    want = np.asarray(jmasks.causal_additive_mask(jnp.asarray(ids)))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.min() == -10000.0  # not -inf


@pytest.mark.parametrize("seq_len,c", [(12, 5), (50, 5), (50, 3), (7, 1)])
def test_lowpass_projection_matches_jax(seq_len, c):
    got = frequency.lowpass_projection_matrix(seq_len, c)
    want = jfreq.lowpass_projection_matrix(seq_len, c)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_frequency_filter_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 12, 16)).astype(np.float32)
    beta = rng.normal(size=(1, 1, 16)).astype(np.float32)
    proj = frequency.lowpass_projection_matrix(12, 5)
    got = frequency.frequency_filter(torch.from_numpy(x), torch.from_numpy(proj),
                                     torch.from_numpy(beta)).numpy()
    want = np.asarray(jfreq.frequency_filter(jnp.asarray(x), jnp.asarray(proj), jnp.asarray(beta)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_masked_topk_matches_jax_with_ties():
    """Seen items at 0.0 (column 0 through the 0-padding), and ties in
    smallest-id order, which the port enforces with a stable sort."""
    rng = np.random.default_rng(2)
    scores = rng.integers(-3, 4, size=(8, 200)).astype(np.float32)  # many exact ties
    seen = rng.integers(1, 200, size=(8, 12)).astype(np.int32)
    seen[:, 8:] = 0
    got_v, got_i = topk.masked_topk(torch.from_numpy(scores), torch.from_numpy(seen))
    want_v, want_i = jtopk.masked_topk(jnp.asarray(scores), jnp.asarray(seen))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


def test_topk_metrics_match_jax():
    rng = np.random.default_rng(3)
    idx = np.stack([rng.permutation(50)[:20] for _ in range(16)]).astype(np.int32)
    answers = rng.integers(0, 50, size=16).astype(np.int32)
    answers[:4] = idx[:4, 0]  # hits at rank 0 too
    valid = (np.arange(16) < 13).astype(np.float32)
    got = topk.topk_metrics(torch.from_numpy(idx), torch.from_numpy(answers), torch.from_numpy(valid))
    want = jtopk.topk_metrics(jnp.asarray(idx), jnp.asarray(answers), jnp.asarray(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert topk.metrics_from_sums(got.numpy()) == pytest.approx(
        jtopk.metrics_from_sums(np.asarray(want)), abs=ATOL)

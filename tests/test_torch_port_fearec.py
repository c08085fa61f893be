"""Port FEARec against the JAX FEARec: the harness of
`tests/test_torch_port_zoo.py` (weights both ways, forward, loss,
gradients, 3 Adam steps, the eval top-20 on both paths, `main` trains and
resumes, here on the fused dropout path), every fredom type (the
documented extension included), the delay aggregation's two variants and
its top-k order. At the harness's L = 10 the top k = min(int(10 ln L), L)
takes every lag, so the delay selection is held at L = 50 too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_port_zoo import (
    FWD_ATOL,
    check_adam_steps,
    check_eval_top20,
    check_forward_both_ways,
    check_loss_and_gradients,
    check_main_trains_and_resumes,
    fields_of,
    one_torch_thread,  # noqa: F401 (autouse fixture)
    jax_model_and_params,
    make_batch,
    port_model,
)

from bsarec_tpu.models import fearec as jfearec
from bsarec_tpu_torch.models import fearec
from bsarec_tpu_torch.ops.topk import stable_topk

FIELDS = fields_of("fearec")


def test_forward_matches_jax_both_ways():
    """Eval mode: the per-row delays (`time_delay_agg_infer`)."""
    check_forward_both_ways(FIELDS)


@pytest.mark.parametrize("extra", [{}, dict(ssl="us", fredom_type="us", sim="cos",
                                            spatial_ratio=0.3)], ids=["us_x", "us"])
def test_loss_and_gradients_match_jax(extra):
    """Train mode: the batch-shared delays. fredom types other than us_x
    take JAX's extension on the last-position states (along the hidden
    axis), which the reference would crash on; "us" takes both of its
    terms, which "un" and "su" take one each."""
    check_loss_and_gradients(dict(FIELDS, **extra))


def test_adam_steps_match_optax():
    # entries held at the first step only (zoo docstring): 49 of 27712 measured
    assert check_adam_steps(FIELDS) <= 60


def test_bands_match_jax():
    for layers, ratio in ((2, 0.6), (3, 0.2), (1, 0.6)):
        cfg = jfearec.EncoderConfig(max_seq_length=50, num_hidden_layers=layers)
        for i in range(layers):
            assert fearec.fearec_band(50, layers, ratio, i) == jfearec.fearec_band(cfg, ratio, i)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("variant", ["train", "infer"])
def test_delay_aggregation_matches_jax(variant, ties):
    """Both variants at L = 50 (k = 39 of 50 lags), on random and on tied
    correlations, where the order of equal values decides which lags
    are kept: the stable sort keeps the smaller lag first, as
    `jax.lax.top_k` does."""
    rng = np.random.default_rng(7)
    values = rng.normal(size=(3, 2, 4, 50)).astype(np.float32)
    corr = rng.normal(size=(3, 2, 4, 50)).astype(np.float32)
    if ties:
        corr = np.round(corr)  # few distinct levels: many equal means
        corr[:, :, :, 1::2] = corr[:, :, :, ::2]
    top_k = int(10 * np.log(50))
    got = getattr(fearec, f"time_delay_agg_{variant}")(torch.from_numpy(values),
                                                        torch.from_numpy(corr), top_k)
    want = getattr(jfearec, f"time_delay_agg_{variant}")(jnp.asarray(values), jnp.asarray(corr),
                                                         top_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    vals, idx = stable_topk(torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0]), 3)
    assert idx.tolist() == [1, 2, 4]


def test_long_sequence_forward_matches_jax():
    """At max_seq_length 40 the top k (36 of 40 lags) selects: the eval
    forward (per-row delays) against JAX; the train variant, which
    differs, is held at L = 50 by `test_delay_aggregation_matches_jax`."""
    fields = dict(FIELDS, max_seq_length=40, hidden_size=16)
    jmodel, params = jax_model_and_params(fields, 3)
    model = port_model(fields, params)
    ids = make_batch(fields, 4)[0]
    model.eval()
    with torch.no_grad():
        got = model.predict(torch.from_numpy(ids).long())
        model.train()
        assert not torch.allclose(model(torch.from_numpy(ids).long()), got)
    want = jmodel.apply({"params": params}, jnp.asarray(ids), method="predict")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_ATOL, rtol=0)


def test_inputs_off_max_seq_length_raise():
    """The band maps are built once at max_seq_length; every caller feeds
    [B, max_seq_length], and another length raises."""
    model = port_model(FIELDS)
    ids = torch.from_numpy(make_batch(FIELDS, 5)[0]).long()
    with pytest.raises(ValueError, match="max_seq_length 10, got 9"):
        model.predict(ids[:, 1:])


@pytest.mark.parametrize("eval_impl", ["dense", "streaming"])
def test_eval_top20_matches_jax(tmp_path, eval_impl):
    check_eval_top20(FIELDS, eval_impl, tmp_path)


def test_main_trains_fused_dropout_on_cpu_and_resumes(tmp_path, monkeypatch):
    """`--prng rbg` with BSAREC_DROPOUT=pallas: every site, the [B, h, L, L]
    attention probabilities included, on the fused path's plain version."""
    monkeypatch.setenv("BSAREC_DROPOUT", "pallas")
    log = check_main_trains_and_resumes("FEARec", tmp_path, prng="rbg")
    assert "dropout: fused kernel" in log and "fredom us_x" in log

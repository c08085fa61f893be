"""Port DuoRec against the JAX DuoRec: the harness of
`tests/test_torch_port_zoo.py` (weights both ways, forward, loss,
gradients, 3 Adam steps, the eval top-20 on both paths, `main` trains and
resumes, which continues the same-target stream), every `ssl` mode and
both `sim`s, and the extra forwards' dropout draws."""

import pytest
import torch

from test_torch_port_zoo import (
    check_adam_steps,
    check_eval_top20,
    check_forward_both_ways,
    check_loss_and_gradients,
    check_main_trains_and_resumes,
    fields_of,
    one_torch_thread,  # noqa: F401 (autouse fixture)
    make_batch,
    port_model,
)

from bsarec_tpu_torch.models.modules import DropoutState

FIELDS = fields_of("duorec")


def test_forward_matches_jax_both_ways():
    model = check_forward_both_ways(FIELDS)
    assert "item_encoder.blocks.1.layer.query.weight" in model.state_dict()


@pytest.mark.parametrize("extra", [{}, dict(ssl="us", sim="cos", tau=0.8, lmd=0.3, lmd_sem=0.2)],
                         ids=["us_x", "us"])
def test_loss_and_gradients_match_jax(extra):
    """us_x pairs the two extra views; us holds both of them against the
    main view, the terms that un and su take one each."""
    check_loss_and_gradients(dict(FIELDS, **extra))


def test_adam_steps_match_optax():
    # entries held at the first step only (zoo docstring): 56 of 27712 measured
    assert check_adam_steps(FIELDS) <= 70


@pytest.mark.parametrize("eval_impl", ["dense", "streaming"])
def test_eval_top20_matches_jax(tmp_path, eval_impl):
    check_eval_top20(FIELDS, eval_impl, tmp_path)


def test_main_trains_on_cpu_and_resumes(tmp_path):
    """The resumed run matches the straight one only if the snapshot
    carried the same-target view's numpy stream on."""
    log = check_main_trains_and_resumes("DuoRec", tmp_path)
    assert "InfoNCE (ssl=us_x)" in log


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "nn_dropout"])
def test_each_forward_draws_its_own_dropout(monkeypatch, fused):
    """us_x runs three forwards a step. On the fused path the call index
    runs on across them (7 sites a forward: 21 calls), so each draws its
    own masks, as Flax's per-call rng folding does in JAX; nn.Dropout
    draws anew at every call."""
    monkeypatch.setenv("BSAREC_DROPOUT", "pallas")
    fields = dict(FIELDS, hidden_dropout_prob=0.5, attention_probs_dropout_prob=0.5)
    from bsarec_tpu_torch.config import ModelConfig
    from bsarec_tpu_torch.models import build_model

    model = build_model(ModelConfig(**fields), generator=torch.Generator().manual_seed(0),
                        prng="rbg" if fused else "threefry")
    assert isinstance(model.dropout_state, DropoutState) and model.dropout_state.fused == fused
    ids = torch.from_numpy(make_batch(fields, 0)[0]).long()
    model.train()
    if fused:
        model.dropout_state.begin_step(torch.tensor([5, 9]))
    outs = [model(ids) for _ in range(2)]
    assert not torch.allclose(outs[0], outs[1])
    if fused:
        assert model.dropout_state.call == 2 * 7
        model.dropout_state.begin_step(torch.tensor([5, 9]))
        batch = (torch.from_numpy(x).long() for x in make_batch(fields, 0))
        model.calculate_loss(*batch)
        assert model.dropout_state.call == 3 * 7
    port_model(FIELDS)  # the registry's default path stays nn.Dropout

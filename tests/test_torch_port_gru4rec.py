"""Port GRU4Rec against the JAX GRU4Rec: the harness of
`tests/test_torch_port_zoo.py` (weights both ways, forward, loss,
gradients, 3 Adam steps, the eval top-20 on both paths, `main` trains and
resumes), with `nn.GRU` in the reference key layout."""

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
)

FIELDS = fields_of("gru4rec")


def test_forward_matches_jax_both_ways():
    model = check_forward_both_ways(FIELDS)
    sd = model.state_dict()
    g, h = FIELDS["gru_hidden_size"], FIELDS["hidden_size"]
    assert sd["gru_layers.weight_ih_l0"].shape == (3 * g, h)
    assert sd["gru_layers.weight_ih_l1"].shape == (3 * g, g)
    assert sd["gru_layers.weight_hh_l1"].shape == (3 * g, g)
    assert sd["dense.weight"].shape == (h, g)
    assert not any("bias" in k for k in sd if k.startswith("gru_layers"))


def test_loss_and_gradients_match_jax():
    """BPR's gradients; the position embeddings and the embedding
    LayerNorm, which the forward never reads, get none."""
    model, used, _ = check_loss_and_gradients(FIELDS)
    assert model.position_embeddings.weight.grad is None and model.LayerNorm.weight.grad is None


def test_adam_steps_match_optax():
    # entries held at the first step only (zoo docstring): 40 of 10592 measured
    assert check_adam_steps(FIELDS) <= 50


@pytest.mark.parametrize("eval_impl", ["dense", "streaming"])
def test_eval_top20_matches_jax(tmp_path, eval_impl):
    check_eval_top20(FIELDS, eval_impl, tmp_path)


def test_main_trains_on_cpu_and_resumes(tmp_path):
    log = check_main_trains_and_resumes("GRU4Rec", tmp_path, "--gru_hidden_size", "24")
    assert "BPR" in log


def test_params_from_jax_fills_the_unused_entries():
    """Without a base state_dict the entries JAX's tree lacks are zeros."""
    from test_torch_port_zoo import jax_model_and_params

    from bsarec_tpu_torch.train.jax_import import params_from_jax

    _, params = jax_model_and_params(FIELDS)
    sd = params_from_jax(params, max_seq_length=FIELDS["max_seq_length"])
    assert sd["position_embeddings.weight"].shape == (FIELDS["max_seq_length"], FIELDS["hidden_size"])
    assert not sd["position_embeddings.weight"].any() and not sd["LayerNorm.weight"].any()
    assert torch.equal(sd["gru_layers.weight_hh_l0"], torch.from_numpy(params["gru_0"]["w_hh"]).T)

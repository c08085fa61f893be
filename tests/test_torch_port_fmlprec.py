"""Port FMLP-Rec against the JAX FMLP-Rec: the harness of
`tests/test_torch_port_zoo.py` (weights both ways, forward, loss,
gradients, 3 Adam steps, the eval top-20 on both paths, `main` trains and
resumes). The filter runs on `torch.fft` where JAX takes DFT matmuls:
the same map, in the zoo file's tolerances."""

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

FIELDS = fields_of("fmlprec")


def test_forward_matches_jax_both_ways():
    model = check_forward_both_ways(FIELDS)
    w = model.state_dict()["item_encoder.blocks.1.layer.complex_weight"]
    assert w.shape == (1, FIELDS["max_seq_length"] // 2 + 1, FIELDS["hidden_size"], 2)


def test_loss_and_gradients_match_jax():
    check_loss_and_gradients(FIELDS)


def test_loss_is_unmasked():
    """Unlike SASRec's, FMLP-Rec's BCE counts the rows whose answer is 0
    (`src/model/fmlprec.py:54-59`)."""
    model = port_model(FIELDS)
    ids, answers, negs, _, _ = (torch.from_numpy(x).long() for x in make_batch(FIELDS, 3))
    assert answers[-1] == 0
    full = model.calculate_loss(ids, answers, negs)
    head = model.calculate_loss(ids[:-1], answers[:-1], negs[:-1])
    assert not torch.allclose(full, head)
    with pytest.raises(ValueError, match="negative"):
        model.calculate_loss(ids, answers)


def test_adam_steps_match_optax():
    # entries held at the first step only (zoo docstring): 90 of 20032 measured
    assert check_adam_steps(FIELDS) <= 100


@pytest.mark.parametrize("eval_impl", ["dense", "streaming"])
def test_eval_top20_matches_jax(tmp_path, eval_impl):
    check_eval_top20(FIELDS, eval_impl, tmp_path)


def test_main_trains_on_cpu_and_resumes(tmp_path):
    log = check_main_trains_and_resumes("FMLPRec", tmp_path)
    assert "unmasked log-sigmoid BCE" in log

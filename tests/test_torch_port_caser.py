"""Port Caser against the JAX Caser: the harness of
`tests/test_torch_port_zoo.py` (weights both ways, forward, loss,
gradients, 3 Adam steps, the eval top-20 on both paths, `main` trains and
resumes), the user table and the serving artifact. The horizontal bank
is the reference's Conv2d modules where JAX takes one windowed einsum:
the same sums in another order, within the zoo file's tolerances."""

import numpy as np
import pytest
import torch

from test_torch_port_zoo import (
    check_adam_steps,
    check_eval_top20,
    check_forward_both_ways,
    check_loss_and_gradients,
    check_main_trains_and_resumes,
    check_serving_matches_jax,
    fields_of,
    one_torch_thread,  # noqa: F401 (autouse fixture)
    make_batch,
    port_model,
)

FIELDS = fields_of("caser", reg_weight=0.05)  # a penalty the loss feels


def test_forward_matches_jax_both_ways():
    model = check_forward_both_ways(FIELDS)
    sd = model.state_dict()
    seq_len, h = FIELDS["max_seq_length"], FIELDS["hidden_size"]
    assert sd["conv_h.3.weight"].shape == (FIELDS["nh"], 1, 4, h)
    assert sd[f"conv_h.{seq_len - 1}.weight"].shape == (FIELDS["nh"], 1, seq_len, h)
    assert sd["conv_v.weight"].shape == (FIELDS["nv"], 1, seq_len, 1)
    assert sd["fc1.weight"].shape == (h, FIELDS["nv"] * h + FIELDS["nh"] * seq_len)


def test_loss_and_gradients_match_jax():
    """The pair BCE plus reg_weight x the Frobenius norms."""
    check_loss_and_gradients(FIELDS)


def test_user_row_0_is_zeroed_but_trained():
    """JAX zeroes the user table's row 0 at init and its plain `nn.Embed`
    lookups train it (`caser.py:50-55`); user 0 is the training split's
    first user, so the port does not freeze it."""
    model = port_model(FIELDS)
    assert not model.user_embeddings.weight[0].any()
    assert model.user_embeddings.padding_idx is None
    ids, answers, negs, sem, users = (torch.from_numpy(x).long() for x in make_batch(FIELDS, 2))
    users[:3] = 0
    model.train()
    model.calculate_loss(ids, answers, negs, sem, users).backward()
    assert model.user_embeddings.weight.grad[0].abs().max() > 0
    # item lookups keep row 0 frozen; the norm's gradient at the zero row is 0
    assert not model.item_table.grad[0].any()


def test_adam_steps_match_optax():
    # entries held at the first step only (zoo docstring): 111 of 11626 measured
    assert check_adam_steps(FIELDS) <= 130


@pytest.mark.parametrize("eval_impl", ["dense", "streaming"])
def test_eval_top20_matches_jax(tmp_path, eval_impl):
    """The eval passes each user's index as its id (JAX's
    `train/loop.py:312,319`); Caser reads it."""
    check_eval_top20(FIELDS, eval_impl, tmp_path)


def test_main_trains_on_cpu_and_resumes(tmp_path):
    log = check_main_trains_and_resumes("Caser", tmp_path, "--nh", "2", "--nv", "2")
    assert "Frobenius" in log


def test_serving_artifact_matches_jax(tmp_path):
    """The artifact threads the user ids through (`tests/test_serving.py:247`)
    and refuses ids outside the user table."""
    scorer, split, users = check_serving_matches_jax(FIELDS, tmp_path)
    ids, seen = split.input_ids[:6], split.seen_items[:6]
    assert not np.array_equal(scorer.topk(ids, users[:6], seen), scorer.topk(ids, users[6:12], seen))
    with pytest.raises(ValueError, match="user_ids"):
        scorer.topk(ids, np.full(6, scorer.meta["num_users"], np.int32), seen)

"""Port BERT4Rec against the JAX BERT4Rec: the harness of
`tests/test_torch_port_zoo.py` (weights both ways, forward, loss,
gradients, 3 Adam steps, the eval top-20 on both paths, `main` trains and
resumes), the cloze draw, the [mask] row and the serving artifact."""

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

from bsarec_tpu_torch.models.bert4rec import cloze_mask

FIELDS = fields_of("bert4rec")


def test_forward_matches_jax_both_ways():
    """Forward and predict (the eval shift: the mask token appended, the
    first position dropped), on a table of item_size + 1 rows."""
    model = check_forward_both_ways(FIELDS)
    assert model.item_table.shape == (FIELDS["item_size"] + 1, FIELDS["hidden_size"])
    ids = torch.from_numpy(make_batch(FIELDS, 0)[0]).long()
    shifted = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], FIELDS["item_size"])], dim=1)
    model.eval()
    with torch.no_grad():
        torch.testing.assert_close(model.predict(ids), model(shifted), rtol=0, atol=0)


def test_loss_and_gradients_match_jax():
    """The CE runs over all item_size + 1 rows: the [mask] row gets the
    softmax's gradient, as in JAX."""
    model, _, _ = check_loss_and_gradients(FIELDS)
    assert model.item_table.grad[FIELDS["item_size"]].abs().max() > 0


def test_adam_steps_match_optax():
    # entries held at the first step only (zoo docstring): 120 of 27744 measured
    assert check_adam_steps(FIELDS) <= 140


def test_cloze_mask_draws_distinct_positions_padding_included():
    """int(L * mask_ratio) distinct positions per row, uniform over all L
    positions: padded ones too, whose 0 becomes the mask token (a key the
    bidirectional mask then lets through), as JAX draws them
    (`bsarec_tpu/models/bert4rec.py:42-51`)."""
    seq_len, token, n = 10, 60, 2
    ids = torch.zeros((4000, seq_len), dtype=torch.long)
    ids[:, -3:] = torch.arange(1, 4)
    masked = cloze_mask(ids, n, token, torch.Generator().manual_seed(0))
    hit = masked == token
    assert (hit.sum(dim=1) == n).all()
    share = hit.float().mean(dim=0)  # each position n / L of the time
    assert (share - n / seq_len).abs().max() < 0.03
    assert hit[:, :-3].any(dim=1).float().mean() > 0.9  # a padded position masked
    again = cloze_mask(ids, n, token, torch.Generator().manual_seed(0))
    assert torch.equal(masked, again)
    model = port_model(FIELDS)
    mask = model.get_bi_attention_mask(masked[:1])
    assert mask.shape == (1, 1, 1, seq_len)
    assert ((mask[0, 0, 0] == 0) == (masked[0] > 0)).all()


@pytest.mark.parametrize("eval_impl", ["dense", "streaming"])
def test_eval_top20_matches_jax(tmp_path, eval_impl):
    """The streaming path scores the whole table (item_size + 1 rows) with
    n_valid = item_size, the [mask] column out of the ranking."""
    trainer = check_eval_top20(FIELDS, eval_impl, tmp_path)
    assert trainer.export_topk("test").max() < trainer.model_cfg.item_size


def test_main_trains_on_cpu_and_resumes(tmp_path):
    log = check_main_trains_and_resumes("BERT4Rec", tmp_path)
    assert "cloze-masked" in log


def test_serving_artifact_matches_jax(tmp_path):
    """The artifact applies the eval shift inside predict and trims the
    [mask] column (`tests/test_serving.py:107`)."""
    scorer, split, users = check_serving_matches_jax(FIELDS, tmp_path)
    assert scorer.meta["num_users"] is None  # BERT4Rec reads no user ids
    np.testing.assert_array_equal(scorer.topk(split.input_ids[:5]),
                                  scorer.topk(split.input_ids[:5], users[5:10]))

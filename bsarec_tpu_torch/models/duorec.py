"""DuoRec (counterpart of `bsarec_tpu/models/duorec.py`).

Contrastive regularization of a causal transformer (reference:
`src/model/duorec.py`): SASRec's encoder and key layout, the full-catalog
CE of the last position's state, plus InfoNCE terms between the states
of extra train-mode forwards, selected by `ssl`: "us"/"un" a second
forward of the same sequences (weight `lmd`), "us"/"su" a forward of the
same-target view (`lmd_sem`), "us_x" the pair of those two (`lmd_sem`).
Every forward draws its own dropout masks: `nn.Dropout` draws anew at
each call, and on the fused path the `DropoutState` call index keeps
running across the step's forwards.
"""

from __future__ import annotations

import torch

from bsarec_tpu_torch.models.base import SequentialRecModel
from bsarec_tpu_torch.models.modules import TransformerEncoder
from bsarec_tpu_torch.ops.losses import full_softmax_ce, info_nce_logits


def contrastive_terms(cfg, forward, input_ids, same_target, last):
    """DuoRec's and FEARec's InfoNCE terms (`duorec.py:34-49`,
    `fearec.py:210-225`): returns (loss terms, aug, sem), where aug and
    sem are the [B, L, H] outputs of the extra forwards `forward` ran
    (None where `ssl` runs none) and `last` is the main forward's [B, H]
    last-position state."""
    loss = 0.0
    aug = sem = None
    if cfg.ssl in ("us", "un"):
        aug = forward(input_ids)
        loss = loss + cfg.lmd * info_nce_logits(last, aug[:, -1, :], cfg.tau, cfg.sim)
    if cfg.ssl in ("us", "su"):
        sem = forward(same_target)
        loss = loss + cfg.lmd_sem * info_nce_logits(last, sem[:, -1, :], cfg.tau, cfg.sim)
    if cfg.ssl == "us_x":
        aug = forward(input_ids)
        sem = forward(same_target)
        loss = loss + cfg.lmd_sem * info_nce_logits(aug[:, -1, :], sem[:, -1, :],
                                                    cfg.tau, cfg.sim)
    return loss, aug, sem


class DuoRecModel(SequentialRecModel):
    reads_same_target = True

    def loss_name(self, ce: str) -> str:
        return f"{ce} + InfoNCE (ssl={self.config.ssl})"

    def __init__(self, cfg, generator: torch.Generator | None = None, prng: str = "threefry"):
        super().__init__(cfg, prng)
        self.item_encoder = TransformerEncoder(cfg, self.dropout_state)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        super().reset_parameters(generator)
        for block in self.item_encoder.blocks:
            block.reset_parameters(self.config.initializer_range, generator)

    def forward(self, input_ids, user_ids=None, all_layers: bool = False):
        mask = self.get_attention_mask(input_ids)
        x = self.add_position_embedding(input_ids)
        return self.item_encoder(x, mask, all_layers=all_layers)

    def calculate_loss(self, input_ids, answers, neg_answers=None, same_target=None,
                       user_ids=None, *, generator=None):
        cfg = self.config
        last = self.forward(input_ids)[:, -1, :]
        loss = full_softmax_ce(last, self.item_table, answers, impl=cfg.loss_impl,
                               dtype=cfg.compute_dtype)
        terms, _, _ = contrastive_terms(cfg, self.forward, input_ids, same_target, last)
        return loss + terms

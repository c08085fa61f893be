"""SASRec (counterpart of `bsarec_tpu/models/sasrec.py`).

A causal TransformerEncoder over the embedded sequence (reference:
`src/model/sasrec.py`). The loss is BCE-with-logits on the (answer,
sampled negative) dot products with the last position's state, over
the rows whose answer is not 0. Item lookups freeze row 0, as JAX's
`embed_items` does. Module names give the reference's key layout
(`item_encoder.blocks.{i}.layer.query.weight`, ...).
"""

from __future__ import annotations

import torch

from bsarec_tpu_torch.models.base import SequentialRecModel
from bsarec_tpu_torch.models.modules import TransformerEncoder
from bsarec_tpu_torch.ops.losses import pair_bce_masked


class SASRecModel(SequentialRecModel):
    reads_negatives = True

    def loss_name(self, ce: str) -> str:
        return "pair BCE with one sampled negative per sample"

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
        seq_out = self.forward(input_ids)[:, -1, :]
        return pair_bce_masked(*self.pair_logits(seq_out, answers, neg_answers), answers)

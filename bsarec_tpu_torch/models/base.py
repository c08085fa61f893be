"""Abstract sequential-recommendation model (counterpart of
`bsarec_tpu/models/base.py`).

Item and position embeddings, the embedding LayerNorm and dropout, and
the `predict` / `item_table` / `calculate_loss` surface of the eval and
training loops. The item table has `padding_idx=0`: row 0 is zero at
init and lookups (`embed_items`) do not update it, while the tied
full-catalog CE of training does (`bsarec_tpu/models/base.py:12-15`).
Dropout follows the module's train/eval mode, where the JAX package
takes a `train` flag; `prng` picks the dropout path of every site
(`modules.make_dropout`), and `dropout_state` carries the fused path's
per-step seeds.
"""

from __future__ import annotations

import torch
from torch import nn

from bsarec_tpu_torch.models.modules import (
    DropoutState,
    TFLayerNorm,
    make_dropout,
    use_fused_dropout,
)
from bsarec_tpu_torch.ops.masks import causal_additive_mask


class SequentialRecModel(nn.Module):
    # whether calculate_loss reads the sampled negatives (the training
    # epoch draws them only for such models)
    reads_negatives = False

    def __init__(self, cfg, prng: str = "threefry"):
        super().__init__()
        self.config = cfg
        self.dropout_state = DropoutState(fused=use_fused_dropout(prng))
        self.item_embeddings = nn.Embedding(cfg.item_size, cfg.hidden_size, padding_idx=0)
        self.position_embeddings = nn.Embedding(cfg.max_seq_length, cfg.hidden_size)
        self.LayerNorm = TFLayerNorm(cfg.hidden_size)
        self.dropout = make_dropout(cfg.hidden_dropout_prob, self.dropout_state)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        """N(0, initializer_range) embeddings with the padding row zeroed;
        subclasses initialize their encoder after this."""
        std = self.config.initializer_range
        with torch.no_grad():
            self.item_embeddings.weight.normal_(0.0, std, generator=generator)
            self.item_embeddings.weight[0].zero_()
            self.position_embeddings.weight.normal_(0.0, std, generator=generator)

    @property
    def item_table(self) -> torch.Tensor:
        return self.item_embeddings.weight

    def embed_items(self, ids: torch.Tensor) -> torch.Tensor:
        """Item rows; lookups of id 0 send no gradient to row 0."""
        return self.item_embeddings(ids.long())

    def add_position_embedding(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos = self.position_embeddings.weight[: input_ids.shape[-1]]
        emb = self.embed_items(input_ids) + pos[None]
        return self.dropout(self.LayerNorm(emb))

    @staticmethod
    def get_attention_mask(input_ids):
        return causal_additive_mask(input_ids)

    def forward(self, input_ids, user_ids=None, all_layers: bool = False):
        raise NotImplementedError

    def predict(self, input_ids, user_ids=None) -> torch.Tensor:
        """Eval-time forward; returns [B, L, H] (the eval loop takes [:, -1])."""
        return self.forward(input_ids, user_ids)

    def calculate_loss(self, input_ids, answers, neg_answers=None) -> torch.Tensor:
        """Scalar training loss of one batch; `neg_answers` [B] are the
        sampled negatives, read by models with `reads_negatives`."""
        raise NotImplementedError

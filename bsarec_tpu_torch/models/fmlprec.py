"""FMLP-Rec (counterpart of `bsarec_tpu/models/fmlprec.py`).

All-MLP with learnable spectral filters (reference: `src/model/fmlprec.py`):
no attention; each layer multiplies the sequence's spectrum (rfft along
the sequence axis, ortho norms, on `torch.fft`) by a learnable complex
weight, adds the
residual, LayerNorms, then runs the shared FeedForward. The loss is the
unmasked log-sigmoid BCE on the (answer, sampled negative) dot products
with the last position's state. The weight is `complex_weight` [1, F, H,
2] (real, imag) in the reference layout; the JAX package keeps the two
planes as `filter_real` / `filter_imag` (`params_from_jax` stacks them).
"""

from __future__ import annotations

import torch
from torch import nn

from bsarec_tpu_torch.models.base import SequentialRecModel
from bsarec_tpu_torch.models.modules import (
    DropoutState,
    FeedForward,
    TFLayerNorm,
    TransformerEncoder,
    make_dropout,
)
from bsarec_tpu_torch.ops.frequency import complex_filter_apply
from bsarec_tpu_torch.ops.losses import pair_logsigmoid_bce


class FilterLayer(nn.Module):
    def __init__(self, cfg, dropout_state: DropoutState):
        super().__init__()
        freq = cfg.max_seq_length // 2 + 1
        self.complex_weight = nn.Parameter(torch.empty(1, freq, cfg.hidden_size, 2))
        self.LayerNorm = TFLayerNorm(cfg.hidden_size)
        self.dropout = make_dropout(cfg.hidden_dropout_prob, dropout_state)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():  # the reference: randn(...) * 0.02
            self.complex_weight.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = complex_filter_apply(x, self.complex_weight)
        return self.LayerNorm(self.dropout(h) + x)


class FMLPRecBlock(nn.Module):
    def __init__(self, cfg, dropout_state: DropoutState):
        super().__init__()
        self.layer = FilterLayer(cfg, dropout_state)
        self.feed_forward = FeedForward(cfg, dropout_state)

    def forward(self, x, attention_mask=None):
        return self.feed_forward(self.layer(x))


class FMLPRecModel(SequentialRecModel):
    reads_negatives = True

    def loss_name(self, ce: str) -> str:
        return "unmasked log-sigmoid BCE with one sampled negative per sample"

    def __init__(self, cfg, generator: torch.Generator | None = None, prng: str = "threefry"):
        super().__init__(cfg, prng)
        self.item_encoder = TransformerEncoder(cfg, self.dropout_state, block=FMLPRecBlock)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        super().reset_parameters(generator)
        for block in self.item_encoder.blocks:
            block.layer.reset_parameters(generator)
            block.feed_forward.reset_parameters(self.config.initializer_range, generator)

    def forward(self, input_ids, user_ids=None, all_layers: bool = False):
        x = self.add_position_embedding(input_ids)
        return self.item_encoder(x, None, all_layers=all_layers)

    def calculate_loss(self, input_ids, answers, neg_answers=None, same_target=None,
                       user_ids=None, *, generator=None):
        seq_out = self.forward(input_ids)[:, -1, :]
        return pair_logsigmoid_bce(*self.pair_logits(seq_out, answers, neg_answers))

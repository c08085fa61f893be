"""BSARec (counterpart of `bsarec_tpu/models/bsarec.py`).

Each block blends a frequency-domain filter branch (`dsp`) with
multi-head attention (`gsp`) as `alpha*dsp + (1-alpha)*gsp`, followed by
the shared FeedForward (reference: `src/model/bsarec.py`). The
FrequencyLayer low-passes the sequence with a fixed [L, L] projection
and rescales the high-pass residue by a learnable `sqrt_beta**2`.
Module names give the reference's key layout
(`item_encoder.blocks.{i}.layer.filter_layer.sqrt_beta`, ...).
"""

from __future__ import annotations

import torch
from torch import nn

from bsarec_tpu_torch.models.base import SequentialRecModel
from bsarec_tpu_torch.models.modules import (
    DropoutState,
    FeedForward,
    MultiHeadAttention,
    TFLayerNorm,
    TransformerEncoder,
    make_dropout,
)
from bsarec_tpu_torch.ops.frequency import frequency_filter, lowpass_projection_matrix
from bsarec_tpu_torch.ops.losses import full_softmax_ce
from bsarec_tpu_torch.ops.precision import is_bf16


class FrequencyLayer(nn.Module):
    def __init__(self, cfg, dropout_state: DropoutState):
        super().__init__()
        self.c = cfg.c
        self.bf16 = is_bf16(cfg.compute_dtype)
        self.sqrt_beta = nn.Parameter(torch.empty(1, 1, cfg.hidden_size))
        self.LayerNorm = TFLayerNorm(cfg.hidden_size)
        self.dropout = make_dropout(cfg.hidden_dropout_prob, dropout_state)
        # kept on the model's device: a copy from pageable host memory in
        # every forward would make the host wait for the card each batch
        self.register_buffer("proj", torch.tensor(
            lowpass_projection_matrix(cfg.max_seq_length, cfg.c)), persistent=False)

    def reset_parameters(self, generator=None) -> None:
        with torch.no_grad():
            self.sqrt_beta.normal_(0.0, 1.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        proj = self.proj
        if x.shape[1] != proj.shape[0]:  # inputs shorter than max_seq_length
            proj = torch.from_numpy(lowpass_projection_matrix(x.shape[1], self.c)).to(x.device)
        h = frequency_filter(x, proj, self.sqrt_beta, self.bf16)
        return self.LayerNorm(self.dropout(h) + x)


class BSARecLayer(nn.Module):
    def __init__(self, cfg, dropout_state: DropoutState):
        super().__init__()
        self.alpha = cfg.alpha
        self.filter_layer = FrequencyLayer(cfg, dropout_state)
        self.attention_layer = MultiHeadAttention(cfg, dropout_state)

    def forward(self, x, attention_mask):
        dsp = self.filter_layer(x)
        gsp = self.attention_layer(x, attention_mask)
        return self.alpha * dsp + (1.0 - self.alpha) * gsp


class BSARecBlock(nn.Module):
    def __init__(self, cfg, dropout_state: DropoutState):
        super().__init__()
        self.layer = BSARecLayer(cfg, dropout_state)
        self.feed_forward = FeedForward(cfg, dropout_state)

    def forward(self, x, attention_mask):
        return self.feed_forward(self.layer(x, attention_mask))


class BSARecModel(SequentialRecModel):
    def __init__(self, cfg, generator: torch.Generator | None = None, prng: str = "threefry"):
        super().__init__(cfg, prng)
        self.item_encoder = TransformerEncoder(cfg, self.dropout_state, block=BSARecBlock)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        super().reset_parameters(generator)
        std = self.config.initializer_range
        for block in self.item_encoder.blocks:
            block.layer.filter_layer.reset_parameters(generator)
            block.layer.attention_layer.reset_parameters(std, generator)
            block.feed_forward.reset_parameters(std, generator)

    def forward(self, input_ids, user_ids=None, all_layers: bool = False):
        mask = self.get_attention_mask(input_ids)
        x = self.add_position_embedding(input_ids)
        return self.item_encoder(x, mask, all_layers=all_layers)

    def calculate_loss(self, input_ids, answers, neg_answers=None, same_target=None,
                       user_ids=None, *, generator=None):
        """Mean full-catalog CE of the last position's state against the
        tied item table (`bsarec_tpu/models/bsarec.py:91-93`); the
        negatives are not read."""
        seq_output = self.forward(input_ids)
        return full_softmax_ce(seq_output[:, -1, :], self.item_table, answers,
                               impl=self.config.loss_impl, dtype=self.config.compute_dtype)

"""GRU4Rec (counterpart of `bsarec_tpu/models/gru4rec.py`).

A bias-free, batch-first GRU stack (`num_hidden_layers` deep, width
`gru_hidden_size`) over the dropped-out item embeddings, then a dense
back-projection to the embedding size (reference: `src/model/gru4rec.py`).
The loss is BPR, -log sigmoid(pos - neg), at the last position. The GRU
is `nn.GRU` under the reference's name `gru_layers` (`weight_ih_l{i}`
[3G, in] and `weight_hh_l{i}` [3G, G], gates r, z, n), every layer
xavier-uniform as in JAX. The forward reads neither the position
embeddings nor the embedding LayerNorm: they stay in the state_dict
for the reference's key layout, untrained (JAX's tree has neither).
"""

from __future__ import annotations

import torch
from torch import nn

from bsarec_tpu_torch.models.base import SequentialRecModel
from bsarec_tpu_torch.models.modules import init_linear
from bsarec_tpu_torch.ops.losses import bpr_loss


class GRU4RecModel(SequentialRecModel):
    reads_negatives = True

    def loss_name(self, ce: str) -> str:
        return "BPR with one sampled negative per sample"

    def __init__(self, cfg, generator: torch.Generator | None = None, prng: str = "threefry"):
        super().__init__(cfg, prng)
        self.gru_layers = nn.GRU(cfg.hidden_size, cfg.gru_hidden_size,
                                 num_layers=cfg.num_hidden_layers, bias=False, batch_first=True)
        self.dense = nn.Linear(cfg.gru_hidden_size, cfg.hidden_size)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        super().reset_parameters(generator)
        with torch.no_grad():
            for w in self.gru_layers.parameters():  # xavier-uniform on [3G, in]
                bound = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
                w.uniform_(-bound, bound, generator=generator)
        init_linear(self.dense, self.config.initializer_range, generator)

    def forward(self, input_ids, user_ids=None, all_layers: bool = False):
        x = self.dropout(self.embed_items(input_ids))
        x, _ = self.gru_layers(x)
        return self.dense(x)

    def calculate_loss(self, input_ids, answers, neg_answers=None, same_target=None,
                       user_ids=None, *, generator=None):
        seq_out = self.forward(input_ids)[:, -1, :]
        return bpr_loss(*self.pair_logits(seq_out, answers, neg_answers))

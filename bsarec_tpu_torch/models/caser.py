"""Caser (counterpart of `bsarec_tpu/models/caser.py`).

Convolutional sequence embedding (reference: `src/model/caser.py`): a
horizontal bank of L Conv2d(1, nh, (i, H)) filters, i = 1..L (relu, then
a max over time), and a vertical Conv2d(1, nv, (L, 1)); their outputs,
dropped out (`fc_dropout`), go through fc1 and relu, are concatenated
with the user's embedding, and fc2 and relu give the [B, 1, H] state.
The loss is the masked pairwise BCE plus `reg_weight` times the
Frobenius norms of the user and item tables, conv_v, fc1, fc2 and every
conv_h weight (`caser.py:122-140`). The JAX package evaluates the bank
as one windowed einsum (a TPU layout choice); here it is the reference's
Conv2d modules, under the reference's names (`conv_h.{i-1}`, `conv_v`).

The user table is a plain `nn.Embedding`: row 0 is zeroed at init, as in
JAX, but not frozen, since user 0 is a real user of the training split
(`data/pipeline.py`). The forward reads neither the position embeddings
nor the embedding LayerNorm, which stay in the state_dict for the
reference's key layout (JAX's tree has neither).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from bsarec_tpu_torch.core.mesh import reduce_from_group
from bsarec_tpu_torch.models.base import SequentialRecModel
from bsarec_tpu_torch.models.modules import init_linear, make_dropout
from bsarec_tpu_torch.ops.losses import pair_bce_masked


def _init_conv(conv: nn.Conv2d, generator) -> None:
    """Conv2d's default init, drawn from `generator`: weight and bias
    U(-b, b) with b = 1 / sqrt(fan_in) (kaiming-uniform at a = sqrt(5))."""
    fan_in = conv.weight[0].numel()
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        conv.weight.uniform_(-bound, bound, generator=generator)
        conv.bias.uniform_(-bound, bound, generator=generator)


def _frobenius(w: torch.Tensor, group=None) -> torch.Tensor:
    """sqrt(sum(w^2)), JAX's form. `sum` takes a cascaded sum on the CPU;
    `torch.linalg.vector_norm` there accumulates 64M fp32 squares (a 1M x
    64 table) 0.56% short. With `group`, `w` is one shard of a row-sharded
    table and the sum runs over the group's shards."""
    return reduce_from_group(w.square().sum(), group).sqrt()


class CaserModel(SequentialRecModel):
    reads_negatives = True
    reads_users = True

    def loss_name(self, ce: str) -> str:
        return "pair BCE with one sampled negative per sample + reg_weight x Frobenius norms"

    def __init__(self, cfg, generator: torch.Generator | None = None, prng: str = "threefry"):
        super().__init__(cfg, prng)
        seq_len, h = cfg.max_seq_length, cfg.hidden_size
        self.user_embeddings = nn.Embedding(cfg.num_users, h)
        self.conv_v = nn.Conv2d(1, cfg.nv, (seq_len, 1))
        self.conv_h = nn.ModuleList([nn.Conv2d(1, cfg.nh, (i, h)) for i in range(1, seq_len + 1)])
        self.fc1 = nn.Linear(cfg.nv * h + cfg.nh * seq_len, h)
        self.fc2 = nn.Linear(2 * h, h)
        self.fc_dropout = make_dropout(cfg.hidden_dropout_prob, self.dropout_state)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        super().reset_parameters(generator)
        std = self.config.initializer_range
        with torch.no_grad():
            self.user_embeddings.weight.normal_(0.0, std, generator=generator)
            self.user_embeddings.weight[0].zero_()
        _init_conv(self.conv_v, generator)
        for conv in self.conv_h:
            _init_conv(conv, generator)
        init_linear(self.fc1, std, generator)
        init_linear(self.fc2, std, generator)

    def forward(self, input_ids, user_ids=None, all_layers: bool = False):
        b = input_ids.shape[0]
        if user_ids is None:
            user_ids = torch.zeros((b,), dtype=torch.long, device=input_ids.device)
        emb = self.embed_items(input_ids).unsqueeze(1)  # [B, 1, L, H]
        out_v = self.conv_v(emb).reshape(b, -1)  # [B, nv * H], (v, h) order
        out_h = [torch.relu(conv(emb).squeeze(3)).amax(dim=2) for conv in self.conv_h]
        out = self.fc_dropout(torch.cat([out_v, *out_h], dim=1))
        z = torch.relu(self.fc1(out))
        user_emb = self.user_embeddings(user_ids.reshape(-1).long())
        return torch.relu(self.fc2(torch.cat([z, user_emb], dim=1)))[:, None, :]

    def calculate_loss(self, input_ids, answers, neg_answers=None, same_target=None,
                       user_ids=None, *, generator=None):
        seq_out = self.forward(input_ids, user_ids)[:, -1, :]
        loss = pair_bce_masked(*self.pair_logits(seq_out, answers, neg_answers), answers)
        shards = None if self.vocab_mesh is None else self.vocab_mesh.model_group
        reg = sum(_frobenius(w, group) for w, group in (
            (self.user_embeddings.weight, None), (self.item_table, shards),
            (self.conv_v.weight, None), (self.fc1.weight, None), (self.fc2.weight, None)))
        reg_h = sum(_frobenius(conv.weight) for conv in self.conv_h)
        return loss + self.config.reg_weight * reg + self.config.reg_weight * reg_h

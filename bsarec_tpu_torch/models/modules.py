"""Shared transformer building blocks (counterpart of
`bsarec_tpu/models/modules.py`).

Numerics contract (reference: `src/model/_modules.py`):
- LayerNorm is TF-style: biased variance, eps=1e-12 inside the sqrt,
  computed in float32.
- FeedForward: dense(4H) → act → dense(H) → dropout → LN(x + res).
- MultiHeadAttention: post-LN, additive mask, softmax dropout, output
  dense + dropout + LN(x + res), scores scaled by √head_dim.
- GELU is the erf formulation.
- Dense and embedding weights init N(0, initializer_range); biases 0.

Parameter names follow the reference's torch modules, so a port
`state_dict` has the reference key layout.
"""

from __future__ import annotations

import math

import torch
from torch import nn


def erf_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


ACT2FN = {
    "gelu": erf_gelu,
    "relu": torch.relu,
    "swish": lambda x: x * torch.sigmoid(x),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


def init_linear(layer: nn.Linear, std: float, generator: torch.Generator | None) -> None:
    with torch.no_grad():
        layer.weight.normal_(0.0, std, generator=generator)
        layer.bias.zero_()


class TFLayerNorm(nn.Module):
    """LayerNorm with epsilon inside the sqrt (TF style), eps=1e-12,
    computed and returned in float32 whatever the input dtype."""

    def __init__(self, hidden_size: int, eps: float = 1e-12):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(hidden_size))
        self.bias = nn.Parameter(torch.zeros(hidden_size))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        u = x.mean(-1, keepdim=True)
        s = (x - u).pow(2).mean(-1, keepdim=True)
        x = (x - u) * torch.rsqrt(s + self.eps)
        return self.weight * x + self.bias


class FeedForward(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        h = cfg.hidden_size
        self.dense_1 = nn.Linear(h, 4 * h)
        self.act = ACT2FN[cfg.hidden_act]
        self.dense_2 = nn.Linear(4 * h, h)
        self.LayerNorm = TFLayerNorm(h)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def reset_parameters(self, std: float, generator=None) -> None:
        init_linear(self.dense_1, std, generator)
        init_linear(self.dense_2, std, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dense_2(self.act(self.dense_1(x)))
        return self.LayerNorm(self.dropout(h) + x)


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_attention_heads
        self.head_dim = h // self.num_heads
        self.query = nn.Linear(h, h)
        self.key = nn.Linear(h, h)
        self.value = nn.Linear(h, h)
        self.attn_dropout = nn.Dropout(cfg.attention_probs_dropout_prob)
        self.dense = nn.Linear(h, h)
        self.LayerNorm = TFLayerNorm(h)
        self.out_dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def reset_parameters(self, std: float, generator=None) -> None:
        for layer in (self.query, self.key, self.value, self.dense):
            init_linear(layer, std, generator)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        b, seq_len, hidden = x.shape

        def heads(y):  # [B, L, H] -> [B, h, L, d]
            return y.view(b, seq_len, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        scores = q @ k.transpose(-1, -2) / math.sqrt(self.head_dim)
        probs = torch.softmax(scores + attention_mask, dim=-1)
        ctx = self.attn_dropout(probs) @ v
        ctx = ctx.transpose(1, 2).reshape(b, seq_len, hidden)
        out = self.out_dropout(self.dense(ctx))
        return self.LayerNorm(out + x)

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
- The compute dtype policy (`cfg.compute_dtype`, `bsarec_tpu/models/modules.py:73-140`):
  under "bfloat16" every Dense runs on bf16 input, weight and bias and
  gives a bf16 output (`Dense`); the attention scores and the context
  product take bf16 operands with a float32 result; softmax, LayerNorm
  and the residual adds (`h + x` promotes to float32) stay float32, and
  so do the parameters and their gradients. The GELU of a bf16 Dense
  output runs in bf16.

Parameter names follow the reference's torch modules, so a port
`state_dict` has the reference key layout.

Dropout sites are made by `make_dropout`, which picks the path once, when
the model is built: `nn.Dropout`, or the fused CUDA kernel of
`ops/dropout.py` under `--prng rbg` with `BSAREC_DROPOUT=pallas`, as the
JAX package's `FastDropout` picks `pallas_dropout`
(`bsarec_tpu/core/dropout.py:179-190,217`). The fused sites of one model
share a `DropoutState`: the step's seed words and a call index that each
site takes in turn, so every site of a step draws its own mask.
"""

from __future__ import annotations

import math
import os

import torch
from torch import nn

from bsarec_tpu_torch.ops.dropout import DropoutSite, FusedDropoutFn, check_call, check_seeds, dropped
from bsarec_tpu_torch.ops.precision import dense, is_bf16, matmul

# sqrt(2) in bf16, the divisor of a bf16 GELU (JAX divides by
# `jnp.sqrt(2.0).astype(x.dtype)`)
_SQRT2_BF16 = float(torch.tensor(math.sqrt(2.0)).to(torch.bfloat16))


def erf_gelu(x: torch.Tensor) -> torch.Tensor:
    root2 = _SQRT2_BF16 if x.dtype == torch.bfloat16 else math.sqrt(2.0)
    return x * 0.5 * (1.0 + torch.erf(x / root2))


ACT2FN = {
    "gelu": erf_gelu,
    "relu": torch.relu,
    "swish": lambda x: x * torch.sigmoid(x),
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}


class Dense(nn.Linear):
    """nn.Linear under the compute dtype policy: with compute_dtype
    "bfloat16", Flax's `nn.Dense(dtype=bf16)` (`ops.precision.dense`). The
    parameters stay float32 under nn.Linear's names."""

    def __init__(self, in_features: int, out_features: int, compute_dtype: str = "float32"):
        super().__init__(in_features, out_features)
        self.bf16 = is_bf16(compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.bf16)


def init_linear(layer: nn.Linear, std: float, generator: torch.Generator | None) -> None:
    with torch.no_grad():
        layer.weight.normal_(0.0, std, generator=generator)
        layer.bias.zero_()


def use_fused_dropout(prng: str) -> bool:
    """True under `--prng rbg` with `BSAREC_DROPOUT=pallas` in the
    environment, read when the model is built. Under rbg with any other
    strategy the JAX package draws its masks another way; the port then
    uses `nn.Dropout`, the same distribution on torch's own stream."""
    return prng == "rbg" and os.environ.get("BSAREC_DROPOUT", "threshold") == "pallas"


class DropoutState:
    """The fused dropout sites' per-step stream: `seeds`, an int64 [2]
    tensor on the model's device, and the index of the next call. The
    training loop calls `begin_step` before each step's forward, which
    checks the seeds once for all of the step's sites; `plain` runs the
    kernel's plain version on any device (the card's check)."""

    def __init__(self, fused: bool, plain: bool = False):
        self.fused = fused
        self.plain = plain
        self.seeds: torch.Tensor | None = None
        self.call = 0

    def begin_step(self, seeds: torch.Tensor) -> None:
        check_seeds(seeds)
        self.seeds, self.call = seeds, 0

    def next_call(self) -> int:
        if self.seeds is None:
            raise RuntimeError("fused dropout in training mode needs the step's seeds: "
                               "call DropoutState.begin_step(seeds) first")
        call = self.call
        check_call(call)
        self.call = call + 1
        return call


class FusedDropout(nn.Module):
    """Training-mode dropout through the fused kernel; the identity in eval
    mode, like `nn.Dropout`. The rate is checked, and the kernel's
    constants made, once, when the site is built."""

    def __init__(self, rate: float, state: DropoutState):
        super().__init__()
        if not rate >= 0.0:  # NaN fails too
            raise ValueError(f"dropout rate must be >= 0, got {rate}")
        self.rate = rate
        self.state = state
        # rate 0 is the identity and rate >= 1 zeros: neither launches
        self.site = DropoutSite(rate) if 0.0 < rate < 1.0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.site is None:
            return dropped(x)
        state = self.state
        return FusedDropoutFn.apply(x, state.seeds, self.site, state.next_call(), state.plain)

    def extra_repr(self) -> str:
        return f"p={self.rate}, fused"


def make_dropout(rate: float, state: DropoutState) -> nn.Module:
    """A dropout site: fused when `state.fused`, else `nn.Dropout`."""
    return FusedDropout(rate, state) if state.fused else nn.Dropout(rate)


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
    def __init__(self, cfg, dropout_state: DropoutState):
        super().__init__()
        h, dt = cfg.hidden_size, cfg.compute_dtype
        self.dense_1 = Dense(h, 4 * h, dt)
        self.act = ACT2FN[cfg.hidden_act]
        self.dense_2 = Dense(4 * h, h, dt)
        self.LayerNorm = TFLayerNorm(h)
        self.dropout = make_dropout(cfg.hidden_dropout_prob, dropout_state)

    def reset_parameters(self, std: float, generator=None) -> None:
        init_linear(self.dense_1, std, generator)
        init_linear(self.dense_2, std, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dense_2(self.act(self.dense_1(x)))
        return self.LayerNorm(self.dropout(h) + x)


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg, dropout_state: DropoutState):
        super().__init__()
        h, dt = cfg.hidden_size, cfg.compute_dtype
        self.bf16 = is_bf16(dt)
        self.num_heads = cfg.num_attention_heads
        self.head_dim = h // self.num_heads
        self.query = Dense(h, h, dt)
        self.key = Dense(h, h, dt)
        self.value = Dense(h, h, dt)
        self.attn_dropout = make_dropout(cfg.attention_probs_dropout_prob, dropout_state)
        self.dense = Dense(h, h, dt)
        self.LayerNorm = TFLayerNorm(h)
        self.out_dropout = make_dropout(cfg.hidden_dropout_prob, dropout_state)

    def reset_parameters(self, std: float, generator=None) -> None:
        for layer in (self.query, self.key, self.value, self.dense):
            init_linear(layer, std, generator)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        b, seq_len, hidden = x.shape

        def heads(y):  # [B, L, H] -> [B, h, L, d]
            return y.view(b, seq_len, self.num_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        # scores and context: bf16 operands, float32 results under bf16
        scores = matmul(q, k.transpose(-1, -2), self.bf16) / math.sqrt(self.head_dim)
        probs = torch.softmax(scores + attention_mask, dim=-1)
        ctx = matmul(self.attn_dropout(probs), v, self.bf16)
        ctx = ctx.transpose(1, 2).reshape(b, seq_len, hidden)
        out = self.out_dropout(self.dense(ctx))
        return self.LayerNorm(out + x)


class TransformerBlock(nn.Module):
    """Attention, then the FeedForward (`bsarec_tpu/models/modules.py:137-143`).
    The attention is named `layer`, the reference key layout
    (`item_encoder.blocks.{i}.layer.query.weight`, ...)."""

    def __init__(self, cfg, dropout_state: DropoutState):
        super().__init__()
        self.layer = MultiHeadAttention(cfg, dropout_state)
        self.feed_forward = FeedForward(cfg, dropout_state)

    def reset_parameters(self, std: float, generator=None) -> None:
        self.layer.reset_parameters(std, generator)
        self.feed_forward.reset_parameters(std, generator)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        return self.feed_forward(self.layer(x, attention_mask))


class TransformerEncoder(nn.Module):
    """`num_hidden_layers` blocks in a row (`bsarec_tpu/models/modules.py:146-155`):
    TransformerBlocks, or another block class with the same call (BSARec's)."""

    def __init__(self, cfg, dropout_state: DropoutState, block=TransformerBlock):
        super().__init__()
        self.blocks = nn.ModuleList(
            [block(cfg, dropout_state) for _ in range(cfg.num_hidden_layers)])

    def forward(self, x, attention_mask, all_layers: bool = False):
        outputs = [x]
        for block in self.blocks:
            x = block(x, attention_mask)
            outputs.append(x)
        return outputs if all_layers else x

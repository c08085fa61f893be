"""NewRec, the PREPRec model (counterpart of `bsarec_tpu/preprec/models.py`).

Popularity features are gathered outside the model (`popularity.py`) and
passed in as dense inputs, so the parameters hold nothing of the
catalog and a checkpoint transfers across domains as it is.

Parameter names are the reference's torch layout, which the JAX
package's `bsarec_tpu/preprec/torch_import.py:import_newrec` reads:
`embed_layer.fc1/fc2`, optional `fs_layer`, `pos_emb`, `time_pos_emb`,
`attention_layernorms.{i}`, `attention_layers.{i}.{Q_w,K_w,V_w}`,
`forward_layernorms.{i}`, `forward_layers.{i}.{conv1,conv2}` (Conv1d,
k=1, weights [out, in, 1]) and `last_layernorm`. The fixed sinusoid
tables are non-persistent buffers.

Numerics: pre-LN query attention (Q = LN(x), K = V = x), no output
projection, residual Q + attn, LN -> conv FFN (dense, dropout, relu,
dense, dropout, residual), padded positions zeroed after each block,
final LN; masking replaces scores with -(2^32 - 1) on padded query rows
and above the diagonal (a padded query row gets a uniform softmax);
LayerNorm eps = 1e-8.

Init (`init_params`) is the reference's effective scheme: xavier-normal
N(0, 2 / (fan_in + fan_out)) on every parameter of two or more
dimensions, the module defaults on the one-dimensional ones (Linear and
Conv1d biases U(+-1/sqrt(fan_in)), LayerNorm ones and zeros), and
`embed_layer.fc1.bias` zeroed. BSAREC_PREPREC_INIT=torch switches to the
plain module defaults (kaiming-uniform weights, N(0, 1) embeddings).
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from bsarec_tpu_torch.preprec.config import PrepRecConfig
from bsarec_tpu_torch.preprec.popularity import sinusoid_table

NEG_BIG = -(2.0**32) + 1
LN_EPS = 1e-8


def _init_scheme() -> str:
    """"xavier" = the reference's effective scheme; "torch" = plain module defaults."""
    return os.environ.get("BSAREC_PREPREC_INIT", "xavier")


class InitFeedForward(nn.Module):
    """Popularity features -> hidden: fc1, relu, fc2."""

    def __init__(self, hidden1: int, hidden2: int, in_features: int):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden1)
        self.fc2 = nn.Linear(hidden1, hidden2)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class CausalSelfAttention(nn.Module):
    """Causal multi-head attention with no output projection."""

    def __init__(self, hidden: int, heads: int, dropout: float):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        self.Q_w = nn.Linear(hidden, hidden)
        self.K_w = nn.Linear(hidden, hidden)
        self.V_w = nn.Linear(hidden, hidden)
        self.dropout = nn.Dropout(dropout)

    def forward(self, q_in, kv_in, pad_mask):
        """pad_mask: [B, T] True where padding (those query rows are masked)."""
        b, t, _ = q_in.shape
        h, d = self.heads, self.hidden // self.heads

        def split(x):
            return x.reshape(b, t, h, d).transpose(1, 2)

        q, k, v = split(self.Q_w(q_in)), split(self.K_w(kv_in)), split(self.V_w(kv_in))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        causal = torch.ones((t, t), dtype=torch.bool, device=q_in.device).triu(1)
        masked = pad_mask[:, None, :, None] | causal[None, None]
        probs = self.dropout(F.softmax(scores.masked_fill(masked, NEG_BIG), dim=-1))
        return torch.matmul(probs, v).transpose(1, 2).reshape(b, t, self.hidden)


class ConvFFN(nn.Module):
    """The reference's conv1d (k=1) FFN with its internal residual."""

    def __init__(self, hidden: int, dropout: float):
        super().__init__()
        self.conv1 = nn.Conv1d(hidden, hidden, kernel_size=1)
        self.conv2 = nn.Conv1d(hidden, hidden, kernel_size=1)
        self.dropout1 = nn.Dropout(dropout)
        self.dropout2 = nn.Dropout(dropout)

    def forward(self, x):
        h = F.linear(x, self.conv1.weight[:, :, 0], self.conv1.bias)
        h = F.relu(self.dropout1(h))
        h = F.linear(h, self.conv2.weight[:, :, 0], self.conv2.bias)
        return self.dropout2(h) + x


class SASRecBackbone(nn.Module):
    """Pre-LN causal tower. A base class: its modules sit on the model
    itself, in the reference's flat key layout."""

    def _build_backbone(self, hidden: int, blocks: int, heads: int, dropout: float):
        self.attention_layernorms = nn.ModuleList(
            nn.LayerNorm(hidden, eps=LN_EPS) for _ in range(blocks))
        self.attention_layers = nn.ModuleList(
            CausalSelfAttention(hidden, heads, dropout) for _ in range(blocks))
        self.forward_layernorms = nn.ModuleList(
            nn.LayerNorm(hidden, eps=LN_EPS) for _ in range(blocks))
        self.forward_layers = nn.ModuleList(ConvFFN(hidden, dropout) for _ in range(blocks))
        self.last_layernorm = nn.LayerNorm(hidden, eps=LN_EPS)

    def backbone(self, seqs, pad_mask):
        keep = (~pad_mask)[..., None].to(seqs.dtype)
        seqs = seqs * keep
        for ln_a, attn, ln_f, ffn in zip(self.attention_layernorms, self.attention_layers,
                                         self.forward_layernorms, self.forward_layers):
            q = ln_a(seqs)
            seqs = q + attn(q, seqs, pad_mask)
            seqs = ffn(ln_f(seqs)) * keep
        return self.last_layernorm(seqs)


class NewRecModel(SASRecBackbone):
    """PREPRec / NewRec: popularity features in, per-position pairwise
    logits out. Feature gathers happen outside."""

    def __init__(self, cfg: PrepRecConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_units
        self.embed_layer = InitFeedForward(h * 2, h, cfg.input_units1 + cfg.input_units2)
        if cfg.fs_emb:
            # few-shot adapter after the popularity embed, on the sequence
            # path only (not on candidate features)
            self.fs_layer = InitFeedForward(h * 2, h, h)
        if cfg.no_fixed_emb:
            self.pos_emb = nn.Embedding(cfg.maxlen, h)
        if cfg.time_embed and cfg.time_no_fixed_embed:
            self.time_pos_emb = nn.Embedding(cfg.maxlen + 1, h)
        self._build_backbone(h, cfg.num_blocks, cfg.num_heads, cfg.dropout_rate)
        self.register_buffer("position_table", torch.from_numpy(sinusoid_table(cfg.maxlen, h)),
                             persistent=False)
        self.register_buffer("time_table", torch.from_numpy(sinusoid_table(cfg.maxlen + 1, h)),
                             persistent=False)

    def embed_feats(self, feats):
        return self.embed_layer(feats)

    def encode(self, seq_feats, pad_mask, time_embed_ids=None):
        cfg = self.cfg
        seqs = self.embed_layer(seq_feats)
        if cfg.fs_emb:
            seqs = self.fs_layer(seqs)
        t = seqs.shape[1]
        if cfg.no_fixed_emb:
            seqs = seqs + self.pos_emb.weight[:t][None]
        elif not cfg.no_emb:
            seqs = seqs + self.position_table[None, :t]
        if cfg.time_embed and time_embed_ids is not None:
            if cfg.time_no_fixed_embed:
                te = self.time_pos_emb(time_embed_ids)
            else:
                te = self.time_table[time_embed_ids]
            if cfg.time_embed_concat:
                # interleave (seq, time) along the time axis
                seqs = torch.stack([seqs, te], dim=2).reshape(seqs.shape[0], -1, seqs.shape[2])
                pad_mask = pad_mask.repeat_interleave(2, dim=1)
            else:
                seqs = seqs + te
        out = self.backbone(seqs, pad_mask)
        if cfg.time_embed and cfg.time_embed_concat:
            out = out[:, 0::2]
        return out

    def forward(self, seq_feats, pad_mask, pos_feats, neg_feats, time_embed_ids=None):
        feats = self.encode(seq_feats, pad_mask, time_embed_ids)
        pos_logits = (feats * self.embed_feats(pos_feats)).sum(-1)
        neg_logits = (feats * self.embed_feats(neg_feats)).sum(-1)
        return pos_logits, neg_logits, feats

    def predict(self, seq_feats, pad_mask, cand_feats, time_embed_ids=None):
        """cand_feats: [B, C, F] popularity features of candidates -> [B, C]."""
        final = self.encode(seq_feats, pad_mask, time_embed_ids)[:, -1, :]
        return torch.einsum("bcf,bf->bc", self.embed_feats(cand_feats), final)


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter from `generator` by the scheme of the module
    docstring, then zero `embed_layer.fc1.bias`."""
    xavier = _init_scheme() == "xavier"
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv1d)):
            w = mod.weight
            fan_in, fan_out = w.shape[1] * w[0, 0].numel(), w.shape[0] * w[0, 0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            if xavier:
                w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)
            else:
                w.uniform_(-bound, bound, generator=generator)
            mod.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(mod, nn.Embedding):
            if xavier:
                std = math.sqrt(2.0 / (mod.weight.shape[0] + mod.weight.shape[1]))
                mod.weight.normal_(0.0, std, generator=generator)
            else:
                mod.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    model.embed_layer.fc1.bias.zero_()


PREPREC_REGISTRY = {"newrec": NewRecModel}

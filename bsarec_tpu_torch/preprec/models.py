"""The PREPRec model family (counterpart of `bsarec_tpu/preprec/models.py`).

Six models: NewRec (PREPRec itself) and NewB4Rec read popularity
features, which are gathered outside the model (`popularity.py`) and
passed in as dense inputs, so their parameters hold nothing of the
catalog and a checkpoint transfers across domains as it is; SASRecB,
BERT4RecB, BPRMF and CL4SRec are the reference's id-embedding baselines.

Parameter names are the reference's torch layout, which the JAX
package's `bsarec_tpu/preprec/torch_import.py` reads: `embed_layer.fc1/fc2`,
optional `fs_layer`, `item_emb`, `user_emb`, `pos_emb`, `time_pos_emb`;
the SASRec tower's `attention_layernorms.{i}`,
`attention_layers.{i}.{Q_w,K_w,V_w}`, `forward_layernorms.{i}`,
`forward_layers.{i}.{conv1,conv2}` (Conv1d, k=1, weights [out, in, 1]) and
`last_layernorm`; the BERT-style blocks' `attention_layernorms.{i}`,
`attention_layers.{i}.linear_layers.{0,1,2}`,
`attention_layers.{i}.output_linear`, `forward_layernorms.{i}`,
`forward_layers.{i}.{w_1,w_2}` and `out`. The fixed sinusoid tables are
non-persistent buffers.

Numerics of the SASRec tower (NewRec, SASRecB, CL4SRec): pre-LN query
attention (Q = LN(x), K = V = x), no output projection, residual Q + attn,
LN -> conv FFN (dense, dropout, relu, dense, dropout, residual), padded
positions zeroed after each block, final LN; masking replaces scores with
-(2^32 - 1) on padded query rows and above the diagonal (a padded query
row gets a uniform softmax); LayerNorm eps = 1e-8.

Numerics of the BERT-style blocks (BERT4RecB, NewB4Rec): q = LN(x),
x = q + attn(q) (bidirectional, keys that are not real tokens replaced by
-1e9, an output linear), x = LN(x), x = FFN(x) with no residual around
the FFN (w_1, the tanh GELU written out, dropout, w_2), then `out`.
Masked positions carry token 0, so they are invalid keys. NewB4Rec adds
its fixed positions (the reference's `log2feats` overwrites the embedded
sequence with them, which the JAX package documents as a typo and does
not copy; neither does the port) and ends in the tanh GELU.

Init (`init_params`) is the reference's effective scheme: xavier-normal
N(0, 2 / (fan_in + fan_out)) on every parameter of two or more
dimensions, the module defaults on the one-dimensional ones (Linear and
Conv1d biases U(+-1/sqrt(fan_in)), LayerNorm ones and zeros), row 0 of
the item tables that the reference pads (`zero_pad_tables`) zeroed, and
NewRec's `embed_layer.fc1.bias` zeroed. BSAREC_PREPREC_INIT=torch switches
to the plain module defaults (kaiming-uniform weights, N(0, 1) embeddings).
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from bsarec_tpu_torch.ops.losses import info_nce_logits
from bsarec_tpu_torch.preprec.config import PrepRecConfig
from bsarec_tpu_torch.preprec.popularity import sinusoid_table

NEG_BIG = -(2.0**32) + 1
BERT_NEG = -1e9
LN_EPS = 1e-8
GELU_C = math.sqrt(2 / math.pi)


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


def tanh_gelu(x):
    """The tanh GELU, written out as the reference writes it."""
    return 0.5 * x * (1 + torch.tanh(GELU_C * (x + 0.044715 * x**3)))


class BidirAttention(nn.Module):
    """BERT-style multi-head attention with an output linear."""

    def __init__(self, hidden: int, heads: int, dropout: float):
        super().__init__()
        self.hidden, self.heads = hidden, heads
        self.linear_layers = nn.ModuleList(nn.Linear(hidden, hidden) for _ in range(3))
        self.output_linear = nn.Linear(hidden, hidden)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x, key_valid):
        """key_valid: [B, T] True where a real token."""
        b, t, _ = x.shape
        h, d = self.heads, self.hidden // self.heads
        q, k, v = (lin(x).reshape(b, t, h, d).transpose(1, 2) for lin in self.linear_layers)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(d)
        scores = scores.masked_fill(~key_valid[:, None, None, :], BERT_NEG)
        probs = self.dropout(F.softmax(scores, dim=-1))
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, t, self.hidden)
        return self.output_linear(out)


class GeluFFN(nn.Module):
    """The 4x FFN with the tanh GELU, and no residual."""

    def __init__(self, hidden: int, dropout: float):
        super().__init__()
        self.w_1 = nn.Linear(hidden, 4 * hidden)
        self.w_2 = nn.Linear(4 * hidden, hidden)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x):
        return self.w_2(self.dropout(tanh_gelu(self.w_1(x))))


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


class BertBlocks(nn.Module):
    """The BERT-style blocks and their `out` dense. A base class, as
    `SASRecBackbone`."""

    def _build_blocks(self, hidden: int, blocks: int, heads: int, dropout: float):
        self.attention_layernorms = nn.ModuleList(
            nn.LayerNorm(hidden, eps=LN_EPS) for _ in range(blocks))
        self.attention_layers = nn.ModuleList(
            BidirAttention(hidden, heads, dropout) for _ in range(blocks))
        self.forward_layernorms = nn.ModuleList(
            nn.LayerNorm(hidden, eps=LN_EPS) for _ in range(blocks))
        self.forward_layers = nn.ModuleList(GeluFFN(hidden, dropout) for _ in range(blocks))
        self.out = nn.Linear(hidden, hidden)

    def blocks(self, seqs, valid):
        for ln_a, attn, ln_f, ffn in zip(self.attention_layernorms, self.attention_layers,
                                         self.forward_layernorms, self.forward_layers):
            q = ln_a(seqs)
            seqs = ffn(ln_f(q + attn(q, valid)))
        return self.out(seqs)


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


class IdSequenceModel(SASRecBackbone):
    """The id-embedding SASRec tower shared by SASRecB and CL4SRec: item
    embeddings scaled by sqrt(hidden) plus learned positions, dropout,
    the tower."""

    zero_pad_tables = ("item_emb",)

    def __init__(self, cfg: PrepRecConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_units
        self.item_emb = nn.Embedding(cfg.itemnum + 1, h)
        self.pos_emb = nn.Embedding(cfg.maxlen, h)
        self.emb_dropout = nn.Dropout(cfg.dropout_rate)
        self._build_backbone(h, cfg.num_blocks, cfg.num_heads, cfg.dropout_rate)

    def encode(self, log_seqs):
        seqs = self.item_emb(log_seqs) * math.sqrt(self.cfg.hidden_units)
        seqs = self.emb_dropout(seqs + self.pos_emb.weight[:log_seqs.shape[1]][None])
        return self.backbone(seqs, log_seqs == 0)

    def pair_logits(self, log_seqs, pos_seqs, neg_seqs):
        feats = self.encode(log_seqs)
        return (feats * self.item_emb(pos_seqs)).sum(-1), (feats * self.item_emb(neg_seqs)).sum(-1)

    def predict(self, log_seqs, item_indices):
        final = self.encode(log_seqs)[:, -1, :]
        return torch.einsum("bcf,bf->bc", self.item_emb(item_indices), final)


class SASRecB(IdSequenceModel):
    """The reference's pmixer SASRec: per-position pairwise BCE."""

    def forward(self, log_seqs, pos_seqs, neg_seqs):
        return self.pair_logits(log_seqs, pos_seqs, neg_seqs)


class CL4SRec(IdSequenceModel):
    """SASRecB's tower plus the InfoNCE of two augmented views (made on
    the host by `sampler.augment_batch`): dot similarity, temperature 1."""

    def forward(self, log_seqs, aug1, aug2, pos_seqs, neg_seqs):
        pos_logits, neg_logits = self.pair_logits(log_seqs, pos_seqs, neg_seqs)
        z1 = self.encode(aug1)[:, -1, :]
        z2 = self.encode(aug2)[:, -1, :]
        return pos_logits, neg_logits, info_nce_logits(z1, z2, temp=1.0, sim="dot")


class BERT4RecB(BertBlocks):
    """The reference's BERT4Rec: cloze with token 0 as the mask,
    full-vocabulary CE (ignore_index 0)."""

    zero_pad_tables = ("item_emb",)

    def __init__(self, cfg: PrepRecConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_units
        self.item_emb = nn.Embedding(cfg.itemnum + 1, h)
        self.pos_emb = nn.Embedding(cfg.maxlen, h)
        self.emb_dropout = nn.Dropout(cfg.dropout_rate)
        self._build_blocks(h, cfg.num_blocks, cfg.num_heads, cfg.dropout_rate)

    def encode(self, log_seqs):
        seqs = self.item_emb(log_seqs) * math.sqrt(self.cfg.hidden_units)
        seqs = self.emb_dropout(seqs + self.pos_emb.weight[:log_seqs.shape[1]][None])
        return self.blocks(seqs, log_seqs > 0)

    def forward(self, log_seqs):
        """Full-vocabulary logits at every position: [B, T, V+1]."""
        return torch.matmul(self.encode(log_seqs), self.item_emb.weight.T)

    def predict(self, log_seqs, candidates):
        return torch.gather(self(log_seqs)[:, -1, :], 1, candidates)


class NewB4Rec(BertBlocks):
    """The popularity-encoded BERT4Rec, trained with a sampled softmax
    over `itemnum // loss_size` random candidates a position."""

    def __init__(self, cfg: PrepRecConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_units
        self.embed_layer = InitFeedForward(h * 2, h, cfg.input_units1 + cfg.input_units2)
        if cfg.no_fixed_emb:
            self.pos_emb = nn.Embedding(cfg.maxlen, h)
        self._build_blocks(h, cfg.num_blocks, cfg.num_heads, cfg.dropout_rate)
        self.register_buffer("position_table", torch.from_numpy(sinusoid_table(cfg.maxlen, h)),
                             persistent=False)

    def embed_feats(self, feats):
        return self.embed_layer(feats)

    def encode(self, seq_feats, valid):
        seqs = self.embed_layer(seq_feats)
        t = seqs.shape[1]
        if self.cfg.no_fixed_emb:
            seqs = seqs + self.pos_emb.weight[:t][None]
        else:
            seqs = seqs + self.position_table[None, :t]  # added, not overwritten
        return tanh_gelu(self.blocks(seqs, valid))

    def forward(self, seq_feats, valid, cand_feats):
        """cand_feats: [B, T, C, F] -> raw candidate logits [B, T, C]. The
        trainer's loss takes the log-softmax over the time axis first
        (`train.newb4rec_ce`)."""
        feats = self.encode(seq_feats, valid)
        return torch.einsum("btcf,btf->btc", self.embed_layer(cand_feats), feats)

    def predict(self, seq_feats, valid, cand_feats):
        """cand_feats: [B, C, F] candidates at the last position -> [B, C]."""
        feats = self.encode(seq_feats, valid)[:, -1, :]
        return torch.einsum("bcf,bf->bc", self.embed_layer(cand_feats), feats)


class BPRMF(nn.Module):
    """Matrix factorisation with the BPR loss. Its tables keep row 0."""

    def __init__(self, cfg: PrepRecConfig):
        super().__init__()
        self.cfg = cfg
        self.user_emb = nn.Embedding(cfg.usernum + 1, cfg.hidden_units)
        self.item_emb = nn.Embedding(cfg.itemnum + 1, cfg.hidden_units)

    def forward(self, users, pos_items, neg_items):
        u = self.user_emb(users)  # [B, H]
        return (torch.einsum("bsh,bh->bs", self.item_emb(pos_items), u),
                torch.einsum("bsh,bh->bs", self.item_emb(neg_items), u))

    def predict(self, users, item_indices):
        return torch.einsum("bch,bh->bc", self.item_emb(item_indices), self.user_emb(users))


@torch.no_grad()
def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter from `generator` by the scheme of the module
    docstring, then zero row 0 of `zero_pad_tables` and NewRec's
    `embed_layer.fc1.bias`."""
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
    for name in getattr(model, "zero_pad_tables", ()):
        getattr(model, name).weight[0] = 0.0
    if isinstance(model, NewRecModel):
        model.embed_layer.fc1.bias.zero_()


PREPREC_REGISTRY = {
    "newrec": NewRecModel,
    "newb4rec": NewB4Rec,
    "sasrec": SASRecB,
    "bert4rec": BERT4RecB,
    "bprmf": BPRMF,
    "cl4srec": CL4SRec,
}

"""Abstract sequential-recommendation model (counterpart of
`bsarec_tpu/models/base.py`).

Item and position embeddings, the embedding LayerNorm and dropout, and
the `predict` / `item_table` / `calculate_loss` surface of the eval and
training loops. The item table has `vocab_rows()` rows (BERT4Rec adds a
[mask] row) and `padding_idx=0`: row 0 is zero at init and lookups
(`embed_items`) do not update it, while the tied full-catalog CE of
training does (`bsarec_tpu/models/base.py:12-15`).
Under `--mesh` with a vocab-sharded table (`shard_item_table`) the item
table holds this rank's rows only: `item_table` is the shard and
`embed_items` the sharded lookup (`parallel/embedding.py`).
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
from bsarec_tpu_torch.ops.masks import bidirectional_additive_mask, causal_additive_mask


class SequentialRecModel(nn.Module):
    # whether calculate_loss reads the sampled negatives (the training
    # epoch draws them only for such models)
    reads_negatives = False
    # whether the model reads the user ids (Caser): the training epoch
    # gathers them only then, and the serving artifact then checks them
    reads_users = False
    # whether calculate_loss reads the same-target view (DuoRec, FEARec):
    # the trainer draws one per epoch only for such models
    reads_same_target = False

    def __init__(self, cfg, prng: str = "threefry"):
        super().__init__()
        self.config = cfg
        self.dropout_state = DropoutState(fused=use_fused_dropout(prng))
        self.item_embeddings = nn.Embedding(self.vocab_rows(), cfg.hidden_size, padding_idx=0)
        self.position_embeddings = nn.Embedding(cfg.max_seq_length, cfg.hidden_size)
        self.LayerNorm = TFLayerNorm(cfg.hidden_size)
        self.dropout = make_dropout(cfg.hidden_dropout_prob, self.dropout_state)
        # the mesh whose model group holds the item table's shards, or None
        self.vocab_mesh = None

    def loss_name(self, ce: str) -> str:
        """The training loss, for the log; `ce` names the full-catalog CE
        as the trainer runs it."""
        return ce

    def vocab_rows(self) -> int:
        """Item-table row count (BERT4Rec adds a [mask] row)."""
        return self.config.item_size

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
        """The [V, H] item table, or this rank's [V / m, H] shard of it."""
        return self.item_embeddings.weight

    def shard_item_table(self, mesh) -> None:
        """Keep this rank's rows of the item table, [model_rank * rows,
        (model_rank + 1) * rows) with rows = V / m, as a new parameter."""
        rows = self.vocab_rows() // mesh.model
        start = mesh.model_rank * rows
        full = self.item_embeddings.weight.detach()
        self.item_embeddings.weight = nn.Parameter(full[start:start + rows].clone())
        self.item_embeddings.num_embeddings = rows
        self.vocab_mesh = mesh

    def embed_items(self, ids: torch.Tensor) -> torch.Tensor:
        """Item rows; lookups of id 0 send no gradient to row 0."""
        if self.vocab_mesh is not None:
            from bsarec_tpu_torch.parallel.embedding import sharded_embedding_lookup

            return sharded_embedding_lookup(self.item_table, ids, self.vocab_mesh)
        return self.item_embeddings(ids.long())

    def add_position_embedding(self, input_ids: torch.Tensor) -> torch.Tensor:
        pos = self.position_embeddings.weight[: input_ids.shape[-1]]
        emb = self.embed_items(input_ids) + pos[None]
        return self.dropout(self.LayerNorm(emb))

    @staticmethod
    def get_attention_mask(input_ids):
        return causal_additive_mask(input_ids)

    @staticmethod
    def get_bi_attention_mask(input_ids):
        return bidirectional_additive_mask(input_ids)

    def pair_logits(self, seq_out: torch.Tensor, answers: torch.Tensor,
                    neg_answers: torch.Tensor | None):
        """(positive, negative) dot products of the [B, H] states with the
        answers' and the sampled negatives' rows, for the pairwise losses."""
        if neg_answers is None:
            raise ValueError(f"{type(self).__name__}'s loss reads one sampled negative per sample")
        pos = (self.embed_items(answers) * seq_out).sum(-1)
        neg = (self.embed_items(neg_answers) * seq_out).sum(-1)
        return pos, neg

    def forward(self, input_ids, user_ids=None, all_layers: bool = False):
        raise NotImplementedError

    def predict(self, input_ids, user_ids=None) -> torch.Tensor:
        """Eval-time forward; returns [B, L, H] (the eval loop takes [:, -1])."""
        return self.forward(input_ids, user_ids)

    def calculate_loss(self, input_ids, answers, neg_answers=None, same_target=None,
                       user_ids=None, *, generator: torch.Generator | None = None) -> torch.Tensor:
        """Scalar training loss of one batch, in the JAX signature
        (`bsarec_tpu/models/base.py:121`): `neg_answers` [B] are the sampled
        negatives (read by models with `reads_negatives`), `same_target`
        [B, L] the same-target view (DuoRec, FEARec), `user_ids` [B] the
        users (Caser). `generator`, on the batch's device, draws what the
        loss itself samples (BERT4Rec's cloze positions); None takes
        torch's default generator."""
        raise NotImplementedError

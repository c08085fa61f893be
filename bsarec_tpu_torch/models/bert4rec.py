"""BERT4Rec (counterpart of `bsarec_tpu/models/bert4rec.py`).

A bidirectional TransformerEncoder (reference: `src/model/bert4rec.py`).
The item table gains a [mask] row, id `item_size`. Training replaces
`int(L * mask_ratio)` distinct positions of every row, drawn uniformly,
with the mask token (`cloze_mask`), and takes the full-catalog CE of the
last position's state against the answer over all `item_size + 1` rows,
as the JAX package does (`bert4rec.py:40-54`; the reference's cloze loss
is overwritten there, so only this one counts). The draw includes
padded positions: their 0 becomes the mask token and so a key that the
bidirectional mask lets through, as in JAX. The positions come from the
generator the training loop passes, torch's stream rather than JAX's.
`predict` appends the mask token and drops the first position
(`reconstruct_test_data`); eval ranks `table[:item_size]`.
"""

from __future__ import annotations

import torch

from bsarec_tpu_torch.core.mesh import global_rows
from bsarec_tpu_torch.models.base import SequentialRecModel
from bsarec_tpu_torch.models.modules import TransformerEncoder
from bsarec_tpu_torch.ops.losses import full_softmax_ce


def cloze_mask(input_ids: torch.Tensor, mask_num: int, mask_token: int,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """`input_ids` with `mask_num` distinct positions per row, uniform over
    all L positions (padding included), set to `mask_token`: the first
    `mask_num` entries of a random permutation per row, read off the
    argsort of [B, L] uniform draws from `generator`. Under a mesh with
    data ranks the draw is the global batch's and this rank keeps its
    rows, so the positions are the single run's."""
    b, seq_len = input_ids.shape
    rows, mine = global_rows(b)
    noise = torch.rand((rows, seq_len), generator=generator, device=input_ids.device)[mine]
    positions = noise.argsort(dim=1)[:, :mask_num]
    return input_ids.scatter(1, positions, mask_token)


class BERT4RecModel(SequentialRecModel):
    def loss_name(self, ce: str) -> str:
        return f"{ce} on cloze-masked inputs"

    def __init__(self, cfg, generator: torch.Generator | None = None, prng: str = "threefry"):
        super().__init__(cfg, prng)
        self.item_encoder = TransformerEncoder(cfg, self.dropout_state)
        self.reset_parameters(generator)

    def vocab_rows(self) -> int:
        return self.config.item_size + 1  # + [mask]

    @property
    def mask_token(self) -> int:
        return self.config.item_size

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        super().reset_parameters(generator)
        for block in self.item_encoder.blocks:
            block.reset_parameters(self.config.initializer_range, generator)

    def forward(self, input_ids, user_ids=None, all_layers: bool = False):
        mask = self.get_bi_attention_mask(input_ids)
        x = self.add_position_embedding(input_ids)
        return self.item_encoder(x, mask, all_layers=all_layers)

    def calculate_loss(self, input_ids, answers, neg_answers=None, same_target=None,
                       user_ids=None, *, generator=None):
        cfg = self.config
        mask_num = int(cfg.max_seq_length * cfg.mask_ratio)
        masked_ids = cloze_mask(input_ids, mask_num, self.mask_token, generator)
        seq_output = self.forward(masked_ids)
        return full_softmax_ce(seq_output[:, -1, :], self.item_table, answers,
                               impl=cfg.loss_impl, dtype=cfg.compute_dtype)

    def predict(self, input_ids, user_ids=None):
        pad = torch.full((input_ids.shape[0], 1), self.mask_token, dtype=input_ids.dtype,
                         device=input_ids.device)
        return self.forward(torch.cat([input_ids, pad], dim=-1)[:, 1:])

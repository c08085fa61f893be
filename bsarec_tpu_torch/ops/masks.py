"""Additive attention masks (counterpart of `bsarec_tpu/ops/masks.py`).

Masks are additive: 0 where attention is allowed and -10000 (not -inf)
where not (reference: `src/model/_abstract_model.py:41-69`). Padding
positions (item id 0) are always disallowed as keys; the causal variant
also disallows future positions; the bidirectional one (BERT4Rec) only
the padding keys.
"""

from __future__ import annotations

import torch

NEG_INF = -10000.0


def causal_additive_mask(input_ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, L] int ids -> [B, 1, L, L] additive mask (0 keep / -1e4 drop)."""
    valid = (input_ids > 0).to(dtype)  # [B, L] keys
    seq_len = input_ids.shape[-1]
    causal = torch.tril(torch.ones(seq_len, seq_len, dtype=dtype, device=input_ids.device))
    keep = valid[:, None, None, :] * causal[None, None, :, :]
    return (1.0 - keep) * NEG_INF


def bidirectional_additive_mask(input_ids: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[B, L] int ids -> [B, 1, 1, L] additive padding mask."""
    valid = (input_ids > 0).to(dtype)
    return (1.0 - valid[:, None, None, :]) * NEG_INF

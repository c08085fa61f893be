"""Training losses (counterpart of `bsarec_tpu/ops/losses.py`).

The full-catalog softmax cross-entropy of BSARec and SASRec's pairwise
BCE are ported; the zoo's other losses wait for ROADMAP A9.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bsarec_tpu_torch.ops.ce import streaming_softmax_ce

# From this catalog size on (and on CUDA) "auto" replaces the dense [B, V]
# logits with the streaming CE kernels: memory O(B) and one table read per
# pass instead of B * V * 4 bytes of logits.
STREAMING_CE_MIN_VOCAB = 262_144


def resolve_loss_impl(impl: str, item_size: int, device: torch.device) -> str:
    """"dense" or "streaming" for the requested `loss_impl`."""
    if impl == "auto":
        big = item_size >= STREAMING_CE_MIN_VOCAB and device.type == "cuda"
        return "streaming" if big else "dense"
    if impl not in ("dense", "streaming"):
        raise NotImplementedError(f"loss_impl {impl!r} is not ported yet (ROADMAP A12)")
    return impl


def full_softmax_ce(seq_state: torch.Tensor, item_table: torch.Tensor, answers: torch.Tensor,
                    impl: str = "auto", dtype: str = "float32") -> torch.Tensor:
    """Mean full-catalog CE (reference: `src/model/bsarec.py:30-37`).

    seq_state [B, H] last-position states, item_table [V, H], answers [B]
    item ids. `impl`: "dense" (the [B, V] logits and logsumexp, which the
    JAX package leaves to XLA), "streaming" (`ops/ce.py`), or "auto"
    (streaming from 262,144 items on, on CUDA). Only float32 is ported."""
    if dtype != "float32":
        raise NotImplementedError(f"CE compute dtype {dtype!r} is not ported yet; use float32")
    if resolve_loss_impl(impl, item_table.shape[0], item_table.device) == "streaming":
        return streaming_softmax_ce(seq_state, item_table, answers).mean()
    logits = seq_state @ item_table.T
    gold = logits.gather(1, answers.long()[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


def pair_bce_masked(pos_logits: torch.Tensor, neg_logits: torch.Tensor,
                    pos_ids: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits on (positive, negative) pairs over the rows whose
    positive id is not 0 (`bsarec_tpu/ops/losses.py:75-87`; reference
    `src/model/sasrec.py:42-63`): the masked means of softplus(-pos) and
    softplus(neg), summed."""
    valid = (pos_ids != 0).float()
    denom = valid.sum().clamp(min=1.0)
    pos_loss = (F.softplus(-pos_logits) * valid).sum() / denom
    neg_loss = (F.softplus(neg_logits) * valid).sum() / denom
    return pos_loss + neg_loss

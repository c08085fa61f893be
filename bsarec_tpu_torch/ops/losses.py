"""Training losses (counterpart of `bsarec_tpu/ops/losses.py`).

The full-catalog softmax cross-entropy (BSARec, BERT4Rec, DuoRec,
FEARec), the masked pairwise BCE (SASRec, Caser), FMLP-Rec's unmasked
log-sigmoid BCE, GRU4Rec's BPR loss and the contrastive models' in-batch
InfoNCE.

Under a mesh (`core/mesh.py`) each data rank computes its own rows'
loss and the training loop averages the gradients over the data group.
That is exact for a mean over equal counts a rank (the CE, FMLP-Rec's
BCE, BPR, FEARec's spectral term). The two losses whose denominator or
whose terms depend on the whole batch take it over the data group: the
masked BCE's valid count, and InfoNCE's batch, whose views are gathered
(`bsarec_tpu/ops/losses.py:53-63,83-103`, where XLA sees the global
batch).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bsarec_tpu_torch.core import mesh as meshlib
from bsarec_tpu_torch.ops.ce import streaming_softmax_ce
from bsarec_tpu_torch.ops.precision import is_bf16, matmul

# From this catalog size on (and on CUDA) "auto" replaces the dense [B, V]
# logits with the streaming CE kernels: memory O(B) and one table read per
# pass instead of B * V * 4 bytes of logits.
STREAMING_CE_MIN_VOCAB = 262_144


# the impls over a vocab-sharded table (`parallel/logits.py`), which the
# Trainer picks under a mesh: the streaming kernels per shard, or each
# shard's dense logits
SHARDED_IMPLS = ("sharded_streaming", "sharded_dense")


def resolve_loss_impl(impl: str, item_size: int, device: torch.device) -> str:
    """"dense", "streaming" or a sharded impl for the requested `loss_impl`."""
    if impl == "auto":
        big = item_size >= STREAMING_CE_MIN_VOCAB and device.type == "cuda"
        return "streaming" if big else "dense"
    if impl not in ("dense", "streaming", *SHARDED_IMPLS):
        raise NotImplementedError(f"loss_impl {impl!r} is not ported")
    return impl


def full_softmax_ce(seq_state: torch.Tensor, item_table: torch.Tensor, answers: torch.Tensor,
                    impl: str = "auto", dtype: str = "float32") -> torch.Tensor:
    """Mean full-catalog CE (reference: `src/model/bsarec.py:30-37`).

    seq_state [B, H] last-position states, item_table [V, H], answers [B]
    item ids. `impl`: "dense" (the [B, V] logits and logsumexp, which the
    JAX package leaves to XLA), "streaming" (`ops/ce.py`), or "auto"
    (streaming from 262,144 items on, on CUDA). "sharded_streaming" and
    "sharded_dense" take `item_table` as this rank's shard of a
    vocab-sharded table on the active mesh (`parallel/logits.py`; no
    active mesh raises). `dtype` is the matmul
    compute dtype (`bsarec_tpu/ops/losses.py:21-72`): under "bfloat16" the
    logits are the float32 product of bf16-rounded operands (the
    streaming kernels' bf16-operand form on that path); logsumexp and the
    gold logit stay float32."""
    bf16 = is_bf16(dtype)
    impl = resolve_loss_impl(impl, item_table.shape[0], item_table.device)
    if impl in SHARDED_IMPLS:
        from bsarec_tpu_torch.parallel import logits as plogits

        mesh = meshlib.active_mesh()
        if impl == "sharded_streaming":
            return plogits.sharded_streaming_ce(seq_state, item_table, answers, mesh,
                                                dtype=dtype).mean()
        return plogits.sharded_softmax_ce(seq_state, item_table, answers, mesh, dtype).mean()
    if impl == "streaming":
        return streaming_softmax_ce(seq_state, item_table, answers, dtype=dtype).mean()
    logits = matmul(seq_state, item_table.T, bf16)
    gold = logits.gather(1, answers.long()[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - gold).mean()


def pair_bce_masked(pos_logits: torch.Tensor, neg_logits: torch.Tensor,
                    pos_ids: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits on (positive, negative) pairs over the rows whose
    positive id is not 0 (`bsarec_tpu/ops/losses.py:75-87`; reference
    `src/model/sasrec.py:42-63`): the masked means of softplus(-pos) and
    softplus(neg), summed. Under a mesh with data ranks the count is the
    global batch's, divided by the number of data ranks, so that the
    loop's average over them gives the global masked mean."""
    valid = (pos_ids != 0).float()
    denom = valid.sum().clamp(min=1.0)
    mesh = meshlib.current_mesh()
    if mesh is not None and mesh.data > 1:
        denom = meshlib.all_reduce_sum(valid.sum(), mesh.data_group).clamp(min=1.0) / mesh.data
    pos_loss = (F.softplus(-pos_logits) * valid).sum() / denom
    neg_loss = (F.softplus(neg_logits) * valid).sum() / denom
    return pos_loss + neg_loss


def pair_logsigmoid_bce(pos_logits: torch.Tensor, neg_logits: torch.Tensor,
                        eps: float = 1e-24) -> torch.Tensor:
    """FMLP-Rec's unmasked sigmoid BCE (`bsarec_tpu/ops/losses.py:90-94`;
    reference `src/model/fmlprec.py:54-59`): every row counts, padded
    answers included, and eps guards the logs."""
    pos = -torch.log(torch.sigmoid(pos_logits) + eps)
    neg = -torch.log(1.0 - torch.sigmoid(neg_logits) + eps)
    return (pos + neg).mean()


def bpr_loss(pos_logits: torch.Tensor, neg_logits: torch.Tensor,
             gamma: float = 1e-10) -> torch.Tensor:
    """GRU4Rec's BPR loss, -mean log(gamma + sigmoid(pos - neg))
    (`bsarec_tpu/ops/losses.py:97-99`; reference `src/model/gru4rec.py:49-67`)."""
    return -torch.log(gamma + torch.sigmoid(pos_logits - neg_logits)).mean()


def info_nce_logits(z_i: torch.Tensor, z_j: torch.Tensor, temp: float,
                    sim: str = "dot") -> torch.Tensor:
    """In-batch InfoNCE over two views (`bsarec_tpu/ops/losses.py:102-124`;
    reference `src/model/duorec.py:47-74`).

    z_i, z_j: [B, H] states of the two views. Each of the 2B rows of
    z = [z_i; z_j] has its pair as the positive and the other 2(B - 1)
    rows as negatives: the [2B, 2B] similarities divided by `temp`, the
    diagonal set to -inf (self excluded), and the mean of logZ - positive.
    `sim` is "dot" or "cos" (rows scaled to unit norm, clipped at 1e-12).
    Under a mesh with data ranks, the views are every data rank's rows,
    gathered in rank order (the global batch), and every rank takes the
    whole loss; the gather's backward sums the ranks' gradients of each
    rank's rows, which the loop's average over the ranks then divides."""
    mesh = meshlib.current_mesh()
    if mesh is not None and mesh.data > 1:
        z_i = meshlib.gather_summed(z_i, mesh.data_group).flatten(0, 1)
        z_j = meshlib.gather_summed(z_j, mesh.data_group).flatten(0, 1)
    z = torch.cat([z_i, z_j], dim=0)
    if sim == "cos":
        z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp(min=1e-12)
    sims = (z @ z.T) / temp
    n = z.shape[0]
    b = n // 2
    idx = torch.arange(n, device=z.device)
    pos = sims[idx, torch.where(idx < b, idx + b, idx - b)]
    eye = torch.eye(n, dtype=torch.bool, device=z.device)
    sims = sims.masked_fill(eye, float("-inf"))
    return (torch.logsumexp(sims, dim=-1) - pos).mean()

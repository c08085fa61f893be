"""Dense full-catalog ranking (counterpart of `bsarec_tpu/ops/topk.py`).

Seen items score 0.0, not -inf (the reference's `rating_pred[seen] = 0`,
`src/trainers.py:134`). Ties go to the smallest item id, as
`jax.lax.top_k` orders them: the top-k is read off a stable descending
sort, because `torch.topk` promises no order among equal scores.
"""

from __future__ import annotations

import torch

EVAL_KS = (5, 10, 15, 20)
TOP_K = 20


def stable_topk(x: torch.Tensor, k: int):
    """Top k along the last dim, ordered by (value desc, index asc), as
    `jax.lax.top_k` orders ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def masked_topk(scores: torch.Tensor, seen_items: torch.Tensor, k: int = TOP_K):
    """scores: [B, V]; seen_items: [B, S] int ids, 0-padded (item 0 is the
    padding id, so pad entries re-zero column 0). Returns (values [B, k],
    ids [B, k] int64), ordered by (value descending, id ascending)."""
    return stable_topk(scores.scatter(1, seen_items.long(), 0.0), k)


def topk_metrics(topk_idx: torch.Tensor, answers: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-batch metric sums for HR@k / NDCG@k, k in EVAL_KS.

    topk_idx: [B, 20] ranked item ids; answers: [B]; valid: [B] float
    0/1 (masks padded eval rows). Returns [2 * len(EVAL_KS) + 1] float32
    sums: [hr@5, ndcg@5, hr@10, ndcg@10, hr@15, ndcg@15, hr@20, ndcg@20,
    count] (`src/metrics.py:3-31`: single ground truth, IDCG = 1).
    """
    hit = (topk_idx.long() == answers.long()[:, None]).float()
    ranks = torch.arange(topk_idx.shape[1], dtype=torch.float32, device=topk_idx.device)
    gain = hit / torch.log2(ranks + 2.0)
    sums = []
    for k in EVAL_KS:
        sums.append(torch.sum(hit[:, :k].sum(dim=1) * valid))
        sums.append(torch.sum(gain[:, :k].sum(dim=1) * valid))
    sums.append(torch.sum(valid))
    return torch.stack(sums)


def metrics_from_sums(sums) -> dict:
    """Finalize accumulated `topk_metrics` sums into the metric dict."""
    count = float(sums[-1])
    out = {}
    for i, k in enumerate(EVAL_KS):
        out[f"HR@{k}"] = float(sums[2 * i]) / count
        out[f"NDCG@{k}"] = float(sums[2 * i + 1]) / count
    return out

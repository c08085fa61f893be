"""PREPRec ranked evaluation (counterpart of `bsarec_tpu/preprec/evaluate.py`).

Per user the ground truth competes against 100 pre-sampled negatives
(eval_method 1) or the full catalog (eval_method 3: the candidates are
[gt] + arange(1..V), so the ground truth also competes against its own
catalog copy, as in the reference). Its rank breaks ties at random;
NDCG@k = 1/log2(rank+2) if rank < k, HR@k = rank < k; reported as
[[ndcg, hr] per k]. In "test" mode the validation item is appended to the
history (unless no_valid_in_test or sparse). Candidate popularity times
are the target interaction's own (lag-shifted) times, or the last history
time with prev_time: constant across a user's candidates, so they are
per-user columns.

The loop over user batches runs in Python with the popularity tables on
the device. Under eval_method 3 the candidates are implicit: per user
batch the final state is encoded once, the ground truth is scored in a
call of its own, then the catalog is swept in `item_chunk` blocks (the
tail block's padding ids clamped to a real item before any gather and
masked out of the counts), accumulating #better and #tied-wins on the
device. Nothing of size [U, V] is built. Whether the ground truth ties
its catalog copy depends on whether the one-candidate and the
`item_chunk` products round alike; that structure is the JAX package's
and is kept.

The tie-break uniforms come from a torch generator (the JAX package draws
from threefry), so tied ranks agree with the JAX package in law, not
draw by draw.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from bsarec_tpu_torch.preprec.config import PrepRecConfig
from bsarec_tpu_torch.preprec.data import PrepRecDataset


@dataclasses.dataclass
class EvalInputs:
    """Host-built fixed-shape eval arrays for one mode (valid/test).

    `cands` is the explicit [U, C] candidate matrix (column 0 = ground
    truth) for sampled-negative eval; None means implicit full-catalog
    candidates ([target] + arange(1..itemnum), never materialized).
    """

    seqs: np.ndarray  # [U, maxlen]
    t1: np.ndarray  # [U, maxlen] (lag-shifted)
    t2: np.ndarray
    te: np.ndarray  # [U, maxlen]
    target: np.ndarray  # [U] ground-truth item (candidate column 0)
    cands: np.ndarray | None  # [U, C] explicit candidates, or None
    cand_t1: np.ndarray  # [U] candidate t1 (constant across candidates)
    cand_t2: np.ndarray  # [U]
    users: np.ndarray  # [U] 1-based
    itemnum: int

    @property
    def num_cands(self) -> int:
        return self.cands.shape[1] if self.cands is not None else self.itemnum + 1

    def to_device(self, device) -> dict[str, torch.Tensor]:
        """The arrays as int64 device tensors; no "cands" entry means the
        implicit full-catalog sweep."""
        keys = ["seqs", "t1", "t2", "te", "target", "cand_t1", "cand_t2", "users"]
        if self.cands is not None:
            keys.append("cands")
        return {k: torch.from_numpy(getattr(self, k).astype(np.int64)).to(device) for k in keys}


def build_eval_inputs(ds: PrepRecDataset, cfg: PrepRecConfig, mode: str,
                      usernegs: np.ndarray | None) -> EvalInputs:
    maxlen = cfg.maxlen
    seqs = ds.train_seq.copy()
    t1 = ds.train_t1.copy()
    t2 = ds.train_t2.copy()
    if mode == "test":
        if not cfg.no_valid_in_test and (not cfg.sparse or cfg.override_sparse):
            seqs = np.concatenate([seqs, ds.valid_item[:, None]], axis=1)
            t1 = np.concatenate([t1, ds.valid_t1[:, None]], axis=1)
            t2 = np.concatenate([t2, ds.valid_t2[:, None]], axis=1)
        target, tgt_t1, tgt_t2, te = ds.test_item, ds.test_t1, ds.test_t2, ds.test_te
    else:
        target, tgt_t1, tgt_t2, te = ds.valid_item, ds.valid_t1, ds.valid_t2, ds.valid_te
    seqs, t1, t2 = seqs[:, -maxlen:], t1[:, -maxlen:], t2[:, -maxlen:]

    if cfg.eval_method == 3 or usernegs is None:
        cands = None  # implicit [gt] + arange(1..V) sweep
    else:
        cands = np.concatenate(
            [target[:, None].astype(np.int32), usernegs.astype(np.int32)], axis=1)

    # the lag shift (the model applies none at predict time)
    lag_t1 = np.maximum(0, t1 - 1 - cfg.lag // 4)
    lag_t2 = np.maximum(0, t2 - cfg.lag)
    it1 = np.maximum(0, tgt_t1 - 1 - cfg.lag // 4)
    it2 = np.maximum(0, tgt_t2 - cfg.lag)
    if cfg.prev_time:
        cand_t1, cand_t2 = lag_t1[:, -1], lag_t2[:, -1]
    else:
        cand_t1, cand_t2 = it1, it2

    return EvalInputs(
        seqs.astype(np.int32), lag_t1.astype(np.int32), lag_t2.astype(np.int32),
        te.astype(np.int32), target.astype(np.int32), cands,
        cand_t1.astype(np.int32), cand_t2.astype(np.int32),
        np.arange(1, ds.usernum + 1, dtype=np.int32), int(ds.itemnum),
    )


def ranks_from_scores(scores: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Rank (0-based) of column 0 with random tie-breaking: a tied
    candidate beats the ground truth when its uniform draw exceeds the
    ground truth's."""
    tiebreak = torch.rand(scores.shape, generator=generator, device=scores.device)
    better = scores > scores[:, :1]
    tied = (scores == scores[:, :1]) & (tiebreak > tiebreak[:, :1])
    tied[:, 0] = False
    return (better | tied).sum(1)


def metrics_from_ranks(ranks: np.ndarray, topk) -> list:
    """[[ndcg@k, hr@k], ...] per k."""
    out = []
    n = max(len(ranks), 1)
    for k in topk:
        sel = ranks[ranks < k]
        ndcg = float(np.sum(1.0 / np.log2(sel + 2)) / n)
        hr = float(len(sel) / n)
        out.append([round(ndcg, 3), round(hr, 3)])
    return out


def grouped_metrics(ranks: np.ndarray, userpop: np.ndarray, cfg: PrepRecConfig) -> list:
    """Metrics per group of users, grouped by the rank-percentile of their
    popularity in steps of `quality_size`."""
    from scipy.stats import rankdata

    perc = 100 * rankdata(userpop) / len(userpop)
    perc[perc > 99] = 99
    groups = (perc // cfg.quality_size).astype(int)
    numgroups = int(100 // cfg.quality_size)
    result = []
    for k in cfg.topk:
        ndcgs, hrs = [], []
        for g in range(numgroups):
            sel = ranks[groups[: len(ranks)] == g]
            if sel.size == 0:
                continue
            hit = sel[sel < k]
            ndcgs.append(round(float(np.sum(1.0 / np.log2(hit + 2)) / sel.size), 3))
            hrs.append(round(float(hit.size / sel.size), 3))
        result.append([ndcgs, hrs])
    return result


def final_state(model, cfg: PrepRecConfig, pop, seqs, t1, t2, te) -> torch.Tensor:
    """[B, H]: the last position of the encoded history (the prefix of `predict`)."""
    out = model.encode(pop(seqs, t1, t2), seqs == 0, te if cfg.time_embed else None)
    return out[:, -1, :]


def cand_embed(model, cfg: PrepRecConfig, pop, eval_pop, cands, ct1, ct2, users) -> torch.Tensor:
    """[B, C, H] candidate embeddings (ct1, ct2 broadcast to [B, C])."""
    if cfg.use_week_eval and eval_pop is not None:
        feats = eval_pop(cands, ct1, users)
    else:
        feats = pop(cands, ct1, ct2)
    return model.embed_feats(feats)


def score_cands(model, cfg: PrepRecConfig, pop, eval_pop, state, cands, ct1_col, ct2_col,
                users) -> torch.Tensor:
    """[B, C] scores of explicit candidates [B, C] against `state` [B, H]."""
    ct1 = ct1_col[:, None].expand(cands.shape)
    ct2 = ct2_col[:, None].expand(cands.shape)
    emb = cand_embed(model, cfg, pop, eval_pop, cands, ct1, ct2, users)
    return torch.einsum("bcf,bf->bc", emb, state)


def sweep_chunk_ids(c: int, item_chunk: int, itemnum: int, device):
    """(ids, valid) of sweep chunk c: ids 1 + c*item_chunk + arange, the
    tail's padding ids clamped to itemnum before any gather."""
    ids = 1 + c * item_chunk + torch.arange(item_chunk, device=device)
    return ids.clamp(max=itemnum), ids <= itemnum


def sweep_ranks(model, cfg: PrepRecConfig, pop, eval_pop, state, target, ct1, ct2, users,
                itemnum: int, item_chunk: int, generator: torch.Generator) -> torch.Tensor:
    """Streaming ground-truth rank [B] over the implicit catalog sweep."""
    def score(cands):
        return score_cands(model, cfg, pop, eval_pop, state, cands, ct1, ct2, users)

    b, dev = state.shape[0], state.device
    tgt = score(target[:, None])[:, 0]
    # one uniform for the ground truth, fresh ones for each chunk's
    # candidates: the law of the monolithic tie-break
    u_gt = torch.rand(b, generator=generator, device=dev)
    n_better = torch.zeros(b, dtype=torch.int64, device=dev)
    n_tiedwin = torch.zeros(b, dtype=torch.int64, device=dev)
    for c in range(math.ceil(itemnum / item_chunk)):
        ids, valid = sweep_chunk_ids(c, item_chunk, itemnum, dev)
        s = score(ids[None].expand(b, item_chunk))
        u = torch.rand(s.shape, generator=generator, device=dev)
        n_better += (valid[None] & (s > tgt[:, None])).sum(1)
        n_tiedwin += (valid[None] & (s == tgt[:, None]) & (u > u_gt[:, None])).sum(1)
    return n_better + n_tiedwin


def make_eval_fn(model, cfg: PrepRecConfig, pop_enc, eval_pop, batch: int, num_users: int,
                 itemnum: int, item_chunk: int = 4096):
    """-> evaluate(generator, arrays) -> ranks [U] on the device.

    `arrays` comes from `EvalInputs.to_device`; without a "cands" entry
    the candidates are the implicit full-catalog sweep."""
    if cfg.eval_method == 3 and cfg.use_week_eval:
        # the week-adjusted eval table is indexed by candidate slot of the
        # offline 101-candidate lists; applied to a catalog sweep it would
        # silently mis-index
        raise ValueError(
            "use_week_eval is slot-indexed against the sampled-negative "
            "candidate lists and cannot be combined with full-catalog "
            "eval (eval_method 3)"
        )
    steps = math.ceil(num_users / batch)

    @torch.no_grad()
    def evaluate(generator: torch.Generator, arrays: dict) -> torch.Tensor:
        model.eval()
        ranks = []
        for step in range(steps):
            sl = slice(step * batch, min((step + 1) * batch, num_users))
            state = final_state(model, cfg, pop_enc, arrays["seqs"][sl], arrays["t1"][sl],
                                arrays["t2"][sl], arrays["te"][sl])
            ct1, ct2 = arrays["cand_t1"][sl], arrays["cand_t2"][sl]
            target, users = arrays["target"][sl], arrays["users"][sl]
            if "cands" in arrays:
                scores = score_cands(model, cfg, pop_enc, eval_pop, state, arrays["cands"][sl],
                                     ct1, ct2, users)
                ranks.append(ranks_from_scores(scores, generator))
            else:
                ranks.append(sweep_ranks(model, cfg, pop_enc, eval_pop, state, target, ct1, ct2,
                                         users, itemnum, item_chunk, generator))
        return torch.cat(ranks)

    return evaluate

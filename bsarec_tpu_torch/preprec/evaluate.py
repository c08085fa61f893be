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
device. Nothing of size [U, V] is built, except by `return_scores`,
whose output is the [U, V+1] rows (the reference's --save_scores dump).
Whether the ground truth ties
its catalog copy depends on whether the one-candidate and the
`item_chunk` products round alike; that structure is the JAX package's
and is kept.

Every model's predict factors into a final state [B, H] times candidate
embeddings [B, C, H] (`final_state`, `cand_embed`): NewRec's and
NewB4Rec's candidates are popularity features through the embed layer,
BPRMF's state is its user row, the id models' candidates are item rows.

The tie-break uniforms come from a torch generator (the JAX package draws
from threefry), so tied ranks agree with the JAX package in law, not
draw by draw. The host-side rankers (`mostpop_ranks`, `ensemble_ranks`)
are the JAX package's numpy code: the same ranks for the same
`np.random.default_rng` state.
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


def _tiebroken_ranks(scores: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """0-based rank of column 0 with the randomized tie-break: a tied
    column beats the ground truth when its uniform exceeds the ground
    truth's (p = 1/2)."""
    tie = rng.random(scores.shape)
    better = scores > scores[:, :1]
    tied = (scores == scores[:, :1]) & (tie > tie[:, :1])
    tied[:, 0] = False
    return np.sum(better | tied, axis=1)


def mostpop_ranks(inputs: EvalInputs, rawpop: np.ndarray, rng: np.random.Generator,
                  exclude_rated: bool = False) -> np.ndarray:
    """The popularity baseline: candidates scored by their interaction
    count. Under the full catalog, `exclude_rated` drops each user's
    rated items from the candidates. That branch builds nothing of size
    [U, V]: every user scores the same vector, so the rank is order
    statistics of the sorted catalog minus per-user corrections, and the
    tie group is one Binomial draw (each tied candidate beats the ground
    truth with p = 1 - u_gt, the monolithic tie-break's conditional law)."""
    pop = np.concatenate([[0.0], np.asarray(rawpop, dtype=np.float64)])  # item 0 pads
    if inputs.cands is not None:
        if exclude_rated:
            raise ValueError(
                "exclude_rated applies to full-catalog (eval_method 3) "
                "candidates; sampled negatives are pre-filtered offline")
        return _tiebroken_ranks(pop[inputs.cands], rng)

    # the implicit full catalog [gt] + arange(1..V)
    tgt_pop = pop[inputs.target]
    cat = np.sort(pop[1:])
    v = cat.size
    n_ge = v - np.searchsorted(cat, tgt_pop, side="left")
    n_gt = v - np.searchsorted(cat, tgt_pop, side="right")
    n_tied = n_ge - n_gt  # the ground truth's own catalog copy among them
    if exclude_rated:  # histories are 0-padded and may repeat items
        for i in range(inputs.seqs.shape[0]):
            rated = np.unique(inputs.seqs[i])
            rp = pop[rated[rated > 0]]
            n_gt[i] -= int(np.sum(rp > tgt_pop[i]))
            n_tied[i] -= int(np.sum(rp == tgt_pop[i]))
    u_gt = rng.random(tgt_pop.shape[0])
    wins = rng.binomial(np.maximum(n_tied, 0), np.clip(1.0 - u_gt, 0.0, 1.0))
    return n_gt + wins


def ensemble_ranks(scores: np.ndarray, loaded: np.ndarray, alphas,
                   rng: np.random.Generator | None = None) -> list[np.ndarray]:
    """Blend fresh scores with saved ones, alpha * new + (1 - alpha) *
    saved, and rank column 0 in each blend; one rank array per alpha.
    With `rng` None a rank counts strictly greater scores only, as the
    JAX package does: exact on tie-free scores, and optimistic on ties
    (the ground truth takes the best place of its tie group, where the
    reference's unstable argsort places it anywhere). With `rng`, ties
    are broken at random."""
    blends = [alpha * scores + (1.0 - alpha) * loaded for alpha in alphas]
    if rng is None:
        return [np.sum(b > b[:, :1], axis=1) for b in blends]
    return [_tiebroken_ranks(b, rng) for b in blends]


def final_state(model, cfg: PrepRecConfig, pop, seqs, t1, t2, te, users=None) -> torch.Tensor:
    """[B, H]: the prefix of the model's `predict` (the last position of
    the encoded history; BPRMF's user rows)."""
    if cfg.model == "newrec":
        out = model.encode(pop(seqs, t1, t2), seqs == 0, te if cfg.time_embed else None)
    elif cfg.model == "newb4rec":
        out = model.encode(pop(seqs, t1, t2), seqs > 0)
    elif cfg.model == "bprmf":
        return model.user_emb(users)
    else:
        out = model.encode(seqs)
    return out[:, -1, :]


def cand_embed(model, cfg: PrepRecConfig, pop, eval_pop, cands, ct1, ct2, users) -> torch.Tensor:
    """[B, C, H] candidate embeddings (ct1, ct2 broadcast to [B, C])."""
    if cfg.model == "newrec":
        if cfg.use_week_eval and eval_pop is not None:
            feats = eval_pop(cands, ct1, users)
        else:
            feats = pop(cands, ct1, ct2)
        return model.embed_feats(feats)
    if cfg.model == "newb4rec":
        return model.embed_feats(pop(cands, ct1, ct2))
    return model.item_emb(cands)


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


def sweep_scores(model, cfg: PrepRecConfig, pop, eval_pop, state, target, ct1, ct2, users,
                 itemnum: int, item_chunk: int) -> torch.Tensor:
    """[B, V+1] score rows of the same chunked sweep: the target's score,
    then the catalog."""
    def score(cands):
        return score_cands(model, cfg, pop, eval_pop, state, cands, ct1, ct2, users)

    b = state.shape[0]
    parts = [score(target[:, None])]
    for c in range(math.ceil(itemnum / item_chunk)):
        ids, _ = sweep_chunk_ids(c, item_chunk, itemnum, state.device)
        parts.append(score(ids[None].expand(b, item_chunk)))
    return torch.cat(parts, 1)[:, :1 + itemnum]


def make_eval_fn(model, cfg: PrepRecConfig, pop_enc, eval_pop, batch: int, num_users: int,
                 itemnum: int, item_chunk: int = 4096, return_scores: bool = False):
    """-> evaluate(generator, arrays) -> ranks [U] on the device, or with
    `return_scores` the raw score rows: [U, C] of the explicit candidates,
    [U, V+1] under the sweep (the output is O(U * V) by nature).

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
        out = []
        for step in range(steps):
            sl = slice(step * batch, min((step + 1) * batch, num_users))
            target, users = arrays["target"][sl], arrays["users"][sl]
            state = final_state(model, cfg, pop_enc, arrays["seqs"][sl], arrays["t1"][sl],
                                arrays["t2"][sl], arrays["te"][sl], users)
            ct1, ct2 = arrays["cand_t1"][sl], arrays["cand_t2"][sl]
            if "cands" in arrays:
                scores = score_cands(model, cfg, pop_enc, eval_pop, state, arrays["cands"][sl],
                                     ct1, ct2, users)
                out.append(scores if return_scores else ranks_from_scores(scores, generator))
            elif return_scores:
                out.append(sweep_scores(model, cfg, pop_enc, eval_pop, state, target, ct1, ct2,
                                          users, itemnum, item_chunk))
            else:
                out.append(sweep_ranks(model, cfg, pop_enc, eval_pop, state, target, ct1, ct2,
                                         users, itemnum, item_chunk, generator))
        return torch.cat(out)

    return evaluate

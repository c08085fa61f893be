"""Full-catalog softmax CE and top-k over a vocab-sharded item table
(counterpart of `bsarec_tpu/parallel/logits.py`).

Shard s of the model group holds the table rows [s * rows, (s + 1) *
rows). Each shard works on its own rows and the shards' results are
merged, in shard order, by two plain functions:

- `merge_ce_stats`: logZ = max + log-sum-exp of the shards' logZ around
  it, gold = the sum of the shards' gold logits (0 off the shard);
- `merge_topk`: a stable top-k over the shards' candidates laid out
  [b, m * k] in shard order, so ties keep the smaller global id, as the
  unsharded kernel orders them.

The distributed functions gather their shards' results over the model
group and call the merges; `*_over_shards` runs m shards in one process
through the same merges (the card's check of the composition, and the
CPU tests against JAX). No new kernel: each shard calls the port's
streaming kernels (`ops/ce.py`, `ops/rank.py`), as JAX's shard_map calls
its Pallas kernels per shard.

The streaming pair:
- `sharded_streaming_ce` (`:243-260`): forward `ce_loss_logz` per shard
  with the answers `a - start` as they are (the kernels give gold 0
  outside [0, n_valid), `csrc/streaming_ce.cu`; JAX maps such answers to
  -1 first, `_local_answers`), the gold as logZ - loss, then the merge.
  Backward `ce_grads` per shard with the global logZ; ds summed over the
  model group. The table's gradient covers this data rank's rows only:
  the training loop's average over the data group, as of every
  gradient, does the data sum of `:236-237`;
- `sharded_streaming_topk` (`:263-321`): the rank kernel per shard with
  n_valid = clip(max_valid - start, 0, rows) (a shard at 0 takes the
  kernel's empty case), ids shifted by start, gathered and merged.

The dense pair, `sharded_softmax_ce` (`:32-66`) and `sharded_masked_topk`
(`:69-128`), is what XLA's partitioning of the dense paths computes in
JAX: the same merges over each shard's [b, rows] logits. They are the
port's "sharded_dense" impls, the default on the CPU and for small
catalogs. Unfilled top-k slots are (-inf, 0), as the unsharded kernel
gives them.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from bsarec_tpu_torch.core.mesh import Mesh, copy_to_group, gather_replicated
from bsarec_tpu_torch.ops.ce import streaming_ce_grads, streaming_ce_stats
from bsarec_tpu_torch.ops.precision import is_bf16, matmul
from bsarec_tpu_torch.ops.rank import streaming_masked_topk
from bsarec_tpu_torch.ops.topk import stable_topk
from bsarec_tpu_torch.parallel.embedding import shard_rows

NEG_INF = float("-inf")


# ---- the merges ----------------------------------------------------------------


def merge_ce_stats(logz_stack: torch.Tensor, gold_stack: torch.Tensor):
    """[m, b] per-shard logZ and gold logits -> ([b] logZ, [b] gold). A row
    whose every shard is -inf (no valid column) keeps logZ -inf."""
    top = logz_stack.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top)).detach()
    logz = top + torch.log(torch.exp(logz_stack - top).sum(dim=0))
    return logz, gold_stack.sum(dim=0)


def merge_topk(vals_stack: torch.Tensor, ids_stack: torch.Tensor, k: int | None = None):
    """[m, b, k] per-shard (values, global ids) -> the top k of their
    union ([b, k] values, [b, k] int64 ids): a stable descending sort over
    the candidates in shard order, so equal values keep the smaller id.
    Slots left at -inf get id 0."""
    m, b, kk = vals_stack.shape
    k = kk if k is None else k
    vals = vals_stack.permute(1, 0, 2).reshape(b, m * kk)
    ids = ids_stack.long().permute(1, 0, 2).reshape(b, m * kk)
    top, pos = stable_topk(vals, k)
    top_ids = ids.gather(1, pos)
    return top, torch.where(top == NEG_INF, 0, top_ids)


def _pad_k(vals: torch.Tensor, ids: torch.Tensor, k: int):
    """(values, ids) widened to k slots with (-inf, 0) where a shard has
    fewer than k rows."""
    short = k - vals.shape[1]
    if short <= 0:
        return vals, ids
    b = vals.shape[0]
    return (torch.cat([vals, vals.new_full((b, short), NEG_INF)], dim=1),
            torch.cat([ids, ids.new_zeros((b, short))], dim=1))


# ---- one shard's work ----------------------------------------------------------


def shard_ce_stats(states: torch.Tensor, local_table: torch.Tensor, answers: torch.Tensor,
                   start: int, dtype: str | None = None):
    """([b] logZ, [b] gold) over this shard's rows: one `ce_loss_logz` call
    on the raw answers - start; gold = logZ - loss, 0 off the shard."""
    loss_l, logz_l = streaming_ce_stats(states, local_table, answers.long() - start, dtype=dtype)
    return logz_l, logz_l - loss_l


def shard_ce_grads(states: torch.Tensor, local_table: torch.Tensor, answers: torch.Tensor,
                   start: int, logz: torch.Tensor, dloss: torch.Tensor, dtype: str | None = None):
    """(ds over this shard's columns, dT of its rows) at the global logZ:
    one `ce_grads` call."""
    return streaming_ce_grads(states, local_table, answers.long() - start, logz, dloss,
                              dtype=dtype)


def shard_topk(states: torch.Tensor, local_table: torch.Tensor, seen_bitmask: torch.Tensor,
               start: int, k: int, max_valid_items: int | None = None):
    """([b, k] values, [b, k] global ids) of this shard: one rank-kernel
    call with n_valid = clip(max_valid - start, 0, rows) and the shard's
    own bitmask."""
    rows = local_table.shape[0]
    nv = rows if max_valid_items is None else min(max(max_valid_items - start, 0), rows)
    vals, ids = streaming_masked_topk(states.contiguous(), local_table, seen_bitmask, k=k,
                                      n_valid=nv)
    return vals, ids.long() + start


def dense_shard_ce_stats(states: torch.Tensor, local_table: torch.Tensor, answers: torch.Tensor,
                         start: int, dtype: str = "float32"):
    """([b] logZ, [b] gold) over this shard's [b, rows] logits,
    differentiable (the dense pair's shard work)."""
    rows = local_table.shape[0]
    logits = matmul(states, local_table.T, is_bf16(dtype))
    local = answers.long() - start
    owned = (local >= 0) & (local < rows)
    gold = logits.gather(1, local.clamp(0, rows - 1)[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1), torch.where(owned, gold, torch.zeros_like(gold))


def dense_shard_topk(states: torch.Tensor, local_table: torch.Tensor, seen_items: torch.Tensor,
                     start: int, k: int, max_valid_items: int | None = None,
                     dtype: str = "float32"):
    """([b, k] values, [b, k] global ids) of this shard's [b, rows] logits:
    its seen items at 0.0 (the padding id 0 is shard 0's column 0), ids
    >= max_valid at -inf, a stable top-k."""
    bf16 = is_bf16(dtype)
    rows = local_table.shape[0]
    logits = matmul(states, local_table.T, bf16)
    local = seen_items.long() - start
    owned = (local >= 0) & (local < rows)
    # a count of owned seen ids a column (a scatter of values would race
    # where an off-shard id and an owned one share a column)
    hits = torch.zeros(logits.shape, dtype=torch.int32, device=logits.device)
    hits.scatter_add_(1, torch.where(owned, local, 0), owned.int())
    logits = torch.where(hits > 0, 0.0, logits)
    if max_valid_items is not None:
        gids = start + torch.arange(rows, device=logits.device)
        logits = torch.where(gids[None, :] >= max_valid_items, NEG_INF, logits)
    vals, idx = stable_topk(logits, k)
    return _pad_k(vals, idx + start, k)


# ---- m shards in one process -----------------------------------------------------


def streaming_ce_over_shards(states: torch.Tensor, tables: list[torch.Tensor],
                             answers: torch.Tensor, dtype: str | None = None):
    """([b] loss, [b] logZ) of the shards `tables` (in order, equal rows)
    merged: the forward of `sharded_streaming_ce` in one process."""
    starts = [i * tables[0].shape[0] for i in range(len(tables))]
    stats = [shard_ce_stats(states, t, answers, s, dtype) for t, s in zip(tables, starts)]
    logz, gold = merge_ce_stats(torch.stack([x[0] for x in stats]),
                                torch.stack([x[1] for x in stats]))
    return logz - gold, logz


def streaming_ce_grads_over_shards(states: torch.Tensor, tables: list[torch.Tensor],
                                   answers: torch.Tensor, logz: torch.Tensor,
                                   dloss: torch.Tensor, dtype: str | None = None):
    """(ds summed over the shards, dT of every shard concatenated): the
    backward of `sharded_streaming_ce` in one process."""
    rows = tables[0].shape[0]
    parts = [shard_ce_grads(states, t, answers, i * rows, logz, dloss, dtype)
             for i, t in enumerate(tables)]
    return torch.stack([p[0] for p in parts]).sum(dim=0), torch.cat([p[1] for p in parts])


def streaming_topk_over_shards(states: torch.Tensor, tables: list[torch.Tensor],
                               seen_bitmasks, k: int = 20, max_valid_items: int | None = None):
    """`sharded_streaming_topk` in one process; `seen_bitmasks[s]` is
    shard s's bitmask (`build_seen_bitmask_sharded`)."""
    rows = tables[0].shape[0]
    parts = [shard_topk(states, t, seen_bitmasks[i], i * rows, k, max_valid_items)
             for i, t in enumerate(tables)]
    return merge_topk(torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]), k)


def dense_ce_over_shards(states: torch.Tensor, tables: list[torch.Tensor],
                         answers: torch.Tensor, dtype: str = "float32") -> torch.Tensor:
    """`sharded_softmax_ce` in one process, differentiable: [b] loss."""
    rows = tables[0].shape[0]
    stats = [dense_shard_ce_stats(states, t, answers, i * rows, dtype)
             for i, t in enumerate(tables)]
    logz, gold = merge_ce_stats(torch.stack([x[0] for x in stats]),
                                torch.stack([x[1] for x in stats]))
    return logz - gold


def dense_topk_over_shards(states: torch.Tensor, tables: list[torch.Tensor],
                           seen_items: torch.Tensor, k: int = 20,
                           max_valid_items: int | None = None, dtype: str = "float32"):
    """`sharded_masked_topk` in one process."""
    rows = tables[0].shape[0]
    parts = [dense_shard_topk(states, t, seen_items, i * rows, k, max_valid_items, dtype)
             for i, t in enumerate(tables)]
    return merge_topk(torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]), k)


# ---- over the model group ----------------------------------------------------------


class _ShardedStreamingCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, states, local_table, answers, start, dtype, group):
        logz_l, gold_l = shard_ce_stats(states, local_table, answers, start, dtype)
        stack = gather_replicated(torch.stack([logz_l, gold_l]), group)
        logz, gold = merge_ce_stats(stack[:, 0], stack[:, 1])
        ctx.save_for_backward(states, local_table, answers, logz)
        ctx.start, ctx.dtype, ctx.group = start, dtype, group
        ctx.mark_non_differentiable(logz)
        return logz - gold, logz

    @staticmethod
    def backward(ctx, dloss, _dlogz):
        states, local_table, answers, logz = ctx.saved_tensors
        ds, dt = shard_ce_grads(states, local_table, answers, ctx.start, logz, dloss, ctx.dtype)
        if dist.get_world_size(ctx.group) > 1:
            dist.all_reduce(ds, group=ctx.group)
        return ds, dt, None, None, None, None


def sharded_streaming_ce(states: torch.Tensor, local_table: torch.Tensor, answers: torch.Tensor,
                         mesh: Mesh, dtype: str | None = None, return_logz: bool = False):
    """[b] per-row full-catalog CE of this data rank's rows over the
    vocab-sharded table (this rank's shard `local_table`), through the
    streaming kernels per shard; differentiable in states and the shard.
    With `return_logz`, also the [b] global logZ."""
    start, _ = shard_rows(local_table, mesh)
    loss, logz = _ShardedStreamingCE.apply(states.contiguous(), local_table.contiguous(),
                                           answers.long().contiguous(), start, dtype,
                                           mesh.model_group)
    return (loss, logz) if return_logz else loss


def sharded_streaming_topk(states: torch.Tensor, local_table: torch.Tensor,
                           seen_bitmask: torch.Tensor, mesh: Mesh, k: int = 20,
                           max_valid_items: int | None = None):
    """([b, k] values, [b, k] int64 global ids) over the vocab-sharded
    table: the rank kernel on this shard with its own bitmask
    (`build_seen_bitmask(..., id_offset=start, mask_item0=start == 0)`),
    gathered over the model group and merged. Every rank of the group
    returns the same result."""
    start, _ = shard_rows(local_table, mesh)
    vals, ids = shard_topk(states, local_table, seen_bitmask, start, k, max_valid_items)
    group = mesh.model_group
    return merge_topk(gather_replicated(vals, group), gather_replicated(ids, group), k)


def sharded_softmax_ce(states: torch.Tensor, local_table: torch.Tensor, answers: torch.Tensor,
                       mesh: Mesh, dtype: str = "float32") -> torch.Tensor:
    """[b] per-row CE over the vocab-sharded table from each shard's dense
    [b, rows] logits, differentiable: the states enter every shard's work
    (their gradient summed over the model group), and the shards' (logZ,
    gold) are gathered and merged on every rank."""
    start, _ = shard_rows(local_table, mesh)
    s = copy_to_group(states, mesh.model_group)
    logz_l, gold_l = dense_shard_ce_stats(s, local_table, answers, start, dtype)
    stack = gather_replicated(torch.stack([logz_l, gold_l]), mesh.model_group)
    logz, gold = merge_ce_stats(stack[:, 0], stack[:, 1])
    return logz - gold


def sharded_masked_topk(states: torch.Tensor, local_table: torch.Tensor,
                        seen_items: torch.Tensor, mesh: Mesh, k: int = 20,
                        max_valid_items: int | None = None, dtype: str = "float32"):
    """([b, k] values, [b, k] int64 global ids) over the vocab-sharded
    table from each shard's dense logits, seen items ([b, S] global ids,
    0-padded) at 0.0, ids >= max_valid at -inf."""
    start, _ = shard_rows(local_table, mesh)
    vals, ids = dense_shard_topk(states, local_table, seen_items, start, k, max_valid_items,
                                 dtype)
    group = mesh.model_group
    return merge_topk(gather_replicated(vals, group), gather_replicated(ids, group), k)

"""The row-sharded item table's lookup (counterpart of
`bsarec_tpu/parallel/embedding.py`).

Shard s of the model group holds the rows [s * rows, (s + 1) * rows) of
the [V, H] item table. A lookup gathers the rows it owns (other ids give
zeros) and sums the pieces over the model group, so every rank holds
the full embedding vectors, bit-equal to an unsharded gather (one piece
is a row, the others are zeros). XLA partitions JAX's lookup by itself;
here it is an autograd Function, the path of every model's `embed_items`
under `--mesh` with a sharded table.

Backwards, each rank scatter-adds the cotangent into the rows it owns,
with no collective: every rank of the model group goes on with the same
embeddings and so already holds the same cotangent, and a sum over the
group would multiply the table's gradient by its size. As
`nn.Embedding(padding_idx=0)`, id 0 sends no gradient to row 0.
"""

from __future__ import annotations

import torch

from bsarec_tpu_torch.core.mesh import Mesh


def pad_vocab_rows(table: torch.Tensor, num_shards: int) -> tuple[torch.Tensor, int]:
    """([V', H] table padded with zero rows to a multiple of num_shards, V).
    Padding rows are never looked up and never win a top-k: their ids
    are past every valid id."""
    v = table.shape[0]
    padded = -(-v // num_shards) * num_shards
    if padded == v:
        return table, v
    pad = torch.zeros((padded - v,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    return torch.cat([table, pad]), v


def shard_rows(local_table: torch.Tensor, mesh: Mesh) -> tuple[int, int]:
    """(start, rows) of this rank's shard."""
    rows = local_table.shape[0]
    return mesh.model_rank * rows, rows


def owned_lookup(local_table: torch.Tensor, ids: torch.Tensor, start: int) -> torch.Tensor:
    """The rows of `ids` this shard owns, zeros for the others."""
    rows = local_table.shape[0]
    local = ids.long() - start
    owned = (local >= 0) & (local < rows)
    gathered = local_table[local.clamp(0, rows - 1)]
    return torch.where(owned[..., None], gathered, torch.zeros((), dtype=gathered.dtype,
                                                                device=gathered.device))


class _ShardedLookup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local_table, ids, start, group):
        import torch.distributed as dist

        out = owned_lookup(local_table, ids, start)
        if group is not None and dist.get_world_size(group) > 1:
            dist.all_reduce(out, group=group)
        ctx.save_for_backward(ids)
        ctx.start, ctx.shape = start, local_table.shape
        return out

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        rows, h = ctx.shape
        local = ids.reshape(-1).long() - ctx.start
        keep = (local >= 0) & (local < rows) & (ids.reshape(-1) != 0)
        dtable = torch.zeros(ctx.shape, dtype=grad.dtype, device=grad.device)
        dtable.index_add_(0, local[keep], grad.reshape(-1, h)[keep])
        return dtable, None, None, None


def sharded_embedding_lookup(local_table: torch.Tensor, ids: torch.Tensor,
                             mesh: Mesh) -> torch.Tensor:
    """[..., H] rows of the global ids [...] from the row-sharded table,
    this rank's shard `local_table` [V / m, H]; differentiable in the
    shard."""
    start, _ = shard_rows(local_table, mesh)
    return _ShardedLookup.apply(local_table, ids, start, mesh.model_group)


def lookup_over_shards(tables: list[torch.Tensor], ids: torch.Tensor) -> torch.Tensor:
    """`sharded_embedding_lookup` of the shards `tables` (in order, equal
    rows) in one process: each shard's owned rows summed, differentiable
    in every shard by the same backward."""
    rows = tables[0].shape[0]
    return sum(_ShardedLookup.apply(t, ids, i * rows, None) for i, t in enumerate(tables))

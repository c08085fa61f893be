"""The serving top-k on the rank kernel: the port's `bitmask` layout
(counterpart of `bsarec_tpu/serving.py:bitmask_masked_topk`).

`torch.ops.bsarec_tpu_torch.serving_masked_topk(states, table, seen_ids,
k)` returns the top k of `states @ table.T` under the serving
contract: the row's seen ids and the padding item 0 score -inf and never
enter the result, ties go to the smallest id. It builds the seen bitmask
from the [B, S] id lists on the device and runs the streaming rank
kernel (`ops/rank.py`) with `seen_value=-inf`, so no [B, V] score matrix
exists. On a CPU tensor it runs the kernel's plain version.

It is a `torch.library` custom op so that `torch.export` records it in a
serving artifact (`serving.py`) as one node: a process that loads such
an artifact imports this module first, or the load fails with
"custom op is not registered".

Two things the kernel alone does not give:

- seen ids outside [0, V) are dropped, as JAX's scatter drops
  them; a CUDA scatter out of bounds would fire a device assert and end
  the serving process;
- a row with fewer than k unmasked items: `jax.lax.top_k` fills its tail
  with the -inf entries in ascending id order, that is 0 and then the
  row's seen ids ascending, where the kernel leaves (-inf, 0).
  `fill_masked_tail` writes JAX's fill, with tensor ops on the device.
"""

from __future__ import annotations

import torch

from bsarec_tpu_torch.ops import rank


def _unique_valid_ids(seen_ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """[B, S] -> [B, S] int64: each row's distinct ids in [1, vocab_size)
    ascending, then vocab_size in every other slot."""
    ids = seen_ids.long()
    ids = torch.where((ids > 0) & (ids < vocab_size), ids, vocab_size)
    ids = torch.sort(ids, dim=1).values
    dup = torch.cat([torch.zeros_like(ids[:, :1], dtype=torch.bool), ids[:, 1:] == ids[:, :-1]], 1)
    return torch.sort(torch.where(dup, vocab_size, ids), dim=1).values


def seen_bitmask(seen_ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """[B, S] 0-padded seen ids (repeats and ids outside [0, vocab_size)
    allowed) -> the kernel's [B, ceil(V/32)] int32 bitmask, item 0 set."""
    ids = _unique_valid_ids(seen_ids, vocab_size)
    return rank.seen_ids_to_bitmask(torch.where(ids < vocab_size, ids, 0), vocab_size)


def fill_masked_tail(vals: torch.Tensor, ids: torch.Tensor, seen_ids: torch.Tensor,
                     vocab_size: int) -> torch.Tensor:
    """The kernel's ids with each unfilled (-inf) slot given JAX's fill:
    the row's masked ids ascending (0, then its distinct seen ids), the
    first in the first unfilled slot. With every column valid, a row's
    unmasked and masked ids together cover [0, V), so k <= V leaves at
    least as many masked ids as unfilled slots."""
    masked = torch.cat([torch.zeros_like(seen_ids[:, :1], dtype=torch.int64),
                        _unique_valid_ids(seen_ids, vocab_size)], dim=1)
    filled = (vals > rank.NEG_INF).sum(dim=1, keepdim=True)
    slot = torch.arange(vals.shape[1], device=vals.device)[None, :]
    fill = torch.gather(masked, 1, (slot - filled).clamp(0, masked.shape[1] - 1))
    return torch.where(slot < filled, ids, fill.to(ids.dtype))


@torch.library.custom_op("bsarec_tpu_torch::serving_masked_topk", mutates_args=())
def serving_masked_topk(states: torch.Tensor, table: torch.Tensor, seen_ids: torch.Tensor,
                        k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """states [B, H] f32, table [V, H] f32, seen_ids [B, S] int ->
    (values [B, k] f32, ids [B, k] int32); 1 <= k <= min(V, 128). Every
    table row is a valid item."""
    v = table.shape[0]
    if not 1 <= k <= v:
        raise ValueError(f"k must be in [1, V={v}], got {k}")
    bitmask = seen_bitmask(seen_ids, v)
    vals, ids = rank.streaming_masked_topk(states.contiguous(), table.contiguous(), bitmask, k,
                                           v, seen_value=rank.NEG_INF)
    return vals.contiguous(), fill_masked_tail(vals, ids, seen_ids, v)


@serving_masked_topk.register_fake
def _(states, table, seen_ids, k):
    b = states.shape[0]
    return states.new_empty((b, k)), states.new_empty((b, k), dtype=torch.int32)

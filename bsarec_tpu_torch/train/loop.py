"""Eval loop (counterpart of `bsarec_tpu/train/loop.py:build_eval_fn`).

The JAX package scans over user batches inside one jitted program; here
it is a Python loop over eval batches on the device. The training
half of the JAX module is not ported yet.
"""

from __future__ import annotations

import math

import torch

from bsarec_tpu_torch.ops.rank import seen_ids_to_bitmask, streaming_masked_topk
from bsarec_tpu_torch.ops.topk import TOP_K, masked_topk, topk_metrics

# From this catalog size on (and on CUDA) "auto" picks the streaming
# rank kernel over the dense [B, V] score matrix.
STREAMING_RANK_MIN_VOCAB = 262_144


def resolve_eval_impl(impl: str, item_size: int, device: torch.device) -> str:
    if impl == "auto":
        big = item_size >= STREAMING_RANK_MIN_VOCAB and device.type == "cuda"
        return "streaming" if big else "dense"
    if impl not in ("dense", "streaming"):
        raise NotImplementedError(f"eval_impl {impl!r} is not ported yet")
    return impl


def build_eval_fn(model, item_size: int, batch_size: int, num_users: int,
                  device: torch.device, impl: str = "auto", collect_topk: bool = False,
                  seen_format: str = "bitmask"):
    """Returns `(evaluate, steps, impl)`; `evaluate(inputs, answers, seen)`
    gives the [9] float32 metric sums (`ops.topk.topk_metrics` layout),
    or with `collect_topk` the [num_users, 20] int32 top-k item ids.

    impl "dense" scores the full catalog per batch and masks/top-ks it;
    "streaming" runs `ops.rank.streaming_masked_topk` and `seen` is then a
    [U, ceil(V/32)] bitmask ("bitmask") or deduplicated [U, S] seen-id
    lists from which each batch's bitmask is built on the device ("ids").
    The dense path always takes id lists. The last batch is padded by
    clamping user indices to num_users-1 and weighted out with `valid`.
    """
    steps = math.ceil(num_users / batch_size)
    impl = resolve_eval_impl(impl, item_size, device)

    @torch.inference_mode()
    def evaluate(inputs, answers, seen):
        model.eval()
        sums = torch.zeros(9, dtype=torch.float32, device=device)
        per_batch = []
        for step in range(steps):
            idx = torch.arange(step * batch_size, (step + 1) * batch_size, device=device)
            valid = (idx < num_users).float()
            safe = idx.clamp(max=num_users - 1)
            state = model.predict(inputs[safe])[:, -1, :]
            table = model.item_table
            if impl == "streaming":
                seen_batch = seen[safe]
                if seen_format == "ids":
                    seen_batch = seen_ids_to_bitmask(seen_batch, item_size)
                _, topk_idx = streaming_masked_topk(
                    state.contiguous(), table, seen_batch, k=TOP_K, n_valid=item_size
                )
            else:
                logits = state @ table[:item_size].T
                _, topk_idx = masked_topk(logits, seen[safe])
            if collect_topk:
                per_batch.append(topk_idx.int())
            else:
                sums += topk_metrics(topk_idx, answers[safe], valid)
        if collect_topk:
            return torch.cat(per_batch)[:num_users]
        return sums

    return evaluate, steps, impl

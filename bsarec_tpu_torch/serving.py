"""Serving export: a weights-baked, batch-polymorphic top-k scorer
(counterpart of `bsarec_tpu/serving.py`).

`export_scorer` records the eval-time ranking computation (`model.predict`
last-position state x item table, top 20) with `torch.export` and saves
it as a `.pt2` artifact; `load_scorer` loads it and `Scorer.topk` runs it.
Serving masks seen items and the padding id 0 to **-inf**, so a user's
history never appears in their results; the reference's
`rating_pred[seen] = 0` quirk (`src/trainers.py:134`) stays in the eval
path (`ops/topk.py`, `ops/rank.py` with `seen_value=0.0`).

The artifact:

- holds the weights (and, for int8, the quantized table and its scales),
  so it needs no checkpoint and no model code to run;
- has one symbolic batch dimension, so any batch size runs without a new
  export;
- takes int32 `input_ids [b, L]`, `user_ids [b]`, `seen_items [b, S]` and
  returns int32 [b, 20] ranked ids. The state is `model.predict(input_ids,
  user_ids)[:, -1]`: BERT4Rec's predict shifts in its mask token, Caser's
  reads the user ids; every model ranks `table[:item_size]`, which leaves
  out BERT4Rec's [mask] row;
- is exported on one device and loads on either: `load_scorer` moves it
  with `torch.export.passes.move_to_device_pass` where they differ.

Where the JAX blob needs only jaxlib, the port's artifact needs the
port's op module `bsarec_tpu_torch.ops.serving_topk`, which registers the
custom op of the `bitmask` layout; `load_scorer` imports it.

Layouts (`impl`), all returning the same ranking:

- `bitmask` (default): the streaming rank kernel in its serving mask mode
  through the custom op (`ops/serving_topk.py`): no [b, V] score matrix;
- `dense`: the [b, V] logits, seen ids scattered to -inf, a stable sort;
- `filtered`: the top (k + S + 1) of the raw logits, then the seen and
  padding ids dropped in top-k space and a second top-k;
- `chunked`: the catalog in `item_chunk` blocks, a top-k each, one merge.

`dtype="bfloat16"` (`--dtype bf16`, `bsarec_tpu/serving.py:206-300`) scores
every non-int8 layout from bf16-rounded operands with a float32 result:
the item table is rounded once at export (the artifact holds the rounded
float32 table beside the model's own) and the [b, H] states in each
call, inside the program, so the `bitmask` layout's rank kernel, which
takes float32, ranks exactly JAX's bf16 logits. int8 ignores the dtype,
as in JAX. The model itself runs under its own `compute_dtype`.

`torch.topk` promises no order among equal scores, so every top-k here is
read off a stable descending sort, which orders ties by the smallest id
as `jax.lax.top_k` does. `quant="int8"` quantizes the catalog matmul
(`int8_logits`); its logits exist as a [b, V] slab, so the `bitmask`
layout masks them as `dense` does.
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch
from torch import nn

# registers the custom op that bitmask artifacts call
from bsarec_tpu_torch.ops import serving_topk
from bsarec_tpu_torch.ops.precision import is_bf16, rounded
from bsarec_tpu_torch.ops.topk import stable_topk

SERVING_CALL_DOC = "(input_ids [b, L] i32, user_ids [b] i32, seen_items [b, S] i32) -> [b, 20] i32"
IMPLS = ("bitmask", "dense", "filtered", "chunked")
_META_FILE = "bsarec_scorer.json"
# an fp32 product of int8-valued operands is exact while every partial sum
# stays below 2^24: H * 127^2 < 2^24
_INT8_MAX_HIDDEN = (1 << 24) // (127 * 127)


def _drop_out_of_range(seen_items: torch.Tensor, v: int) -> torch.Tensor:
    """Seen ids outside [0, v) -> 0 (the padding column, masked anyway), as
    JAX's bitmask scatter drops them."""
    seen = seen_items.long()
    return torch.where((seen >= 0) & (seen < v), seen, 0)


def serving_masked_topk(logits: torch.Tensor, seen_items: torch.Tensor, k: int = 20):
    """Serving-contract masking on the [b, V] logits: seen ids and the
    padding column 0 go to -inf, then the top k."""
    masked = logits.scatter(1, _drop_out_of_range(seen_items, logits.shape[1]), float("-inf"))
    masked[:, 0] = float("-inf")
    return stable_topk(masked, k)


def bitmask_masked_topk(states: torch.Tensor, table: torch.Tensor, seen_items: torch.Tensor,
                        k: int = 20):
    """The same contract and result as `serving_masked_topk(states @
    table.T, seen_items, k)`, through the rank kernel's serving mode: the
    custom op of `ops/serving_topk.py` (on a CPU tensor its plain version:
    a chunked matmul, the mask, a stable sort)."""
    return serving_topk.serving_masked_topk(states, table, seen_items, k)


def filtered_masked_topk(logits: torch.Tensor, seen_items: torch.Tensor, k: int = 20):
    """The same contract and result as `serving_masked_topk`, masking in
    top-k space: the top (k + S + 1) of the raw logits (S seen ids, +1 for
    the padding column), winners that are seen or id 0 set to -inf, then
    the top k of those. At most S + 1 winners drop out, so the k left are
    exactly the masked top k, and both sorts keep the id order of ties."""
    kk = k + seen_items.shape[1] + 1
    if kk > logits.shape[1]:  # degenerate catalogs: the slab is tiny anyway
        return serving_masked_topk(logits, seen_items, k=k)
    vals, ids = stable_topk(logits, kk)
    seen = _drop_out_of_range(seen_items, logits.shape[1])
    bad = (ids[:, :, None] == seen[:, None, :]).any(dim=-1) | (ids == 0)
    fvals, floc = stable_topk(torch.where(bad, float("-inf"), vals), k)
    return fvals, torch.gather(ids, 1, floc)


def quantize_rows(x: torch.Tensor):
    """[N, h] f32 -> symmetric per-row int8 + f32 scales. `torch.round`
    rounds half to even, as `jnp.round` does."""
    x = x.float()
    amax = x.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.round(x / scale[:, None]).to(torch.int8), scale


def int8_logits_prequant(state: torch.Tensor, q_table: torch.Tensor, t_scale: torch.Tensor):
    """Catalog logits against a pre-quantized table: the [b, h] states
    quantize per row, the int8 x int8 product sums exactly (an fp32 matmul
    of int8 values is exact while h * 127^2 < 2^24, with TF32 off; unlike
    `torch._int_mm` it takes any batch), and both scales apply after it."""
    return _int8_product(quantize_rows(state), q_table, t_scale)


def _int8_product(state_pack, q_table: torch.Tensor, t_scale: torch.Tensor):
    """(q_state, s_scale) x (q_table, t_scale) -> f32 logits."""
    if q_table.shape[1] > _INT8_MAX_HIDDEN:
        raise ValueError(f"int8 logits need hidden size <= {_INT8_MAX_HIDDEN} for exact sums")
    q_state, s_scale = state_pack
    acc = q_state.float() @ q_table.float().T
    return acc * s_scale[:, None] * t_scale[None, :]


def int8_logits(state: torch.Tensor, table: torch.Tensor):
    """Symmetric per-row int8 for both the [b, h] states (dynamic scales)
    and the [V, h] table (static scales; an exported scorer keeps them)."""
    q_table, t_scale = quantize_rows(table)
    return int8_logits_prequant(state.float(), q_table, t_scale)


def chunked_masked_topk(state_pack, tables, logits_fn, seen_items: torch.Tensor, v: int,
                        k: int = 20, item_chunk: int = 65536):
    """Serving top-k over the catalog in `item_chunk`-row blocks: a top-k
    per block and one merge, so the largest score slab is [b, item_chunk].

    state_pack: per-request operands passed to `logits_fn(state_pack,
    *table_slices) -> [b, chunk] f32`; tables: tensors sliced along dim 0
    per block. Seen ids and the padding column mask to -inf as in
    `serving_masked_topk`. The blocks' lists are merged in id order, so a
    stable sort keeps the tie order."""
    n_chunks = -(-v // item_chunk)
    k_eff = min(k, item_chunk)
    if n_chunks * k_eff < k:
        raise ValueError(f"item_chunk={item_chunk} too small to surface top-{k} over {v} items "
                         f"({n_chunks} chunks x {k_eff} kept)")
    seen = seen_items.long()
    vals, ids = [], []
    for start in range(0, v, item_chunk):
        width = min(item_chunk, v - start)
        logits = logits_fn(state_pack, *(t[start:start + width] for t in tables))
        gids = torch.arange(start, start + width, device=logits.device)
        logits = torch.where(gids[None, :] >= 1, logits, float("-inf"))
        local = seen - start
        dump = torch.where((local >= 0) & (local < width), local, width)
        ext = torch.cat([logits, logits.new_zeros((logits.shape[0], 1))], dim=1)
        ext = ext.scatter(1, dump, float("-inf"))[:, :width]
        cv, ci = stable_topk(ext, min(k_eff, width))
        vals.append(cv)
        ids.append(ci + start)
    mvals, mloc = stable_topk(torch.cat(vals, dim=1), k)
    return mvals, torch.gather(torch.cat(ids, dim=1), 1, mloc)


class _ScoringModule(nn.Module):
    """The serving ranking as a module of (input_ids, user_ids,
    seen_items) -> [b, k] int32 ids: the state `predict(...)[:, -1]`
    against `table[:item_size]` (the tied-table matmul of
    `src/trainers.py:62-68`), masked by the serving contract. Under a
    bf16 `dtype` the non-int8 layouts score rounded operands."""

    def __init__(self, model: nn.Module, item_size: int, k: int = 20, quant: str | None = None,
                 impl: str = "bitmask", item_chunk: int = 65536, dtype: str = "float32"):
        super().__init__()
        if quant not in (None, "int8"):
            raise ValueError(f"unknown serving quantization {quant!r}")
        if impl not in IMPLS:
            raise ValueError(f"unknown serving impl {impl!r}")
        self.model = model
        self.item_size, self.k, self.quant, self.impl = item_size, k, quant, impl
        self.item_chunk = item_chunk
        self.bf16 = is_bf16(dtype) and quant is None
        if quant == "int8":  # the table's int8 rows and scales, computed once
            with torch.no_grad():
                q_table, t_scale = quantize_rows(model.item_table[:item_size])
            self.register_buffer("q_table", q_table)
            self.register_buffer("t_scale", t_scale)
        elif self.bf16:  # the bf16-rounded table, computed once
            with torch.no_grad():
                self.register_buffer("rounded_table", rounded(model.item_table[:item_size], True))

    def forward(self, input_ids, user_ids, seen_items):
        state = self.model.predict(input_ids, user_ids)[:, -1, :].float()
        if self.bf16:
            state, table = rounded(state, True), self.rounded_table
        else:
            table = self.model.item_table[:self.item_size]
        if self.impl == "chunked":
            if self.quant == "int8":
                _, ids = chunked_masked_topk(
                    quantize_rows(state), (self.q_table, self.t_scale), _int8_product,
                    seen_items, self.item_size, self.k, self.item_chunk)
            else:
                _, ids = chunked_masked_topk(state, (table,), lambda s, t: s @ t.float().T,
                                             seen_items, self.item_size, self.k, self.item_chunk)
            return ids.int()
        if self.quant is None and self.impl == "bitmask":
            return bitmask_masked_topk(state, table, seen_items, self.k)[1].int()
        if self.quant == "int8":
            logits = int8_logits_prequant(state, self.q_table, self.t_scale)
        else:
            logits = state @ table.float().T
        mask_topk = filtered_masked_topk if self.impl == "filtered" else serving_masked_topk
        return mask_topk(logits, seen_items, self.k)[1].int()


def build_scoring_fn(model: nn.Module, item_size: int, k: int = 20, quant: str | None = None,
                     impl: str = "bitmask", item_chunk: int = 65536,
                     dtype: str = "float32") -> nn.Module:
    """The serving ranking computation over `model`'s weights, as a module
    of (input_ids, user_ids, seen_items) -> [b, k] int32 ids. `quant="int8"`
    swaps the catalog matmul for `int8_logits`; `impl` picks the layout
    and `dtype` the logits' operand rounding (module docstring)."""
    return _ScoringModule(model, item_size, k=k, quant=quant, impl=impl, item_chunk=item_chunk,
                          dtype=dtype)


def export_scorer(model: nn.Module, item_size: int, max_len: int, seen_width: int, path: str,
                  quant: str | None = None, impl: str = "bitmask",
                  item_chunk: int = 65536, dtype: str = "float32") -> dict:
    """Export the weights-baked scorer on the model's device to `path`
    (`.pt2`); returns its metadata, which the artifact also holds, with
    the file's bytes and the export's seconds."""
    from torch.export import Dim

    t0 = time.perf_counter()
    device = model.item_table.device
    was_training = model.training
    model.eval()
    try:
        module = build_scoring_fn(model, item_size, quant=quant, impl=impl,
                                  item_chunk=item_chunk, dtype=dtype)
        b = Dim("b", min=1)
        example = (torch.ones((2, max_len), dtype=torch.int32, device=device),
                   torch.zeros((2,), dtype=torch.int32, device=device),
                   torch.zeros((2, seen_width), dtype=torch.int32, device=device))
        with torch.no_grad():
            program = torch.export.export(module, example,
                                          dynamic_shapes=({0: b}, {0: b}, {0: b}))
    finally:
        model.train(was_training)
    meta = {
        "path": path, "call": SERVING_CALL_DOC, "device": device.type, "max_len": max_len,
        # the user-table size of a model that reads user ids (Caser), else None
        "num_users": model.config.num_users if model.reads_users else None,
        "seen_width": seen_width, "item_size": item_size, "quant": quant or "none",
        "impl": impl, "item_chunk": item_chunk if impl == "chunked" else None,
        "dtype": dtype,
    }
    torch.export.save(program, path, extra_files={_META_FILE: json.dumps(meta)})
    meta["bytes"] = os.path.getsize(path)
    meta["seconds"] = round(time.perf_counter() - t0, 3)
    return meta


class Scorer:
    """A loaded serving artifact. `topk(input_ids, user_ids, seen_items)
    -> [b, 20] ranked item ids` at any batch size. Calls from several
    threads take turns: they would share one CUDA stream anyway."""

    def __init__(self, program, meta: dict, device: torch.device):
        self._module = program.module()
        self.meta = meta
        self.device = device
        self._lock = threading.Lock()

    @property
    def max_len(self) -> int:
        return self.meta["max_len"]

    @property
    def seen_width(self) -> int:
        return self.meta["seen_width"]

    @property
    def item_size(self) -> int:
        return self.meta["item_size"]

    def topk(self, input_ids, user_ids=None, seen_items=None) -> np.ndarray:
        """Inputs are checked on the host: an id outside [0, item_size), or
        a user id outside [0, num_users) for a model that reads them,
        raises ValueError (on the card an embedding lookup out of range
        would fire a device assert; JAX's lookup gives that row NaN
        scores instead)."""
        input_ids = np.asarray(input_ids)
        b = input_ids.shape[0] if input_ids.ndim == 2 else -1
        if input_ids.shape != (b, self.max_len):
            raise ValueError(f"input_ids shape {input_ids.shape}, want [b, {self.max_len}]")
        if input_ids.size and (input_ids.min() < 0 or input_ids.max() >= self.item_size):
            raise ValueError(f"input_ids must lie in [0, {self.item_size})")
        user_ids = np.zeros((b,), np.int32) if user_ids is None else np.asarray(user_ids)
        if seen_items is None:  # mask nothing beyond the padding column
            seen_items = np.zeros((b, self.seen_width), np.int32)
        seen_items = np.asarray(seen_items)
        if user_ids.shape != (b,) or seen_items.shape != (b, self.seen_width):
            raise ValueError(f"user_ids {user_ids.shape} and seen_items {seen_items.shape} must "
                             f"be [{b}] and [{b}, {self.seen_width}]")
        num_users = self.meta.get("num_users")
        if num_users is not None and user_ids.size and (user_ids.min() < 0
                                                        or user_ids.max() >= num_users):
            raise ValueError(f"user_ids must lie in [0, {num_users})")
        args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(self.device)
                for a in (input_ids, user_ids, seen_items)]
        with self._lock, torch.inference_mode():
            return self._module(*args).cpu().numpy()


def load_scorer(path: str, device: str | torch.device = "cuda") -> Scorer:
    """Load an artifact written by `export_scorer` onto `device` (the card
    unless the caller asks for the CPU). Needs the port's op module
    `ops/serving_topk.py` (imported with this one), not its model code or
    a checkpoint. It leaves the matmul precision to the process: fp32
    logits and exact int8 sums need TF32 off (PyTorch's default;
    `config.set_fp32_matmul`, which the serving host calls)."""
    from bsarec_tpu_torch.config import resolve_device

    device = resolve_device(device)
    extra = {_META_FILE: ""}
    program = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META_FILE])
    if meta["device"] != device.type:
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, device)
    return Scorer(program, meta, device)

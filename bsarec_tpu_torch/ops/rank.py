"""Streaming full-catalog masked top-k (counterpart of
`bsarec_tpu/ops/pallas_rank.py`).

`streaming_masked_topk` returns, per user, the top k of the catalog
scores `states @ table.T` without building the [B, V] score matrix on
the card: the CUDA kernel in `csrc/streaming_rank.cu` (which replaces
the Pallas `_rank_kernel`) sweeps the catalog once, on one of four
routes picked by shape:
- the on-chip route (`onchip_route`: B <= 256, H <= 64, k <= 32): a
  sample pass bounds each row's k-th score from below, then one block per
  SM holds the whole batch and skips every score under the bound;
- the middle route (`mid_route`: B <= 256, 64 < H <= 256, k <= 32): one
  block per SM takes the scores of every row x 128 items a tile on
  Hopper's warpgroup MMAs in 3xTF32, which keeps fp32 accuracy, reads the
  table once, and offers each tile's scores to the rows' lists from the
  accumulators;
- the tensor-core route (`tc_route`: H > 256, k <= 32, any B): one block
  per SM takes the scores of 256 rows x 128 items a tile on the tensor
  cores (`mma.sync`) in 3xTF32, reads the table once per 256 rows, and
  offers each tile's scores to the rows' lists from the accumulator
  fragments;
- elsewhere an older sweep that re-stages 64-row batch tiles, with fp32
  FMAs. It stages all of a tile's states ([H, 64]) where they fit and,
  past that (`wide_route`: H > ~670 at k = 20, H > ~454 at k = 128), a
  hidden chunk of 32 at a time beside the table's, so every H % 4 == 0
  and k <= 128 runs.
`streaming_masked_topk.onchip_launches`, `.mid_launches`, `.tc_launches`
and `.wide_launches` count them apart. The on-chip and older routes give
bit-equal results (one FMA chain a score, in ascending h). The middle
and tensor-core routes sum each score in another order: where every
score is exact in any order (integer inputs) their values and ids are
bit-equal to the others', elsewhere their values lie within fp32
rounding of the plain version's, and an id can differ from another
route's only where two scores lie that close. Seen items score
`seen_value`: 0.0 for eval (the reference's `src/trainers.py:134`, what
the TPU kernel gives them) and -inf for serving (`ops/serving_topk.py`),
where a seen item never enters the result. Columns >= n_valid score
-inf, ties go to the smallest item id, and slots never filled are
(-inf, 0) — exactly what the TPU kernel returns.

Seen items arrive as a packed bitmask. The port's layout is linear:
item v is bit `v & 31` of word `v >> 5`, [B, ceil(V/32)] int32, and the
builders set item 0's bit (on a vocab-sharded table, shard 0's only:
their `id_offset` and `mask_item0`). (The JAX package's bit-plane layout
exists for the TPU's lanes; only the seen sets carry over.)

On a CPU tensor the wrapper runs the plain PyTorch version beside it;
on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from bsarec_tpu_torch import native
from bsarec_tpu_torch.ops._launch import call_on, raw_stream, sm_count

NEG_INF = float("-inf")
MAX_K = 128
WORD_BITS = 32

# Above this many bytes of staged [num_users, ceil(V/32)] bitmasks (valid +
# test splits together), the Trainer keeps the [U, S] seen-id lists on
# the device instead and builds each batch's bitmask there
# (`seen_ids_to_bitmask`): a 1M-item x 50k-user catalog would stage
# 2 x 6.25 GB.
SEEN_BITMASK_STAGE_LIMIT = 256 * 2**20


def seen_words(vocab_size: int) -> int:
    """Words per bitmask row."""
    return -(-vocab_size // WORD_BITS)


def build_seen_bitmask(seen_items: np.ndarray, vocab_size: int, id_offset: int = 0,
                       mask_item0: bool = True) -> np.ndarray:
    """[B, S] 0-padded seen-item lists -> [B, ceil(V/32)] int32 bitmask
    (host side) of the items [id_offset, id_offset + vocab_size), in
    shard-local coordinates (`pallas_rank.py:38-83`): an id v > 0 with
    0 <= v - id_offset < vocab_size sets local bit v - id_offset, other
    ids are dropped, and local item 0's bit is set where `mask_item0`
    (the shard that holds the padding item). The defaults are the whole
    table. Through the native library where it loads
    (`native.seen_bitmask`), else in numpy, bit for bit the same."""
    built = native.seen_bitmask(seen_items, vocab_size, id_offset, mask_item0)
    if built is not None:
        return built
    out = np.zeros((seen_items.shape[0], seen_words(vocab_size)), np.uint32)
    if mask_item0:
        out[:, 0] |= 1
    rows = np.repeat(np.arange(seen_items.shape[0]), seen_items.shape[1])
    raw = seen_items.reshape(-1).astype(np.int64)
    ids = raw - id_offset
    keep = (raw > 0) & (ids >= 0) & (ids < vocab_size)
    rows, ids = rows[keep], ids[keep]
    np.bitwise_or.at(out, (rows, ids >> 5), np.uint32(1) << (ids & 31).astype(np.uint32))
    return out.view(np.int32)


def build_seen_bitmask_sharded(seen_items: np.ndarray, vocab_size: int,
                               n_shards: int) -> np.ndarray:
    """[n_shards, B, ceil(rows/32)] int32: shard s's bitmask of its rows
    [s * rows, (s + 1) * rows), rows = vocab_size / n_shards, in its own
    coordinates (`pallas_rank.py:146-162`); item 0's bit on shard 0 only."""
    if vocab_size % n_shards:
        raise ValueError(f"{vocab_size} rows do not split into {n_shards} shards")
    rows = vocab_size // n_shards
    return np.stack([build_seen_bitmask(seen_items, rows, id_offset=s * rows, mask_item0=s == 0)
                     for s in range(n_shards)])


def dedupe_seen_rows(seen_items: np.ndarray) -> np.ndarray:
    """Zero duplicate ids within each row. `seen_ids_to_bitmask` ORs
    single-bit words with a scatter-add, which is OR only when each
    (row, id) appears once. Returns a sorted, 0-padded copy."""
    s = np.sort(seen_items.astype(np.int32), axis=1)
    dup = np.zeros_like(s, dtype=bool)
    dup[:, 1:] = s[:, 1:] == s[:, :-1]
    s[dup] = 0
    return s


def seen_ids_to_bitmask(seen_ids: torch.Tensor, vocab_size: int, id_offset: int = 0,
                        mask_item0: bool = True) -> torch.Tensor:
    """Device-side `build_seen_bitmask`: [B, S] 0-padded seen-id lists,
    UNIQUE per row (`dedupe_seen_rows`) -> [B, ceil(V/32)] int32, with the
    same shard arguments.

    torch's scatter has no bitwise OR, so single-bit words are added:
    distinct ids land on distinct (word, bit) pairs, so no carry occurs,
    and int32 wrap-around makes bit 31 add like the others. Padding and
    ids outside the shard add 0 to word 0; local item 0's bit, which then
    no kept id shares but the shard's first item, is set where
    `mask_item0`. On a shard other than the first, local item 0 is a real
    item: its bit comes from the ids alone."""
    raw = seen_ids.long()
    ids = raw - id_offset
    keep = (raw > 0) & (ids >= 0) & (ids < vocab_size)
    ids = torch.where(keep, ids, 0)
    bit = torch.where(keep, torch.ones_like(ids) << (ids & 31), torch.zeros_like(ids))
    bit = torch.where(bit >= 2**31, bit - 2**32, bit).int()  # two's-complement int32
    out = torch.zeros((ids.shape[0], seen_words(vocab_size)), dtype=torch.int32,
                      device=seen_ids.device)
    out.scatter_add_(1, ids >> 5, bit)
    if mask_item0:
        out[:, 0] |= 1
    return out


def streaming_masked_topk_plain(states: torch.Tensor, table: torch.Tensor,
                                seen_bitmask: torch.Tensor, k: int = 20,
                                n_valid: int | None = None, chunk: int = 65536,
                                seen_value: float = 0.0):
    """Plain PyTorch version of the kernel, chunked over the catalog.

    Keeps a running (values, ids) list sorted by (value desc, id asc):
    each chunk's masked scores are appended after it (their ids are all
    larger) and a stable descending sort keeps equal values in id order."""
    b = states.shape[0]
    v = table.shape[0]
    n_valid = v if n_valid is None else n_valid
    dev = states.device
    vals = torch.full((b, k), NEG_INF, dtype=torch.float32, device=dev)
    ids = torch.zeros((b, k), dtype=torch.int64, device=dev)
    for j0 in range(0, v, chunk):
        j1 = min(v, j0 + chunk)
        cols = torch.arange(j0, j1, device=dev)
        scores = states.float() @ table[j0:j1].float().T
        words = seen_bitmask[:, cols >> 5]
        seen = ((words >> (cols & 31).int()) & 1).bool()
        scores = torch.where(seen, seen_value, scores)
        scores = torch.where(cols < n_valid, scores, NEG_INF)
        cat_v = torch.cat([vals, scores], dim=1)
        cat_i = torch.cat([ids, cols.expand(b, -1)], dim=1)
        sv, order = torch.sort(cat_v, dim=1, descending=True, stable=True)
        vals = sv[:, :k]
        ids = torch.gather(cat_i, 1, order[:, :k])
    ids = torch.where(vals == NEG_INF, 0, ids)
    return vals, ids.int()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at first use) with its C signatures."""
    from bsarec_tpu_torch.ops import _build

    return bind(_build.load("streaming_rank"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """`lib` (a build of `csrc/streaming_rank.cu`) with its C signatures set."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.streaming_rank.argtypes = [p, p, p, i, i, i, i, i, f, i, i, i, i, i, i, p, p, p, p, p, p,
                                   p, p]
    lib.streaming_rank.restype = ctypes.c_int
    lib.streaming_rank_error.argtypes = [i]
    lib.streaming_rank_error.restype = ctypes.c_char_p
    lib.streaming_rank_smem_bytes.argtypes = [i, i, i]
    lib.streaming_rank_smem_bytes.restype = ctypes.c_longlong
    lib.streaming_rank_onchip.argtypes = [i, i, i]
    lib.streaming_rank_onchip.restype = ctypes.c_int
    lib.streaming_rank_tc.argtypes = [i, i, i]
    lib.streaming_rank_tc.restype = ctypes.c_int
    lib.streaming_rank_mid.argtypes = [i, i, i]
    lib.streaming_rank_mid.restype = ctypes.c_int
    lib.streaming_rank_wide.argtypes = [i, i]
    lib.streaming_rank_wide.restype = ctypes.c_int
    lib.streaming_rank_overflow_bytes.argtypes = [i]
    lib.streaming_rank_overflow_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def onchip_route(b: int, h: int, k: int) -> bool:
    """True where the kernel takes its on-chip route (the whole batch held
    in one block per SM, warp-private top-k lists), by shape."""
    return bool(_lib().streaming_rank_onchip(b, h, k))


@functools.cache
def tc_route(b: int, h: int, k: int) -> bool:
    """True where the kernel takes its tensor-core route (the scores in
    3xTF32, a top-k epilogue over the accumulator fragments), by shape."""
    return bool(_lib().streaming_rank_tc(b, h, k))


@functools.cache
def mid_route(b: int, h: int, k: int) -> bool:
    """True where the kernel takes its middle route (the scores on the
    warpgroup MMAs in 3xTF32 for every row at once, the tensor-core
    route's top-k epilogue), by shape."""
    return bool(_lib().streaming_rank_mid(b, h, k))


@functools.cache
def wide_route(h: int, k: int) -> bool:
    """True where the older route stages the states in hidden chunks (all
    of them do not fit in shared memory), by shape."""
    return bool(_lib().streaming_rank_wide(h, k))


# kernel tiling (csrc/streaming_rank.cu): rows per block and columns per
# tile of the older route and of the middle and tensor-core routes;
# columns per tile of the on-chip route
_BT, _VT, _ONCHIP_VT = 64, 128, 64


def _splits(b: int, v: int, onchip: bool, sms: int, tc: bool = False) -> tuple[int, int]:
    """(n_splits, tiles_per_split) in tiles of the route's width, every
    split holding a tile: one block per SM on the on-chip, middle and
    tensor-core routes (`tc` for either of the last two: both walk
    128-column tiles), enough blocks for two per SM on the older one."""
    n_tiles = -(-v // (_ONCHIP_VT if onchip else _VT))
    target = sms if onchip or tc else -(-2 * sms // -(-b // _BT))
    per = -(-n_tiles // max(1, min(n_tiles, target)))
    return -(-n_tiles // per), per


def _launch(states, table, seen_bitmask, k, n_valid, allow_onchip=True, taken=None,
            seen_value=0.0, allow_tc=True, allow_mid=True):
    """Both passes of the kernel. `allow_onchip=False`, `allow_mid=False`
    and `allow_tc=False` keep the older route at any shape, and `taken` (an
    int64 [1] tensor on the card) receives the count of scores the on-chip
    route's lists took: all four serve only the checks and the timing
    tools."""
    b, h = states.shape
    v = table.shape[0]
    dev = states.device
    for name, t, dtype in (("states", states, torch.float32), ("table", table, torch.float32),
                           ("seen_bitmask", seen_bitmask, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if table.shape[1] != h or h % 4 or seen_bitmask.shape != (b, seen_words(v)):
        raise ValueError(
            f"shapes: states {tuple(states.shape)}, table {tuple(table.shape)}, "
            f"bitmask {tuple(seen_bitmask.shape)} (need H % 4 == 0, bitmask [B, ceil(V/32)])"
        )
    lib = _lib()
    index = states.get_device()
    onchip = allow_onchip and onchip_route(b, h, k)
    mid = not onchip and allow_mid and mid_route(b, h, k)
    tc = not onchip and not mid and allow_tc and tc_route(b, h, k)
    n_splits, per = _splits(b, v, onchip, sm_count(index), tc or mid)
    part_v = torch.empty((n_splits, b, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((n_splits, b, k), dtype=torch.int32, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    ids = torch.empty((b, k), dtype=torch.int32, device=dev)
    # the on-chip route's sample: 64 bucket maxima a row; the middle and
    # tensor-core routes' overflow area: a split's offers of a tile past a
    # row's shared slots
    buckets = torch.empty((b, 64), dtype=torch.int32, device=dev) if onchip else None
    overflow = (torch.empty((lib.streaming_rank_overflow_bytes(n_splits),), dtype=torch.uint8,
                            device=dev) if tc or mid else None)
    rc = call_on(index, lib.streaming_rank, states.data_ptr(), table.data_ptr(),
                 seen_bitmask.data_ptr(), b, v, h, seen_bitmask.shape[1], n_valid, seen_value,
                 k, n_splits, per, int(allow_onchip), int(allow_tc), int(allow_mid),
                 None if buckets is None else buckets.data_ptr(),
                 None if overflow is None else overflow.data_ptr(),
                 part_v.data_ptr(), part_i.data_ptr(), vals.data_ptr(), ids.data_ptr(),
                 None if taken is None else taken.data_ptr(), raw_stream(index))
    if rc != 0:
        raise RuntimeError(
            f"streaming_rank launch failed ({rc}: {lib.streaming_rank_error(rc).decode()}); "
            f"B={b} V={v} H={h} k={k}, shared memory "
            f"{lib.streaming_rank_smem_bytes(h, k, 1 if onchip else 2 if tc else 3 if mid else 0)} "
            f"bytes"
        )
    streaming_masked_topk.launches += 1
    streaming_masked_topk.onchip_launches += onchip
    streaming_masked_topk.mid_launches += mid
    streaming_masked_topk.tc_launches += tc
    streaming_masked_topk.wide_launches += not onchip and not mid and not tc and wide_route(h, k)
    return vals, ids


def streaming_masked_topk(states: torch.Tensor, table: torch.Tensor,
                          seen_bitmask: torch.Tensor, k: int = 20,
                          n_valid: int | None = None, seen_value: float = 0.0):
    """states [B, H] f32, table [V, H] f32, seen_bitmask [B, ceil(V/32)]
    int32 -> (values [B, k] f32, item ids [B, k] int32), 1 <= k <= 128.
    A seen item scores `seen_value`, 0.0 or -inf."""
    n_valid = table.shape[0] if n_valid is None else n_valid
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k must be in [1, {MAX_K}], got {k}")
    if not 0 <= n_valid <= table.shape[0]:
        raise ValueError(f"n_valid must be in [0, {table.shape[0]}], got {n_valid}")
    if seen_value not in (0.0, NEG_INF):
        raise ValueError(f"seen_value must be 0.0 (eval) or -inf (serving), got {seen_value}")
    if states.device.type == "cpu":
        return streaming_masked_topk_plain(states, table, seen_bitmask, k, n_valid,
                                           seen_value=seen_value)
    if states.device.type != "cuda":
        raise ValueError(f"unsupported device {states.device}")
    return _launch(states, table, seen_bitmask, k, n_valid, seen_value=seen_value)


streaming_masked_topk.launches = 0  # kernel launches (CUDA path only)
streaming_masked_topk.onchip_launches = 0  # the launches that took the on-chip route
streaming_masked_topk.mid_launches = 0  # ... the middle route (rank_mid_tf32_kernel)
streaming_masked_topk.tc_launches = 0  # ... the tensor-core route (rank_wide_tf32_kernel)
streaming_masked_topk.wide_launches = 0  # the older route's launches in its wide form

"""Streaming full-catalog softmax cross-entropy (counterpart of
`bsarec_tpu/ops/pallas_ce.py`).

`streaming_softmax_ce(states, table, answers)` gives the per-row loss
`logsumexp(states @ table.T) - <states, table[answers]>` without
building the [B, V] logit matrix on the card. Three CUDA kernels in
`csrc/streaming_ce.cu` replace the three Pallas kernels:

- `ce_logz` (the Pallas `_fwd_kernel`): per-row logZ over the columns
  < n_valid, one online-softmax sweep over the catalog. `ce_loss_logz`
  launches the same kernel with the answers: its merge pass also takes
  the gold logit and gives (loss, logZ) in one call;
- `gold_rows` (the Pallas `_gather_kernel`): the answers' table rows,
  zeros for answers outside [0, V). The training path does not run it:
  it stays as `_gather_kernel`'s counterpart and as the yardstick of the
  fused gold terms;
- `ce_grads` (the Pallas `_grads_kernel`): one sweep that recomputes the
  logits and gives ds = p @ T - dloss · T[a] and dT = pᵀ @ s with
  p = softmax · dloss, then dT[a_i] -= dloss_i · s_i, duplicate answers
  accumulating. Its ds-reduce pass takes the gold term, which the JAX
  package composes outside the kernel with its gather
  (`pallas_ce.py:553-555`).

Both sweeps take one of three routes, by shape: at B <= 256 and H <= 64
(`onchip_route`) the batch (and the backward's ds) stays on chip for the
whole sweep, one block per SM; at H > 256 (`wide_route`) the wide
kernels stage the hidden dimension in chunks, so their shared memory does
not grow with H; elsewhere the older sweeps re-stage 64-row batch tiles
with whole rows, two blocks per SM, but for the bf16 form at B <= 256
and 64 < H <= 256 (`mid_route`, the middle route, below).
`ce_logz.onchip_launches`, `ce_grads.onchip_launches`,
`ce_logz.wide_launches` and `ce_grads.wide_launches` count the first two
apart. On the on-chip route the fp32 form runs fp32 FMA kernels and the
bf16 form its own kernels on
the tensor cores (`mma.sync` bf16 products with fp32 sums, every state
row staged once in bf16, the table tiles rounded on chip):
`ce_fwd_onchip_tc_kernel` (256 batch rows x 128 catalog columns a tile)
and `ce_bwd_onchip_tc_kernel` (64-column tiles, the split's ds held in
registers); `onchip_launches` with `bf16_launches` counts them. On the wide route
both sweeps run on the tensor cores in both forms, one block per SM, so
`wide_launches` (with `bf16_launches` for the form) counts the
tensor-core kernels' launches. The forward takes 256 batch rows x 128
catalog columns a tile and reads the table once:
`ce_fwd_wide_tf32_kernel` in the fp32 form (the logits in 3xTF32: each
fp32 operand split into two TF32 parts, three tensor-core passes, fp32
accuracy) and `ce_fwd_wide_tc_kernel` in the bf16 form (the states
rounded into a bf16 scratch first). The backward holds the p of up to
256 batch rows for a tile of catalog columns: `ce_bwd_wide_tf32_kernel`
in the fp32 form (128-column tiles, every product in 3xTF32) and
`ce_bwd_wide_tc_kernel` in the bf16 form (256-column tiles). On the
middle route the bf16 form runs its own pair on the tensor cores, one
block per SM, every state row staged once in bf16 straight from the fp32
states (no states scratch, no extra launch): `ce_fwd_mid_tc_kernel`
(256 batch rows x 128 catalog columns a tile, the wide forward's
epilogue) and `ce_bwd_mid_tc_kernel` (128-column tiles, p held beside the
states, ds_part in the wide backward's fragment order);
`ce_logz.mid_launches` and `ce_grads.mid_launches` count them (the fp32
form at those shapes runs the older sweeps). The kernels take every H % 4 == 0
(JAX's kernels take an H that divides 128 or is a multiple of 128, all
of it inside that); the workspaces (the splits' partials, and in the
bf16 form's wide kernels bf16 copies of the states and, backward, of a
table tile a split) and the outputs are the only memory that grows with
H.

Answers are the model's ids as they are. The kernels test 0 <= a <
n_valid themselves: a row whose answer fails it has gold 0 and no
one-hot term. So a step's CE is one kernel call each way.

Two forms, as the JAX package's `dtype` argument: float32 (None or
"float32") and the bf16-operand form ("bfloat16", the `--dtype bf16`
policy, `pallas_ce.py:234-237,303-310,360-362,378,393,397-398`): the
states and table rows are rounded to bf16 before every product, and so
is the backward's p = softmax · dloss; every sum, logZ and both
gradients stay float32, and the one-hot corrections dT[a] -= d·s and
ds -= d·T[a] take the unrounded float32 states and rows
(`pallas_ce.py:507-514,553-555`). Inputs and outputs are float32 in both
forms: the kernels round as they stage, so the table is never copied.
Any other dtype raises. `ce_logz.bf16_launches` and
`ce_grads.bf16_launches` count the bf16 form's launches apart.

Beside each kernel is its plain PyTorch version (`ce_logz_plain`,
`ce_loss_logz_plain`, `gold_rows_plain`, `ce_grads_plain`, each with a
`bf16` flag), chunked over the catalog. On a CPU tensor the wrappers run
the plain version; on a CUDA tensor they launch the kernel or raise. The
TPU layout work (lane packing, lane-replicated row scalars, 8-row-aligned
DMA windows, padding the catalog to an even tile count) has no
counterpart here.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from bsarec_tpu_torch.ops._launch import call_on, raw_stream, sm_count
from bsarec_tpu_torch.ops.precision import is_bf16, rounded

NEG_INF = float("-inf")
PLAIN_CHUNK = 65536  # catalog columns per step of the plain versions


def _resolve_n_valid(table: torch.Tensor, n_valid: int | None) -> int:
    v = table.shape[0]
    n_valid = v if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= v:
        raise ValueError(f"n_valid must be in [0, {v}], got {n_valid}")
    return n_valid


def map_answers(answers: torch.Tensor, n_valid: int) -> torch.Tensor:
    """int32 answers with every id outside [0, n_valid) mapped to -1
    (`pallas_ce.py:631-633`): such a row has gold 0 and no one-hot term.
    The plain versions gather with it; the kernels test the range
    themselves."""
    a = answers.long()
    return torch.where((a >= 0) & (a < n_valid), a, -1).to(torch.int32)


def _int64(answers: torch.Tensor) -> torch.Tensor:
    return answers if answers.dtype == torch.int64 else answers.long()


# ---- plain PyTorch versions ------------------------------------------------


def ce_logz_plain(states: torch.Tensor, table: torch.Tensor, n_valid: int,
                  chunk: int = PLAIN_CHUNK, bf16: bool = False) -> torch.Tensor:
    """[B] logsumexp of states @ table[:n_valid].T, one chunk of the
    catalog at a time (-inf when n_valid is 0); with `bf16`, of the
    bf16-rounded operands' product (exact products, fp32 sums)."""
    logz = torch.full((states.shape[0],), NEG_INF, dtype=torch.float32, device=states.device)
    s = rounded(states, bf16)
    for j0 in range(0, n_valid, chunk):
        part = torch.logsumexp(s @ rounded(table[j0:min(n_valid, j0 + chunk)], bf16).T, dim=1)
        logz = torch.logaddexp(logz, part)
    return logz


def gold_rows_plain(table: torch.Tensor, answers: torch.Tensor) -> torch.Tensor:
    """[B, H] rows table[answers], zeros where an answer is outside [0, V)."""
    a = answers.long()
    keep = (a >= 0) & (a < table.shape[0])
    rows = table[a.clamp(0, table.shape[0] - 1)]
    return torch.where(keep[:, None], rows, torch.zeros_like(rows))


def ce_loss_logz_plain(states: torch.Tensor, table: torch.Tensor, answers: torch.Tensor,
                       n_valid: int, chunk: int = PLAIN_CHUNK,
                       bf16: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, logZ) [B]: `ce_logz_plain`, and loss = logZ - <s, T[a]> from
    the gathered rows, gold 0 for answers outside [0, n_valid); with
    `bf16`, both from bf16-rounded operands."""
    logz = ce_logz_plain(states, table, n_valid, chunk, bf16)
    rows = gold_rows_plain(table, map_answers(answers, n_valid))
    gold = (rounded(rows, bf16) * rounded(states, bf16)).sum(dim=1)
    return logz - gold, logz


def ce_grads_plain(states: torch.Tensor, table: torch.Tensor, answers: torch.Tensor,
                   logz: torch.Tensor, dloss: torch.Tensor, n_valid: int,
                   chunk: int = PLAIN_CHUNK, bf16: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(ds, dT): ds = p @ T, dT = pᵀ @ s with p = exp(s @ Tᵀ - logz) ·
    dloss over the columns < n_valid (rows >= n_valid of dT stay 0); then,
    for every answer in [0, n_valid), dT[a_i] -= dloss_i · s_i and
    ds_i -= dloss_i · T[a_i]. With `bf16`, s, T and p are rounded to bf16
    before the three products and the one-hot terms take them unrounded."""
    ds = torch.zeros_like(states)
    dt = torch.zeros_like(table)
    s = rounded(states, bf16)
    for j0 in range(0, n_valid, chunk):
        j1 = min(n_valid, j0 + chunk)
        tile = rounded(table[j0:j1], bf16)
        p = rounded(torch.exp(s @ tile.T - logz[:, None]) * dloss[:, None], bf16)
        ds += p @ tile
        dt[j0:j1] = p.T @ s
    a = answers.long()
    keep = (a >= 0) & (a < n_valid)
    dt.index_add_(0, a[keep], -(dloss[keep, None] * states[keep]))
    ds = ds - dloss[:, None] * gold_rows_plain(table, torch.where(keep, a, -1))
    return ds, dt


# ---- CUDA kernels ------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at first use) with its C signatures."""
    from bsarec_tpu_torch.ops import _build

    lib = _build.load("streaming_ce")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ce_logz.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, i, p]
    lib.ce_logz.restype = i
    lib.ce_gold_rows.argtypes = [p, p, i, i, i, p, p]
    lib.ce_gold_rows.restype = i
    lib.ce_grads.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p, p, p, i, p]
    lib.ce_grads.restype = i
    lib.ce_grads_workspace_bytes.argtypes = [i, i, i, i]
    lib.ce_grads_workspace_bytes.restype = ctypes.c_longlong
    lib.ce_logz_workspace_bytes.argtypes = [i, i, i, i]
    lib.ce_logz_workspace_bytes.restype = ctypes.c_longlong
    lib.streaming_ce_error.argtypes = [i]
    lib.streaming_ce_error.restype = ctypes.c_char_p
    lib.streaming_ce_smem_bytes.argtypes = [i, i, i, i]
    lib.streaming_ce_smem_bytes.restype = ctypes.c_longlong
    lib.ce_onchip_route.argtypes = [i, i]
    lib.ce_onchip_route.restype = i
    lib.ce_wide_route.argtypes = [i]
    lib.ce_wide_route.restype = i
    lib.ce_mid_route.argtypes = [i, i]
    lib.ce_mid_route.restype = i
    return lib


@functools.cache
def onchip_route(b: int, h: int) -> bool:
    """True where `ce_logz` and `ce_grads` take their kernels' on-chip
    routes (the batch held in one block per SM for the whole sweep), by
    shape."""
    return bool(_lib().ce_onchip_route(b, h))


@functools.cache
def wide_route(h: int) -> bool:
    """True where `ce_logz` and `ce_grads` take their kernels' wide routes
    (the hidden dimension staged in chunks, H > 256), by shape."""
    return bool(_lib().ce_wide_route(h))


@functools.cache
def mid_route(b: int, h: int) -> bool:
    """True where the bf16 form of `ce_logz` and `ce_grads` takes its
    middle route (B <= 256, 64 < H <= 256: ce_fwd_mid_tc_kernel and
    ce_bwd_mid_tc_kernel), by shape; the fp32 form takes the older sweeps
    there."""
    return bool(_lib().ce_mid_route(b, h))


# kernel tiling (csrc/streaming_ce.cu): batch rows per tile, columns per
# tile, columns per tile of the tensor-core kernels (the forward in both
# forms, the bf16 backward, the fp32 backward, the bf16 middle route's
# backward)
_BT, _VT, _TC_FWD_VT, _TC_VT, _TF_VT, _MID_VT = 64, 64, 128, 256, 128, 128


def _require(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, index: int,
             aligned: bool = False) -> None:
    """Raise unless t is a contiguous `dtype` tensor of `shape` on card
    `index` (16-byte aligned where the kernel reads it by float4)."""
    if t.dtype != dtype or t.get_device() != index or not t.is_contiguous() or t.shape != shape:
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape {shape} on "
                         f"cuda:{index}; got {t.dtype} {tuple(t.shape)} on {t.device}")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _check_table(table: torch.Tensor) -> tuple[int, int, int]:
    """(V, H, device index) of a float32 table [V, H]."""
    v, h = table.shape
    if h % 4 or h < 4:
        raise ValueError(f"the CE kernels take H % 4 == 0 and H >= 4, got H={h}")
    index = table.get_device()
    _require("table", table, torch.float32, (v, h), index, aligned=True)
    return v, h, index


def _check_matrices(states: torch.Tensor, table: torch.Tensor) -> tuple[int, int, int, int]:
    """(B, V, H, device index) of a float32 states [B, H] and table [V, H]."""
    v, h, index = _check_table(table)
    b = states.shape[0]
    _require("states", states, torch.float32, (b, h), index, aligned=True)
    return b, v, h, index


def _raise(what: str, rc: int, b: int, v: int, h: int, which: int | None = None,
           bf16: bool = False) -> None:
    lib = _lib()
    smem = ("" if which is None else
            f", shared memory {lib.streaming_ce_smem_bytes(b, h, which, int(bf16))} bytes")
    raise RuntimeError(f"{what} launch failed ({rc}: {lib.streaming_ce_error(rc).decode()}); "
                       f"B={b} V={v} H={h}{smem}")


def _even_splits(n_tiles: int, n_splits: int) -> tuple[int, int]:
    """(n_splits, tiles_per_split) with every split holding a tile."""
    per = -(-n_tiles // max(1, min(n_tiles, n_splits)))
    return -(-n_tiles // per), per


def tc_splits(v: int, tile: int, sms: int) -> tuple[int, int]:
    """(n_splits, tiles_per_split) of a tensor-core kernel that walks V
    catalog columns in tiles of `tile` columns, one block per SM of `sms`:
    each split whole tiles, at least one, the splits covering V;
    tiles_per_split in the C entries' 64-column units."""
    n_splits, per = _even_splits(-(-v // tile), sms)
    return n_splits, per * (tile // _VT)


def split_plan(b: int, v: int, onchip: bool, wide: bool, bf16: bool, backward: bool,
               sms: int, mid: bool = False) -> tuple[int, int]:
    """(n_splits, tiles_per_split) that `ce_logz` (or, with `backward`,
    `ce_grads`) launches with on `sms` SMs, for the route (`onchip_route`,
    `wide_route`, `mid_route`) and form of batch `b` and catalog `v`: one
    block per SM on the on-chip, middle (bf16) and wide routes, each split
    whole tiles of its kernel (the wide forward's, the bf16 on-chip
    forward's and the bf16 middle route's 128 columns, the wide backward's
    256 (bf16) or 128 (fp32), else 64); on the older sweeps two blocks per
    SM, the forward's over (splits x batch tiles of 64 rows)."""
    if wide:
        tile = (_TC_VT if bf16 else _TF_VT) if backward else _TC_FWD_VT
        return tc_splits(v, tile, sms)
    if mid and bf16:  # ce_fwd_mid_tc_kernel's and ce_bwd_mid_tc_kernel's tiles
        return tc_splits(v, _MID_VT if backward else _TC_FWD_VT, sms)
    if onchip and bf16 and not backward:  # ce_fwd_onchip_tc_kernel's tiles
        return tc_splits(v, _TC_FWD_VT, sms)
    if backward or onchip:
        return _even_splits(-(-v // _VT), (1 if onchip else 2) * sms)
    return _even_splits(-(-v // _VT), -(-2 * sms // -(-b // _BT)))


def _launch_logz(states, table, answers, n_valid, bf16=False):
    """(loss, logZ) from one `ce_logz` call, in the bf16-operand form when
    `bf16`; loss is None when answers is."""
    b, v, h, index = _check_matrices(states, table)
    if answers is not None:
        _require("answers", answers, torch.int64, (b,), index)
    onchip, wide, mid = onchip_route(b, h), wide_route(h), mid_route(b, h)
    n_splits, per = split_plan(b, v, onchip, wide, bf16, False, sm_count(index), mid)
    lib = _lib()
    # the (max, sum) partials, and in the bf16 form on the wide route the
    # bf16 states
    work = states.new_empty((lib.ce_logz_workspace_bytes(b, h, int(bf16), n_splits),),
                            dtype=torch.uint8)
    logz = states.new_empty((b,))
    loss = None if answers is None else states.new_empty((b,))
    rc = call_on(index, lib.ce_logz, states.data_ptr(), table.data_ptr(),
                 None if answers is None else answers.data_ptr(), b, v, h, n_valid, n_splits, per,
                 work.data_ptr(), logz.data_ptr(), None if loss is None else loss.data_ptr(),
                 int(bf16), raw_stream(index))
    if rc != 0:
        _raise("ce_logz", rc, b, v, h, 0, bf16)
    ce_logz.launches += 1
    ce_logz.onchip_launches += onchip
    ce_logz.wide_launches += wide
    ce_logz.mid_launches += mid and bf16
    ce_logz.bf16_launches += bf16
    return loss, logz


def _launch_gold_rows(table, answers):
    v, h, index = _check_table(table)
    b = answers.shape[0]
    _require("answers", answers, torch.int32, (b,), index)
    out = table.new_empty((b, h))
    rc = call_on(index, _lib().ce_gold_rows, table.data_ptr(), answers.data_ptr(), b, v, h,
                 out.data_ptr(), raw_stream(index))
    if rc != 0:
        _raise("ce_gold_rows", rc, b, v, h)
    gold_rows.launches += 1
    return out


def _launch_grads(states, table, answers, logz, dloss, n_valid, bf16=False):
    b, v, h, index = _check_matrices(states, table)
    _require("answers", answers, torch.int64, (b,), index)
    _require("logz", logz, torch.float32, (b,), index)
    _require("dloss", dloss, torch.float32, (b,), index)
    onchip, wide, mid = onchip_route(b, h), wide_route(h), mid_route(b, h)
    n_splits, per = split_plan(b, v, onchip, wide, bf16, True, sm_count(index), mid)
    lib = _lib()
    work = states.new_empty((lib.ce_grads_workspace_bytes(b, h, int(bf16), n_splits),),
                            dtype=torch.uint8)
    ds = states.new_empty((b, h))
    dt = table.new_empty((v, h))
    rc = call_on(index, lib.ce_grads, states.data_ptr(), table.data_ptr(), answers.data_ptr(),
                 logz.data_ptr(), dloss.data_ptr(), b, v, h, n_valid, n_splits, per,
                 work.data_ptr(), ds.data_ptr(), dt.data_ptr(), int(bf16), raw_stream(index))
    if rc != 0:
        _raise("ce_grads", rc, b, v, h, 1, bf16)
    ce_grads.launches += 1
    ce_grads.onchip_launches += onchip
    ce_grads.wide_launches += wide
    ce_grads.mid_launches += mid and bf16
    ce_grads.bf16_launches += bf16
    return ds, dt


def _on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; other devices raise."""
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


# ---- wrappers: plain version on the CPU, the kernel on the card --------------


def ce_logz(states: torch.Tensor, table: torch.Tensor, n_valid: int | None = None,
            dtype: str | None = None) -> torch.Tensor:
    """states [B, H] f32, table [V, H] f32 -> logZ [B] f32 over the columns
    < n_valid, in the form `dtype` names."""
    bf16 = is_bf16(dtype)
    n_valid = _resolve_n_valid(table, n_valid)
    if not _on_card(states):
        return ce_logz_plain(states, table, n_valid, bf16=bf16)
    return _launch_logz(states, table, None, n_valid, bf16)[1]


def ce_loss_logz(states: torch.Tensor, table: torch.Tensor, answers: torch.Tensor,
                 n_valid: int | None = None,
                 dtype: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss [B], logZ [B]) f32: logZ over the columns < n_valid and
    loss = logZ - <states, table[answers]>, gold 0 for answers outside
    [0, n_valid), in the form `dtype` names. One launch of the `ce_logz`
    kernel, counted there."""
    bf16 = is_bf16(dtype)
    n_valid = _resolve_n_valid(table, n_valid)
    if not _on_card(states):
        return ce_loss_logz_plain(states, table, answers, n_valid, bf16=bf16)
    return _launch_logz(states, table, _int64(answers), n_valid, bf16)


def gold_rows(table: torch.Tensor, answers: torch.Tensor) -> torch.Tensor:
    """table [V, H] f32, answers [B] int -> [B, H] f32 rows table[answers],
    zeros for answers outside [0, V)."""
    if not _on_card(table):
        return gold_rows_plain(table, answers)
    if answers.dtype != torch.int32:
        answers = answers.int()
    return _launch_gold_rows(table, answers if answers.is_contiguous() else answers.contiguous())


def ce_grads(states: torch.Tensor, table: torch.Tensor, answers: torch.Tensor,
             logz: torch.Tensor, dloss: torch.Tensor, n_valid: int | None = None,
             dtype: str | None = None):
    """(ds [B, H], dT [V, H]) of `ce_grads_plain`: the finished gradients
    of sum(dloss · loss), in the form `dtype` names. Answers are taken as
    they are."""
    bf16 = is_bf16(dtype)
    n_valid = _resolve_n_valid(table, n_valid)
    if not _on_card(states):
        return ce_grads_plain(states, table, answers, logz, dloss, n_valid, bf16=bf16)
    return _launch_grads(states, table, _int64(answers), logz, dloss, n_valid, bf16)


ce_logz.launches = 0  # kernel launches (CUDA path only), ce_loss_logz's included
ce_logz.onchip_launches = 0  # the launches that took the on-chip route
ce_logz.wide_launches = 0  # the launches that took the wide route (a tensor-core kernel, either form)
ce_logz.mid_launches = 0  # the bf16 form's launches on the middle route (ce_fwd_mid_tc_kernel)
ce_logz.bf16_launches = 0  # the launches in the bf16-operand form
gold_rows.launches = 0
ce_grads.launches = 0
ce_grads.onchip_launches = 0  # the launches that took the on-chip route
ce_grads.wide_launches = 0  # the launches that took the wide route (a tensor-core kernel, either form)
ce_grads.mid_launches = 0  # the bf16 form's launches on the middle route (ce_bwd_mid_tc_kernel)
ce_grads.bf16_launches = 0  # the launches in the bf16-operand form


class _StreamingCE(torch.autograd.Function):
    """Per-row loss logZ - <s, T[a]>, one kernel call each way, in the
    bf16-operand form when `bf16`. `plain` selects the plain versions
    (always on the CPU; on the card, the check of the autograd wiring)."""

    @staticmethod
    def forward(ctx, states, table, answers, n_valid, bf16, plain):
        if plain:
            loss, logz = ce_loss_logz_plain(states, table, answers, n_valid, bf16=bf16)
        else:
            loss, logz = _launch_logz(states, table, answers, n_valid, bf16)
        ctx.save_for_backward(states, table, answers, logz)
        ctx.n_valid, ctx.bf16, ctx.plain = n_valid, bf16, plain
        return loss

    @staticmethod
    @once_differentiable
    def backward(ctx, dloss):
        states, table, answers, logz = ctx.saved_tensors
        args = (states, table, answers, logz, dloss.contiguous(), ctx.n_valid)
        if ctx.plain:
            ds, dt = ce_grads_plain(*args, bf16=ctx.bf16)
        else:
            ds, dt = _launch_grads(*args, ctx.bf16)
        return ds, dt, None, None, None, None


def _apply(states, table, answers, n_valid, dtype, plain):
    bf16 = is_bf16(dtype)
    n_valid = _resolve_n_valid(table, n_valid)
    plain = plain or not _on_card(states)
    return _StreamingCE.apply(states.contiguous(), table.contiguous(),
                              _int64(answers).contiguous(), n_valid, bf16, plain)


def streaming_softmax_ce(states: torch.Tensor, table: torch.Tensor, answers: torch.Tensor,
                         n_valid: int | None = None, dtype: str | None = None) -> torch.Tensor:
    """Per-row CE [B] over the full catalog, differentiable in states and
    table: logsumexp over the columns < n_valid minus the gold logit
    (0 for answers outside [0, n_valid)). `dtype`: None or "float32", or
    "bfloat16" for the bf16-operand form; others raise."""
    return _apply(states, table, answers, n_valid, dtype, plain=False)


def streaming_softmax_ce_plain(states: torch.Tensor, table: torch.Tensor, answers: torch.Tensor,
                               n_valid: int | None = None,
                               dtype: str | None = None) -> torch.Tensor:
    """`streaming_softmax_ce` through the plain versions on any device."""
    return _apply(states, table, answers, n_valid, dtype, plain=True)


# ---- building blocks of the vocab-sharded composition (parallel/logits.py) ----


def streaming_ce_stats(states: torch.Tensor, table: torch.Tensor, answers: torch.Tensor,
                       n_valid: int | None = None, dtype: str | None = None):
    """Per-row (loss_local, logz_local) over THIS table's rows only; not
    differentiable. Answers outside [0, n_valid) (another shard's gold)
    contribute gold 0, so there loss_local == logz_local."""
    with torch.no_grad():
        return ce_loss_logz(states.contiguous(), table, answers, n_valid, dtype)


def streaming_ce_grads(states: torch.Tensor, table: torch.Tensor, answers: torch.Tensor,
                       logz: torch.Tensor, dloss: torch.Tensor, n_valid: int | None = None,
                       dtype: str | None = None):
    """(dstates_partial, dtable) for this shard given the GLOBAL per-row
    logZ: dstates sums only this shard's columns (sum it over the shards),
    dtable covers exactly this shard's rows."""
    with torch.no_grad():
        return ce_grads(states.contiguous(), table, answers, logz.float().contiguous(),
                        dloss.float().contiguous(), n_valid, dtype)

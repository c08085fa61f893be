"""Streaming full-catalog softmax cross-entropy (counterpart of
`bsarec_tpu/ops/pallas_ce.py`).

`streaming_softmax_ce(states, table, answers)` gives the per-row loss
`logsumexp(states @ table.T) - <states, table[answers]>` without
building the [B, V] logit matrix on the card. Three CUDA kernels in
`csrc/streaming_ce.cu` replace the three Pallas kernels:

- `ce_logz` (the Pallas `_fwd_kernel`): per-row logZ over the columns
  < n_valid, one online-softmax sweep over the catalog;
- `gold_rows` (the Pallas `_gather_kernel`): the answers' table rows,
  zeros for answers outside [0, V);
- `ce_grads` (the Pallas `_grads_kernel`): one sweep that recomputes the
  logits and gives ds = p @ T and dT = pᵀ @ s with p = softmax · dloss,
  then dT[a_i] -= dloss_i · s_i, duplicate answers accumulating.

The backward then takes ds -= dloss · T[a] with the gather, as the JAX
package does (`pallas_ce.py:553-555`). Answers < 0 or >= n_valid map to
-1 first: they have gold 0 and no one-hot term.

Beside each kernel is its plain PyTorch version (`ce_logz_plain`,
`gold_rows_plain`, `ce_grads_plain`), chunked over the catalog. On a
CPU tensor the wrappers run the plain version; on a CUDA tensor they
launch the kernel or raise. Only float32 is ported. The TPU layout work
(lane packing, lane-replicated row scalars, 8-row-aligned DMA windows,
padding the catalog to an even tile count) has no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

NEG_INF = float("-inf")
MAX_H = 256
PLAIN_CHUNK = 65536  # catalog columns per step of the plain versions


def _fp32_only(dtype: str | None) -> None:
    if dtype not in (None, "float32"):
        raise NotImplementedError(f"streaming CE dtype {dtype!r} is not ported yet; use float32")


def _resolve_n_valid(table: torch.Tensor, n_valid: int | None) -> int:
    v = table.shape[0]
    n_valid = v if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= v:
        raise ValueError(f"n_valid must be in [0, {v}], got {n_valid}")
    return n_valid


def map_answers(answers: torch.Tensor, n_valid: int) -> torch.Tensor:
    """int32 answers with every id outside [0, n_valid) mapped to -1
    (`pallas_ce.py:631-633`): such a row has gold 0 and no one-hot term."""
    a = answers.to(torch.int32)
    return torch.where((a >= 0) & (a < n_valid), a, torch.full_like(a, -1)).contiguous()


# ---- plain PyTorch versions ------------------------------------------------


def ce_logz_plain(states: torch.Tensor, table: torch.Tensor, n_valid: int,
                  chunk: int = PLAIN_CHUNK) -> torch.Tensor:
    """[B] logsumexp of states @ table[:n_valid].T, one chunk of the
    catalog at a time (-inf when n_valid is 0)."""
    logz = torch.full((states.shape[0],), NEG_INF, dtype=torch.float32, device=states.device)
    for j0 in range(0, n_valid, chunk):
        part = torch.logsumexp(states @ table[j0:min(n_valid, j0 + chunk)].T, dim=1)
        logz = torch.logaddexp(logz, part)
    return logz


def gold_rows_plain(table: torch.Tensor, answers: torch.Tensor) -> torch.Tensor:
    """[B, H] rows table[answers], zeros where an answer is outside [0, V)."""
    a = answers.long()
    keep = (a >= 0) & (a < table.shape[0])
    rows = table[a.clamp(0, table.shape[0] - 1)]
    return torch.where(keep[:, None], rows, torch.zeros_like(rows))


def ce_grads_plain(states: torch.Tensor, table: torch.Tensor, answers: torch.Tensor,
                   logz: torch.Tensor, dloss: torch.Tensor, n_valid: int,
                   chunk: int = PLAIN_CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """(ds, dT): ds = p @ T, dT = pᵀ @ s with p = exp(s @ Tᵀ - logz) ·
    dloss over the columns < n_valid (rows >= n_valid of dT stay 0), then
    dT[a_i] -= dloss_i · s_i for every answer in [0, n_valid)."""
    ds = torch.zeros_like(states)
    dt = torch.zeros_like(table)
    for j0 in range(0, n_valid, chunk):
        j1 = min(n_valid, j0 + chunk)
        tile = table[j0:j1]
        p = torch.exp(states @ tile.T - logz[:, None]) * dloss[:, None]
        ds += p @ tile
        dt[j0:j1] = p.T @ states
    a = answers.long()
    keep = (a >= 0) & (a < n_valid)
    dt.index_add_(0, a[keep], -(dloss[keep, None] * states[keep]))
    return ds, dt


# ---- CUDA kernels ------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel library (built at first use) with its C signatures."""
    from bsarec_tpu_torch.ops import _build

    lib = _build.load("streaming_ce")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ce_logz.argtypes = [p, p, i, i, i, i, i, i, p, p, p, p]
    lib.ce_logz.restype = i
    lib.ce_gold_rows.argtypes = [p, p, i, i, i, p, p]
    lib.ce_gold_rows.restype = i
    lib.ce_grads.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p, p, p, p]
    lib.ce_grads.restype = i
    lib.streaming_ce_error.argtypes = [i]
    lib.streaming_ce_error.restype = ctypes.c_char_p
    lib.streaming_ce_smem_bytes.argtypes = [i, i]
    lib.streaming_ce_smem_bytes.restype = ctypes.c_longlong
    return lib


# kernel tiling (csrc/streaming_ce.cu): batch rows per tile, columns per tile
_BT, _VT = 64, 64


def _check(device: torch.device, **tensors) -> None:
    for name, (t, dtype, shape) in tensors.items():
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want {shape}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _check_table(table: torch.Tensor) -> tuple[int, int]:
    v, h = table.shape
    if h % 4 or not 4 <= h <= MAX_H:
        raise ValueError(f"the CE kernels take H % 4 == 0 and 4 <= H <= {MAX_H}, got H={h}")
    _check(table.device, table=(table, torch.float32, (v, h)))
    return v, h


def _check_matrices(states: torch.Tensor, table: torch.Tensor) -> tuple[int, int, int]:
    v, h = _check_table(table)
    b = states.shape[0]
    _check(table.device, states=(states, torch.float32, (b, h)))
    return b, v, h


def _raise(lib, what: str, rc: int, b: int, v: int, h: int, which: int | None = None) -> None:
    smem = "" if which is None else f", shared memory {lib.streaming_ce_smem_bytes(h, which)} bytes"
    raise RuntimeError(f"{what} launch failed ({rc}: {lib.streaming_ce_error(rc).decode()}); "
                       f"B={b} V={v} H={h}{smem}")


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _even_splits(n_tiles: int, n_splits: int) -> tuple[int, int]:
    """(n_splits, tiles_per_split) with every split holding a tile."""
    per = -(-n_tiles // max(1, min(n_tiles, n_splits)))
    return -(-n_tiles // per), per


def _launch_logz(states, table, n_valid):
    b, v, h = _check_matrices(states, table)
    dev = states.device
    lib = _lib()
    # two blocks per SM over (splits x batch tiles)
    n_splits, per = _even_splits(-(-v // _VT), -(-2 * _sm_count(dev) // -(-b // _BT)))
    part_m = torch.empty((n_splits, b), dtype=torch.float32, device=dev)
    part_s = torch.empty((n_splits, b), dtype=torch.float32, device=dev)
    logz = torch.empty((b,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ce_logz(states.data_ptr(), table.data_ptr(), b, v, h, n_valid, n_splits, per,
                         part_m.data_ptr(), part_s.data_ptr(), logz.data_ptr(),
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        _raise(lib, "ce_logz", rc, b, v, h, 0)
    ce_logz.launches += 1
    return logz


def _launch_gold_rows(table, answers):
    v, h = _check_table(table)
    b = answers.shape[0]
    dev = table.device
    _check(dev, answers=(answers, torch.int32, (b,)))
    lib = _lib()
    out = torch.empty((b, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ce_gold_rows(table.data_ptr(), answers.data_ptr(), b, v, h, out.data_ptr(),
                              torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        _raise(lib, "ce_gold_rows", rc, b, v, h)
    gold_rows.launches += 1
    return out


def _launch_grads(states, table, answers, logz, dloss, n_valid):
    b, v, h = _check_matrices(states, table)
    dev = states.device
    _check(dev, answers=(answers, torch.int32, (b,)), logz=(logz, torch.float32, (b,)),
           dloss=(dloss, torch.float32, (b,)))
    lib = _lib()
    # one block per split, two per SM
    n_splits, per = _even_splits(-(-v // _VT), 2 * _sm_count(dev))
    ds_part = torch.empty((n_splits, b, h), dtype=torch.float32, device=dev)
    ds = torch.empty((b, h), dtype=torch.float32, device=dev)
    dt = torch.empty((v, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ce_grads(states.data_ptr(), table.data_ptr(), answers.data_ptr(),
                          logz.data_ptr(), dloss.data_ptr(), b, v, h, n_valid, n_splits, per,
                          ds_part.data_ptr(), ds.data_ptr(), dt.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        _raise(lib, "ce_grads", rc, b, v, h, 1)
    ce_grads.launches += 1
    return ds, dt


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


# ---- wrappers: plain version on the CPU, the kernel on the card --------------


def ce_logz(states: torch.Tensor, table: torch.Tensor, n_valid: int | None = None) -> torch.Tensor:
    """states [B, H] f32, table [V, H] f32 -> logZ [B] f32 over the columns
    < n_valid."""
    n_valid = _resolve_n_valid(table, n_valid)
    if _device_kind(states) == "cpu":
        return ce_logz_plain(states, table, n_valid)
    return _launch_logz(states, table, n_valid)


def gold_rows(table: torch.Tensor, answers: torch.Tensor) -> torch.Tensor:
    """table [V, H] f32, answers [B] int -> [B, H] f32 rows table[answers],
    zeros for answers outside [0, V)."""
    if _device_kind(table) == "cpu":
        return gold_rows_plain(table, answers)
    return _launch_gold_rows(table, answers.to(torch.int32).contiguous())


def ce_grads(states: torch.Tensor, table: torch.Tensor, answers: torch.Tensor,
             logz: torch.Tensor, dloss: torch.Tensor, n_valid: int | None = None):
    """(ds [B, H], dT [V, H]) of `ce_grads_plain`; answers outside
    [0, n_valid) must already be -1 (`map_answers`)."""
    n_valid = _resolve_n_valid(table, n_valid)
    if _device_kind(states) == "cpu":
        return ce_grads_plain(states, table, answers, logz, dloss, n_valid)
    return _launch_grads(states, table, answers, logz, dloss, n_valid)


ce_logz.launches = 0  # kernel launches (CUDA path only)
gold_rows.launches = 0
ce_grads.launches = 0

_KERNEL_OPS = (ce_logz, gold_rows, ce_grads)
_PLAIN_OPS = (ce_logz_plain, gold_rows_plain, ce_grads_plain)


class _StreamingCE(torch.autograd.Function):
    """Per-row loss logZ - <s, T[a]>; `plain` selects the plain versions
    on any device (the card's check of the autograd wiring)."""

    @staticmethod
    def forward(ctx, states, table, answers, n_valid, plain):
        logz_fn, gold_fn, _ = _PLAIN_OPS if plain else _KERNEL_OPS
        logz = logz_fn(states, table, n_valid)
        gold = (gold_fn(table, answers) * states).sum(dim=1)
        ctx.save_for_backward(states, table, answers, logz)
        ctx.n_valid, ctx.plain = n_valid, plain
        return logz - gold

    @staticmethod
    @once_differentiable
    def backward(ctx, dloss):
        states, table, answers, logz = ctx.saved_tensors
        _, gold_fn, grads_fn = _PLAIN_OPS if ctx.plain else _KERNEL_OPS
        dloss = dloss.contiguous()
        ds, dt = grads_fn(states, table, answers, logz, dloss, ctx.n_valid)
        ds = ds - dloss[:, None] * gold_fn(table, answers)
        return ds, dt, None, None, None


def _apply(states, table, answers, n_valid, dtype, plain):
    _fp32_only(dtype)
    n_valid = _resolve_n_valid(table, n_valid)
    return _StreamingCE.apply(states.contiguous(), table.contiguous(),
                              map_answers(answers, n_valid), n_valid, plain)


def streaming_softmax_ce(states: torch.Tensor, table: torch.Tensor, answers: torch.Tensor,
                         n_valid: int | None = None, dtype: str | None = None) -> torch.Tensor:
    """Per-row CE [B] over the full catalog, differentiable in states and
    table: logsumexp over the columns < n_valid minus the gold logit
    (0 for answers outside [0, n_valid)). Only float32 is ported."""
    return _apply(states, table, answers, n_valid, dtype, plain=False)


def streaming_softmax_ce_plain(states: torch.Tensor, table: torch.Tensor, answers: torch.Tensor,
                               n_valid: int | None = None) -> torch.Tensor:
    """`streaming_softmax_ce` through the plain versions on any device."""
    return _apply(states, table, answers, n_valid, None, plain=True)


# ---- building blocks of the vocab-sharded composition (ROADMAP A12) ----------


def streaming_ce_stats(states: torch.Tensor, table: torch.Tensor, answers: torch.Tensor,
                       n_valid: int | None = None, dtype: str | None = None):
    """Per-row (loss_local, logz_local) over THIS table's rows only; not
    differentiable. Answers outside [0, n_valid) (another shard's gold)
    contribute gold 0, so there loss_local == logz_local."""
    _fp32_only(dtype)
    n_valid = _resolve_n_valid(table, n_valid)
    with torch.no_grad():
        logz = ce_logz(states.contiguous(), table, n_valid)
        gold = (gold_rows(table, map_answers(answers, n_valid)) * states).sum(dim=1)
    return logz - gold, logz


def streaming_ce_grads(states: torch.Tensor, table: torch.Tensor, answers: torch.Tensor,
                       logz: torch.Tensor, dloss: torch.Tensor, n_valid: int | None = None,
                       dtype: str | None = None):
    """(dstates_partial, dtable) for this shard given the GLOBAL per-row
    logZ: dstates sums only this shard's columns (sum it over the shards),
    dtable covers exactly this shard's rows."""
    _fp32_only(dtype)
    n_valid = _resolve_n_valid(table, n_valid)
    a = map_answers(answers, n_valid)
    with torch.no_grad():
        d = dloss.float().contiguous()
        ds, dt = ce_grads(states.contiguous(), table, a, logz.float().contiguous(), d, n_valid)
        return ds - d[:, None] * gold_rows(table, a), dt

"""Time the kernels of the port's main paths at their main-path shapes,
and compare checkouts of the port on one card.

One reading is the mean of 20 calls (CUDA events, after warm-up) of
`ce_grads` and of `ce_loss_logz` at B=256, V=1,000,000, H=64, and of
`streaming_masked_topk` at B=256, V=1,000,000, H=64, k=20, in fp32 on
seeded inputs, as `chip_smoke.py` times them (`time ce_grads kernel`,
`time ce_logz kernel`, `time streaming_masked_topk kernel`), and of
`ce_grads(..., dtype="bfloat16")` and `ce_loss_logz(...,
dtype="bfloat16")` there (rows 4b and 2b, `ce_grads_bf16` and
`ce_logz_bf16`: the bf16 form on the on-chip route), and of
`ce_loss_logz` and `ce_grads` at B=256, V=1,000,000, H=512 (the wide
route's fp32 form, rows 2w and 4w: `ce_logz_fp32_wide`,
`ce_grads_fp32_wide`), and of `ce_grads(..., dtype="bfloat16")` and
`ce_loss_logz(..., dtype="bfloat16")` there (the bf16 forms,
`ce_grads_bf16_wide` and `ce_logz_bf16_wide`), and of
`streaming_masked_topk` at B=256, V=1,000,000, H=512, k=20 (row 1w,
`streaming_masked_topk_wide`) and on its first 16 rows
(`streaming_masked_topk_wide_b16`); two readings each, in turns (wide
rank, wide rank at B=16, fp32 wide logz, fp32 wide grads, wide grads,
wide logz, grads, logz, bf16 grads, bf16 logz, rank, rank, bf16 logz,
bf16 grads, logz, grads, wide logz, wide grads, fp32 wide grads, fp32
wide logz, wide rank at B=16, wide rank). All are public
entries that every version of the port has, so an older checkout's
package is timed by the same code. Each process first holds `ce_grads`
against `ce_grads_plain` (GRAD_TOL relative to the largest |plain|
entry) and two calls bit for bit, at H=64 (and in the bf16 form there
against the plain bf16 version at the kernel's logZ, each group of
`parity.grad_errors` within `parity.BF16_GRAD_TOL`, its `ce_loss_logz`
within CE_TOL, two calls bit for bit) and, each group of
`parity.grad_errors` apart, at H=512, the wide `ce_loss_logz` in both
forms against its plain version (CE_TOL, relative to max(1, |plain|))
and two calls bit for bit, the wide bf16 `ce_grads` against
`parity.ce_grads_bf16_in_order` (WIDE_BF16_TOL, each group relative to
its largest |plain| entry) and two calls bit for bit, and the rank kernel
against its plain version at H=64 and at H=512 (values within FLOAT_TOL,
each returned id by the plain score of that id; at H=512 two calls bit
for bit). It also reports the rank wrapper's host ms per
call (perf_counter around 50 calls, no sync inside), where the
package's rank kernel counts them, the scores inserted into a row's
top-k list in a split, and `rank_eval_digest`: a sha256 of the rank
kernel's eval-mode values and ids at this checkout's `chip_smoke.py`
rank cases (read from that file: its table, seeds and inputs), so that
two checkouts with equal digests give bit-equal results there;
`rank_wide_eval_digest`, the same at its wide rank cases
(`WIDE_RANK_CASES`, the i-th seeded with 300 + i), and
`rank_wide_int_digest`, over their integer cases alone (exact scores:
equal across any two routes that rank correctly); and
`ce_fp32_digest`, the same over the fp32 `ce_loss_logz` (loss, logZ) and
`ce_grads` (ds, dT) at its CE cases (`CE_CASES`, `ce_case`);
`ce_wide_fp32_fwd_digest`, the fp32 `ce_loss_logz` (loss, logZ) alone at
its wide CE cases (`WIDE_CE_CASES`, the i-th seeded with 200 + i), and
`ce_wide_fp32_grads_digest`, the fp32 `ce_grads` (ds, dT) there, apart,
at the plain version's logZ (`ce_logz_plain`), so that a change to one
wide kernel leaves the other kernels' digests equal; `ce_bf16_digest`,
the bf16 forms' outputs at `CE_CASES`, and `ce_wide_bf16_grads_digest`,
the bf16 `ce_grads` (ds, dT) at `WIDE_CE_CASES` at the plain logZ too.
The wide ce_grads readings take the plain logZ as well.

The middle widths (B=256, V=1,000,000, H in MID_WIDTHS = {128, 256}, the
states N(0, 1), the table 0.25 N(0, 1), chip_smoke.py's main CE case's
scales): the five forms there, `ce_loss_logz` and `ce_grads` in the fp32
form (the middle route's wgmma forward, ce_fwd_mid_tf32_kernel, and
ce_bwd_wide_tf32_kernel; the older sweeps in a package from before them)
and in the bf16 form (the middle route's tensor-core pair, the older
sweeps' bf16 form in one from before it), and `streaming_masked_topk` at
k=20 (its older route),
each first held against its plain version (the forward within CE_TOL;
the fp32 gradients within GRAD_TOL and the bf16 ones within
WIDE_BF16_TOL of `parity.ce_grads_bf16_in_order`, each group of
`parity.grad_errors` apart, at the plain version's logZ of the form; two
calls bit for bit; the rank kernel as at H=64), then timed two readings
each in turns (fp32 logz, bf16 logz, fp32 grads, bf16 grads, rank, rank,
bf16 grads, fp32 grads, bf16 logz, fp32 logz), with its plain version's
ms and its library call's (`F.cross_entropy` over the fp32 product, or
`chip_smoke.py:bf16_yardsticks`' over the bf16 one, forward and
backward; `matmul` + `masked_fill_` + `topk`): the `mid` entry, with
each wrapper's middle-route launch counts (the bf16 pair's and the fp32
form's, and the rank kernel's middle route's, rank_mid_tf32_kernel, in a
package that has it, with `mid_route` naming the rank kernel's route at
B=256 there, and its older route, rank_partial_kernel, timed in turns
beside it as `rank_older`: `allow_mid=False`); `rank_mid_eval_digest`
and `rank_mid_int_digest`, the rank kernel's outputs at
`MID_RANK_CASES` (seeded with 800 + i) and at their integer cases alone
(equal across any two routes that rank correctly); `ce_mid_fp32_fwd_digest`,
the fp32 `ce_loss_logz` (loss, logZ) at `MID_CE_CASES` (equal where
ce_fwd_mid_tf32_kernel gives the same bits); and `ce_mid_bf16_digest`, the
bf16 forms' outputs at `MID_CE_CASES` (seeded with 600 + i; the
gradients at the plain fp32 logZ), which moves by design where the
middle route's kernels replace the older sweeps (so does
`ce_bf16_digest`: `CE_CASES` holds two middle-route shapes).

    python3 bsarec_tpu_torch/tools/time_kernels.py
        # this checkout's package
    python3 bsarec_tpu_torch/tools/time_kernels.py --against DIR [DIR ...]
        # the DIRs' packages, then this one; then the same in reverse
        # order: one process each, in turns
    python3 bsarec_tpu_torch/tools/time_kernels.py --large
        # the bf16 CE pair at the large-catalog shape alone (below)

With `--large`, this package's bf16 `ce_loss_logz` and `ce_grads` at
B=256, V=10,000,000, H=256 (`benchmarks/large_catalog.py`'s 10M x 256
cell; on the middle route, ce_fwd_mid_tc_kernel and ce_bwd_mid_tc_kernel),
checked as the middle widths are, then timed in turns (logz, grads,
grads, logz), with their byte bounds: one JSON line, then the card.

Each process prints one JSON line; the comparison ends with the card's
name and power limit. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
B, V, H, K = 256, 1_000_000, 64, 20
ITERS = 20
WIDE_H = 512
GRAD_TOL = 1e-4  # chip_smoke.py's
FLOAT_TOL = 1e-4  # chip_smoke.py's
CE_TOL = 1e-5  # chip_smoke.py's
WIDE_BF16_TOL = 6e-3  # parity.BF16_WIDE_GRAD_TOL (an older package's parity.py lacks it)
MID_WIDTHS = (128, 256)


def cuda_ms(fn, iters: int = ITERS, warmup: int = 2) -> float:
    """Mean ms per call of fn (CUDA events around `iters` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 50) -> float:
    """Host ms per call to issue fn, no sync inside."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return ms


def rank_inputs(device):
    """chip_smoke.py's main-path rank case: N(0, 1) states and table, 20
    seen items a row (a repeat and padding among them)."""
    import torch

    from bsarec_tpu_torch.ops import rank

    rng = np.random.default_rng(0)
    states = torch.from_numpy(rng.standard_normal((B, H), dtype=np.float32)).to(device)
    table = torch.from_numpy(rng.standard_normal((V, H), dtype=np.float32)).to(device)
    seen = rng.integers(1, V, size=(B, 20)).astype(np.int32)
    seen[:, 1] = seen[:, 0]
    seen[:, -3:] = 0
    bitmask = torch.from_numpy(rank.build_seen_bitmask(seen, V)).to(device)
    return states, table, bitmask


def _chip_smoke():
    """This checkout's `chip_smoke.py` as a module (its cases and inputs)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def rank_eval_digest(device, wide: bool = False, integer_only: bool = False,
                     mid: bool = False) -> str:
    """sha256 over the rank kernel's eval-mode (values, ids) at this
    checkout's `chip_smoke.py` rank cases (`RANK_CASES`), on its inputs
    (`make_case`, the i-th case seeded with i); with `wide`, at
    `WIDE_RANK_CASES` (seeded with 300 + i, the float tables scaled by
    sqrt(64 / H) as the wide phase draws them); with `mid`, at
    `MID_RANK_CASES` (seeded with 800 + i, scaled likewise); with
    `integer_only`, at the integer cases alone."""
    import torch

    from bsarec_tpu_torch.ops import rank

    smoke = _chip_smoke()
    digest = hashlib.sha256()
    cases, seed0 = ((smoke.WIDE_RANK_CASES, 300) if wide else (smoke.MID_RANK_CASES, 800) if mid
                    else (smoke.RANK_CASES, 0))
    for i, (_, b, v, h, k, n_valid, n_seen, integer, all_seen) in enumerate(cases):
        if integer_only and not integer:
            continue
        states, table, bitmask = smoke.make_case(b, v, h, n_seen, seed=seed0 + i, device=device,
                                                 integer=integer, all_seen_row=all_seen,
                                                 scale=math.sqrt(64 / h) if wide or mid else 1.0)
        vals, ids = rank.streaming_masked_topk(states, table, bitmask, k, n_valid)
        digest.update(vals.cpu().numpy().tobytes())
        digest.update(ids.cpu().numpy().tobytes())
        del states, table, bitmask
        torch.cuda.empty_cache()
    return digest.hexdigest()


def ce_digest(device, wide: bool = False, dtype=None, grads_only: bool = False,
              forward_only: bool = False, mid: bool = False) -> str:
    """sha256 over the CE entries' outputs, in the form `dtype` names, at
    this checkout's `chip_smoke.py` CE cases (`CE_CASES`, the i-th on
    `ce_case`'s inputs seeded with 100 + i; with `wide`, `WIDE_CE_CASES`
    seeded with 200 + i; with `mid`, `MID_CE_CASES` seeded with 600 + i):
    loss and logZ from `ce_loss_logz`, ds and dT from
    `ce_grads` at that logZ and dloss = 1/B; with `grads_only`, ds and dT
    alone, at the fp32 plain version's logZ (no kernel's); with
    `forward_only`, loss and logZ alone."""
    import torch

    from bsarec_tpu_torch.ops import ce

    smoke = _chip_smoke()
    digest = hashlib.sha256()
    cases, seed0 = ((smoke.WIDE_CE_CASES, 200) if wide else (smoke.MID_CE_CASES, 600) if mid
                    else (smoke.CE_CASES, 100))
    for i, (_, b, v, h, n_valid, kind) in enumerate(cases):
        states, table, answers = smoke.ce_case(b, v, h, n_valid, seed=seed0 + i, device=device,
                                               answer_kind=kind)
        if grads_only:
            loss, logz = None, ce.ce_logz_plain(states, table, n_valid)
        else:
            loss, logz = ce.ce_loss_logz(states, table, answers, n_valid, dtype=dtype)
        if forward_only:
            outputs = (loss, logz)
        else:
            d = torch.full((b,), 1.0 / b, device=device)
            outputs = ce.ce_grads(states, table, answers, logz, d, n_valid, dtype=dtype)
            if not grads_only:
                outputs = (loss, logz, *outputs)
        for x in outputs:
            digest.update(x.cpu().numpy().tobytes())
        del states, table, answers, outputs
        torch.cuda.empty_cache()
    return digest.hexdigest()


def check_rank(states, table, bitmask) -> float:
    """The kernel against the plain version, and at H=512 two calls bit for
    bit; returns the value error."""
    import torch

    from bsarec_tpu_torch.ops import rank

    vals, ids = rank.streaming_masked_topk(states, table, bitmask, K, V)
    if states.shape[1] == WIDE_H:
        again_v, again_i = rank.streaming_masked_topk(states, table, bitmask, K, V)
        if not (torch.equal(vals, again_v) and torch.equal(ids, again_i)):
            raise SystemExit(f"time_kernels: rank kernel at H={WIDE_H} not deterministic")
    want_v, _ = rank.streaming_masked_topk_plain(states, table, bitmask, K, V)
    err = float((vals - want_v).abs().max())
    ids = ids.long()
    by_id = torch.einsum("bh,bkh->bk", states, table[ids])
    seen = ((torch.gather(bitmask, 1, ids >> 5) >> (ids & 31).int()) & 1).bool()
    by_id = torch.where(seen, torch.zeros_like(by_id), by_id)
    id_err = float((by_id - want_v).abs().max())
    if not (err <= FLOAT_TOL and id_err <= FLOAT_TOL):
        raise SystemExit(f"time_kernels: rank kernel at H={states.shape[1]} off its plain version "
                         f"({err}, ids {id_err})")
    return err


def time_mid(h, r_mask, rng, device) -> dict:
    """The five middle-width forms at B=256, V=1M and hidden size `h`
    (module docstring): each checked, then timed in turns; {form: {"ms":
    [ms, ms], "plain_ms": ms, "library_ms": ms}}."""
    import torch
    import torch.nn.functional as F

    from bsarec_tpu_torch import parity
    from bsarec_tpu_torch.ops import ce, rank

    states = torch.from_numpy(rng.standard_normal((B, h), dtype=np.float32)).to(device)
    table = torch.from_numpy(0.25 * rng.standard_normal((V, h), dtype=np.float32)).to(device)
    answers = torch.from_numpy(rng.integers(1, V, size=B)).to(device)
    d = torch.full((B,), 1.0 / B, device=device)
    forms, errs = {}, {}
    for tag, dtype in (("fp32", None), ("bf16", "bfloat16")):
        bf16 = dtype is not None
        want_loss, want_logz = ce.ce_loss_logz_plain(states, table, answers, V, bf16=bf16)
        fwd = lambda dtype=dtype: ce.ce_loss_logz(states, table, answers, V, dtype=dtype)
        (loss, logz), (loss2, logz2) = fwd(), fwd()
        err = max(float(((x - y).abs() / y.abs().clamp(min=1.0)).max())
                  for x, y in ((loss, want_loss), (logz, want_logz)))
        if err > CE_TOL or not (torch.equal(loss, loss2) and torch.equal(logz, logz2)):
            raise SystemExit(f"time_kernels: {tag} ce_loss_logz at H={h} off its plain version "
                             f"({err}) or not deterministic")
        grads = lambda dtype=dtype, z=want_logz: ce.ce_grads(states, table, answers, z, d, V,
                                                             dtype=dtype)
        (ds, dt), (ds2, dt2) = grads(), grads()
        want = (parity.ce_grads_bf16_in_order(states, table, answers, want_logz, d, V) if bf16
                else ce.ce_grads_plain(states, table, answers, want_logz, d, V))
        g_err = max(parity.grad_errors(ds, dt, *want, answers, V).values())
        if g_err > (WIDE_BF16_TOL if bf16 else GRAD_TOL) or not (torch.equal(ds, ds2)
                                                                   and torch.equal(dt, dt2)):
            raise SystemExit(f"time_kernels: {tag} ce_grads at H={h} off its plain version "
                             f"({g_err}) or not deterministic")
        errs |= {f"ce_logz_{tag}": err, f"ce_grads_{tag}": g_err}
        del loss, loss2, logz, logz2, ds, dt, ds2, dt2, want
        plain_z = want_logz
        forms[f"ce_logz_{tag}"] = (fwd, lambda bf16=bf16: ce.ce_loss_logz_plain(
            states, table, answers, V, bf16=bf16))
        forms[f"ce_grads_{tag}"] = (grads, lambda bf16=bf16, z=plain_z: ce.ce_grads_plain(
            states, table, answers, z, d, V, bf16=bf16))
    errs["rank"] = check_rank(states, table, r_mask)
    forms["rank"] = (lambda: rank.streaming_masked_topk(states, table, r_mask, K, V),
                     lambda: rank.streaming_masked_topk_plain(states, table, r_mask, K, V))
    if "allow_mid" in inspect.signature(rank._launch).parameters:  # a package with the middle route
        errs["rank_older"] = errs["rank"]
        forms["rank_older"] = (lambda: rank._launch(states, table, r_mask, K, V, allow_mid=False),
                               forms["rank"][1])
    torch.cuda.empty_cache()
    names = list(forms)
    ms = {name: [] for name in names}
    for name in names + names[::-1]:
        ms[name].append(cuda_ms(forms[name][0], iters=10))
    out = {name: {"ms": ms[name], "plain_ms": cuda_ms(forms[name][1], iters=2, warmup=1),
                  "max_rel_err": errs[name]} for name in names}
    # the library calls, on the same inputs (yardsticks only)
    (fwd16, fwd16_name), (back16, back16_name) = _chip_smoke().bf16_yardsticks(states, table, answers)
    s_req, t_req = states.clone().requires_grad_(), table.clone().requires_grad_()
    graph = F.cross_entropy(s_req @ t_req.T, answers)
    cols = torch.arange(V, device=device)
    seen = ((r_mask[:, cols >> 5] >> (cols & 31).int()) & 1).bool()
    library = {"ce_logz_fp32": (lambda: F.cross_entropy(states @ table.T, answers),
                                "F.cross_entropy(states @ table.T) forward"),
               "ce_grads_fp32": (lambda: torch.autograd.grad(graph, (s_req, t_req), retain_graph=True),
                                 "backward of F.cross_entropy(states @ table.T)"),
               "ce_logz_bf16": (fwd16, fwd16_name), "ce_grads_bf16": (back16, back16_name),
               "rank": (lambda: torch.topk(torch.matmul(states, table.T).masked_fill_(seen, 0.0), K),
                        "matmul + masked_fill_ + topk")}
    if "rank_older" in forms:
        library["rank_older"] = library["rank"]
    for name, (fn, lib_name) in library.items():
        out[name] |= {"library_ms": cuda_ms(fn, iters=5), "library": lib_name}
    del graph, s_req, t_req, seen, cols
    torch.cuda.empty_cache()
    out["rank"]["mid_route"] = rank.mid_route(B, h, K) if hasattr(rank, "mid_route") else False
    return out


def time_large() -> dict:
    """The --large mode (module docstring)."""
    sys.path.insert(0, str(ROOT))
    import torch

    from bsarec_tpu_torch import parity
    from bsarec_tpu_torch.ops import ce

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device, b, v, h = torch.device("cuda"), B, 10_000_000, 256
    rng = np.random.default_rng(10)
    states = torch.from_numpy(rng.standard_normal((b, h), dtype=np.float32)).to(device)
    table = torch.from_numpy(0.25 * rng.standard_normal((v, h), dtype=np.float32)).to(device)
    answers = torch.from_numpy(rng.integers(1, v, size=b)).to(device)
    d = torch.full((b,), 1.0 / b, device=device)
    fwd = lambda: ce.ce_loss_logz(states, table, answers, v, dtype="bfloat16")
    (loss, logz), (loss2, logz2) = fwd(), fwd()
    want_loss, want_logz = ce.ce_loss_logz_plain(states, table, answers, v, bf16=True)
    fwd_err = max(float(((x - y).abs() / y.abs().clamp(min=1.0)).max())
                  for x, y in ((loss, want_loss), (logz, want_logz)))
    if fwd_err > CE_TOL or not (torch.equal(loss, loss2) and torch.equal(logz, logz2)):
        raise SystemExit(f"time_kernels: bf16 ce_loss_logz at V={v} off its plain version "
                         f"({fwd_err}) or not deterministic")
    grads = lambda: ce.ce_grads(states, table, answers, logz, d, v, dtype="bfloat16")
    (ds, dt), (ds2, dt2) = grads(), grads()
    want = parity.ce_grads_bf16_in_order(states, table, answers, logz, d, v)
    grad_err = parity.grad_errors(ds, dt, *want, answers, v)
    if max(grad_err.values()) > WIDE_BF16_TOL or not (torch.equal(ds, ds2) and torch.equal(dt, dt2)):
        raise SystemExit(f"time_kernels: bf16 ce_grads at V={v} off the in-order plain version "
                         f"({grad_err}) or not deterministic")
    del ds, dt, ds2, dt2, want, loss2, logz2
    torch.cuda.empty_cache()
    f1, g1, g2, f2 = (cuda_ms(fn, iters=10) for fn in (fwd, grads, grads, fwd))
    table_bytes = 4 * v * h
    return {"B": b, "V": v, "H": h, "mid_route": ce.mid_route(b, h),
            "ce_logz_bf16": [f1, f2], "ce_grads_bf16": [g1, g2],
            "ce_logz_bf16_bound_ms": table_bytes / 3.35e12 * 1e3,
            "ce_grads_bf16_bound_ms": 2 * table_bytes / 3.35e12 * 1e3,
            "ce_logz_bf16_rel_err": fwd_err, "ce_grads_bf16_rel_err": grad_err}


def time_package(package_root: Path) -> dict:
    """{"ce_grads": [ms, ms], "ce_logz": [ms, ms], "streaming_masked_topk":
    [ms, ms], ...} for the package under `package_root`."""
    sys.path.insert(0, str(package_root))
    import torch

    from bsarec_tpu_torch import parity
    from bsarec_tpu_torch.ops import ce, rank
    from bsarec_tpu_torch.parity import rel_err

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    rng = np.random.default_rng(100)
    states = torch.from_numpy(rng.standard_normal((B, H), dtype=np.float32)).to(device)
    table = torch.from_numpy(0.25 * rng.standard_normal((V, H), dtype=np.float32)).to(device)
    answers = torch.from_numpy(rng.integers(1, V, size=B)).to(device)
    d = torch.full((B,), 1.0 / B, device=device)
    _, logz = ce.ce_loss_logz(states, table, answers, V)
    ds, dt = ce.ce_grads(states, table, answers, logz, d, V)
    ds2, dt2 = ce.ce_grads(states, table, answers, logz, d, V)
    want_ds, want_dt = ce.ce_grads_plain(states, table, answers, logz, d, V)
    err = max(rel_err(ds, want_ds), rel_err(dt, want_dt))
    if err > GRAD_TOL or not (torch.equal(ds, ds2) and torch.equal(dt, dt2)):
        raise SystemExit(f"time_kernels: ce_grads off its plain version ({err}) or not deterministic")
    del ds, dt, ds2, dt2, want_ds, want_dt
    # the bf16 forms at H=64 (rows 2b and 4b) against their plain versions
    fwd16 = lambda: ce.ce_loss_logz(states, table, answers, V, dtype="bfloat16")
    (b_loss, b_logz), (b_loss2, b_logz2) = fwd16(), fwd16()
    want_loss, want_logz = ce.ce_loss_logz_plain(states, table, answers, V, bf16=True)
    fwd16_err = max(float(((x - y).abs() / y.abs().clamp(min=1.0)).max())
                    for x, y in ((b_loss, want_loss), (b_logz, want_logz)))
    if fwd16_err > CE_TOL or not (torch.equal(b_loss, b_loss2) and torch.equal(b_logz, b_logz2)):
        raise SystemExit(f"time_kernels: bf16 ce_loss_logz at H={H} off its plain version "
                         f"({fwd16_err}) or not deterministic")
    grads16 = lambda: ce.ce_grads(states, table, answers, b_logz, d, V, dtype="bfloat16")
    (ds, dt), (ds2, dt2) = grads16(), grads16()
    want = ce.ce_grads_plain(states, table, answers, b_logz, d, V, bf16=True)
    grads16_err = max(parity.grad_errors(ds, dt, *want, answers, V).values())
    if grads16_err > parity.BF16_GRAD_TOL or not (torch.equal(ds, ds2) and torch.equal(dt, dt2)):
        raise SystemExit(f"time_kernels: bf16 ce_grads at H={H} off its plain version "
                         f"({grads16_err}) or not deterministic")
    del b_loss, b_loss2, b_logz2, want_loss, want_logz, ds, dt, ds2, dt2, want
    r_states, r_table, r_mask = rank_inputs(device)
    rank_err = check_rank(r_states, r_table, r_mask)
    # the wide route's bf16 forms, chip_smoke.py's main wide case's scales
    w_states = torch.from_numpy(rng.standard_normal((B, WIDE_H), dtype=np.float32)).to(device)
    w_table = torch.from_numpy(0.25 * rng.standard_normal((V, WIDE_H), dtype=np.float32)).to(device)
    # the rank kernel at H=512 (row 1w) on these states and table and the
    # H=64 case's seen items; and on the first 16 rows
    wide_rank_err = check_rank(w_states, w_table, r_mask)
    q_states, q_mask = w_states[:16].contiguous(), r_mask[:16].contiguous()
    # the fp32 form's wide ce_loss_logz (row 2w) against its plain version
    wide_fwd32 = lambda: ce.ce_loss_logz(w_states, w_table, answers, V)
    (y_loss, y_logz), (y_loss2, y_logz2) = wide_fwd32(), wide_fwd32()
    want_loss, x_logz = ce.ce_loss_logz_plain(w_states, w_table, answers, V)
    fwd32_err = max(float(((x - y).abs() / y.abs().clamp(min=1.0)).max())
                    for x, y in ((y_loss, want_loss), (y_logz, x_logz)))
    if fwd32_err > CE_TOL or not (torch.equal(y_loss, y_loss2) and torch.equal(y_logz, y_logz2)):
        raise SystemExit(f"time_kernels: fp32 ce_loss_logz at H={WIDE_H} off its plain version "
                         f"({fwd32_err}) or not deterministic")
    del y_loss, y_logz, y_loss2, y_logz2, want_loss
    # the fp32 form's wide ce_grads (row 4w) at the plain logZ
    wide32 = lambda: ce.ce_grads(w_states, w_table, answers, x_logz, d, V)
    (ds, dt), (ds2, dt2) = wide32(), wide32()
    want = ce.ce_grads_plain(w_states, w_table, answers, x_logz, d, V)
    wide32_err = max(parity.grad_errors(ds, dt, *want, answers, V).values())
    if wide32_err > GRAD_TOL or not (torch.equal(ds, ds2) and torch.equal(dt, dt2)):
        raise SystemExit(f"time_kernels: fp32 ce_grads at H={WIDE_H} off its plain version "
                         f"({wide32_err}) or not deterministic")
    del ds, dt, ds2, dt2, want
    wide_fwd = lambda: ce.ce_loss_logz(w_states, w_table, answers, V, dtype="bfloat16")
    (w_loss, w_logz), (w_loss2, w_logz2) = wide_fwd(), wide_fwd()
    want_loss, want_logz = ce.ce_loss_logz_plain(w_states, w_table, answers, V, bf16=True)
    fwd_err = max(float(((x - y).abs() / y.abs().clamp(min=1.0)).max())
                  for x, y in ((w_loss, want_loss), (w_logz, want_logz)))
    if fwd_err > CE_TOL or not (torch.equal(w_loss, w_loss2) and torch.equal(w_logz, w_logz2)):
        raise SystemExit(f"time_kernels: bf16 ce_loss_logz at H={WIDE_H} off its plain version "
                         f"({fwd_err}) or not deterministic")
    del w_loss2, w_logz2, want_loss, want_logz
    wide = lambda: ce.ce_grads(w_states, w_table, answers, w_logz, d, V, dtype="bfloat16")
    (ds, dt), (ds2, dt2) = wide(), wide()
    want = parity.ce_grads_bf16_in_order(w_states, w_table, answers, w_logz, d, V)
    wide_err = max(parity.grad_errors(ds, dt, *want, answers, V).values())
    if wide_err > WIDE_BF16_TOL or not (torch.equal(ds, ds2) and torch.equal(dt, dt2)):
        raise SystemExit(f"time_kernels: bf16 ce_grads at H={WIDE_H} off the in-order plain "
                         f"version ({wide_err}) or not deterministic")
    del ds, dt, ds2, dt2, want
    torch.cuda.empty_cache()
    out = {"ce_grads_rel_err": err, "ce_grads_bf16_rel_err": grads16_err,
           "ce_logz_bf16_rel_err": fwd16_err, "ce_grads_fp32_wide_rel_err": wide32_err,
           "ce_logz_fp32_wide_rel_err": fwd32_err,
           "ce_grads_bf16_wide_rel_err": wide_err,
           "ce_logz_bf16_wide_rel_err": fwd_err,
           "rank_abs_err": rank_err, "rank_wide_abs_err": wide_rank_err,
           "rank_eval_digest": rank_eval_digest(device),
           "rank_wide_eval_digest": rank_eval_digest(device, wide=True),
           "rank_wide_int_digest": rank_eval_digest(device, wide=True, integer_only=True),
           "ce_fp32_digest": ce_digest(device),
           "ce_wide_fp32_fwd_digest": ce_digest(device, wide=True, forward_only=True),
           "ce_wide_fp32_grads_digest": ce_digest(device, wide=True, grads_only=True),
           "ce_bf16_digest": ce_digest(device, dtype="bfloat16"),
           "ce_mid_bf16_digest": ce_digest(device, mid=True, dtype="bfloat16", grads_only=True),
           "ce_mid_fp32_fwd_digest": ce_digest(device, mid=True, forward_only=True),
           "rank_mid_eval_digest": rank_eval_digest(device, mid=True),
           "rank_mid_int_digest": rank_eval_digest(device, mid=True, integer_only=True),
           "ce_wide_bf16_grads_digest": ce_digest(device, wide=True, dtype="bfloat16",
                                                  grads_only=True)}
    if "taken" in inspect.signature(rank._launch).parameters:
        n = torch.zeros(1, dtype=torch.int64, device=device)
        rank._launch(r_states, r_table, r_mask, K, V, taken=n)
        out["rank_taken_per_row_per_split"] = int(n) / B / rank._splits(
            B, V, rank.onchip_route(B, H, K), torch.cuda.get_device_properties(0).multi_processor_count)[0]
    grads = lambda: ce.ce_grads(states, table, answers, logz, d, V)
    logz_fn = lambda: ce.ce_loss_logz(states, table, answers, V)
    rank_fn = lambda: rank.streaming_masked_topk(r_states, r_table, r_mask, K, V)
    wide_rank = lambda: rank.streaming_masked_topk(w_states, w_table, r_mask, K, V)
    wide_rank16 = lambda: rank.streaming_masked_topk(q_states, w_table, q_mask, K, V)
    k1, q1 = cuda_ms(wide_rank), cuda_ms(wide_rank16)
    y1, x1, w1, f1 = cuda_ms(wide_fwd32), cuda_ms(wide32), cuda_ms(wide), cuda_ms(wide_fwd)
    g1, l1 = cuda_ms(grads), cuda_ms(logz_fn)
    bg1, bl1 = cuda_ms(grads16), cuda_ms(fwd16)
    r1, r2 = cuda_ms(rank_fn), cuda_ms(rank_fn)
    bl2, bg2 = cuda_ms(fwd16), cuda_ms(grads16)
    l2, g2 = cuda_ms(logz_fn), cuda_ms(grads)
    f2, w2, x2, y2 = cuda_ms(wide_fwd), cuda_ms(wide), cuda_ms(wide32), cuda_ms(wide_fwd32)
    q2, k2 = cuda_ms(wide_rank16), cuda_ms(wide_rank)
    out |= {"ce_grads": [g1, g2], "ce_logz": [l1, l2], "streaming_masked_topk": [r1, r2],
            "ce_grads_bf16": [bg1, bg2], "ce_logz_bf16": [bl1, bl2],
            "streaming_masked_topk_wide": [k1, k2], "streaming_masked_topk_wide_b16": [q1, q2],
            "ce_logz_fp32_wide": [y1, y2], "ce_grads_fp32_wide": [x1, x2],
            "ce_grads_bf16_wide": [w1, w2], "ce_logz_bf16_wide": [f1, f2],
            "rank_host_ms": host_ms(rank_fn)}
    for name, f in (("ce_logz", ce.ce_logz), ("ce_grads", ce.ce_grads),
                    ("streaming_masked_topk", rank.streaming_masked_topk)):
        out[f"{name}_onchip_launches"] = getattr(f, "onchip_launches", None)
    for name, f in (("ce_logz", ce.ce_logz), ("ce_grads", ce.ce_grads)):
        out[f"{name}_wide_launches"] = getattr(f, "wide_launches", None)
    # the middle widths last: their forms at B=256, V=1M, H in MID_WIDTHS
    counters = [(f"{name}_{c}", f, c) for name, f in (("ce_logz", ce.ce_logz), ("ce_grads", ce.ce_grads))
                for c in ("mid_launches", "mid_tf32_launches")]
    mid_before = {key: getattr(f, c, None) for key, f, c in counters}
    out["mid"] = {h: time_mid(h, r_mask, np.random.default_rng(100 + h), device) for h in MID_WIDTHS}
    for key, f, c in counters:
        after = getattr(f, c, None)
        out[key] = None if after is None else after - mid_before[key]
    out["streaming_masked_topk_tc_launches"] = getattr(rank.streaming_masked_topk, "tc_launches", None)
    out["streaming_masked_topk_mid_launches"] = getattr(rank.streaming_masked_topk, "mid_launches",
                                                        None)
    return out


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", type=Path, default=ROOT,
                    help="the checkout whose bsarec_tpu_torch is timed (default: this one)")
    ap.add_argument("--against", type=Path, nargs="+", default=None,
                    help="other checkouts: time them and this one in turns, one process each")
    ap.add_argument("--large", action="store_true",
                    help="the bf16 CE pair at B=256, V=10,000,000, H=256 alone")
    args = ap.parse_args()
    if args.large:
        print(json.dumps(time_large()), flush=True)
        print(card_line(), flush=True)
        return
    if args.against is None:
        print(json.dumps({"package": str(args.package_root), "B": B, "V": V, "H": H, "k": K,
                          "wide_H": WIDE_H, "ms": time_package(args.package_root.resolve())}),
              flush=True)
        return
    order = [*args.against, args.package_root]
    for root in order + order[::-1]:
        subprocess.run([sys.executable, __file__, "--package-root", str(root.resolve())],
                       check=True, timeout=600)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()

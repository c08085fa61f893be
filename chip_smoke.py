"""Smoke test of the PyTorch/CUDA port (`bsarec_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) when it fails:

1. Print the card's name and power limit; build every CUDA kernel of the
   port from `bsarec_tpu_torch/csrc/` with nvcc.
2. Hold the streaming masked top-k kernel against its plain PyTorch
   version at the eval path's shape (B=256 users, V=1,000,000 items,
   H=64, k=20) and at edge shapes: odd B, V off every tile, n_valid < V,
   k in {1, 20, 128}, an all-seen row, fewer valid items than k, H off
   the kernel's hidden chunk, and integer-valued inputs whose dot
   products are exact, where values and ids (tie order included) must be
   bit-equal. On float inputs values agree within FLOAT_TOL and each
   returned id is checked by the plain version's score of that id.
3. Drive the port's main path through its normal entry point:
   `bsarec_tpu_torch.main --do_eval --eval_impl streaming --export_topk`
   on a seeded synthetic 1,000,000-item x 50,000-user corpus with a
   seeded random-init BSARec at the paper's Beauty widths (hidden 64,
   2 layers, 1 head, c=5, alpha=0.7, max_len 50). The kernel's launch
   count must cover every eval batch of the test pass and the export,
   and the first 512 users' exported top-20 must agree with the plain
   version.
4. Time the kernel, its plain version and one library yardstick with
   CUDA events, print the bound, eval users/s, a steady-state eval pass
   with its per-batch breakdown, and a `kernels` JSON line.

The last line is `{"ok": true, "device": {...}}`. Without a CUDA device
the script exits 1 and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

# fp32 sums of 64 products taken in another order than torch.matmul's;
# scores at these shapes stay below ~50 in magnitude
FLOAT_TOL = 1e-4
# H100 SXM peaks from NVIDIA's data sheet: fp32 outside
# the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# EVAL_BATCH is TrainConfig.eval_batch_size's default, which main uses
N_USERS, N_ITEMS, EVAL_BATCH, TOP_K = 50_000, 1_000_000, 256, 20


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def synth_corpus(n_users: int, n_items: int, seed: int = 0) -> list[list[int]]:
    """`benchmarks/million_item_e2e.py:synth_corpus`: each user walks a
    random arithmetic progression through the catalog, lengths 8-16.
    The last user's final item is set to n_items - 1, so that the file's
    largest id, from which `load_corpus` derives item_size, is the
    catalog's last item."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, 17, size=n_users)
    starts = rng.integers(1, n_items, size=n_users)
    strides = rng.integers(1, 7, size=n_users)
    offsets = np.zeros(n_users + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    pos = np.arange(int(offsets[-1]), dtype=np.int64)
    user_of = np.repeat(np.arange(n_users), lens)
    within = pos - offsets[user_of]
    items = (starts[user_of] + strides[user_of] * within - 1) % (n_items - 1) + 1
    items[-1] = n_items - 1
    return [items[offsets[u]:offsets[u + 1]].tolist() for u in range(n_users)]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of `fn` on the card (CUDA events)."""
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


def masked_scores(states, table, bitmask, n_valid, ids):
    """The plain version's masked score of each given id: s . T[id],
    0.0 where the id is seen, -inf at or past n_valid."""
    import torch

    ids = ids.long()
    raw = torch.einsum("bh,bkh->bk", states, table[ids])
    seen = (torch.gather(bitmask, 1, ids >> 5) >> (ids & 31).int()) & 1
    raw = torch.where(seen.bool(), torch.zeros_like(raw), raw)
    return torch.where(ids < n_valid, raw, torch.full_like(raw, -math.inf))


def make_case(b, v, h, n_seen, seed, device, integer=False, all_seen_row=False):
    """Seeded inputs: states [b, h], table [v, h], a seen bitmask built on
    the device from 0-padded id lists with repeats (and checked against
    the host builder)."""
    import torch

    from bsarec_tpu_torch.ops import rank

    rng = np.random.default_rng(seed)
    if integer:
        states = rng.integers(-3, 4, size=(b, h)).astype(np.float32)
        table = rng.integers(-3, 4, size=(v, h)).astype(np.float32)
    else:
        states = rng.standard_normal((b, h), dtype=np.float32)
        table = rng.standard_normal((v, h), dtype=np.float32)
    seen = rng.integers(1, v, size=(b, n_seen + 4)).astype(np.int32)
    seen[:, 1] = seen[:, 0]  # a repeated item
    seen[:, -3:] = 0  # padding
    host = rank.build_seen_bitmask(seen, v)
    dev = rank.seen_ids_to_bitmask(torch.from_numpy(rank.dedupe_seen_rows(seen)).to(device), v)
    check(np.array_equal(dev.cpu().numpy(), host), "seen_ids_to_bitmask differs from build_seen_bitmask")
    if all_seen_row:
        dev[b // 2] = -1
    return torch.from_numpy(states).to(device), torch.from_numpy(table).to(device), dev


def compare_kernel(case_name, states, table, bitmask, k, n_valid, exact):
    """Kernel vs plain on one input; returns the largest value error."""
    import torch

    from bsarec_tpu_torch.ops import rank

    vals, ids = rank.streaming_masked_topk(states, table, bitmask, k, n_valid)
    torch.cuda.synchronize()
    want_v, want_i = rank.streaming_masked_topk_plain(states, table, bitmask, k, n_valid)
    check(vals.shape == want_v.shape and ids.dtype == torch.int32, f"{case_name}: shape/dtype")
    finite = torch.isfinite(want_v)
    check(torch.equal(torch.isfinite(vals), finite), f"{case_name}: filled slots differ")
    check(bool((ids[~finite] == 0).all()), f"{case_name}: unfilled slots must hold id 0")
    err = float((vals[finite] - want_v[finite]).abs().max()) if finite.any() else 0.0
    if exact:
        check(torch.equal(vals, want_v) and torch.equal(ids, want_i),
              f"{case_name}: integer inputs must give bit-equal values and ids")
    else:
        check(err <= FLOAT_TOL, f"{case_name}: value error {err} > {FLOAT_TOL}")
        by_score = masked_scores(states, table, bitmask, n_valid, ids)
        id_err = float((by_score[finite] - want_v[finite]).abs().max()) if finite.any() else 0.0
        check(id_err <= FLOAT_TOL, f"{case_name}: returned ids score {id_err} off the plain values")
        for r in range(ids.shape[0]):
            row = ids[r][finite[r]]
            check(row.unique().numel() == row.numel(), f"{case_name}: row {r} repeats an id")
    log(f"kernel vs plain {case_name}: ok, max |value error| {err:.3g}"
        f"{' (bit-equal ids and values)' if exact else ''}")
    return err


def phase_kernels(device):
    """Phase 2. Returns (max value error, the full-shape inputs)."""
    # (tag, B, V, H, k, n_valid, seen per row, integer, all-seen row)
    cases = [
        ("main path", 256, N_ITEMS, 64, TOP_K, N_ITEMS, 16, False, False),
        ("odd B, n_valid < V", 37, 5000, 64, 20, 4990, 16, False, False),
        ("V off the tile, k=1", 3, 12101, 64, 1, 12101, 16, False, False),
        ("k=128", 64, 33333, 64, 128, 33333, 16, False, False),
        ("all-seen row", 9, 4099, 64, 20, 4099, 16, False, True),
        ("n_valid < k", 5, 300, 64, 20, 10, 4, False, False),
        ("H off the hidden chunk", 130, 70001, 48, 20, 70001, 16, False, False),
        ("integer", 37, 20011, 64, 1, 20006, 16, True, False),
        ("integer", 37, 20011, 64, 20, 20006, 16, True, False),
        ("integer, all-seen row", 70, 20011, 64, 128, 20011, 16, True, True),
    ]
    worst, full = 0.0, None
    for i, (tag, b, v, h, k, n_valid, n_seen, integer, all_seen) in enumerate(cases):
        name = f"{tag} (B={b} V={v} H={h} k={k} n_valid={n_valid})"
        states, table, bitmask = make_case(b, v, h, n_seen, seed=i, device=device,
                                           integer=integer, all_seen_row=all_seen)
        worst = max(worst, compare_kernel(name, states, table, bitmask, k, n_valid, integer))
        if i == 0:
            full = (states, table, bitmask)
    return worst, full


def phase_main_path(device, workdir):
    """Phase 3: `main --do_eval --eval_impl streaming --export_topk` at
    full width. Returns (kernel launches, test-pass seconds, the corpus's
    sequences, the model on the device)."""
    import torch

    from bsarec_tpu_torch import main as port_main
    from bsarec_tpu_torch.config import ModelConfig
    from bsarec_tpu_torch.data.corpus import Corpus
    from bsarec_tpu_torch.data.pipeline import SeqRecData
    from bsarec_tpu_torch.models import build_model
    from bsarec_tpu_torch.ops import rank
    from bsarec_tpu_torch.train.checkpoint import load_params, save_params

    t0 = time.perf_counter()
    seqs = synth_corpus(N_USERS, N_ITEMS, seed=0)
    with open(os.path.join(workdir, "synth1m.txt"), "w") as fh:
        for u, seq in enumerate(seqs):
            fh.write(f"{u + 1} {' '.join(map(str, seq))}\n")
    cfg = ModelConfig(model_type="bsarec", item_size=N_ITEMS, num_users=N_USERS + 1,
                      max_seq_length=50, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=1, c=5, alpha=0.7)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    save_params(model.state_dict(), os.path.join(workdir, "smoke_init.ckpt"))
    log(f"main path set-up: corpus file and checkpoint in {time.perf_counter() - t0:.1f}s")

    topk_path = os.path.join(workdir, "topk.npy")
    argv = [
        "--data_dir", workdir, "--data_name", "synth1m", "--output_dir", workdir,
        "--train_name", "smoke_eval", "--do_eval", "--load_model", "smoke_init",
        "--eval_impl", "streaming", "--export_topk", topk_path, "--device", device.type,
        "--model_type", "BSARec", "--hidden_size", "64", "--num_hidden_layers", "2",
        "--num_attention_heads", "1", "--c", "5", "--alpha", "0.7",
        "--max_seq_length", "50",
    ]
    rank.streaming_masked_topk.launches = 0
    t0 = time.perf_counter()
    scores = port_main.main(argv)
    torch.cuda.synchronize(device)
    launches = rank.streaming_masked_topk.launches
    log(f"main path: main(--do_eval --eval_impl streaming --export_topk) returned in "
        f"{time.perf_counter() - t0:.1f}s, test scores {scores}")

    steps = math.ceil(N_USERS / EVAL_BATCH)
    check(launches == 2 * steps,
          f"rank kernel launched {launches} times, want {2 * steps} (test pass + export)")
    check(all(math.isfinite(s) and 0.0 <= s <= 1.0 for s in scores), f"bad scores {scores}")
    with open(os.path.join(workdir, "smoke_eval.log")) as fh:
        found = re.findall(r"eval test: (\d+) users in ([0-9.]+)s", fh.read())
    check(len(found) == 1 and int(found[0][0]) == N_USERS, f"eval log line: {found}")
    eval_seconds = float(found[0][1])

    topk = np.load(topk_path)
    check(topk.shape == (N_USERS, TOP_K), f"export shape {topk.shape}")
    check(int(topk.min()) >= 0 and int(topk.max()) < N_ITEMS, "exported ids out of range")

    # recompute the first 512 users' top-20 with the plain version
    head = SeqRecData(Corpus(user_seq=seqs[:512], max_item=N_ITEMS - 1), max_len=50).test
    model.load_state_dict(load_params(os.path.join(workdir, "smoke_init.ckpt")))
    model.to(device).eval()
    with torch.inference_mode():
        states = model.predict(torch.from_numpy(head.input_ids).long().to(device))[:, -1, :]
        table = model.item_table
        bitmask = torch.from_numpy(rank.build_seen_bitmask(head.seen_items, N_ITEMS)).to(device)
        want_v, _ = rank.streaming_masked_topk_plain(states, table, bitmask, TOP_K, N_ITEMS)
        got = masked_scores(states, table, bitmask, N_ITEMS,
                            torch.from_numpy(topk[:512]).to(device))
    err = float((got - want_v).abs().max())
    check(err <= FLOAT_TOL, f"exported top-20 of the first 512 users: score error {err}")
    log(f"main path: {launches} kernel launches over {steps} eval batches x 2 passes; "
        f"first 512 users' exported top-20 agree with the plain version (score error {err:.3g})")
    return launches, eval_seconds, seqs, model


def phase_breakdown(device, seqs, model, card):
    """Where one eval pass's time goes: a steady-state pass of the eval
    function main uses, one such pass under torch.profiler (device busy
    time by kernel), and each per-batch piece on its own (CUDA events)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bsarec_tpu_torch.data.corpus import Corpus
    from bsarec_tpu_torch.data.pipeline import SeqRecData
    from bsarec_tpu_torch.ops import rank
    from bsarec_tpu_torch.ops.topk import topk_metrics
    from bsarec_tpu_torch.train.loop import build_eval_fn

    test = SeqRecData(Corpus(user_seq=seqs, max_item=N_ITEMS - 1), max_len=50).test
    inputs = torch.from_numpy(test.input_ids).long().to(device)
    answers = torch.from_numpy(test.answers).long().to(device)
    seen = torch.from_numpy(rank.dedupe_seen_rows(test.seen_items)).to(device)
    evaluate, steps, _ = build_eval_fn(model, N_ITEMS, EVAL_BATCH, N_USERS, device,
                                       impl="streaming", seen_format="ids")
    evaluate(inputs, answers, seen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate(inputs, answers, seen)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    log(f"eval steady state: {N_USERS} users in {seconds:.3f}s = {N_USERS / seconds:.1f} users/s, "
        f"{1e3 * seconds / steps:.3f} ms per {EVAL_BATCH}-user batch (second pass) [{card}]")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate(inputs, answers, seen)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    on_device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in on_device) / 1e6
    if busy > 0:
        log(f"eval trace: device busy {busy:.3f}s of a {traced:.3f}s traced pass, idle share "
            f"{100 * (1 - busy / traced):.1f}% (torch.profiler) [{card}]")
        for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"eval trace device time {e.key[:90]}: {e.self_device_time_total / 1e3 / steps:.4f} "
                f"ms per batch, {e.count} calls [{card}]")
    else:
        log("eval trace: torch.profiler recorded no device time; device busy share not measured")

    # each piece alone, called back to back: where a piece is host-bound
    # this is the host's dispatch time, not the card's
    idx = torch.arange(EVAL_BATCH, device=device)
    with torch.inference_mode():
        states = model.predict(inputs[idx])[:, -1, :].contiguous()
        bitmask = rank.seen_ids_to_bitmask(seen[idx], N_ITEMS)
        _, ids = rank.streaming_masked_topk(states, model.item_table, bitmask, TOP_K, N_ITEMS)
        valid = torch.ones(EVAL_BATCH, device=device)
        pieces = {
            "model forward": lambda: model.predict(inputs[idx])[:, -1, :].contiguous(),
            "seen bitmask": lambda: rank.seen_ids_to_bitmask(seen[idx], N_ITEMS),
            "rank kernel": lambda: rank.streaming_masked_topk(states, model.item_table, bitmask,
                                                               TOP_K, N_ITEMS),
            "metric sums": lambda: topk_metrics(ids, answers[idx], valid),
        }
        for name, fn in pieces.items():
            log(f"eval breakdown {name}: {cuda_ms(fn, iters=100):.4f} ms per {EVAL_BATCH}-user "
                f"batch, back to back [{card}]")


def phase_times(full, card):
    """Phase 4 at the main path's kernel shape. Returns the JSON fields."""
    import torch

    from bsarec_tpu_torch.ops import rank

    states, table, bitmask = full
    b, h = states.shape
    v, k = table.shape[0], TOP_K
    ms = cuda_ms(lambda: rank.streaming_masked_topk(states, table, bitmask, k, v), iters=20)
    plain_ms = cuda_ms(lambda: rank.streaming_masked_topk_plain(states, table, bitmask, k, v),
                       iters=3, warmup=1)
    # yardstick only (the port never calls it): one dense score matrix,
    # the seen mask applied as a [B, V] bool tensor built outside the timing
    cols = torch.arange(v, device=states.device)
    seen = ((bitmask[:, cols >> 5] >> (cols & 31).int()) & 1).bool()

    def library():
        scores = torch.matmul(states, table.T).masked_fill_(seen, 0.0)
        return torch.topk(scores, k)

    library_ms = cuda_ms(library, iters=5)
    flops = 2 * b * v * h
    nbytes = 4 * (b * h + v * h + bitmask.numel()) + 8 * b * k
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    for name, t in (("kernel", ms), ("plain version", plain_ms),
                    ("library matmul+masked_fill+topk", library_ms)):
        log(f"time streaming_masked_topk {name}: {t:.4f} ms per {b}-user batch "
            f"(B={b} V={v} H={h} k={k}) [{card}]")
    log(f"bound streaming_masked_topk: {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP "
        f"fp32 at 67 TFLOP/s = {t_ops:.4f} ms; {nbytes / 1e6:.1f} MB at 3.35 TB/s = "
        f"{t_bytes:.4f} ms) -> kernel at {100 * bound_ms / ms:.1f}% of the bound [{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this smoke test runs only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bsarec_tpu_torch.ops import _build
    from bsarec_tpu_torch.train.trainer import set_fp32_matmul

    device = torch.device("cuda", 0)
    card = card_line()
    log(card)
    set_fp32_matmul()

    t0 = time.perf_counter()
    _build.build_all(verbose=True)
    log(f"build: {len(_build.SOURCES)} CUDA source(s) compiled in {time.perf_counter() - t0:.1f}s")

    worst_err, full = phase_kernels(device)
    with tempfile.TemporaryDirectory() as workdir:
        launches, eval_seconds, seqs, model = phase_main_path(device, workdir)
    log(f"eval: {N_USERS} users in {eval_seconds:.3f}s = {N_USERS / eval_seconds:.1f} users/s "
        f"(test pass of main --do_eval, first batch included) [{card}]")
    times = phase_times(full, card)
    phase_breakdown(device, seqs, model, card)

    kernels = [{
        "name": "streaming_masked_topk",
        "route": "cuda",
        "source": "bsarec_tpu_torch/csrc/streaming_rank.cu",
        "replaces": "bsarec_tpu/ops/pallas_rank.py:165",
        "launches": launches,
        "max_abs_err": worst_err,
        **times,
    }]
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

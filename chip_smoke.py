"""Smoke test of the PyTorch/CUDA port (`bsarec_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) when it fails:

1. Print the card's name and power limit; build every CUDA kernel of the
   port from `bsarec_tpu_torch/csrc/` with nvcc, one process per source,
   all started together.
2. Hold the streaming masked top-k kernel against its plain PyTorch
   version at the eval path's shape (B=256 users, V=1,000,000 items,
   H=64, k=20) and at edge shapes: odd B, V off every tile, n_valid < V,
   k in {1, 20, 128}, an all-seen row, fewer valid items than k, H off
   the kernel's hidden chunk, and integer-valued inputs whose dot
   products are exact, where values and ids (tie order included) must be
   bit-equal. On float inputs values agree within FLOAT_TOL and each
   returned id is checked by the plain version's score of that id. Each
   case takes the route its shape names (on-chip at B <= 256, H <= 64
   and k <= 32, the older sweep at k=128), and every on-chip case is
   bit-equal in values and ids to the older route on the same inputs.
   Every case runs twice: in the eval mode (a seen item scores 0.0) and
   in the serving mode (-inf), which must leave no seen item in the
   result and (-inf, 0) in every slot it cannot fill.
3. Hold the three streaming-CE kernels (logZ, gold-row gather, fused
   backward) against their plain versions at the training shape (B=256,
   V=1,000,000, H=64) and at edge shapes (odd B, V off every tile,
   n_valid < V, H in {32, 48, 128, 256}, repeated answers, raw int64
   answers of -1, >= n_valid and >= V, an answer at item 0): the fused
   forward's loss and logZ (one ce_logz call), the finished ds and dT
   (one ce_grads call), both through the autograd function, within
   CE_TOL and GRAD_TOL; the standalone gather bit-equal; the fused
   ds bit-equal to the unfused composition of the same kernels
   (ce_grads with every answer set to -1, which leaves out the gold
   terms, minus dloss * gold_rows); ce_grads on the route its shape
   names (on-chip at B <= 256 and H <= 64; at H in {128, 256} the sweep in
   the fp32 form and the middle route's tensor-core pair in the bf16 form),
   and two ce_grads calls on the same inputs bit-equal in ds and dT; dT's
   one-hot term read off ce_grads (on the answers against answers of -1)
   equal, up to fp32 rounding, to the sum of dloss_i * s_i over the
   unrounded states. Every case runs twice: in the fp32 form and in the
   bf16-operand form (`--dtype bf16`; on the on-chip route its own
   tensor-core kernels, ce_fwd_onchip_tc_kernel and ce_bwd_onchip_tc_kernel;
   on the middle route, phase 3c's ce_fwd_mid_tc_kernel and
   ce_bwd_mid_tc_kernel) against the plain bf16 versions: its logZ apart
   from the fp32 form's, its ce_grads at the kernel's logZ within
   bsarec_tpu_torch/parity.py's BF16_GRAD_TOL of the plain version at that
   logZ (ds, dT's answer rows and dT's other rows apart), which the fp32
   form must exceed on ds and on dT's other rows; on the on-chip and
   middle routes, whose bf16 pairs sum their logits
   in the tensor cores' order, within BF16_WIDE_GRAD_TOL of
   parity.ce_grads_bf16_in_order, as the wide route's bf16 form is held
   (the distance from the plain version printed beside), the fp32 control
   moving to the exact-logit cases. Then both forms at ONCHIP_EXACT_CASES
   (parity.exact_logit_case inputs at H in {48, 64}, the states scaled by
   2, the main path's shape among them, whose logits are exact in any
   summation order): the sharp check of the tensor cores' own summation
   order, the bf16 form within BF16_GRAD_TOL, which the fp32 form must
   fail.
3b. The wide routes (H > 256; the wide phase): the CE kernels in both
   forms at WIDE_CE_CASES (H in {260, 384, 512, 1024}, the main path's
   B=256, V=1M, H=512 among them, odd B, B over one group of 256 rows, V
   off every tile, n_valid < V, raw int64 answers of -1, >= n_valid and
   >= V, repeated answers) with phase 3's checks, both forms' ce_logz and
   ce_grads on the tensor-core kernels (fp32: ce_fwd_wide_tf32_kernel,
   ce_bwd_wide_tf32_kernel, in 3xTF32; bf16: ce_fwd_wide_tc_kernel,
   ce_bwd_wide_tc_kernel), the bf16 form's
   gradients within parity.BF16_WIDE_GRAD_TOL of the plain version with
   its logits summed in ascending h (parity.ce_grads_bf16_in_order), which
   the fp32 form must fail; and at WIDE_EXACT_CASES (parity.exact_logit_case
   inputs, H in {260, 512, 1024}, the main path's shape among them, whose
   logits are exact in any summation order) within parity.BF16_GRAD_TOL
   of it, which the fp32 form must fail, and the fp32 form's loss and logZ
   bit-equal to the bf16 form's (both forward kernels see the same exact
   logits and fold them in the same order); the rank kernel in
   both modes at WIDE_RANK_CASES (H in {260, 512, 1024}, k in {1, 20, 32,
   33, 128}, B in {1, 5, 9, 37, 64, 70, 256, 300}, n_valid < V and < k,
   all-seen rows) with phase 2's checks, two calls bit-equal, on the route
   its shape names: at k <= 32 the tensor-core route (rank_wide_tf32_kernel,
   3xTF32), held besides against the older route on the same inputs,
   values and ids bit-equal on the integer cases and values within
   FLOAT_TOL on the float ones; at k > 32 the older route with all states
   staged or in hidden chunks. Then `main
   --hidden_size 512` on a 1M-item x 2.5k-user corpus: one epoch, then
   `--resume --epochs 2 --export_topk`, which must start at epoch 1 (one
   ce_logz and one ce_grads launch a step, every one on the wide route;
   the rank kernel on every eval batch, every launch on
   rank_wide_tf32_kernel; finite losses; the first 512
   users' exported top-20 against the plain version; every CE launch on an
   fp32 tensor-core kernel), and one `--dtype
   bf16` epoch (the bf16 forms on the wide route, every ce_logz and
   ce_grads launch on its tensor-core kernel, every rank launch on
   rank_wide_tf32_kernel). Then the wide main path's kernels timed as
   phase 10 times them (the CE entries in both forms; the rank kernel at
   k=20 at B=256 and B=16, with its older route in turns, and, in the
   older route's wide form, at k=128), and the phase's seconds.
3c. The middle route (B <= 256, 64 < H <= 256; the mid phase, after the
   wide phase): the CE kernels in both forms at MID_CE_CASES (the main
   path's B=256, V=1M, H=256 among them; H in {68, 128, 192}, B in {1, 3,
   255}, BERT4Rec's table at n_valid = V - 1, repeated answers) and at the
   main shape at H = 128 with phase
   3's checks, the bf16 form on ce_fwd_mid_tc_kernel and
   ce_bwd_mid_tc_kernel (a middle-route launch each call) held as the
   on-chip route's tensor-core pair (parity.ce_grads_bf16_in_order within
   BF16_WIDE_GRAD_TOL), the fp32 form on ce_fwd_mid_tf32_kernel (wgmma in
   3xTF32) and ce_bwd_wide_tf32_kernel (3xTF32; logZ within CE_TOL,
   gradients within GRAD_TOL); two cases past the route (B = 300 at H =
   128, B = 257 at H = 256), where both forms
   take the older sweeps, the bf16 form held within BF16_GRAD_TOL of the
   plain bf16 version with its fp32 control failing; and at
   MID_EXACT_CASES (parity.exact_logit_case inputs at scale 1, the main
   path's shape among them) within parity.BF16_GRAD_TOL, which the fp32
   form must fail. Then `main --hidden_size 256 --dtype bf16` (BSARec, 2
   layers, 1 head, c=5, alpha=0.7, max_len 50) on a 1M-item x 5k-user
   corpus for one epoch (every ce_logz and ce_grads launch on the middle
   route's kernels, the rank kernel on every eval batch), then `--do_eval
   --load_model --export_topk` (the rank kernel's older route, no CE
   launch); then the same epoch in fp32 (every ce_logz launch on
   ce_fwd_mid_tf32_kernel, every ce_grads launch on
   ce_bwd_wide_tf32_kernel); the bf16 CE entries at H in {128, 256} timed
   as phase 10 times them (in turns with the fp32 form; plain, library,
   bound; the training step's CE in at most 5 device operations), the
   fp32 entries there (plain, library, the 3xTF32 bound), and each form's
   step CE ms beside main's examples/s.
4. Hold the fused dropout kernel against its plain version, bit for bit,
   at SASRec's two site shapes ([256, 50, 64] and [256, 2, 50, 50]) in
   fp32 and bf16 and at edge shapes (n in {1, 3, 4, 4097, 1000003}, rates
   {0, 0.2, 0.5, 0.9}, aligned and misaligned views); then the checks of
   `benchmarks/validate_pallas_dropout.py` (keep fraction, kept scale,
   determinism, seed and call sensitivity, keep fraction per 64K chunk)
   and the forward/backward mask identity through the autograd function.
5. One Adam step of a full-width BSARec at 1,000,000 items through the
   kernels against the same step through the plain versions (same
   weights and batch, dropout 0): loss, gradients and parameters. Then
   one SASRec step with every dropout site on the kernel against the same
   step on its plain version (same weights, batch, negatives and seeds):
   14 dropout launches, loss, gradients and parameters. Then one Adam
   step of the same BSARec under the bf16 policy through the kernels'
   bf16 form against the plain bf16 CE on the card.
6. Drive the eval path through its normal entry point:
   `bsarec_tpu_torch.main --do_eval --eval_impl streaming --export_topk`
   on a seeded synthetic 1,000,000-item x 50,000-user corpus with a
   seeded random-init BSARec at the paper's Beauty widths (hidden 64,
   2 layers, 1 head, c=5, alpha=0.7, max_len 50). The rank kernel's
   launch count must cover every eval batch of the test pass and the
   export, every launch on its on-chip route, and the first 512 users'
   exported top-20 must agree with the plain version.
7. Drive the training path through its normal entry point: `main`
   without `--do_eval` on a 1,000,000-item x 5,000-user corpus, BSARec
   at the same widths with dropout 0.5, batch 256, lr 5e-4, 2 epochs;
   then `--resume --epochs 3 --export_topk`, which must start at epoch
   2. The CE forward and backward kernels must launch once per step, every
   ce_logz and ce_grads launch on its on-chip route, and the standalone
   gather never;
   every epoch's loss must be finite and epoch 1's below epoch 0's; the
   checkpoint and the `.state` snapshot must exist; the test scores must
   lie in [0, 1].
8. Drive the serving path in phase 7's directory: `main --do_eval
   --load_model <phase 7's BSARec> --export_serving scorer.pt2` on the
   card, `serving.load_scorer(..., "cuda")`, one artifact call at B=256
   (the rank kernel launches once, on its on-chip route), then the HTTP
   host (`serve.make_server`, port 0, a thread): /healthz, /rank with
   ragged histories at b = 1, 17 and 256, a malformed body and an
   out-of-range id (400), sequential requests/s and p50/p99 latency at
   b = 1 and 256 (HTTP_LOAD_REQUESTS requests each). Only rank launches,
   all on-chip. Then the artifact's top-20 at B=256 against the serving-mode plain version (each id by its
   plain score), the dense, filtered and chunked artifacts against it,
   the int8 artifact's overlap with it (at least INT8_MIN_OVERLAP), the
   serving op on both routes at edge rows (an all-seen row, rows with 5
   unseen items, out-of-range seen ids) against a host reference of
   JAX's serving contract, its -inf fill included; export seconds and
   bytes, each layout's ms per call at b = 1, 16 and 256 (median of
   SCORER_CALLS), and the rank
   kernel's serving mode against its eval mode on the same inputs.
9. Drive SASRec's training path: `main --model_type SASRec --prng rbg`
   with BSAREC_DROPOUT=pallas at the CLI defaults on the same corpus, 2
   epochs, then `--resume --epochs 3`; exactly 14 dropout launches per
   step, the rank kernel in every validation and no CE launch; epoch 1's
   loss below epoch 0's; the resumed run starts at epoch 2. Then 2
   epochs with nn.Dropout for the rate without the kernel.
9b. The main paths under `--dtype bf16`: BSARec for one epoch, then
   `--resume` to a second with `--export_topk` (one ce_logz and one
   ce_grads launch a step, all in the bf16 form on the on-chip route;
   the rank kernel on every eval batch); `--export_serving` of it, whose
   artifact's top-20 at B=256 is held against the plain version on
   bf16-rounded operands (one rank launch); SASRec under `--prng rbg`
   and BSAREC_DROPOUT=pallas for one epoch (14 dropout launches a step,
   8 of them on bf16 tensors).
10. Time every kernel, its plain version and one library yardstick with
   CUDA events, print each bound, eval users/s and a steady-state eval
   pass with its per-batch breakdown, train examples/s, a per-step
   training breakdown, the host syncs of a training step, the device's
   busy share under torch.profiler (for BSARec and for SASRec with the
   fused dropout), and a `kernels` JSON line. Comparisons with a
   yardstick run in turns (kernel, yardstick, yardstick, kernel): the
   standalone gather against `index_select` back to back and in a CUDA
   graph; one CE forward plus backward through the fused entries against
   the unfused composition (host ms to issue, card ms in a CUDA graph,
   device operations under torch.profiler; the training step's CE must
   make 2 wrapper calls and at most 5 device operations); the dropout
   kernel against `F.dropout` back to back and through a model's site
   with its backward against `nn.Dropout`; the dropout kernel with a
   cold and a warm L2. The CE kernels' bf16 forms in turns with their
   fp32 forms, with their plain versions, a bf16 library yardstick and
   their bounds at the bf16 tensor rate; BSARec's training step in bf16
   against fp32 in turns (examples/s, device busy share).

11. PREPRec's NewRec (`bsarec_tpu_torch/preprec/`), which runs no
   hand-written kernel (every launch count stays 0): `python -m
   bsarec_tpu_torch.preprec.main`'s entry at full width (maxlen 200,
   hidden 50, 2 blocks, 1 head, batch 128, input_units 132 + 6) on a
   10,000-user domain that the port's `preprocess` builds, one epoch with
   a method-1 valid and test eval (finite loss, ranks in [0, 100],
   best.ckpt written); the method-3 full-catalog eval over 1,000,000 items
   through `PrepRecTrainer.evaluate` (2,048 users, eval batch 32, item
   chunk 4,096, popularity tables drawn on the card: month [35, V+1, 11],
   week [104, V+1, 6]), the first 8 users' ranks inside the window that
   the CPU path's scores on the same params and tables allow (items
   within PREPREC_SCORE_TOL of the ground truth on either side), users/s
   and peak memory; 20 training steps at that scale under torch.profiler
   (busy share, top device entries).
11b. The other five PREPRec models and the rest of the PREPRec CLI
   (`phase_preprec_zoo`, no hand-written kernel either), in phase 11's
   directory, on its domain: `preprec.main` at the same full width trains
   SASRecB, BERT4RecB, NewB4Rec (both with `--mask_prob 0.2`), BPRMF and
   CL4SRec for one epoch each with a method-1 valid and test eval (finite
   positive losses, ranks in [0, 100], best.ckpt written; examples/s and
   users/s per model) and ranks with mostpop (users/s); SASRecB's method
   3 over 1,000,000 items through `PrepRecTrainer.evaluate` (item table
   1M x 50, 2,048 users, eval batch 32, item chunk 4,096), the first 8
   users' ranks inside the CPU path's windows, users/s and peak memory;
   SASRecB's `--save_scores`, then `--use_scores` on them (the ensembled
   metrics logged); `--export_user_embed` of phase 11's NewRec ([U, 50]);
   `--fs_transfer --fs_emb` from phase 11's best.ckpt (every parameter
   but fs_layer's bit-equal to it afterwards); `--export_serving` of that
   NewRec with `--save_scores`, the artifact loaded on the card scoring
   the first 64 users' candidates within PREPREC_SERVE_TOL of the eval
   path's saved rows.

12. The tools (after phase 8, in phase 7's directory; `phase tools: ...`,
   `tools ...` lines and a `tools: {...}` summary): the native host library
   (`bsarec_tpu_torch/native.py`) built with g++ from `native/seqrec.cpp`
   and loaded; at phase 7's corpus its corpus parse, train split, both eval
   splits and the test split's seen bitmask at V = 1,000,000 bit-equal to
   the port's numpy paths, the same-target sampler against its contract,
   each host time native against numpy; `--remat`: two Adam steps at B=256,
   V=1,000,000 eager and through `remat_loss` from the same parameters,
   batches and seeds, for BSARec at hidden 64 (fp32 and bf16, dropout 0.5
   on nn.Dropout), BSARec at hidden 512 and SASRec on the fused dropout,
   the parameters after them bit-equal, the remat step's launches (two
   ce_logz and one ce_grads, 21 dropout passes), ms and peak memory of
   each; `main --remat` for one epoch; `main --profile` of a one-epoch
   fit on a 1M-item x 1k-user corpus, whose trace names the CE and rank
   kernels and the training annotations (its top device entries
   printed); `main --do_eval --load_model smoke_train --dump_seqout`
   (40 batches x 3 files, shapes, read back by `load_sequence_outputs`,
   the last layer against the model's forward).
13. The vocab-sharded mesh (`core/mesh.py`, `parallel/`; `mesh ...` lines
   and a `mesh: {...}` summary). After phase 3, m shards of the 1M-item
   table in one process through the merges of `parallel/logits.py`, one
   kernel launch a shard: the CE at m in {2, 4}, H = 64 and m = 2, H = 512,
   both forms (loss and logZ within CE_TOL of one unsharded call, the
   backward at its logZ within the form's gradient limit), the top-20 at
   n_valid 999,997 and where the last shard is empty (ids and values
   bit-equal to the unsharded kernel's), the shard-mode seen bitmasks
   native against numpy, bit-equal; each composition timed against the
   unsharded call. After phase 12, in phase 7's directory: `main --mesh
   data:1,model:1` through a one-rank NCCL group and `main --multihost`
   (the host-fed pipeline, `data/multihost.py`), alone and under that
   mesh, in turns with the plain run (plain, host-fed, mesh, host-fed
   under the mesh, host-fed, plain; scores, epoch loss and checkpoint
   bit-equal, the same launches, the host-fed runs' peak allocated bytes
   below the plain runs', printed beside the device-resident training
   set's bytes and each run's examples/s), SASRec on the fused dropout
   under the mesh, device-resident and host-fed (14 launches a step, the
   same epoch loss), and `main --mesh data:1,model:2` as two gloo processes sharing the
   card (the epoch loss within parity.MESH_LOSS_RTOL of the plain run's,
   one launch a step of each CE kernel and one an eval batch of the rank
   kernel on each rank).

Every path is driven with every kernel's launch count set to 0 just
before it and read just after.

The last line is `{"ok": true, "device": {...}}`. Without a CUDA device
the script exits 1 and prints no result. It imports nothing of JAX.
"""

from __future__ import annotations

import ast
import contextlib
import copy
import json
import logging
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

# fp32 sums of 64 products taken in another order than torch.matmul's;
# scores at these shapes stay below ~50 in magnitude
FLOAT_TOL = 1e-4
# CE, relative to max(1, |plain|): logZ sums up to 1M exponentials of
# H-term fp32 dot products, in another order than torch's (the sum's
# relative error, ~1e-6, becomes logZ's absolute error)
CE_TOL = 1e-5
# gradients, relative to the largest |plain| entry of the same tensor (dT:
# of the answer rows and of the other rows apart): ds sums up to 1M
# columns, dT up to 256 rows, each term carrying p = exp(logit - logZ)
# with logZ's error
GRAD_TOL = 1e-4
# the CE kernels' bf16-operand form: loss and logZ are fp32 sums of exact
# products of the rounded operands (CE_TOL holds); its gradients are held
# as bsarec_tpu_torch/parity.py says. A bf16 model's step through them
# against the same step through the plain CE: the two logZs differ by their
# fp32 rounding, which moves some p = softmax * dloss one bf16 ulp (2^-8)
# apart (the item table's gradient: readings up to 4.9e-5 of its largest
# entry), and the gradients crossing each bf16 cast of the model are
# rounded there, where such a difference can flip a rounding again (the
# other tensors: readings up to 2.5e-3; PERF.md)
BF16_STEP_TABLE_TOL = 1e-3
BF16_STEP_GRAD_TOL = 1e-2
# one Adam step from the same weights: Adam divides each gradient by its
# own magnitude, so a gradient's relative rounding error moves its
# parameter by that fraction of lr (5e-4)
STEP_PARAM_TOL = 1e-6
# H100 SXM peaks from NVIDIA's data sheet: fp32 outside
# the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# ... and the dense bf16 tensor-core rate, the peak for the CE kernels'
# bf16-operand form
PEAK_BF16_FLOPS = 989e12
# ... and the dense TF32 tensor-core rate: the fp32 form's wide ce_logz and
# ce_grads take every product in 3xTF32, three TF32 passes
PEAK_TF32_FLOPS = 495e12

# EVAL_BATCH is TrainConfig.eval_batch_size's default, which main uses
N_USERS, N_ITEMS, EVAL_BATCH, TOP_K = 50_000, 1_000_000, 256, 20
TRACED_EVAL_USERS = 40 * EVAL_BATCH
# the training corpus: 5,000 users (10,000 before the fp32 middle route's
# epochs: the script's time)
TRAIN_USERS, TRAIN_BATCH, LR = 5_000, 256, 5e-4
WIDTHS = ["--model_type", "BSARec", "--hidden_size", "64", "--num_hidden_layers", "2",
          "--num_attention_heads", "1", "--c", "5", "--alpha", "0.7", "--max_seq_length", "50"]
# SASRec at the CLI defaults (hidden 64, 2 layers, 2 heads, dropout 0.5/0.5,
# max_len 50, lr 1e-3): dropout sites per forward (embedding, then per
# layer the attention probabilities, the attention output and the FFN),
# and the two shapes they see at batch 256
SASREC_LR = 1e-3
DROPOUT_SITES = 7
DROPOUT_SHAPES = {"hidden": (256, 50, 64), "attention": (256, 2, 50, 50)}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


@contextlib.contextmanager
def timed(name: str):
    """Log the seconds a phase took."""
    t0 = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.1f}s")


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


def device_kernels(prof):
    """The profiler's device-side entries, without user annotations (such
    as `Optimizer.step#Adam.step`), whose ranges overlap the kernels."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def masked_scores(states, table, bitmask, n_valid, ids, seen_value=0.0):
    """The plain version's masked score of each given id: s . T[id],
    seen_value (0.0 eval, -inf serving) where the id is seen, -inf at or
    past n_valid."""
    import torch

    ids = ids.long()
    raw = torch.einsum("bh,bkh->bk", states, table[ids])
    seen = (torch.gather(bitmask, 1, ids >> 5) >> (ids & 31).int()) & 1
    raw = torch.where(seen.bool(), torch.full_like(raw, seen_value), raw)
    return torch.where(ids < n_valid, raw, torch.full_like(raw, -math.inf))


# phase 2's rank cases, the i-th on make_case's inputs seeded with i:
# (tag, B, V, H, k, n_valid, seen per row, integer, all-seen row).
# bsarec_tpu_torch/tools/time_kernels.py digests the kernel's results here.
RANK_CASES = [
    ("main path", 256, N_ITEMS, 64, TOP_K, N_ITEMS, 16, False, False),
    ("odd B, n_valid < V", 37, 5000, 64, 20, 4990, 16, False, False),
    ("V off the tile, k=1", 3, 12101, 64, 1, 12101, 16, False, False),
    ("k=128", 64, 33333, 64, 128, 33333, 16, False, False),
    ("all-seen row", 9, 4099, 64, 20, 4099, 16, False, True),
    ("n_valid < k", 5, 300, 64, 20, 10, 4, False, False),
    ("H off the hidden chunk", 130, 70001, 48, 20, 70001, 16, False, False),
    ("on-chip bounds", 256, 64 * 1563 + 17, 64, 32, 64 * 1563 + 5, 16, False, True),
    ("past the on-chip bounds", 257, 30011, 64, 33, 30011, 16, False, False),
    ("integer", 37, 20011, 64, 1, 20006, 16, True, False),
    ("integer", 37, 20011, 64, 20, 20006, 16, True, False),
    ("integer, all-seen row", 70, 20011, 64, 128, 20011, 16, True, True),
]


def make_case(b, v, h, n_seen, seed, device, integer=False, all_seen_row=False, scale=1.0):
    """Seeded inputs: states [b, h], table [v, h] (N(0, 1) times `scale`, or
    integers), a seen bitmask built on the device from 0-padded id lists
    with repeats (and checked against the host builder)."""
    import torch

    from bsarec_tpu_torch.ops import rank

    rng = np.random.default_rng(seed)
    if integer:
        states = rng.integers(-3, 4, size=(b, h)).astype(np.float32)
        table = rng.integers(-3, 4, size=(v, h)).astype(np.float32)
    else:
        states = rng.standard_normal((b, h), dtype=np.float32)
        table = rng.standard_normal((v, h), dtype=np.float32)
        if scale != 1.0:
            table *= np.float32(scale)
    seen = rng.integers(1, v, size=(b, n_seen + 4)).astype(np.int32)
    seen[:, 1] = seen[:, 0]  # a repeated item
    seen[:, -3:] = 0  # padding
    host = rank.build_seen_bitmask(seen, v)
    dev = rank.seen_ids_to_bitmask(torch.from_numpy(rank.dedupe_seen_rows(seen)).to(device), v)
    check(np.array_equal(dev.cpu().numpy(), host), "seen_ids_to_bitmask differs from build_seen_bitmask")
    if all_seen_row:
        dev[b // 2] = -1
    return torch.from_numpy(states).to(device), torch.from_numpy(table).to(device), dev


def compare_kernel(case_name, states, table, bitmask, k, n_valid, exact, seen_value=0.0):
    """Kernel vs plain on one input, a seen item scoring seen_value (0.0
    eval, -inf serving); returns the largest value error."""
    import torch

    from bsarec_tpu_torch.ops import rank

    case_name = f"{case_name}, {'eval' if seen_value == 0.0 else 'serving'} mode"
    b, h = states.shape
    f = rank.streaming_masked_topk
    before = (f.onchip_launches, f.tc_launches, f.wide_launches)
    vals, ids = rank.streaming_masked_topk(states, table, bitmask, k, n_valid, seen_value)
    again_v, again_i = rank.streaming_masked_topk(states, table, bitmask, k, n_valid, seen_value)
    torch.cuda.synchronize()
    onchip, tc, wide = ((n - n0) // 2 for n, n0 in
                        zip((f.onchip_launches, f.tc_launches, f.wide_launches), before))
    check(onchip == rank.onchip_route(b, h, k)
          and tc == (not onchip and rank.tc_route(b, h, k))
          and wide == (not onchip and not tc and rank.wide_route(h, k)),
          f"{case_name}: the rank kernel took another route than its shape names")
    check(torch.equal(vals, again_v) and torch.equal(ids, again_i),
          f"{case_name}: two calls on the same inputs differ")
    del again_v, again_i
    if onchip:  # the older route on the same inputs gives the same bits
        old_v, old_i = rank._launch(states, table, bitmask, k, n_valid, allow_onchip=False,
                                    seen_value=seen_value)
        torch.cuda.synchronize()
        check(torch.equal(vals, old_v) and torch.equal(ids, old_i),
              f"{case_name}: the on-chip route differs from the older route at "
              f"{int(((vals != old_v) | (ids != old_i)).sum())} of {vals.numel()} slots")
        del old_v, old_i
    tc_err = None
    if tc:  # the older route on the same inputs: bit-equal where the scores are exact
        old_v, old_i = rank._launch(states, table, bitmask, k, n_valid, allow_tc=False,
                                    seen_value=seen_value)
        torch.cuda.synchronize()
        old_finite = torch.isfinite(old_v)
        check(torch.equal(torch.isfinite(vals), old_finite),
              f"{case_name}: the tensor-core route fills other slots than the older route")
        tc_err = float((vals[old_finite] - old_v[old_finite]).abs().max()) if old_finite.any() else 0.0
        if exact:
            check(torch.equal(vals, old_v) and torch.equal(ids, old_i),
                  f"{case_name}: the tensor-core route differs from the older route at "
                  f"{int(((vals != old_v) | (ids != old_i)).sum())} of {vals.numel()} slots")
        else:
            check(tc_err <= FLOAT_TOL, f"{case_name}: tensor-core route {tc_err} off the older route")
        del old_v, old_i
    want_v, want_i = rank.streaming_masked_topk_plain(states, table, bitmask, k, n_valid,
                                                      seen_value=seen_value)
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
        by_score = masked_scores(states, table, bitmask, n_valid, ids, seen_value)
        id_err = float((by_score[finite] - want_v[finite]).abs().max()) if finite.any() else 0.0
        check(id_err <= FLOAT_TOL, f"{case_name}: returned ids score {id_err} off the plain values")
        for r in range(ids.shape[0]):
            row = ids[r][finite[r]]
            check(row.unique().numel() == row.numel(), f"{case_name}: row {r} repeats an id")
    route = ("on-chip, bit-equal to the older route" if onchip
             else "tensor cores (rank_wide_tf32_kernel), bit-equal to the older route" if tc and exact
             else f"tensor cores (rank_wide_tf32_kernel), {tc_err:.3g} off the older route" if tc
             else "older route, states in hidden chunks" if wide else "older route")
    log(f"kernel vs plain {case_name}: ok, max |value error| {err:.3g}"
        f"{' (bit-equal ids and values)' if exact else ''}; {route}; two calls bit-equal")
    return err


def phase_kernels(device):
    """Phase 2. Returns (max value error, the full-shape inputs)."""
    worst, full = 0.0, None
    for i, (tag, b, v, h, k, n_valid, n_seen, integer, all_seen) in enumerate(RANK_CASES):
        name = f"{tag} (B={b} V={v} H={h} k={k} n_valid={n_valid})"
        states, table, bitmask = make_case(b, v, h, n_seen, seed=i, device=device,
                                           integer=integer, all_seen_row=all_seen)
        for seen_value in (0.0, -math.inf):
            worst = max(worst, compare_kernel(name, states, table, bitmask, k, n_valid, integer,
                                              seen_value))
        if i == 0:
            full = (states, table, bitmask)
    return worst, full


def phase_main_path(device, workdir):
    """Phase 3: `main --do_eval --eval_impl streaming --export_topk` at
    full width. Returns (kernel launches, those on the on-chip route,
    test-pass seconds, the corpus's sequences, the model on the device)."""
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
        *WIDTHS,
    ]
    reset_counts()
    t0 = time.perf_counter()
    scores = port_main.main(argv)
    torch.cuda.synchronize(device)
    counts = read_counts()
    launches = counts["streaming_masked_topk"]
    onchip = rank.streaming_masked_topk.onchip_launches
    log(f"main path: main(--do_eval --eval_impl streaming --export_topk) returned in "
        f"{time.perf_counter() - t0:.1f}s, test scores {scores}")

    steps = math.ceil(N_USERS / EVAL_BATCH)
    check(counts == zero_counts() | {"streaming_masked_topk": 2 * steps},
          f"eval path launches {counts}, want {2 * steps} rank launches (test pass + export)")
    check(onchip == launches, f"eval path: {onchip} of {launches} rank launches on the on-chip route")
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
    log(f"main path: {launches} kernel launches over {steps} eval batches x 2 passes, {onchip} on "
        f"the on-chip route; first 512 users' exported top-20 agree with the plain version "
        f"(score error {err:.3g})")
    return launches, onchip, eval_seconds, seqs, model


def phase_breakdown(device, seqs, model, card):
    """Where one eval pass's time goes: a steady-state pass of the eval
    function main uses, the first TRACED_EVAL_USERS of such a pass under
    torch.profiler (device busy time by kernel; fewer users keep the
    profiler's post-processing short), and each per-batch piece on its own
    (CUDA events)."""
    import torch
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

    head = slice(0, TRACED_EVAL_USERS)
    evaluate_head, head_steps, _ = build_eval_fn(model, N_ITEMS, EVAL_BATCH, TRACED_EVAL_USERS,
                                                 device, impl="streaming", seen_format="ids")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate_head(inputs[head], answers[head], seen[head])
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    on_device = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in on_device) / 1e6
    if busy > 0:
        log(f"eval trace: device busy {busy:.3f}s of a {traced:.3f}s traced pass over the first "
            f"{TRACED_EVAL_USERS} users, idle share {100 * (1 - busy / traced):.1f}% "
            f"(torch.profiler) [{card}]")
        for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"eval trace device time {e.key[:90]}: "
                f"{e.self_device_time_total / 1e3 / head_steps:.4f} ms per batch, {e.count} calls "
                f"[{card}]")
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
    older_ms = cuda_ms(lambda: rank._launch(states, table, bitmask, k, v, allow_onchip=False),
                       iters=20)
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
    for name, t in (("kernel", ms), ("kernel, older route", older_ms), ("plain version", plain_ms),
                    ("library matmul+masked_fill+topk", library_ms)):
        log(f"time streaming_masked_topk {name}: {t:.4f} ms per {b}-user batch "
            f"(B={b} V={v} H={h} k={k}) [{card}]")
    log(f"bound streaming_masked_topk: {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP "
        f"fp32 at 67 TFLOP/s = {t_ops:.4f} ms; {nbytes / 1e6:.1f} MB at 3.35 TB/s = "
        f"{t_bytes:.4f} ms) -> kernel at {100 * bound_ms / ms:.1f}% of the bound [{card}]")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}



def ce_case(b, v, h, n_valid, seed, device, answer_kind):
    """Seeded CE inputs. answer_kind "plain": answers in [1, n_valid);
    "odd": the first rows repeat one answer, then item 0, -1, n_valid and
    V + 7; "repeated": every answer is one of 5 ids."""
    import torch

    rng = np.random.default_rng(seed)
    states = rng.standard_normal((b, h), dtype=np.float32)
    table = 0.25 * rng.standard_normal((v, h), dtype=np.float32)
    answers = rng.integers(1, n_valid, size=b)
    if answer_kind == "odd":
        special = [answers[0], answers[0], answers[0], 0, -1, n_valid, v + 7]
        answers[: min(b, len(special))] = special[:b]
    elif answer_kind == "repeated":
        answers = rng.choice(rng.integers(1, n_valid, size=5), size=b)
    return (torch.from_numpy(states).to(device), torch.from_numpy(table).to(device),
            torch.from_numpy(answers).to(device))


def compare_ce(case_name, states, table, answers, n_valid, dtype=None, in_order=False,
               exact=False):
    """The CE kernels vs their plain versions on one input, in the form
    `dtype` names (None: fp32; "bfloat16": the bf16-operand form): the
    fused entries (loss and logZ from one ce_logz call, the finished ds and
    dT from one ce_grads call) on the raw int64 answers, the same through
    the autograd function, and the standalone gather. The gradients of ds,
    dT's answer rows and dT's other rows apart: the fp32 form's through
    autograd within GRAD_TOL; the bf16 form's ce_grads at the kernel's logZ
    within parity.BF16_GRAD_TOL of the plain version at that logZ, which the
    fp32 form must exceed. Then the fused ds against the unfused
    composition of the same kernels, bit for bit (in the bf16 form this
    also shows that the ds correction takes the unrounded rows), and dT's
    one-hot term read off the kernel (parity.one_hot_excess), which must
    fail with the rounded states in its place. `in_order` holds the bf16
    form's gradients against parity.ce_grads_bf16_in_order (the plain
    version with the logits summed in ascending h) instead, within
    parity.BF16_WIDE_GRAD_TOL, which the fp32 form must exceed: the wide
    phase's, where ce_grads' bf16 form sums its logits on the tensor
    cores. `exact` (parity.exact_logit_case inputs, whose logits are exact
    in any order) holds it there within parity.BF16_GRAD_TOL instead, and
    asks nothing of the one-hot check's rounded-states control (the
    states are bf16-exact); on the wide route it holds the fp32 form's
    loss and logZ bit-equal to the bf16 form's: there every operand is
    TF32- and bf16-exact (lo = 0) and every partial sum exact, so both
    tensor-core forward kernels hold the same logits bit for bit and fold
    them by one function in one order, and any difference is a fault of
    the fp32 kernel's tiles, masking or fold. The bf16 form on the on-chip
    route (B <= 256, H <= 64) runs a tensor-core pair too, which sums its
    logits in the tensor cores' order: on inputs that are not exact it is
    held as the wide route's (against parity.ce_grads_bf16_in_order within
    parity.BF16_WIDE_GRAD_TOL, its distance from the plain version printed
    beside), and the fp32 form, which lies nearer than that limit at
    H <= 64, must fail only on the exact-logit cases (ONCHIP_EXACT_CASES).
    The bf16 form's middle-route pair (B <= 256, 64 < H <= 256:
    ce_fwd_mid_tc_kernel, ce_bwd_mid_tc_kernel) is held as the on-chip
    route's, its fp32 control on MID_EXACT_CASES. Returns the largest
    absolute error of each kernel's outputs."""
    import torch

    from bsarec_tpu_torch import parity
    from bsarec_tpu_torch.ops import ce

    bf16 = dtype is not None
    # the bf16 form's on-chip and middle-route tensor-core pairs, on inputs
    # whose logits are not exact: held as the wide route's bf16 form is
    # (docstring)
    mid = bf16 and ce.mid_route(*states.shape)
    # the fp32 form's middle route: ce_fwd_mid_tf32_kernel and
    # ce_bwd_wide_tf32_kernel
    mid32 = not bf16 and ce.mid_route(*states.shape)
    onchip_tc = bf16 and not exact and (ce.onchip_route(*states.shape) or mid)
    in_order = in_order or onchip_tc
    mapped = ce.map_answers(answers, n_valid)
    logz_onchip_before = ce.ce_logz.onchip_launches
    logz_wide_before = ce.ce_logz.wide_launches
    logz_mid_before = ce.ce_logz.mid_launches
    logz_mid32_before = ce.ce_logz.mid_tf32_launches
    bf16_before = (ce.ce_logz.bf16_launches, ce.ce_grads.bf16_launches)
    loss_f, logz = ce.ce_loss_logz(states, table, answers, n_valid, dtype=dtype)
    check(ce.ce_logz.onchip_launches - logz_onchip_before == ce.onchip_route(*states.shape)
          and ce.ce_logz.wide_launches - logz_wide_before == ce.wide_route(states.shape[1])
          and ce.ce_logz.mid_launches - logz_mid_before == mid
          and ce.ce_logz.mid_tf32_launches - logz_mid32_before == mid32,
          f"{case_name}: ce_logz took another route than its shape and form name")
    check(ce.ce_logz.bf16_launches - bf16_before[0] == bf16,
          f"{case_name}: ce_logz took another form than {dtype or 'float32'}")
    rows = ce.gold_rows(table, mapped)
    torch.cuda.synchronize()
    want_loss_f, want_logz = ce.ce_loss_logz_plain(states, table, answers, n_valid, bf16=bf16)
    check(torch.equal(torch.isfinite(logz), torch.isfinite(want_logz)), f"{case_name}: logZ finiteness")
    logz_err = float(((logz - want_logz).abs() / want_logz.abs().clamp(min=1.0)).max())
    check(logz_err <= CE_TOL, f"{case_name}: logZ error {logz_err} > {CE_TOL}")
    fused_err = float(((loss_f - want_loss_f).abs() / want_loss_f.abs().clamp(min=1.0)).max())
    check(fused_err <= CE_TOL, f"{case_name}: fused loss error {fused_err} > {CE_TOL}")
    off = (answers < 0) | (answers >= n_valid)
    check(torch.equal(loss_f[off], logz[off]), f"{case_name}: answers off the catalog need gold 0")
    check(torch.equal(ce.ce_logz(states, table, n_valid, dtype=dtype), logz),
          f"{case_name}: logZ alone differs")
    check(torch.equal(rows, ce.gold_rows_plain(table, mapped)), f"{case_name}: gather not bit-equal")
    if bf16 and not exact:  # the rounding is real: the fp32 form's logZ differs
        check(not torch.equal(ce.ce_logz(states, table, n_valid), logz),
              f"{case_name}: the bf16 form's logZ equals the fp32 form's")
    same_as_bf16 = ""
    if exact and not bf16 and ce.wide_route(states.shape[1]):  # the sharp limit: none
        loss_b, logz_b = ce.ce_loss_logz(states, table, answers, n_valid, dtype=BF16)
        check(torch.equal(loss_f, loss_b) and torch.equal(logz, logz_b),
              f"{case_name}: the fp32 form's loss or logZ differs from the bf16 form's on exact "
              f"logits (logZ at {int((logz != logz_b).sum())} of {logz.numel()} rows)")
        same_as_bf16 = ", loss and logZ bit-equal to the bf16 form's"

    grads = []
    for fn in (ce.streaming_softmax_ce, ce.streaming_softmax_ce_plain):
        s = states.clone().requires_grad_()
        t = table.clone().requires_grad_()
        loss = fn(s, t, answers, n_valid, dtype=dtype)
        loss.mean().backward()
        grads.append((loss.detach(), s.grad, t.grad))
        del s, t
    (loss, ds, dt), (want_loss, want_ds, want_dt) = grads
    torch.cuda.synchronize()
    check(torch.equal(loss, loss_f), f"{case_name}: the autograd function's loss differs from ce_loss_logz")
    loss_err = float(((loss - want_loss).abs() / want_loss.abs().clamp(min=1.0)).max())
    check(loss_err <= CE_TOL, f"{case_name}: loss error {loss_err} > {CE_TOL}")
    check(not dt[n_valid:].any(), f"{case_name}: dT rows past n_valid must be 0")
    d = torch.full((states.shape[0],), 1.0 / states.shape[0], device=states.device)
    # two calls on the same inputs give the same bits, on the route the shape takes
    onchip_before = ce.ce_grads.onchip_launches
    wide_before = ce.ce_grads.wide_launches
    mid_before = ce.ce_grads.mid_launches
    mid32_before = ce.ce_grads.mid_tf32_launches
    grads_bf16_before = ce.ce_grads.bf16_launches
    fused_ds, fused_dt = ce.ce_grads(states, table, answers, logz, d, n_valid, dtype=dtype)
    again_ds, again_dt = ce.ce_grads(states, table, answers, logz, d, n_valid, dtype=dtype)
    torch.cuda.synchronize()
    n_onchip = ce.ce_grads.onchip_launches - onchip_before
    n_wide = ce.ce_grads.wide_launches - wide_before
    n_mid = ce.ce_grads.mid_launches - mid_before
    n_mid32 = ce.ce_grads.mid_tf32_launches - mid32_before
    # every wide launch takes a tensor-core kernel, in either form
    route = (("on-chip, tensor cores" if bf16 else "on-chip") if n_onchip
             else "wide, tensor cores" if n_wide else "middle, tensor cores" if n_mid
             else "middle, ce_grads on the wide 3xTF32 kernel" if n_mid32 else "sweep")
    check(n_onchip == (2 if ce.onchip_route(*states.shape) else 0)
          and n_wide == (2 if ce.wide_route(states.shape[1]) else 0) and n_mid == 2 * mid
          and n_mid32 == 2 * mid32,
          f"{case_name}: ce_grads took another route than its shape and form name")
    check(ce.ce_grads.bf16_launches - grads_bf16_before == 2 * bf16,
          f"{case_name}: ce_grads took another form than {dtype or 'float32'}")
    check(torch.equal(fused_ds, again_ds) and torch.equal(fused_dt, again_dt),
          f"{case_name}: two ce_grads calls on the same inputs differ")
    del again_ds, again_dt
    if bf16:
        # the backward through autograd is ce_grads at the kernel's logZ; that
        # call is held against the plain version at the same logZ (parity.py),
        # and the fp32 form, which rounds nothing, must fail the same limit
        # (but for the on-chip tensor-core pair's inputs that are not exact)
        check(torch.equal(ds, fused_ds) and torch.equal(dt, fused_dt),
              f"{case_name}: the autograd function's gradients differ from ce_grads")
        plain = (parity.ce_grads_bf16_in_order(states, table, answers, logz, d, n_valid) if in_order
                 else ce.ce_grads_plain(states, table, answers, logz, d, n_valid, bf16=True))
        errs = parity.grad_errors(fused_ds, fused_dt, *plain, answers, n_valid)
        control = parity.grad_errors(*ce.ce_grads(states, table, answers, logz, d, n_valid),
                                     *plain, answers, n_valid)
        grad_abs = max(float((fused_ds - plain[0]).abs().max()), float((fused_dt - plain[1]).abs().max()))
        del plain
        plain_errs = None
        if onchip_tc:  # a reading beside the limit: the distance from the plain version
            plain_errs = parity.grad_errors(
                fused_ds, fused_dt, *ce.ce_grads_plain(states, table, answers, logz, d, n_valid, bf16=True),
                answers, n_valid)
        tol = parity.BF16_WIDE_GRAD_TOL if in_order and not exact else parity.BF16_GRAD_TOL
        check(max(errs.values()) <= tol,
              f"{case_name}: gradient errors {errs} at the kernel's logZ > {tol}")
        check(onchip_tc or min(control["ds"], control["dT other rows"]) > tol,
              f"{case_name}: the fp32 form passes the bf16 limit {tol} on ds or dT's other rows: "
              f"{control}")
    else:
        errs = parity.grad_errors(ds, dt, want_ds, want_dt, answers, n_valid)
        control = None
        grad_abs = max(float((ds - want_ds).abs().max()), float((dt - want_dt).abs().max()))
        check(max(errs.values()) <= GRAD_TOL, f"{case_name}: gradient errors {errs} > {GRAD_TOL}")
    # the unfused forms: ce_grads with every answer off the catalog leaves out
    # both gold terms; the caller subtracts the gathered rows from ds (bit
    # for bit), and dT differs on the answer rows by the one-hot term on the
    # unrounded states (parity.one_hot_excess), in the bf16 form too
    no_answers = torch.full_like(answers, -1)
    sum_ds, none_dt = ce.ce_grads(states, table, no_answers, logz, d, n_valid, dtype=dtype)
    unfused_ds = sum_ds - d[:, None] * ce.gold_rows(table, mapped)
    torch.cuda.synchronize()
    check(torch.equal(fused_ds, unfused_ds),
          f"{case_name}: fused ds differs from the unfused composition at "
          f"{int((fused_ds != unfused_ds).sum())} of {fused_ds.numel()} elements")
    one_hot = parity.one_hot_excess(fused_dt, none_dt, states, answers, d, n_valid)
    check(one_hot <= 1.0, f"{case_name}: dT's one-hot term {one_hot} of its allowance")
    one_hot_rounded = parity.one_hot_excess(fused_dt, none_dt, states, answers, d, n_valid,
                                            round_states=True)
    check(exact or one_hot_rounded > 1.0,
          f"{case_name}: the one-hot check passes the rounded states too ({one_hot_rounded})")
    del fused_dt, none_dt
    del fused_ds, sum_ds, unfused_ds, no_answers
    abs_err = {
        "ce_logz": max(float((logz - want_logz)[torch.isfinite(want_logz)].abs().max()),
                       float((loss_f - want_loss_f).abs().max()),
                       float((loss - want_loss).abs().max())),
        "gold_rows": 0.0,
        "ce_grads": grad_abs,
    }

    def short(e):
        return ", ".join(f"{k} {v:.3g}" for k, v in e.items())
    order = ", exact logits" if exact else ", logits in ascending h" if in_order else ""
    held = (f"at the kernel's logZ{order}, limit {tol}; the fp32 form against the bf16 plain "
            f"version: {short(control)}" if bf16 else "through autograd")
    if bf16 and plain_errs is not None:
        held += (f"; the kernel against the plain bf16 version (cuBLAS's order): {short(plain_errs)}, "
                 f"the fp32 form required to fail on the exact-logit cases")
    log(f"CE kernels vs plain {case_name}, {dtype or 'float32'} form: ok, logZ rel err {logz_err:.3g}, fused loss {fused_err:.3g}{same_as_bf16}, "
        f"loss through autograd {loss_err:.3g}; gradients {short(errs)} (relative to each group's "
        f"largest |plain|, {held}); {int(off.sum())} answers off the catalog, gather bit-equal; fused ds bit-equal "
        f"to ce_grads(answers -1) - dloss * gold_rows; dT's one-hot term {one_hot:.3g} of its allowance "
        f"(rounded states {one_hot_rounded:.3g}); ce_logz and ce_grads route {route}, two calls bit-equal; "
        f"max abs err logZ/loss {abs_err['ce_logz']:.3g}, ds/dT {abs_err['ce_grads']:.3g}")
    return abs_err


# phase 3's CE cases, the i-th on ce_case's inputs seeded with 100 + i:
# (tag, B, V, H, n_valid, answers). bsarec_tpu_torch/tools/time_kernels.py
# digests the fp32 form's results here.
CE_CASES = [
    ("main path", 256, N_ITEMS, 64, N_ITEMS, "plain"),
    ("odd B, n_valid < V, odd answers", 37, 5000, 64, 4990, "odd"),
    ("V off every tile", 3, 12101, 64, 12101, "odd"),
    ("H=32", 130, 70001, 32, 70001, "odd"),
    ("H=48, n_valid < V", 64, 20011, 48, 20006, "odd"),
    ("H=128", 96, 30011, 128, 30011, "odd"),
    ("H=256, n_valid < V", 256, 40009, 256, 40000, "odd"),
    ("repeated answers", 200, 3001, 64, 3001, "repeated"),
    # BERT4Rec's table with its [mask] row: V mod 64 = 1, the last tile one row
    ("BERT4Rec's table", 256, N_ITEMS + 1, 64, N_ITEMS + 1, "plain"),
]
CE_FORMS = (None, "bfloat16")
# ... and on parity.exact_logit_case's inputs with the states scaled by 2
# (at H <= 64 the unscaled logits spread too little for the fp32 control to
# fail on ds), the i-th seeded with 500 + i: (tag, B, V, H, n_valid). Every
# logit is exact in any summation order, so the bf16 form's on-chip
# tensor-core kernels are held within parity.BF16_GRAD_TOL there
ONCHIP_EXACT_CASES = [
    ("exact logits at the main path's shape", 256, N_ITEMS, 64, N_ITEMS),
    ("exact logits, H=48, odd B, n_valid < V", 37, 20011, 48, 20006),
    ("exact logits, BERT4Rec's table, B=255", 255, N_ITEMS + 1, 64, N_ITEMS),
]


def phase_ce_kernels(device):
    """Phase 3, each case in both forms, CE_CASES then ONCHIP_EXACT_CASES.
    Returns ({form: {kernel: largest absolute error}}, the main-shape
    inputs)."""
    import torch

    from bsarec_tpu_torch import parity

    worst = {form: {"ce_logz": 0.0, "gold_rows": 0.0, "ce_grads": 0.0} for form in CE_FORMS}
    full = None
    for i, (tag, b, v, h, n_valid, kind) in enumerate(CE_CASES):
        states, table, answers = ce_case(b, v, h, n_valid, seed=100 + i, device=device,
                                         answer_kind=kind)
        for form in CE_FORMS:
            errs = compare_ce(f"{tag} (B={b} V={v} H={h} n_valid={n_valid})", states, table,
                              answers, n_valid, dtype=form)
            worst[form] = {k: max(worst[form][k], errs[k]) for k in errs}
        if i == 0:
            full = (states, table, answers)
        del states, table, answers
    for i, (tag, b, v, h, n_valid) in enumerate(ONCHIP_EXACT_CASES):
        states, table, answers, _ = parity.exact_logit_case(b, v, h, n_valid, seed=500 + i,
                                                            device=device, scale=2)
        for form in CE_FORMS:
            errs = compare_ce(f"{tag} (B={b} V={v} H={h} n_valid={n_valid})", states, table,
                              answers, n_valid, dtype=form, exact=True)
            worst[form] = {k: max(worst[form][k], errs[k]) for k in errs}
        del states, table, answers
    torch.cuda.empty_cache()
    return worst, full


def full_width_model(device, dropout: float, loss_impl: str = "auto", dtype: str = "float32"):
    """A seeded random-init BSARec at the paper's Beauty widths, 1M items,
    under the compute dtype `dtype`."""
    import torch

    from bsarec_tpu_torch.config import ModelConfig
    from bsarec_tpu_torch.models import build_model

    cfg = ModelConfig(model_type="bsarec", item_size=N_ITEMS, num_users=TRAIN_USERS + 1,
                      max_seq_length=50, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=1, c=5, alpha=0.7, hidden_dropout_prob=dropout,
                      attention_probs_dropout_prob=dropout, loss_impl=loss_impl,
                      compute_dtype=dtype)
    return build_model(cfg, generator=torch.Generator().manual_seed(0)).to(device)


def random_batch(device, seed):
    """[256, 50] left-padded item ids and [256] answers, from a seed."""
    import torch

    rng = np.random.default_rng(seed)
    ids = rng.integers(1, N_ITEMS, size=(TRAIN_BATCH, 50))
    for r, pad in enumerate(rng.integers(0, 45, size=TRAIN_BATCH)):
        ids[r, :pad] = 0
    answers = rng.integers(1, N_ITEMS, size=TRAIN_BATCH)
    return torch.from_numpy(ids).to(device), torch.from_numpy(answers).to(device)


def phase_step(device):
    """Phase 4: one Adam step through the kernels vs through the plain
    versions, from the same weights and batch, dropout 0."""
    import torch

    from bsarec_tpu_torch import parity
    from bsarec_tpu_torch.config import TrainConfig
    from bsarec_tpu_torch.ops import ce
    from bsarec_tpu_torch.train.loop import make_optimizer

    ids, answers = random_batch(device, seed=7)
    first = full_width_model(device, dropout=0.0, loss_impl="streaming")
    models = (first, copy.deepcopy(first))
    del first
    results = []
    for plain, model in zip((False, True), models):
        model.train()
        opt = make_optimizer(model.parameters(), TrainConfig(lr=LR))
        if plain:
            state = model(ids)[:, -1, :]
            loss = ce.streaming_softmax_ce_plain(state, model.item_table, answers).mean()
        else:
            loss = model.calculate_loss(ids, answers)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        opt.step()
        results.append((loss.detach(), grads, {k: v.clone() for k, v in model.state_dict().items()}))
        del opt
    del models, model
    (loss, grads, params), (want_loss, want_grads, want_params) = results
    torch.cuda.synchronize()
    loss_err = abs(float(loss) - float(want_loss))
    check(loss_err <= CE_TOL * max(1.0, abs(float(want_loss))), f"step: loss error {loss_err}")
    grad_err = max(parity.rel_err(grads[k], want_grads[k]) for k in grads
                   if not k.endswith("key.bias") and want_grads[k].abs().max() > 0)
    check(grad_err <= GRAD_TOL, f"step: gradient error {grad_err} > {GRAD_TOL}")
    param_err, key_bias = 0.0, 0.0
    for k, want in want_params.items():
        if k.endswith("attention_layer.key.bias"):
            # zero at init with an exactly-zero true gradient: Adam steps on
            # rounding noise on both sides, bounded by lr
            key_bias = max(key_bias, float(params[k].abs().max()), float(want.abs().max()))
            continue
        param_err = max(param_err, float((params[k] - want).abs().max()))
    check(param_err <= STEP_PARAM_TOL, f"step: parameter error {param_err} > {STEP_PARAM_TOL}")
    check(key_bias <= LR, f"step: key bias moved {key_bias} > lr")
    log(f"one Adam step, kernels vs plain (B={TRAIN_BATCH}, V={N_ITEMS}, H=64, dropout 0): ok, "
        f"loss {float(loss):.6f} vs {float(want_loss):.6f}, gradient rel err {grad_err:.3g}, "
        f"parameter max |diff| {param_err:.3g} (key biases, zero true gradient: |b| <= {key_bias:.3g})")
    del results, grads, want_grads, params, want_params
    torch.cuda.empty_cache()


def read_log(path):
    with open(path) as fh:
        return fh.read()


def phase_train(device, workdir):
    """Phase 6: `main` without --do_eval, then --resume. Returns (the
    launch counts of the first run, the second epoch's examples/s)."""
    import torch

    from bsarec_tpu_torch import main as port_main
    from bsarec_tpu_torch.ops import ce

    seqs = synth_corpus(TRAIN_USERS, N_ITEMS, seed=1)
    with open(os.path.join(workdir, "synth_train.txt"), "w") as fh:
        for u, seq in enumerate(seqs):
            fh.write(f"{u + 1} {' '.join(map(str, seq))}\n")
    n_samples = sum(len(s[-52:-2]) for s in seqs)
    steps = math.ceil(n_samples / TRAIN_BATCH)
    eval_steps = math.ceil(TRAIN_USERS / EVAL_BATCH)
    argv = ["--data_dir", workdir, "--data_name", "synth_train", "--output_dir", workdir,
            "--train_name", "smoke_train", "--device", device.type, "--lr", str(LR),
            "--batch_size", str(TRAIN_BATCH), *WIDTHS]

    def run(extra):
        reset_counts()
        t0 = time.perf_counter()
        scores = port_main.main(argv + extra)
        torch.cuda.synchronize(device)
        counts = read_counts()
        check(all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in scores), f"bad scores {scores}")
        return scores, counts | {"ce_logz_onchip": ce.ce_logz.onchip_launches,
                                 "ce_grads_onchip": ce.ce_grads.onchip_launches}, \
            time.perf_counter() - t0

    scores, counts, seconds = run(["--epochs", "2"])
    log(f"train path: main(--epochs 2) on {TRAIN_USERS} users x {N_ITEMS} items, {n_samples} "
        f"samples = {steps} steps per epoch, returned in {seconds:.1f}s, test scores {scores}; "
        f"launches {counts}")
    # one ce_logz call (loss and logZ) and one ce_grads call per step, each
    # on its on-chip route (B=256, H=64); the gold terms ride in them, so
    # the standalone gather never launches
    want = zero_counts() | {"ce_logz": 2 * steps, "ce_grads": 2 * steps,
                            "streaming_masked_topk": 3 * eval_steps, "ce_logz_onchip": 2 * steps,
                            "ce_grads_onchip": 2 * steps}
    check(counts == want, f"train path launches {counts}, want {want}")
    first_counts = counts
    text = read_log(os.path.join(workdir, "smoke_train.log"))
    losses = [float(x) for x in re.findall(r"'epoch': \d+, 'rec_loss': '([^']+)'", text)]
    check(len(losses) == 2 and all(math.isfinite(x) for x in losses) and losses[1] < losses[0],
          f"epoch losses {losses}: want two finite values, the second lower")
    rates = [float(x) for x in re.findall(r"epoch \d+: train (\d+) ex/s", text)]
    check(len(rates) == 2, f"epoch rate lines {rates}")
    for name in ("smoke_train.ckpt", "smoke_train.ckpt.state"):
        check(os.path.exists(os.path.join(workdir, name)), f"{name} missing")
    log(f"train path: epoch losses {losses}; train {rates[0]:.0f} then {rates[1]:.0f} examples/s; "
        f"checkpoint and .state snapshot written")

    topk_path = os.path.join(workdir, "train_topk.npy")
    scores, counts, seconds = run(["--epochs", "3", "--resume", "--export_topk", topk_path])
    text = read_log(os.path.join(workdir, "smoke_train.log"))
    check("resumed full train state" in text and "(epoch 1)" in text, "resume line missing")
    losses = [float(x) for x in re.findall(r"'epoch': \d+, 'rec_loss': '([^']+)'", text)]
    check(len(losses) == 3 and "'epoch': 2," in text and math.isfinite(losses[2]),
          f"resumed run: epoch losses {losses}")
    want = zero_counts() | {"ce_logz": steps, "ce_grads": steps,
                            "streaming_masked_topk": 3 * eval_steps, "ce_logz_onchip": steps,
                            "ce_grads_onchip": steps}
    check(counts == want, f"resumed launches {counts}, want {want}")
    topk = np.load(topk_path)
    check(topk.shape == (TRAIN_USERS, TOP_K) and 0 <= int(topk.min()) and int(topk.max()) < N_ITEMS,
          "export after fit")
    log(f"train path: main(--resume --epochs 3 --export_topk) started at epoch 2 and returned in "
        f"{seconds:.1f}s, epoch 2 loss {losses[2]}, test scores {scores}; launches {counts}")
    return first_counts, rates[1]


# ---- the serving path ----------------------------------------------------------

SCORER_BATCHES = (1, 16, 256)
HTTP_BATCHES = (1, 17, 256)
# sequential requests timed at each HTTP load batch, and calls timed at
# each scorer batch: enough that a p99 is not just the largest reading
HTTP_LOAD_REQUESTS = {1: 200, 256: 200}
SCORER_CALLS = 20
# the serving layouts timed, (impl, quant)
LAYOUTS = (("bitmask", None), ("dense", None), ("filtered", None), ("chunked", None),
           ("bitmask", "int8"))
# the share of the fp32 top-20 ids that the int8 artifact must keep, per
# row on average
INT8_MIN_OVERLAP = 0.5


def serving_fill_cases(device):
    """The serving op at the edge rows, integer inputs (exact scores, many
    ties) on both routes (B=9 on-chip, B=257 the older route): row 0 has
    seen every item, rows 1 and 2 all but 5, and every row holds ids
    outside [0, V). The ids and values must equal a host reference of
    JAX's serving contract: the seen ids (out-of-range ones dropped) and
    item 0 masked to -inf, then a stable top-k by (value desc, id asc),
    whose -inf tail is 0 and then the row's seen ids ascending."""
    import torch

    from bsarec_tpu_torch.ops import rank, serving_topk

    v, h, k, extra = 4099, 64, TOP_K, 8
    for b in (9, 257):
        rng = np.random.default_rng(b)
        states = rng.integers(-3, 4, size=(b, h)).astype(np.float32)
        table = rng.integers(-3, 4, size=(v, h)).astype(np.float32)
        seen = np.zeros((b, extra + v), np.int32)
        seen[:, :extra] = rng.integers(-2, v + 3, size=(b, extra))
        for r in (0, 1, 2):
            seen[r, :extra] = [-2, -1, v, v + 1, v + 2, 1 << 30, 0, 0]
            seen[r, extra:] = np.arange(v)
            if r:
                seen[r, extra + 100 * r:extra + 100 * r + 5] = 0
        logits = states @ table.T  # integer sums below 2^24: exact
        ok = (seen >= 0) & (seen < v)
        mask = np.zeros((b, v), bool)
        mask[np.nonzero(ok)[0], seen[ok]] = True
        mask[:, 0] = True
        masked = np.where(mask, -np.inf, logits)
        want_i = np.argsort(-masked, axis=1, kind="stable")[:, :k]
        want_v = np.take_along_axis(masked, want_i, 1)
        before = (rank.streaming_masked_topk.launches, rank.streaming_masked_topk.onchip_launches)
        got_v, got_i = serving_topk.serving_masked_topk(
            torch.from_numpy(states).to(device), torch.from_numpy(table).to(device),
            torch.from_numpy(seen).to(device), k)
        torch.cuda.synchronize()
        onchip = rank.onchip_route(b, h, k)
        check((rank.streaming_masked_topk.launches, rank.streaming_masked_topk.onchip_launches)
              == (before[0] + 1, before[1] + onchip), f"serving op B={b}: launches")
        check(np.array_equal(got_i.cpu().numpy(), want_i)
              and np.array_equal(got_v.cpu().numpy(), want_v.astype(np.float32)),
              f"serving op B={b}: ids or values differ from the serving contract's")
        check(got_i[0].tolist() == list(range(k)) and got_i[1, 5:].tolist() == list(range(k - 5)),
              f"serving op B={b}: the -inf fill of the all-seen and 5-unseen rows")
        log(f"serving op vs host reference (B={b} V={v} k={k}, integer inputs, an all-seen row, "
            f"rows with 5 unseen items, out-of-range seen ids): bit-equal ids and values, "
            f"JAX's -inf fill; {'on-chip' if onchip else 'older'} route")


def http_session(scorer, seqs, card):
    """Serve the scorer over HTTP from a thread; /healthz, /rank at the
    HTTP_BATCHES with ragged histories (each equal to a direct scorer
    call, no history item or id 0 served), a malformed body and an
    out-of-range id (400, then the server still answers), then
    sequential requests/s and latency at b = 1 and 256."""
    import http.client
    import threading

    from bsarec_tpu_torch import serve

    server = serve.make_server(scorer, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=300)

    def post(body):
        conn.request("POST", "/rank", body, {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())

    def health():
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())

    try:
        status, body = health()
        check(status == 200 and body == {"ok": True, "max_len": scorer.max_len,
                                         "seen_width": scorer.seen_width}, f"/healthz {body}")
        for b in HTTP_BATCHES:
            hists = [s[:-1] for s in seqs[:b]]
            status, body = post(json.dumps({"input_ids": hists}))
            check(status == 200, f"/rank b={b}: status {status} {body}")
            ids, seen, _ = serve.pad_requests(hists, scorer.max_len, scorer.seen_width)
            got = np.asarray(body["topk"])
            check(np.array_equal(got, scorer.topk(ids, None, seen)),
                  f"/rank b={b} differs from a direct scorer call")
            check(all(not set(row) & (set(h) | {0}) for row, h in zip(got.tolist(), hists)),
                  f"/rank b={b} served a history item or id 0")
        for bad in ("{bad json", json.dumps({"input_ids": [[5, N_ITEMS]]})):
            status, body = post(bad)
            check(status == 400 and "error" in body, f"/rank {bad[:40]!r}: {status} {body}")
        check(health()[0] == 200, "/healthz after the refused requests")
        log("serving HTTP: /healthz, /rank at b = " + ", ".join(map(str, HTTP_BATCHES))
            + " equal to direct scorer calls with no history item served; a malformed body "
            "and an out-of-range id answered 400")
        for b, n in HTTP_LOAD_REQUESTS.items():
            body = json.dumps({"input_ids": [s[:-1] for s in seqs[:b]]})
            post(body)
            lat = []
            t0 = time.perf_counter()
            for _ in range(n):
                t1 = time.perf_counter()
                check(post(body)[0] == 200, "/rank under load")
                lat.append(1e3 * (time.perf_counter() - t1))
            wall = time.perf_counter() - t0
            log(f"serving HTTP b={b}: {n} sequential requests on one connection, "
                f"{n / wall:.1f} requests/s ({b * n / wall:.1f} users/s), "
                f"p50 {np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} ms, "
                f"max {max(lat):.3f} ms of {n} [{card}]")
    finally:
        conn.close()
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    check(not thread.is_alive(), "the HTTP server thread did not stop")


def phase_serving(device, workdir, card):
    """The serving path, in phase 7's directory: `main --do_eval
    --load_model <phase 7's BSARec> --export_serving` at full width on
    the card, `load_scorer(..., "cuda")`, one artifact call at B=256 (the
    rank kernel launches once, on its on-chip route), then the HTTP host.
    The launch counts are read over that run. Then, outside it: the
    artifact against the serving-mode plain version, the four layouts and
    int8 against it, the op at the edge rows, and the timings. Returns
    the JSON fields for the rank kernel."""
    import torch

    from bsarec_tpu_torch import main as port_main
    from bsarec_tpu_torch import serving
    from bsarec_tpu_torch.config import ModelConfig
    from bsarec_tpu_torch.data.corpus import Corpus
    from bsarec_tpu_torch.data.pipeline import SeqRecData
    from bsarec_tpu_torch.models import build_model
    from bsarec_tpu_torch.ops import rank, serving_topk
    from bsarec_tpu_torch.train.checkpoint import load_params

    path = os.path.join(workdir, "scorer.pt2")
    argv = ["--data_dir", workdir, "--data_name", "synth_train", "--output_dir", workdir,
            "--train_name", "smoke_serving", "--do_eval", "--load_model", "smoke_train",
            "--export_serving", path, "--device", device.type, *WIDTHS]
    seqs = synth_corpus(TRAIN_USERS, N_ITEMS, seed=1)  # phase 7's corpus
    test = SeqRecData(Corpus(user_seq=seqs, max_item=N_ITEMS - 1), max_len=50).test
    ids, seen = test.input_ids[:EVAL_BATCH], test.seen_items[:EVAL_BATCH]

    reset_counts()
    t0 = time.perf_counter()
    port_main.main(argv)
    main_seconds = time.perf_counter() - t0
    found = re.findall(r"exported serving scorer: (\{.*\})", read_log(
        os.path.join(workdir, "smoke_serving.log")))
    check(len(found) == 1, "export log line")
    meta = ast.literal_eval(found[0])
    check(meta["impl"] == "bitmask" and meta["device"] == "cuda" and meta["item_size"] == N_ITEMS
          and meta["bytes"] == os.path.getsize(path), f"export metadata {meta}")
    t0 = time.perf_counter()
    scorer = serving.load_scorer(path, "cuda")
    load_seconds = time.perf_counter() - t0
    before = (rank.streaming_masked_topk.launches, rank.streaming_masked_topk.onchip_launches)
    got = scorer.topk(ids, None, seen)
    check((rank.streaming_masked_topk.launches, rank.streaming_masked_topk.onchip_launches)
          == (before[0] + 1, before[1] + 1),
          "the artifact call at B=256 must launch the rank kernel once, on its on-chip route")
    http_session(scorer, seqs, card)
    counts = read_counts()
    launches, onchip = counts["streaming_masked_topk"], rank.streaming_masked_topk.onchip_launches
    eval_steps = math.ceil(TRAIN_USERS / EVAL_BATCH)
    check(counts == zero_counts() | {"streaming_masked_topk": launches}
          and launches > eval_steps and onchip == launches,
          f"serving path launches {counts}, {onchip} on-chip: want only rank launches, more than "
          f"the test pass's {eval_steps}, all on-chip")
    log(f"serving path: main(--do_eval --export_serving) returned in {main_seconds:.1f}s, export "
        f"{meta['seconds']:.3f}s, artifact {meta['bytes']} bytes, load {load_seconds:.3f}s; "
        f"{launches} rank launches ({eval_steps} of the test pass, the rest in artifact calls), "
        f"{onchip} on the on-chip route [{card}]")

    # the artifact against the serving-mode plain version on the card
    cfg = ModelConfig(model_type="bsarec", item_size=N_ITEMS, num_users=TRAIN_USERS + 1,
                      max_seq_length=50, hidden_size=64, num_hidden_layers=2,
                      num_attention_heads=1, c=5, alpha=0.7)
    model = build_model(cfg)
    model.load_state_dict(load_params(os.path.join(workdir, "smoke_train.ckpt")))
    model.to(device).eval()
    seen_dev = torch.from_numpy(seen).to(device)
    with torch.inference_mode():
        states = model.predict(torch.from_numpy(ids).long().to(device))[:, -1, :].contiguous()
        table = model.item_table
        bitmask = serving_topk.seen_bitmask(seen_dev, N_ITEMS)
        want_v, _ = rank.streaming_masked_topk_plain(states, table, bitmask, TOP_K, N_ITEMS,
                                                     seen_value=-math.inf)

        def score_of(topk):
            return masked_scores(states, table, bitmask, N_ITEMS,
                                 torch.from_numpy(topk).to(device), -math.inf)

        check(bool(torch.isfinite(want_v).all()), "every row has 20 unmasked items")
        err = float((score_of(got) - want_v).abs().max())
        check(err <= FLOAT_TOL, f"artifact top-20 at B=256: score error {err} > {FLOAT_TOL}")
        check(all(len(set(r)) == TOP_K for r in got.tolist()), "artifact row repeats an id")
        log(f"serving artifact vs plain serving version at B={EVAL_BATCH}: ids scored by the plain "
            f"version within {err:.3g} of its top-20 values")

        serving_fill_cases(device)
        bm_ms = cuda_ms(lambda: rank.streaming_masked_topk(
            states, table, bitmask, TOP_K, N_ITEMS, -math.inf), iters=20)
        eval_ms = cuda_ms(lambda: rank.streaming_masked_topk(
            states, table, bitmask, TOP_K, N_ITEMS), iters=20)
    log(f"time streaming_masked_topk serving mode: {bm_ms:.4f} ms per {EVAL_BATCH}-user batch, "
        f"eval mode on the same inputs {eval_ms:.4f} ms [{card}]")

    # the layouts: each exported as main would, loaded, held against bitmask
    # and timed per call (host clock around Scorer.topk, inputs from and
    # ids back to the host)
    scorers = {("bitmask", None): scorer}
    for impl, quant in LAYOUTS:
        key = (impl, quant)
        if key not in scorers:
            lpath = os.path.join(workdir, f"scorer_{impl}_{quant}.pt2")
            lmeta = serving.export_scorer(model, N_ITEMS, 50, seen.shape[1], lpath, quant=quant,
                                          impl=impl)
            scorers[key] = serving.load_scorer(lpath, "cuda")
            log(f"serving export {impl}{' int8' if quant else ''}: {lmeta['seconds']:.3f}s, "
                f"{lmeta['bytes']} bytes")
        sc = scorers[key]
        out = sc.topk(ids, None, seen)
        if quant is None and impl != "bitmask":
            diff = out != got
            with torch.inference_mode():
                d_err = float((score_of(out) - score_of(got)).abs().max())
            check(d_err <= FLOAT_TOL, f"layout {impl}: ids score {d_err} off bitmask's")
            log(f"serving layout {impl} vs bitmask at B={EVAL_BATCH}: {int(diff.sum())} of "
                f"{diff.size} ids differ, scores within {d_err:.3g}")
        elif quant:
            overlap = float(np.mean([len(set(a) & set(b)) / TOP_K
                                     for a, b in zip(out.tolist(), got.tolist())]))
            top1 = float((out[:, 0] == got[:, 0]).mean())
            check(overlap >= INT8_MIN_OVERLAP, f"int8 keeps {overlap:.3f} of the fp32 top-20")
            log(f"serving int8 vs fp32 at B={EVAL_BATCH}: {overlap:.4f} of each row's top-20 "
                f"kept on average, top-1 equal in {top1:.4f} of rows")
        for b in SCORER_BATCHES:
            sc.topk(ids[:b], None, seen[:b])
            times = []
            for _ in range(SCORER_CALLS):
                t0 = time.perf_counter()
                sc.topk(ids[:b], None, seen[:b])
                times.append(1e3 * (time.perf_counter() - t0))
            name = impl + (" int8" if quant else "")
            log(f"serving scorer {name} b={b}: median {np.median(times):.3f} ms per call, "
                f"min {min(times):.3f}, {SCORER_CALLS} calls [{card}]")
        if key != ("bitmask", None):
            del scorers[key]
    del scorer, scorers, model
    torch.cuda.empty_cache()
    return {"serving_launches": launches, "serving_onchip_launches": onchip, "serving_ms": bm_ms}


def in_turns(first, second, measure):
    """measure(first), measure(second), measure(second), measure(first):
    two readings of each, taken in turns inside one call."""
    a1 = measure(first)
    b1, b2 = measure(second), measure(second)
    return (a1, measure(first)), (b1, b2)


def graph_ms(fn, calls: int, replays: int = 10) -> float:
    """The card's ms per call of fn: CUDA events around replays of a CUDA
    graph that holds `calls` calls, so the host's dispatch is left out."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):  # the wrappers launch on the capturing stream
        for _ in range(calls):
            fn()
    ms = cuda_ms(graph.replay, iters=replays) / calls
    del graph
    return ms


def host_ms(fn, iters: int, warmup: int = 2) -> float:
    """Host ms per call to issue fn: perf_counter around `iters` calls with
    no sync inside (the card drains its queue afterwards)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    return ms


def profiled_ops(fn, tries: int = 3) -> int:
    """Device operations (kernels, memsets, copies) that one call of fn
    issues, counted by torch.profiler: the most any of `tries` traced
    calls shows, since a trace now and then loses a record but never adds
    one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in device_kernels(prof)))
    return max(counts)


def pair(readings) -> str:
    return "/".join(f"{t:.5f}" for t in readings)


GOLD_ROWS_WENT = ("folded into the main path's other two CE calls: ce_logz's merge pass takes "
                  "the gold logit <s, T[a]>, ce_grads' ds-reduce pass takes -dloss * T[a]")


def bf16_yardsticks(states, table, answers):
    """Library yardsticks for the bf16 forms: F.cross_entropy forward, and
    backward through it, over a bf16 product with an fp32 output where this
    PyTorch has one, else over the bf16-output product (its logits rounded
    to bf16), the operands cast to bf16 once outside the timing. Returns
    ((forward, its name), (backward, its name))."""
    import torch
    import torch.nn.functional as F

    s16, t16 = states.to(torch.bfloat16), table.to(torch.bfloat16)
    s_req = s16.clone().requires_grad_()
    t_req = t16.clone().requires_grad_()
    forms = ((lambda x, y: torch.mm(x, y.T, out_dtype=torch.float32),
              "torch.mm(bf16, bf16, out_dtype=float32)"),
             (lambda x, y: (x @ y.T).float(), "bf16 @ bf16 (its logits rounded to bf16)"))
    chosen = {}
    for which in ("forward", "backward"):
        for product, product_name in forms:
            try:
                graph = F.cross_entropy(product(s_req, t_req), answers)
                if which == "backward":
                    torch.autograd.grad(graph, (s_req, t_req), retain_graph=True)
                chosen[which] = (product, product_name, graph)
                break
            except (TypeError, RuntimeError, NotImplementedError):
                continue
    product, fwd_name, _ = chosen["forward"]
    _, back_name, graph = chosen["backward"]
    return ((lambda: F.cross_entropy(product(s16, t16), answers),
             f"F.cross_entropy forward over {fwd_name}"),
            (lambda: torch.autograd.grad(graph, (s_req, t_req), retain_graph=True),
             f"F.cross_entropy backward over {back_name}"))


def step_ce_check(states, table, answers, dloss, card, dtype=None):
    """The CE of a training step in the form `dtype` names, as the model
    calls it: streaming_softmax_ce forward and backward on the last
    position of a [B, L, H] state (a strided view, so the wrapper makes it
    contiguous). Checks that it makes 2 wrapper calls (one ce_logz, one
    ce_grads launch) and issues at most 5 device operations (the copy and
    each kernel's two passes), but for the bf16 form on the wide route,
    whose C entries each add their states scratch (states_bf16_kernel):
    there the count is printed, not held."""
    import torch

    from bsarec_tpu_torch.ops import ce

    b, h = states.shape
    seq = torch.zeros((b, 2, h), device=states.device)
    seq[:, 1] = states
    state = seq[:, -1, :]
    t_req = table.clone().requires_grad_()

    def autograd_form():
        loss = ce.streaming_softmax_ce(state, t_req, answers, dtype=dtype)
        torch.autograd.grad(loss, t_req, dloss)

    before = sum(f.launches for f in (ce.ce_logz, ce.gold_rows, ce.ce_grads))
    autograd_form()
    calls = sum(f.launches for f in (ce.ce_logz, ce.gold_rows, ce.ce_grads)) - before
    step_ops = profiled_ops(autograd_form)
    form = f"{dtype or 'float32'} form"
    scratch = dtype is not None and ce.wide_route(h)
    if scratch:
        form += " on the wide route (a states scratch kernel each way, not held to 5)"
    check(calls == 2 and (scratch or step_ops <= 5),
          f"the training step's CE ({form}) made {calls} wrapper calls and {step_ops} device "
          f"operations")
    log(f"CE of a training step, {form} (streaming_softmax_ce forward and backward on the "
        f"model's [B, L, H][:, -1] state): {calls} wrapper calls, {step_ops} device operations "
        f"(torch.profiler) [{card}]")
    del t_req, seq, state
    torch.cuda.empty_cache()


def phase_ce_times(full, card, dtype=None, extras=True):
    """The CE kernels at the training shape, in the form `dtype` names.
    Each main-path entry's time, its plain version's, a library
    yardstick's and its bound: in the fp32 form against fp32 products at
    67 TFLOP/s (on the wide and middle routes, H > 64 at B <= 256, three
    TF32 passes at 495 TFLOP/s: their kernels take every product in
    3xTF32; the fp32 FMA figure on the `bound` log line only), and in the
    bf16-operand form in turns
    with the fp32 form
    (fp32, bf16, bf16, fp32), against `bf16_yardsticks` and the bf16
    tensor rate, 989 TFLOP/s. The fp32 form also times the standalone
    gather against `index_select`, back to back and in a CUDA graph, in
    turns, and one CE forward plus backward through the fused entries
    against the unfused composition of the public wrappers (the gather
    and elementwise ops around ce_logz and ce_grads), in turns: host ms to
    issue it, device ms in a CUDA graph and the device operations it
    issues. In both forms it ends with `step_ce_check`. Without `extras`
    (the fp32 form on the middle route) only the entries' times. Returns
    {kernel: JSON fields}."""
    import torch
    import torch.nn.functional as F

    from bsarec_tpu_torch.ops import ce

    states, table, answers = full
    b, h = states.shape
    v = table.shape[0]
    dev = states.device
    a = ce.map_answers(answers, v)
    bf16 = dtype is not None
    _, logz = ce.ce_loss_logz(states, table, answers, v, dtype=dtype)
    d = torch.full((b,), 1.0 / b, device=dev)
    flops = 2 * b * v * h
    out = {}
    if bf16:
        (fwd_library, fwd_name), (back_library, back_name) = bf16_yardsticks(states, table, answers)
        peak, rate, form = PEAK_BF16_FLOPS, "at the bf16 tensor rate 989 TFLOP/s", " bf16 form"
    else:
        s_req = states.clone().requires_grad_()
        t_req = table.clone().requires_grad_()
        lib_loss = F.cross_entropy(s_req @ t_req.T, answers)  # the yardstick's graph, 1 GB logits
        fwd_library = lambda: F.cross_entropy(states @ table.T, answers)
        fwd_name = "F.cross_entropy(states @ table.T) forward"
        back_library = lambda: torch.autograd.grad(lib_loss, (s_req, t_req), retain_graph=True)
        back_name = "backward of F.cross_entropy(states @ table.T)"
        peak, rate, form = PEAK_FP32_FLOPS, "fp32 at 67 TFLOP/s", ""

    # the two main-path entries, as the training step calls them
    pieces = {
        "ce_logz": (lambda dt: ce.ce_loss_logz(states, table, answers, v, dtype=dt),
                    lambda: ce.ce_loss_logz_plain(states, table, answers, v, bf16=bf16),
                    fwd_library, fwd_name, flops + 2 * b * h, 4 * (2 * b * h + v * h + 2 * b) + 8 * b),
        "ce_grads": (lambda dt: ce.ce_grads(states, table, answers, logz, d, v, dtype=dt),
                     lambda: ce.ce_grads_plain(states, table, answers, logz, d, v, bf16=bf16),
                     back_library, back_name, 3 * flops, 4 * (2 * b * h + 2 * v * h + 2 * b) + 8 * b),
    }
    for name, (kernel, plain, library, lib_name, ops, nbytes) in pieces.items():
        fields = {}
        if bf16:
            ((f1, f2), (k1, k2)) = in_turns(None, dtype, lambda dt: cuda_ms(lambda: kernel(dt), iters=20))
            ms = (k1 + k2) / 2
            fields["fp32_form_ms"] = (f1 + f2) / 2
            # on the middle route the fp32 form runs the wgmma forward and
            # the wide 3xTF32 backward
            sweep = ""
            if ce.mid_route(b, h):
                kernel32 = "ce_fwd_mid_tf32_kernel" if name == "ce_logz" else "ce_bwd_wide_tf32_kernel"
                sweep = f" ({kernel32})"
            log(f"time {name} bf16 form: {pair((k1, k2))} ms, fp32 form{sweep} {pair((f1, f2))} ms "
                f"(B={b} V={v} H={h}; turns fp32, bf16, bf16, fp32) [{card}]")
        else:
            ms = cuda_ms(lambda: kernel(None), iters=20)
            log(f"time {name} kernel: {ms:.4f} ms (B={b} V={v} H={h}, gold terms fused) [{card}]")
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        library_ms = cuda_ms(library, iters=5)
        t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        basis, fma = f"{ops / 1e9:.2f} GFLOP {rate}", ""
        if not bf16 and (ce.wide_route(h) or ce.mid_route(b, h)):
            # the wide and middle fp32 kernels take 3xTF32 on the tensor cores: three
            # passes of the work at the TF32 rate; the same work in fp32
            # FMAs, for comparison
            t_fma, t_ops = t_ops, 3 * ops / PEAK_TF32_FLOPS * 1e3
            basis = f"3 x {ops / 1e9:.2f} GFLOP in 3xTF32 at the TF32 tensor rate 495 TFLOP/s"
            fma = (f"; in fp32 FMAs at 67 TFLOP/s the work takes {t_fma:.4f} ms, the kernel at "
                   f"{100 * t_fma / ms:.1f}% of that")
        bound_ms = max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        log(f"time {name}{form} plain version: {plain_ms:.4f} ms [{card}]")
        log(f"time {name}{form} library {lib_name}: {library_ms:.4f} ms [{card}]")
        log(f"bound {name}{form}: {bound_ms:.4f} ms ({bound_by}: {basis} "
            f"= {t_ops:.4f} ms; {nbytes / 1e6:.3f} MB at 3.35 TB/s = {t_bytes:.4f} ms) -> kernel at "
            f"{100 * bound_ms / ms:.1f}% of the bound{fma} [{card}]")
        out[name] = {"ms": ms, **fields, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms, "library": lib_name}
    del pieces, fwd_library, back_library
    if bf16:
        step_ce_check(states, table, answers, d, card, dtype)
        return out
    if not extras:
        return out

    # the gather alone against one PyTorch call
    back = lambda fn: cuda_ms(fn, iters=200, warmup=5)
    ((k1, k2), (l1, l2)) = in_turns(lambda: ce.gold_rows(table, a),
                                    lambda: table.index_select(0, answers), back)
    ((g1, g2), (i1, i2)) = in_turns(lambda: ce.gold_rows(table, a),
                                    lambda: table.index_select(0, answers),
                                    lambda fn: graph_ms(fn, calls=50, replays=20))
    plain_ms = cuda_ms(lambda: ce.gold_rows_plain(table, a), iters=20, warmup=1)
    nbytes = 4 * (2 * b * h + b)
    bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"time gold_rows kernel: {pair((k1, k2))} ms back to back, {pair((g1, g2))} ms per call in a "
        f"CUDA graph of 50 (B={b} V={v} H={h}; turns kernel, index_select, index_select, kernel) [{card}]")
    log(f"time gold_rows library table.index_select: {pair((l1, l2))} ms back to back, "
        f"{pair((i1, i2))} ms per call in a CUDA graph of 50 [{card}]")
    log(f"time gold_rows plain version: {plain_ms:.4f} ms [{card}]")
    log(f"bound gold_rows: {bound_ms:.7f} ms (bytes: {nbytes / 1e6:.3f} MB at 3.35 TB/s); main path: "
        f"0 launches, {GOLD_ROWS_WENT} [{card}]")
    out["gold_rows"] = {"ms": (k1 + k2) / 2, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": "bytes", "library_ms": (l1 + l2) / 2,
                        "main_path": GOLD_ROWS_WENT}

    del lib_loss, s_req

    # one forward plus backward: fused entries vs the unfused composition,
    # on the model's form of the state (the last position of [B, L, H])
    seq = torch.zeros((b, 2, h), device=dev)
    seq[:, 1] = states
    state = seq[:, -1, :]

    def fused():
        s = state.contiguous()
        _, z = ce.ce_loss_logz(s, table, answers, v)
        ce.ce_grads(s, table, answers, z, d, v)

    no_answers = torch.full_like(answers, -1)

    def unfused():
        s = state.contiguous()
        m = ce.map_answers(answers, v)
        z = ce.ce_logz(s, table, v)
        _ = z - (ce.gold_rows(table, m) * s).sum(dim=1)
        ds, _ = ce.ce_grads(s, table, no_answers, z, d, v)
        _ = ds - d[:, None] * ce.gold_rows(table, m)

    ((f1, f2), (u1, u2)) = in_turns(fused, unfused, lambda fn: host_ms(fn, iters=10))
    ((fg1, fg2), (ug1, ug2)) = in_turns(fused, unfused, lambda fn: graph_ms(fn, calls=5, replays=4))
    fused_ops, unfused_ops = profiled_ops(fused), profiled_ops(unfused)
    log(f"CE forward+backward, fused entries: host {pair((f1, f2))} ms to issue, card {pair((fg1, fg2))} "
        f"ms per call in a CUDA graph, {fused_ops} device operations, 2 wrapper calls (B={b} V={v} "
        f"H={h}; turns fused, unfused, unfused, fused) [{card}]")
    log(f"CE forward+backward, unfused composition (ce_logz + gold_rows + elementwise, ce_grads "
        f"on answers of -1 + gold_rows + elementwise): host {pair((u1, u2))} ms to issue, card "
        f"{pair((ug1, ug2))} ms per call in a CUDA graph, {unfused_ops} device operations, 4 wrapper "
        f"calls [{card}]")

    del t_req, seq, state
    step_ce_check(states, table, answers, d, card)
    return out


def phase_train_breakdown(device, card, n_steps: int = 30):
    """Where a training step's time goes at full width and 1M items, on a
    fresh model: CUDA events between the step's pieces, then a window of
    steps under torch.profiler for the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bsarec_tpu_torch.config import TrainConfig
    from bsarec_tpu_torch.ops.losses import full_softmax_ce
    from bsarec_tpu_torch.train.loop import make_optimizer

    model = full_width_model(device, dropout=0.5)
    model.train()
    opt = make_optimizer(model.parameters(), TrainConfig(lr=LR))
    batches = [random_batch(device, seed=1000 + i) for i in range(n_steps)]
    names = ("model forward", "CE forward", "backward", "Adam")
    totals = dict.fromkeys(names, 0.0)

    def step(ids, answers, events=None):
        if events:
            events[0].record()
        state = model(ids)[:, -1, :]
        if events:
            events[1].record()
        loss = full_softmax_ce(state, model.item_table, answers, impl="streaming")
        if events:
            events[2].record()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if events:
            events[3].record()
        opt.step()
        if events:
            events[4].record()

    for ids, answers in batches[:3]:  # warm-up: Adam's state, the allocator
        step(ids, answers)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step(*batches[0])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "called a synchronizing CUDA operation" in str(w.message)]
    log(f"train step host syncs: {len(syncs)} found by torch.cuda.set_sync_debug_mode('warn') "
        f"(which does not see every kind of sync)")
    torch.cuda.synchronize()
    all_events = []
    t0 = time.perf_counter()
    for ids, answers in batches:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        step(ids, answers, events)
        all_events.append(events)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_steps
    for events in all_events:
        for i, name in enumerate(names):
            totals[name] += events[i].elapsed_time(events[i + 1]) / n_steps
    for name in names:
        log(f"train breakdown {name}: {totals[name]:.4f} ms per step on the card's timeline [{card}]")
    log(f"train step: {1e3 * wall:.4f} ms per {TRAIN_BATCH}-sample step on the host clock = "
        f"{TRAIN_BATCH / wall:.1f} examples/s (fresh model, random batches) [{card}]")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for ids, answers in batches[:10]:
            step(ids, answers)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    on_device = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in on_device) / 1e6
    if busy > 0:
        log(f"train trace: device busy {busy:.4f}s of a {traced:.4f}s traced window of 10 steps, "
            f"idle share {100 * (1 - busy / traced):.1f}% (torch.profiler) [{card}]")
        for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]:
            log(f"train trace device time {e.key[:90]}: {e.self_device_time_total / 1e3 / 10:.4f} "
                f"ms per step, {e.count} calls [{card}]")
    else:
        log("train trace: torch.profiler recorded no device time; device busy share not measured")
    del model, opt, batches
    torch.cuda.empty_cache()


# ---- the fused dropout kernel and SASRec ---------------------------------------


def kernel_wrappers():
    """{name: wrapper} of every kernel of the port, each with a `launches` count."""
    from bsarec_tpu_torch.ops import ce, rank
    from bsarec_tpu_torch.ops import dropout as fd

    return {f.__name__: f for f in (rank.streaming_masked_topk, ce.ce_logz, ce.gold_rows,
                                    ce.ce_grads, fd.fused_dropout)}


def reset_counts() -> None:
    from bsarec_tpu_torch.ops import ce, rank
    from bsarec_tpu_torch.ops import dropout as fd

    for f in kernel_wrappers().values():
        f.launches = 0
    for f in (rank.streaming_masked_topk, ce.ce_logz, ce.ce_grads):
        f.onchip_launches = 0
        f.wide_launches = 0
    for f in (ce.ce_logz, ce.ce_grads):
        f.mid_launches = 0
        f.mid_tf32_launches = 0
    rank.streaming_masked_topk.tc_launches = 0
    for f in (ce.ce_logz, ce.ce_grads, fd.fused_dropout):
        f.bf16_launches = 0


def read_counts() -> dict:
    return {name: f.launches for name, f in kernel_wrappers().items()}


def zero_counts() -> dict:
    return dict.fromkeys(kernel_wrappers(), 0)


@contextlib.contextmanager
def pallas_dropout_env(on: bool = True):
    """BSAREC_DROPOUT=pallas (on) or unset (off) while models are built:
    the model reads it when it is built."""
    old = os.environ.pop("BSAREC_DROPOUT", None)
    if on:
        os.environ["BSAREC_DROPOUT"] = "pallas"
    try:
        yield
    finally:
        os.environ.pop("BSAREC_DROPOUT", None)
        if old is not None:
            os.environ["BSAREC_DROPOUT"] = old


def dropout_seeds(device, seed):
    """Two seed words in [0, 2^32) as the int64 [2] tensor the kernel reads."""
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 1 << 32, size=2, dtype=np.int64)).to(device)


def compare_dropout(case_name, x, seeds, rate, call) -> float:
    """The kernel's pass vs the plain version's: bit-equal values. Returns
    the largest absolute difference (0.0 when the check passes)."""
    import torch

    from bsarec_tpu_torch.ops import dropout as fd

    got = fd.dropout_apply(x, seeds, rate, call)
    torch.cuda.synchronize()
    want = fd.fused_dropout_plain(x, seeds, rate, call)
    check(got.dtype == x.dtype and got.shape == x.shape, f"dropout {case_name}: dtype/shape")
    check(torch.equal(got, want), f"dropout {case_name}: kernel and plain version differ "
          f"at {int((got != want).sum())} of {x.numel()} elements")
    return float((got.float() - want.float()).abs().max())


def phase_dropout_kernels(device):
    """The fused dropout kernel against its plain version, bit for bit, at
    the SASRec sites' shapes and at edge shapes; then the checks of
    `benchmarks/validate_pallas_dropout.py` and the forward/backward mask
    identity through the autograd function. Returns the largest absolute
    difference over the compared cases."""
    import torch

    from bsarec_tpu_torch.ops import dropout as fd

    seeds = dropout_seeds(device, 0)
    errs = []
    for shape in DROPOUT_SHAPES.values():
        for dtype in (torch.float32, torch.bfloat16):
            for rate in (0.5, 0.2):
                x = torch.randn(shape, device=device).to(dtype)
                errs.append(compare_dropout(f"{list(shape)} {dtype} rate {rate}", x, seeds, rate, 3))
    for n in (1, 3, 4, 4097, 1_000_003):
        for dtype in (torch.float32, torch.bfloat16):
            for rate in (0.0, 0.2, 0.5, 0.9):
                for offset in (0, 1):  # 1: a view off the vector alignment
                    flat = torch.randn(n + offset, device=device).to(dtype)
                    errs.append(compare_dropout(f"n={n} {dtype} rate {rate} offset {offset}",
                                                flat[offset:], seeds, rate, n))
    log(f"dropout kernel vs plain: bit-equal in {len(errs)} cases (the sites' shapes "
        f"{[list(s) for s in DROPOUT_SHAPES.values()]} in fp32 and bf16 at rates 0.5 and 0.2; "
        f"n in (1, 3, 4, 4097, 1000003) x fp32/bf16 x rates (0, 0.2, 0.5, 0.9) x aligned and "
        f"misaligned views)")

    x = torch.ones(4, device=device)
    before = fd.fused_dropout.launches
    check(fd.fused_dropout(x, 0.0, seeds, 0) is x and not fd.fused_dropout(x, 1.0, seeds, 0).any()
          and fd.fused_dropout.launches == before, "rates 0 and 1 must not launch")

    for rate, shape in ((0.5, DROPOUT_SHAPES["hidden"]), (0.2, DROPOUT_SHAPES["attention"])):
        ones = torch.ones(shape, device=device)
        y = fd.dropout_apply(ones, seeds, rate, 0)
        kept = y != 0
        keep_frac = float(kept.float().mean())
        scale = fd.inv_keep(rate, torch.float32)
        check(abs(keep_frac - (1 - rate)) < 0.01, f"keep fraction {keep_frac} at rate {rate}")
        check(bool((y[kept] == scale).all()), f"kept values must be {scale}")
        check(torch.equal(y, fd.dropout_apply(ones, seeds, rate, 0)), "not deterministic")
        check(not torch.equal(y, fd.dropout_apply(ones, seeds + 1, rate, 0)), "seed-insensitive")
        check(not torch.equal(y, fd.dropout_apply(ones, seeds, rate, 1)), "call-insensitive")
        flat = kept.reshape(-1)
        chunks = flat[: flat.numel() // 65536 * 65536].view(-1, 65536).float().mean(dim=1)
        lo, hi = float(chunks.min()), float(chunks.max())
        check(abs(lo - (1 - rate)) < 0.05 and abs(hi - (1 - rate)) < 0.05,
              f"64K-chunk keep fractions {lo}..{hi} at rate {rate}")
        xg = ones.clone().requires_grad_()
        out = fd.fused_dropout(xg, rate, seeds, 0)
        out.sum().backward()
        torch.cuda.synchronize()
        check(torch.equal(out.detach(), y), "the autograd function's forward differs from the pass")
        check(torch.equal(xg.grad != 0, kept) and bool((xg.grad[kept] == scale).all()),
              "backward mask differs from the forward mask")
        log(f"dropout statistics at rate {rate}, {list(shape)}: keep fraction {keep_frac:.4f}, "
            f"kept values {scale}, deterministic, seed- and call-sensitive, 64K-chunk keep "
            f"{lo:.4f}..{hi:.4f}, forward/backward masks identical")
    return max(errs)


def sasrec_model(device, fused: bool):
    """A seeded random-init SASRec at the CLI defaults (hidden 64, 2 layers,
    2 heads, dropout 0.5/0.5, max_len 50) over 1M items."""
    import torch

    from bsarec_tpu_torch.config import ModelConfig
    from bsarec_tpu_torch.models import build_model

    cfg = ModelConfig(model_type="sasrec", item_size=N_ITEMS, num_users=TRAIN_USERS + 1)
    with pallas_dropout_env(fused):
        model = build_model(cfg, generator=torch.Generator().manual_seed(0),
                            prng="rbg" if fused else "threefry")
    check(model.dropout_state.fused == fused, "dropout path not as asked")
    return model.to(device)


def sasrec_batch(device, seed):
    """A random batch, its negatives and the step's dropout seeds."""
    import torch

    from bsarec_tpu_torch.train.loop import sample_negatives

    ids, answers = random_batch(device, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    return ids, answers, sample_negatives(gen, ids, answers, N_ITEMS), dropout_seeds(device, seed)


def phase_sasrec_step(device):
    """One SASRec Adam step with every dropout site on the kernel against
    the same step on the kernel's plain version: same weights, batch,
    negatives and seeds."""
    import torch

    from bsarec_tpu_torch import parity
    from bsarec_tpu_torch.config import TrainConfig
    from bsarec_tpu_torch.ops import dropout as fd
    from bsarec_tpu_torch.train.loop import make_optimizer

    ids, answers, negs, seeds = sasrec_batch(device, seed=11)
    first = sasrec_model(device, fused=True)
    models = (first, copy.deepcopy(first))
    del first
    models[1].dropout_state.plain = True
    results, launches = [], []
    for model in models:
        model.train()
        opt = make_optimizer(model.parameters(), TrainConfig(lr=SASREC_LR))
        before = fd.fused_dropout.launches
        model.dropout_state.begin_step(seeds)
        loss = model.calculate_loss(ids, answers, negs)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        launches.append(fd.fused_dropout.launches - before)
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        results.append((loss.detach(), grads, {k: v.clone() for k, v in model.state_dict().items()}))
        del opt
    del models, model
    check(launches == [2 * DROPOUT_SITES, 0],
          f"dropout launches in the two steps {launches}, want [{2 * DROPOUT_SITES}, 0]")
    (loss, grads, params), (want_loss, want_grads, want_params) = results
    loss_err = abs(float(loss) - float(want_loss))
    check(loss_err <= CE_TOL * max(1.0, abs(float(want_loss))), f"SASRec step: loss error {loss_err}")
    grad_err = max(parity.rel_err(grads[k], want_grads[k]) for k in grads
                   if want_grads[k].abs().max() > 0)
    check(grad_err <= GRAD_TOL, f"SASRec step: gradient error {grad_err} > {GRAD_TOL}")
    param_err = max(float((params[k] - want).abs().max()) for k, want in want_params.items())
    check(param_err <= STEP_PARAM_TOL, f"SASRec step: parameter error {param_err}")
    log(f"one SASRec Adam step, fused dropout kernel vs its plain version (B={TRAIN_BATCH}, "
        f"V={N_ITEMS}, H=64, dropout 0.5, {launches[0]} dropout launches): ok, loss "
        f"{float(loss):.7f} vs {float(want_loss):.7f}, gradient rel err {grad_err:.3g}, "
        f"parameter max |diff| {param_err:.3g}")
    del results, grads, want_grads, params, want_params
    torch.cuda.empty_cache()


def phase_sasrec_train(device, workdir, card):
    """`main --model_type SASRec --prng rbg` with BSAREC_DROPOUT=pallas for 2
    epochs, then --resume for a third; then 2 epochs with nn.Dropout for
    the rate without the kernel. Returns (the first run's launch counts,
    its second epoch's examples/s, the nn.Dropout run's)."""
    import torch

    from bsarec_tpu_torch import main as port_main

    seqs = synth_corpus(TRAIN_USERS, N_ITEMS, seed=1)
    with open(os.path.join(workdir, "synth_train.txt"), "w") as fh:
        for u, seq in enumerate(seqs):
            fh.write(f"{u + 1} {' '.join(map(str, seq))}\n")
    n_samples = sum(len(s[-52:-2]) for s in seqs)
    steps = math.ceil(n_samples / TRAIN_BATCH)
    eval_steps = math.ceil(TRAIN_USERS / EVAL_BATCH)
    argv = ["--data_dir", workdir, "--data_name", "synth_train", "--output_dir", workdir,
            "--device", device.type, "--model_type", "SASRec", "--prng", "rbg",
            "--lr", str(SASREC_LR), "--batch_size", str(TRAIN_BATCH)]

    def run(name, extra, fused=True):
        reset_counts()
        t0 = time.perf_counter()
        with pallas_dropout_env(fused):
            scores = port_main.main(argv + ["--train_name", name] + extra)
        torch.cuda.synchronize(device)
        counts = read_counts()
        check(all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in scores), f"bad scores {scores}")
        text = read_log(os.path.join(workdir, f"{name}.log"))
        losses = [float(x) for x in re.findall(r"'epoch': \d+, 'rec_loss': '([^']+)'", text)]
        rates = [float(x) for x in re.findall(r"epoch \d+: train (\d+) ex/s", text)]
        return scores, counts, time.perf_counter() - t0, text, losses, rates

    scores, counts, seconds, text, losses, rates = run("sasrec", ["--epochs", "2"])
    want = zero_counts() | {"fused_dropout": 2 * 2 * DROPOUT_SITES * steps,
                            "streaming_masked_topk": 3 * eval_steps}
    check(counts == want, f"SASRec launches {counts}, want {want}")
    check("dropout: fused kernel" in text and "pair BCE" in text, "dropout/loss log lines missing")
    check(len(losses) == 2 and all(math.isfinite(x) for x in losses) and losses[1] < losses[0],
          f"SASRec epoch losses {losses}: want two finite values, the second lower")
    check(len(rates) == 2, f"epoch rate lines {rates}")
    first_counts, fused_rate = counts, rates[1]
    log(f"SASRec path: main(--model_type SASRec --prng rbg, BSAREC_DROPOUT=pallas, --epochs 2) on "
        f"{TRAIN_USERS} users x {N_ITEMS} items, {steps} steps per epoch, returned in {seconds:.1f}s, "
        f"epoch losses {losses}, train {rates[0]:.0f} then {rates[1]:.0f} examples/s, test scores "
        f"{scores}; launches {counts}: {2 * DROPOUT_SITES} dropout launches per step [{card}]")

    scores, counts, seconds, text, losses, _ = run("sasrec", ["--epochs", "3", "--resume"])
    check("resumed full train state" in text and "(epoch 1)" in text, "resume line missing")
    check(len(losses) == 3 and "'epoch': 2," in text and math.isfinite(losses[2]),
          f"resumed run: epoch losses {losses}")
    want = zero_counts() | {"fused_dropout": 2 * DROPOUT_SITES * steps,
                            "streaming_masked_topk": 2 * eval_steps}
    check(counts == want, f"resumed SASRec launches {counts}, want {want}")
    log(f"SASRec path: main(--resume --epochs 3) started at epoch 2 and returned in {seconds:.1f}s, "
        f"epoch 2 loss {losses[2]}, test scores {scores}; launches {counts}")

    _, counts, seconds, _, losses, rates = run("sasrec_nn", ["--epochs", "2"], fused=False)
    want = zero_counts() | {"streaming_masked_topk": 3 * eval_steps}
    check(counts == want and len(rates) == 2, f"nn.Dropout run: launches {counts}, rates {rates}")
    log(f"SASRec path with nn.Dropout (BSAREC_DROPOUT unset): returned in {seconds:.1f}s, epoch "
        f"losses {losses}, train {rates[0]:.0f} then {rates[1]:.0f} examples/s [{card}]")
    return first_counts, fused_rate, rates[1]


def kernel_ms_profiled(fn, kernel_name: str, flush=None, iters: int = 50, tries: int = 3):
    """The card's ms per launch of the kernels whose name holds
    `kernel_name` over `iters` calls of fn, from torch.profiler's kernel
    times. `flush` (a callable that reads or writes a buffer larger than
    the 50 MB L2) runs before each call, so the kernel finds none of its
    input in L2. A trace that recorded no such kernel is taken again, up
    to `tries` traces; None when none did."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        ours = [e for e in device_kernels(prof) if kernel_name in e.key]
        n = sum(e.count for e in ours)
        if n:
            return sum(e.self_device_time_total for e in ours) / 1e3 / n
    return None


def phase_dropout_times(device, card):
    """The dropout kernel at both site shapes, each comparison in turns
    (kernel, yardstick, yardstick, kernel): `dropout_apply` against
    `F.dropout(x, 0.5, True)` back to back; forward through a chain of
    7 sites (a SASRec step's count) and one backward on a leaf that
    requires grad, `FusedDropout` sites against `nn.Dropout` ones, per
    site; the kernel in a CUDA graph of 50 launches; the kernel with a
    cold L2, after a 128 MB write (the lines it evicts are dirty) and
    after a 128 MB read (clean), beside ATen's dropout kernel and a
    multiply by 2 (the same bytes in and out) under the same flush, and
    with a warm L2; the plain version and the bound. Returns the hidden
    site's JSON fields."""
    import torch
    import torch.nn.functional as F

    from bsarec_tpu_torch.models.modules import DropoutState, FusedDropout
    from bsarec_tpu_torch.ops import dropout as fd

    seeds = dropout_seeds(device, 1)
    state = DropoutState(fused=True)
    state.begin_step(seeds)
    fused_sites = torch.nn.Sequential(*[FusedDropout(0.5, state) for _ in range(DROPOUT_SITES)]).train()
    nn_sites = torch.nn.Sequential(*[torch.nn.Dropout(0.5) for _ in range(DROPOUT_SITES)]).train()
    buf = torch.empty(32 << 20, device=device)  # 128 MB
    flushes = {"written": buf.zero_, "read": buf.sum}
    back = lambda fn: cuda_ms(fn, iters=200, warmup=5)
    out = {}
    for site_name, shape in DROPOUT_SHAPES.items():
        x = torch.randn(shape, device=device)
        y = torch.empty_like(x)
        where = f"{site_name} site {list(shape)} fp32, rate 0.5"
        (k1, k2), (l1, l2) = in_turns(lambda: fd.dropout_apply(x, seeds, 0.5, 0),
                                      lambda: F.dropout(x, 0.5, True), back)
        leaf = x.clone().requires_grad_()
        g = torch.randn_like(x)

        def through_fused():
            state.call = 0
            torch.autograd.grad(fused_sites(leaf), leaf, g)

        (s1, s2), (n1, n2) = in_turns(through_fused,
                                      lambda: torch.autograd.grad(nn_sites(leaf), leaf, g),
                                      lambda fn: cuda_ms(fn, iters=100, warmup=5) / DROPOUT_SITES)
        plain_ms = cuda_ms(lambda: fd.fused_dropout_plain(x, seeds, 0.5, 0), iters=20)
        in_graph = graph_ms(lambda: fd.dropout_apply(x, seeds, 0.5, 0), calls=50, replays=20)
        nbytes = 2 * x.numel() * 4
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        log(f"time fused_dropout dropout_apply: {pair((k1, k2))} ms per call back to back; library "
            f"F.dropout(x, 0.5, True): {pair((l1, l2))} ms ({where}; turns kernel, F.dropout, "
            f"F.dropout, kernel) [{card}]")
        log(f"time fused_dropout forward through {DROPOUT_SITES} sites and one backward on a leaf "
            f"that requires grad, per site: FusedDropout {pair((s1, s2))} ms, nn.Dropout "
            f"{pair((n1, n2))} ms ({where}; turns FusedDropout, nn.Dropout, nn.Dropout, "
            f"FusedDropout) [{card}]")
        log(f"time fused_dropout plain version: {plain_ms:.4f} ms; kernel in a CUDA graph of 50 "
            f"launches: {in_graph:.5f} ms per launch (the same input each launch, L2-resident) "
            f"({where}) [{card}]")
        # each profiled alone, beside the flush's own kernel; the names tell them apart
        ours = (lambda: fd.dropout_apply(x, seeds, 0.5, 0), "fused_dropout_kernel<")
        aten = (lambda: F.dropout(x, 0.5, True), "dropout")
        double = (lambda: torch.mul(x, 2.0, out=y), "MulFunctor")
        for flush_name, flush in flushes.items():
            ((c1, c2), (a1, a2)) = in_turns(ours, aten, lambda k: kernel_ms_profiled(*k, flush))
            mul = kernel_ms_profiled(*double, flush)
            for label, times in (("fused_dropout_kernel", (c1, c2)), ("ATen's dropout kernel", (a1, a2)),
                                 ("x * 2 (ATen)", (mul,))):
                if any(t is None for t in times):
                    log(f"time {label}, cold L2 (128 MB {flush_name} before each launch): not "
                        f"measured (torch.profiler recorded no such kernel) ({where})")
                    continue
                share = "/".join(f"{100 * bound_ms / t:.1f}" for t in times)
                log(f"time {label}, cold L2 (128 MB {flush_name} before each launch): "
                    f"{pair(times)} ms per launch (torch.profiler), {share}% of the dropout "
                    f"kernel's bound ({where}) [{card}]")
        warm = kernel_ms_profiled(*ours)
        log(f"time fused_dropout_kernel, warm L2 (back to back, same input): "
            + (f"{warm:.5f} ms per launch (torch.profiler), {100 * bound_ms / warm:.1f}% of the bound"
               if warm is not None else "not measured") + f" ({where}) [{card}]")
        log(f"bound fused_dropout: {bound_ms:.5f} ms (bytes: {nbytes / 1e6:.3f} MB at 3.35 TB/s; "
            f"Philox's ~12 integer operations per element stay far under it) -> kernel at "
            f"{100 * bound_ms / in_graph:.1f}% of the bound in the graph ({site_name} site) [{card}]")
        out[site_name] = {"ms": (k1 + k2) / 2, "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": "bytes", "library_ms": (l1 + l2) / 2}
        del x, y, leaf, g
    del buf, flushes
    torch.cuda.empty_cache()
    return out["hidden"]


def phase_sasrec_breakdown(device, card, n_steps: int = 10):
    """SASRec training steps with the fused dropout, on the host clock and
    under torch.profiler: the device's busy share and its time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bsarec_tpu_torch.config import TrainConfig
    from bsarec_tpu_torch.train.loop import make_optimizer

    model = sasrec_model(device, fused=True)
    model.train()
    opt = make_optimizer(model.parameters(), TrainConfig(lr=SASREC_LR))
    batches = [sasrec_batch(device, seed=2000 + i) for i in range(n_steps)]

    def step(ids, answers, negs, seeds):
        model.dropout_state.begin_step(seeds)
        loss = model.calculate_loss(ids, answers, negs)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    for batch in batches[:3]:  # warm-up: Adam's state, the allocator
        step(*batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch in batches:
        step(*batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n_steps
    log(f"SASRec train step (fused dropout): {1e3 * wall:.4f} ms per {TRAIN_BATCH}-sample step on "
        f"the host clock = {TRAIN_BATCH / wall:.1f} examples/s (fresh model, random batches) [{card}]")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            step(*batch)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    on_device = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in on_device) / 1e6
    if busy > 0:
        log(f"SASRec train trace: device busy {busy:.4f}s of a {traced:.4f}s traced window of "
            f"{n_steps} steps, idle share {100 * (1 - busy / traced):.1f}% (torch.profiler) [{card}]")
        for e in sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]:
            log(f"SASRec train trace device time {e.key[:90]}: "
                f"{e.self_device_time_total / 1e3 / n_steps:.4f} ms per step, {e.count} calls [{card}]")
        ours = [e for e in on_device if "fused_dropout_kernel" in e.key]
        log(f"SASRec train trace device time fused_dropout_kernel: "
            f"{sum(e.self_device_time_total for e in ours) / 1e3 / n_steps:.4f} ms per step, "
            f"{sum(e.count for e in ours)} calls in {n_steps} steps [{card}]")
    else:
        log("SASRec train trace: torch.profiler recorded no device time; busy share not measured")
    del model, opt, batches
    torch.cuda.empty_cache()


# ---- the rest of the model zoo -------------------------------------------------

# the six models ported after BSARec and SASRec, at the JAX CLI's defaults
# (hidden 64, 2 layers, 2 heads, max_len 50, dropout 0.5/0.5, and each
# model's own flags at main's defaults); the CE models train through the
# streaming CE kernels, every model's eval through the rank kernel
ZOO = ("FMLPRec", "BERT4Rec", "GRU4Rec", "Caser", "DuoRec", "FEARec")
ZOO_CE = ("bert4rec", "duorec", "fearec")
ZOO_SERVED = ("BERT4Rec", "Caser")
# FEARec trains on the fused dropout kernel: 7 sites a forward (the
# embedding, then per layer the attention probabilities [B, h, L, L], the
# attention output and the FFN), 3 forwards a step under ssl us_x, each
# site once forward and once backward
FEAREC_DROPOUT_PER_STEP = 7 * 3 * 2
# an entry's parameter after one Adam step from the same weights is
# lr * f(G), f(G) = G / (|G| + eps), G the gradient with the decay added:
# an entry whose gradient is near eps (1e-8) turns a rounding difference
# in G into a visible step difference
ADAM_EPS = 1e-8
CASER_FC_SHAPE = (TRAIN_BATCH, 4 * 64 + 8 * 50)  # nv * H + nh * L at the defaults


def zoo_config(model_type: str, dropout: float = 0.0, loss_impl: str = "auto"):
    """A model of the zoo over N_ITEMS items at the CLI defaults."""
    from bsarec_tpu_torch.config import ModelConfig

    return ModelConfig(model_type=model_type.lower(), item_size=N_ITEMS,
                       num_users=TRAIN_USERS + 1, hidden_dropout_prob=dropout,
                       attention_probs_dropout_prob=dropout, loss_impl=loss_impl)


def zoo_batch(seed: int):
    """A training batch on the host: [256, 50] left-padded ids, answers,
    negatives, a same-target view and user ids, from a seed."""
    import torch

    rng = np.random.default_rng(seed)

    def ids():
        x = rng.integers(1, N_ITEMS, size=(TRAIN_BATCH, 50))
        for r, pad in enumerate(rng.integers(0, 45, size=TRAIN_BATCH)):
            x[r, :pad] = 0
        return x

    batch = (ids(), rng.integers(1, N_ITEMS, size=TRAIN_BATCH),
             rng.integers(1, N_ITEMS, size=TRAIN_BATCH), ids(),
             rng.integers(0, TRAIN_USERS + 1, size=TRAIN_BATCH))
    return tuple(torch.from_numpy(x) for x in batch)


def zoo_loss(model, batch, masked=None):
    """The model's training loss on a batch; BERT4Rec's on the cloze-masked
    ids given (its own draw would differ between the CPU's and the card's
    generators): the CE of the forward on them, as its calculate_loss takes it."""
    from bsarec_tpu_torch.ops.losses import full_softmax_ce

    if masked is not None:
        cfg = model.config
        return full_softmax_ce(model(masked)[:, -1, :], model.item_table, batch[1],
                               impl=cfg.loss_impl)
    return model.calculate_loss(*batch)


def zoo_one_step(model, batch, masked=None):
    """One Adam step; returns (loss, gradients, parameters after), on the CPU."""
    import torch

    from bsarec_tpu_torch.config import TrainConfig
    from bsarec_tpu_torch.train.loop import make_optimizer

    model.train()
    opt = make_optimizer(model.parameters(), TrainConfig(lr=LR))
    loss = zoo_loss(model, batch, masked)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    grads = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    opt.step()
    params = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del opt
    return float(loss.detach()), grads, params


def zoo_read_rows(model, batch, masked):
    """[V] bool: the item-table rows that the batch's lookups and pair
    logits read (the inputs, or BERT4Rec's masked ids, the answers, the
    negatives and same-target view where the model reads them). The
    other rows' gradient is the CE's softmax share, or Caser's norm
    penalty, or 0."""
    import torch

    ids = [batch[0] if masked is None else masked, batch[1]]
    if model.reads_negatives:
        ids.append(batch[2])
    if model.reads_same_target:
        ids.append(batch[3])
    rows = torch.zeros(model.vocab_rows(), dtype=torch.bool)
    rows[torch.cat([x.reshape(-1) for x in ids]).long()] = True
    return rows


def zoo_grad_tolerance(grads, want_grads, read_rows, grad_tol=GRAD_TOL, table_tol=None):
    """{name: the largest gradient difference allowed, a scalar tensor or
    [V, 1] for the item table}, the errors relative to it, and the names
    of the zero-gradient tensors. Each tensor is
    held within grad_tol of its largest reference entry; a tensor whose
    reference gradient stays under 1e-6 of the model's largest (a zero true
    gradient) within grad_tol of that largest; the item table's read rows
    and its other rows apart, each within table_tol (default grad_tol) of
    its own largest entry (0 where that is 0: the card's must then be 0
    too)."""
    import torch

    top = max(float(g.abs().max()) for g in want_grads.values())
    tol, errs, zero = {}, {}, []
    for k, want in want_grads.items():
        diff = (grads[k] - want).abs()
        if k == "item_embeddings.weight":
            t = torch.zeros(want.shape[0], 1)
            for part, rows in (("read rows", read_rows), ("other rows", ~read_rows)):
                scale = float(want[rows].abs().max()) if rows.any() else 0.0
                t[rows] = (grad_tol if table_tol is None else table_tol) * scale
                d = float(diff[rows].max()) if rows.any() else 0.0
                errs[f"table {part}"] = d / scale if scale > 0 else (0.0 if d == 0 else math.inf)
            tol[k] = t
            continue
        scale = float(want.abs().max())
        if scale <= 1e-6 * top:
            zero.append(k)
            scale = top
        tol[k] = torch.tensor(grad_tol * scale)
        errs["other tensors"] = max(errs.get("other tensors", 0.0), float(diff.max()) / scale)
    return tol, errs, zero


def zoo_adam_excess(start, grads, want_grads, params, want_params, tol):
    """The largest parameter difference after one Adam step beyond the
    most that a gradient difference within `tol` explains: lr * |f(G + d)
    - f(G)|, G the CPU's gradient with the decay added (TrainConfig's
    weight_decay), d the measured difference clamped to +-tol. A zeroed
    gradient where |G| > tol is then an error."""
    from bsarec_tpu_torch.config import TrainConfig

    def f(g):
        return g / (g.abs() + ADAM_EPS)

    decay = TrainConfig().weight_decay
    worst = 0.0
    for k, want in want_params.items():
        diff = (params[k].double() - want.double()).abs()
        if k in want_grads:
            g = want_grads[k].double() + decay * start[k].double()
            t = tol[k].double()
            d = (grads[k].double() - want_grads[k].double()).clamp(min=-t, max=t)
            diff = diff - LR * (f(g + d) - f(g)).abs()
        worst = max(worst, float(diff.max()))
    return worst


# Caser's horizontal filters take a max over time: where two windows' values
# lie within rounding of each other, the card and the CPU may take
# different windows, and the gradient then follows a different window on
# each (an O(1) difference in that filter's gradient, correct on both
# sides). A window the card took is held as a maximum when the fp64 bank
# puts it within this fraction of the window's absolute sum (sum |w x| +
# |b|) of the fp64 maximum
CASER_TIE_TOL = 1e-5


def caser_picks(model, ids):
    """The window each of Caser's horizontal filters takes its max over
    time at, on the device of `model`: [L] of [B, nh, 1] int64 on the CPU
    (the first window where values tie exactly, as amax's gradient splits
    there: the same weights' gradient, the windows' inputs being the same
    padding rows)."""
    import torch

    with torch.no_grad():
        emb = model.embed_items(ids).unsqueeze(1)
        return [torch.relu(conv(emb).squeeze(3)).argmax(dim=2, keepdim=True).cpu()
                for conv in model.conv_h]


def caser_forward_at(model, picks):
    """Bind to `model` (a CaserModel) the port's Caser forward with each
    horizontal filter's max over time taken at the windows `picks`
    (caser_picks) instead of by amax: the same function wherever the
    windows are the maxima, and the same gradient where they are unique."""
    import types

    import torch

    def forward(self, input_ids, user_ids=None, all_layers=False):
        b = input_ids.shape[0]
        if user_ids is None:
            user_ids = torch.zeros((b,), dtype=torch.long, device=input_ids.device)
        emb = self.embed_items(input_ids).unsqueeze(1)
        out_v = self.conv_v(emb).reshape(b, -1)
        out_h = [torch.relu(conv(emb).squeeze(3)).gather(2, w.to(emb.device)).squeeze(2)
                 for conv, w in zip(self.conv_h, picks)]
        out = self.fc_dropout(torch.cat([out_v, *out_h], dim=1))
        z = torch.relu(self.fc1(out))
        user_emb = self.user_embeddings(user_ids.reshape(-1).long())
        return torch.relu(self.fc2(torch.cat([z, user_emb], dim=1)))[:, None, :]

    model.forward = types.MethodType(forward, model)
    return model


def caser_tie_witness(cpu_model, ids, picks):
    """The card's windows against Caser's bank in fp64 on the CPU (the
    model's weights): raises unless each is a maximum within
    CASER_TIE_TOL of its window's absolute sum. Returns the windows where
    the card, the CPU in fp32 and fp64 disagree, and the fp64 gaps between
    the value at the card's window, and at the CPU's, and the maximum
    there, relative to the window's absolute sum (the largest of each)."""
    import torch
    import torch.nn.functional as F

    with torch.no_grad():
        emb = cpu_model.embed_items(ids).unsqueeze(1)
        emb64 = emb.double()
        out = {"windows": 0, "card_vs_fp64": 0, "cpu_fp32_vs_fp64": 0, "card_vs_cpu_fp32": 0,
               "largest_gap": 0.0, "cpu_largest_gap": 0.0}
        for i, (conv, card) in enumerate(zip(cpu_model.conv_h, picks)):
            w64, b64 = conv.weight.double(), conv.bias.double()
            v64 = torch.relu(F.conv2d(emb64, w64, b64).squeeze(3))
            sums = F.conv2d(emb64.abs(), w64.abs(), b64.abs()).squeeze(3)

            def gap(at):  # the fp64 maximum less the value at `at`, of at's absolute sum
                return ((v64.amax(dim=2) - v64.gather(2, at).squeeze(2))
                        / sums.gather(2, at).squeeze(2).clamp(min=1e-30))

            mine = torch.relu(conv(emb).squeeze(3)).argmax(dim=2, keepdim=True)
            best = v64.argmax(dim=2, keepdim=True)
            gap_card, gap_cpu = float(gap(card).max()), float(gap(mine).max())
            check(gap_card <= CASER_TIE_TOL,
                  f"Caser step: filter {i}: the card's max over time is off the fp64 maximum by "
                  f"{gap_card:.3g} of its window's absolute sum")
            out["windows"] += card.numel()
            out["card_vs_fp64"] += int((card != best).sum())
            out["cpu_fp32_vs_fp64"] += int((mine != best).sum())
            out["card_vs_cpu_fp32"] += int((card != mine).sum())
            out["largest_gap"] = max(out["largest_gap"], gap_card)
            out["cpu_largest_gap"] = max(out["cpu_largest_gap"], gap_cpu)
    return out


def caser_fp64_grads(cpu_model, batch, picks):
    """The gradients of Caser's loss in fp64 on the CPU, from the model's
    weights, its max over time at the card's windows: {name: fp32}."""
    import torch

    model = caser_forward_at(copy.deepcopy(cpu_model).double(), picks)
    loss = zoo_loss(model, batch)
    loss.backward()
    grads = {k: q.grad.float() for k, q in model.named_parameters() if q.grad is not None}
    del model
    return grads


def phase_zoo_steps(device, card):
    """One Adam step of each zoo model at full width over N_ITEMS items
    (BERT4Rec's table 1,000,001 rows), dropout 0, B=256: through the
    kernels on the card against the plain versions on the CPU, from the
    same weights and batch. Loss within CE_TOL; gradients as
    `zoo_grad_tolerance` holds them (the item table's read rows and its
    other rows apart); every parameter within STEP_PARAM_TOL of the CPU's
    beyond what `zoo_adam_excess` allows. The CE models' card step must
    launch ce_logz and ce_grads once each on the on-chip route, the others
    no kernel. Caser's CPU step takes each horizontal filter's max over time
    at the window the card took (caser_forward_at), each of which must be a
    maximum in fp64 (caser_tie_witness); its gradients are held besides
    against the same step in fp64, and those of the CPU's own maxima
    (amax) are logged beside, with the windows where the two sides took
    different maxima. Returns {model: launch counts}."""
    import torch

    from bsarec_tpu_torch.models import build_model
    from bsarec_tpu_torch.models.bert4rec import cloze_mask
    from bsarec_tpu_torch.ops import ce

    out = {}
    for i, name in enumerate(ZOO):
        mt = name.lower()
        batch = zoo_batch(seed=700 + i)
        masked = None
        if mt == "bert4rec":
            masked = cloze_mask(batch[0], int(50 * 0.2), N_ITEMS, torch.Generator().manual_seed(i))
        cfg = zoo_config(mt, loss_impl="streaming")
        cpu_model = build_model(cfg, generator=torch.Generator().manual_seed(i))
        card_model = copy.deepcopy(cpu_model).to(device)
        start = {k: v.detach().clone() for k, v in cpu_model.state_dict().items()}
        read_rows = zoo_read_rows(cpu_model, batch, masked)
        if mt == "caser":
            picks = caser_picks(card_model, batch[0].to(device))
            tie = caser_tie_witness(cpu_model, batch[0], picks)
            # the copy of the forward against the model's: bit-equal at the
            # CPU's own maxima
            with torch.no_grad():
                own = zoo_loss(cpu_model, batch)
                check(torch.equal(zoo_loss(caser_forward_at(cpu_model, caser_picks(cpu_model, batch[0])),
                                           batch), own), "Caser step: caser_forward_at is not the model's")
            plain_grads = zoo_one_step(copy.deepcopy(cpu_model), batch)[1]
            grads64 = caser_fp64_grads(cpu_model, batch, picks)
            caser_forward_at(cpu_model, picks)
        t0 = time.perf_counter()
        want_loss, want_grads, want_params = zoo_one_step(cpu_model, batch, masked)
        cpu_s = time.perf_counter() - t0
        del cpu_model
        reset_counts()
        t0 = time.perf_counter()
        loss, grads, params = zoo_one_step(
            card_model, tuple(x.to(device) for x in batch),
            None if masked is None else masked.to(device))
        card_s = time.perf_counter() - t0
        counts = read_counts() | {"ce_logz_onchip": ce.ce_logz.onchip_launches,
                                  "ce_grads_onchip": ce.ce_grads.onchip_launches}
        del card_model
        want_counts = zero_counts() | {"ce_logz_onchip": 0, "ce_grads_onchip": 0}
        if mt in ZOO_CE:
            want_counts |= {"ce_logz": 1, "ce_grads": 1, "ce_logz_onchip": 1, "ce_grads_onchip": 1}
        check(counts == want_counts, f"{name} step launches {counts}, want {want_counts}")
        loss_err = abs(loss - want_loss)
        check(math.isfinite(loss) and loss_err <= CE_TOL * max(1.0, abs(want_loss)),
              f"{name} step: loss {loss} vs {want_loss}")
        check(grads.keys() == want_grads.keys(), f"{name} step: gradient keys differ")
        tol, grad_errs, zero = zoo_grad_tolerance(grads, want_grads, read_rows)
        check(max(grad_errs.values()) <= GRAD_TOL,
              f"{name} step: gradient errors {grad_errs} > {GRAD_TOL}")
        if mt == "caser":
            errs64 = zoo_grad_tolerance(grads, grads64, read_rows)[1]
            check(max(errs64.values()) <= GRAD_TOL,
                  f"{name} step: gradient errors against fp64 {errs64} > {GRAD_TOL}")
            plain_errs = zoo_grad_tolerance(grads, plain_grads, read_rows)[1]
            log(f"zoo step {name}: max over time at {tie['windows']} windows; the card's and the "
                f"CPU's fp32 maxima differ at {tie['card_vs_cpu_fp32']}, the card's and fp64's at "
                f"{tie['card_vs_fp64']}, the CPU's and fp64's at {tie['cpu_fp32_vs_fp64']}; the "
                f"card's windows within {tie['largest_gap']:.3g} of the fp64 maxima (of the window's "
                f"absolute sum; limit {CASER_TIE_TOL}), the CPU's within {tie['cpu_largest_gap']:.3g}; "
                f"gradient rel err against the fp64 step at "
                f"the card's windows { {k: float(f'{v:.3g}') for k, v in errs64.items()} }, against "
                f"the CPU's own maxima { {k: float(f'{v:.3g}') for k, v in plain_errs.items()} } "
                f"[{card}]")
            del plain_grads, grads64
        param_excess = zoo_adam_excess(start, grads, want_grads, params, want_params, tol)
        check(param_excess <= STEP_PARAM_TOL,
              f"{name} step: parameter error beyond Adam's share {param_excess} > {STEP_PARAM_TOL}")
        rows = params["item_embeddings.weight"].shape[0]
        log(f"zoo step {name} (B={TRAIN_BATCH}, {rows} table rows, H=64, dropout 0): kernels on the "
            f"card vs plain versions on the CPU ok: loss {loss:.6f} vs {want_loss:.6f}, gradient "
            f"rel err { {k: float(f'{v:.3g}') for k, v in grad_errs.items()} } ({int(read_rows.sum())} "
            f"read table rows; {len(zero)} zero-gradient tensors: {zero}), parameters "
            f"within {STEP_PARAM_TOL} beyond Adam's share (worst {param_excess:.3g}); launches "
            f"{counts}; CPU step {cpu_s:.1f}s, card step {card_s:.2f}s (first call) [{card}]")
        out[mt] = counts
        del grads, want_grads, params, want_params, start, tol
        torch.cuda.empty_cache()
    return out


# the user ids of the served batch: the first users, then another set
# (Caser's states depend on them; its top-20s must change)
SERVED_USER_SETS = (0, TRAIN_USERS // 2)


def zoo_serving_check(device, workdir, name, data, argv, card):
    """BERT4Rec or Caser served from seeded random-init weights (one
    epoch leaves Caser's states scoring every item alike): the weights
    saved as a port checkpoint, `main --do_eval --load_model
    --export_serving` on them (the test pass, then the export), the
    artifact loaded on the card. Per user set of SERVED_USER_SETS, one
    call at B=256 (one rank launch, on-chip), each returned id scored by
    the serving-mode plain version within `tol` of its top-20, and the
    ids equal to it at every slot whose score stands more than `tol` from
    its neighbours'; half the slots at least must be such. `tol` is
    FLOAT_TOL times the largest |score| where that is under 1 (Caser's
    random-init scores are ~1e-3: an absolute 1e-4 would let any id pass). Caser's
    two user sets must give different top-20s. For BERT4Rec also the eval
    path's own call, the kernel over the whole table (1,000,001 rows)
    with n_valid = 1,000,000, against its plain version."""
    import torch

    from bsarec_tpu_torch import main as port_main
    from bsarec_tpu_torch import serving
    from bsarec_tpu_torch.models import build_model
    from bsarec_tpu_torch.ops import rank, serving_topk
    from bsarec_tpu_torch.train.checkpoint import save_params

    mt = name.lower()
    model = build_model(zoo_config(mt), generator=torch.Generator().manual_seed(11))
    save_params(model.state_dict(), os.path.join(workdir, f"zoo_{mt}_init.ckpt"))
    path = os.path.join(workdir, f"zoo_{mt}.pt2")
    t0 = time.perf_counter()
    scores = port_main.main(argv + ["--train_name", f"zoo_{mt}_serve", "--do_eval",
                                    "--load_model", f"zoo_{mt}_init", "--export_serving", path])
    export_s = time.perf_counter() - t0
    check(all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in scores),
          f"{name} --do_eval scores {scores}")
    scorer = serving.load_scorer(path, device)
    ids = data.test.input_ids[:EVAL_BATCH]
    seen = data.test.seen_items[:EVAL_BATCH]
    model.to(device).eval()
    table = model.item_table
    served = table[:N_ITEMS]
    seen_dev = torch.from_numpy(seen).to(device)
    bitmask = serving_topk.seen_bitmask(seen_dev, N_ITEMS)
    ids_dev = torch.from_numpy(ids).long().to(device)
    err, tops = 0.0, []
    for first in SERVED_USER_SETS:
        users = np.arange(first, first + EVAL_BATCH, dtype=np.int32)
        reset_counts()
        got = scorer.topk(ids, users, seen)
        counts = read_counts()
        check(counts == zero_counts() | {"streaming_masked_topk": 1}
              and rank.streaming_masked_topk.onchip_launches == 1,
              f"{name} artifact call launches {counts}")
        with torch.inference_mode():
            states = model.predict(ids_dev, torch.from_numpy(users).long().to(device))
            states = states[:, -1, :].contiguous()
            want_v, want_i = rank.streaming_masked_topk_plain(states, served, bitmask, TOP_K,
                                                              N_ITEMS, seen_value=-math.inf)
            got_t = torch.from_numpy(got).to(device)
            set_err = float((masked_scores(states, served, bitmask, N_ITEMS, got_t, -math.inf)
                             - want_v).abs().max())
            top = float(want_v.abs().max())
            tol = FLOAT_TOL * min(1.0, top)
            check(set_err <= tol, f"{name} artifact: score error {set_err} > {tol}")
            gaps = (want_v[:, :-1] - want_v[:, 1:]).abs()
            clear = torch.cat([gaps[:, :1], torch.minimum(gaps[:, 1:], gaps[:, :-1]),
                               gaps[:, -1:]], dim=1) > tol  # apart from its neighbours
            same = got_t.long() == want_i.long()
            check(2 * int(clear.sum()) >= clear.numel(),
                  f"{name} artifact: only {int(clear.sum())} of {clear.numel()} slots clearly ranked")
            check(bool(same[clear].all()), f"{name} artifact: ids differ at clearly ranked slots")
        err = max(err, set_err)
        tops.append(got)
        log(f"zoo serving {name}: artifact at B={EVAL_BATCH}, users {first}..{first + EVAL_BATCH - 1}, "
            f"one rank launch on-chip; ids scored within {set_err:.3g} (tolerance {tol:.3g}, largest "
            f"|score| {top:.3g}) of the serving-mode plain top-20, equal in {int(same.sum())} of {same.numel()} slots (all {int(clear.sum())} "
            f"clearly ranked ones) [{card}]")
    rows_differ = int((tops[0] != tops[1]).any(axis=1).sum())
    if model.reads_users:
        check(rows_differ > 0, f"{name} artifact: the two user sets give the same top-20s")
    log(f"zoo serving {name}: random-init weights exported by main --do_eval --export_serving in "
        f"{export_s:.1f}s (test pass and export); the two user sets' top-20s differ in "
        f"{rows_differ} of {EVAL_BATCH} rows")
    if mt == "bert4rec":  # the eval path's call: the whole table, n_valid < V
        with torch.inference_mode():
            full_mask = rank.seen_ids_to_bitmask(
                torch.from_numpy(rank.dedupe_seen_rows(seen)).to(device), table.shape[0])
            reset_counts()
            kv, ki = rank.streaming_masked_topk(states, table, full_mask, TOP_K, N_ITEMS)
            torch.cuda.synchronize()
            check(rank.streaming_masked_topk.onchip_launches == 1, "BERT4Rec eval call route")
            pv, _ = rank.streaming_masked_topk_plain(states, table, full_mask, TOP_K, N_ITEMS)
            eval_err = float((masked_scores(states, table, full_mask, N_ITEMS, ki) - pv).abs().max())
        check(eval_err <= FLOAT_TOL and int(ki.max()) < N_ITEMS,
              f"BERT4Rec eval rank call: error {eval_err}, largest id {int(ki.max())}")
        log(f"zoo BERT4Rec eval rank call (V={table.shape[0]}, n_valid={N_ITEMS}, on-chip) vs "
            f"plain: ids scored within {eval_err:.3g}, the [mask] row never returned")
    del model, scorer
    return err


def phase_zoo_train(device, workdir, card):
    """`main --model_type <M> --epochs 1` for each zoo model on the
    TRAIN_USERS-user x N_ITEMS synthetic corpus (Trainer.fit: one epoch, the
    validation, the test pass), FEARec under `--prng rbg` with
    BSAREC_DROPOUT=pallas; BERT4Rec and Caser then exported and served
    (`zoo_serving_check`).
    Checks the scores and the epoch loss, and the launches: the CE models
    ce_logz and ce_grads once a step on the on-chip route, the others
    none; the rank kernel once an eval batch, all on-chip; FEARec's
    dropout sites on the fused kernel. Returns ({model: counts}, {model:
    (train examples/s of the epoch, eval users/s of the test pass)})."""
    import torch

    from bsarec_tpu_torch import main as port_main
    from bsarec_tpu_torch.data.corpus import Corpus
    from bsarec_tpu_torch.data.pipeline import SeqRecData
    from bsarec_tpu_torch.ops import ce, rank

    seqs = synth_corpus(TRAIN_USERS, N_ITEMS, seed=1)
    with open(os.path.join(workdir, "zoo_train.txt"), "w") as fh:
        for u, seq in enumerate(seqs):
            fh.write(f"{u + 1} {' '.join(map(str, seq))}\n")
    data = SeqRecData(Corpus(user_seq=seqs, max_item=N_ITEMS - 1), 50)
    steps = math.ceil(data.train.num_samples / TRAIN_BATCH)
    eval_steps = math.ceil(TRAIN_USERS / EVAL_BATCH)
    counts_out, rates, serving_errs = {}, {}, {}
    for name in ZOO:
        mt = name.lower()
        fused = mt == "fearec"
        common = ["--data_dir", workdir, "--data_name", "zoo_train", "--output_dir", workdir,
                  "--device", device.type, "--model_type", name]
        argv = common + ["--train_name", f"zoo_{mt}", "--lr", str(LR),
                         "--batch_size", str(TRAIN_BATCH), "--epochs", "1"]
        if fused:
            argv += ["--prng", "rbg"]
        with pallas_dropout_env(fused):
            reset_counts()
            t0 = time.perf_counter()
            scores = port_main.main(argv)
            torch.cuda.synchronize(device)
            seconds = time.perf_counter() - t0
        counts = read_counts() | {
            "ce_logz_onchip": ce.ce_logz.onchip_launches,
            "ce_grads_onchip": ce.ce_grads.onchip_launches,
            "streaming_masked_topk_onchip": rank.streaming_masked_topk.onchip_launches}
        check(all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in scores), f"{name}: scores {scores}")
        want = zero_counts() | {"streaming_masked_topk": 2 * eval_steps,
                                "streaming_masked_topk_onchip": 2 * eval_steps,
                                "ce_logz_onchip": 0, "ce_grads_onchip": 0}
        if mt in ZOO_CE:
            want |= {"ce_logz": steps, "ce_grads": steps, "ce_logz_onchip": steps,
                     "ce_grads_onchip": steps}
        if fused:
            want["fused_dropout"] = FEAREC_DROPOUT_PER_STEP * steps
        check(counts == want, f"{name} train path launches {counts}, want {want}")
        text = read_log(os.path.join(workdir, f"zoo_{mt}.log"))
        losses = [float(x) for x in re.findall(r"'epoch': \d+, 'rec_loss': '([^']+)'", text)]
        check(len(losses) == 1 and math.isfinite(losses[0]), f"{name}: epoch losses {losses}")
        train_rate = [float(x) for x in re.findall(r"epoch \d+: train (\d+) ex/s", text)]
        evals = re.findall(r"eval test: (\d+) users in ([0-9.]+)s", text)
        check(len(train_rate) == 1 and len(evals) == 1, f"{name}: rate lines")
        users_s = int(evals[0][0]) / float(evals[0][1])
        loss_line = re.search(r"loss: (.*)", text).group(1)
        rates[mt] = (train_rate[0], users_s)
        counts_out[mt] = counts
        log(f"zoo train {name}: main(--epochs 1{' --prng rbg, fused dropout' if fused else ''}) "
            f"on {TRAIN_USERS} users x {N_ITEMS} items, {steps} steps, returned in {seconds:.1f}s; "
            f"loss [{loss_line}] {losses[0]:.4f}; test scores {scores}; train {train_rate[0]:.0f} "
            f"examples/s (first epoch, warm-up included); test pass {users_s:.0f} users/s "
            f"(first batch included); launches {counts} [{card}]")
        if name in ZOO_SERVED:
            serving_errs[mt] = zoo_serving_check(device, workdir, name, data, common, card)
        torch.cuda.empty_cache()
    return counts_out, rates, serving_errs


def phase_zoo_profile(device, card, n_steps: int = 10, n_eval: int = 10):
    """Per zoo model, a fresh model at the CLI defaults (dropout 0.5,
    nn.Dropout): n_steps training steps on the host clock after warm-up
    (train examples/s), n_eval eval batches (predict and the rank kernel,
    eval users/s), then 5 steps under torch.profiler: the device's busy
    share and the largest device entries."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bsarec_tpu_torch.config import TrainConfig
    from bsarec_tpu_torch.models import build_model
    from bsarec_tpu_torch.ops import rank
    from bsarec_tpu_torch.train.loop import make_optimizer

    out = {}
    for i, name in enumerate(ZOO):
        mt = name.lower()
        model = build_model(zoo_config(mt, dropout=0.5),
                            generator=torch.Generator().manual_seed(i)).to(device)
        opt = make_optimizer(model.parameters(), TrainConfig(lr=LR))
        gen = torch.Generator(device=device).manual_seed(i)
        batches = [tuple(x.to(device) for x in zoo_batch(900 + j)) for j in range(n_steps)]

        def step(batch):
            model.train()
            loss = model.calculate_loss(*batch, generator=gen)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()

        for batch in batches[:3]:
            step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in batches:
            step(batch)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / n_steps
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for batch in batches[:5]:
                step(batch)
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0
        on_device = device_kernels(prof)
        busy = sum(e.self_device_time_total for e in on_device) / 1e6
        seen = rank.seen_ids_to_bitmask(torch.from_numpy(rank.dedupe_seen_rows(
            batches[0][0].cpu().numpy())).to(device), model.vocab_rows())
        users = torch.arange(EVAL_BATCH, device=device)

        @torch.inference_mode()
        def eval_batch(ids):
            model.eval()
            state = model.predict(ids, users)[:, -1, :].contiguous()
            return rank.streaming_masked_topk(state, model.item_table, seen, TOP_K, N_ITEMS)

        eval_batch(batches[0][0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(n_eval):
            eval_batch(batches[j % n_steps][0])
        torch.cuda.synchronize()
        eval_s = (time.perf_counter() - t0) / n_eval
        top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:4]
        share = f"{100 * busy / traced:.1f}%" if busy > 0 else "not measured (no device time traced)"
        log(f"zoo profile {name}: train step {1e3 * step_s:.3f} ms = {TRAIN_BATCH / step_s:.0f} "
            f"examples/s (host clock, {n_steps} steps after warm-up, nn.Dropout 0.5); eval batch "
            f"{1e3 * eval_s:.3f} ms = {EVAL_BATCH / eval_s:.0f} users/s (predict + rank kernel); "
            f"device busy {share} of 5 traced steps; top device entries "
            f"{[(e.key[:40], round(e.self_device_time_total / 5e3, 3)) for e in top]} ms/step "
            f"[{card}]")
        out[mt] = {"train_examples_per_s": TRAIN_BATCH / step_s,
                   "eval_users_per_s": EVAL_BATCH / eval_s,
                   "busy_share": busy / traced if busy > 0 else None}
        del model, opt, batches
        torch.cuda.empty_cache()
    return out


def phase_zoo_dropout(device):
    """The fused dropout kernel at Caser's fc_dropout shape and FEARec's
    attention-probability shape, against its plain version bit for bit."""
    import torch

    seeds = dropout_seeds(device, 5)
    errs = [compare_dropout(f"zoo {list(shape)}", torch.randn(shape, device=device), seeds, 0.5, c)
            for c, shape in enumerate((CASER_FC_SHAPE, DROPOUT_SHAPES["attention"]))]
    log(f"zoo dropout kernel vs plain: bit-equal at Caser's fc_dropout {list(CASER_FC_SHAPE)} "
        f"and FEARec's {list(DROPOUT_SHAPES['attention'])}")
    return max(errs)


# ---- the bf16 compute policy (--dtype bf16) ------------------------------------

BF16 = "bfloat16"
# SASRec's dropout sites under bf16: the embedding's and the attention
# probabilities' inputs stay fp32, the attention output's and the FFN's are
# bf16 Dense outputs: 1 + 2 fp32 and 2 * 2 bf16 sites a forward
DROPOUT_BF16_SITES = 4


def bf16_step(model, ids, answers, plain: bool):
    """One Adam step of a bf16 BSARec, its CE through the kernels or through
    the plain versions; returns (loss, gradients, parameters after) on the
    CPU."""
    from bsarec_tpu_torch.config import TrainConfig
    from bsarec_tpu_torch.ops import ce
    from bsarec_tpu_torch.train.loop import make_optimizer

    model.train()
    opt = make_optimizer(model.parameters(), TrainConfig(lr=LR))
    if plain:
        state = model(ids)[:, -1, :]
        loss = ce.streaming_softmax_ce_plain(state, model.item_table, answers, dtype=BF16).mean()
    else:
        loss = model.calculate_loss(ids, answers)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    grads = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    opt.step()
    params = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del opt
    return float(loss.detach()), grads, params


def phase_bf16_step(device, card):
    """Phase 5 in bf16: one Adam step of a full-width bf16 BSARec at 1M
    items through the kernels (one ce_logz and one ce_grads launch, both in
    the bf16 form on the on-chip route) against the same step through the
    plain bf16 CE on the card, from the same weights and batch, dropout 0:
    loss within CE_TOL, gradients as `zoo_grad_tolerance` holds them at
    BF16_STEP_TABLE_TOL (the item table) and BF16_STEP_GRAD_TOL (the other
    tensors), parameters within STEP_PARAM_TOL beyond Adam's share."""
    import torch

    from bsarec_tpu_torch.ops import ce

    ids, answers = random_batch(device, seed=17)
    first = full_width_model(device, dropout=0.0, loss_impl="streaming", dtype=BF16)
    start = {k: v.detach().cpu().clone() for k, v in first.state_dict().items()}
    read_rows = zoo_read_rows(first, (ids.cpu(), answers.cpu()), None)
    second = copy.deepcopy(first)
    reset_counts()
    loss, grads, params = bf16_step(first, ids, answers, plain=False)
    torch.cuda.synchronize()
    counts = read_counts() | {f"{n}_{kind}": getattr(getattr(ce, n), f"{kind}_launches")
                              for n in ("ce_logz", "ce_grads") for kind in ("onchip", "bf16")}
    del first
    want_loss, want_grads, want_params = bf16_step(second, ids, answers, plain=True)
    del second
    want = zero_counts() | {"ce_logz": 1, "ce_grads": 1, "ce_logz_onchip": 1, "ce_grads_onchip": 1,
                            "ce_logz_bf16": 1, "ce_grads_bf16": 1}
    check(counts == want, f"bf16 step launches {counts}, want {want}")
    check(math.isfinite(loss) and abs(loss - want_loss) <= CE_TOL * max(1.0, abs(want_loss)),
          f"bf16 step: loss {loss} vs {want_loss}")
    tol, grad_errs, zero = zoo_grad_tolerance(grads, want_grads, read_rows, BF16_STEP_GRAD_TOL,
                                              BF16_STEP_TABLE_TOL)
    check(grad_errs["other tensors"] <= BF16_STEP_GRAD_TOL
          and max(grad_errs["table read rows"], grad_errs["table other rows"]) <= BF16_STEP_TABLE_TOL,
          f"bf16 step: gradient errors {grad_errs} > {BF16_STEP_TABLE_TOL} (table), "
          f"{BF16_STEP_GRAD_TOL} (other tensors)")
    excess = zoo_adam_excess(start, grads, want_grads, params, want_params, tol)
    check(excess <= STEP_PARAM_TOL, f"bf16 step: parameter error beyond Adam's share {excess}")
    check(all(g.dtype == torch.float32 for g in grads.values())
          and all(v.dtype == torch.float32 for v in params.values()), "bf16 step: fp32 state")
    log(f"one Adam step in bf16, kernels vs plain bf16 CE on the card (B={TRAIN_BATCH}, V={N_ITEMS}, "
        f"H=64, dropout 0): ok, loss {loss:.6f} vs {want_loss:.6f}, gradient rel err "
        f"{ {k: float(f'{v:.3g}') for k, v in grad_errs.items()} } ({len(zero)} zero-gradient "
        f"tensors), parameters within {STEP_PARAM_TOL} beyond Adam's share (worst {excess:.3g}); "
        f"launches {counts} [{card}]")
    del grads, want_grads, params, want_params, start
    torch.cuda.empty_cache()


def bf16_counts() -> dict:
    from bsarec_tpu_torch.ops import ce, rank
    from bsarec_tpu_torch.ops import dropout as fd

    return read_counts() | {
        "ce_logz_onchip": ce.ce_logz.onchip_launches, "ce_grads_onchip": ce.ce_grads.onchip_launches,
        "ce_logz_bf16": ce.ce_logz.bf16_launches, "ce_grads_bf16": ce.ce_grads.bf16_launches,
        "rank_onchip": rank.streaming_masked_topk.onchip_launches,
        "fused_dropout_bf16": fd.fused_dropout.bf16_launches}


def zero_bf16_counts() -> dict:
    return dict.fromkeys(bf16_counts(), 0)


def phase_bf16_train(device, card):
    """The main paths under --dtype bf16 on the 1M-item x TRAIN_USERS corpus:
    BSARec at the paper widths for one epoch, then --resume to a second
    with the test pass and --export_topk (one ce_logz and one ce_grads
    launch a step, every one in the bf16 form on the on-chip route, the
    rank kernel over every eval batch, on-chip); its bf16 serving artifact
    (--export_serving), loaded on the card, whose top-20 at B=256 agrees
    with the plain version on bf16-rounded operands, one rank launch; and
    SASRec under --prng rbg with BSAREC_DROPOUT=pallas for one epoch, its
    dropout launches counted per step and by dtype. Returns the JSON
    fields."""
    import torch

    from bsarec_tpu_torch import main as port_main
    from bsarec_tpu_torch import serving
    from bsarec_tpu_torch.config import ModelConfig
    from bsarec_tpu_torch.data.corpus import Corpus
    from bsarec_tpu_torch.data.pipeline import SeqRecData
    from bsarec_tpu_torch.models import build_model
    from bsarec_tpu_torch.ops import rank, serving_topk
    from bsarec_tpu_torch.ops.precision import rounded
    from bsarec_tpu_torch.train.checkpoint import load_params

    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        seqs = synth_corpus(TRAIN_USERS, N_ITEMS, seed=1)
        with open(os.path.join(workdir, "synth_train.txt"), "w") as fh:
            for u, seq in enumerate(seqs):
                fh.write(f"{u + 1} {' '.join(map(str, seq))}\n")
        steps = math.ceil(sum(len(s[-52:-2]) for s in seqs) / TRAIN_BATCH)
        eval_steps = math.ceil(TRAIN_USERS / EVAL_BATCH)
        base = ["--data_dir", workdir, "--data_name", "synth_train", "--output_dir", workdir,
                "--device", device.type, "--batch_size", str(TRAIN_BATCH), "--dtype", "bf16"]
        bsarec = base + ["--train_name", "smoke_bf16", "--lr", str(LR), *WIDTHS]

        def run(argv, fused=False):
            reset_counts()
            t0 = time.perf_counter()
            with pallas_dropout_env(fused):
                scores = port_main.main(argv)
            torch.cuda.synchronize(device)
            check(all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in scores), f"bad scores {scores}")
            return bf16_counts(), time.perf_counter() - t0

        def epoch_lines(name):
            text = read_log(os.path.join(workdir, f"{name}.log"))
            losses = [float(x) for x in re.findall(r"'epoch': \d+, 'rec_loss': '([^']+)'", text)]
            rates = [float(x) for x in re.findall(r"epoch \d+: train (\d+) ex/s", text)]
            return text, losses, rates

        counts, seconds = run(bsarec + ["--epochs", "1"])
        ce_step = {"ce_logz": steps, "ce_grads": steps, "ce_logz_onchip": steps,
                   "ce_grads_onchip": steps, "ce_logz_bf16": steps, "ce_grads_bf16": steps}
        # every CE launch of the epoch an on-chip launch in the bf16 form:
        # ce_fwd_onchip_tc_kernel and ce_bwd_onchip_tc_kernel, the tensor cores
        for name in ("ce_logz", "ce_grads"):
            check(counts[name] == counts[f"{name}_onchip"] == counts[f"{name}_bf16"] == steps,
                  f"bf16 epoch: {counts[name]} {name} launches, {counts[f'{name}_onchip']} on-chip, "
                  f"{counts[f'{name}_bf16']} in the bf16 form; want all {steps} on the on-chip "
                  f"route's tensor-core kernels")
        want = zero_bf16_counts() | ce_step | {"streaming_masked_topk": 2 * eval_steps,
                                               "rank_onchip": 2 * eval_steps}
        check(counts == want, f"bf16 train launches {counts}, want {want}")
        text, losses, rates = epoch_lines("smoke_bf16")
        check("'dtype': 'bf16'" in text and len(losses) == 1 and math.isfinite(losses[0]),
              f"bf16 train: epoch losses {losses}")
        out["train"] = counts
        log(f"bf16 train path: main(--dtype bf16 --epochs 1) on {TRAIN_USERS} users x {N_ITEMS} "
            f"items, {steps} steps, returned in {seconds:.1f}s, epoch 0 loss {losses[0]}, train "
            f"{rates[0]:.0f} examples/s (first epoch); all {steps} ce_logz and {steps} ce_grads "
            f"launches on the on-chip route's tensor-core kernels (ce_fwd_onchip_tc_kernel, "
            f"ce_bwd_onchip_tc_kernel); launches {counts} [{card}]")

        topk_path = os.path.join(workdir, "bf16_topk.npy")
        counts, seconds = run(bsarec + ["--epochs", "2", "--resume", "--export_topk", topk_path])
        want = zero_bf16_counts() | ce_step | {"streaming_masked_topk": 3 * eval_steps,
                                               "rank_onchip": 3 * eval_steps}
        check(counts == want, f"bf16 resumed launches {counts}, want {want}")
        text, losses, rates = epoch_lines("smoke_bf16")
        check("resumed full train state" in text and len(losses) == 2
              and math.isfinite(losses[1]) and losses[1] < losses[0],
              f"bf16 resumed run: epoch losses {losses}, want a second, lower one")
        topk = np.load(topk_path)
        check(topk.shape == (TRAIN_USERS, TOP_K) and 0 <= int(topk.min())
              and int(topk.max()) < N_ITEMS, "bf16 export after fit")
        log(f"bf16 train path: main(--resume --epochs 2 --export_topk) returned in {seconds:.1f}s, "
            f"epoch losses {losses}, train {rates[-1]:.0f} examples/s (second epoch); launches "
            f"{counts} [{card}]")

        # the bf16 serving artifact of that model
        path = os.path.join(workdir, "scorer_bf16.pt2")
        counts, seconds = run(base + ["--train_name", "smoke_bf16_serving", "--do_eval",
                                      "--load_model", "smoke_bf16", "--export_serving", path,
                                      *WIDTHS])
        check(counts == zero_bf16_counts() | {"streaming_masked_topk": eval_steps,
                                              "rank_onchip": eval_steps},
              f"bf16 serving export launches {counts}")
        scorer = serving.load_scorer(path, device.type)
        check(scorer.meta["dtype"] == BF16 and scorer.meta["impl"] == "bitmask",
              f"bf16 artifact metadata {scorer.meta}")
        test = SeqRecData(Corpus(user_seq=seqs, max_item=N_ITEMS - 1), max_len=50).test
        ids, seen = test.input_ids[:EVAL_BATCH], test.seen_items[:EVAL_BATCH]
        reset_counts()
        got = scorer.topk(ids, None, seen)
        counts = bf16_counts()
        check(counts == zero_bf16_counts() | {"streaming_masked_topk": 1, "rank_onchip": 1},
              f"the bf16 artifact call at B=256: launches {counts}, want one on-chip rank launch")
        out["serving"] = counts
        cfg = ModelConfig(model_type="bsarec", item_size=N_ITEMS, num_users=TRAIN_USERS + 1,
                          max_seq_length=50, hidden_size=64, num_hidden_layers=2,
                          num_attention_heads=1, c=5, alpha=0.7, compute_dtype=BF16)
        model = build_model(cfg)
        model.load_state_dict(load_params(os.path.join(workdir, "smoke_bf16.ckpt")))
        model.to(device).eval()
        with torch.inference_mode():
            states = rounded(model.predict(torch.from_numpy(ids).long().to(device))[:, -1, :],
                             True).contiguous()
            table = rounded(model.item_table, True)
            bitmask = serving_topk.seen_bitmask(torch.from_numpy(seen).to(device), N_ITEMS)
            want_v, _ = rank.streaming_masked_topk_plain(states, table, bitmask, TOP_K, N_ITEMS,
                                                         seen_value=-math.inf)
            by_id = masked_scores(states, table, bitmask, N_ITEMS,
                                  torch.from_numpy(got).to(device), -math.inf)
        check(bool(torch.isfinite(want_v).all()), "every row has 20 unmasked items")
        err = float((by_id - want_v).abs().max())
        check(err <= FLOAT_TOL, f"bf16 artifact top-20 at B=256: score error {err} > {FLOAT_TOL}")
        out["serving_max_abs_err"] = err
        log(f"bf16 serving path: main(--dtype bf16 --do_eval --export_serving) returned in "
            f"{seconds:.1f}s; the artifact's top-20 at B={EVAL_BATCH} scored by the plain version "
            f"on bf16-rounded states and table within {err:.3g} of its top-20 values; one on-chip "
            f"rank launch [{card}]")
        del model, states, table, bitmask, scorer

        # SASRec on the fused dropout kernel, bf16 sites included
        counts, seconds = run(base + ["--train_name", "sasrec_bf16", "--model_type", "SASRec",
                                      "--prng", "rbg", "--lr", str(SASREC_LR), "--epochs", "1"],
                              fused=True)
        want = zero_bf16_counts() | {
            "fused_dropout": 2 * DROPOUT_SITES * steps,
            "fused_dropout_bf16": 2 * DROPOUT_BF16_SITES * steps,
            "streaming_masked_topk": 2 * eval_steps, "rank_onchip": 2 * eval_steps}
        check(counts == want, f"bf16 SASRec launches {counts}, want {want}")
        text, losses, rates = epoch_lines("sasrec_bf16")
        check("dropout: fused kernel" in text and len(losses) == 1 and math.isfinite(losses[0]),
              f"bf16 SASRec: epoch losses {losses}")
        out["sasrec"] = counts
        log(f"bf16 SASRec path: main(--dtype bf16 --model_type SASRec --prng rbg, "
            f"BSAREC_DROPOUT=pallas, --epochs 1) returned in {seconds:.1f}s, epoch 0 loss "
            f"{losses[0]}, train {rates[0]:.0f} examples/s; launches {counts}: "
            f"{2 * DROPOUT_SITES} dropout launches a step, {2 * DROPOUT_BF16_SITES} of them on "
            f"bf16 tensors [{card}]")
    torch.cuda.empty_cache()
    return out


def phase_bf16_train_turns(device, card, n_steps: int = 20):
    """BSARec's training step at full width and 1M items (dropout 0.5),
    fp32 against bf16 in turns (fp32, bf16, bf16, fp32) on one set of
    batches: examples/s over n_steps steps on the host clock, then the
    device's busy share over a 5-step window under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bsarec_tpu_torch.config import TrainConfig
    from bsarec_tpu_torch.train.loop import make_optimizer

    batches = [random_batch(device, seed=3000 + i) for i in range(n_steps)]
    runs = {}
    for dt in ("float32", BF16):
        model = full_width_model(device, dropout=0.5, loss_impl="streaming", dtype=dt)
        runs[dt] = (model, make_optimizer(model.parameters(), TrainConfig(lr=LR)))

    def step(dt, ids, answers):
        model, opt = runs[dt]
        model.train()
        loss = model.calculate_loss(ids, answers)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()

    def measure(dt):
        for ids, answers in batches[:2]:
            step(dt, ids, answers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for ids, answers in batches:
            step(dt, ids, answers)
        torch.cuda.synchronize()
        rate = TRAIN_BATCH * n_steps / (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for ids, answers in batches[:5]:
                step(dt, ids, answers)
            torch.cuda.synchronize()
            traced = time.perf_counter() - t0
        busy = sum(e.self_device_time_total for e in device_kernels(prof)) / 1e6
        return rate, (busy / traced if busy > 0 else None)

    (f1, f2), (b1, b2) = in_turns("float32", BF16, measure)

    def fmt(r):
        return f"{r[0]:.1f} examples/s, busy " + ("not measured" if r[1] is None
                                                  else f"{100 * r[1]:.1f}%")
    log(f"train step bf16 vs fp32 (BSARec, B={TRAIN_BATCH}, V={N_ITEMS}, dropout 0.5; turns fp32, "
        f"bf16, bf16, fp32): fp32 {fmt(f1)} / {fmt(f2)}; bf16 {fmt(b1)} / {fmt(b2)} [{card}]")
    del runs, batches
    torch.cuda.empty_cache()
    return {"fp32": [f1, f2], "bf16": [b1, b2]}


# ---- the wide routes (H > 256) ---------------------------------------------------

# BSARec at hidden 512 (the paper's other widths), the width the wide
# phase trains and ranks at over 1M items, on a corpus of WIDE_USERS users
# from synth_corpus: half of phase 7's users, so that the phase's three runs
# of main stay near two minutes (a step at H = 512 runs ~40 ms of CE kernels)
WIDE_H = 512
WIDE_USERS = 2_500  # 5,000 before the middle route's phase: its runs' time
WIDE_WIDTHS = ["--model_type", "BSARec", "--hidden_size", str(WIDE_H), "--num_hidden_layers", "2",
               "--num_attention_heads", "1", "--c", "5", "--alpha", "0.7", "--max_seq_length", "50"]
# the wide phase's CE cases, the i-th on ce_case's inputs seeded with 200 + i:
# (tag, B, V, H, n_valid, answers). H = 260 is just past the older routes
# and no multiple of 128; B = 300 takes two groups of batch rows. The bf16
# form's gradients are held against parity.ce_grads_bf16_in_order within
# parity.BF16_WIDE_GRAD_TOL: at these widths the fp32 rounding of an H-term
# logit, which the tensor cores sum in their own order, moves single bf16
# roundings of p (parity.py's head)
WIDE_CE_CASES = [
    ("main path at H=512", 256, N_ITEMS, WIDE_H, N_ITEMS, "plain"),
    ("H=260, odd B, n_valid < V, odd answers", 37, 5000, 260, 4990, "odd"),
    ("H=384, B over one group, n_valid < V", 300, 20011, 384, 20006, "odd"),
    ("H=512, V off every tile", 3, 12101, WIDE_H, 12101, "odd"),
    ("H=512, repeated answers", 200, 3001, WIDE_H, 3001, "repeated"),
    ("H=1024, n_valid < V", 256, 40009, 1024, 40000, "odd"),
]
# ... and on parity.exact_logit_case's inputs, the i-th seeded with 400 + i:
# (tag, B, V, H, n_valid). Every logit is exact there in any summation
# order, so the bf16 form is held within parity.BF16_GRAD_TOL
WIDE_EXACT_CASES = [
    ("exact logits at the main path's shape", 256, N_ITEMS, WIDE_H, N_ITEMS),
    ("exact logits, H=260, odd B, n_valid < V", 37, 5000, 260, 4990),
    ("exact logits, H=512, B over one group, n_valid < V", 300, 20011, WIDE_H, 20006),
    ("exact logits, H=1024, odd B, n_valid < V", 37, 12101, 1024, 12000),
]
# the wide phase's rank cases, the i-th on make_case's inputs seeded with
# 300 + i: (tag, B, V, H, k, n_valid, seen per row, integer, all-seen row).
# Float cases draw the table at sqrt(64 / H) N(0, 1), so that the scores
# keep the spread they have at phase 2's H = 64 (std 8, top scores below
# ~50), for which FLOAT_TOL is stated; the integer cases are exact at any H
# and in any summation order. At k <= 32 every case takes the tensor-core
# route (rank_wide_tf32_kernel), at k > 32 the older route; the cases from
# "B over one group" on hold the tensor-core route's edges: two groups of
# 256 rows, B = 1, k = 1 and 32 against k = 33, H off its 16-column step,
# fewer valid items than k, an all-seen row (serving mode: all -inf)
WIDE_RANK_CASES = [
    ("main path at H=512", 256, N_ITEMS, WIDE_H, TOP_K, N_ITEMS, 16, False, False),
    ("H=512, k=128", 64, 33333, WIDE_H, 128, 33333, 16, False, False),
    ("H=1024, odd B, V off the tile", 5, 12101, 1024, 20, 12101, 16, False, False),
    ("integer, H=512, k=20", 37, 20011, WIDE_H, 20, 20006, 16, True, False),
    ("integer, H=512, k=128", 37, 20011, WIDE_H, 128, 20006, 16, True, False),
    ("integer, all-seen row, H=1024, k=20", 70, 20011, 1024, 20, 20011, 16, True, True),
    ("integer, H=1024, k=128", 37, 20011, 1024, 128, 20006, 16, True, True),
    ("B over one group, n_valid < V", 300, 20011, WIDE_H, 20, 20006, 16, False, False),
    ("integer, all-seen row, B over one group, n_valid < V", 300, 20011, WIDE_H, 20, 20006, 16,
     True, True),
    ("B=1", 1, 12101, WIDE_H, 20, 12101, 16, False, False),
    ("integer, B=1", 1, 12101, WIDE_H, 20, 12101, 16, True, False),
    ("k=32", 256, 40009, WIDE_H, 32, 40000, 16, False, False),
    ("integer, k=1", 37, 20011, WIDE_H, 1, 20006, 16, True, False),
    ("integer, k=32", 37, 20011, WIDE_H, 32, 20006, 16, True, True),
    ("integer, k=33 (the older route)", 37, 20011, WIDE_H, 33, 20006, 16, True, False),
    ("H=260, off the 16-column step", 37, 20011, 260, 20, 20006, 16, False, False),
    ("integer, H=260", 37, 20011, 260, 20, 20006, 16, True, False),
    ("n_valid < k", 5, 300, WIDE_H, 20, 10, 4, False, False),
    ("all-seen row", 9, 4099, WIDE_H, 20, 4099, 16, False, True),
]


def eval_passes(text: str) -> list[float]:
    """The seconds of each eval pass that a `main` log records."""
    return [float(x) for x in re.findall(r"eval (?:valid|test): \d+ users in ([0-9.]+)s", text)]


def wide_counts() -> dict:
    from bsarec_tpu_torch.ops import ce, rank

    return read_counts() | {
        "ce_logz_wide": ce.ce_logz.wide_launches, "ce_grads_wide": ce.ce_grads.wide_launches,
        "ce_logz_bf16": ce.ce_logz.bf16_launches, "ce_grads_bf16": ce.ce_grads.bf16_launches,
        "rank_wide": rank.streaming_masked_topk.wide_launches,
        "rank_tc": rank.streaming_masked_topk.tc_launches,
        "rank_onchip": rank.streaming_masked_topk.onchip_launches}


def zero_wide_counts() -> dict:
    return dict.fromkeys(wide_counts(), 0)


def phase_wide_kernels(device):
    """The CE kernels in both forms at WIDE_CE_CASES and WIDE_EXACT_CASES
    and the rank kernel in both modes at WIDE_RANK_CASES, against their
    plain versions with phase 3's and phase 2's checks. Returns ({form:
    {kernel: largest absolute error}}, the largest rank value error, the CE
    and rank main-shape inputs)."""
    import torch

    from bsarec_tpu_torch import parity

    worst = {form: {"ce_logz": 0.0, "gold_rows": 0.0, "ce_grads": 0.0} for form in CE_FORMS}
    ce_full = rank_full = None
    for i, (tag, b, v, h, n_valid, kind) in enumerate(WIDE_CE_CASES):
        states, table, answers = ce_case(b, v, h, n_valid, seed=200 + i, device=device,
                                         answer_kind=kind)
        for form in CE_FORMS:
            errs = compare_ce(f"{tag} (B={b} V={v} H={h} n_valid={n_valid})", states, table,
                              answers, n_valid, dtype=form, in_order=True)
            worst[form] = {k: max(worst[form][k], errs[k]) for k in errs}
        if i == 0:
            ce_full = (states, table, answers)
        del states, table, answers
        torch.cuda.empty_cache()
    for i, (tag, b, v, h, n_valid) in enumerate(WIDE_EXACT_CASES):
        states, table, answers, _ = parity.exact_logit_case(b, v, h, n_valid, seed=400 + i,
                                                            device=device)
        for form in CE_FORMS:
            errs = compare_ce(f"{tag} (B={b} V={v} H={h} n_valid={n_valid})", states, table,
                              answers, n_valid, dtype=form, in_order=True, exact=True)
            worst[form] = {k: max(worst[form][k], errs[k]) for k in errs}
        del states, table, answers
        torch.cuda.empty_cache()
    rank_worst = 0.0
    for i, (tag, b, v, h, k, n_valid, n_seen, integer, all_seen) in enumerate(WIDE_RANK_CASES):
        name = f"{tag} (B={b} V={v} H={h} k={k} n_valid={n_valid})"
        states, table, bitmask = make_case(b, v, h, n_seen, seed=300 + i, device=device,
                                           integer=integer, all_seen_row=all_seen,
                                           scale=math.sqrt(64 / h))
        for seen_value in (0.0, -math.inf):
            rank_worst = max(rank_worst, compare_kernel(name, states, table, bitmask, k, n_valid,
                                                        integer, seen_value))
        if i == 0:
            rank_full = (states, table, bitmask)
        del states, table, bitmask
    torch.cuda.empty_cache()
    return worst, rank_worst, ce_full, rank_full


def phase_wide_train(device, card):
    """`main --hidden_size 512` on the 1M-item x WIDE_USERS corpus: one epoch,
    then --resume --epochs 2 --export_topk, which must start at epoch 1;
    then one --dtype bf16 epoch. Every step one ce_logz and one ce_grads
    launch, every one on the wide route (in the bf16 form under --dtype
    bf16), the rank kernel on every eval batch, every epoch's loss finite,
    and the first 512 users' exported top-20 against the plain version.
    Returns {run: launch counts}."""
    import torch

    from bsarec_tpu_torch import main as port_main
    from bsarec_tpu_torch.config import ModelConfig
    from bsarec_tpu_torch.data.corpus import Corpus
    from bsarec_tpu_torch.data.pipeline import SeqRecData
    from bsarec_tpu_torch.models import build_model
    from bsarec_tpu_torch.ops import rank
    from bsarec_tpu_torch.train.checkpoint import load_params

    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        seqs = synth_corpus(WIDE_USERS, N_ITEMS, seed=1)
        with open(os.path.join(workdir, "synth_wide.txt"), "w") as fh:
            for u, seq in enumerate(seqs):
                fh.write(f"{u + 1} {' '.join(map(str, seq))}\n")
        steps = math.ceil(sum(len(s[-52:-2]) for s in seqs) / TRAIN_BATCH)
        eval_steps = math.ceil(WIDE_USERS / EVAL_BATCH)
        base = ["--data_dir", workdir, "--data_name", "synth_wide", "--output_dir", workdir,
                "--device", device.type, "--batch_size", str(TRAIN_BATCH), "--lr", str(LR),
                *WIDE_WIDTHS]

        def run(argv):
            reset_counts()
            t0 = time.perf_counter()
            scores = port_main.main(argv)
            torch.cuda.synchronize(device)
            counts = wide_counts()
            check(all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in scores), f"bad scores {scores}")
            return counts, scores, time.perf_counter() - t0

        def epoch_lines(name):
            text = read_log(os.path.join(workdir, f"{name}.log"))
            losses = [float(x) for x in re.findall(r"'epoch': \d+, 'rec_loss': '([^']+)'", text)]
            rates = [float(x) for x in re.findall(r"epoch \d+: train (\d+) ex/s", text)]
            return text, losses, rates

        # the rank kernel at H = 512, k = 20 on every eval batch (the last
        # one 136 rows) on its tensor-core route, rank_wide_tf32_kernel (in
        # both forms: under bf16 it ranks rounded operands in fp32); every
        # CE launch on the wide route, where each form runs its tensor-core
        # kernels (fp32: ce_fwd_wide_tf32_kernel and ce_bwd_wide_tf32_kernel)
        def rank_route(n):
            return {"streaming_masked_topk": n, "rank_tc": n, "rank_wide": 0, "rank_onchip": 0}

        ce_step = {"ce_logz": steps, "ce_grads": steps, "ce_logz_wide": steps,
                   "ce_grads_wide": steps}
        counts, scores, seconds = run(base + ["--train_name", "smoke_wide", "--epochs", "1"])
        want = zero_wide_counts() | ce_step | rank_route(2 * eval_steps)
        check(counts == want, f"wide train launches {counts}, want {want}")
        text, losses, rates = epoch_lines("smoke_wide")
        check(len(losses) == 1 and math.isfinite(losses[0]), f"wide train: epoch losses {losses}")
        out["train"] = counts
        # the eval passes (validation, then test), each 20 rank launches
        out["eval_s"] = eval_passes(text)
        log(f"wide train path: main(--hidden_size {WIDE_H} --epochs 1) on {WIDE_USERS} users x "
            f"{N_ITEMS} items, {steps} steps, returned in {seconds:.1f}s, epoch 0 loss {losses[0]}, "
            f"train {rates[0]:.0f} examples/s (first epoch), eval passes {out['eval_s']} s "
            f"(valid, test; {WIDE_USERS} users each), test scores {scores}; launches "
            f"{counts}, every CE launch on the fp32 tensor-core kernels, every rank launch on "
            f"rank_wide_tf32_kernel [{card}]")

        topk_path = os.path.join(workdir, "wide_topk.npy")
        counts, scores, seconds = run(base + ["--train_name", "smoke_wide", "--epochs", "2",
                                              "--resume", "--export_topk", topk_path])
        want = zero_wide_counts() | ce_step | rank_route(3 * eval_steps)
        check(counts == want, f"wide resumed launches {counts}, want {want}")
        text, losses, rates = epoch_lines("smoke_wide")
        check("resumed full train state" in text and "(epoch 0)" in text and "'epoch': 1," in text
              and len(losses) == 2 and all(math.isfinite(x) for x in losses),
              f"wide resumed run: epoch losses {losses}, want epoch 1 after the resume")
        out["resume"] = counts
        log(f"wide train path: main(--resume --epochs 2 --export_topk) started at epoch 1 and "
            f"returned in {seconds:.1f}s, epoch losses {losses}, train {rates[-1]:.0f} examples/s "
            f"(second epoch), test scores {scores}; launches {counts}, every CE launch on the fp32 "
            f"tensor-core kernels, every rank launch on rank_wide_tf32_kernel [{card}]")

        # the first 512 users' exported top-20 against the plain version, on
        # the best checkpoint that the export ranked with
        topk = np.load(topk_path)
        check(topk.shape == (WIDE_USERS, TOP_K) and 0 <= int(topk.min())
              and int(topk.max()) < N_ITEMS, "wide export after fit")
        head = SeqRecData(Corpus(user_seq=seqs[:512], max_item=N_ITEMS - 1), max_len=50).test
        cfg = ModelConfig(model_type="bsarec", item_size=N_ITEMS, num_users=WIDE_USERS + 1,
                          max_seq_length=50, hidden_size=WIDE_H, num_hidden_layers=2,
                          num_attention_heads=1, c=5, alpha=0.7)
        model = build_model(cfg)
        model.load_state_dict(load_params(os.path.join(workdir, "smoke_wide.ckpt")))
        model.to(device).eval()
        with torch.inference_mode():
            states = model.predict(torch.from_numpy(head.input_ids).long().to(device))[:, -1, :]
            table = model.item_table
            bitmask = torch.from_numpy(rank.build_seen_bitmask(head.seen_items, N_ITEMS)).to(device)
            want_v, _ = rank.streaming_masked_topk_plain(states, table, bitmask, TOP_K, N_ITEMS)
            got = masked_scores(states, table, bitmask, N_ITEMS,
                                torch.from_numpy(topk[:512]).to(device))
        err = float((got - want_v).abs().max())
        check(err <= FLOAT_TOL, f"wide export: first 512 users' top-20 score error {err}")
        log(f"wide train path: the first 512 users' exported top-20 agree with the plain version "
            f"(score error {err:.3g}, largest |score| {float(want_v.abs().max()):.3g})")
        del model, states, table, bitmask

        counts, scores, seconds = run(base + ["--train_name", "smoke_wide_bf16", "--epochs", "1",
                                              "--dtype", "bf16"])
        want = zero_wide_counts() | ce_step | rank_route(2 * eval_steps) | {
            "ce_logz_bf16": steps, "ce_grads_bf16": steps}
        check(counts == want, f"wide bf16 train launches {counts}, want {want}")
        text, losses, rates = epoch_lines("smoke_wide_bf16")
        check("'dtype': 'bf16'" in text and len(losses) == 1 and math.isfinite(losses[0]),
              f"wide bf16 train: epoch losses {losses}")
        out["bf16"] = counts
        log(f"wide bf16 train path: main(--hidden_size {WIDE_H} --dtype bf16 --epochs 1) returned "
            f"in {seconds:.1f}s, epoch 0 loss {losses[0]}, train {rates[0]:.0f} examples/s, eval "
            f"passes {eval_passes(text)} s (valid, test), test scores {scores}; launches {counts}, "
            f"every rank launch on rank_wide_tf32_kernel [{card}]")
    torch.cuda.empty_cache()
    return out


def wide_rank_times(rank_full, card, b):
    """The rank kernel at H=512, k=20 on the first b rows of the main wide
    case: the kernel (its tensor-core route) and its older route in turns
    (kernel, older, older, kernel), the plain version, the library call and
    the bound (3xTF32 at the dense TF32 rate, or the bytes; the same work
    in fp32 FMAs on the bound line only). Returns the JSON fields."""
    import torch

    from bsarec_tpu_torch.ops import rank

    full_states, table, full_mask = rank_full
    states, bitmask = full_states[:b].contiguous(), full_mask[:b].contiguous()
    h, v, k = states.shape[1], table.shape[0], TOP_K
    check(rank.tc_route(b, h, k), f"the rank kernel's tensor-core route at B={b} H={h} k={k}")
    kernel = lambda: rank.streaming_masked_topk(states, table, bitmask, k, v)
    older = lambda: rank._launch(states, table, bitmask, k, v, allow_tc=False)
    ms1, old1, old2, ms2 = (cuda_ms(fn, iters=10) for fn in (kernel, older, older, kernel))
    plain_ms = cuda_ms(lambda: rank.streaming_masked_topk_plain(states, table, bitmask, k, v),
                       iters=3, warmup=1)
    # yardstick only (the port never calls it), as phase_times builds it
    cols = torch.arange(v, device=states.device)
    seen = ((bitmask[:, cols >> 5] >> (cols & 31).int()) & 1).bool()
    library_ms = cuda_ms(lambda: torch.topk(torch.matmul(states, table.T).masked_fill_(seen, 0.0), k),
                         iters=5)
    del seen, cols
    flops = 2 * b * v * h
    nbytes = 4 * (b * h + v * h + bitmask.numel()) + 8 * b * k
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    ms = (ms1 + ms2) / 2
    for name, t in (("kernel (rank_wide_tf32_kernel)", pair([ms1, ms2])),
                    ("kernel, older route (rank_partial_kernel)", pair([old1, old2])),
                    ("plain version", f"{plain_ms:.4f}"),
                    ("library matmul+masked_fill+topk", f"{library_ms:.4f}")):
        log(f"time streaming_masked_topk at H={h} {name}: {t} ms per {b}-user batch (B={b} V={v} "
            f"H={h} k={k}; the kernel and the older route in turns) [{card}]")
    log(f"bound streaming_masked_topk at H={h}, B={b}: {bound_ms:.4f} ms ({bound_by}: 3 x "
        f"{flops / 1e9:.2f} GFLOP in 3xTF32 at 495 TFLOP/s = {t_ops:.4f} ms; {nbytes / 1e6:.1f} MB "
        f"at 3.35 TB/s = {t_bytes:.4f} ms; the same work in fp32 FMAs at 67 TFLOP/s = "
        f"{flops / PEAK_FP32_FLOPS * 1e3:.4f} ms) -> kernel at {100 * bound_ms / ms:.1f}% of the "
        f"bound, {ms / library_ms:.3f}x the library call, the older route {(old1 + old2) / 2 / ms:.2f}x "
        f"the kernel [{card}]")
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "readings_ms": [ms1, ms2], "older_route_ms": [old1, old2]}


def phase_wide_times(ce_full, rank_full, card):
    """The wide main path's kernels at B=256, V=1M, H=512: the CE entries in
    both forms (phase_ce_times), the rank kernel at k=20 (its tensor-core
    route, at B=256 and B=16, wide_rank_times) and at k=128 (the older
    route's wide form). Each with its plain version, a library yardstick
    and its bound. Returns {entry: JSON fields}."""
    import torch

    from bsarec_tpu_torch.ops import rank

    ce32 = phase_ce_times(ce_full, card)
    ce16 = phase_ce_times(ce_full, card, BF16)
    rank20 = wide_rank_times(rank_full, card, rank_full[0].shape[0])
    rank20["b16"] = wide_rank_times(rank_full, card, 16)
    states, table, bitmask = rank_full
    b, h = states.shape
    v, k = table.shape[0], 128
    check(rank.wide_route(h, k) and not rank.tc_route(b, h, k) and not rank.wide_route(h, TOP_K),
          "rank routes at H=512")
    ms = cuda_ms(lambda: rank.streaming_masked_topk(states, table, bitmask, k, v), iters=10)
    plain_ms = cuda_ms(lambda: rank.streaming_masked_topk_plain(states, table, bitmask, k, v),
                       iters=2, warmup=1)
    cols = torch.arange(v, device=states.device)
    seen = ((bitmask[:, cols >> 5] >> (cols & 31).int()) & 1).bool()
    library_ms = cuda_ms(lambda: torch.topk(torch.matmul(states, table.T).masked_fill_(seen, 0.0), k),
                         iters=5)
    flops = 2 * b * v * h
    bound_ms = flops / PEAK_FP32_FLOPS * 1e3
    log(f"time streaming_masked_topk k=128 (older route, states in hidden chunks): kernel "
        f"{ms:.4f} ms, plain version {plain_ms:.4f} ms, library matmul+masked_fill+topk "
        f"{library_ms:.4f} ms; bound {bound_ms:.4f} ms (operations: {flops / 1e9:.2f} GFLOP fp32 at "
        f"67 TFLOP/s) -> kernel at {100 * bound_ms / ms:.1f}% of the bound (B={b} V={v} H={h}) "
        f"[{card}]")
    del seen, cols
    torch.cuda.empty_cache()
    rank20["k128"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": "operations", "library_ms": library_ms}
    return {"ce32": ce32, "ce16": ce16, "rank": rank20}



# ---- the middle route: the bf16 form at B <= 256, 64 < H <= 256 -------------

MID_H = 256
MID_USERS = 5_000
MID_WIDTHS = ["--model_type", "BSARec", "--hidden_size", str(MID_H), "--num_hidden_layers", "2",
              "--num_attention_heads", "1", "--c", "5", "--alpha", "0.7", "--max_seq_length", "50"]
# the middle route's CE cases, the i-th on ce_case's inputs seeded with
# 600 + i: (tag, B, V, H, n_valid, answers). In the bf16 form the first four
# take ce_fwd_mid_tc_kernel and ce_bwd_mid_tc_kernel, held as the on-chip
# route's tensor-core pair (compare_ce); in the fp32 form they take
# ce_fwd_mid_tf32_kernel and ce_bwd_wide_tf32_kernel, logZ and loss within
# CE_TOL of the plain fp32 version, the gradients within GRAD_TOL
# (parity.WIDE_GRAD_TOL), two calls bit-equal; the last two, at B > 256,
# the older sweeps in both forms (ce_fwd_partial_kernel,
# ce_bwd_sweep_kernel), the bf16 form's held within BF16_GRAD_TOL of the
# plain bf16 version with the fp32 control failing
MID_CE_CASES = [
    ("main path at H=256", 256, N_ITEMS, MID_H, N_ITEMS, "plain"),
    ("H=128, B=255, BERT4Rec's table, n_valid = V - 1", 255, N_ITEMS + 1, 128, N_ITEMS, "odd"),
    ("H=68, B=1, V off every tile", 1, 12101, 68, 12101, "odd"),
    ("H=192, B=3, n_valid < V, repeated answers", 3, 4099, 192, 4000, "repeated"),
    ("H=128, B=300, past the middle route", 300, 30011, 128, 30011, "odd"),
    ("H=256, B=257, past the middle route, n_valid < V", 257, 40009, MID_H, 40000, "odd"),
]
# ... and on parity.exact_logit_case's inputs (scale 1), the i-th seeded with
# 700 + i: (tag, B, V, H, n_valid). The sharp check: the bf16 form within
# parity.BF16_GRAD_TOL, which the fp32 form must fail
MID_EXACT_CASES = [
    ("exact logits at the main path's shape", 256, N_ITEMS, MID_H, N_ITEMS),
    ("exact logits, H=128", 256, 20011, 128, 20011),
    ("exact logits, H=256, n_valid < V", 256, 20011, MID_H, 20000),
    ("exact logits, H=192, odd B, n_valid < V", 37, 5000, 192, 4990),
    ("exact logits, H=128, B=12, n_valid < V", 12, 300, 128, 290),
    ("exact logits, H=256, B=5, V one past a tile", 5, 257, MID_H, 257),
]


def mid_counts() -> dict:
    from bsarec_tpu_torch.ops import ce, rank

    return read_counts() | {
        "ce_logz_mid": ce.ce_logz.mid_launches, "ce_grads_mid": ce.ce_grads.mid_launches,
        "ce_logz_mid_tf32": ce.ce_logz.mid_tf32_launches,
        "ce_grads_mid_tf32": ce.ce_grads.mid_tf32_launches,
        "ce_logz_bf16": ce.ce_logz.bf16_launches, "ce_grads_bf16": ce.ce_grads.bf16_launches,
        "ce_logz_onchip": ce.ce_logz.onchip_launches, "ce_grads_onchip": ce.ce_grads.onchip_launches,
        "ce_logz_wide": ce.ce_logz.wide_launches, "ce_grads_wide": ce.ce_grads.wide_launches,
        "rank_onchip": rank.streaming_masked_topk.onchip_launches,
        "rank_tc": rank.streaming_masked_topk.tc_launches,
        "rank_wide": rank.streaming_masked_topk.wide_launches}


def phase_mid_kernels(device):
    """The CE kernels in both forms at MID_CE_CASES and MID_EXACT_CASES
    against their plain versions with phase 3's checks (compare_ce): in the
    bf16 form the middle route's mma.sync pair, in the fp32 form
    ce_fwd_mid_tf32_kernel (wgmma) and ce_bwd_wide_tf32_kernel; then both
    forms at the main shape at H = 128 (B=256, V=1M), the inputs the
    entries are timed on. Returns ({form: {kernel: largest absolute error
    on the middle route's shapes}}, {H: the main-shape inputs at B=256,
    V=1M} for H in {128, 256})."""
    import torch

    from bsarec_tpu_torch import parity
    from bsarec_tpu_torch.ops import ce

    worst = {form: {"ce_logz": 0.0, "gold_rows": 0.0, "ce_grads": 0.0} for form in CE_FORMS}
    full = {}
    for i, (tag, b, v, h, n_valid, kind) in enumerate(MID_CE_CASES):
        states, table, answers = ce_case(b, v, h, n_valid, seed=600 + i, device=device,
                                         answer_kind=kind)
        for form in CE_FORMS:
            errs = compare_ce(f"{tag} (B={b} V={v} H={h} n_valid={n_valid})", states, table,
                              answers, n_valid, dtype=form)
            if ce.mid_route(b, h):  # (the cases past the route run the older sweeps)
                worst[form] = {k: max(worst[form][k], errs[k]) for k in errs}
        if i == 0:
            full[MID_H] = (states, table, answers)
        del states, table, answers
        torch.cuda.empty_cache()
    for i, (tag, b, v, h, n_valid) in enumerate(MID_EXACT_CASES):
        states, table, answers, _ = parity.exact_logit_case(b, v, h, n_valid, seed=700 + i,
                                                            device=device)
        for form in CE_FORMS:
            errs = compare_ce(f"{tag} (B={b} V={v} H={h} n_valid={n_valid})", states, table,
                              answers, n_valid, dtype=form, exact=True)
            worst[form] = {k: max(worst[form][k], errs[k]) for k in errs}
        del states, table, answers
        torch.cuda.empty_cache()
    full[128] = ce_case(TRAIN_BATCH, N_ITEMS, 128, N_ITEMS, seed=600, device=device,
                        answer_kind="plain")
    for form in CE_FORMS:
        errs = compare_ce(f"main shape at H=128 (B={TRAIN_BATCH} V={N_ITEMS} H=128 "
                          f"n_valid={N_ITEMS})", *full[128], N_ITEMS, dtype=form)
        worst[form] = {k: max(worst[form][k], errs[k]) for k in errs}
    torch.cuda.empty_cache()
    return worst, full


def phase_mid_train(device, card):
    """`main --hidden_size 256 --dtype bf16` (BSARec, 2 layers, 1 head,
    c=5, alpha=0.7, max_len 50) on a 1M-item x MID_USERS corpus: one epoch,
    every ce_logz and ce_grads launch on the middle route's tensor-core
    kernels (ce_fwd_mid_tc_kernel, ce_bwd_mid_tc_kernel), the rank kernel on
    every eval batch; then `--do_eval --load_model --export_topk` (the test
    pass and the export on the rank kernel's older route at this width, no
    CE launch); then one fp32 epoch (main's default --dtype) on the same
    corpus, every ce_logz launch on ce_fwd_mid_tf32_kernel and every
    ce_grads launch on ce_bwd_wide_tf32_kernel. Returns {run: launch counts,
    "examples_per_s": the bf16 epoch's rate, "examples_per_s_fp32": the
    fp32 epoch's}."""
    import torch

    from bsarec_tpu_torch import main as port_main
    from bsarec_tpu_torch.ops import rank

    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        seqs = synth_corpus(MID_USERS, N_ITEMS, seed=2)
        with open(os.path.join(workdir, "synth_mid.txt"), "w") as fh:
            for u, seq in enumerate(seqs):
                fh.write(f"{u + 1} {' '.join(map(str, seq))}\n")
        steps = math.ceil(sum(len(s[-52:-2]) for s in seqs) / TRAIN_BATCH)
        eval_steps = math.ceil(MID_USERS / EVAL_BATCH)
        base = ["--data_dir", workdir, "--data_name", "synth_mid", "--output_dir", workdir,
                "--device", device.type, "--batch_size", str(TRAIN_BATCH), "--lr", str(LR),
                "--dtype", "bf16", *MID_WIDTHS]

        def run(argv):
            reset_counts()
            t0 = time.perf_counter()
            scores = port_main.main(argv)
            torch.cuda.synchronize(device)
            counts = mid_counts()
            check(all(math.isfinite(x) and 0.0 <= x <= 1.0 for x in scores), f"bad scores {scores}")
            return counts, scores, time.perf_counter() - t0

        # the rank kernel at H = 256, k = 20: its older route (rank_partial_kernel,
        # in the form its shared memory takes)
        def rank_route(n):
            return {"streaming_masked_topk": n, "rank_tc": 0, "rank_onchip": 0,
                    "rank_wide": n * rank.wide_route(MID_H, TOP_K)}

        counts, scores, seconds = run(base + ["--train_name", "smoke_mid", "--epochs", "1"])
        ce_step = {f"{name}{route}": steps for name in ("ce_logz", "ce_grads")
                   for route in ("", "_mid", "_bf16")}
        want = dict.fromkeys(mid_counts(), 0) | ce_step | rank_route(2 * eval_steps)
        check(counts == want, f"middle-route train launches {counts}, want {want}")
        text = read_log(os.path.join(workdir, "smoke_mid.log"))
        losses = [float(x) for x in re.findall(r"'epoch': \d+, 'rec_loss': '([^']+)'", text)]
        rates = [float(x) for x in re.findall(r"epoch \d+: train (\d+) ex/s", text)]
        check("'dtype': 'bf16'" in text and len(losses) == 1 and math.isfinite(losses[0])
              and len(rates) == 1, f"middle-route train: epoch losses {losses}, rates {rates}")
        out["train"] = counts
        out["examples_per_s"] = rates[0]
        log(f"mid train path: main(--hidden_size {MID_H} --dtype bf16 --epochs 1) on {MID_USERS} "
            f"users x {N_ITEMS} items, {steps} steps, returned in {seconds:.1f}s, epoch 0 loss "
            f"{losses[0]}, train {rates[0]:.0f} examples/s, eval passes {eval_passes(text)} s "
            f"(valid, test), test scores {scores}; all {steps} ce_logz and {steps} ce_grads "
            f"launches on the middle route's tensor-core kernels (ce_fwd_mid_tc_kernel, "
            f"ce_bwd_mid_tc_kernel); launches {counts} [{card}]")

        topk_path = os.path.join(workdir, "mid_topk.npy")
        counts, scores, seconds = run(base + ["--train_name", "smoke_mid_eval", "--do_eval",
                                              "--load_model", "smoke_mid", "--export_topk",
                                              topk_path])
        want = dict.fromkeys(mid_counts(), 0) | rank_route(2 * eval_steps)
        check(counts == want, f"middle-route eval launches {counts}, want {want}")
        topk = np.load(topk_path)
        check(topk.shape == (MID_USERS, TOP_K) and 0 <= int(topk.min())
              and int(topk.max()) < N_ITEMS, "middle-route export")
        out["eval"] = counts
        log(f"mid eval path: main(--do_eval --load_model smoke_mid --export_topk) returned in "
            f"{seconds:.1f}s, test scores {scores}, exported {topk.shape}; launches {counts}, the "
            f"rank kernel on its older route at H={MID_H} [{card}]")

        # the fp32 form (main's default --dtype)
        fp32 = [a for a in base if a not in ("--dtype", "bf16")]
        counts, scores, seconds = run(fp32 + ["--train_name", "smoke_mid32", "--epochs", "1"])
        want = dict.fromkeys(mid_counts(), 0) | rank_route(2 * eval_steps) | {
            "ce_logz": steps, "ce_grads": steps, "ce_logz_mid_tf32": steps, "ce_grads_mid_tf32": steps}
        check(counts == want, f"middle-route fp32 train launches {counts}, want {want}")
        text = read_log(os.path.join(workdir, "smoke_mid32.log"))
        losses = [float(x) for x in re.findall(r"'epoch': \d+, 'rec_loss': '([^']+)'", text)]
        rates = [float(x) for x in re.findall(r"epoch \d+: train (\d+) ex/s", text)]
        check("'dtype': 'fp32'" in text and len(losses) == 1 and math.isfinite(losses[0])
              and len(rates) == 1, f"middle-route fp32 train: epoch losses {losses}, rates {rates}")
        out["train_fp32"] = counts
        out["examples_per_s_fp32"] = rates[0]
        log(f"mid train path, fp32 form: main(--hidden_size {MID_H} --epochs 1) on {MID_USERS} users "
            f"x {N_ITEMS} items, {steps} steps, returned in {seconds:.1f}s, epoch 0 loss {losses[0]}, "
            f"train {rates[0]:.0f} examples/s (bf16 form {out['examples_per_s']:.0f}), test scores "
            f"{scores}; all {steps} ce_logz launches on ce_fwd_mid_tf32_kernel (wgmma, 3xTF32), all "
            f"{steps} ce_grads launches on ce_bwd_wide_tf32_kernel (3xTF32); launches {counts} [{card}]")
    torch.cuda.empty_cache()
    return out



# ---- PREPRec (NewRec) --------------------------------------------------------

PREPREC_USERS = 10_000  # 20,000 before the fp32 middle route's epochs: the script's time
PREPREC_ITEMS = 5_000
PREPREC_SPAN_S = 2 * 365 * 24 * 3600  # two years of interactions
PREPREC_MAXLEN, PREPREC_HIDDEN = 200, 50
PREPREC_WIDTHS = ["--maxlen", str(PREPREC_MAXLEN), "--hidden_units", str(PREPREC_HIDDEN),
                  "--num_blocks", "2", "--num_heads", "1", "--batch_size", "128",
                  "--input_units1", "132", "--input_units2", "6"]
PREPREC_V = 1_000_000  # the method-3 catalog
PREPREC_EVAL_USERS = 2_048
PREPREC_MONTHS, PREPREC_WEEKS = 24, 104
PREPREC_CHECK_USERS = 8
# GPU and CPU scores differ by fp32 rounding (sums in another order); a
# catalog item within this share of the scores' largest magnitude of the
# ground truth may sit on either side of it
PREPREC_SCORE_TOL = 1e-5
# the exported scorer against the eval path's rows on the card, relative
# to the rows' largest magnitude: the same ops, traced
PREPREC_SERVE_TOL = 1e-5
PREPREC_ZOO = ("sasrec", "bert4rec", "newb4rec", "bprmf", "cl4srec")
PREPREC_SERVE_USERS = 64


def preprec_domain(n_users: int, n_items: int, seed: int = 0):
    """`benchmarks/preprec_demo.py:synth_domain`'s popularity-lifecycle
    process, drawn in bulk: item i's attractiveness is a Gaussian bump in
    time (centre c_i, width w_i) times a lognormal base; each event picks
    an item in proportion to the attractiveness in its week. 12-63 events
    a user over two years. -> (items, users, unix times)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, PREPREC_SPAN_S, n_items)
    widths = rng.uniform(PREPREC_SPAN_S / 24, PREPREC_SPAN_S / 6, n_items)
    base = rng.lognormal(0.0, 1.0, n_items)
    lens = rng.integers(12, 64, n_users)
    users = np.repeat(np.arange(n_users), lens)
    ts = rng.uniform(0, PREPREC_SPAN_S, users.size)
    n_slots = 104
    slot = np.minimum((ts / PREPREC_SPAN_S * n_slots).astype(np.int64), n_slots - 1)
    mids = (np.arange(n_slots) + 0.5) * PREPREC_SPAN_S / n_slots
    attr = base * np.exp(-((mids[:, None] - centers) ** 2) / (2 * widths**2)) + 1e-9
    cdf = np.cumsum(attr / attr.sum(1, keepdims=True), axis=1)
    u = rng.random(users.size)
    items = np.empty(users.size, np.int64)
    for w in range(n_slots):
        sel = slot == w
        items[sel] = np.minimum(np.searchsorted(cdf[w], u[sel]), n_items - 1)
    return items, users, (1_500_000_000 + ts).astype(np.int64)


class LogLines(logging.Handler):
    """Keeps the messages of a logger."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def preprec_scale_trainer(device, workdir, model: str = "newrec"):
    """A PrepRecTrainer of `model` for eval_method 3 over PREPREC_V items,
    as `benchmarks/preprec_scale.py` builds its inputs: random histories
    of full length, popularity tables of uniform values drawn on the card
    from a seed (month [24 + 11, V + 1, 11], week [104, V + 1, 6]; none for
    the id models, whose item table is [V + 1, 50])."""
    import torch

    from bsarec_tpu_torch.preprec.config import PrepRecConfig, PrepRecTrainConfig
    from bsarec_tpu_torch.preprec.data import PrepRecDataset
    from bsarec_tpu_torch.preprec.popularity import PopularityEncoding, PopularityTable
    from bsarec_tpu_torch.preprec.train import PrepRecTrainer

    u, v, length = PREPREC_EVAL_USERS, PREPREC_V, PREPREC_MAXLEN
    rng = np.random.default_rng(0)

    def ints(lo, hi, shape):
        return rng.integers(lo, hi, shape).astype(np.int32)

    ds = PrepRecDataset(
        train_seq=ints(1, v + 1, (u, length + 1)), train_t1=ints(0, PREPREC_MONTHS, (u, length + 1)),
        train_t2=ints(0, PREPREC_WEEKS, (u, length + 1)), train_te=np.zeros((u, length), np.int32),
        valid_item=ints(1, v + 1, u), valid_t1=ints(0, PREPREC_MONTHS, u),
        valid_t2=ints(0, PREPREC_WEEKS, u), valid_te=np.zeros((u, length), np.int32),
        test_item=ints(1, v + 1, u), test_t1=ints(0, PREPREC_MONTHS, u),
        test_t2=ints(0, PREPREC_WEEKS, u), test_te=np.zeros((u, length), np.int32),
        seq_lens=np.full(u, length + 1, np.int32), usernum=u, itemnum=v)
    pop = None
    if model in ("newrec", "newb4rec"):
        gen = torch.Generator(device=device).manual_seed(1)
        month = PopularityTable(torch.rand((PREPREC_MONTHS + 11, v + 1, 11), generator=gen,
                                           device=device), 11, 12)
        week = PopularityTable(torch.rand((PREPREC_WEEKS, v + 1, 6), generator=gen, device=device),
                               6, 1)
        pop = PopularityEncoding(month, week)
    cfg = PrepRecConfig(model=model, usernum=u, itemnum=v, maxlen=length,
                        hidden_units=PREPREC_HIDDEN,
                        num_blocks=2, num_heads=1, eval_method=3)
    tcfg = PrepRecTrainConfig(batch_size=128, seed=0, eval_batch_size=32, eval_item_chunk=4096,
                              device=device.type)
    logger = logging.getLogger("chip_smoke.preprec")
    return PrepRecTrainer(cfg, tcfg, ds, logger, workdir, pop)


def preprec_cpu_rows(trainer, n: int):
    """The first n users' method-3 score rows on the CPU through the
    port's own eval functions, same params and tables: (target scores [n],
    catalog scores [n, V])."""
    import torch

    from bsarec_tpu_torch.preprec import evaluate
    from bsarec_tpu_torch.preprec.popularity import PopularityEncoding, PopularityTable

    cpu = torch.device("cpu")
    model = copy.deepcopy(trainer.model).to(cpu).eval()
    pe, pop = trainer.pop_enc, None
    if pe is not None:
        pop = PopularityEncoding(
            PopularityTable(pe.month.table.cpu(), pe.month.base_dim, pe.month.nwin),
            PopularityTable(pe.week.table.cpu(), pe.week.base_dim, pe.week.nwin))
    arrays = evaluate.build_eval_inputs(trainer.ds, trainer.cfg, "valid", None).to_device(cpu)
    a = {k: t[:n] for k, t in arrays.items()}
    chunk, v = 65536, trainer.ds.itemnum
    with torch.no_grad():
        state = evaluate.final_state(model, trainer.cfg, pop, a["seqs"], a["t1"], a["t2"], a["te"],
                                     a["users"])
        args = (a["cand_t1"], a["cand_t2"], a["users"])
        tgt = evaluate.score_cands(model, trainer.cfg, pop, None, state, a["target"][:, None], *args)
        parts = []
        for c in range(math.ceil(v / chunk)):
            ids, _ = evaluate.sweep_chunk_ids(c, chunk, v, cpu)
            parts.append(evaluate.score_cands(model, trainer.cfg, pop, None, state,
                                              ids[None].expand(n, -1), *args))
    return tgt[:, 0].numpy(), torch.cat(parts, 1)[:, :v].numpy()


def preprec_sweep_trace(trainer, device, card):
    """One user batch's method-3 sweep (32 users, every chunk) under
    torch.profiler: the device's busy share and top entries a chunk."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bsarec_tpu_torch.preprec import evaluate

    a = evaluate.build_eval_inputs(trainer.ds, trainer.cfg, "valid", None).to_device(device)
    a = {k: t[:32] for k, t in a.items()}
    cfg, pop, v, chunk = trainer.cfg, trainer.pop_enc, trainer.ds.itemnum, trainer.tcfg.eval_item_chunk
    n_chunks = math.ceil(v / chunk)
    trainer.model.eval()
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = evaluate.final_state(trainer.model, cfg, pop, a["seqs"], a["t1"], a["t2"], a["te"])
        evaluate.sweep_ranks(trainer.model, cfg, pop, None, state, a["target"], a["cand_t1"],
                             a["cand_t2"], a["users"], v, chunk, trainer.generator)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    on_device = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in on_device) / 1e6
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:8]
    share = f"{100 * busy / traced:.1f}%" if busy > 0 else "not measured (no device time traced)"
    log(f"preprec method-3 sweep trace: 32 users x {n_chunks} chunks in {traced:.3f}s "
        f"({1e3 * traced / n_chunks:.3f} ms a chunk); device busy {share}; top device entries "
        f"{[(e.key[:48], round(e.self_device_time_total / (1e3 * n_chunks), 4)) for e in top]} "
        f"ms/chunk [{card}]")
    return busy / traced if busy > 0 else None


def phase_preprec(device, card, workdir, n_steps: int = 20):
    """PREPRec's NewRec on the card (no hand-written kernel: every count
    stays 0). 1) `bsarec_tpu_torch.preprec.main` at full width (maxlen
    200, hidden 50, 2 blocks, 1 head, batch 128, input_units 132 + 6) on a
    domain the port's `preprocess` builds from PREPREC_USERS users: one
    epoch, a method-1 valid and test eval; finite loss, ranks in [0, 100],
    best.ckpt written. 2) Method 3 over PREPREC_V items through
    `PrepRecTrainer.evaluate` (PREPREC_EVAL_USERS users, eval batch 32,
    item chunk 4096): ranks in [0, V], the first users' ranks inside the
    window the CPU path's scores allow, users/s and peak memory. 3)
    torch.profiler over n_steps training steps at that scale: the device's
    busy share and top entries. The domain and the run (`res/synth/smoke`)
    stay in `workdir` for phase_preprec_zoo."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bsarec_tpu_torch.preprec import main as preprec_main
    from bsarec_tpu_torch.preprec import preprocess

    out = {}
    reset_counts()
    t0 = time.perf_counter()
    prefix = os.path.join(workdir, "synth")
    stats = preprocess.preprocess(*preprec_domain(PREPREC_USERS, PREPREC_ITEMS), prefix)
    preprocess.eval_negatives(f"{prefix}_intwtime.csv", f"{prefix}_userneg.pickle", n=100)
    log(f"preprec domain: {stats['n_users']} users x {stats['n_items']} items preprocessed in "
        f"{time.perf_counter() - t0:.1f}s (host)")
    lines = LogLines()
    logging.getLogger("preprec").addHandler(lines)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        t0 = time.perf_counter()
        metrics = preprec_main.main(
            ["--dataset", "synth", "--data_dir", workdir, "--device", device.type,
             "--num_epochs", "1", "--epoch_test", "1", "--eval_method", "1",
             "--save_ranks", "--train_dir", "smoke", *PREPREC_WIDTHS])
        main_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        logging.getLogger("preprec").removeHandler(lines)
    run = os.path.join(workdir, "res", "synth", "smoke")
    epoch = [m for m in lines.lines if m.startswith("epoch 1: loss")]
    evals = [m for m in lines.lines if " eval: " in m]
    check(len(epoch) == 1 and len(evals) == 2, f"preprec main log: {lines.lines}")
    loss = float(re.search(r"loss (\S+)", epoch[0]).group(1))
    check(math.isfinite(loss), f"preprec epoch loss {loss}")
    ranks = np.loadtxt(os.path.join(run, "ranks.txt"))
    check(ranks.shape == (stats["n_users"],) and ranks.min() >= 0 and ranks.max() <= 100,
          f"preprec method-1 ranks in [0, 100] (min {ranks.min()}, max {ranks.max()})")
    check(os.path.exists(os.path.join(run, "best.ckpt")), "preprec best.ckpt written")
    check(metrics is not None and all(np.isfinite(metrics).ravel()), f"preprec metrics {metrics}")
    log(f"preprec main (--device {device.type}, 1 epoch, method-1 valid and test): {main_s:.1f}s; "
        f"{epoch[0]}; {'; '.join(evals)}; test {metrics} [{card}]")
    out["main"] = {"seconds": main_s, "epoch": epoch[0], "evals": evals}

    trainer = preprec_scale_trainer(device, workdir)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, ranks3 = trainer.evaluate("valid")
    sweep_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(ranks3.shape == (PREPREC_EVAL_USERS,) and ranks3.min() >= 0
          and ranks3.max() <= PREPREC_V, f"preprec method-3 ranks in [0, V]")
    t0 = time.perf_counter()
    tgt, rows = preprec_cpu_rows(trainer, PREPREC_CHECK_USERS)
    tol = PREPREC_SCORE_TOL * max(np.abs(rows).max(), np.abs(tgt).max())
    lo = (rows > tgt[:, None] + tol).sum(1)
    hi = (rows >= tgt[:, None] - tol).sum(1)
    got = ranks3[:PREPREC_CHECK_USERS]
    check(((got >= lo) & (got <= hi)).all(),
          f"preprec method-3 card ranks {got.tolist()} outside the CPU window "
          f"{list(zip(lo.tolist(), hi.tolist()))}")
    log(f"preprec method 3: {PREPREC_EVAL_USERS} users x {PREPREC_V} items in {sweep_s:.3f}s = "
        f"{PREPREC_EVAL_USERS / sweep_s:.1f} users/s (eval batch 32, item chunk 4096, the "
        f"process's first method-3 pass); peak device memory {peak:.2f} GiB; first {PREPREC_CHECK_USERS} ranks "
        f"{got.tolist()} within the CPU path's windows {list(zip(lo.tolist(), hi.tolist()))} "
        f"(tol {tol:.3g}; CPU {time.perf_counter() - t0:.1f}s) [{card}]")
    out["method3"] = {"users_per_s": PREPREC_EVAL_USERS / sweep_s, "peak_gib": peak,
                      "sweep_busy_share": preprec_sweep_trace(trainer, device, card)}

    gen = np.random.default_rng(5)
    batches = [torch.from_numpy(gen.integers(1, PREPREC_EVAL_USERS + 1, 128)).to(device)
               for _ in range(n_steps)]
    trainer.model.train()
    for users in batches[:3]:
        trainer.step(users)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for users in batches:
            trainer.step(users)
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    on_device = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in on_device) / 1e6
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:6]
    share = f"{100 * busy / traced:.1f}%" if busy > 0 else "not measured (no device time traced)"
    log(f"preprec train trace: {n_steps} NewRec steps (batch 128, maxlen 200, hidden 50, "
        f"{PREPREC_V} items) in {traced:.3f}s = {n_steps * 128 / traced:.0f} examples/s; device "
        f"busy {share}; top device entries "
        f"{[(e.key[:48], round(e.self_device_time_total / (1e3 * n_steps), 3)) for e in top]} "
        f"ms/step [{card}]")
    out["busy_share"] = busy / traced if busy > 0 else None
    del trainer
    torch.cuda.empty_cache()
    counts = read_counts()
    check(not any(counts.values()), f"the PREPRec phase launched no kernel of the port: {counts}")
    return out


def preprec_cli(workdir, device, argv):
    """`preprec.main` run in `workdir` on phase 11's domain: (its return,
    its log lines, seconds)."""
    from bsarec_tpu_torch.preprec import main as preprec_main

    lines = LogLines()
    logging.getLogger("preprec").addHandler(lines)
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        t0 = time.perf_counter()
        out = preprec_main.main(["--dataset", "synth", "--data_dir", workdir, "--device",
                                 device.type, *PREPREC_WIDTHS, *argv])
        seconds = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        logging.getLogger("preprec").removeHandler(lines)
    return out, lines.lines, seconds


def rate_of(lines, prefix: str) -> float:
    """The examples/s or users/s of the first log line starting with `prefix`."""
    line = next(m for m in lines if m.startswith(prefix))
    return float(re.search(r"([\d.]+) (?:examples|users)/s\)", line).group(1))


def phase_preprec_zoo(device, card, workdir):
    """The other five PREPRec models and the rest of the PREPRec CLI on
    the card, in phase 11's `workdir` (its domain and its NewRec run); no
    hand-written kernel (every count stays 0). See the module docstring,
    11b."""
    import torch

    from bsarec_tpu_torch.preprec.config import PrepRecConfig
    from bsarec_tpu_torch.preprec.data import load_intwtime, load_userneg
    from bsarec_tpu_torch.preprec.evaluate import build_eval_inputs
    from bsarec_tpu_torch.preprec.serving import load_candidate_scorer

    reset_counts()
    out = {"models": {}}
    res = os.path.join(workdir, "res", "synth")
    n_users = len(np.loadtxt(os.path.join(res, "smoke", "ranks.txt")))
    for name in PREPREC_ZOO:
        extra = ["--mask_prob", "0.2"] if name in ("bert4rec", "newb4rec") else []
        if name == "sasrec":
            extra = ["--save_scores"]  # the saved rows of the ensembling check below
        metrics, lines, seconds = preprec_cli(
            workdir, device, ["--model", name, "--num_epochs", "1", "--epoch_test", "1",
                              "--eval_method", "1", "--save_ranks", "--train_dir", f"zoo_{name}",
                              *extra])
        run = os.path.join(res, f"zoo_{name}")
        epoch = next(m for m in lines if m.startswith("epoch 1: loss"))
        loss = float(re.search(r"loss (\S+)", epoch).group(1))
        check(math.isfinite(loss) and loss > 0, f"preprec {name} epoch loss {loss}")
        ranks = np.loadtxt(os.path.join(run, "ranks.txt"))
        check(ranks.shape == (n_users,) and ranks.min() >= 0 and ranks.max() <= 100,
              f"preprec {name} method-1 ranks in [0, 100] (min {ranks.min()}, max {ranks.max()})")
        check(os.path.exists(os.path.join(run, "best.ckpt")), f"preprec {name} best.ckpt written")
        check(metrics is not None and all(np.isfinite(metrics).ravel()), f"preprec {name} {metrics}")
        rates = {"train_examples_per_s": rate_of(lines, "epoch 1: loss"),
                 "valid_users_per_s": rate_of(lines, "valid eval"),
                 "test_users_per_s": rate_of(lines, "test eval"), "main_s": seconds,
                 "loss": loss, "test": metrics}
        out["models"][name] = rates
        log(f"preprec zoo {name}: main (--device {device.type}, 1 epoch, method-1 valid and "
            f"test) {seconds:.1f}s; {epoch}; train {rates['train_examples_per_s']} examples/s, "
            f"eval {rates['valid_users_per_s']} / {rates['test_users_per_s']} users/s; "
            f"test {metrics} [{card}]")
    metrics, lines, seconds = preprec_cli(workdir, device, ["--model", "mostpop"])
    out["mostpop_users_per_s"] = rate_of(lines, "mostpop test")
    log(f"preprec zoo mostpop: {out['mostpop_users_per_s']} users/s (host numpy); test {metrics}; "
        f"main {seconds:.1f}s [{card}]")

    # SASRecB's method 3 over PREPREC_V items
    trainer = preprec_scale_trainer(device, workdir, "sasrec")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, ranks3 = trainer.evaluate("valid")
    sweep_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(ranks3.shape == (PREPREC_EVAL_USERS,) and ranks3.min() >= 0 and ranks3.max() <= PREPREC_V,
          "preprec SASRecB method-3 ranks in [0, V]")
    tgt, rows = preprec_cpu_rows(trainer, PREPREC_CHECK_USERS)
    tol = PREPREC_SCORE_TOL * max(np.abs(rows).max(), np.abs(tgt).max())
    lo = (rows > tgt[:, None] + tol).sum(1)
    hi = (rows >= tgt[:, None] - tol).sum(1)
    got = ranks3[:PREPREC_CHECK_USERS]
    check(((got >= lo) & (got <= hi)).all(),
          f"preprec SASRecB method-3 card ranks {got.tolist()} outside the CPU window "
          f"{list(zip(lo.tolist(), hi.tolist()))}")
    out["sasrec_method3"] = {"users_per_s": PREPREC_EVAL_USERS / sweep_s, "peak_gib": peak}
    log(f"preprec zoo SASRecB method 3: {PREPREC_EVAL_USERS} users x {PREPREC_V} items in "
        f"{sweep_s:.3f}s = {PREPREC_EVAL_USERS / sweep_s:.1f} users/s (eval batch 32, item chunk "
        f"4096); peak device memory {peak:.2f} GiB; first {PREPREC_CHECK_USERS} ranks "
        f"{got.tolist()} within the CPU path's windows {list(zip(lo.tolist(), hi.tolist()))} "
        f"(tol {tol:.3g}) [{card}]")
    del trainer
    torch.cuda.empty_cache()

    # the saved scores, ensembled with fresh ones
    sas = os.path.join(res, "zoo_sasrec")
    saved = np.loadtxt(os.path.join(sas, "preds.txt"))
    check(saved.shape == (n_users, 101) and np.isfinite(saved).all(), f"preds.txt {saved.shape}")
    _, lines, seconds = preprec_cli(
        workdir, device, ["--model", "sasrec", "--inference_only", "--state_dict_path",
                          os.path.join(sas, "best.ckpt"), "--use_scores", "--use_score_dir",
                          os.path.join(sas, "preds.txt"), "--alphas", "0.3", "0.7",
                          "--train_dir", "zoo_sasrec_ens"])
    blends = [m for m in lines if m.startswith("alpha=")]
    check(len(blends) == 2 and all("nan" not in m for m in blends), f"ensembled metrics {blends}")
    log(f"preprec zoo --use_scores (SASRecB, method 1): {'; '.join(blends)} ({seconds:.1f}s) [{card}]")

    # phase 11's NewRec: user embeddings, few-shot transfer, the scorer
    src = os.path.join(res, "smoke", "best.ckpt")
    _, _, seconds = preprec_cli(workdir, device, ["--state_dict_path", src, "--export_user_embed",
                                                  "--label", "smoke", "--train_dir", "zoo_embed"])
    emb = np.loadtxt(os.path.join(res, "zoo_embed", "user_embed_smoke.txt"))
    check(emb.shape == (n_users, PREPREC_HIDDEN) and np.isfinite(emb).all(),
          f"user embeddings {emb.shape}")
    log(f"preprec zoo --export_user_embed: {emb.shape} in {seconds:.1f}s [{card}]")

    _, lines, seconds = preprec_cli(
        workdir, device, ["--state_dict_path", src, "--fs_transfer", "--fs_emb", "--fs_num_epochs",
                          "1", "--fs_prop", "0.25", "--epoch_test", "1", "--train_dir", "zoo_fs"])
    loaded, after = torch.load(src), torch.load(os.path.join(res, "zoo_fs", "epoch=1.ckpt"))
    check(all(torch.equal(after[k], v) for k, v in loaded.items()),
          "fs_transfer: every parameter but fs_layer's bit-equal to the loaded checkpoint")
    moved = [k for k in after if k.startswith("fs_layer")]
    check(moved, "fs_transfer: the checkpoint holds fs_layer")
    log(f"preprec zoo --fs_transfer --fs_emb: {len(loaded)} frozen tensors bit-equal, "
        f"{len(moved)} fs_layer tensors trained; "
        f"{next(m for m in lines if m.startswith('epoch 1: loss'))} ({seconds:.1f}s) [{card}]")

    path = os.path.join(workdir, "preprec_scorer.pt2")
    _, lines, seconds = preprec_cli(
        workdir, device, ["--state_dict_path", src, "--inference_only", "--mode", "valid",
                          "--save_scores", "--export_serving", path, "--train_dir", "zoo_serve"])
    want = np.loadtxt(os.path.join(res, "zoo_serve", "preds.txt"))[:PREPREC_SERVE_USERS]
    scorer = load_candidate_scorer(path, device)
    prefix = os.path.join(workdir, "synth")
    ds = load_intwtime(f"{prefix}_intwtime.csv", PREPREC_MAXLEN)
    cfg = PrepRecConfig(usernum=ds.usernum, itemnum=ds.itemnum, maxlen=PREPREC_MAXLEN)
    a = build_eval_inputs(ds, cfg, "valid", load_userneg(f"{prefix}_userneg.pickle", ds.usernum))
    n, c = PREPREC_SERVE_USERS, a.cands.shape[1]
    args = (a.seqs[:n], a.t1[:n], a.t2[:n], a.cands[:n], np.repeat(a.cand_t1[:n, None], c, 1),
            np.repeat(a.cand_t2[:n, None], c, 1), a.users[:n])
    got = scorer.scores(*args)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    check(got.shape == want.shape and err <= PREPREC_SERVE_TOL,
          f"preprec scorer against the eval path: {got.shape} vs {want.shape}, err {err:.3g}")
    scorer.scores(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        scorer.scores(*args)
    call_ms = (time.perf_counter() - t0) * 100
    out["serving"] = {"max_rel_err": err, "ms_per_call_b64": call_ms, "bytes": os.path.getsize(path)}
    log(f"preprec zoo serving: {path.rsplit('/', 1)[-1]} ({os.path.getsize(path)} bytes) loaded "
        f"on the card, {n} users x {c} candidates within {err:.3g} of the eval path's rows; "
        f"{call_ms:.3f} ms a call (b={n}, host numpy in and out) [{card}]")
    counts = read_counts()
    check(not any(counts.values()), f"the PREPRec zoo phase launched no kernel of the port: {counts}")
    return out


# ---- the tools: the native host library, --remat, --profile, --dump_seqout ------

PROFILE_USERS = 1_000  # the --profile run's corpus: 1M items, few steps, a small trace
# a --remat step computes the loss twice (its forward, then its recompute in
# the backward), so its CE makes two ce_logz launches and one ce_grads, and
# SASRec's fused dropout three passes a site (forward, recompute, backward)
REMAT_STEP_CE = {"ce_logz": 2, "ce_grads": 1}
REMAT_STEP_DROPOUT = 3 * DROPOUT_SITES
# at most this share of the rows whose answer group holds another row may
# keep a pick equal to their own row after the native sampler's 9 tries
SAME_TARGET_SELF_SHARE = 0.01


@contextlib.contextmanager
def native_off():
    """BSAREC_NO_NATIVE=1 while the block runs: the port's numpy paths."""
    old = os.environ.get("BSAREC_NO_NATIVE")
    os.environ["BSAREC_NO_NATIVE"] = "1"
    try:
        yield
    finally:
        os.environ.pop("BSAREC_NO_NATIVE")
        if old is not None:
            os.environ["BSAREC_NO_NATIVE"] = old


def host_s(fn):
    """(fn(), seconds on the host clock)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def phase_tools_native(workdir, card):
    """The native library (`bsarec_tpu_torch/native.py`, g++ on
    `native/seqrec.cpp`) at phase 7's 1M-item x TRAIN_USERS corpus: the
    corpus parse, the train split (prefix_expand), both eval splits and the
    seen bitmask of the test split at V = 1,000,000 bit-equal to the port's
    numpy paths; the same-target sampler against its contract. Returns
    {routine: [native s, numpy s]}."""
    from bsarec_tpu_torch import native
    from bsarec_tpu_torch.data.corpus import load_corpus
    from bsarec_tpu_torch.data.pipeline import SeqRecData
    from bsarec_tpu_torch.ops import rank

    lib, build_s = host_s(native.lib)
    check(lib is not None, "the native library did not build or load")
    path = os.path.join(workdir, "synth_train.txt")
    fast, t_fast = host_s(lambda: load_corpus(path))
    with native_off():
        slow, t_slow = host_s(lambda: load_corpus(path))
    check(fast.offsets is not None and slow.offsets is None, "corpus parse: paths not as asked")
    offsets, items = slow.csr
    check(np.array_equal(fast.offsets, offsets) and np.array_equal(fast.items, items)
          and fast.max_item == slow.max_item == N_ITEMS - 1, "native corpus parse != Python's")
    times = {"parse_corpus": [t_fast, t_slow]}

    (inputs, answers, users), t_fast = host_s(lambda: native.prefix_expand(offsets, items, 50))
    train, t_slow = host_s(lambda: SeqRecData._build_train(slow.lists, 50))
    check(np.array_equal(inputs, train.input_ids) and np.array_equal(answers, train.answers)
          and np.array_equal(users, train.user_ids), "native prefix_expand != numpy")
    times["prefix_expand"] = [t_fast, t_slow]
    lens = (offsets[1:] - offsets[:-1]).astype(np.int64)
    times["eval_split"] = [0.0, 0.0]
    for mode, drop in (("valid", 2), ("test", 1)):
        width = max(int((lens - drop).max(initial=1)), 1)
        got, t_fast = host_s(lambda: native.eval_split(offsets, items, 50, drop, width))
        want, t_slow = host_s(lambda: SeqRecData._build_eval(slow.lists, 50, mode))
        check(all(np.array_equal(g, w) for g, w in
                  zip(got, (want.input_ids, want.answers, want.seen_items))),
              f"native eval_split ({mode}) != numpy")
        times["eval_split"] = [times["eval_split"][0] + t_fast, times["eval_split"][1] + t_slow]
        if mode == "test":
            seen = want.seen_items
    bits, t_fast = host_s(lambda: rank.build_seen_bitmask(seen, N_ITEMS))
    with native_off():
        want_bits, t_slow = host_s(lambda: rank.build_seen_bitmask(seen, N_ITEMS))
    check(bits.shape == (TRAIN_USERS, rank.seen_words(N_ITEMS)) and np.array_equal(bits, want_bits),
          "native seen_bitmask != numpy at V = 1M")
    times["seen_bitmask"] = [t_fast, t_slow]
    del bits, want_bits

    data = SeqRecData(fast, 50)
    data._build_same_target_groups()  # the answer groups, built once for both samplers
    _, t_fast = host_s(lambda: data.sample_same_target(np.random.default_rng(0)))
    with native_off():
        _, t_slow = host_s(lambda: data.sample_same_target(np.random.default_rng(0)))
    times["same_target_pick"] = [t_fast, t_slow]
    order, starts, ends, diversity, row_class = data._same_target_groups
    ans = data.train.answers
    group_start = starts[ans]
    group_size = np.maximum(ends[ans] - group_start, 1)
    args = (order, group_start, group_size, diversity[ans], row_class)
    pick = native.same_target_pick(*args, seed=12345)
    check(np.array_equal(pick, native.same_target_pick(*args, seed=12345))
          and not np.array_equal(pick, native.same_target_pick(*args, seed=54321)),
          "same_target_pick: not a function of its seed")
    check(np.array_equal(ans[pick], ans), "same_target_pick: a pick outside its answer group")
    diverse = diversity[ans]
    kept_self = int((diverse & (row_class[pick] == row_class)).sum())
    check(diverse.any() and kept_self <= SAME_TARGET_SELF_SHARE * int(diverse.sum()),
          f"same_target_pick: {kept_self} of {int(diverse.sum())} rows of diverse groups kept "
          f"their own sequence")
    log(f"tools native: library built and loaded in {build_s:.2f}s; parse_corpus, prefix_expand, "
        f"eval_split (both splits) and seen_bitmask (V={N_ITEMS}, {TRAIN_USERS} rows) bit-equal "
        f"to the numpy paths; same_target_pick over {len(pick)} rows in its answer groups, "
        f"{kept_self} of {int(diverse.sum())} diverse rows on their own sequence")
    for name, (t_native, t_numpy) in times.items():
        log(f"tools native host time {name}: native {1e3 * t_native:.1f} ms, numpy "
            f"{1e3 * t_numpy:.1f} ms ({t_numpy / max(t_native, 1e-9):.1f}x) [{card}]")
    return {name: [round(a, 6), round(b, 6)] for name, (a, b) in times.items()}


def remat_cases(device):
    """(name, model builder, dtype, fused): the --remat step's models."""
    import torch

    from bsarec_tpu_torch.config import ModelConfig
    from bsarec_tpu_torch.models import build_model

    def wide():
        cfg = ModelConfig(model_type="bsarec", item_size=N_ITEMS, num_users=TRAIN_USERS + 1,
                          max_seq_length=50, hidden_size=WIDE_H, num_hidden_layers=2,
                          num_attention_heads=1, c=5, alpha=0.7, loss_impl="streaming")
        return build_model(cfg, generator=torch.Generator().manual_seed(0)).to(device)

    return [
        ("BSARec H=64", lambda: full_width_model(device, dropout=0.5, loss_impl="streaming")),
        ("BSARec H=64 bf16", lambda: full_width_model(device, dropout=0.5, loss_impl="streaming",
                                                      dtype=BF16)),
        (f"BSARec H={WIDE_H}", wide),
        ("SASRec fused dropout", lambda: sasrec_model(device, fused=True)),
    ]


def remat_steps(model, remat: bool, seed: int):
    """Two Adam steps of `model` (batches seeded seed and seed + 1, torch's
    CUDA stream and the loss's generator seeded alike), through `remat_loss`
    or the eager loss. Returns (the second step's ms, its peak bytes, its
    launch counts, the parameters after it on the card)."""
    import torch

    from bsarec_tpu_torch.config import TrainConfig
    from bsarec_tpu_torch.ops import ce
    from bsarec_tpu_torch.train.loop import make_optimizer, remat_loss

    device = model.item_table.device
    model.train()
    opt = make_optimizer(model.parameters(), TrainConfig(lr=LR))
    for step in range(2):
        ids, answers, negs, seeds = sasrec_batch(device, seed + step)
        torch.cuda.manual_seed(seed + step)  # nn.Dropout's stream
        gen = torch.Generator(device=device).manual_seed(seed + step)
        if model.dropout_state.fused:
            model.dropout_state.begin_step(seeds)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        reset_counts()
        t0 = time.perf_counter()
        if remat:
            loss = remat_loss(model, ids, answers, negs, None, None, gen)
        else:
            loss = model.calculate_loss(ids, answers, negs, generator=gen)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
    check(math.isfinite(float(loss)), "remat step: loss not finite")
    counts = {k: v for k, v in read_counts().items() if v} | {
        k: getattr(ce, n).wide_launches for k, n in (("ce_logz_wide", "ce_logz"),
                                                     ("ce_grads_wide", "ce_grads"))
        if getattr(ce, n).wide_launches}
    peak = torch.cuda.max_memory_allocated(device)
    del opt
    return ms, peak, counts, {k: v.detach().clone() for k, v in model.state_dict().items()}


def phase_tools_remat(device, card):
    """--remat at B=256, V=1,000,000: per case, two Adam steps eager and
    two through `remat_loss` from the same parameters, batches and seeds
    (dropout on: nn.Dropout on torch's CUDA stream, SASRec's fused
    dropout), the parameters after them bit-equal, the remat step's CE
    and dropout launches as REMAT_STEP_CE and REMAT_STEP_DROPOUT say; the
    second step's host ms (to its synchronize) and peak memory. Returns
    {case: fields}."""
    import torch

    out = {}
    for name, build in remat_cases(device):
        first = build()
        second = copy.deepcopy(first)
        ms, peak, counts, params = remat_steps(first, remat=False, seed=31)
        del first
        r_ms, r_peak, r_counts, r_params = remat_steps(second, remat=True, seed=31)
        del second
        worst = max(float((params[k].float() - v.float()).abs().max()) for k, v in r_params.items())
        check(worst == 0.0, f"remat {name}: parameters after two steps differ from the eager "
                            f"steps' by up to {worst}")
        if name.startswith("SASRec"):
            want = {"fused_dropout": 2 * DROPOUT_SITES}, {"fused_dropout": REMAT_STEP_DROPOUT}
        else:
            want = ({"ce_logz": 1, "ce_grads": 1}, dict(REMAT_STEP_CE))
            if name.endswith(f"H={WIDE_H}"):
                want = tuple(w | {f"{k}_wide": v for k, v in w.items()} for w in want)
        check((counts, r_counts) == want, f"remat {name}: launches eager {counts}, remat "
                                          f"{r_counts}, want {want}")
        out[name] = {"eager_ms": round(ms, 3), "remat_ms": round(r_ms, 3),
                     "eager_peak_mib": round(peak / 2**20, 1),
                     "remat_peak_mib": round(r_peak / 2**20, 1), "remat_launches": r_counts}
        log(f"tools remat {name} (B={TRAIN_BATCH}, V={N_ITEMS}): parameters after two Adam steps "
            f"bit-equal to the eager steps'; step {ms:.2f} ms eager, {r_ms:.2f} ms remat; peak "
            f"{peak / 2**20:.1f} MiB eager, {r_peak / 2**20:.1f} MiB remat; launches eager "
            f"{counts}, remat {r_counts} [{card}]")
        del params, r_params
        torch.cuda.empty_cache()
    return out


def tools_main(argv):
    """main.main(argv) with the launch counts set to 0 just before and read
    just after; returns (scores, counts, seconds)."""
    import torch

    from bsarec_tpu_torch import main as port_main

    reset_counts()
    t0 = time.perf_counter()
    scores = port_main.main(argv)
    torch.cuda.synchronize()
    return scores, read_counts(), time.perf_counter() - t0


def phase_tools_main(device, workdir, card):
    """The flags through `main` on the card: one `--remat` epoch on phase
    7's corpus (two ce_logz launches and one ce_grads a step, the rank
    kernel on every eval batch); `--profile` of a one-epoch fit on a
    1M-item x 1k-user corpus (a Chrome trace whose device events name the
    CE and rank kernels and the training annotations); `--do_eval
    --load_model smoke_train --dump_seqout` (batches x (layers + 1) files
    of [b, 50, 64], read back by `load_sequence_outputs`, the last layer's
    last position of the first batch against the model's own forward).
    Returns the phase's summary fields."""
    import torch

    from bsarec_tpu_torch.data.corpus import load_corpus
    from bsarec_tpu_torch.data.pipeline import SeqRecData
    from bsarec_tpu_torch.models import build_model
    from bsarec_tpu_torch.train import checkpoint as ckpt
    from bsarec_tpu_torch.utils.visualize import load_sequence_outputs

    common = ["--data_dir", workdir, "--output_dir", workdir, "--device", device.type,
              "--lr", str(LR), "--batch_size", str(TRAIN_BATCH), *WIDTHS]
    seqs = synth_corpus(TRAIN_USERS, N_ITEMS, seed=1)
    steps = math.ceil(sum(len(s[-52:-2]) for s in seqs) / TRAIN_BATCH)
    eval_steps = math.ceil(TRAIN_USERS / EVAL_BATCH)
    scores, counts, seconds = tools_main(common + ["--data_name", "synth_train", "--train_name",
                                                   "tools_remat", "--epochs", "1", "--remat"])
    want = zero_counts() | {"ce_logz": REMAT_STEP_CE["ce_logz"] * steps,
                            "ce_grads": REMAT_STEP_CE["ce_grads"] * steps,
                            "streaming_masked_topk": 2 * eval_steps}
    check(counts == want, f"main --remat launches {counts}, want {want}")
    text = read_log(os.path.join(workdir, "tools_remat.log"))
    losses = [float(x) for x in re.findall(r"'epoch': \d+, 'rec_loss': '([^']+)'", text)]
    rates = [float(x) for x in re.findall(r"epoch \d+: train (\d+) ex/s", text)]
    check(len(losses) == 1 and math.isfinite(losses[0]) and len(rates) == 1,
          f"main --remat: epoch losses {losses}")
    log(f"tools main --remat --epochs 1 on {TRAIN_USERS} users x {N_ITEMS} items: loss {losses[0]}, "
        f"train {rates[0]:.0f} examples/s (first epoch), test scores {scores}, {seconds:.1f}s; "
        f"launches {counts} [{card}]")
    fields = {"remat_main_launches": counts, "remat_main_examples_per_s": rates[0]}

    with open(os.path.join(workdir, "synth_profile.txt"), "w") as fh:
        for u, seq in enumerate(synth_corpus(PROFILE_USERS, N_ITEMS, seed=2)):
            fh.write(f"{u + 1} {' '.join(map(str, seq))}\n")
    prof_dir = os.path.join(workdir, "profile")
    _, counts, seconds = tools_main(common + ["--data_name", "synth_profile", "--train_name",
                                              "tools_profile", "--epochs", "1",
                                              "--profile", prof_dir])
    files = [f for f in os.listdir(prof_dir) if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"--profile wrote {files}")
    trace_path = os.path.join(prof_dir, files[0])
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    kernel_us: dict[str, float] = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernel_us[e["name"]] = kernel_us.get(e["name"], 0.0) + float(e.get("dur", 0.0))
    names = {e.get("name") for e in events}
    for part in ("ce_fwd_onchip_kernel", "ce_bwd_onchip_kernel", "rank_onchip_kernel"):
        check(any(part in k for k in kernel_us), f"--profile trace: no device event of {part}")
    check({"train_epoch", "train_step", "eval_epoch"} <= names,
          "--profile trace: training annotations missing")
    top = sorted(kernel_us.items(), key=lambda kv: -kv[1])[:8]
    log(f"tools main --profile (1 epoch, {PROFILE_USERS} users x {N_ITEMS} items, {seconds:.1f}s): "
        f"trace {os.path.getsize(trace_path) / 2**20:.1f} MiB, {len(kernel_us)} kernel names, "
        f"launches {counts}; top device entries (ms): "
        f"{ {k[:60]: round(v / 1e3, 3) for k, v in top} } [{card}]")
    fields |= {"profile_trace_mib": round(os.path.getsize(trace_path) / 2**20, 2),
               "profile_top_kernels_ms": {k[:60]: round(v / 1e3, 3) for k, v in top}}

    dump_dir = os.path.join(workdir, "seqout")
    _, counts, seconds = tools_main(common + ["--data_name", "synth_train", "--train_name",
                                              "tools_dump", "--do_eval", "--load_model",
                                              "smoke_train", "--dump_seqout", dump_dir])
    tag = "synth_train_BSARec"
    files = os.listdir(os.path.join(dump_dir, tag))
    layers = 2
    check(len(files) == eval_steps * (layers + 1), f"--dump_seqout wrote {len(files)} files, "
                                                   f"want {eval_steps * (layers + 1)}")
    last = TRAIN_USERS - (eval_steps - 1) * EVAL_BATCH
    for i in (0, eval_steps - 1):
        for layer in range(layers + 1):
            arr = np.load(os.path.join(dump_dir, tag, f"{layer}layer_{i}iter.npy"))
            want_rows = last if i == eval_steps - 1 else EVAL_BATCH
            check(arr.shape == (want_rows, 50, 64) and arr.dtype == np.float32
                  and np.isfinite(arr).all(), f"dump {layer}layer_{i}iter: {arr.shape} {arr.dtype}")
    per_layer = load_sequence_outputs(os.path.join(dump_dir, tag), layers)
    check([x.shape for x in per_layer] == [(TRAIN_USERS, 64)] * (layers + 1),
          f"load_sequence_outputs shapes {[x.shape for x in per_layer]}")
    data = SeqRecData(load_corpus(os.path.join(workdir, "synth_train.txt")), 50)
    model = full_width_model(device, dropout=0.5)
    model.load_state_dict(ckpt.load_params(os.path.join(workdir, "smoke_train.ckpt")))
    model.eval()
    with torch.inference_mode():
        ids = torch.from_numpy(data.test.input_ids[:EVAL_BATCH]).long().to(device)
        want_states = model(ids)[:, -1, :].cpu().numpy()
    err = float(np.abs(per_layer[-1][:EVAL_BATCH] - want_states).max())
    check(err <= FLOAT_TOL, f"--dump_seqout: last layer vs the model's forward, error {err}")
    del model, per_layer
    log(f"tools main --do_eval --dump_seqout: {len(files)} files ({eval_steps} batches x "
        f"{layers + 1} outputs), shapes checked, read back by load_sequence_outputs, the last "
        f"layer within {err:.3g} of the model's forward, {seconds:.1f}s; launches {counts} [{card}]")
    return fields | {"dump_files": len(files)}



# ---- the vocab-sharded mesh (core/mesh.py, parallel/): m shards in one process,
# ---- main --mesh through a one-rank NCCL group, and two gloo ranks on the card --

# (shards, hidden, CE form): the on-chip routes (fp32 FMA, bf16 tensor cores)
# at H=64 and the wide routes at H=512
MESH_CE_CASES = [(2, 64, None), (2, 64, "bfloat16"), (4, 64, None), (4, 64, "bfloat16"),
                 (2, 512, None), (2, 512, "bfloat16")]
# (shards, hidden, n_valid): 999,997 valid items, and n_valid at or under
# the last shard's first row, which leaves that shard empty
MESH_RANK_CASES = [(2, 64, N_ITEMS - 3), (4, 64, N_ITEMS - 3), (2, 64, N_ITEMS // 2),
                   (4, 64, 3 * N_ITEMS // 4 - 3), (2, 512, N_ITEMS - 3)]
MESH_SEEN = 50  # seen ids a user, 0-padded
# one rank of `main --mesh data:1,model:2` over gloo, both ranks on cuda:0
# (NCCL takes one rank a device): python -c MESH_RANK_CODE <rank> <store>
# <result.json> <main argv...>
MESH_RANK_CODE = """
import json, os, sys, time
import torch, torch.distributed as dist
rank, store, result = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 2), rank=rank, world_size=2)
import chip_smoke
from bsarec_tpu_torch import main as port_main
from bsarec_tpu_torch.config import set_fp32_matmul
set_fp32_matmul()
chip_smoke.reset_counts()
scores = port_main.main(sys.argv[4:])
if torch.cuda.is_available():
    torch.cuda.synchronize()
with open(result, "w") as fh:
    json.dump({"scores": scores, "counts": chip_smoke.read_counts()}, fh)
dist.destroy_process_group()
"""


def mesh_seen_items(b: int, v: int, m: int, seed: int) -> np.ndarray:
    """[b, MESH_SEEN] seen ids: random ids, every shard's first row (local
    item 0 of shards s > 0), a repeat and 0 padding at the end."""
    rng = np.random.default_rng(seed)
    seen = rng.integers(1, v, size=(b, MESH_SEEN)).astype(np.int32)
    rows = v // m
    seen[:, :m - 1] = np.arange(1, m) * rows
    seen[:, m] = seen[:, m + 1]
    pad = rng.integers(1, 10, size=b)
    seen[np.arange(MESH_SEEN)[None, :] >= MESH_SEEN - pad[:, None]] = 0
    return seen


def mesh_bitmask_check(seen: np.ndarray, v: int, m: int):
    """The shard-mode bitmasks, native against numpy, bit-equal, and shard
    s's local bits equal to the whole table's bits of its rows (item 0's
    bit on shard 0 only). Returns (the [m, b, w] stack, the whole table's
    [b, W] bitmask, the native and numpy host seconds)."""
    from bsarec_tpu_torch.ops import rank

    (stack, native_s) = host_s(lambda: rank.build_seen_bitmask_sharded(seen, v, m))
    with native_off():
        (plain, numpy_s) = host_s(lambda: rank.build_seen_bitmask_sharded(seen, v, m))
    check(stack.dtype == plain.dtype == np.int32 and np.array_equal(stack, plain),
          f"shard-mode bitmask, m={m}: native and numpy differ")
    whole = rank.build_seen_bitmask(seen, v)
    rows = v // m
    bits = np.unpackbits(whole[:8].view(np.uint8), axis=1, bitorder="little")
    for s in range(m):
        local = np.unpackbits(stack[s, :8].view(np.uint8), axis=1, bitorder="little")[:, :rows]
        check(np.array_equal(local, bits[:, s * rows:(s + 1) * rows]),
              f"shard {s} of {m}: its bits are not the table's")
    return stack, whole, native_s, numpy_s


def mesh_inputs(h: int, seed: int, device):
    """Seeded states [256, h], table [1M, h] (0.25 N(0, 1)) and CE answers
    (phase 3's "odd" kind: repeats, item 0, -1, n_valid and V + 7), drawn on
    the card."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    states = torch.randn((TRAIN_BATCH, h), generator=gen, device=device)
    table = 0.25 * torch.randn((N_ITEMS, h), generator=gen, device=device)
    answers = torch.randint(1, N_ITEMS, (TRAIN_BATCH,), generator=gen, device=device)
    answers[:7] = torch.tensor([answers[0], answers[0], answers[0], 0, -1, N_ITEMS, N_ITEMS + 7])
    return states, table, answers


def phase_mesh_kernels(device, card):
    """m shards of the 1M-item table in one process through the merges of
    `parallel/logits.py`, held against one unsharded kernel call: the CE
    forward (loss and logZ within CE_TOL) and the per-shard backward at
    the unsharded logZ (ds summed over the shards, dT concatenated; each
    group within GRAD_TOL, WIDE_GRAD_TOL at H=512, BF16_GRAD_TOL in the bf16
    form) at MESH_CE_CASES, and the top-20 at MESH_RANK_CASES (ids and
    values bit-equal, a shard past n_valid on the kernel's empty case), each
    with one launch a shard; the shard-mode bitmasks native against numpy.
    Times the composition against the unsharded call and the merge alone.
    Returns the phase's summary."""
    import torch

    from bsarec_tpu_torch import parity
    from bsarec_tpu_torch.ops import ce, rank
    from bsarec_tpu_torch.parallel import logits as plog

    out = {"ce": {}, "rank": {}, "bitmask": {}}
    inputs = {h: mesh_inputs(h, 300 + h, device) for h in (64, 512)}
    dloss = torch.full((TRAIN_BATCH,), 1.0 / TRAIN_BATCH, device=device)
    for m, h, dtype in MESH_CE_CASES:
        name = f"m={m} H={h} {dtype or 'float32'}"
        s, t, a = inputs[h]
        loss_u, logz_u = ce.ce_loss_logz(s, t, a, dtype=dtype)
        ds_u, dt_u = ce.ce_grads(s, t, a, logz_u, dloss, dtype=dtype)
        tables = list(t.chunk(m))
        reset_counts()
        loss, logz = plog.streaming_ce_over_shards(s, tables, a, dtype)
        ds, dt = plog.streaming_ce_grads_over_shards(s, tables, a, logz_u, dloss, dtype)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts["ce_logz"] == m and counts["ce_grads"] == m,
              f"mesh CE {name}: launches {counts}, want {m} of each")
        fwd = max(float(((x - y).abs() / y.abs().clamp(min=1.0)).max())
                  for x, y in ((loss, loss_u), (logz, logz_u)))
        check(fwd <= CE_TOL, f"mesh CE {name}: loss/logZ error {fwd:.3g} > {CE_TOL}")
        errs = parity.grad_errors(ds, dt, ds_u, dt_u, a, N_ITEMS)
        tol = (parity.BF16_GRAD_TOL if dtype else parity.WIDE_GRAD_TOL if h > 256 else GRAD_TOL)
        check(max(errs.values()) <= tol, f"mesh CE {name}: gradient errors {errs} > {tol}")
        stack = logz.expand(m, -1).contiguous()
        times = {
            "fwd_ms": cuda_ms(lambda: plog.streaming_ce_over_shards(s, tables, a, dtype), 5),
            "fwd_unsharded_ms": cuda_ms(lambda: ce.ce_loss_logz(s, t, a, dtype=dtype), 5),
            "bwd_ms": cuda_ms(lambda: plog.streaming_ce_grads_over_shards(
                s, tables, a, logz_u, dloss, dtype), 3),
            "bwd_unsharded_ms": cuda_ms(lambda: ce.ce_grads(s, t, a, logz_u, dloss, dtype=dtype), 3),
            "merge_ms": cuda_ms(lambda: plog.merge_ce_stats(stack, stack), 20),
        }
        out["ce"][name] = {"launches": {"ce_logz": m, "ce_grads": m}, "fwd_err": fwd,
                           **errs, **times}
        log(f"mesh CE {name}: {m} ce_logz + {m} ce_grads launches; loss/logZ error {fwd:.3g}; "
            f"gradient errors {json.dumps(errs)}; forward {times['fwd_ms']:.3f} ms against "
            f"{times['fwd_unsharded_ms']:.3f} unsharded, backward {times['bwd_ms']:.3f} against "
            f"{times['bwd_unsharded_ms']:.3f}, merge {times['merge_ms']:.4f} ms [{card}]")
        del ds, dt, ds_u, dt_u
    bitmasks = {}
    for m, h, n_valid in MESH_RANK_CASES:
        name = f"m={m} H={h} n_valid={n_valid}"
        s, t, _ = inputs[h]
        s = s * 4.0  # scores spread past the seen items' 0.0
        if m not in bitmasks:
            seen = mesh_seen_items(EVAL_BATCH, N_ITEMS, m, 500 + m)
            stack, whole, native_s, numpy_s = mesh_bitmask_check(seen, N_ITEMS, m)
            bitmasks[m] = (torch.from_numpy(stack).to(device), torch.from_numpy(whole).to(device))
            out["bitmask"][f"m={m}"] = {"native_s": native_s, "numpy_s": numpy_s}
            log(f"mesh bitmask m={m}: [{m}, {EVAL_BATCH}, {stack.shape[2]}] native and numpy "
                f"bit-equal ({native_s:.3f} s and {numpy_s:.3f} s on the host), each shard's bits "
                f"the table's")
        stack, whole = bitmasks[m]
        tables = list(t.chunk(m))
        vals_u, ids_u = rank.streaming_masked_topk(s, t, whole, TOP_K, n_valid)
        reset_counts()
        vals, ids = plog.streaming_topk_over_shards(s, tables, stack, TOP_K, n_valid)
        torch.cuda.synchronize()
        counts = read_counts()
        check(counts["streaming_masked_topk"] == m, f"mesh top-k {name}: launches {counts}")
        check(torch.equal(ids, ids_u.long()) and torch.equal(vals, vals_u),
              f"mesh top-k {name}: ids or values differ from the unsharded kernel's")
        check(int(ids.max()) < n_valid, f"mesh top-k {name}: an id past n_valid")
        times = {"ms": cuda_ms(lambda: plog.streaming_topk_over_shards(s, tables, stack, TOP_K,
                                                                        n_valid), 5),
                 "unsharded_ms": cuda_ms(lambda: rank.streaming_masked_topk(s, t, whole, TOP_K,
                                                                             n_valid), 5)}
        out["rank"][name] = {"launches": m, **times}
        log(f"mesh top-k {name}: {m} launches, ids and values bit-equal to the unsharded "
            f"kernel's; {times['ms']:.3f} ms against {times['unsharded_ms']:.3f} unsharded "
            f"[{card}]")
    return out


def mesh_run(argv, fused=False):
    """main.main(argv) with the counts set to 0 just before and read just
    after: (scores, counts, the epoch's examples/s, its loss string, the
    log, the card's peak allocated bytes over the run
    (`torch.cuda.max_memory_allocated`, reset just before) and the bytes
    allocated at its start)."""
    import gc

    import torch
    import torch.distributed as dist

    gc.collect()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with pallas_dropout_env(fused):
        scores, counts, _ = tools_main(argv)
    peak = torch.cuda.max_memory_allocated()
    check(not dist.is_initialized(), "main left its process group behind")
    name = argv[argv.index("--train_name") + 1]
    text = read_log(os.path.join(argv[argv.index("--output_dir") + 1], name + ".log"))
    rates = re.findall(r"epoch 0: train (\d+) ex/s", text)
    losses = re.findall(r"'epoch': 0, 'rec_loss': '([^']+)'", text)
    check(len(rates) == 1 and len(losses) == 1 and math.isfinite(float(losses[0])),
          f"{name}: epoch lines {rates} {losses}")
    host_fed = "input: host-fed (--multihost)" in text
    check(host_fed == ("--multihost" in argv), f"{name}: host-fed input line {host_fed}")
    return scores, counts, float(rates[0]), losses[0], text, (peak, start)


# the runs of phase_mesh_main, in turns: plain, host-fed, mesh, host-fed
# under the mesh, host-fed, plain
MESH_11 = ["--mesh", "data:1,model:1"]
MESH_MAIN_RUNS = (("mesh_plain", []), ("mesh_host", ["--multihost"]), ("mesh_11", MESH_11),
                  ("mesh_host_11", ["--multihost", *MESH_11]), ("mesh_hostb", ["--multihost"]),
                  ("mesh_plainb", []))


def phase_mesh_main(device, workdir, card):
    """`main --mesh data:1,model:1` through a one-rank NCCL group and `main
    --multihost` (the host-fed pipeline), alone and under that mesh, on
    phase 7's corpus (BSARec, one epoch, validation, the test pass), in
    turns with the plain run (MESH_MAIN_RUNS): the scores, the epoch loss
    and the best checkpoint bit-equal to the plain run's, the same kernel
    launches, the host-fed runs' peak allocated bytes below the plain
    runs'; then SASRec on the fused dropout under the same mesh,
    device-resident and host-fed (its 14 launches a step, data rank 0's
    seed words, the same epoch loss). Returns the phase's summary."""
    import torch

    seqs = synth_corpus(TRAIN_USERS, N_ITEMS, seed=1)
    n_samples = sum(len(s[-52:-2]) for s in seqs)
    steps = math.ceil(n_samples / TRAIN_BATCH)
    eval_steps = math.ceil(TRAIN_USERS / EVAL_BATCH)
    # the device-resident training set: [N, L] inputs, [N] answers, [N] user
    # ids, int64 (max_seq_length 50)
    train_set_bytes = n_samples * (50 + 2) * 8
    common = ["--data_dir", workdir, "--data_name", "synth_train", "--output_dir", workdir,
              "--device", device.type, "--batch_size", str(TRAIN_BATCH), "--epochs", "1"]
    bsarec = common + ["--lr", str(LR), *WIDTHS]
    runs = {name: mesh_run(bsarec + ["--train_name", name] + extra)
            for name, extra in MESH_MAIN_RUNS}
    want = zero_counts() | {"ce_logz": steps, "ce_grads": steps,
                            "streaming_masked_topk": 2 * eval_steps}
    plain_run = runs["mesh_plain"]
    for name, (scores, counts, rate, loss, text, peak) in runs.items():
        check(counts == want, f"{name}: launches {counts}, want {want}")
        check(scores == plain_run[0] and loss == plain_run[3],
              f"{name}: scores {scores} / loss {loss} differ from the plain run's")
        if name.endswith("11"):
            check("mesh: {'data': 1, 'model': 1} (cuda" in text, f"{name}: no mesh line")
    plain = torch.load(os.path.join(workdir, "mesh_plain.ckpt"))
    for name in runs:
        if name == "mesh_plain":
            continue
        other = torch.load(os.path.join(workdir, name + ".ckpt"))
        check(plain.keys() == other.keys() and all(torch.equal(plain[k], other[k]) for k in plain),
              f"{name}: the checkpoint differs from the plain run's")
    rates = {name: r[2] for name, r in runs.items()}
    peaks = {name: r[5][0] - r[5][1] for name, r in runs.items()}
    host_peak = max(peaks[n] for n in ("mesh_host", "mesh_hostb"))
    plain_peak = min(peaks[n] for n in ("mesh_plain", "mesh_plainb"))
    check(host_peak < plain_peak, f"host-fed peak {host_peak} not below the plain run's "
          f"{plain_peak}")
    log(f"mesh main: --mesh data:1,model:1 (one-rank NCCL group), --multihost and --multihost "
        f"--mesh data:1,model:1 bit-equal to the plain run (scores {plain_run[0]}, epoch loss "
        f"{plain_run[3]}, checkpoint); launches {want}; epoch examples/s in turns "
        f"{json.dumps(rates)} [{card}]")
    log(f"multihost memory: max_memory_allocated over each run (reset before it) "
        f"{json.dumps({name: r[5][0] for name, r in runs.items()})}, allocated at its start "
        f"{json.dumps({name: r[5][1] for name, r in runs.items()})}, the peak less the start "
        f"{json.dumps(peaks)}; the device-resident training set {train_set_bytes} bytes "
        f"({n_samples} samples x (50 + 2) x 8); host-fed peak {host_peak} against plain "
        f"{plain_peak}, {plain_peak - host_peak} lower [{card}]")
    sasrec = common + ["--model_type", "SASRec", "--prng", "rbg", "--lr", str(SASREC_LR), *MESH_11]
    want_fused = zero_counts() | {"fused_dropout": 2 * DROPOUT_SITES * steps,
                                  "streaming_masked_topk": 2 * eval_steps}
    sas = {}
    for name, extra in (("mesh_sasrec", []), ("mesh_sasrec_host", ["--multihost"])):
        scores, counts, rate, loss, _, _ = mesh_run(sasrec + ["--train_name", name] + extra,
                                                    fused=True)
        check(counts == want_fused, f"{name}: launches {counts}, want {want_fused}")
        sas[name] = (scores, counts, rate, loss)
    check(sas["mesh_sasrec_host"][3] == sas["mesh_sasrec"][3]
          and sas["mesh_sasrec_host"][0] == sas["mesh_sasrec"][0],
          f"SASRec --multihost: loss {sas['mesh_sasrec_host'][3]} / scores differ from the "
          f"mesh run's {sas['mesh_sasrec'][3]}")
    fused_counts = sas["mesh_sasrec"][1]
    log(f"mesh main: SASRec --prng rbg BSAREC_DROPOUT=pallas --mesh data:1,model:1, epoch loss "
        f"{sas['mesh_sasrec'][3]}, {sas['mesh_sasrec'][2]:.0f} examples/s; with --multihost "
        f"the same loss and scores, {sas['mesh_sasrec_host'][2]:.0f} examples/s; launches "
        f"{fused_counts} each [{card}]")
    return {"launches": {k: v for k, v in want.items() if v}, "examples_per_s": rates,
            "plain_loss": plain_run[3],
            "fused_dropout_launches": fused_counts["fused_dropout"],
            "multihost_fused_dropout_launches": sas["mesh_sasrec_host"][1]["fused_dropout"],
            "sasrec_examples_per_s": sas["mesh_sasrec"][2],
            "sasrec_multihost_examples_per_s": sas["mesh_sasrec_host"][2],
            "peak_bytes": peaks, "train_set_bytes": train_set_bytes}


def phase_mesh_two_ranks(device, workdir, card, plain_loss: str):
    """`main --mesh data:1,model:2` as two processes in one gloo group, both
    on the one card (NCCL takes one rank a device), on phase 7's corpus for
    one epoch: every rank's scores equal, the epoch loss within
    parity.MESH_LOSS_RTOL of the plain run's (`plain_loss`, phase_mesh_main),
    and on each rank one launch a step of ce_logz and of ce_grads (its
    shard) and of the rank kernel an eval batch. Returns the summary."""
    from bsarec_tpu_torch import parity

    seqs = synth_corpus(TRAIN_USERS, N_ITEMS, seed=1)
    steps = math.ceil(sum(len(s[-52:-2]) for s in seqs) / TRAIN_BATCH)
    eval_steps = math.ceil(TRAIN_USERS / EVAL_BATCH)
    argv = ["--data_dir", workdir, "--data_name", "synth_train", "--output_dir", workdir,
            "--device", device.type, "--batch_size", str(TRAIN_BATCH), "--epochs", "1",
            "--lr", str(LR), *WIDTHS, "--train_name", "mesh_12", "--mesh", "data:1,model:2"]
    store = os.path.join(workdir, "mesh_12.store")
    env = dict(os.environ, LOCAL_RANK="0")
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, "-c", MESH_RANK_CODE, str(r), store,
                               os.path.join(workdir, f"mesh_12.rank{r}.json"), *argv],
                              cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"mesh_12 rank {r} exited {p.returncode}: {text[-3000:]}")
    results = []
    for r in range(2):
        with open(os.path.join(workdir, f"mesh_12.rank{r}.json")) as fh:
            results.append(json.load(fh))
    want = zero_counts() | {"ce_logz": steps, "ce_grads": steps,
                            "streaming_masked_topk": 2 * eval_steps}
    for r, res in enumerate(results):
        check(res["counts"] == want, f"mesh_12 rank {r}: launches {res['counts']}, want {want}")
        check(res["scores"] == results[0]["scores"], f"mesh_12 rank {r}: scores differ")
    text = read_log(os.path.join(workdir, "mesh_12.log"))
    losses = re.findall(r"'epoch': 0, 'rec_loss': '([^']+)'", text)
    rates = re.findall(r"epoch 0: train (\d+) ex/s", text)
    check("mesh: {'data': 1, 'model': 2} (cuda, item table rows split over 2; loss "
          "sharded_streaming, eval sharded_streaming)" in text, "mesh_12: no mesh line")
    check(len(losses) == 1 and abs(float(losses[0]) - float(plain_loss))
          <= parity.MESH_LOSS_RTOL * abs(float(plain_loss)),
          f"mesh_12: epoch loss {losses} against the plain run's {plain_loss}")
    log(f"mesh two ranks: main --mesh data:1,model:2 over gloo, both ranks on cuda:0: epoch loss "
        f"{losses[0]} (plain {plain_loss}), scores {results[0]['scores']}, {rates[0]} examples/s; "
        f"launches a rank {want} [{card}]")
    return {"launches_per_rank": {k: v for k, v in want.items() if v},
            "examples_per_s": float(rates[0]), "loss": losses[0]}


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

    with timed("rank kernel vs plain"):
        worst_err, full = phase_kernels(device)
    with timed("CE kernels vs plain"):
        ce_err, ce_full = phase_ce_kernels(device)
    with timed("mesh: m shards of the 1M-item table through the merges vs the unsharded kernels"):
        mesh_kernels = phase_mesh_kernels(device, card)
    with timed("wide: kernels vs plain, main --hidden_size 512 (train, resume, export, bf16), times"):
        wide_err, wide_rank_err, wide_ce_full, wide_rank_full = phase_wide_kernels(device)
        wide_paths = phase_wide_train(device, card)
        wide_times = phase_wide_times(wide_ce_full, wide_rank_full, card)
        del wide_ce_full, wide_rank_full
    with timed("mid: the CE pairs at 64 < H <= 256 vs plain in both forms, main --hidden_size "
               "256 (bf16: train, eval, export; fp32: train), times"):
        mid_err, mid_full = phase_mid_kernels(device)
        mid_paths = phase_mid_train(device, card)
        # the bf16 entries at B=256, V=1M, H in {128, 256}, in turns with the
        # fp32 form; the training step's CE in at most 5 device operations
        # (no states scratch)
        mid_times = {h: phase_ce_times(mid_full[h], card, BF16) for h in sorted(mid_full)}
        # the fp32 entries there (ce_fwd_mid_tf32_kernel, ce_bwd_wide_tf32_kernel)
        mid_times32 = {h: phase_ce_times(mid_full[h], card, extras=False) for h in sorted(mid_full)}
        del mid_full
        for form, rate, times in (("bf16", mid_paths["examples_per_s"], mid_times),
                                  ("fp32", mid_paths["examples_per_s_fp32"], mid_times32)):
            step_ms = 1e3 * TRAIN_BATCH / rate
            ce_ms = times[MID_H]["ce_logz"]["ms"] + times[MID_H]["ce_grads"]["ms"]
            log(f"mid train path: the step's CE kernels (ce_loss_logz + ce_grads at B={TRAIN_BATCH} "
                f"V={N_ITEMS} H={MID_H}, {form} form, timed above) {ce_ms:.4f} ms of a {step_ms:.2f} "
                f"ms step ({rate:.0f} examples/s in main's epoch) [{card}]")
    with timed("dropout kernel vs plain"):
        dropout_err = phase_dropout_kernels(device)
    with timed("one step, kernels vs plain"):
        phase_step(device)
    with timed("one bf16 step, kernels vs plain"):
        phase_bf16_step(device, card)
    with timed("one SASRec step, dropout kernel vs plain"):
        phase_sasrec_step(device)
    with timed("eval main path"), tempfile.TemporaryDirectory() as workdir:
        launches, eval_onchip, eval_seconds, seqs, model = phase_main_path(device, workdir)
    log(f"eval: {N_USERS} users in {eval_seconds:.3f}s = {N_USERS / eval_seconds:.1f} users/s "
        f"(test pass of main --do_eval, first batch included) [{card}]")
    with timed("train main path"), tempfile.TemporaryDirectory() as workdir:
        train_launches, train_rate = phase_train(device, workdir)
        log(f"train: {train_rate:.0f} examples/s in the second epoch of main (--epochs 2, "
            f"validation excluded) [{card}]")
        with timed("serving main path"):
            serving_fields = phase_serving(device, workdir, card)
        with timed("tools: the native library, --remat steps and epoch, --profile, --dump_seqout"):
            tools = {"native_host_s": phase_tools_native(workdir, card),
                     "remat_steps": phase_tools_remat(device, card)}
            tools |= phase_tools_main(device, workdir, card)
        with timed("mesh: main --mesh data:1,model:1 (one-rank NCCL group) and --multihost in "
                   "turns with the plain run, SASRec on the fused dropout, two gloo ranks on the "
                   "card"):
            mesh = phase_mesh_main(device, workdir, card)
            mesh["two_ranks"] = phase_mesh_two_ranks(device, workdir, card, mesh["plain_loss"])
    with timed("SASRec train main path"), tempfile.TemporaryDirectory() as workdir:
        sasrec_launches, fused_rate, nn_rate = phase_sasrec_train(device, workdir, card)
    log(f"SASRec train: {fused_rate:.0f} examples/s with the fused dropout kernel, {nn_rate:.0f} "
        f"with nn.Dropout, in the second epoch of main (separate runs, in that order) [{card}]")
    with timed("bf16 main paths (BSARec train/resume/eval/export/serve, SASRec)"):
        bf16_paths = phase_bf16_train(device, card)
    with timed("rank times and eval breakdown"):
        times = phase_times(full, card)
        phase_breakdown(device, seqs, model, card)
    del full, model
    with timed("CE times and train breakdown"):
        ce_times = phase_ce_times(ce_full, card)
        bf16_times = phase_ce_times(ce_full, card, BF16)
        del ce_full
        phase_train_breakdown(device, card)
        bf16_turns = phase_bf16_train_turns(device, card)
    with timed("dropout times and SASRec breakdown"):
        dropout_times = phase_dropout_times(device, card)
        phase_sasrec_breakdown(device, card)
    with timed("zoo: dropout kernel at the zoo's shapes"):
        dropout_err = max(dropout_err, phase_zoo_dropout(device))
    with timed("zoo: one step per model, kernels on the card vs plain on the CPU"):
        zoo_step_counts = phase_zoo_steps(device, card)
    with timed("zoo: main per model"), tempfile.TemporaryDirectory() as workdir:
        zoo_counts, zoo_rates, zoo_serving = phase_zoo_train(device, workdir, card)
    with timed("zoo: step and eval times, device busy share"):
        zoo_profile = phase_zoo_profile(device, card)
    with tempfile.TemporaryDirectory() as preprec_dir:
        with timed("preprec: NewRec main (epoch, method-1 eval), method 3 at 1M items, trace"):
            preprec = phase_preprec(device, card, preprec_dir)
        with timed("preprec zoo: five models' main, mostpop, SASRecB method 3 at 1M items, "
                   "scores, user embeddings, fs_transfer, the scorer"):
            preprec_zoo = phase_preprec_zoo(device, card, preprec_dir)
    for mt, (train_rate, users_s) in zoo_rates.items():
        prof = zoo_profile[mt]
        busy = prof["busy_share"]
        log(f"zoo {mt}: train {train_rate:.0f} examples/s (main's first epoch), "
            f"{prof['train_examples_per_s']:.0f} (steady steps); eval {users_s:.0f} users/s "
            f"(main's test pass), {prof['eval_users_per_s']:.0f} (steady batches); device busy "
            f"{'not measured' if busy is None else f'{100 * busy:.1f}%'} of a traced step [{card}]")

    def zoo_fields(name):
        fields = {"zoo_launches": {mt: c[name] for mt, c in zoo_counts.items()},
                  "zoo_step_launches": {mt: c[name] for mt, c in zoo_step_counts.items()}}
        if f"{name}_onchip" in next(iter(zoo_counts.values())):
            fields["zoo_onchip_launches"] = {mt: c[f"{name}_onchip"] for mt, c in zoo_counts.items()}
        return fields

    kernels = [{
        "name": "streaming_masked_topk",
        "route": "cuda",
        "source": "bsarec_tpu_torch/csrc/streaming_rank.cu",
        "replaces": "bsarec_tpu/ops/pallas_rank.py:165",
        "launches": launches,
        "onchip_launches": eval_onchip,
        "max_abs_err": worst_err,
        **times,
        "serving_launches": serving_fields["serving_launches"],
        "serving_onchip_launches": serving_fields["serving_onchip_launches"],
        "serving_ms": serving_fields["serving_ms"],
        **zoo_fields("streaming_masked_topk"),
        "zoo_serving_max_abs_err": zoo_serving,
    }]
    ce_replaces = {"ce_logz": "bsarec_tpu/ops/pallas_ce.py:222",
                   "gold_rows": "bsarec_tpu/ops/pallas_ce.py:152",
                   "ce_grads": "bsarec_tpu/ops/pallas_ce.py:340"}
    for name, replaces in ce_replaces.items():
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "bsarec_tpu_torch/csrc/streaming_ce.cu",
            "replaces": replaces,
            "launches": train_launches[name],
            "max_abs_err": ce_err[None][name],
            **ce_times[name],
            **({"onchip_launches": train_launches[f"{name}_onchip"]} if name != "gold_rows" else {}),
            **zoo_fields(name),
            "remat_step_launches": tools["remat_steps"]["BSARec H=64"]["remat_launches"].get(name, 0),
            "remat_main_launches": tools["remat_main_launches"][name],
        })
    onchip_tc_kernels = {"ce_logz": "ce_fwd_onchip_tc_kernel", "ce_grads": "ce_bwd_onchip_tc_kernel"}
    for name in ("ce_logz", "ce_grads"):  # the bf16-operand forms, on --dtype bf16's main path
        train = bf16_paths["train"]
        kernels.append({
            "name": f"{name} (bf16-operand form)",
            "kernel": onchip_tc_kernels[name],
            "route": "cuda",
            "source": "bsarec_tpu_torch/csrc/streaming_ce.cu",
            "replaces": ce_replaces[name],
            "launches": train[f"{name}_bf16"],
            "onchip_launches": train[f"{name}_onchip"],
            "max_abs_err": ce_err[BF16][name],
            **bf16_times[name],
        })
    kernels.append({
        "name": "fused_dropout",
        "route": "cuda",
        "source": "bsarec_tpu_torch/csrc/fused_dropout.cu",
        "replaces": "bsarec_tpu/ops/pallas_dropout.py:69",
        "launches": sasrec_launches["fused_dropout"],
        "max_abs_err": dropout_err,
        **dropout_times,
        **zoo_fields("fused_dropout"),
        "bf16_path_launches": bf16_paths["sasrec"]["fused_dropout"],
        "bf16_path_bf16_launches": bf16_paths["sasrec"]["fused_dropout_bf16"],
        "remat_step_launches":
            tools["remat_steps"]["SASRec fused dropout"]["remat_launches"]["fused_dropout"],
    })
    # the wide main path (H = 512): the rank kernel on its tensor-core route,
    # the CE kernels on their wide routes; launches from its first run (one
    # epoch), every one on rank_wide_tf32_kernel (phase_wide_train checks it)
    wide_train = wide_paths["train"]
    kernels.append({
        "name": f"streaming_masked_topk (H={WIDE_H})",
        "kernel": "rank_wide_tf32_kernel",
        "route": "cuda",
        "source": "bsarec_tpu_torch/csrc/streaming_rank.cu",
        "replaces": "bsarec_tpu/ops/pallas_rank.py:165",
        "launches": wide_train["streaming_masked_topk"],
        "tc_launches": wide_train["rank_tc"],
        "resume_launches": wide_paths["resume"]["streaming_masked_topk"],
        "bf16_path_launches": wide_paths["bf16"]["streaming_masked_topk"],
        "eval_pass_s": wide_paths["eval_s"],
        "max_abs_err": wide_rank_err,
        **{k: v for k, v in wide_times["rank"].items() if k not in ("k128", "b16")},
        "b16": wide_times["rank"]["b16"],
        "k128_wide_form": wide_times["rank"]["k128"],
    })
    for name in ("ce_logz", "ce_grads"):
        kernels.append({
            "name": f"{name} (wide route, H={WIDE_H})",
            "route": "cuda",
            "source": "bsarec_tpu_torch/csrc/streaming_ce.cu",
            "replaces": ce_replaces[name],
            "launches": wide_train[f"{name}_wide"],
            "resume_launches": wide_paths["resume"][f"{name}_wide"],
            "max_abs_err": wide_err[None][name],
            **wide_times["ce32"][name],
        })
        # the bf16 forms run ce_fwd_wide_tc_kernel and ce_bwd_wide_tc_kernel
        kernels.append({
            "name": f"{name} (bf16-operand form, wide route, tensor cores, H={WIDE_H})",
            "route": "cuda",
            "source": "bsarec_tpu_torch/csrc/streaming_ce.cu",
            "replaces": ce_replaces[name],
            "launches": wide_paths["bf16"][f"{name}_bf16"],
            "max_abs_err": wide_err[BF16][name],
            **wide_times["ce16"][name],
        })
    # the middle route's bf16 pair (B <= 256, 64 < H <= 256): launches from
    # main --hidden_size 256 --dtype bf16's epoch, every one on these kernels
    mid_kernels = {"ce_logz": "ce_fwd_mid_tc_kernel", "ce_grads": "ce_bwd_mid_tc_kernel"}
    for name in ("ce_logz", "ce_grads"):
        kernels.append({
            "name": f"{name} (bf16-operand form, middle route, tensor cores, H={MID_H})",
            "kernel": mid_kernels[name],
            "route": "cuda",
            "source": "bsarec_tpu_torch/csrc/streaming_ce.cu",
            "replaces": ce_replaces[name],
            "launches": mid_paths["train"][f"{name}_mid"],
            "max_abs_err": mid_err[BF16][name],
            **mid_times[MID_H][name],
            "h128": mid_times[128][name],
        })
    # the fp32 form on the middle route: ce_logz on ce_fwd_mid_tf32_kernel,
    # ce_grads on ce_bwd_wide_tf32_kernel (launches: main --hidden_size 256's
    # fp32 epoch; errors: the largest over the middle route's fp32 cases,
    # every one of them on these two kernels)
    mid32 = mid_paths["train_fp32"]
    kernels += [{
        "name": f"ce_logz (fp32 form, middle route, wgmma, H={MID_H})",
        "kernel": "ce_fwd_mid_tf32_kernel",
        "route": "cuda",
        "source": "bsarec_tpu_torch/csrc/streaming_ce.cu",
        "replaces": ce_replaces["ce_logz"],
        "launches": mid32["ce_logz_mid_tf32"],
        "max_abs_err": mid_err[None]["ce_logz"],
        **mid_times32[MID_H]["ce_logz"],
        "h128": mid_times32[128]["ce_logz"],
    }, {
        "name": f"ce_grads (fp32 form, middle route, H={MID_H})",
        "kernel": "ce_bwd_wide_tf32_kernel",
        "route": "cuda",
        "source": "bsarec_tpu_torch/csrc/streaming_ce.cu",
        "replaces": ce_replaces["ce_grads"],
        "launches": mid32["ce_grads_mid_tf32"],
        "max_abs_err": mid_err[None]["ce_grads"],
        **mid_times32[MID_H]["ce_grads"],
        "h128": mid_times32[128]["ce_grads"],
    }]
    # the vocab-sharded mesh: launches of main --mesh data:1,model:1 (one
    # rank), of each rank of main --mesh data:1,model:2 (two gloo ranks on
    # the card), and one a shard of the one-process composition's checks;
    # the host-fed runs' (main --multihost, alone and under the one-rank
    # mesh: each run's launches, checked equal to the plain run's)
    mesh_two = mesh["two_ranks"]["launches_per_rank"]
    for entry in kernels:
        name = entry["name"]
        if name in ("streaming_masked_topk", "ce_logz", "ce_grads"):
            entry |= {"mesh_launches": mesh["launches"][name],
                      "mesh_two_rank_launches_per_rank": mesh_two[name],
                      "multihost_launches": mesh["launches"][name]}
        if name == "streaming_masked_topk":
            entry["mesh_shard_launches"] = {c: r["launches"] for c, r in mesh_kernels["rank"].items()}
            entry["mesh_ms"] = {c: {"ms": r["ms"], "unsharded_ms": r["unsharded_ms"]}
                                for c, r in mesh_kernels["rank"].items()}
        if name in ("ce_logz", "ce_grads"):
            key = "fwd" if name == "ce_logz" else "bwd"
            entry["mesh_shard_launches"] = {c: r["launches"][name]
                                            for c, r in mesh_kernels["ce"].items()}
            entry["mesh_ms"] = {c: {"ms": r[f"{key}_ms"], "unsharded_ms": r[f"{key}_unsharded_ms"]}
                                for c, r in mesh_kernels["ce"].items()}
        if name == "fused_dropout":
            entry |= {"mesh_launches": mesh["fused_dropout_launches"],
                      "multihost_launches": mesh["multihost_fused_dropout_launches"]}
    kernels[0] |= {"bf16_path_launches": bf16_paths["train"]["streaming_masked_topk"],
                   "bf16_serving_launches": bf16_paths["serving"]["streaming_masked_topk"],
                   "bf16_serving_max_abs_err": bf16_paths["serving_max_abs_err"]}
    log(f"train bf16 vs fp32 examples/s and busy share: {json.dumps(bf16_turns)} [{card}]")
    log(f"preprec: {json.dumps(preprec)} [{card}]")
    log(f"preprec zoo: {json.dumps(preprec_zoo)} [{card}]")
    log(f"tools: {json.dumps(tools)} [{card}]")
    log(f"mesh: {json.dumps(mesh | {'kernels': mesh_kernels})} [{card}]")
    log(card)
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())

"""Where the four tensor-core kernels spend their time: build copies of
`csrc/streaming_ce.cu` with parts of a kernel cut out, and time each at
B=256, V=1,000,000, H=512.

Each variant is this checkout's source, `csrc/tensor_core.cuh` inlined,
with text replacements (each must match exactly once, so a variant that
no longer applies fails loudly).
For `ce_bwd_wide_tc_kernel` (through the C entry `ce_grads`): the whole
kernel, its logits steps alone and its products steps alone, then each
of those without one kind of work (state copies, table loads, the bf16
tile stores, the MMAs; the carry loads, the stores). For
`ce_fwd_wide_tc_kernel` (through `ce_logz`, the "forward" variants): the
whole kernel, then without the state copies, the table loads, the table
stores, the MMAs or the (max, sum) epilogue, and the MMAs alone. For
`ce_bwd_wide_tf32_kernel` (through `ce_grads` in the fp32 form, the "fp32"
variants): the whole kernel, its logits steps alone and its products
steps alone, without its copies, without its MMAs (and so without the
fragment loads and hi/lo splits that feed only them), the MMAs alone (no
copies, no carry loads, no stores of dT and ds_part), hi split by
cvt.rna.tf32.f32 (the same rounding as the kernel's integer form), and
1xTF32: the two correction passes of every product cut, which shows what
fp32 accuracy costs. For `ce_fwd_wide_tf32_kernel` (through `ce_logz` in
the fp32 form, the "fwd32" variants): the whole kernel, its MMAs alone
(no copies; every fragment load and hi/lo split, MMA and fold kept), its
memory path alone (the copies and the fold; no fragment loads, splits
or MMAs), 1xTF32, and the hi/lo split once per staged element in place
of once per fragment load (each slot doubled into hi and lo planes, the
rows split in place a step ahead of the MMAs, two ldmatrix a fragment:
the form first planned). The cut variants compute wrong
results and are timed only, but for the cvt.rna split and the split once
per staged chunk, which must give their kernel's bits, and the 1xTF32
ones, which are held beside their kernel against the plain fp32 version
and an fp64 one (`ce_grads_plain`, `ce_logz_plain` on float64 inputs):
the backward at the main shape and at `tests/test_torch_port_cuda.py`'s
H = 260 route-boundary case, by `parity.grad_errors` (each group
relative to its largest plain entry) and, elementwise, the largest
|error| / (atol + rtol |want|) at that test's GRAD_TOL (rtol 1e-4, atol
1e-5); the forward's logZ at the main shape, the largest |error| /
max(1, |want|) (chip_smoke.py's CE_TOL); the plain fp32 version against
the fp64 one too. Every library is built
with `ops/_build.py`'s flags into `build/ablate/`, one nvcc each, all
started together, and called on the same inputs; one reading is the
mean of 10 calls (CUDA events, after one warm-up), the variants timed in
order and then in reverse.

With `--onchip`, the bf16 form on the on-chip route instead (B=256,
V=1,000,000, H=64, `ONCHIP_VARIANTS`): both C entries in the bf16 form as
the source has them (`ce_fwd_onchip_tc_kernel`, `ce_bwd_onchip_tc_kernel`),
the same shapes routed to the wide route's tensor-core kernels
(`ce_fwd_wide_tc_kernel`, `ce_bwd_wide_tc_kernel`, which take any
H % 4 == 0, padding H to 64: the yardstick the on-chip kernels were
designed against), the on-chip kernels with their MMAs and epilogue alone
(no table copies, no rounding into bf16, no dT stores), with everything
but their MMAs (no fragment loads or MMAs), without the forward's fold
and the backward's expf, and the backward without its dT or its ds
product, in turns with the fp32 form's kernels and
the library calls of `chip_smoke.py:bf16_yardsticks`; each variant's logZ
and gradients are printed against the plain bf16 versions. Every library
takes one split plan: whole 128-column tiles for the forward and whole
256-column tiles for the backward (`ops/ce.py:tc_splits`), which every
kernel there accepts.

With `--mid`, the bf16 form on the middle route instead (B=256,
V=1,000,000, H in {128, 256}, `MID_VARIANTS`): both C entries in the bf16
form as the source has them (`ce_fwd_mid_tc_kernel`,
`ce_bwd_mid_tc_kernel`); the yardstick the middle pair must beat, the same
shapes routed to the wide route's tensor-core kernels
(`ce_fwd_wide_tc_kernel`, `ce_bwd_wide_tc_kernel`: the states rounded
into a scratch by an extra launch and streamed from L2 every tile, the
backward's 256-column p); the same shapes on the older sweeps
(`ce_fwd_partial_kernel<true>`, `ce_bwd_sweep_kernel<true>`: the route
the middle pair replaced); the middle pair with their MMAs and epilogue
alone (no table loads, no rounding into the slots, no dT stores, no
ds_part carry or stores), with everything but their MMAs (no fragment
loads or MMAs), without the forward's fold, and the backward without its
ds_part carry loads, its ds_part stores, its dT stores, its products
steps (logits steps alone) or its logits steps (products steps alone);
and four whole variants of the backward (their outputs held as the
kernel's): ds_part carried through the MMAs, as the wide backward carries
it, L2 eviction hints (ds_part evict-last, dT evict-first), and the
backward's other choice, `ce_bwd_wide_tc_kernel`'s 256-column p with its
states streamed from the fp32 states and rounded on chip (no scratch, no
extra launch; `wide_streamed`), the chunk held in registers a step ahead
or stored as soon as it is loaded;
in turns with the fp32 form's kernels (the older sweeps at these shapes)
and `chip_smoke.py:bf16_yardsticks`' library calls; each whole variant's
logZ and gradients are printed against the plain bf16 versions and
`parity.ce_grads_bf16_in_order`. Every library takes one split plan:
whole 128-column tiles for the forward and whole 256-column tiles for
the backward, which every kernel there accepts. `--mid` also times the
fp32 form's middle route (the variants named "fp32 ...", each in the
fp32 form beside the plain fp32 version and an fp64 one): the route as
it is (`ce_fwd_mid_tf32_kernel`, the backward on
`ce_bwd_wide_tf32_kernel`), the forward's yardstick (both entries on the
wide 3xTF32 kernels), the backward on `ce_bwd_mid_tf32_kernel` (`wgmma`,
which the route does not take; every cut below takes it too), the
logits' partial sums one or four k8 blocks long or
summed over all of H in the MMAs' accumulators, the pair's MMAs alone
(no copies, loads, plane stores, dT stores or ds_part traffic), their
memory path alone (no MMAs), without the forward's fold and the
backward's carry, and the backward's logits or products steps alone;
with the fp32 library calls (`F.cross_entropy` over the fp32 product).
`--only TEXT` builds the variants whose name holds TEXT.

    python3 bsarec_tpu_torch/tools/ablate_ce_tc.py            # needs a card and nvcc
    python3 bsarec_tpu_torch/tools/ablate_ce_tc.py --onchip   # the H=64 variants
    python3 bsarec_tpu_torch/tools/ablate_ce_tc.py --mid      # the H=128 and H=256 variants
    python3 bsarec_tpu_torch/tools/ablate_ce_tc.py --mid-batches  # the fp32 backward's route by B
    python3 bsarec_tpu_torch/tools/ablate_ce_tc.py --check    # the replacements apply (no card)

With `--mid-batches`, the fp32 form's two backward kernels on the middle
route at V=1,000,000, H in {128, 256} and B in MID_BATCHES: the route's
`ce_bwd_wide_tf32_kernel` and the variant `ce_bwd_mid_tf32_kernel`
(`wgmma`), with the fp32 forward beside them; each checked against the
plain fp32 version at B=37, V=5,003 and at every B timed (gradients
within `parity.WIDE_GRAD_TOL`, two calls bit-equal), then timed in
turns. This is the reading behind the route's choice of
`ce_bwd_wide_tf32_kernel` at B = 256, the batch `main` trains at.

Prints one JSON line per variant, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "bsarec_tpu_torch" / "csrc"
OUT = ROOT / "build" / "ablate"
B, V, H = 256, 1_000_000, 512

LOGITS_ONLY = [("  const int n_lg = 4 * nl, n_steps = n_lg + np,",
                "  const int n_lg = 4 * nl, n_steps = n_lg,")]
PRODUCTS_ONLY = [
    ("      for (int s = 0; s < n_steps; s += 2) {",
     "      for (int s = n_lg; s < n_steps; s += 2) {"),
    ("      issue(0);\n      onchip::cp_async_commit();\n"
     "      load_table(0, pre_a);\n      fill(0, pre_a);\n      load_table(1, pre_b);",
     "      issue(n_lg);\n      onchip::cp_async_commit();"),
]
NO_STATE_COPIES = [
    ("            tc::cp_async_16(dst + r * TC_LDL + c8, sb + (size_t)(g0 + r) * Hp + h0 + c8);\n",
     "")]
NO_TABLE_LOADS = [("          pre[q] = (col0 + r < V && h < H)",
                   "          pre[q] = (col0 + r < 0 && h < H)")]
NO_TILE_STORES = [
    ("          *reinterpret_cast<uint2*>(tile_bf16 + (size_t)(c0 + r) * Hp + h0 + c4) = v;\n", "")]
NO_LOGITS_MMA = [("          for (int kk = 0; kk < TC_HL; kk += 16) {",
                  "          for (int kk = 0; kk < 0; kk += 16) {")]
NO_CARRY = [("          const float4 v = t != t_begin ? src[(4 * i + j) * 32]",
             "          const float4 v = false ? src[(4 * i + j) * 32]"),
            ("                if (from && h < H && j0 + m < V)", "                if (false)")]
NO_STORES = [("                  if (h < H && j0 + m < V)  // H % 4 == 0 and h is even: h + 1 < H too",
              "                  if (false)"),
             ("                dst[(4 * i + j) * 32] = make_float4(",
              "                if (false) dst[(4 * i + j) * 32] = make_float4(")]
NO_PRODUCTS_MMA = [("          for (int k = 0; k < TC_SV; k += 16) {",
                    "          for (int k = 0; k < 0; k += 16) {")]

FWD_NO_STATE_COPIES = [
    ("        tc::cp_async_16(dst + r * FT_LD + c8, sb + (size_t)(g0 + r) * Hp + h0 + c8);\n", "")]
FWD_NO_TABLE_LOADS = [("      rows[q] = (c0 + r < V && h < H)", "      rows[q] = (c0 + r < 0 && h < H)")]
FWD_NO_TABLE_STORES = [  # the loads kept: a store that never runs still reads them
    ("      *reinterpret_cast<uint2*>(dst + r * FT_LD + c4) =\n",
     "      if (V < 0) *reinterpret_cast<uint2*>(dst + r * FT_LD + c4) =\n")]
FWD_NO_MMA = [("      for (int k16 = 0; k16 < TC_HL; k16 += 16) {",
               "      for (int k16 = 0; k16 < 0; k16 += 16) {")]
FWD_NO_EPILOGUE = [("      if (s % nk == nk - 1)  // the tile's logits are complete",
                    "      if (false)  // the tile's logits are complete")]

FP32_LOGITS_ONLY = [("  const int n_lg = (TF_COLS / TF_SUB) * nl, n_steps = n_lg + np;",
                     "  const int n_lg = (TF_COLS / TF_SUB) * nl, n_steps = n_lg;")]
FP32_PRODUCTS_ONLY = [
    ("      for (int s = 0; s < n_lg; ++s) {\n        begin(s);",
     "      for (int s = n_lg; s < n_lg; ++s) {\n        begin(s);"),
    ("      issue(0);\n      onchip::cp_async_commit();\n\n      // the logits steps",
     "      issue(n_lg);\n      onchip::cp_async_commit();\n\n      // the logits steps")]
FP32_NO_COPIES = [("    tc::cp_async_16_zfill(dst + r * ld + c, full ?", "    if (R < 0) tc::cp_async_16_zfill(dst + r * ld + c, full ?")]
FP32_NO_CARRY = [("            prev[q] = src ? *reinterpret_cast<const float4*>(src) : zero;",
                  "            prev[q] = zero;"),
                 ("          for (int q = 0; q < 8; ++q) prev[q] = t != t_begin ? src[q * 32] : zero;",
                  "          for (int q = 0; q < 8; ++q) prev[q] = zero;")]
FP32_NO_STORES = [("            if (dst)\n              *reinterpret_cast<float4*>(dst) = make_float4(",
                   "            if (V < 0)\n              *reinterpret_cast<float4*>(dst) = make_float4("),
                  ("            dst[q * 32] = make_float4(prev[q].x + c[i][0][e]",
                   "            if (V < 0) dst[q * 32] = make_float4(prev[q].x + c[i][0][e]")]
FP32_PASSES = [("            tc::mma_3xtf32(part, ah, al, bh, bl);", "            tc::mma_pass(2, part, ah, al, bh, bl);"),
               ("            tc::mma_3xtf32(c, ah, al, bh, bl);", "            tc::mma_pass(2, c, ah, al, bh, bl);"),
               ("            for (int pass = 0; pass < 3; ++pass)  // the two blocks'",
                "            for (int pass = 2; pass < 3; ++pass)  // the two blocks'")]
FP32_CVT_SPLIT = [("  hi = (x + 0x1000u) & 0xffffe000u;",
                   '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(hi) : "f"(__uint_as_float(x)));')]
FP32_NO_MMA = [("            tc::mma_3xtf32(part, ah, al, bh, bl);", ""),
               ("            tc::mma_3xtf32(c, ah, al, bh, bl);", ""),
               ("            for (int pass = 0; pass < 3; ++pass)  // the two blocks'",
                "            for (int pass = 3; pass < 3; ++pass)  // the two blocks'")]

# ce_fwd_wide_tf32_kernel
FW32_NO_COPIES = [
    ("      copy_chunk_async<TC_ROWS, FW_HC>(S, FW_LD, states, g0, B, H, h0);\n"
     "      copy_chunk_async<FT_COLS, FW_HC>(S + FW_SPLANE, FW_LD, table, (t_begin + s / nk) * FT_COLS,\n"
     "                                       V, H, h0);\n", "")]
FW32_NO_MMA = [("      for (int kk = 0; kk < FW_HC; kk += 8) {", "      for (int kk = 0; kk < 0; kk += 8) {")]
FW32_PASSES = [("\n          tc::mma_3xtf32(part, ah, al, bh, bl);",
                "\n          tc::mma_pass(2, part, ah, al, bh, bl);")]
# the hi/lo split once per staged element instead of once per fragment
# load: each slot doubled into hi planes (states, table rows) and lo
# planes, the rows copied into the lo planes, each thread's copied pieces
# split in place one step ahead of the MMAs (so the copies of step s + 1
# are awaited at step s), and a fragment's hi and lo two ldmatrix; the
# same bits
FW32_SPLIT_ONCE = [
    ("constexpr int FW_SLOT = FW_SPLANE + FT_COLS * FW_LD;  // states, then table rows",
     "constexpr int FW_SLOT = 2 * (FW_SPLANE + FT_COLS * FW_LD);  // hi planes, then lo planes"),
    ("      copy_chunk_async<TC_ROWS, FW_HC>(S, FW_LD, states, g0, B, H, h0);\n"
     "      copy_chunk_async<FT_COLS, FW_HC>(S + FW_SPLANE, FW_LD, table, (t_begin + s / nk) * FT_COLS,\n"
     "                                       V, H, h0);\n    };\n",
     "      copy_chunk_async<TC_ROWS, FW_HC>(S + FW_SLOT / 2, FW_LD, states, g0, B, H, h0);\n"
     "      copy_chunk_async<FT_COLS, FW_HC>(S + FW_SLOT / 2 + FW_SPLANE, FW_LD, table,\n"
     "                                       (t_begin + s / nk) * FT_COLS, V, H, h0);\n    };\n"
     "    auto split_slot = [&](int s) {\n"
     "      for (int half = 0; half < 2; ++half) {\n"
     "        float* lo = slot(s) + FW_SLOT / 2 + half * FW_SPLANE;\n"
     "        const int n = half ? FT_COLS : TC_ROWS;\n"
     "        for (int q = 0; q < n * (FW_HC / 4) / THREADS; ++q) {\n"
     "          const int i = tid + THREADS * q, r = i / (FW_HC / 4), c = (i % (FW_HC / 4)) * 4;\n"
     "          float* x = lo + r * FW_LD + c;\n"
     "          const float4 v = *reinterpret_cast<const float4*>(x);\n"
     "          const float w[4] = {v.x, v.y, v.z, v.w};\n"
     "          uint32_t h[4], l[4];\n"
     "          for (int e = 0; e < 4; ++e) tc::split_tf32(__float_as_uint(w[e]), h[e], l[e]);\n"
     "          *reinterpret_cast<float4*>(x - FW_SLOT / 2) = make_float4(\n"
     "              __uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]), __uint_as_float(h[3]));\n"
     "          *reinterpret_cast<float4*>(x) = make_float4(\n"
     "              __uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));\n"
     "        }\n"
     "      }\n"
     "    };\n"),
    ("    for (int s = 0; s < n_steps; ++s) {\n"
     "      tc::cp_async_wait_group<FW_STAGES - 2>();  // this thread's copies of step s have landed\n",
     "    onchip::cp_async_wait_all();\n"
     "    if (n_steps > 0) split_slot(0);\n"
     "    for (int s = 0; s < n_steps; ++s) {\n"
     "      onchip::cp_async_wait_all();  // step s + 1's copies too\n"),
    ("      onchip::cp_async_commit();  // (empty past the last step: one group a step)\n"
     "      const float* S = slot(s);\n",
     "      onchip::cp_async_commit();\n"
     "      if (s + 1 < n_steps) split_slot(s + 1);\n"
     "      const float* S = slot(s);\n"),
    ("#pragma unroll\n    for (int e = 0; e < 4; ++e) tc::split_tf32(h[e], h[e], l[e]);",
     "    tc::ldmatrix_x4(l, p + FW_SLOT / 2);"),
]

# variant: replacements; "kernel" (the source as it is) is timed through every entry
VARIANTS = {
    "kernel": [],
    "logits steps only": LOGITS_ONLY,
    "logits: no state copies": LOGITS_ONLY + NO_STATE_COPIES,
    "logits: no table loads": LOGITS_ONLY + NO_TABLE_LOADS,
    "logits: no bf16 tile stores": LOGITS_ONLY + NO_TILE_STORES,
    "logits: no MMAs": LOGITS_ONLY + NO_LOGITS_MMA,
    "logits: MMAs alone": LOGITS_ONLY + NO_STATE_COPIES + NO_TABLE_LOADS + NO_TILE_STORES,
    "products steps only": PRODUCTS_ONLY,
    "products: no carry loads": PRODUCTS_ONLY + NO_CARRY,
    "products: no stores": PRODUCTS_ONLY + NO_STORES,
    "products: no MMAs": PRODUCTS_ONLY + NO_PRODUCTS_MMA,
    "forward: no state copies": FWD_NO_STATE_COPIES,
    "forward: no table loads": FWD_NO_TABLE_LOADS,
    "forward: no table stores": FWD_NO_TABLE_STORES,
    "forward: no MMAs": FWD_NO_MMA,
    "forward: no epilogue": FWD_NO_EPILOGUE,
    "forward: MMAs alone": FWD_NO_STATE_COPIES + FWD_NO_TABLE_LOADS + FWD_NO_TABLE_STORES,
    "fp32: logits steps only": FP32_LOGITS_ONLY,
    "fp32: products steps only": FP32_PRODUCTS_ONLY,
    "fp32: no copies": FP32_NO_COPIES,
    "fp32: no MMAs": FP32_NO_MMA,
    "fp32: MMAs alone": FP32_NO_COPIES + FP32_NO_CARRY + FP32_NO_STORES,
    "fp32: hi by cvt.rna": FP32_CVT_SPLIT,
    "fp32: 1xTF32": FP32_PASSES,
    "fwd32: MMAs alone": FW32_NO_COPIES,
    "fwd32: memory path alone": FW32_NO_MMA,
    "fwd32: 1xTF32": FW32_PASSES,
    "fwd32: split once per staged chunk": FW32_SPLIT_ONCE,
}

# the bf16 form's on-chip shapes (B <= 256, H <= 64) sent to the wide
# route's tensor-core kernels: its shared memory, workspaces and both C
# entries' route
TO_WIDE = [
    ("  if (wide_route(H)) return which == 0 ? (bf16 ? FT_SMEM : FW_SMEM) : (bf16 ? TC_SMEM : TF_SMEM);",
     "  if (wide_route(H) || (bf16 && onchip_route(B, H)))\n"
     "    return which == 0 ? (bf16 ? FT_SMEM : FW_SMEM) : (bf16 ? TC_SMEM : TF_SMEM);"),
    ("  if (!(bf16 && wide_route(H))) return parts;",
     "  if (!(bf16 && (wide_route(H) || onchip_route(B, H)))) return parts;"),
    ("  if (!wide_route(H)) return 4LL * n_splits * B * H;",
     "  if (!(wide_route(H) || (bf16 && onchip_route(B, H)))) return 4LL * n_splits * B * H;"),
    ("  const bool wide = wide_route(H);  // a tensor-core kernel in either form",
     "  const bool wide = wide_route(H) || (bf16 && onchip_route(B, H));"),
    ("  const bool tc = wide_route(H) || (!bf16 && mid_route(B, H));",
     "  const bool tc = wide_route(H) || (bf16 && onchip_route(B, H)) || (!bf16 && mid_route(B, H));"),
]
# ce_fwd_onchip_tc_kernel without its table traffic (the copies and the
# rounding into bf16: the MMAs and the fold alone), or without its
# fragment loads and MMAs (the memory path and the fold)
FO_MMA_AND_EPILOGUE = [
    ("    if (s < n) tc::copy_table_tile<FT_COLS>(sF + s * FO_SLOT_F, table, (t_begin + s) * FT_COLS, V, H);\n", ""),
    ("      tc::round_table_tile<FT_COLS>(sT + (s & 1) * FO_SLOT_B, sF + (s % STAGES) * FO_SLOT_F);\n", ""),
    ("        tc::copy_table_tile<FT_COLS>(sF + ((s + STAGES - 1) % STAGES) * FO_SLOT_F, table,\n"
     "                                     (t_begin + s + STAGES - 1) * FT_COLS, V, H);\n", "        ;\n")]
FO_NO_MMA = [("    if (i_end == 4)  // (warp-uniform) 4 but where B < 256\n"
              "      onchip_logits_64x64<true>(acc, sS, T, wm, wn, lane, 4);\n"
              "    else if (i_end > 0)\n"
              "      onchip_logits_64x64<false>(acc, sS, T, wm, wn, lane, i_end);\n", "")]
# ce_bwd_onchip_tc_kernel likewise: without the table copies, the rounding
# and the dT stores to device memory; or without its three products'
# fragment loads and MMAs
BO_MMA_AND_EPILOGUE = [
    ("    if (s < n) tc::copy_table_tile<VT>(sF + s * BO_SLOT_F, table, (t_begin + s) * VT, V, H);\n", ""),
    ("  tc::round_table_tile<VT>(sT, sF);\n"
     "  if (STAGES < n) tc::copy_table_tile<VT>(sF, table, (t_begin + STAGES) * VT, V, H);\n", ""),
    ("      tc::round_table_tile<VT>(sT + ((s + 1) & 1) * BO_SLOT_B, sF + ((s + 1) % STAGES) * BO_SLOT_F);\n"
     "      if (s + 1 + STAGES < n)\n", "      if (false)\n"),
    ("      if (j0 + c < V && h < H) *reinterpret_cast<float4*>(dtable",
     "      if (V < 0) *reinterpret_cast<float4*>(dtable")]
BO_NO_LOGITS_MMA = [("      if (i_end == 2)  // (warp-uniform) 2 but where B < 256\n"
                      "        onchip_bwd_logits<2>(acc, sa, T, lane);\n"
                      "      else\n"
                      "        onchip_bwd_logits<1>(acc, sa, T, lane);\n", "")]
BO_NO_DS = [("      if (i_end == 2)\n        onchip_bwd_ds<2>(part, pa, T, lane);\n"
             "      else\n        onchip_bwd_ds<1>(part, pa, T, lane);\n", "")]
BO_NO_DT = [("      for (int k = 16 * k_begin; k < 16 * k_end; k += 16) {",
             "      for (int k = 16 * k_begin; k < 0; k += 16) {")]
BO_NO_MMA = BO_NO_LOGITS_MMA + BO_NO_DS + BO_NO_DT
FO_NO_FOLD = [("    if (f >= 0 && f < n) fold_tile_onchip(acc, m, sum, (t_begin + f) * FT_COLS, n_valid);\n", "")]
BO_NO_EXPF = [("            const uint32_t u = tc::pack_bf16(expf(acc[i][j][2 * half] - z) * d,\n"
               "                                             expf(acc[i][j][2 * half + 1] - z) * d);",
               "            const uint32_t u = tc::pack_bf16((acc[i][j][2 * half] - z) * d,\n"
               "                                             (acc[i][j][2 * half + 1] - z) * d);")]
# variant: replacements, at B=256, V=1M, H=64 (--onchip); the cut variants
# compute wrong results and are timed only
ONCHIP_VARIANTS = {
    "kernel": [],
    "bf16 on the wide tensor-core kernels": TO_WIDE,
    "on-chip kernels: MMAs and epilogue only": FO_MMA_AND_EPILOGUE + BO_MMA_AND_EPILOGUE,
    "on-chip kernels: everything but the MMAs": FO_NO_MMA + BO_NO_MMA,
    "on-chip kernels: no fold (forward), no expf (backward)": FO_NO_FOLD + BO_NO_EXPF,
    "on-chip kernels: backward without its dT product": BO_NO_DT,
    "on-chip kernels: backward without its ds product": BO_NO_DS,
}


# the bf16 form's middle-route shapes (B <= 256, 64 < H <= 256) sent to
# the wide route's tensor-core kernels, as TO_WIDE sends the on-chip ones
TO_WIDE_MID = [
    ("  if (wide_route(H)) return which == 0 ? (bf16 ? FT_SMEM : FW_SMEM) : (bf16 ? TC_SMEM : TF_SMEM);",
     "  if (wide_route(H) || (bf16 && mid_route(B, H)))\n"
     "    return which == 0 ? (bf16 ? FT_SMEM : FW_SMEM) : (bf16 ? TC_SMEM : TF_SMEM);"),
    ("  if (!(bf16 && wide_route(H))) return parts;",
     "  if (!(bf16 && (wide_route(H) || mid_route(B, H)))) return parts;"),
    ("  if (mid_route(B, H)) return 4LL * n_splits * TC_ROWS * round_up(H, bf16 ? TC_HL : MF_HP);\n"
     "  if (!wide_route(H)) return 4LL * n_splits * B * H;",
     "  if (!bf16 && mid_route(B, H)) return 4LL * n_splits * TC_ROWS * round_up(H, MF_HP);\n"
     "  if (!(wide_route(H) || (bf16 && mid_route(B, H)))) return 4LL * n_splits * B * H;"),
    ("  const bool wide = wide_route(H);  // a tensor-core kernel in either form\n"
     "  const bool mid = mid_route(B, H);  // ce_fwd_mid_tc_kernel, ce_fwd_mid_tf32_kernel",
     "  const bool wide = wide_route(H) || (bf16 && mid_route(B, H));\n"
     "  const bool mid = !bf16 && mid_route(B, H);"),
    ("  const bool tc = wide_route(H) || (!bf16 && mid_route(B, H));\n"
     "  const bool mid = bf16 && mid_route(B, H);  // ce_bwd_mid_tc_kernel",
     "  const bool tc = wide_route(H) || mid_route(B, H);\n"
     "  const bool mid = false;"),
]
# the bf16 form's middle-route backward alone sent to ce_bwd_wide_tc_kernel
TO_WIDE_MID_BWD = [
    ("  if (wide_route(H)) return which == 0 ? (bf16 ? FT_SMEM : FW_SMEM) : (bf16 ? TC_SMEM : TF_SMEM);",
     "  if (wide_route(H)) return which == 0 ? (bf16 ? FT_SMEM : FW_SMEM) : (bf16 ? TC_SMEM : TF_SMEM);\n"
     "  if (bf16 && which == 1 && mid_route(B, H)) return TC_SMEM;"),
    TO_WIDE_MID[2], TO_WIDE_MID[4]]


def wide_streamed(sync: bool) -> list:
    """TO_WIDE_MID_BWD with ce_bwd_wide_tc_kernel's states streamed from the
    fp32 states and rounded on chip, so no states_bf16_kernel launch and no
    states scratch: the backward's other choice at H = 256 (256-column p,
    the states streamed every step). Each step's state chunk comes as fp32
    float4s, 16 a thread for a logits step and 8 for a products step,
    loaded with step s - 1's copies and rounded into the slot after step
    s - 1's MMAs (the table rows' register prefetch), or with `sync` rounded
    and stored as soon as they are loaded, which frees the registers and
    leaves the loads' latency before the MMAs."""
    issue_old = (
        "      auto issue = [&](int s) {\n"
        "        __nv_bfloat16* dst = slot(s);\n"
        "        if (s < n_lg) {\n"
        "          const int h0 = (s % nl) * TC_HL;\n"
        "#pragma unroll\n"
        "          for (int q = 0; q < 8; ++q) {\n"
        "            const int i = tid + THREADS * q, r = i >> 3, c8 = (i & 7) * 8;\n"
        "            tc::cp_async_16(dst + r * TC_LDL + c8, sb + (size_t)(g0 + r) * Hp + h0 + c8);\n"
        "          }\n"
        "        } else {\n"
        "          const int h0 = (s - n_lg) * TC_HP;\n"
        "#pragma unroll\n"
        "          for (int q = 0; q < 4; ++q) {\n"
        "            const int i = tid + THREADS * q, r = i >> 2, c8 = (i & 3) * 8;\n"
        "            tc::cp_async_16(dst + r * TC_LDC + c8, sb + (size_t)(g0 + r) * Hp + h0 + c8);\n"
        "            tc::cp_async_16(dst + (TC_ROWS + r) * TC_LDC + c8, tile_bf16 + (size_t)r * Hp + h0 + c8);\n"
        "          }\n"
        "        }\n"
        "      };\n")
    issue_new = (
        f"      constexpr bool kSync = {'true' if sync else 'false'};\n"
        "      float4 sv[16];  // a step's state chunk in fp32\n"
        "      auto fill_states = [&](int s) {  // sv, rounded, into step s's slot\n"
        "        __nv_bfloat16* dst = slot(s);\n"
        "        if (s < n_lg) {\n"
        "#pragma unroll\n"
        "          for (int q = 0; q < 16; ++q) {\n"
        "            const int i = tid + THREADS * q, r = i >> 4, c4 = (i & 15) * 4;\n"
        "            *reinterpret_cast<uint2*>(dst + r * TC_LDL + c4) =\n"
        "                make_uint2(tc::pack_bf16(sv[q].x, sv[q].y), tc::pack_bf16(sv[q].z, sv[q].w));\n"
        "          }\n"
        "        } else {\n"
        "#pragma unroll\n"
        "          for (int q = 0; q < 8; ++q) {\n"
        "            const int i = tid + THREADS * q, r = i >> 3, c4 = (i & 7) * 4;\n"
        "            *reinterpret_cast<uint2*>(dst + r * TC_LDC + c4) =\n"
        "                make_uint2(tc::pack_bf16(sv[q].x, sv[q].y), tc::pack_bf16(sv[q].z, sv[q].w));\n"
        "          }\n"
        "        }\n"
        "      };\n"
        "      auto issue = [&](int s) {\n"
        "        __nv_bfloat16* dst = slot(s);\n"
        "        auto ld = [&](int r, int h) {  // zero past B and H (H % 4 == 0)\n"
        "          return (g0 + r < B && h < H)\n"
        "                     ? __ldg(reinterpret_cast<const float4*>(states + (size_t)(g0 + r) * H + h))\n"
        "                     : make_float4(0.f, 0.f, 0.f, 0.f);\n"
        "        };\n"
        "        if (s < n_lg) {\n"
        "          const int h0 = (s % nl) * TC_HL;\n"
        "#pragma unroll\n"
        "          for (int q = 0; q < 16; ++q) {\n"
        "            const int i = tid + THREADS * q;\n"
        "            sv[q] = ld(i >> 4, h0 + (i & 15) * 4);\n"
        "          }\n"
        "        } else {\n"
        "          const int h0 = (s - n_lg) * TC_HP;\n"
        "#pragma unroll\n"
        "          for (int q = 0; q < 8; ++q) {\n"
        "            const int i = tid + THREADS * q;\n"
        "            sv[q] = ld(i >> 3, h0 + (i & 7) * 4);\n"
        "          }\n"
        "#pragma unroll\n"
        "          for (int q = 0; q < 4; ++q) {\n"
        "            const int i = tid + THREADS * q, r = i >> 2, c8 = (i & 3) * 8;\n"
        "            tc::cp_async_16(dst + (TC_ROWS + r) * TC_LDC + c8, tile_bf16 + (size_t)r * Hp + h0 + c8);\n"
        "          }\n"
        "        }\n"
        "        if (kSync) fill_states(s);\n"
        "      };\n")
    prologue = "      issue(0);\n      onchip::cp_async_commit();\n      load_table(0, pre_a);\n      fill(0, pre_a);"
    step_end = ("          if (s + 1 >= n_lg) carry(s + 1);  // (after the epilogue or the stores: acc is free)\n"
                "          fill(s + 1, nxt);\n        }")
    launch = ("    states_bf16_kernel<<<(n4 + 255) / 256, 256, 0, s>>>(static_cast<const float*>(states), B, H,\n"
              "                                                         Bp, Hp, sb);\n"
              "    e = cudaGetLastError();\n"
              "    if (e != cudaSuccess) return (int)e;\n"
              "    e = cudaFuncSetAttribute(ce_bwd_wide_tc_kernel,")
    return TO_WIDE_MID_BWD + [
        (issue_old, issue_new),
        (prologue, prologue.replace("issue(0);\n", "issue(0);\n      if (!kSync) fill_states(0);\n")),
        (step_end, step_end.replace("nxt);\n", "nxt);\n          if (!kSync) fill_states(s + 1);\n")),
        (launch, "    (void)n4;\n    e = cudaFuncSetAttribute(ce_bwd_wide_tc_kernel,")]


# ... and to the older sweeps, the route the middle pair replaced
TO_SWEEP_MID = [("bool mid_route(int B, int H) { return B <= OC_B && H > OC_H && H <= MAX_H; }",
                 "bool mid_route(int B, int H) { return false; }")]
# ce_fwd_mid_tc_kernel without its table traffic (the loads, the rounding
# into the slots), without its fragment loads and MMAs, without its fold
MF_NO_LOADS = [("      chunk[q] = (c0 + r < V && h < H)", "      chunk[q] = (c0 + r < 0 && h < H)")]
MF_NO_STORES = [("      *reinterpret_cast<uint2*>(dst + r * FT_LD + c4) = v;",
                 "      if (V < 0) *reinterpret_cast<uint2*>(dst + r * FT_LD + c4) = v;")]
MF_NO_MMA = [("    if (i_end == 4)  // (warp-uniform) 4 but where B < 256\n"
              "      onchip_logits_64x64<true>(acc, S, slot(s), wm, wn, lane, 4, lds, FT_LD);\n"
              "    else if (i_end > 0)\n"
              "      onchip_logits_64x64<false>(acc, S, slot(s), wm, wn, lane, i_end, lds, FT_LD);\n", "")]
MF_NO_FOLD = [("(m, sum)\n      fold_tile(acc", "(m, sum)\n      if (V < 0) fold_tile(acc")]
# ce_bwd_mid_tc_kernel likewise, and without one kind of work at a time
MB_NO_LOADS = [("      pre[k] = (col0 + r < V && h < H)", "      pre[k] = (col0 + r < 0 && h < H)")]
MB_NO_FILL = [("      *reinterpret_cast<uint2*>(dst + r * (lg ? MID_LLD : MID_PLD) + c4) =",
               "      if (V < 0) *reinterpret_cast<uint2*>(dst + r * (lg ? MID_LLD : MID_PLD) + c4) =")]
MB_NO_DT_STORES = [("2 * t4;\n              if (h < H && j0 + m < V)", "2 * t4;\n              if (V < 0)")]
MB_NO_CARRY = [("prev[q] = from ? src[q * 32]", "prev[q] = false ? src[q * 32]")]
MB_NO_DS_STORES = [("            dst[(4 * i + j) * 32] =\n", "            if (V < 0) dst[(4 * i + j) * 32] =\n")]
MB_NO_MMA = [("      for (int kk = 0; kk < TC_HL; kk += 16) {\n        uint32_t a[4][4], b[4][2];",
              "      for (int kk = 0; kk < 0; kk += 16) {\n        uint32_t a[4][4], b[4][2];"),
             ("for (int k = 0; k < 16 * kb; k += 16) {", "for (int k = 0; k < 0; k += 16) {"),
             ("for (int k = 0; k < MID_COLS; k += 16) {", "for (int k = 0; k < 0; k += 16) {")]
MB_LOGITS_ONLY = [("  const int n_lg = (MID_COLS / MID_SUB) * nl, per_tile = n_lg + np;",
                   "  const int n_lg = (MID_COLS / MID_SUB) * nl, per_tile = n_lg;")]
MB_PRODUCTS_ONLY = [("  const int n_lg = (MID_COLS / MID_SUB) * nl, per_tile = n_lg + np;",
                     "  const int n_lg = 0 * nl, per_tile = np;")]
# ce_bwd_mid_tc_kernel with ds_part carried through the MMAs (each products
# step's accumulators start from it, as ce_bwd_wide_tc_kernel's do), not
# added in fp32 after them
MB_CARRY_THROUGH_MMA = [
    ("        // acc[i][j] += p[pm + 16 i, :] . T[:, h0 + 8 j] over the tile's columns\n",
     "        // acc[i][j] += p[pm + 16 i, :] . T[:, h0 + 8 j] over the tile's columns\n"
     "        for (int q = 0; q < 16; ++q) {\n"
     "          acc[q >> 2][q & 3][0] = prev[q].x;\n          acc[q >> 2][q & 3][1] = prev[q].y;\n"
     "          acc[q >> 2][q & 3][2] = prev[q].z;\n          acc[q >> 2][q & 3][3] = prev[q].w;\n"
     "        }\n"),
    ("            const float4 c = prev[4 * i + j];", "            const float4 c = make_float4(0.f, 0.f, 0.f, 0.f);")]
# ... with L2 eviction hints: ds_part loaded and stored evict-last (a
# split's 256 KB at H = 256 meant to stay in L2), dT stored evict-first
MB_L2_HINTS = [
    ("constexpr int MID_COLS = 128;",
     "__device__ __forceinline__ uint64_t l2_policy(bool last) {\n"
     "  uint64_t p;\n"
     "  if (last) asm volatile(\"createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\\n\" : \"=l\"(p));\n"
     "  else asm volatile(\"createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\\n\" : \"=l\"(p));\n"
     "  return p;\n}\n"
     "__device__ __forceinline__ float4 ld_hint(const float4* p, uint64_t pol) {\n"
     "  float4 v;\n"
     "  asm volatile(\"ld.global.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;\\n\"\n"
     "               : \"=f\"(v.x), \"=f\"(v.y), \"=f\"(v.z), \"=f\"(v.w) : \"l\"(p), \"l\"(pol));\n"
     "  return v;\n}\n"
     "__device__ __forceinline__ void st_hint(float4* p, float4 v, uint64_t pol) {\n"
     "  asm volatile(\"st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;\\n\"\n"
     "               :: \"l\"(p), \"f\"(v.x), \"f\"(v.y), \"f\"(v.z), \"f\"(v.w), \"l\"(pol) : \"memory\");\n}\n"
     "__device__ __forceinline__ void st_hint(float2* p, float2 v, uint64_t pol) {\n"
     "  asm volatile(\"st.global.L2::cache_hint.v2.f32 [%0], {%1, %2}, %3;\\n\"\n"
     "               :: \"l\"(p), \"f\"(v.x), \"f\"(v.y), \"l\"(pol) : \"memory\");\n}\n\n"
     "constexpr int MID_COLS = 128;"),
    ("  const int pm = dt_warp ? 32 * warp : 64 * (warp - 4);\n\n  tc::stage_states_bf16(",
     "  const int pm = dt_warp ? 32 * warp : 64 * (warp - 4);\n"
     "  const uint64_t keep = l2_policy(true), stream = l2_policy(false);\n\n  tc::stage_states_bf16("),
    ("prev[q] = from ? src[q * 32] :", "prev[q] = from ? ld_hint(src + q * 32, keep) :"),
    ("            dst[(4 * i + j) * 32] =\n"
     "                make_float4(c.x + acc[i][j][0], c.y + acc[i][j][1], c.z + acc[i][j][2], c.w + acc[i][j][3]);",
     "            st_hint(dst + (4 * i + j) * 32,\n"
     "                make_float4(c.x + acc[i][j][0], c.y + acc[i][j][1], c.z + acc[i][j][2], c.w + acc[i][j][3]), keep);"),
    ("                *reinterpret_cast<float2*>(dtable + (size_t)(j0 + m) * H + h) =\n"
     "                    make_float2(acc[i][j][e], acc[i][j][e + 1]);\n            }\n      } else {",
     "                st_hint(reinterpret_cast<float2*>(dtable + (size_t)(j0 + m) * H + h),\n"
     "                        make_float2(acc[i][j][e], acc[i][j][e + 1]), stream);\n            }\n      } else {")]
# ---- the fp32 form's middle pair (ce_fwd_mid_tf32_kernel, ce_bwd_mid_tf32_kernel)
# the fp32 form's middle-route shapes sent to the wide 3xTF32 kernels
# (ce_fwd_wide_tf32_kernel, ce_bwd_wide_tf32_kernel: mma.sync, any H): the
# yardstick of the wgmma pair (ds_part takes the same bytes on both)
TO_WIDE_MID_FP32 = [
    ("  if (mid_route(B, H)) return which == 0 ? MF_FWD_SMEM : TF_SMEM;",
     "  if (mid_route(B, H)) return which == 0 ? FW_SMEM : TF_SMEM;"),
    ("  const bool wide = wide_route(H);  // a tensor-core kernel in either form\n"
     "  const bool mid = mid_route(B, H);  // ce_fwd_mid_tc_kernel, ce_fwd_mid_tf32_kernel",
     "  const bool wide = wide_route(H) || (!bf16 && mid_route(B, H));\n"
     "  const bool mid = bf16 && mid_route(B, H);")]
# the fp32 form's middle-route backward on ce_bwd_mid_tf32_kernel (wgmma),
# which the route does not take (ce_bwd_wide_tf32_kernel is faster at B =
# 256): the variants below that cut parts of it take this too
F32_BWD_WGMMA = [
    ("  if (mid_route(B, H)) return which == 0 ? MF_FWD_SMEM : TF_SMEM;",
     "  if (mid_route(B, H)) return which == 0 ? MF_FWD_SMEM : MF_BWD_SMEM;"),
    ("  const bool tc = wide_route(H) || (!bf16 && mid_route(B, H));\n"
     "  const bool mid = bf16 && mid_route(B, H);  // ce_bwd_mid_tc_kernel",
     "  const bool tc = wide_route(H);\n"
     "  const bool mid = mid_route(B, H);"),
    ("    auto sweep = ce_bwd_mid_tc_kernel;\n",
     "    auto sweep = bf16 ? ce_bwd_mid_tc_kernel : ce_bwd_mid_tf32_kernel;\n")]
# the logits' sums on the tensor cores (mf_logits) one or four k8 blocks
# long (four: the forward's whole step; the backward's steps hold two),
# each added to the running logits in fp32, where the kernel's are two
# blocks long
F32_CHAIN = {n: [("constexpr int MF_CHAIN = 2;", f"constexpr int MF_CHAIN = {n};")] for n in (1, 4)}
# ... or summed over all of H in the MMAs' own accumulators (acc[mt]), no
# partial sums and no wait inside a step, the a fragments double-buffered
# over the stream of (m64 tile, pair of k8 blocks) groups
MF_LOGITS_PARTIAL = '  constexpr int CH = KC / 8 < MF_CHAIN ? KC / 8 : MF_CHAIN;\n  static_assert((KC / 8) % CH == 0, "whole chains a step");\n#pragma unroll\n  for (int mt = 0; mt < 4; ++mt) {\n    if (mt >= mt_end) break;  // (block-uniform)\n#pragma unroll\n    for (int k0 = 0; k0 < KC; k0 += 8 * CH) {\n      uint32_t ah[CH][4], al[CH][4];\n#pragma unroll\n      for (int c = 0; c < CH; ++c) frag(mt, k0 + 8 * c, ah[c], al[c]);\n      float part[32];\n      wg::fence();\n#pragma unroll\n      for (int c = 0; c < CH; ++c) {\n        const int kb = k0 / 8 + c;\n        wg::mma_3xtf32<64>(part, ah[c], al[c], wg::desc(bh + 64 * kb, KC), wg::desc(bl + 64 * kb, KC), c);\n      }\n      wg::commit();\n      wg::wait<0>();\n      wg::fence_regs(part);\n#pragma unroll\n      for (int j = 0; j < 8; ++j)\n#pragma unroll\n        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[4 * j + e];\n    }\n  }\n'
MF_LOGITS_ALL_OF_H = "  constexpr int NG = KC / 16;  // groups of two k8 blocks a step and m64 tile\n  uint32_t ah[2][2][4], al[2][2][4];  // [buffer][k8 block of the group]\n#pragma unroll\n  for (int mt = 0; mt < 4; ++mt) {\n    if (mt >= mt_end) break;  // (block-uniform)\n    float(&d)[32] = reinterpret_cast<float(&)[32]>(acc[mt]);\n#pragma unroll\n    for (int q = 0; q < NG; ++q) {\n      const int u = (mt * NG + q) & 1;  // this group's buffer\n      wg::wait<1>();  // the group before the one before, its last reader, is done\n#pragma unroll\n      for (int c = 0; c < 2; ++c) frag(mt, 16 * q + 8 * c, ah[u][c], al[u][c]);\n      wg::fence();\n#pragma unroll\n      for (int c = 0; c < 2; ++c) {\n        const int kb = 2 * q + c;\n        wg::mma_3xtf32<64>(d, ah[u][c], al[u][c], wg::desc(bh + 64 * kb, KC), wg::desc(bl + 64 * kb, KC), 1);\n      }\n      wg::commit();\n    }\n  }\n  wg::wait<0>();\n#pragma unroll\n  for (int mt = 0; mt < 4; ++mt) wg::fence_regs(reinterpret_cast<float(&)[32]>(acc[mt]));\n"
F32_ALL_OF_H = [(MF_LOGITS_PARTIAL, MF_LOGITS_ALL_OF_H)]
# the pair without their state copies, table loads and plane stores,
# products loads and plane stores, dT stores, ds_part carry and stores:
# their fragment loads, splits, MMAs and epilogues (fold, p) alone
F32_NO_MEMORY = [
    ("    copy_chunk_async<TC_ROWS, KC>(slot(s), KC + 4, states, 0, B, H, (s % nk) * KC);\n", ""),
    ("    mf_load_table<KC>(pre, table, (t_begin + s / nk) * MF_COLS, (s % nk) * KC, V, H);\n", ""),
    ("  auto store_table = [&](int s) {\n    mf_store_table<KC>(pre, th(s), th(s) + MF_COLS * KC);\n",
     "  auto store_table = [&](int s) {\n"),
    ("      copy_chunk_async<TC_ROWS, KC>(slot(s), KC + 4, states, 0, B, H, s * KC);\n"
     "      mf_load_table<KC>(pre, table, j0, s * KC, V, H);\n", ""),
    ("      if (first) {\n        mf_store_table<KC>(pre, th(s), th(s) + MF_COLS * KC);\n", "      if (first) {\n"),
    ("        mf_store_table<KC>(pre, th(s + 1), th(s + 1) + MF_COLS * KC);\n", ""),
    ("        tp[i] = (c < V && h < H) ?", "        tp[i] = (c < 0 && h < H) ?"),
    ("          sp[v][i] = (b < B && h < H) ?", "          sp[v][i] = (b < 0 && h < H) ?"),
    ("    store_products();\n    for (int k = 0; k < np; ++k) {", "    for (int k = 0; k < np; ++k) {"),
    ("      if (k + 1 < np) store_products();\n", ""),
    ("          if (col < V && h < H)\n            *reinterpret_cast<float4*>(dtable",
     "          if (V < 0)\n            *reinterpret_cast<float4*>(dtable"),
    ("                tt != t_begin ? reinterpret_cast<const float4*>(ds_part)",
     "                false ? reinterpret_cast<const float4*>(ds_part)"),
    ("            reinterpret_cast<float4*>(ds_part)[mf_ds_at(blockIdx.x, Hp, 2 * k + jj, 2 * w + mi, wr, half, lane)] =",
     "            if (V < 0) reinterpret_cast<float4*>(ds_part)[mf_ds_at(blockIdx.x, Hp, 2 * k + jj, 2 * w + mi, wr, half, lane)] =")]
# ... or without their MMAs (the copies, loads, plane stores, fragment
# loads and epilogues: the memory path)
F32_NO_MMA = [
    ("        wg::mma_3xtf32<64>(part, ah[c], al[c], wg::desc(bh + 64 * kb, KC), wg::desc(bl + 64 * kb, KC), c);\n",
     ""),
    ("          wg::mma_3xtf32<32>(dsa[mi], ah[kb & 1], al[kb & 1], wg::desc(tth + 64 * kb, MF_COLS),\n"
     "                             wg::desc(ttl + 64 * kb, MF_COLS), kb);\n", ""),
    ("            wg::mma_3xtf32<32>(dta, ah[u], al[u], wg::desc(sth + 64 * (kb + u), TC_ROWS),\n"
     "                               wg::desc(stl + 64 * (kb + u), TC_ROWS), kb + u);\n", "")]
F32_LOGITS_ONLY = [("  const int Hp = round_up(H, MF_HP), nl = Hp / KC, np = Hp / MF_HP;",
                    "  const int Hp = round_up(H, MF_HP), nl = Hp / KC, np = 0;")]
F32_PRODUCTS_ONLY = [("  const int Hp = round_up(H, MF_HP), nl = Hp / KC, np = Hp / MF_HP;",
                      "  const int Hp = round_up(H, MF_HP), nl = 0, np = Hp / MF_HP;")]
F32_NO_FOLD = [("fold its logits\n      fold_tile(acc", "fold its logits\n      if (V < 0) fold_tile(acc")]
F32_NO_CARRY = [F32_NO_MEMORY[11]]

# variant: replacements, at B=256, V=1M, H in {128, 256} (--mid); the cut
# variants compute wrong results and are timed only. "kernel" and "on the
# older sweeps" are timed in both forms, a variant named "fp32 ..." in the
# fp32 form, the others in the bf16 form
MID_VARIANTS = {
    "kernel": [],
    "bf16 on the wide tensor-core kernels": TO_WIDE_MID,
    "on the older sweeps": TO_SWEEP_MID,
    "middle kernels: MMAs and epilogue only": (MF_NO_LOADS + MF_NO_STORES + MB_NO_LOADS + MB_NO_FILL
                                              + MB_NO_DT_STORES + MB_NO_CARRY + MB_NO_DS_STORES),
    "middle kernels: everything but the MMAs": MF_NO_MMA + MB_NO_MMA,
    "middle kernels: no fold (forward), no ds_part carry (backward)": MF_NO_FOLD + MB_NO_CARRY,
    "middle kernels: backward without its ds_part stores": MB_NO_DS_STORES,
    "middle kernels: backward without its dT stores": MB_NO_DT_STORES,
    "middle kernels: backward, logits steps only": MB_LOGITS_ONLY,
    "middle kernels: backward, products steps only": MB_PRODUCTS_ONLY,
    "backward: ds_part carried through the MMAs": MB_CARRY_THROUGH_MMA,
    "backward: L2 eviction hints on ds_part and dT": MB_L2_HINTS,
    "backward: wide tiling, states streamed from fp32, a step ahead": wide_streamed(sync=False),
    "backward: wide tiling, states streamed from fp32, at the step": wide_streamed(sync=True),
    "fp32 on the wide 3xTF32 kernels": TO_WIDE_MID_FP32,
    "fp32 backward on ce_bwd_mid_tf32_kernel": F32_BWD_WGMMA,
    "fp32 partial sums of one k8 block": F32_BWD_WGMMA + F32_CHAIN[1],
    "fp32 partial sums of four k8 blocks": F32_BWD_WGMMA + F32_CHAIN[4],
    "fp32 logits summed on the tensor cores over all of H": F32_BWD_WGMMA + F32_ALL_OF_H,
    "fp32 middle kernels: MMAs alone": F32_BWD_WGMMA + F32_NO_MEMORY,
    "fp32 middle kernels: everything but the MMAs": F32_BWD_WGMMA + F32_NO_MMA,
    "fp32 middle kernels: no fold (forward), no ds_part carry (backward)": (F32_BWD_WGMMA + F32_NO_FOLD
                                                                           + F32_NO_CARRY),
    "fp32 middle kernels: backward, logits steps only": F32_BWD_WGMMA + F32_LOGITS_ONLY,
    "fp32 middle kernels: backward, products steps only": F32_BWD_WGMMA + F32_PRODUCTS_ONLY,
}
# the variants of MID_VARIANTS timed in both forms
MID_BOTH_FORMS = ("kernel", "on the older sweeps")


def sources(variants: dict | None = None) -> dict[str, str]:
    """{variant: source text} of `variants` (default VARIANTS); raises
    unless every replacement matches once."""
    base = (CSRC / "streaming_ce.cu").read_text().replace(
        '#include "tensor_core.cuh"', (CSRC / "tensor_core.cuh").read_text())
    out = {}
    for name, replacements in (VARIANTS if variants is None else variants).items():
        text = base
        for old, new in replacements:
            if text.count(old) != 1:
                raise SystemExit(f"ablate_ce_tc: {name!r}: {old.strip()[:60]!r} matches "
                                 f"{text.count(old)} times")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(texts: dict[str, str], prefix: str = "v") -> dict[str, Path]:
    sys.path.insert(0, str(ROOT))
    from bsarec_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    for header in CSRC.glob("*.cuh"):
        (OUT / header.name).write_text(header.read_text())
    jobs = {}
    for k, (name, text) in enumerate(texts.items()):
        src, lib = OUT / f"{prefix}{k}.cu", OUT / f"{prefix}{k}.so"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, lib)
    for name, (proc, _) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"ablate_ce_tc: nvcc failed for {name!r}:\n{log}")
    return {name: lib for name, (_, lib) in jobs.items()}


def accuracy(libs: dict, states, table, answers, dev) -> None:
    """The fp32 form's wide ce_grads of each library in `libs` against the
    plain fp32 version and an fp64 one, at the main shape (these inputs,
    dloss 1/B) and at tests/test_torch_port_cuda.py's route-boundary case
    (B=256, V=9001, H=260, n_valid 8999, its seeds); one JSON line each."""
    import numpy as np
    import torch

    from bsarec_tpu_torch import parity
    from bsarec_tpu_torch.ops import ce

    def worst(got, want):  # elementwise, against rtol 1e-4, atol 1e-5
        return float(((got.double() - want.double()).abs() / (1e-5 + 1e-4 * want.double().abs())).max())

    b, v, h, n_valid = 256, 9001, 260, 8999
    rng = np.random.default_rng(b * 1000 + h)
    s2 = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(dev)
    t2 = torch.from_numpy((0.5 * rng.normal(size=(v, h))).astype(np.float32)).to(dev)
    a2 = rng.integers(0, v + 3, size=b)
    a2[:4] = a2[0]
    d2 = torch.from_numpy(rng.uniform(0.5, 1.5, size=b).astype(np.float32)).to(dev)
    cases = [("main shape", states, table, answers, torch.full((B,), 1.0 / B, device=dev), V),
             ("H=260 route boundary", s2, t2, torch.from_numpy(a2).to(dev), d2, n_valid)]
    p, i = ctypes.c_void_p, ctypes.c_int
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    for case, s, t, a, d, nv in cases:
        bb, vv, hh = s.shape[0], t.shape[0], s.shape[1]
        logz = ce.ce_logz(s, t, nv)
        plain = ce.ce_grads_plain(s, t, a, logz, d, nv)
        exact = ce.ce_grads_plain(s.double(), t.double(), a, logz.double(), d.double(), nv)
        rows = [("plain fp32", plain)]
        n_splits, per = ce.tc_splits(vv, ce._TF_VT, sm)
        work = torch.empty((ce._lib().ce_grads_workspace_bytes(bb, hh, 0, n_splits),),
                           dtype=torch.uint8, device=dev)
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            lib.ce_grads.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p, p, p, i, p]
            ds, dt = torch.empty((bb, hh), device=dev), torch.empty((vv, hh), device=dev)
            rc = lib.ce_grads(s.data_ptr(), t.data_ptr(), a.data_ptr(), logz.data_ptr(), d.data_ptr(),
                              bb, vv, hh, nv, n_splits, per, work.data_ptr(), ds.data_ptr(),
                              dt.data_ptr(), 0, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise SystemExit(f"ablate_ce_tc: {name!r} launch failed")
            rows.append(("fp32 kernel" if name == "kernel" else name, (ds, dt)))
        kernel = rows[1][1]
        for name, got in rows:
            out = {"accuracy": name, "case": case, "B": bb, "V": vv, "H": hh,
                   "bit-equal to the kernel": bool(torch.equal(got[0], kernel[0])
                                                   and torch.equal(got[1], kernel[1]))}
            if name != "plain fp32":
                out["vs plain: groups"] = parity.grad_errors(*got, *plain, a, nv)
                out["vs plain: elementwise"] = [worst(got[0], plain[0]), worst(got[1], plain[1])]
            out["vs fp64: groups"] = parity.grad_errors(*got, *exact, a, nv)
            out["vs fp64: elementwise"] = [worst(got[0], exact[0]), worst(got[1], exact[1])]
            print(json.dumps(out), flush=True)
        del plain, exact, rows, work
        torch.cuda.empty_cache()


def accuracy_forward(libs: dict, states, table, dev) -> None:
    """The fp32 form's wide ce_logz of each library in `libs` against the
    plain fp32 version and an fp64 one (`ce_logz_plain` on float64
    inputs) at the main shape: the largest |error| / max(1, |want|), as
    chip_smoke.py's CE_TOL is applied, and bit-equality to the kernel; one
    JSON line each."""
    import torch

    from bsarec_tpu_torch.ops import ce

    def worst(got, want):
        return float(((got.double() - want.double()).abs() / want.double().abs().clamp(min=1.0)).max())

    plain = ce.ce_logz_plain(states, table, V)
    exact = ce.ce_logz_plain(states.double(), table.double(), V)
    p, i = ctypes.c_void_p, ctypes.c_int
    n_splits, per = ce.tc_splits(V, ce._TC_FWD_VT, torch.cuda.get_device_properties(0).multi_processor_count)
    work = torch.empty((ce._lib().ce_logz_workspace_bytes(B, H, 0, n_splits),), dtype=torch.uint8,
                       device=dev)
    rows = [("plain fp32", plain)]
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.ce_logz.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, i, p]
        logz = torch.empty((B,), device=dev)
        if lib.ce_logz(states.data_ptr(), table.data_ptr(), None, B, V, H, V, n_splits, per,
                       work.data_ptr(), logz.data_ptr(), None, 0,
                       torch.cuda.current_stream().cuda_stream) != 0:
            raise SystemExit(f"ablate_ce_tc: {name!r} ce_logz launch failed")
        rows.append(("fp32 forward kernel" if name == "kernel" else name, logz))
    kernel = rows[1][1]
    for name, got in rows:
        out = {"accuracy": name, "case": "main shape", "B": B, "V": V, "H": H,
               "bit-equal to the kernel": bool(torch.equal(got, kernel))}
        if name != "plain fp32":
            out["logZ vs plain"] = worst(got, plain)
        out["logZ vs fp64"] = worst(got, exact)
        print(json.dumps(out), flush=True)
    del plain, exact, work
    torch.cuda.empty_cache()


def timed_in_turns(calls: dict, iters: int = 10) -> dict:
    """Each call of `calls` ({name: fn returning a C entry's code}) timed in
    order, then in reverse (CUDA events, one warm-up): {name: [ms, ms]}."""
    import torch

    def ms(fn):
        if fn() != 0:
            raise SystemExit("ablate_ce_tc: launch failed")
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    readings = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        readings[name].append(ms(calls[name]))
    return readings


MID_BATCHES = (16, 64, 128, 192, 256)


def mid_batches_main() -> None:
    """The --mid-batches mode (module docstring)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from bsarec_tpu_torch import parity
    from bsarec_tpu_torch.ops import ce

    if not torch.cuda.is_available():
        raise SystemExit("ablate_ce_tc: no CUDA device")
    names = {"ce_bwd_mid_tf32_kernel": "fp32 backward on ce_bwd_mid_tf32_kernel",
             "ce_bwd_wide_tf32_kernel": "kernel"}
    libs = build(sources({k: MID_VARIANTS[v] for k, v in names.items()}), prefix="mb")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    p, i = ctypes.c_void_p, ctypes.c_int
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream
    loaded = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.ce_logz.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, i, p]
        lib.ce_grads.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p, p, p, i, p]
        lib.ce_logz_workspace_bytes.argtypes = lib.ce_grads_workspace_bytes.argtypes = [i, i, i, i]
        lib.ce_logz_workspace_bytes.restype = lib.ce_grads_workspace_bytes.restype = ctypes.c_longlong
        loaded[name] = lib

    def entries(lib, states, table, answers, logz, dloss, v, n_valid):
        b, h = states.shape
        n_splits, per = ce.tc_splits(v, 128, sm)
        fw = torch.empty((lib.ce_logz_workspace_bytes(b, h, 0, n_splits),), dtype=torch.uint8, device=dev)
        gw = torch.empty((lib.ce_grads_workspace_bytes(b, h, 0, n_splits),), dtype=torch.uint8, device=dev)
        z = torch.empty((b,), device=dev)
        ds, dt = torch.empty((b, h), device=dev), torch.empty((v, h), device=dev)
        fwd = lambda: lib.ce_logz(states.data_ptr(), table.data_ptr(), None, b, v, h, n_valid, n_splits, per,
                                  fw.data_ptr(), z.data_ptr(), None, 0, stream())
        bwd = lambda: lib.ce_grads(states.data_ptr(), table.data_ptr(), answers.data_ptr(), logz.data_ptr(),
                                   dloss.data_ptr(), b, v, h, n_valid, n_splits, per, gw.data_ptr(),
                                   ds.data_ptr(), dt.data_ptr(), 0, stream())
        return fwd, bwd, (fw, gw, z, ds, dt)

    for h in (128, 256):
        # the check: both kernels against the plain fp32 version
        b, v, n_valid = 37, 5003, 5001
        rng = np.random.default_rng(h)
        s = torch.from_numpy(rng.normal(size=(b, h)).astype(np.float32)).to(dev)
        t = torch.from_numpy((0.5 * rng.normal(size=(v, h))).astype(np.float32)).to(dev)
        a = torch.from_numpy(rng.integers(-1, v + 2, size=b)).to(dev)
        d = torch.from_numpy(rng.uniform(0.5, 1.5, size=b).astype(np.float32)).to(dev)
        z = ce.ce_logz_plain(s, t, n_valid)
        want = ce.ce_grads_plain(s, t, a, z, d, n_valid)
        for name, lib in loaded.items():
            _, bwd, bufs = entries(lib, s, t, a, z, d, v, n_valid)
            if bwd() != 0:
                raise SystemExit(f"ablate_ce_tc: {name} launch failed")
            torch.cuda.synchronize()
            errs = parity.grad_errors(bufs[3], bufs[4], *want, a, n_valid)
            if max(errs.values()) > parity.WIDE_GRAD_TOL:
                raise SystemExit(f"ablate_ce_tc: {name} off the plain version at H={h}: {errs}")
            print(json.dumps({"check": name, "B": b, "V": v, "H": h, "gradients vs plain fp32": errs}),
                  flush=True)
        v = 1_000_000
        table = torch.from_numpy(0.25 * rng.standard_normal((v, h), dtype=np.float32)).to(dev)
        for b in MID_BATCHES:
            states = torch.from_numpy(rng.standard_normal((b, h), dtype=np.float32)).to(dev)
            answers = torch.from_numpy(rng.integers(1, v, size=b)).to(dev)
            dloss = torch.full((b,), 1.0 / b, device=dev)
            logz = ce.ce_logz_plain(states, table, v)
            want = ce.ce_grads_plain(states, table, answers, logz, dloss, v)
            calls, keep = {}, []
            for name, lib in loaded.items():
                fwd, bwd, bufs = entries(lib, states, table, answers, logz, dloss, v, v)
                if bwd() != 0:
                    raise SystemExit(f"ablate_ce_tc: {name} launch failed")
                first = (bufs[3].clone(), bufs[4].clone())
                if bwd() != 0:
                    raise SystemExit(f"ablate_ce_tc: {name} launch failed")
                torch.cuda.synchronize()
                errs = parity.grad_errors(bufs[3], bufs[4], *want, answers, v)
                same = torch.equal(first[0], bufs[3]) and torch.equal(first[1], bufs[4])
                if max(errs.values()) > parity.WIDE_GRAD_TOL or not same:
                    raise SystemExit(f"ablate_ce_tc: {name} at B={b} H={h}: {errs}, two calls "
                                     f"bit-equal {same}")
                print(json.dumps({"check": name, "B": b, "V": v, "H": h, "gradients vs plain fp32": errs,
                                  "two calls bit-equal": same}), flush=True)
                del first
                keep.append(bufs)
                calls[f"backward: {name}"] = bwd
                if name == "ce_bwd_mid_tf32_kernel":
                    calls["forward: ce_fwd_mid_tf32_kernel"] = fwd
            del want
            for name, r in timed_in_turns(calls).items():
                print(json.dumps({"variant": name, "ms": r, "B": b, "V": v, "H": h}), flush=True)
            del keep, calls
            torch.cuda.empty_cache()
        del table
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())


def onchip_main(only=None) -> None:
    """The --onchip mode (module docstring)."""
    route_main(ONCHIP_VARIANTS, "onchip", (64,), ("on-chip kernels:",), only)


def mid_main(only=None) -> None:
    """The --mid mode (module docstring)."""
    route_main(MID_VARIANTS, "mid", (128, 256), ("middle kernels:", "fp32 middle kernels:"), only)


def route_main(variants: dict, prefix: str, widths: tuple, cut: tuple, only=None) -> None:
    """Build `variants` (with `only`, "kernel" and those whose name holds
    one of its strings), then at B=256, V=1M and each H of `widths` time
    them in turns with the library calls; the whole variants' (not those
    whose name starts with one of `cut`) outputs against the plain
    versions of their form."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ablate_ce_tc: no CUDA device")
    if only:
        variants = {k: v for k, v in variants.items() if k == "kernel" or any(o in k for o in only)}
    libs = build(sources(variants), prefix=prefix)
    for h in widths:
        route_times(libs, h, cut)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())


def route_times(libs: dict, h: int, cut: tuple) -> None:
    """One width of `route_main`."""
    import importlib.util

    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from bsarec_tpu_torch import parity
    from bsarec_tpu_torch.ops import ce

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    b, v = 256, 1_000_000
    dev = torch.device("cuda")
    rng = np.random.default_rng(100)  # chip_smoke.py's main CE case
    states = torch.from_numpy(rng.standard_normal((b, h), dtype=np.float32)).to(dev)
    table = torch.from_numpy(0.25 * rng.standard_normal((v, h), dtype=np.float32)).to(dev)
    answers = torch.from_numpy(rng.integers(1, v, size=b)).to(dev)
    dloss = torch.full((b,), 1.0 / b, device=dev)
    want_loss, logz = ce.ce_loss_logz_plain(states, table, answers, v, bf16=True)
    want_ds, want_dt = ce.ce_grads_plain(states, table, answers, logz, dloss, v, bf16=True)
    # the tensor cores' summation order (parity.py's head): the reference of
    # BF16_WIDE_GRAD_TOL
    in_order = parity.ce_grads_bf16_in_order(states, table, answers, logz, dloss, v)
    # the fp32 form's references: the plain fp32 version and the same in fp64
    want32_loss, logz32 = ce.ce_loss_logz_plain(states, table, answers, v)
    want32_ds, want32_dt = ce.ce_grads_plain(states, table, answers, logz32, dloss, v)
    fp64 = ce.ce_grads_plain(states.double(), table.double(), answers, logz32.double(), dloss.double(), v)
    fp64_logz = ce.ce_logz_plain(states.double(), table.double(), v)
    print(json.dumps({"accuracy": "plain fp32", "B": b, "V": v, "H": h,
                      "logZ vs fp64": float(((logz32.double() - fp64_logz).abs()
                                             / fp64_logz.abs().clamp(min=1.0)).max()),
                      "gradients vs fp64": parity.grad_errors(want32_ds, want32_dt, *fp64, answers, v)}),
          flush=True)
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    f_splits, f_per = ce.tc_splits(v, ce._TC_FWD_VT, sm)
    g_splits, g_per = ce.tc_splits(v, ce._TC_VT, sm)
    p, i = ctypes.c_void_p, ctypes.c_int
    stream = lambda: torch.cuda.current_stream().cuda_stream
    calls, keep = {}, []
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.ce_logz.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, i, p]
        lib.ce_grads.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p, p, p, i, p]
        lib.ce_logz_workspace_bytes.argtypes = lib.ce_grads_workspace_bytes.argtypes = [i, i, i, i]
        lib.ce_logz_workspace_bytes.restype = lib.ce_grads_workspace_bytes.restype = ctypes.c_longlong
        forms = (1, 0) if name in MID_BOTH_FORMS else (0,) if name.startswith("fp32") else (1,)
        for form in forms:
            f_work = torch.empty((lib.ce_logz_workspace_bytes(b, h, form, f_splits),),
                                 dtype=torch.uint8, device=dev)
            g_work = torch.empty((lib.ce_grads_workspace_bytes(b, h, form, g_splits),),
                                 dtype=torch.uint8, device=dev)
            loss, z = torch.empty((b,), device=dev), torch.empty((b,), device=dev)
            ds, dt = torch.empty((b, h), device=dev), torch.empty((v, h), device=dev)
            keep += [f_work, g_work, loss, z, ds, dt]
            fwd = (states.data_ptr(), table.data_ptr(), answers.data_ptr(), b, v, h, v, f_splits,
                   f_per, f_work.data_ptr(), z.data_ptr(), loss.data_ptr(), form)
            bwd = (states.data_ptr(), table.data_ptr(), answers.data_ptr(),
                   (logz if form else logz32).data_ptr(), dloss.data_ptr(), b, v, h, v, g_splits,
                   g_per, g_work.data_ptr(), ds.data_ptr(), dt.data_ptr(), form)
            tag = (("fp32 kernel" if name == "kernel" else f"{'bf16' if form else 'fp32'} {name}")
                   if name in MID_BOTH_FORMS else name)
            calls[f"forward: {tag}"] = lambda lib=lib, a=fwd: lib.ce_logz(*a, stream())
            calls[f"backward: {tag}"] = lambda lib=lib, a=bwd: lib.ce_grads(*a, stream())
            if name.startswith(cut):
                continue
            if calls[f"forward: {tag}"]() != 0 or calls[f"backward: {tag}"]() != 0:
                raise SystemExit(f"ablate_ce_tc: {name!r} launch failed")
            torch.cuda.synchronize()
            if not form:  # against the plain fp32 version (CE_TOL, WIDE_GRAD_TOL) and fp64
                print(json.dumps({
                    "accuracy": tag, "B": b, "V": v, "H": h,
                    "logZ vs plain fp32": float(((z - logz32).abs() / logz32.abs().clamp(min=1.0)).max()),
                    "loss vs plain fp32": float(((loss - want32_loss).abs()
                                                 / want32_loss.abs().clamp(min=1.0)).max()),
                    "logZ vs fp64": float(((z.double() - fp64_logz).abs() / fp64_logz.abs().clamp(min=1.0)).max()),
                    "gradients vs plain fp32": parity.grad_errors(ds, dt, want32_ds, want32_dt, answers, v),
                    "gradients vs fp64": parity.grad_errors(ds, dt, *fp64, answers, v)}), flush=True)
                continue
            errs = parity.grad_errors(ds, dt, want_ds, want_dt, answers, v)
            print(json.dumps({"accuracy": tag, "B": b, "V": v, "H": h,
                              "logZ vs plain bf16": float(((z - logz).abs() / logz.abs().clamp(min=1.0)).max()),
                              "loss vs plain bf16": float(((loss - want_loss).abs() / want_loss.abs().clamp(min=1.0)).max()),
                              "gradients vs plain bf16": errs,
                              "gradients vs plain bf16, logits in ascending h":
                                  parity.grad_errors(ds, dt, *in_order, answers, v)}), flush=True)
    (fwd_lib, fwd_name), (back_lib, back_name) = smoke.bf16_yardsticks(states, table, answers)

    def zero(fn):
        return lambda: (fn(), 0)[1]
    calls[f"forward: library {fwd_name}"] = zero(fwd_lib)
    calls[f"backward: library {back_name}"] = zero(back_lib)
    # ... and the fp32 form's (chip_smoke.py:phase_ce_times'), full fp32 products
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    s_req, t_req = states.clone().requires_grad_(), table.clone().requires_grad_()
    lib32_loss = F.cross_entropy(s_req @ t_req.T, answers)
    calls["forward: library F.cross_entropy(states @ table.T), fp32"] = zero(
        lambda: F.cross_entropy(states @ table.T, answers))
    calls["backward: library backward of F.cross_entropy(states @ table.T), fp32"] = zero(
        lambda: torch.autograd.grad(lib32_loss, (s_req, t_req), retain_graph=True))
    for name, r in timed_in_turns(calls).items():
        print(json.dumps({"variant": name, "ms": r, "B": b, "V": v, "H": h}), flush=True)
    del keep, calls, states, table, want_ds, want_dt, in_order, want32_ds, want32_dt, fp64
    del lib32_loss, s_req, t_req
    torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", help="only check that the replacements apply")
    ap.add_argument("--onchip", action="store_true", help="the bf16 on-chip route's variants")
    ap.add_argument("--mid", action="store_true", help="the middle route's variants, both forms")
    ap.add_argument("--mid-batches", action="store_true",
                    help="the fp32 middle route's two backward kernels across B")
    ap.add_argument("--only", action="append", metavar="TEXT",
                    help="with --onchip or --mid: build only the variants whose name holds TEXT "
                         "(and the kernel as it is); may repeat")
    args = ap.parse_args()
    texts = sources()
    if args.check:
        onchip, mid = sources(ONCHIP_VARIANTS), sources(MID_VARIANTS)
        print(f"ablate_ce_tc: {len(texts)} variants, {len(onchip)} on-chip variants and "
              f"{len(mid)} middle-route variants apply")
        return
    if args.onchip:
        onchip_main(args.only)
        return
    if args.mid:
        mid_main(args.only)
        return
    if args.mid_batches:
        mid_batches_main()
        return
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ablate_ce_tc: no CUDA device")
    libs = build(texts)
    sys.path.insert(0, str(ROOT))
    from bsarec_tpu_torch.ops import ce

    dev = torch.device("cuda")
    rng = np.random.default_rng(100)
    states = torch.from_numpy(rng.standard_normal((B, H), dtype=np.float32)).to(dev)
    table = torch.from_numpy(0.25 * rng.standard_normal((V, H), dtype=np.float32)).to(dev)
    answers = torch.from_numpy(rng.integers(1, V, size=B)).to(dev)
    dloss = torch.full((B,), 1.0 / B, device=dev)
    _, logz = ce.ce_loss_logz(states, table, answers, V, dtype="bfloat16")
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    n_splits, per = ce.tc_splits(V, ce._TC_VT, sm)
    work = torch.empty((ce._lib().ce_grads_workspace_bytes(B, H, 1, n_splits),),
                       dtype=torch.uint8, device=dev)
    _, x_logz = ce.ce_loss_logz(states, table, answers, V)
    x_splits, x_per = ce.tc_splits(V, ce._TF_VT, sm)
    x_work = torch.empty((ce._lib().ce_grads_workspace_bytes(B, H, 0, x_splits),),
                         dtype=torch.uint8, device=dev)
    ds, dt = torch.empty((B, H), device=dev), torch.empty((V, H), device=dev)
    f_splits, f_per = ce.tc_splits(V, ce._TC_FWD_VT, sm)
    f_work = torch.empty((ce._lib().ce_logz_workspace_bytes(B, H, 1, f_splits),),
                         dtype=torch.uint8, device=dev)
    w_work = torch.empty((ce._lib().ce_logz_workspace_bytes(B, H, 0, f_splits),),
                         dtype=torch.uint8, device=dev)
    f_logz = torch.empty((B,), device=dev)
    p, i = ctypes.c_void_p, ctypes.c_int
    calls = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        stream = lambda: torch.cuda.current_stream().cuda_stream
        lib.ce_grads.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p, p, p, i, p]
        if not name.startswith(("forward", "fp32", "fwd32")):
            args = (states.data_ptr(), table.data_ptr(), answers.data_ptr(), logz.data_ptr(),
                    dloss.data_ptr(), B, V, H, V, n_splits, per, work.data_ptr(), ds.data_ptr(),
                    dt.data_ptr(), 1)
            calls[name] = lambda lib=lib, args=args: lib.ce_grads(*args, stream())
        if name == "kernel" or name.startswith("fp32"):
            args = (states.data_ptr(), table.data_ptr(), answers.data_ptr(), x_logz.data_ptr(),
                    dloss.data_ptr(), B, V, H, V, x_splits, x_per, x_work.data_ptr(),
                    ds.data_ptr(), dt.data_ptr(), 0)
            calls["fp32 kernel" if name == "kernel" else name] = (
                lambda lib=lib, args=args: lib.ce_grads(*args, stream()))
        lib.ce_logz.argtypes = [p, p, p, i, i, i, i, i, i, p, p, p, i, p]
        if name == "kernel" or name.startswith("forward"):
            args = (states.data_ptr(), table.data_ptr(), None, B, V, H, V, f_splits, f_per,
                    f_work.data_ptr(), f_logz.data_ptr(), None, 1)
            calls["forward kernel" if name == "kernel" else name] = (
                lambda lib=lib, args=args: lib.ce_logz(*args, stream()))
        if name == "kernel" or name.startswith("fwd32"):
            args = (states.data_ptr(), table.data_ptr(), None, B, V, H, V, f_splits, f_per,
                    w_work.data_ptr(), f_logz.data_ptr(), None, 0)
            calls["fwd32 kernel" if name == "kernel" else name] = (
                lambda lib=lib, args=args: lib.ce_logz(*args, stream()))

    for name, r in timed_in_turns(calls).items():
        print(json.dumps({"variant": name, "ms": r, "B": B, "V": V, "H": H}), flush=True)
    del work, f_work, w_work, ds, dt
    torch.cuda.empty_cache()
    accuracy({name: libs[name] for name in ("kernel", "fp32: hi by cvt.rna", "fp32: 1xTF32")},
             states, table, answers, dev)
    accuracy_forward({name: libs[name] for name in
                      ("kernel", "fwd32: split once per staged chunk", "fwd32: 1xTF32")},
                     states, table, dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()

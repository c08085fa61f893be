"""Where the rank kernel's tensor-core route spends its time: build copies
of `csrc/streaming_rank.cu` with parts of `rank_wide_tf32_kernel` cut
out, and time each through `ops/rank.py` at V=1,000,000, H=512, k=20, at
B=256 and B=16.

Each variant is this checkout's source with text replacements (each must
match exactly once, so a variant that no longer applies fails loudly):
the whole kernel; without its epilogue (the tile's scores summed and
dropped: no masks, offers or merges, so the MMA loop, the copies and the
barriers alone); and 1xTF32 (the two correction passes of every product
cut), which shows what fp32 accuracy costs. The older route
(`rank_partial_kernel`, fp32 FMAs) is timed beside them through the
whole kernel's build. The whole kernel and 1xTF32 are held against the
exact scores: the largest |value - the float64 score of the returned
id| (seen items at 0.0), beside the plain fp32 version's own; the cut
variants compute wrong results and are timed only. Every library is
built with `ops/_build.py`'s flags and `-Xptxas -v` into
`build/ablate_rank/`, one nvcc each, all started together; each line
also gives the kernel's registers and spills. One reading is the mean of
10 calls (CUDA events, after one warm-up), the variants timed in order
and then in reverse.

    python3 bsarec_tpu_torch/tools/ablate_rank_tc.py            # needs a card and nvcc
    python3 bsarec_tpu_torch/tools/ablate_rank_tc.py --mid      # the middle route's variants
    python3 bsarec_tpu_torch/tools/ablate_rank_tc.py --check    # the replacements apply (no card)

With `--mid`, the middle route instead (V=1,000,000, k=20, H in
MID_WIDTHS = {128, 256}, B in MID_BATCHES = {256, 128, ..., 2, 1}; `MID_VARIANTS`,
built into `build/ablate_rank/mid*`): the routed kernel
(`rank_mid_tf32_kernel`, warpgroup MMAs) and it without its epilogue (the
cut above, in that kernel); the other design, `rank_wide_tf32_kernel`
(`mma.sync`) with its `TW_MIN_H` bound lifted to 64 and the middle route
off, so that it takes these shapes, with and without its epilogue; the
older route (`rank_partial_kernel`, through the kernel's build with
`allow_mid=False`) and the library call (`matmul` + `masked_fill_` +
`topk`), all in turns (in order, then in reverse). Each line gives the
route the shape took, ptxas's registers and spills of the kernels in the
build (the older route's line: `rank_partial_kernel<false>`'s) and, for
the whole kernels and the older route, the largest |value - the float64
score of its id| at B=256.

Prints one JSON line per variant, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CSRC = ROOT / "bsarec_tpu_torch" / "csrc"
OUT = ROOT / "build" / "ablate_rank"
V, H, K = 1_000_000, 512, 20
BATCHES = (256, 16)

NO_EPILOGUE = [(
    "        const bool offered =\n"
    "            offer_tile(acc, sM + ((s / nk) & 1) * TW_MSLOT, lv, li, cnt, pv, pi, ov, oi, k,\n"
    "                       (t_begin + s / nk) * TW_COLS, n_valid, seen_value, rows);\n"
    "        // every offer is written; the merges are seen by the next tile's\n"
    "        // offers after the next step's barrier\n"
    "        if (__syncthreads_or(offered)) merge_pending(lv, li, cnt, pv, pi, ov, oi, k);\n",
    "        float z = 0.f;  // the scores kept live, then dropped\n"
    "        for (int i = 0; i < 4; ++i)\n"
    "          for (int j = 0; j < 8; ++j)\n"
    "            for (int e = 0; e < 4; ++e) z += acc[i][j][e];\n"
    "        if (z == 1e30f) cnt[0] = 1;\n")]
ONE_PASS = [("      tc::mma_3xtf32(part, ah, al, bh, bl);",
             "      tc::mma_pass(2, part, ah, al, bh, bl);")]

VARIANTS = {"kernel": [], "no epilogue": NO_EPILOGUE, "1xTF32": ONE_PASS}
EXACT = ("kernel", "1xTF32")  # the variants that rank correctly (the others are timed only)

MID_WIDTHS = (128, 256)
MID_BATCHES = (256, 128, 64, 32, 16, 8, 4, 2, 1)
# rank_mid_tf32_kernel's epilogue cut as NO_EPILOGUE cuts the wide kernel's
MID_NO_EPILOGUE = [(
    "      const bool offered = offer_tile<RM_PEND, true>(acc, sM, lv, li, cnt, pv, pi, ov, oi, k,\n"
    "                                                     (t_begin + s / nk) * MF_COLS, n_valid,\n"
    "                                                     seen_value, B);\n"
    "      // every offer is written; the merges are seen by the next tile's\n"
    "      // offers after the next step's barrier\n"
    "      if (__syncthreads_or(offered)) merge_pending<RM_PEND>(lv, li, cnt, pv, pi, ov, oi, k);\n",
    "      float z = 0.f;  // the scores kept live, then dropped\n"
    "      for (int i = 0; i < 4; ++i)\n"
    "        for (int j = 0; j < 8; ++j)\n"
    "          for (int e = 0; e < 4; ++e) z += acc[i][j][e];\n"
    "      if (z == 1e30f) cnt[0] = 1;\n")]
# the middle shapes sent to rank_wide_tf32_kernel: its bound lifted to the
# on-chip route's, the middle route off
TO_WIDE = [("constexpr int TW_MIN_H = 256;", "constexpr int TW_MIN_H = 64;"),
           ("  return B <= RM_ROWS && H > onchip::MAX_H && H <= RM_MAX_H && k <= TW_K;",
            "  return false;")]
MID_VARIANTS = {
    "kernel": [],
    "no epilogue": MID_NO_EPILOGUE,
    "rank_wide_tf32_kernel": TO_WIDE,
    "rank_wide_tf32_kernel, no epilogue": TO_WIDE + NO_EPILOGUE,
}
MID_EXACT = ("kernel", "rank_wide_tf32_kernel")
# the kernels whose registers and spills --mid reports (the older route's
# form at k <= 128 and H <= 256: rank_partial_kernel<false>)
KERNELS = ("rank_mid_tf32_kernel", "rank_wide_tf32_kernel", "rank_partial_kernelILb0EE")


def sources(variants: dict | None = None) -> dict[str, str]:
    """{variant: source text} of `variants` (default VARIANTS); raises
    unless every replacement matches once."""
    base = (CSRC / "streaming_rank.cu").read_text()
    out = {}
    for name, replacements in (VARIANTS if variants is None else variants).items():
        text = base
        for old, new in replacements:
            if text.count(old) != 1:
                raise SystemExit(f"ablate_rank_tc: {name!r}: {old.strip()[:60]!r} matches "
                                 f"{text.count(old)} times")
            text = text.replace(old, new)
        out[name] = text
    return out


def ptxas(log: str, kernel: str) -> str:
    """ptxas's registers and spills of `kernel` in a -Xptxas -v log."""
    found = re.search(rf"Compiling entry function '[^']*{kernel}[^']*'.*?\n"
                      r".*?\n\s*(\d+ bytes stack frame, [^\n]*)\n[^\n]*Used (\d+) registers",
                      log)
    return f"{found.group(2)} registers, {found.group(1)}" if found else "not found"


def build(texts: dict[str, str], prefix: str = "v", kernels=("rank_wide_tf32_kernel",)):
    """{variant: (library, {kernel: ptxas's registers and spills})}."""
    sys.path.insert(0, str(ROOT))
    from bsarec_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for n, (name, text) in enumerate(texts.items()):
        src, lib = OUT / f"{prefix}{n}.cu", OUT / f"{prefix}{n}.so"
        src.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
               "-o", str(lib), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, lib)
    out = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"ablate_rank_tc: nvcc failed for {name!r}:\n{log}")
        out[name] = (lib, {kernel: ptxas(log, kernel) for kernel in kernels})
    return out


def cuda_ms(fn, iters: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def exact_err(states, table, bitmask, vals, ids) -> float:
    """The largest |value - the float64 score of its id| (seen ids at 0.0)."""
    import torch

    idx = ids.long()
    exact = torch.einsum("bh,bkh->bk", states.double(), table[idx].double())
    seen = ((torch.gather(bitmask, 1, idx >> 5) >> (idx & 31).int()) & 1).bool()
    exact = torch.where(seen, torch.zeros_like(exact), exact)
    return float((vals.double() - exact).abs().max())


def mid_main() -> None:
    """The --mid mode (module docstring)."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from bsarec_tpu_torch.ops import rank
    from bsarec_tpu_torch.train.trainer import set_fp32_matmul

    if not torch.cuda.is_available():
        raise SystemExit("ablate_rank_tc: no CUDA device")
    set_fp32_matmul()
    built = build(sources(MID_VARIANTS), prefix="mid", kernels=KERNELS)
    libs = {name: rank.bind(ctypes.CDLL(str(path))) for name, (path, _) in built.items()}
    dev = torch.device("cuda")
    f = rank.streaming_masked_topk

    def use(name):  # the variant's library, and its routes asked anew
        rank._lib = lambda: libs[name]
        for route in (rank.onchip_route, rank.mid_route, rank.tc_route, rank.wide_route):
            route.cache_clear()

    def route_of(fn):
        before = (f.mid_launches, f.tc_launches)
        fn()
        return ("rank_mid_tf32_kernel" if f.mid_launches > before[0]
                else "rank_wide_tf32_kernel" if f.tc_launches > before[1] else "rank_partial_kernel")

    order = [*MID_VARIANTS, "older route", "library"]
    for h in MID_WIDTHS:
        rng = np.random.default_rng(h)
        states = torch.from_numpy(rng.standard_normal((max(MID_BATCHES), h), dtype=np.float32)).to(dev)
        table = torch.from_numpy(
            np.float32(math.sqrt(64 / h)) * rng.standard_normal((V, h), dtype=np.float32)).to(dev)
        seen = rng.integers(1, V, size=(max(MID_BATCHES), 20)).astype(np.int32)
        bitmask = torch.from_numpy(rank.build_seen_bitmask(seen, V)).to(dev)
        errs = {}
        for name in MID_EXACT:
            use(name)
            vals, ids = rank.streaming_masked_topk(states, table, bitmask, K, V)
            errs[name] = exact_err(states, table, bitmask, vals, ids)
        use("kernel")
        vals, ids = rank._launch(states, table, bitmask, K, V, allow_mid=False, allow_tc=False)
        errs["older route"] = exact_err(states, table, bitmask, vals, ids)
        del vals, ids
        readings = {name: {b: [] for b in MID_BATCHES} for name in order}
        routes = {name: {} for name in order}
        for b in MID_BATCHES:
            s, m = states[:b].contiguous(), bitmask[:b].contiguous()
            cols = torch.arange(V, device=dev)
            masked = ((m[:, cols >> 5] >> (cols & 31).int()) & 1).bool()
            del cols
            for name in order + order[::-1]:
                use("kernel" if name in ("older route", "library") else name)
                if name == "library":  # the yardstick only
                    fn = lambda: torch.topk(torch.matmul(s, table.T).masked_fill_(masked, 0.0), K)
                elif name == "older route":
                    fn = lambda: rank._launch(s, table, m, K, V, allow_mid=False, allow_tc=False)
                else:
                    fn = lambda: rank._launch(s, table, m, K, V)
                if name != "library" and b not in routes[name]:
                    routes[name][b] = route_of(fn)
                readings[name][b].append(cuda_ms(fn))
            del masked
            torch.cuda.empty_cache()
        for name in order:
            line = {"variant": name, "V": V, "H": h, "k": K,
                    "ms": {f"B={b}": readings[name][b] for b in MID_BATCHES}}
            if routes[name]:
                line["route"] = {f"B={b}": r for b, r in routes[name].items()}
            if name in built:
                line["ptxas"] = built[name][1]
            elif name == "older route":
                line["ptxas"] = {"rank_partial_kernel<false>":
                                 built["kernel"][1]["rank_partial_kernelILb0EE"]}
            if name in errs:
                line["max_err_vs_fp64"] = errs[name]
            print(json.dumps(line), flush=True)
        del states, table, bitmask
        torch.cuda.empty_cache()
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(out.stdout.strip().splitlines()[0], flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", help="only check that the replacements apply")
    ap.add_argument("--mid", action="store_true", help="the middle route's variants")
    args = ap.parse_args()
    texts = sources()
    if args.check:
        mid = sources(MID_VARIANTS)
        print(f"ablate_rank_tc: {len(texts)} variants and {len(mid)} middle-route variants apply")
        return
    if args.mid:
        mid_main()
        return
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from bsarec_tpu_torch.ops import rank
    from bsarec_tpu_torch.train.trainer import set_fp32_matmul

    if not torch.cuda.is_available():
        raise SystemExit("ablate_rank_tc: no CUDA device")
    set_fp32_matmul()
    built = build(texts)
    libs = {name: rank.bind(ctypes.CDLL(str(path))) for name, (path, _) in built.items()}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    states = torch.from_numpy(rng.standard_normal((max(BATCHES), H), dtype=np.float32)).to(dev)
    table = torch.from_numpy(
        (math.sqrt(64 / H) * rng.standard_normal((V, H))).astype(np.float32)).to(dev)
    seen = rng.integers(1, V, size=(max(BATCHES), 20)).astype(np.int32)
    bitmask = torch.from_numpy(rank.build_seen_bitmask(seen, V)).to(dev)

    def use(name):
        rank._lib = lambda: libs[name]

    errs = {}
    for name in EXACT:
        use(name)
        vals, ids = rank.streaming_masked_topk(states, table, bitmask, K, V)
        errs[name] = exact_err(states, table, bitmask, vals, ids)
    vals, ids = rank.streaming_masked_topk_plain(states, table, bitmask, K, V)
    errs["plain"] = exact_err(states, table, bitmask, vals, ids)
    order = [*VARIANTS, "older route"]
    readings = {name: {b: [] for b in BATCHES} for name in order}
    for b in BATCHES:
        s, m = states[:b].contiguous(), bitmask[:b].contiguous()
        for name in order + order[::-1]:
            use("kernel" if name == "older route" else name)
            if name == "older route":
                fn = lambda: rank._launch(s, table, m, K, V, allow_tc=False, allow_mid=False)
            else:
                fn = lambda: rank._launch(s, table, m, K, V)
            readings[name][b].append(cuda_ms(fn))
    for name in order:
        line = {"variant": name, "V": V, "H": H, "k": K,
                "ms": {f"B={b}": readings[name][b] for b in BATCHES}}
        if name in built:
            line["ptxas"] = built[name][1]
        if name in errs:
            line["max_err_vs_fp64"] = errs[name]
        print(json.dumps(line), flush=True)
    print(json.dumps({"variant": "plain version", "max_err_vs_fp64": errs["plain"]}), flush=True)
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(out.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()

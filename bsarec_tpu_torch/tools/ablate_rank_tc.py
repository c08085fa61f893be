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
    python3 bsarec_tpu_torch/tools/ablate_rank_tc.py --check    # the replacements apply (no card)

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


def sources() -> dict[str, str]:
    """{variant: source text}; raises unless every replacement matches once."""
    base = (CSRC / "streaming_rank.cu").read_text()
    out = {}
    for name, replacements in VARIANTS.items():
        text = base
        for old, new in replacements:
            if text.count(old) != 1:
                raise SystemExit(f"ablate_rank_tc: {name!r}: {old.strip()[:60]!r} matches "
                                 f"{text.count(old)} times")
            text = text.replace(old, new)
        out[name] = text
    return out


def build(texts: dict[str, str]) -> dict[str, tuple[Path, str]]:
    """{variant: (library, ptxas's registers and spills of rank_wide_tf32_kernel)}."""
    sys.path.insert(0, str(ROOT))
    from bsarec_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for n, (name, text) in enumerate(texts.items()):
        src, lib = OUT / f"v{n}.cu", OUT / f"v{n}.so"
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
        found = re.search(r"Compiling entry function '[^']*rank_wide_tf32_kernel[^']*'.*?\n"
                          r".*?\n\s*(\d+ bytes stack frame, [^\n]*)\n[^\n]*Used (\d+) registers",
                          log)
        out[name] = (lib, f"{found.group(2)} registers, {found.group(1)}" if found else "not found")
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true", help="only check that the replacements apply")
    args = ap.parse_args()
    texts = sources()
    if args.check:
        print(f"ablate_rank_tc: {len(texts)} variants apply")
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
                fn = lambda: rank._launch(s, table, m, K, V, allow_tc=False)
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

"""Time the streaming-CE kernels at the training shape, and compare
checkouts of the port on one card.

One reading is the mean of 20 calls (CUDA events, after warm-up) of
`ce_grads` and of `ce_loss_logz` at B=256, V=1,000,000, H=64 in fp32 on
seeded inputs, as `chip_smoke.py` times them (`time ce_grads kernel`,
`time ce_logz kernel`); two readings each, in turns. Both calls are
public entries that every version of the port has, so an older
checkout's package is timed by the same code. Each process first holds
`ce_grads` against `ce_grads_plain` (GRAD_TOL relative to the largest
|plain| entry) and two calls bit for bit.

    python3 bsarec_tpu_torch/tools/time_ce_grads.py
        # this checkout's package
    python3 bsarec_tpu_torch/tools/time_ce_grads.py --against DIR [DIR ...]
        # the DIRs' packages, then this one; then the same in reverse
        # order: one process each, in turns

Each process prints one JSON line; the comparison ends with the card's
name and power limit. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
B, V, H = 256, 1_000_000, 64
ITERS = 20
GRAD_TOL = 1e-4  # chip_smoke.py's


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


def rel_err(got, want) -> float:
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


def time_package(package_root: Path) -> dict:
    """{"ce_grads": [ms, ms], "ce_logz": [ms, ms], ...} for the package
    under `package_root`, in turns grads, logz, logz, grads."""
    sys.path.insert(0, str(package_root))
    import numpy as np
    import torch

    from bsarec_tpu_torch.ops import ce

    if not torch.cuda.is_available():
        raise SystemExit("time_ce_grads: no CUDA device")
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
        raise SystemExit(f"time_ce_grads: ce_grads off its plain version ({err}) or not deterministic")
    del ds, dt, ds2, dt2, want_ds, want_dt
    grads = lambda: ce.ce_grads(states, table, answers, logz, d, V)
    logz_fn = lambda: ce.ce_loss_logz(states, table, answers, V)
    g1, l1, l2, g2 = cuda_ms(grads), cuda_ms(logz_fn), cuda_ms(logz_fn), cuda_ms(grads)
    return {"ce_grads": [g1, g2], "ce_logz": [l1, l2], "ce_grads_rel_err": err,
            "onchip_launches": getattr(ce.ce_grads, "onchip_launches", None)}


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
    args = ap.parse_args()
    if args.against is None:
        print(json.dumps({"package": str(args.package_root), "B": B, "V": V, "H": H,
                          "ms": time_package(args.package_root.resolve())}), flush=True)
        return
    order = [*args.against, args.package_root]
    for root in order + order[::-1]:
        subprocess.run([sys.executable, __file__, "--package-root", str(root.resolve())],
                       check=True, timeout=600)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()

"""Time the fused dropout sites as training runs them, and compare two
checkouts of the port on one card.

One reading is a forward through a chain of 7 `FusedDropout` sites (a
SASRec step's count) and one `torch.autograd.grad` on a leaf that
requires grad, per site, against the same chain of `nn.Dropout` sites,
in turns (fused, nn, nn, fused), at both of SASRec's site shapes, fp32,
rate 0.5: the measurement `chip_smoke.py` prints as `time fused_dropout
forward through 7 sites`. Both chains use only the public API that every
version of the port has (`DropoutState`, `FusedDropout`), so an older
checkout's package is timed by the same code.

    python3 bsarec_tpu_torch/tools/time_dropout_sites.py
        # this checkout's package
    python3 bsarec_tpu_torch/tools/time_dropout_sites.py --against DIR
        # DIR's package, this one, this one, DIR's: one process each, in turns

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
SITES = 7
SHAPES = {"hidden": (256, 50, 64), "attention": (256, 2, 50, 50)}
ITERS = 100


def cuda_ms(fn, iters: int, warmup: int = 5) -> float:
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


def time_package(package_root: Path) -> dict:
    """{shape: {"fused": [ms, ms], "nn": [ms, ms]}} per site for the
    package under `package_root`, in turns fused, nn, nn, fused."""
    sys.path.insert(0, str(package_root))
    import torch

    from bsarec_tpu_torch.models.modules import DropoutState, FusedDropout

    if not torch.cuda.is_available():
        raise SystemExit("time_dropout_sites: no CUDA device")
    device = torch.device("cuda")
    seeds = torch.tensor([123456789, 987654321], dtype=torch.int64, device=device)
    state = DropoutState(fused=True)
    state.begin_step(seeds)
    fused = torch.nn.Sequential(*[FusedDropout(0.5, state) for _ in range(SITES)]).train()
    plain = torch.nn.Sequential(*[torch.nn.Dropout(0.5) for _ in range(SITES)]).train()
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for name, shape in SHAPES.items():
        leaf = torch.randn(shape, device=device, generator=gen).requires_grad_()
        g = torch.randn(shape, device=device, generator=gen)

        def through_fused():
            state.call = 0
            torch.autograd.grad(fused(leaf), leaf, g)

        def through_nn():
            torch.autograd.grad(plain(leaf), leaf, g)

        per_site = lambda fn: cuda_ms(fn, ITERS) / SITES
        f1, n1, n2, f2 = per_site(through_fused), per_site(through_nn), per_site(through_nn), \
            per_site(through_fused)
        out[name] = {"fused": [f1, f2], "nn": [n1, n2]}
    return out


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", type=Path, default=ROOT,
                    help="the checkout whose bsarec_tpu_torch is timed (default: this one)")
    ap.add_argument("--against", type=Path, default=None,
                    help="another checkout: time its package and this one in turns, one process each")
    args = ap.parse_args()
    if args.against is None:
        print(json.dumps({"package": str(args.package_root), "ms_per_site": time_package(
            args.package_root.resolve())}), flush=True)
        return
    for root in (args.against, args.package_root, args.package_root, args.against):
        subprocess.run([sys.executable, __file__, "--package-root", str(root.resolve())],
                       check=True, timeout=600)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()

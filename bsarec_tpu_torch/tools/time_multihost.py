"""Time `main --multihost` (the host-fed pipeline) against the plain,
device-resident run on one card, in turns.

On `chip_smoke.py`'s phase-7 corpus (1,000,000 items, 10,000 users,
BSARec at its widths, batch 256, one epoch with validation and the test
pass), after one run that is not counted, `--pairs N` rounds of plain,
host-fed, host-fed, plain, each run through `chip_smoke.mesh_run` (the
launch counts set to 0 before it, the epoch's examples/s and loss read
from its log, the card's peak allocated bytes over it): the measurement `chip_smoke.py` prints as `mesh main`
and `multihost memory`, repeated to see past the host's spread. Every
run's loss and scores must equal the first run's.

    python3 bsarec_tpu_torch/tools/time_multihost.py [--pairs 3]

Prints one JSON line per run, then one with the medians and the card's
name and power limit. Needs a card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load_chip_smoke():
    sys.path.insert(0, str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--pairs", type=int, default=3,
                        help="rounds of plain, host-fed, host-fed, plain")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_multihost: no CUDA device visible", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    from bsarec_tpu_torch.config import set_fp32_matmul
    from bsarec_tpu_torch.ops import _build

    set_fp32_matmul()
    _build.build_all(verbose=False)
    card = cs.card_line()
    readings = {"plain": [], "host": []}
    peaks = {"plain": [], "host": []}
    with tempfile.TemporaryDirectory() as workdir:
        seqs = cs.synth_corpus(cs.TRAIN_USERS, cs.N_ITEMS, seed=1)
        with open(os.path.join(workdir, "synth_train.txt"), "w") as fh:
            for u, seq in enumerate(seqs):
                fh.write(f"{u + 1} {' '.join(map(str, seq))}\n")
        argv = ["--data_dir", workdir, "--data_name", "synth_train", "--output_dir", workdir,
                "--device", "cuda", "--batch_size", str(cs.TRAIN_BATCH), "--epochs", "1",
                "--lr", str(cs.LR), *cs.WIDTHS]
        # a first run, not counted, takes the process's one-time costs
        first = cs.mesh_run(argv + ["--train_name", "warmup"])
        first = (first[0], first[3])
        for _ in range(args.pairs):
            for kind in ("plain", "host", "host", "plain"):
                name = f"{kind}{len(readings[kind])}"
                extra = ["--multihost"] if kind == "host" else []
                scores, counts, rate, loss, _, (peak, start) = cs.mesh_run(
                    argv + ["--train_name", name] + extra)
                cs.check((scores, loss) == first, f"{name}: scores {scores} / loss {loss} "
                         f"differ from the first run's {first}")
                readings[kind].append(rate)
                peaks[kind].append(peak - start)
                print(json.dumps({"run": name, "examples_per_s": rate, "loss": loss,
                                  "peak_bytes": peak - start, "launches": counts}), flush=True)
    print(json.dumps({"median_examples_per_s": {k: statistics.median(v)
                                                for k, v in readings.items()},
                      "examples_per_s": readings, "peak_bytes": peaks, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

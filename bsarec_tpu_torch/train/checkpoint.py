"""Parameter checkpoints (counterpart of `bsarec_tpu/train/checkpoint.py`).

Parameters only, as the reference saves them (`src/utils.py:171-176`):
an atomic write-then-rename of `torch.save(state_dict)`, so a crash
mid-write never corrupts the previous good checkpoint. Full train-state
resume is not ported yet.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch


def save_params(state_dict: dict, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    cpu = {k: v.detach().cpu() for k, v in state_dict.items()}
    with open(tmp, "wb") as fh:
        torch.save(cpu, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def load_params(path: str | Path) -> dict:
    """The saved `state_dict`, as CPU tensors."""
    return torch.load(path, map_location="cpu", weights_only=True)

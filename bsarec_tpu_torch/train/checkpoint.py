"""Checkpoints (counterpart of `bsarec_tpu/train/checkpoint.py`).

- `save_params` / `load_params`: parameters only, as the reference saves
  them (`src/utils.py:171-176`), a `torch.save`d state_dict in the
  reference's key layout.
- `load_reference_params`: a state_dict that the reference's torch code
  saved, for `--load_torch_model`. It reads an older BSARec
  checkpoint's `filter_layer.beta` as `sqrt_beta`, as the reference's own
  loader does (`src/trainers.py:47-60`) and as the JAX package's importer
  does (`bsarec_tpu/train/torch_import.py:76-78`).
  `load_params` renames nothing: a port checkpoint with an unknown key
  is refused by the strict `load_state_dict` behind `Trainer.load`.
- `save_train_state` / `load_train_state`: the full training state, so
  that `--resume` continues an interrupted run where it stopped: params,
  the Adam state, the epoch, the random generators' states (the
  trainer's device generator, which draws the epoch order, the negatives,
  BERT4Rec's cloze positions and the fused dropout's seeds; torch's
  default generators; the numpy generator of the same-target view), the
  early-stopping best score and counter, and the model-config
  fingerprint that `Trainer.resume` checks.

Both write to a temporary file, fsync it and rename it over the target,
so a crash mid-write never corrupts the previous good file. Tensors are
saved on the CPU, so a snapshot loads on any device.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import torch


def _cpu(obj):
    """`obj` with every tensor detached and copied to the CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu(v) for v in obj)
    return obj


def _atomic_save(obj, path: str | Path) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fh:
        torch.save(obj, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def save_params(state_dict: dict, path: str | Path) -> None:
    _atomic_save(_cpu(state_dict), path)


def load_params(path: str | Path) -> dict:
    """The saved `state_dict`, as CPU tensors."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_reference_params(path: str | Path) -> dict:
    """A reference torch checkpoint's `state_dict`, as CPU tensors, with
    each `...filter_layer.beta` of an older BSARec checkpoint named
    `...filter_layer.sqrt_beta`, its name since the reference renamed it,
    where the file does not hold that key already."""
    params = load_params(path)
    old, new = ".filter_layer.beta", ".filter_layer.sqrt_beta"
    renamed = {}
    for key, value in params.items():
        if key.endswith(old) and key[: -len(old)] + new not in params:
            key = key[: -len(old)] + new
        renamed[key] = value
    return renamed


def save_train_state(path: str | Path, params: dict, opt_state: dict, epoch: int,
                     rng_states: dict, best_score=None, patience_counter: int = 0,
                     config_fp: str = "") -> None:
    """The full resumable state. `best_score` is None before the first
    validation; `rng_states` maps a generator's name to its state."""
    best = None if best_score is None else [float(x) for x in np.asarray(best_score).reshape(-1)]
    _atomic_save({
        "params": _cpu(params),
        "opt_state": _cpu(opt_state),
        "epoch": int(epoch),
        "rng": _cpu(rng_states),
        "best_score": best,
        "patience_counter": int(patience_counter),
        "config_fp": config_fp,
    }, path)


def load_train_state(path: str | Path) -> dict:
    """A `save_train_state` snapshot, tensors on the CPU (`best_score` as
    a float32 array or None)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if state["best_score"] is not None:
        state["best_score"] = np.asarray(state["best_score"], np.float32)
    return state

"""Training batch samplers (counterpart of `bsarec_tpu/preprec/sampler.py`).

The per-user dataset lives on the device; a step's users come from a
numpy generator (the same draws as the JAX package for the same seed),
its sequences and targets are gathers, and its per-position negatives
are drawn on the device from a torch generator. The other samplers of
the JAX module (cloze masks, NewB4Rec candidates, BPRMF permutations,
CL4SRec augmentations) serve the models of ROADMAP A5b.
"""

from __future__ import annotations

import numpy as np
import torch


def draw_user_batches(rng: np.random.Generator, eligible: np.ndarray, steps: int,
                      batch: int) -> np.ndarray:
    """[steps, batch] 1-based user ids, uniform with replacement."""
    return eligible[rng.integers(0, eligible.size, size=(steps, batch))]


def positional_negatives(generator: torch.Generator, exclusion_rows: torch.Tensor,
                         pos: torch.Tensor, itemnum: int, rounds: int = 6) -> torch.Tensor:
    """Per-position negatives in [1, itemnum] avoiding the user's train
    items (`exclusion_rows` [B, L+1]); positions with pos == 0 get 0.

    A fixed number of rounds of redraw-on-collision, as in the JAX
    package: every colliding candidate is redrawn `rounds` times at most,
    so a collision may survive the last round."""
    def draw():
        return torch.randint(1, itemnum + 1, pos.shape, generator=generator,
                             device=pos.device, dtype=pos.dtype)

    cand = draw()
    for _ in range(rounds):
        collides = (exclusion_rows[:, None, :] == cand[:, :, None]).any(-1)
        cand = torch.where(collides, draw(), cand)
    return torch.where(pos != 0, cand, torch.zeros_like(cand))

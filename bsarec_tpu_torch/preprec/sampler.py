"""Training batch samplers (counterpart of `bsarec_tpu/preprec/sampler.py`).

The per-user dataset lives on the device; a step's users come from a
numpy generator (the same draws as the JAX package for the same seed),
its sequences and targets are gathers, and its per-position negatives,
cloze masks, NewB4Rec candidates and BPRMF permutations are drawn on the
device from a torch generator, by the JAX package's laws (not its
threefry draws). CL4SRec's augmented views are made on the host with
numpy, as there: the same views for the same generator state.
"""

from __future__ import annotations

import math

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


def _randint(generator: torch.Generator, shape, itemnum: int, like: torch.Tensor) -> torch.Tensor:
    return torch.randint(1, itemnum + 1, tuple(shape), generator=generator, device=like.device,
                         dtype=like.dtype)


def cloze_mask(generator: torch.Generator, tokens: torch.Tensor, itemnum: int,
               mask_prob: float):
    """BERT-style 80/10/10 masking with token 0 as the mask -> (masked,
    labels). One uniform a position selects it (u < mask_prob; padding is
    never selected) and, scaled by 1/mask_prob, splits it: below 0.8 the
    mask, below 0.9 a uniform item, else the token kept. Labels carry the
    original item at selected positions and 0 elsewhere; at mask_prob 0
    nothing is selected."""
    prob = torch.rand(tokens.shape, generator=generator, device=tokens.device)
    selected = (prob < mask_prob) & (tokens > 0)
    sub = prob / max(mask_prob, 1e-9)
    rand_items = _randint(generator, tokens.shape, itemnum, tokens)
    replacement = torch.where(sub < 0.8, torch.zeros_like(tokens),
                              torch.where(sub < 0.9, rand_items, tokens))
    masked = torch.where(selected, replacement, tokens)
    labels = torch.where(selected, tokens, torch.zeros_like(tokens))
    return masked, labels


def newb4rec_candidates(generator: torch.Generator, masked: torch.Tensor, itemnum: int,
                        compare: int) -> torch.Tensor:
    """[B, T, compare + 1] sampled-softmax candidates: `compare` uniform
    items, then the gold column, which is the MASKED INPUT token (the
    mask 0, a random item or the true item, by the cloze rule), not the
    label: the reference's code appends its input sequence there."""
    rand_c = _randint(generator, masked.shape + (compare,), itemnum, masked)
    return torch.cat([rand_c, masked[..., None]], dim=-1)


def permute_user_items(generator: torch.Generator, rows: torch.Tensor) -> torch.Tensor:
    """Each row's nonzero items in a uniformly random order, right-padded
    with 0 (the BPRMF sampler): a stable argsort of uniforms, +inf on the
    padding."""
    keys = torch.rand(rows.shape, generator=generator, device=rows.device)
    keys = keys.masked_fill(rows == 0, float("inf"))
    return torch.gather(rows, -1, torch.sort(keys, dim=-1, stable=True).indices)


# ---- CL4SRec augmentations (host numpy, the JAX package's code) -------------

def _crop_row(rng, row, length, maxlen, eta=0.6):
    num_left = int(math.floor(length * eta))
    if length - num_left <= 1:
        return row
    crop_begin = rng.integers(1, length - num_left + 1)
    out = np.zeros_like(row)
    out[maxlen - num_left:] = row[maxlen - num_left - crop_begin: maxlen - crop_begin]
    return out


def _mask_row(rng, row, length, maxlen, gamma=0.3):
    num_mask = int(math.floor(length * gamma))
    if num_mask == 0:
        return row
    idx = rng.integers(1, length + 1, size=num_mask)
    out = row.copy()
    out[maxlen - idx] = 0
    return out


def _reorder_row(rng, row, length, maxlen, beta=0.6):
    num_reorder = int(math.floor(length * beta))
    if length - num_reorder <= 1:
        return row
    begin = rng.integers(1, length - num_reorder)
    out = row.copy()
    idx = np.arange(maxlen - begin - num_reorder, maxlen - begin)
    rng.shuffle(idx)
    out[idx] = row[maxlen - begin - num_reorder: maxlen - begin]
    return out


def augment_batch(rng: np.random.Generator, seqs: np.ndarray, lens: np.ndarray):
    """Two independently augmented views of each row (crop, mask or
    reorder: two distinct operations a row, drawn from `rng`)."""
    maxlen = seqs.shape[1]
    ops = [_crop_row, _mask_row, _reorder_row]
    aug1 = seqs.copy()
    aug2 = seqs.copy()
    for i in range(seqs.shape[0]):
        length = int(lens[i])
        if length <= 1:
            continue
        a, b = rng.choice(3, size=2, replace=False)
        aug1[i] = ops[a](rng, seqs[i], length, maxlen)
        aug2[i] = ops[b](rng, seqs[i], length, maxlen)
    return aug1, aug2

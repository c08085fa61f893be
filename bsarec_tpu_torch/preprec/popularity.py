"""Time-indexed popularity encodings (counterpart of `bsarec_tpu/preprec/popularity.py`).

Items carry no learned id embedding: each (item, time-bucket) pair maps
to a fixed feature vector of popularity percentiles, a window of
`input_units / base_dim` coarse ("month") buckets × `base_dim`
soft-one-hot percentile dims, plus a fine ("week") window.

The table is a device tensor [T + nwin - 1, items + 1, base_dim]: item
major, so one candidate's `base_dim` features in one period are
contiguous; front-padded with nwin - 1 zero periods, item 0 the padding
column. (The JAX package stores [T + nwin - 1, base_dim, items + 1]; the
gather computes the same values.) A lookup is one joint (period, item)
gather whose result is [..., nwin, base_dim]: nothing of the catalog's
size is built per candidate (at 1M items the JAX package's first
period-then-item form would have built 12.3 GB).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class PopularityTable:
    """One popularity table (coarse or fine)."""

    table: torch.Tensor  # [T + nwin - 1, items + 1, base_dim] float32
    base_dim: int
    nwin: int  # windows considered = input_units // base_dim

    @property
    def input_units(self) -> int:
        return self.base_dim * self.nwin

    @classmethod
    def from_flat(cls, flat: np.ndarray, base_dim: int, input_units: int,
                  device="cpu") -> "PopularityTable":
        """flat: [(T*base_dim), items] as written by preprocessing (the
        wtembed / week_embed2 artifacts)."""
        if base_dim == 0 or input_units == 0:
            return cls(torch.zeros((1, flat.shape[-1] + 1, 1), device=device), 1, 1)
        t = flat.shape[0] // base_dim
        nwin = input_units // base_dim
        cube = flat.reshape(t, base_dim, flat.shape[1]).astype(np.float32).swapaxes(1, 2)
        table = torch.zeros((nwin - 1 + t, flat.shape[1] + 1, base_dim), device=device)
        table[nwin - 1:, 1:] = torch.from_numpy(np.ascontiguousarray(cube)).to(device)
        return cls(table, base_dim, nwin)

    def gather(self, items: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
        """items, times: [...] int -> [..., input_units] features: the nwin
        periods ending at `times`, oldest first, base_dim inner (the
        reference's flat row indexing `time*base_dim + arange(input_units)`
        over its zero-padded table)."""
        t_max = self.table.shape[0] - 1
        window = (times[..., None] + torch.arange(self.nwin, device=times.device)).clamp_(0, t_max)
        feats = self.table[window, items[..., None]]  # [..., nwin, base_dim]
        return feats.reshape(feats.shape[:-2] + (self.nwin * self.base_dim,))


@dataclasses.dataclass
class PopularityEncoding:
    """Concatenated coarse+fine popularity features (month ++ week)."""

    month: PopularityTable
    week: PopularityTable

    @classmethod
    def load(cls, month_file: str, week_file: str, cfg, device="cpu") -> "PopularityEncoding":
        month = PopularityTable.from_flat(
            np.loadtxt(month_file, ndmin=2), cfg.base_dim1, cfg.input_units1, device)
        week = PopularityTable.from_flat(
            np.loadtxt(week_file, ndmin=2), cfg.base_dim2, cfg.input_units2, device)
        return cls(month, week)

    def __call__(self, items, time1, time2) -> torch.Tensor:
        return torch.cat([self.month.gather(items, time1), self.week.gather(items, time2)], dim=-1)


@dataclasses.dataclass
class EvalPopularity:
    """Recent-week-adjusted popularity for eval candidates: the week
    component is replaced by a per-(user, candidate-slot) table built
    offline from the most recent fine-period counts
    (`preprocess.week_adjustment`)."""

    month: PopularityTable
    week_eval: torch.Tensor  # [users, n_candidates, base_dim2]
    base_dim2: int

    @classmethod
    def load(cls, month_file: str, week_eval_file: str, cfg, device="cpu") -> "EvalPopularity":
        month = PopularityTable.from_flat(
            np.loadtxt(month_file, ndmin=2), cfg.base_dim1, cfg.input_units1, device)
        flat = np.loadtxt(week_eval_file, ndmin=2).astype(np.float32)
        users = flat.shape[0] // cfg.base_dim2
        cube = flat.reshape(users, cfg.base_dim2, flat.shape[1]).swapaxes(1, 2)
        return cls(month, torch.from_numpy(np.ascontiguousarray(cube)).to(device), cfg.base_dim2)

    def __call__(self, items, time1, users) -> torch.Tensor:
        """items/time1: [B, C]; users: [B] 1-based -> [B, C, feats]."""
        month = self.month.gather(items, time1)
        recent = self.week_eval[users - 1]  # [B, C, base_dim2]
        return torch.cat([month, recent[:, : items.shape[1], :]], dim=-1)


def sinusoid_table(n_position: int, dim: int) -> np.ndarray:
    """The fixed sinusoidal position table."""
    pos = np.arange(n_position)[:, None]
    j = np.arange(dim)[None, :]
    angle = pos / np.power(10000.0, 2 * (j // 2) / dim)
    table = np.zeros((n_position, dim))
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table.astype(np.float32)

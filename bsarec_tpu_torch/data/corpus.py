"""Interaction-corpus loading (counterpart of `bsarec_tpu/data/corpus.py`).

File format (reference: `src/dataset.py:171-197`): one line per user,
space-separated `user item1 item2 ...` with items time-ordered and ids
contiguous from 1 (0 = padding). `item_size = max_item + 1`,
`num_users = line count + 1` (`src/main.py:22-24`).

With the native library (`bsarec_tpu_torch/native.py`) the file is
parsed in C into the CSR form (`offsets`, `items`), as the JAX package
does; without it, in Python into per-user lists. A line with no token is
a user with no items in Python and no user in C, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from bsarec_tpu_torch import native


@dataclasses.dataclass
class Corpus:
    """Per-user, time-ordered item sequences, as lists (`user_seq`) or in
    CSR form (`offsets` [U+1], `items` [total], int32); each form is made
    from the other when first asked for."""

    user_seq: list[list[int]] | None
    max_item: int
    offsets: np.ndarray | None = None
    items: np.ndarray | None = None

    @property
    def num_users(self) -> int:
        if self.user_seq is not None:
            return len(self.user_seq)
        return self.offsets.shape[0] - 1

    @property
    def item_size(self) -> int:
        return self.max_item + 1

    @property
    def lists(self) -> list[list[int]]:
        if self.user_seq is None:
            self.user_seq = [self.items[a:b].tolist()
                             for a, b in zip(self.offsets[:-1], self.offsets[1:])]
        return self.user_seq

    @property
    def csr(self) -> tuple[np.ndarray, np.ndarray]:
        if self.offsets is None:
            lens = np.fromiter((len(s) for s in self.user_seq), np.int64, len(self.user_seq))
            self.offsets = np.zeros(len(self.user_seq) + 1, np.int32)
            np.cumsum(lens, out=self.offsets[1:])
            self.items = np.fromiter((i for s in self.user_seq for i in s), np.int32,
                                     int(self.offsets[-1]))
        return self.offsets, self.items


def load_corpus(data_file: str | Path) -> Corpus:
    parsed = native.parse_corpus(str(data_file))
    if parsed is not None:
        offsets, items, max_item = parsed
        return Corpus(user_seq=None, max_item=max_item, offsets=offsets, items=items)

    user_seq: list[list[int]] = []
    max_item = 0
    with open(data_file) as fh:
        for line in fh:
            parts = line.strip().split(" ")
            items = [int(tok) for tok in parts[1:]]
            if items:
                max_item = max(max_item, max(items))
            user_seq.append(items)
    return Corpus(user_seq=user_seq, max_item=max_item)

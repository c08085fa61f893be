"""Interaction-corpus loading (counterpart of `bsarec_tpu/data/corpus.py`).

File format (reference: `src/dataset.py:171-197`): one line per user,
space-separated `user item1 item2 ...` with items time-ordered and ids
contiguous from 1 (0 = padding). `item_size = max_item + 1`,
`num_users = line count + 1` (`src/main.py:22-24`).

Only the pure-Python parser is ported; the JAX package's ctypes path to
`native/seqrec.cpp` (and the CSR form it returns) is not.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path


@dataclasses.dataclass
class Corpus:
    """Per-user, time-ordered item sequences."""

    user_seq: list[list[int]]
    max_item: int

    @property
    def num_users(self) -> int:
        return len(self.user_seq)

    @property
    def item_size(self) -> int:
        return self.max_item + 1


def load_corpus(data_file: str | Path) -> Corpus:
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

"""Host-side splits (counterpart of `bsarec_tpu/data/pipeline.py`).

Every split is materialized once as fixed-shape int32 numpy arrays:

- train:  [N, L] inputs, [N] answers, [N] user ids — one row per
  history prefix (semantics of `src/dataset.py:18-23, 61-117`);
- valid/test: [U, L] inputs, [U] answers, plus 0-padded per-user
  seen-item lists (`src/dataset.py:126-168`) for eval masking.

The contrastive same-target view of DuoRec and FEARec
(`sample_same_target`, `src/dataset.py:41-56,83-106`) is resampled on the
host each epoch from a grouped-by-answer index.

Where the native library loads (`bsarec_tpu_torch/native.py`), the
splits and the same-target picks come from `native/seqrec.cpp`, as in
the JAX package; the numpy code here is the path without it and the
reference the C routines are held to (the splits bit for bit).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from bsarec_tpu_torch import native
from bsarec_tpu_torch.data.corpus import Corpus


@dataclasses.dataclass
class EvalSplit:
    input_ids: np.ndarray  # [U, L] int32
    answers: np.ndarray  # [U] int32
    seen_items: np.ndarray  # [U, S] int32, 0-padded

    @property
    def num_users(self) -> int:
        return self.input_ids.shape[0]


@dataclasses.dataclass
class TrainSplit:
    input_ids: np.ndarray  # [N, L] int32
    answers: np.ndarray  # [N] int32
    user_ids: np.ndarray  # [N] int32

    @property
    def num_samples(self) -> int:
        return self.input_ids.shape[0]


def _left_pad(seq: list[int], max_len: int) -> list[int]:
    seq = seq[-max_len:]
    return [0] * (max_len - len(seq)) + seq


class SeqRecData:
    """All splits of one corpus, materialized as numpy arrays."""

    def __init__(self, corpus: Corpus, max_len: int):
        self.corpus = corpus
        self.max_len = max_len
        self.item_size = corpus.item_size
        if native.lib() is not None:
            offsets, items = corpus.csr
            self.train = TrainSplit(*native.prefix_expand(offsets, items, max_len))
            lens = (offsets[1:] - offsets[:-1]).astype(np.int64)
            for mode, drop in (("valid", 2), ("test", 1)):
                seen_width = max(int((lens - drop).max(initial=1)), 1)
                setattr(self, mode, EvalSplit(
                    *native.eval_split(offsets, items, max_len, drop, seen_width)))
        else:
            lists = corpus.lists
            self.train = self._build_train(lists, max_len)
            self.valid = self._build_eval(lists, max_len, mode="valid")
            self.test = self._build_eval(lists, max_len, mode="test")
        self._same_target_groups = None

    @staticmethod
    def _build_train(user_seq: list[list[int]], max_len: int) -> TrainSplit:
        # prefix expansion: the user's training items are seq[-(L+2):-2];
        # one sample per prefix, answer = last prefix item, input = the rest
        total = sum(len(s[-(max_len + 2) : -2]) for s in user_seq)
        inputs = np.zeros((total, max_len), dtype=np.int32)
        answers = np.zeros((total,), dtype=np.int32)
        users = np.zeros((total,), dtype=np.int32)
        row = 0
        for user, seq in enumerate(user_seq):
            items = seq[-(max_len + 2) : -2]
            for i in range(len(items)):
                if i > 0:
                    inputs[row, max_len - i :] = items[:i]
                answers[row] = items[i]
                users[row] = user
                row += 1
        return TrainSplit(inputs, answers, users)

    @staticmethod
    def _build_eval(user_seq: list[list[int]], max_len: int, mode: str) -> EvalSplit:
        drop = 2 if mode == "valid" else 1
        num_users = len(user_seq)
        inputs = np.zeros((num_users, max_len), dtype=np.int32)
        answers = np.zeros((num_users,), dtype=np.int32)
        seen_len = max((len(s) - drop for s in user_seq), default=0)
        seen = np.zeros((num_users, max(seen_len, 1)), dtype=np.int32)
        for user, seq in enumerate(user_seq):
            if len(seq) < drop + 1:
                continue  # degenerate rows keep zeros (masked out downstream)
            hist = seq[:-drop]
            inputs[user] = _left_pad(hist, max_len)
            answers[user] = seq[-drop]
            seen[user, : len(hist)] = hist
        return EvalSplit(inputs, answers, seen)

    # ---- contrastive same-target view (DuoRec / FEARec) ----------------
    def _build_same_target_groups(self):
        """Group the train rows by answer item, and flag the groups that
        hold at least two distinct input rows (reference `keep_random`,
        `src/dataset.py:86-96`). `row_class` numbers the distinct input
        rows, where JAX hashes each row's bytes: the two agree on which
        rows are equal, which is all the sampler reads. The flags come from
        each group's least and largest class, where JAX loops over the
        catalog in Python (seconds at 1M items): the same groups."""
        answers = self.train.answers
        order = np.argsort(answers, kind="stable")
        sorted_ans = answers[order]
        items = np.arange(self.item_size)
        starts = np.searchsorted(sorted_ans, items)
        ends = np.searchsorted(sorted_ans, items, side="right")
        rows = np.ascontiguousarray(self.train.input_ids)
        as_bytes = rows.view(np.dtype((np.void, rows.shape[1] * rows.itemsize))).reshape(-1)
        row_class = np.unique(as_bytes, return_inverse=True)[1].reshape(-1).astype(np.int64)
        diversity = np.zeros(self.item_size, dtype=bool)
        nonempty = ends > starts
        if nonempty.any():
            grouped = row_class[order]
            firsts = starts[nonempty]
            diversity[nonempty] = (np.minimum.reduceat(grouped, firsts)
                                   != np.maximum.reduceat(grouped, firsts))
        self._same_target_groups = (order, starts, ends, diversity, row_class)

    def sample_same_target(self, rng: np.random.Generator) -> np.ndarray:
        """One epoch's same-target view, [N, L]: for each train row the
        input row of a random *other* train row with the same answer
        (itself when its group has no distinct member), as the JAX package
        draws it (`bsarec_tpu/data/pipeline.py:152-185`): a seed from
        `rng` for the native sampler, which re-picks (8 tries) a row equal
        to its own while the group offers another; without the library,
        the seed dropped and the numpy path, draw for draw. The native
        sampler reads the row classes where JAX reads its row hashes: the
        two agree on which rows are equal, so the picks are JAX's."""
        if self._same_target_groups is None:
            self._build_same_target_groups()
        order, starts, ends, diversity, row_class = self._same_target_groups
        answers = self.train.answers
        n = answers.shape[0]
        group_start = starts[answers]
        group_size = np.maximum(ends[answers] - group_start, 1)
        seed = int(rng.integers(0, 2**63 - 1))
        pick = native.same_target_pick(order, group_start, group_size, diversity[answers],
                                       row_class, seed)
        if pick is not None:
            return self.train.input_ids[pick].copy()
        pick = order[group_start + (rng.integers(0, 1 << 62, size=n) % group_size)]
        # re-pick rows that landed on an identical sequence while their
        # group offers another one (8 rounds, as JAX)
        for _ in range(8):
            bad = (row_class[pick] == row_class) & diversity[answers]
            if not bad.any():
                break
            idx = np.nonzero(bad)[0]
            pick[idx] = order[group_start[idx]
                              + (rng.integers(0, 1 << 62, size=idx.size) % group_size[idx])]
        # the picked row's input is the reference's sem_aug[:-1]
        return self.train.input_ids[pick].copy()

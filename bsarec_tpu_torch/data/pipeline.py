"""Host-side splits (counterpart of `bsarec_tpu/data/pipeline.py`).

Every split is materialized once as fixed-shape int32 numpy arrays:

- train:  [N, L] inputs, [N] answers, [N] user ids — one row per
  history prefix (semantics of `src/dataset.py:18-23, 61-117`);
- valid/test: [U, L] inputs, [U] answers, plus 0-padded per-user
  seen-item lists (`src/dataset.py:126-168`) for eval masking.

The contrastive same-target view (`sample_same_target`, DuoRec/FEARec)
is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
        lists = corpus.user_seq
        self.train = self._build_train(lists, max_len)
        self.valid = self._build_eval(lists, max_len, mode="valid")
        self.test = self._build_eval(lists, max_len, mode="test")

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

"""Early stopping on the validation score (counterpart of
`bsarec_tpu/utils/early_stopping.py`; reference `src/utils.py:129-176`).

The caller passes the score vector `[NDCG@20]` (`src/main.py:57` keeps
only the last metric). "No improvement" means every component is
<= best + delta; an improvement resets the counter and calls `save_fn`,
which checkpoints the model.
"""

from __future__ import annotations

import numpy as np


class EarlyStopping:
    def __init__(self, save_fn, logger=None, patience: int = 10, delta: float = 0.0):
        self.save_fn = save_fn
        self.logger = logger
        self.patience = patience
        self.delta = delta
        self.counter = 0
        self.best_score = None
        self.early_stop = False

    def _no_improvement(self, score) -> bool:
        return bool(np.all(np.asarray(score) <= np.asarray(self.best_score) + self.delta))

    def __call__(self, score, payload) -> None:
        if self.best_score is None:
            self.best_score = score
            self.save_fn(payload)
        elif self._no_improvement(score):
            self.counter += 1
            if self.logger:
                self.logger.info(f"EarlyStopping counter: {self.counter} out of {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = score
            self.save_fn(payload)
            self.counter = 0

"""PREPRec CSV partition loaders (counterpart of `bsarec_tpu/preprec/data.py`).

`<ds>_intwtime.csv` rows are `user,item,t1,t2,timestamp` (0-based ids;
the loader shifts them to 1-based). Leave-one-out split per user: train =
items[-maxlen-3:-2] left-zero-padded to maxlen+1, valid = items[-2], test
= items[-1]; "sparse" datasets drop the valid split and train on
[-maxlen-2:-1]. The relative-time-rank index (`te`) is the 1-based
argsort of successive timestamp gaps.

The rows are parsed by the native library where it loads
(`bsarec_tpu_torch/native.py`, `native/seqrec.cpp:intwtime_*`), as in
the JAX package, else in Python, with the same result. The arrays are
the JAX loader's, numpy [U, ...] rows indexed by user-1.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np

from bsarec_tpu_torch import native


@dataclasses.dataclass
class PrepRecDataset:
    # train rows are length maxlen+1 (seq ++ next-target chain source)
    train_seq: np.ndarray  # [U, maxlen+1] int32
    train_t1: np.ndarray  # [U, maxlen+1] int32
    train_t2: np.ndarray  # [U, maxlen+1] int32
    train_te: np.ndarray  # [U, maxlen] int32 (zeros if no timestamps)
    valid_item: np.ndarray  # [U] int32 (0 when sparse)
    valid_t1: np.ndarray  # [U]
    valid_t2: np.ndarray  # [U]
    valid_te: np.ndarray  # [U, maxlen]
    test_item: np.ndarray  # [U]
    test_t1: np.ndarray  # [U]
    test_t2: np.ndarray  # [U]
    test_te: np.ndarray  # [U, maxlen]
    seq_lens: np.ndarray  # [U] true (train) history lengths
    usernum: int
    itemnum: int

    @property
    def eligible_users(self) -> np.ndarray:
        """1-based users with >1 train interactions (the sampler's rejection)."""
        counts = (self.train_seq > 0).sum(axis=1)
        return (np.nonzero(counts > 1)[0] + 1).astype(np.int32)


def _parse_rows(path: str):
    """The Python parser: the five int32 columns in file order, itemnum."""
    rows: list[tuple] = []
    itemnum = 0
    with open(path) as fh:
        for line in fh:
            parts = line.rstrip().split(",")
            u, i, t1, t2 = (int(parts[0]) + 1, int(parts[1]) + 1,
                            int(parts[2]), int(parts[3]))
            te = int(float(parts[4])) if len(parts) > 4 else 0
            itemnum = max(itemnum, i)
            rows.append((u, i, t1, t2, te))
    if not rows:
        raise ValueError(f"empty intwtime file: {path}")
    return (*np.asarray(rows, np.int32).reshape(-1, 5).T, itemnum)


def _group_rows(path: str):
    """-> ({user1: (items, t1s, t2s, tes) numpy slices in file order},
    usernum, itemnum)."""
    parsed = native.parse_intwtime(path)
    if parsed is not None:
        (u_col, i_col, t1_col, t2_col, te_col), usernum, itemnum = parsed
    else:
        u_col, i_col, t1_col, t2_col, te_col, itemnum = _parse_rows(path)
        usernum = int(u_col.max())

    # group by user, keeping file order within each user
    order = np.argsort(u_col, kind="stable")
    sorted_u = u_col[order]
    uniq, starts = np.unique(sorted_u, return_index=True)
    bounds = np.append(starts, len(sorted_u))
    users = {}
    for k, u in enumerate(uniq):
        idx = order[bounds[k]:bounds[k + 1]]
        users[int(u)] = (i_col[idx], t1_col[idx], t2_col[idx], te_col[idx])
    return users, usernum, int(itemnum)


def load_intwtime(path: str, maxlen: int, sparse: bool = False) -> PrepRecDataset:
    users, usernum, itemnum = _group_rows(path)

    def zeros(shape, dtype=np.int32):
        return np.zeros(shape, dtype)

    tr_s, tr_1, tr_2 = (zeros((usernum, maxlen + 1)) for _ in range(3))
    tr_e = zeros((usernum, maxlen))
    v_i, v_1, v_2 = (zeros(usernum) for _ in range(3))
    v_e = zeros((usernum, maxlen))
    te_i, te_1, te_2 = (zeros(usernum) for _ in range(3))
    te_e = zeros((usernum, maxlen))
    lens = zeros(usernum)

    for u, (items, t1s, t2s, tes) in users.items():
        r = u - 1
        uselen = min(maxlen + 2, len(tes))
        gaps = np.array(tes[-uselen + 1:]) - np.array(tes[-uselen:-1])

        if not sparse:
            tr = items[-maxlen - 3: -2]
            tr1 = t1s[-maxlen - 3: -2]
            tr2 = t2s[-maxlen - 3: -2]
            tre = list(np.argsort(gaps[:-2][-maxlen:]) + 1)
            v_i[r], v_1[r], v_2[r] = items[-2], t1s[-2], t2s[-2]
            vte = list(np.argsort(gaps[:-1][-maxlen:]) + 1)
            v_e[r, maxlen - len(vte):] = vte
        else:
            tr = items[-maxlen - 2: -1]
            tr1 = t1s[-maxlen - 2: -1]
            tr2 = t2s[-maxlen - 2: -1]
            tre = list(np.argsort(gaps[:-1][-maxlen:]) + 1)
        tr_s[r, maxlen + 1 - len(tr):] = tr
        tr_1[r, maxlen + 1 - len(tr1):] = tr1
        tr_2[r, maxlen + 1 - len(tr2):] = tr2
        tr_e[r, maxlen - len(tre):] = tre
        lens[r] = len(tr)

        te_i[r], te_1[r], te_2[r] = items[-1], t1s[-1], t2s[-1]
        tte = list(np.argsort(gaps[-maxlen:]) + 1)
        te_e[r, maxlen - len(tte):] = tte

    return PrepRecDataset(
        tr_s, tr_1, tr_2, tr_e, v_i, v_1, v_2, v_e, te_i, te_1, te_2, te_e,
        lens, usernum, itemnum,
    )


def load_userneg(path: str, usernum: int) -> np.ndarray:
    """Pickled {user(1-based): [n negs]} (written by `preprocess.eval_negatives`)
    -> [U, n] int32."""
    with open(path, "rb") as fh:
        negs = pickle.load(fh)
    out = np.zeros((usernum, len(next(iter(negs.values())))), np.int32)
    for u, lst in negs.items():
        out[u - 1] = lst
    return out

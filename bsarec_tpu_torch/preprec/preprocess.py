"""Offline PREPRec preprocessing (counterpart of `bsarec_tpu/preprec/preprocess.py`).

1. 5-core filter (iterative), contiguous 0-based user/item id maps.
2. Coarse ("month") and fine ("week") time buckets from timestamps.
3. Per bucket, exponentially-weighted (coarse) / plain (fine) item
   popularity over a sliding window of up to 32 buckets, converted to
   rank-percentiles, then soft-one-hot embedded (`pop_embed_vec`).
4. Artifacts in the reference's file formats: `<ds>_intwtime.csv`,
   `<ds>_int2.csv`, `<ds>_rawpop.txt`, `<ds>_wtembed.txt`,
   `<ds>_week_embed2.txt`, `<ds>_week_curr_raw.txt`,
   `<ds>_userneg.pickle`, `<ds>_week_wt_embed_adj.txt`.

Numpy and scipy only. Every artifact is byte-identical to the JAX
package's on the same raw interactions; `eval_negatives` groups the rows
by user once instead of scanning every row for every user, which keeps
its random draws (same candidate arrays, same order) and makes it linear
in the row count.
"""

from __future__ import annotations

import pickle
from datetime import datetime

import numpy as np
from scipy.stats import rankdata


def kcore_filter(users: np.ndarray, items: np.ndarray, k: int = 5):
    """Iterative k-core: keep interactions whose item AND user have >= k
    interactions, repeating until stable."""
    keep = np.ones(users.shape[0], bool)
    while True:
        u, i = users[keep], items[keep]
        item_counts = np.bincount(i, minlength=i.max() + 1 if i.size else 1)
        good_items = item_counts >= k
        keep_new = keep.copy()
        keep_new[keep] &= good_items[i]
        u2 = users[keep_new]
        user_counts = np.bincount(u2, minlength=u2.max() + 1 if u2.size else 1)
        good_users = user_counts >= k
        keep_final = keep_new.copy()
        keep_final[keep_new] &= good_users[users[keep_new]]
        if keep_final.sum() == keep.sum():
            keep = keep_final
            u3, i3 = users[keep], items[keep]
            if u3.size == 0:
                break
            if (np.bincount(i3)[np.bincount(i3) > 0].min() >= k
                    and np.bincount(u3)[np.bincount(u3) > 0].min() >= k):
                break
        keep = keep_final
    return keep


def contiguous_map(values: np.ndarray) -> np.ndarray:
    """sorted-unique -> 0..n-1, int64."""
    return np.unique(values, return_inverse=True)[1].reshape(-1).astype(np.int64)


def pop_embed_vec(percs: np.ndarray, num: int) -> np.ndarray:
    """Soft-one-hot percentile embedding: perc 0 -> all zeros; else linear
    interpolation between the two nearest of num+1 bins."""
    rev = 100 // num
    loc = np.minimum((percs // rev).astype(int), num)
    frac = (percs % rev) / rev
    out = np.zeros(percs.shape + (num + 1,), np.float32)
    idx = np.arange(percs.size)
    flat_loc = loc.reshape(-1)
    flat_frac = frac.reshape(-1)
    flat = out.reshape(-1, num + 1)
    exact = (flat_frac == 0)
    flat[idx[exact], flat_loc[exact]] = 1.0
    inexact = ~exact & (flat_loc < num)
    flat[idx[inexact], flat_loc[inexact]] = 1.0 - flat_frac[inexact]
    flat[idx[inexact], flat_loc[inexact] + 1] = flat_frac[inexact]
    zero = percs.reshape(-1) == 0
    flat[zero] = 0.0
    return out


def time_buckets(timestamps: np.ndarray, cutoff: float) -> np.ndarray:
    """year*1000 + ceil(dayofyear / cutoff) in local time, then contiguous-mapped."""
    ts = timestamps.astype("int64")
    if ts.max() > 10**12:  # milliseconds
        ts = ts // 1000
    buckets = np.empty(ts.shape[0], np.int64)
    for j, t in enumerate(ts):
        d = datetime.fromtimestamp(int(t))
        buckets[j] = d.year * 1000 + int(np.ceil(d.timetuple().tm_yday / cutoff))
    return contiguous_map(buckets)


def windowed_popularity(
    items: np.ndarray, buckets: np.ndarray, n_items: int,
    weight: float | None, window: int = 32,
):
    """Per-bucket item popularity percentiles over a trailing window.

    weight=None -> plain counts (fine table); otherwise exponentially
    weighted by bucket distance. Items with zero windowed count keep
    percentile 0. Returns (percs [T, V], counts [T, V]).
    """
    n_t = int(buckets.max()) + 1
    counts_per_bucket = np.zeros((n_t, n_items), np.float64)
    np.add.at(counts_per_bucket, (buckets, items), 1.0)

    percs = np.zeros((n_t, n_items), np.float64)
    win_counts = np.zeros((n_t, n_items), np.float64)
    for t in range(n_t):
        lo = max(0, t - window + 1)
        if weight is None:
            win = counts_per_bucket[lo: t + 1].sum(axis=0)
        else:
            w = weight ** (t - np.arange(lo, t + 1, dtype=np.float64))
            win = (counts_per_bucket[lo: t + 1] * w[:, None]).sum(axis=0)
        win_counts[t] = win
        active = win > 0
        if active.any():
            percs[t, active] = 100.0 * rankdata(win[active], "average") / active.sum()
    return percs, win_counts


def preprocess(
    raw_items, raw_users, raw_times, out_prefix: str,
    t1_cutoff: float = 366 / 12, t1_size: int = 10,
    t2_cutoff: float = 366 / 62, t2_size: int = 5,
    weight: float = 0.5, k_core: int = 5, seed: int = 0,
):
    """Full offline pipeline; writes reference-format artifacts.

    raw_*: 1-D arrays (item, user, unix timestamp). Duplicate
    (item, user) pairs are dropped keeping the first occurrence.
    """
    items = np.asarray(raw_items)
    users = np.asarray(raw_users)
    times = np.asarray(raw_times, np.int64)

    pair_keys = np.char.add(items.astype(str), np.char.add("|", users.astype(str)))
    _, first_idx = np.unique(pair_keys, return_index=True)
    first_idx.sort()
    items, users, times = items[first_idx], users[first_idx], times[first_idx]

    uid = contiguous_map(users)
    iid = contiguous_map(items)
    keep = kcore_filter(uid, iid, k=k_core)
    uid, iid, times = uid[keep], iid[keep], times[keep]
    uid = contiguous_map(uid)
    iid = contiguous_map(iid)
    n_items = int(iid.max()) + 1

    raw_counts = np.bincount(iid, minlength=n_items).astype(np.float64)
    np.savetxt(f"{out_prefix}_rawpop.txt", raw_counts[None, :])

    t1 = time_buckets(times, t1_cutoff)
    t2 = time_buckets(times, t2_cutoff)

    order = np.argsort(times, kind="stable")
    rows = np.stack([uid[order], iid[order], t1[order], t2[order], times[order]], axis=1)
    np.savetxt(f"{out_prefix}_intwtime.csv", rows, fmt="%d", delimiter=",")
    np.savetxt(f"{out_prefix}_int2.csv", rows[:, :4], fmt="%d", delimiter=",")

    # coarse (exp-weighted) table -> [T1*(t1_size+1), V]
    percs1, _ = windowed_popularity(iid, t1, n_items, weight)
    emb1 = pop_embed_vec(percs1, t1_size)  # [T1, V, t1_size+1]
    np.savetxt(f"{out_prefix}_wtembed.txt", emb1.swapaxes(1, 2).reshape(-1, n_items))

    # fine (plain-count) table -> [T2*(t2_size+1), V]
    percs2, counts2 = windowed_popularity(iid, t2, n_items, None)
    emb2 = pop_embed_vec(percs2, t2_size)
    np.savetxt(f"{out_prefix}_week_embed2.txt", emb2.swapaxes(1, 2).reshape(-1, n_items))
    np.savetxt(f"{out_prefix}_week_curr_raw.txt", counts2)

    return dict(n_users=int(uid.max()) + 1, n_items=n_items)


def _rows_by_user(users: np.ndarray):
    """(user, row indices in file order) for each distinct user, ascending."""
    order = np.argsort(users, kind="stable")
    uniq, starts = np.unique(users[order], return_index=True)
    bounds = np.append(starts, order.size)
    return [(u, order[bounds[k]:bounds[k + 1]]) for k, u in enumerate(uniq)]


def eval_negatives(intwtime_csv: str, out_pickle: str, n: int = 100, seed: int = 0):
    """Per-user uniform eval negatives excluding the user's items:
    {user(1-based): [n item ids 1-based]}. A user who owns so much of the
    catalog that fewer than n negatives exist draws with replacement."""
    rows = np.loadtxt(intwtime_csv, delimiter=",", dtype=np.int64, ndmin=2)
    users, items = rows[:, 0], rows[:, 1]
    itemnum = int(items.max()) + 1
    rng = np.random.default_rng(seed)
    negs = {}
    for u, idx in _rows_by_user(users):
        free = np.ones(itemnum + 1, bool)
        free[0] = False
        free[items[idx] + 1] = False
        valid = np.nonzero(free)[0].astype(np.int64)
        if valid.size == 0:
            valid = np.arange(1, itemnum + 1)
        negs[int(u) + 1] = list(rng.choice(valid, size=n, replace=valid.size < n))
    with open(out_pickle, "wb") as fh:
        pickle.dump(negs, fh, protocol=pickle.HIGHEST_PROTOCOL)
    return negs


def week_adjustment(intwtime_csv: str, userneg_pickle: str, week_raw_file: str, out_file: str,
                    t2_size: int = 5):
    """Recent-week popularity adjustment table for eval: for each user,
    re-rank the latest fine-period counts with the user's own
    pre-interaction counts added for the candidate items, then pop-embed
    the candidates' percentiles. Output rows: users*(t2_size+1), cols:
    1+n_negs (gt-first order)."""
    rows = np.loadtxt(intwtime_csv, delimiter=",", dtype=np.int64, ndmin=2)
    users, items, t6, times = rows[:, 0], rows[:, 1], rows[:, 3], rows[:, 4]
    with open(userneg_pickle, "rb") as fh:
        negs = pickle.load(fh)
    otmpw = np.loadtxt(week_raw_file, ndmin=2)
    out = []
    for u, idx in _rows_by_user(users):
        last_pos = idx[-1]
        lu_t6, lu_time, lu_item = t6[last_pos], times[last_pos], items[last_pos]
        cand = np.array(negs[int(u) + 1]) - 1
        cand = np.insert(cand, 0, lu_item)
        in_bucket = (t6 == lu_t6) & (times < lu_time)
        counts = np.bincount(items[in_bucket], minlength=otmpw.shape[1])
        urow = otmpw[int(lu_t6) - 1].copy()
        urow[cand] += counts[cand]
        percs = 100 * rankdata(urow, "average") / len(urow)
        out.append(pop_embed_vec(percs[cand], t2_size).T)
    np.savetxt(out_file, np.concatenate(out))

"""Offline corpus preparation for the BSARec-side datasets (counterpart of
`bsarec_tpu/data/preprocess.py`, whose output files it writes byte for
byte).

    python -m bsarec_tpu_torch.data.preprocess --dataset Beauty --raw_dir raw/ --out_dir data/

Behavioral contract (reference: `src/data/process/_transform.py`,
`_utils.py`):

- Source parsers emit (user, item, unix_time) triples:
  Amazon 5-core review JSON (rating filter), ML-1M `ratings.dat`
  (`::`-separated), Yelp review JSON restricted to a date window,
  LastFM tag events with per-user item dedup (first occurrence wins).
- Interactions are sorted per user by timestamp, tracking the
  time-interval to the previous event (`_utils.get_interaction`).
- Iterative K-core: drop users with < user_core events outright;
  remove items with < item_core occurrences from sequences, merging
  the removed event's time interval into the successor
  (`_utils.filter_Kcore:103-121`); repeat to a fixed point.
- Contiguous 1-based id remap in first-appearance order
  (`_utils.id_map`), stats print, and `user item1 item2 ...` output
  lines — the exact input format of `data/corpus.py`.
"""

from __future__ import annotations

import datetime
import json
from collections import defaultdict
from pathlib import Path


# ---- source parsers ---------------------------------------------------------

def parse_amazon(path: str, rating_score: float = 0.0):
    """Amazon 5-core review dump: one JSON object per line."""
    out = []
    with open(path) as fh:
        for line in fh:
            row = json.loads(line.strip())
            if float(row["overall"]) <= rating_score:
                continue
            out.append((row["reviewerID"], row["asin"], int(row["unixReviewTime"])))
    return out


def parse_ml1m(path: str):
    """MovieLens-1M ratings.dat: user::item::rating::timestamp."""
    out = []
    with open(path) as fh:
        for line in fh:
            user, item, _, ts = line.strip().split("::")
            out.append((user, item, int(ts)))
    return out


def parse_yelp(path: str, date_min: str = "2019-01-01 00:00:00",
               date_max: str = "2019-12-31 00:00:00", rating_score: float = 0.0):
    out = []
    with open(path) as fh:
        for line in fh:
            row = json.loads(line.strip())
            date = row["date"]
            if date < date_min or date > date_max or float(row["stars"]) <= rating_score:
                continue
            ts = datetime.datetime.strptime(date, "%Y-%m-%d %H:%M:%S")
            out.append((row["user_id"], row["business_id"], int(ts.timestamp())))
    return out


def parse_lastfm(path: str):
    """hetrec user_taggedartists-timestamps.dat (tab-separated, header)."""
    out = []
    with open(path) as fh:
        for line in fh.readlines()[1:]:
            user, item, _, ts = line.strip().split("\t")
            out.append((user, item, int(ts)))
    return out


PARSERS = {
    "Beauty": parse_amazon,
    "Toys_and_Games": parse_amazon,
    "Sports_and_Outdoors": parse_amazon,
    "ML-1M": parse_ml1m,
    "Yelp": parse_yelp,
    "LastFM": parse_lastfm,
}


# ---- interaction building ---------------------------------------------------

def build_interactions(triples, dedup_items: bool = False):
    """(user, item, time) -> ({user: [items time-sorted]},
    {user: [time gaps]}). dedup_items keeps a user's first occurrence
    of each item (LastFM mode). NOTE: the reference drops each user's
    very first event in LastFM mode (`_utils.py:30-37` initializes an
    empty list before appending); we keep it — documented divergence.
    """
    per_user: dict = defaultdict(list)
    seen: dict = defaultdict(set)
    for user, item, ts in triples:
        if dedup_items:
            if item in seen[user]:
                continue
            seen[user].add(item)
        per_user[user].append((item, int(ts)))

    user_items, gaps = {}, {}
    for user, events in per_user.items():
        events.sort(key=lambda x: x[1])
        user_items[user] = [e[0] for e in events]
        gaps[user] = [
            0 if i == 0 else events[i][1] - events[i - 1][1]
            for i in range(len(events))
        ]
    return user_items, gaps


def check_kcore(user_items, user_core: int, item_core: int):
    user_count, item_count = defaultdict(int), defaultdict(int)
    for user, items in user_items.items():
        for item in items:
            user_count[user] += 1
            item_count[item] += 1
    ok = all(n >= user_core for n in user_count.values()) and all(
        n >= item_core for n in item_count.values()
    )
    return user_count, item_count, ok


def filter_kcore(user_items, gaps, user_core: int = 5, item_core: int = 5):
    """Iterative K-core with time-interval merging (semantics of
    `_utils.filter_Kcore`)."""
    user_count, item_count, ok = check_kcore(user_items, user_core, item_core)
    while not ok:
        for user in list(user_items):
            if user_count[user] < user_core:
                user_items.pop(user)
                gaps.pop(user)
                continue
            items, g = user_items[user], gaps[user]
            j = 0
            while j < len(items):
                if item_count[items[j]] < item_core:
                    items.pop(j)
                    if j + 1 < len(g):
                        g[j + 1] += g[j]
                    g.pop(j)
                else:
                    j += 1
            if g:
                g[0] = 0
        user_count, item_count, ok = check_kcore(user_items, user_core, item_core)
    return user_items, gaps


def id_map(user_items):
    """Contiguous 1-based ids in first-appearance order (`_utils.id_map`)."""
    user2id, item2id = {}, {}
    mapped = {}
    for user, items in user_items.items():
        uid = user2id.setdefault(user, len(user2id) + 1)
        mapped[uid] = [item2id.setdefault(it, len(item2id) + 1) for it in items]
    return mapped, len(user2id), len(item2id), {"user2id": user2id, "item2id": item2id}


def corpus_stats(user_items) -> dict:
    lens = [len(v) for v in user_items.values()]
    items = {i for v in user_items.values() for i in v}
    total = sum(lens)
    n_users, n_items = len(user_items), len(items)
    return {
        "users": n_users,
        "items": n_items,
        "interactions": total,
        "avg_seq_len": total / max(n_users, 1),
        "sparsity": (1 - total / max(n_users * n_items, 1)) * 100,
    }


def write_corpus(user_items, path: str | Path) -> None:
    """`user item1 item2 ...` lines (the `data/<name>.txt` format)."""
    with open(path, "w") as out:
        for user, items in user_items.items():
            out.write(f"{user} " + " ".join(str(i) for i in items) + "\n")


def process_dataset(data_name: str, raw_path: str, out_path: str,
                    user_core: int = 5, item_core: int = 5) -> dict:
    """Full pipeline for one dataset: parse -> interactions -> K-core ->
    id map -> write. Returns the stats dict."""
    triples = PARSERS[data_name](raw_path)
    user_items, gaps = build_interactions(triples, dedup_items=data_name == "LastFM")
    user_items, gaps = filter_kcore(user_items, gaps, user_core, item_core)
    mapped, n_users, n_items, _ = id_map(user_items)
    write_corpus(mapped, out_path)
    return corpus_stats(mapped)


# ---- CLI orchestration (reference: `src/data/process/process.sh`) -----------

# raw-source URLs the reference's `_download.sh` fetches; this environment
# has no network, so acquisition stays manual — drop the files into
# --raw_dir with these names:
RAW_SOURCES = {
    "Beauty": ("reviews_Beauty_5.json",
               "https://snap.stanford.edu/data/amazon/productGraph/categoryFiles/"),
    "Toys_and_Games": ("reviews_Toys_and_Games_5.json", "(same host)"),
    "Sports_and_Outdoors": ("reviews_Sports_and_Outdoors_5.json", "(same host)"),
    "ML-1M": ("ratings.dat", "https://files.grouplens.org/datasets/movielens/ml-1m.zip"),
    "Yelp": ("yelp_academic_dataset_review.json", "https://www.yelp.com/dataset"),
    "LastFM": ("user_taggedartists-timestamps.dat",
               "https://files.grouplens.org/datasets/hetrec2011/hetrec2011-lastfm-2k.zip"),
}


def main(argv=None):
    """`python -m bsarec_tpu_torch.data.preprocess --dataset Beauty --raw_dir raw/
    --out_dir data/` — parse -> K-core -> id map -> corpus .txt, the
    offline half of the reference's `process.sh` (`--dataset all` loops
    every known dataset whose raw file is present)."""
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--dataset", required=True,
                   help="|".join(PARSERS) + " | all")
    p.add_argument("--raw_dir", default="raw")
    p.add_argument("--out_dir", default="data")
    p.add_argument("--user_core", type=int, default=5)
    p.add_argument("--item_core", type=int, default=5)
    args = p.parse_args(argv)

    names = list(PARSERS) if args.dataset == "all" else [args.dataset]
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    results = {}
    for name in names:
        raw_name, source = RAW_SOURCES[name]
        raw = Path(args.raw_dir) / raw_name
        if not raw.exists():
            print(f"{name}: missing raw file {raw} (download from {source})")
            continue
        stats = process_dataset(
            name, str(raw), str(out_dir / f"{name}.txt"),
            args.user_core, args.item_core,
        )
        print(f"{name}: {stats}")
        results[name] = stats
    return results


if __name__ == "__main__":
    main()

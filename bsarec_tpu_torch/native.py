"""ctypes binding of the native host-side data runtime (counterpart of
`bsarec_tpu/native/__init__.py`).

`native/seqrec.cpp` at the root of the checkout depends on no framework,
so both packages load it; each builds its own library. `lib()` compiles
it on first use with

    g++ -O3 -shared -fPIC

into `build/native/seqrec-<hash>.so` (the hash covers the source), under
a temporary name first and then `os.replace`d, so that processes
building at once never load a half-written file. It returns None only
when `BSAREC_NO_NATIVE` is set in the environment (read on every call)
or when no library is built and `g++` is absent; callers then run their
numpy paths, which stay as the reference every routine is held to. A
failed build or load raises: unlike the JAX package, which takes any
failure there for "no library", a broken build does not pass silently as
slower host preparation.

Every wrapper returns None when `lib()` does, and the parsers also where
the C parser declines a file (a malformed token, an empty PREPRec file):
the numpy paths then raise their usual errors.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "seqrec.cpp"
BUILD_DIR = SOURCE.parents[1] / "build" / "native"
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]
WORD_BITS = 32

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _configure(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.corpus_count.argtypes = [ctypes.c_char_p, i64p, i64p]
    lib.corpus_count.restype = ctypes.c_int
    lib.corpus_fill.argtypes = [ctypes.c_char_p, i32p, i32p, i32p]
    lib.corpus_fill.restype = ctypes.c_int
    lib.prefix_rows.argtypes = [i32p, ctypes.c_int64, ctypes.c_int32]
    lib.prefix_rows.restype = ctypes.c_int64
    lib.prefix_expand.argtypes = [i32p, i32p, ctypes.c_int64, ctypes.c_int32, i32p, i32p, i32p]
    lib.prefix_expand.restype = None
    lib.eval_split.argtypes = [
        i32p, i32p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, i32p, i32p, i32p,
    ]
    lib.eval_split.restype = None
    lib.seen_bitmask.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, u32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
    ]
    lib.seen_bitmask.restype = None
    lib.same_target_pick.argtypes = [
        i32p, i32p, i32p, u8p, i64p, ctypes.c_int64, ctypes.c_uint64, i32p,
    ]
    lib.same_target_pick.restype = None
    lib.intwtime_count.argtypes = [ctypes.c_char_p, i64p, i64p, i64p]
    lib.intwtime_count.restype = ctypes.c_int
    lib.intwtime_fill.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  i32p, i32p, i32p, i32p, i32p]
    lib.intwtime_fill.restype = ctypes.c_int
    return lib


def library_path(source: Path, build_dir: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return build_dir / f"{source.stem}-{digest}.so"


def build(source: Path, build_dir: Path) -> Path:
    """Compile `source` into `build_dir` unless its library is there;
    returns the library's path. Raises with g++'s output when the compile
    fails."""
    out = library_path(source, build_dir)
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {source}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL | None:
    """The loaded library, built first if needed; None when switched off
    (`BSAREC_NO_NATIVE`) or when it is not built and g++ is absent."""
    global _lib
    if os.environ.get("BSAREC_NO_NATIVE"):
        return None
    with _lock:
        if _lib is None:
            if not library_path(SOURCE, BUILD_DIR).exists() and shutil.which("g++") is None:
                return None
            _lib = _configure(ctypes.CDLL(str(build(SOURCE, BUILD_DIR))))
        return _lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _i32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def _csr(offsets: np.ndarray, items: np.ndarray):
    offsets, items = _i32(offsets), _i32(items)
    if (offsets.ndim != 1 or offsets.shape[0] < 1 or offsets[0] != 0
            or (np.diff(offsets) < 0).any() or offsets[-1] > items.shape[0]):
        raise ValueError("offsets must rise from 0 to at most len(items)")
    return offsets, items


def parse_corpus(path: str):
    """`user item item ...` lines -> (offsets [U+1] int32, items [total]
    int32, max_item), or None. A line with no token is no user."""
    L = lib()
    if L is None:
        return None
    n_users, n_items = ctypes.c_int64(), ctypes.c_int64()
    if L.corpus_count(str(path).encode(), ctypes.byref(n_users), ctypes.byref(n_items)):
        return None
    offsets = np.zeros(n_users.value + 1, np.int32)
    items = np.zeros(max(n_items.value, 1), np.int32)
    max_item = ctypes.c_int32()
    if L.corpus_fill(str(path).encode(), _ptr(offsets, ctypes.c_int32),
                     _ptr(items, ctypes.c_int32), ctypes.byref(max_item)):
        return None
    return offsets, items[: n_items.value], int(max_item.value)


def parse_intwtime(path: str):
    """PREPRec `<ds>_intwtime.csv` -> ((users1, items1, t1, t2, te) [n]
    int32 columns in file order, usernum, itemnum), or None: ids shifted
    to 1-based, the 5th field truncated toward zero, as the Python loader
    (`preprec/data.py`) reads them."""
    L = lib()
    if L is None:
        return None
    n_rows, max_u, max_i = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    if L.intwtime_count(str(path).encode(), ctypes.byref(n_rows),
                        ctypes.byref(max_u), ctypes.byref(max_i)):
        return None
    if n_rows.value == 0:
        return None
    cols = [np.zeros(n_rows.value, np.int32) for _ in range(5)]
    if L.intwtime_fill(str(path).encode(), n_rows.value,
                       *(_ptr(c, ctypes.c_int32) for c in cols)):
        return None  # rc 3 included: the file changed between the two passes
    return tuple(cols), int(max_u.value), int(max_i.value)


def prefix_expand(offsets: np.ndarray, items: np.ndarray, max_len: int):
    """The train split from a CSR corpus: ([N, L] inputs, [N] answers, [N]
    users), one row per prefix of each user's seq[-(L+2):-2]; or None."""
    L = lib()
    if L is None:
        return None
    offsets, items = _csr(offsets, items)
    n_users = offsets.shape[0] - 1
    total = L.prefix_rows(_ptr(offsets, ctypes.c_int32), n_users, max_len)
    inputs = np.zeros((total, max_len), np.int32)
    answers = np.zeros(total, np.int32)
    users = np.zeros(total, np.int32)
    L.prefix_expand(_ptr(offsets, ctypes.c_int32), _ptr(items, ctypes.c_int32), n_users,
                    max_len, _ptr(inputs, ctypes.c_int32), _ptr(answers, ctypes.c_int32),
                    _ptr(users, ctypes.c_int32))
    return inputs, answers, users


def eval_split(offsets: np.ndarray, items: np.ndarray, max_len: int, drop: int,
               seen_width: int):
    """An eval split from a CSR corpus: ([U, L] inputs, [U] answers,
    [U, seen_width] 0-padded seen lists) with seq[-drop] the answer; or
    None."""
    L = lib()
    if L is None:
        return None
    offsets, items = _csr(offsets, items)
    n_users = offsets.shape[0] - 1
    inputs = np.zeros((n_users, max_len), np.int32)
    answers = np.zeros(n_users, np.int32)
    seen = np.zeros((n_users, seen_width), np.int32)
    L.eval_split(_ptr(offsets, ctypes.c_int32), _ptr(items, ctypes.c_int32), n_users,
                 max_len, drop, seen_width, _ptr(inputs, ctypes.c_int32),
                 _ptr(answers, ctypes.c_int32), _ptr(seen, ctypes.c_int32))
    return inputs, answers, seen


def seen_bitmask(seen: np.ndarray, vocab: int, id_offset: int = 0, mask_item0: bool = True):
    """[B, S] 0-padded seen lists -> the port's linear [B, ceil(V/32)]
    int32 bitmask of the items [id_offset, id_offset + vocab) in local
    coordinates (item v at bit v & 31 of word v >> 5; ids <= 0 or outside
    the range dropped; local item 0's bit set where `mask_item0`), or
    None. The C routine's tile of 32 columns has one word a tile, which
    is this layout."""
    L = lib()
    if L is None:
        return None
    seen = _i32(seen)
    n_rows, n_cols = seen.shape
    out = np.zeros((n_rows, -(-vocab // WORD_BITS)), np.uint32)
    L.seen_bitmask(_ptr(seen, ctypes.c_int32), n_rows, n_cols, vocab, WORD_BITS,
                   _ptr(out, ctypes.c_uint32), out.shape[1], int(id_offset), int(mask_item0))
    return out.view(np.int32)


def same_target_pick(order, group_start, group_size, diverse, row_hash, seed: int):
    """[n] int32 picks: for row i a random member of its answer group
    (`order[group_start[i] : group_start[i] + group_size[i]]`), drawn again
    (up to 8 tries) while `diverse[i]` and the pick's `row_hash` equals
    row i's; splitmix64 streams keyed on (seed, row, try). None without
    the library."""
    L = lib()
    if L is None:
        return None
    order, group_start, group_size = _i32(order), _i32(group_start), _i32(group_size)
    diverse = np.ascontiguousarray(diverse, np.uint8)
    row_hash = np.ascontiguousarray(row_hash, np.int64)
    n = group_start.shape[0]
    ends = group_start.astype(np.int64) + np.maximum(group_size, 1)
    if (group_size.shape != (n,) or diverse.shape != (n,) or row_hash.shape[0] < n
            or (n and (group_start.min() < 0 or ends.max() > order.shape[0]))
            or (order.size and (order.min() < 0 or order.max() >= row_hash.shape[0]))):
        raise ValueError("same_target_pick: groups must lie in `order`, whose rows "
                         "must lie in `row_hash`")
    pick = np.zeros(n, np.int32)
    L.same_target_pick(_ptr(order, ctypes.c_int32), _ptr(group_start, ctypes.c_int32),
                       _ptr(group_size, ctypes.c_int32), _ptr(diverse, ctypes.c_uint8),
                       _ptr(row_hash, ctypes.c_int64), n, seed & (2**64 - 1),
                       _ptr(pick, ctypes.c_int32))
    return pick

"""The port's binding of `native/seqrec.cpp` (`bsarec_tpu_torch/native.py`)
against the JAX package's binding (`bsarec_tpu/native`) and the port's
numpy paths, entry by entry, on arrays and files made from a seed; its
build (a failed build or load raises, `BSAREC_NO_NATIVE` and a missing
g++ give the numpy paths, processes building at once all load).

The JAX binding builds `bsarec_tpu/native/_seqrec.so` in place and keeps
a failed load as None for the life of the process, so on a fresh tree a
worker that loads it while another worker's g++ is writing the file gets
None: `jax_native_lib` waits that build out and loads again."""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from bsarec_tpu import native as jax_native
from bsarec_tpu.data.corpus import Corpus as JaxCorpus
from bsarec_tpu.data.pipeline import SeqRecData as JaxSeqRecData
from bsarec_tpu_torch import native
from bsarec_tpu_torch.data import corpus as corpus_mod
from bsarec_tpu_torch.data.corpus import Corpus, load_corpus
from bsarec_tpu_torch.data.pipeline import SeqRecData
from bsarec_tpu_torch.ops import rank
from bsarec_tpu_torch.preprec import data as preprec_data

ROOT = Path(__file__).resolve().parents[1]
MAX_LEN = 6
MAX_ITEM = 44


# how long jax_native_lib waits for another process's build of the JAX
# binding's library: the binding gives its g++ 120 s
JAX_BUILD_WAIT_S = 150.0


def jax_native_lib(wait_s: float = JAX_BUILD_WAIT_S, poll_s: float = 0.5):
    """`bsarec_tpu.native.lib()`, loaded again while it gives None, for at
    most `wait_s` seconds: each retry clears the binding's cached failure
    (`_tried`, `_lib`), so that a load that met a library another process
    was still writing is tried once more after that write. None if every
    try failed."""
    deadline = time.monotonic() + wait_s
    while True:
        lib = jax_native.lib()
        if lib is not None or time.monotonic() >= deadline:
            return lib
        time.sleep(poll_s)
        jax_native._tried = False
        jax_native._lib = None


@pytest.fixture(scope="module")
def libs():
    assert native.lib() is not None and jax_native_lib() is not None
    return native.lib(), jax_native.lib()


def _keep_jax_binding_state(monkeypatch):
    """Restore the JAX binding's cached load after the test."""
    monkeypatch.setattr(jax_native, "_tried", jax_native._tried)
    monkeypatch.setattr(jax_native, "_lib", jax_native._lib)


def test_jax_binding_loads_again_after_a_failed_load(monkeypatch):
    """A binding whose first load fails (another worker's g++ still writing
    the library) and whose next one works: the helper clears the cached
    failure and returns the loaded library."""
    _keep_jax_binding_state(monkeypatch)
    real, calls = jax_native.lib, []

    def once_none():
        calls.append(jax_native._tried)
        return None if len(calls) == 1 else real()

    monkeypatch.setattr(jax_native, "lib", once_none)
    monkeypatch.setattr(jax_native, "_tried", True)  # as after the failed load
    got = jax_native_lib(wait_s=60.0, poll_s=0.0)
    assert got is not None and len(calls) == 2
    assert calls[1] is False  # the second try started with the failure cleared


def test_jax_binding_wait_is_bounded(monkeypatch):
    """A binding that never loads: the helper gives up after its wait and
    returns None (the fixture then fails, it does not skip)."""
    _keep_jax_binding_state(monkeypatch)
    calls = []
    monkeypatch.setattr(jax_native, "lib", lambda: calls.append(1))
    t0 = time.monotonic()
    assert jax_native_lib(wait_s=0.3, poll_s=0.05) is None
    assert 0.3 <= time.monotonic() - t0 < 30.0 and len(calls) >= 2


def seeded_seqs(n_users=60, n_items=40, seed=0):
    """Users of 0 to 14 items (the short ones have no train row and no
    eval answer) with repeats, so that groups hold equal rows; item 41 is
    only ever a first item, so its group holds three equal all-padding
    rows and nothing else. The largest id is MAX_ITEM."""
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(1, n_items, size=rng.integers(0, 15)).tolist() for _ in range(n_users)]
    return seqs + [[3, 4, 5, 6]] * 4 + [[9, 9]] * 2 + [[41, 42, 43, MAX_ITEM]] * 3


def write_corpus_file(path: Path, seqs) -> None:
    # a user with no items keeps its line (its id alone): both parsers count it
    path.write_text("".join(f"{u + 1} {' '.join(map(str, s))}".rstrip() + "\n"
                            for u, s in enumerate(seqs)))


def test_parse_corpus_matches_jax_binding_and_python(tmp_path, libs, monkeypatch):
    seqs = seeded_seqs()
    path = tmp_path / "toy.txt"
    write_corpus_file(path, seqs)
    offsets, items, max_item = native.parse_corpus(str(path))
    j_offsets, j_items, j_max = jax_native.parse_corpus(str(path))
    np.testing.assert_array_equal(offsets, j_offsets)
    np.testing.assert_array_equal(items, j_items)
    assert max_item == j_max == max(map(max, filter(None, seqs)))
    got = load_corpus(path)
    assert got.offsets is not None and got.lists == seqs
    monkeypatch.setattr(native, "lib", lambda: None)
    python = load_corpus(path)
    assert python.offsets is None and python.user_seq == seqs
    assert python.max_item == max_item
    np.testing.assert_array_equal(python.csr[0], offsets)
    np.testing.assert_array_equal(python.csr[1], items)
    # a malformed token: the C parser declines and Python raises its error
    bad = tmp_path / "bad.txt"
    bad.write_text("1 2 x\n")
    assert native.parse_corpus(str(bad)) is None
    with pytest.raises(ValueError):
        load_corpus(bad)


def _splits(data) -> dict:
    return {f"{name}.{field}": getattr(getattr(data, name), field)
            for name, fields in (("train", ("input_ids", "answers", "user_ids")),
                                 ("valid", ("input_ids", "answers", "seen_items")),
                                 ("test", ("input_ids", "answers", "seen_items")))
            for field in fields}


def test_prefix_expand_and_eval_split_match_jax_binding_and_numpy(libs, monkeypatch):
    seqs = seeded_seqs(seed=1)
    offsets, items = Corpus(user_seq=seqs, max_item=MAX_ITEM).csr
    for got, want in zip(native.prefix_expand(offsets, items, MAX_LEN),
                         jax_native.prefix_expand(offsets, items, MAX_LEN)):
        np.testing.assert_array_equal(got, want)
    for drop in (1, 2):
        for got, want in zip(native.eval_split(offsets, items, MAX_LEN, drop, 13),
                             jax_native.eval_split(offsets, items, MAX_LEN, drop, 13)):
            np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="offsets"):
        native.prefix_expand(offsets[::-1].copy(), items, MAX_LEN)
    fast = _splits(SeqRecData(Corpus(user_seq=seqs, max_item=MAX_ITEM), MAX_LEN))
    monkeypatch.setattr(native, "lib", lambda: None)
    numpy_path = _splits(SeqRecData(Corpus(user_seq=seqs, max_item=MAX_ITEM), MAX_LEN))
    for name, want in numpy_path.items():
        assert fast[name].dtype == want.dtype and fast[name].shape == want.shape, name
        np.testing.assert_array_equal(fast[name], want, err_msg=name)


@pytest.mark.parametrize("vocab", [1, 31, 32, 33, 100, 1000])
def test_seen_bitmask_matches_jax_binding_and_numpy(vocab, libs, monkeypatch):
    """At 32 columns a tile the C routine's layout is the port's linear one;
    ids out of [1, vocab), padding and repeats included."""
    rng = np.random.default_rng(vocab)
    seen = rng.integers(-3, vocab + 40, size=(9, 17)).astype(np.int32)
    seen[:, -4:] = 0
    seen[0] = 0
    seen[1, :5] = seen[1, 5]
    got = native.seen_bitmask(seen, vocab)
    assert got.dtype == np.int32 and got.shape == (9, rank.seen_words(vocab))
    np.testing.assert_array_equal(got, jax_native.seen_bitmask(seen, vocab, tile_cols=32))
    np.testing.assert_array_equal(rank.build_seen_bitmask(seen, vocab), got)
    monkeypatch.setattr(native, "lib", lambda: None)
    np.testing.assert_array_equal(rank.build_seen_bitmask(seen, vocab), got)


def _splitmix64(x: int) -> int:
    m = (1 << 64) - 1
    x = (x + 0x9E3779B97F4A7C15) & m
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & m
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & m
    return x ^ (x >> 31)


def _pick_reference(order, group_start, group_size, diverse, row_hash, seed):
    """`seqrec.cpp:same_target_pick` in Python, the contract it states."""
    picks = []
    for i in range(len(group_start)):
        start, size = int(group_start[i]), max(int(group_size[i]), 1)
        p = int(order[start + _splitmix64(seed ^ i) % size])
        attempt = 1
        while diverse[i] and attempt < 9 and row_hash[p] == row_hash[i]:
            p = int(order[start + _splitmix64(seed ^ i ^ (attempt << 48)) % size])
            attempt += 1
        picks.append(p)
    return np.asarray(picks, np.int32)


def test_same_target_pick_matches_jax_binding_and_its_contract(libs):
    """The port's sampler (row classes as the row hashes) picks what JAX's
    native sampler picks from one seed, three epochs; every pick is the
    C routine's, computed in Python, and lies in the row's answer group."""
    seqs = seeded_seqs(seed=2)
    data = SeqRecData(Corpus(user_seq=[list(s) for s in seqs], max_item=MAX_ITEM), MAX_LEN)
    jdata = JaxSeqRecData(JaxCorpus(user_seq=[list(s) for s in seqs], max_item=MAX_ITEM), MAX_LEN)
    rng, jrng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(3):
        np.testing.assert_array_equal(data.sample_same_target(rng),
                                      jdata.sample_same_target(jrng))
    assert rng.bit_generator.state == jrng.bit_generator.state

    order, starts, ends, diversity, row_class = data._same_target_groups
    answers = data.train.answers
    group_start = starts[answers]
    group_size = np.maximum(ends[answers] - group_start, 1)
    diverse = diversity[answers]
    assert diverse.any() and (~diverse & (group_size > 1)).any()
    seed = 0xDEADBEEF12345
    pick = native.same_target_pick(order, group_start, group_size, diverse, row_class, seed)
    np.testing.assert_array_equal(pick, jax_native.same_target_pick(
        order.astype(np.int32), group_start.astype(np.int32), group_size.astype(np.int32),
        diverse.astype(np.uint8), row_class, seed))
    np.testing.assert_array_equal(
        pick, _pick_reference(order, group_start, group_size, diverse, row_class, seed))
    np.testing.assert_array_equal(answers[pick], answers)
    with pytest.raises(ValueError, match="groups"):
        native.same_target_pick(order, group_start + len(order), group_size, diverse,
                                row_class, seed)


def test_parse_intwtime_matches_jax_binding_and_python(tmp_path, libs, monkeypatch):
    rng = np.random.default_rng(3)
    rows = []
    for u in rng.permutation(30):
        for _ in range(rng.integers(3, 9)):
            rows.append(f"{u},{rng.integers(0, 50)},{rng.integers(0, 35)},"
                        f"{rng.integers(0, 104)},{rng.integers(10**8, 10**9)}.{rng.integers(0, 99)}")
    path = tmp_path / "toy_intwtime.csv"
    path.write_text("\n".join(rows) + "\n")
    cols, usernum, itemnum = native.parse_intwtime(str(path))
    j_cols, j_usernum, j_itemnum = jax_native.parse_intwtime(str(path))
    for got, want in zip(cols, j_cols):
        np.testing.assert_array_equal(got, want)
    assert (usernum, itemnum) == (j_usernum, j_itemnum)
    *python_cols, python_itemnum = preprec_data._parse_rows(str(path))
    for got, want in zip(cols, python_cols):
        np.testing.assert_array_equal(got, want)
    assert itemnum == python_itemnum and usernum == int(python_cols[0].max())
    fast = preprec_data.load_intwtime(str(path), 5)
    monkeypatch.setattr(native, "lib", lambda: None)
    slow = preprec_data.load_intwtime(str(path), 5)
    for field in fast.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(fast, field), getattr(slow, field), err_msg=field)
    empty = tmp_path / "empty_intwtime.csv"
    empty.write_text("")
    with pytest.raises(ValueError, match="empty"):
        preprec_data.load_intwtime(str(empty), 5)


def test_failed_build_or_load_raises(tmp_path, monkeypatch):
    """Where the JAX binding takes any failure for "no library", the
    port's raises: a source that does not compile, a library that does
    not load."""
    broken = tmp_path / "broken.cpp"
    broken.write_text("extern \"C\" int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(broken, tmp_path / "out")
    assert not list((tmp_path / "out").glob("*"))  # no temporary file left
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "lib")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.lib()
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        load_corpus(tmp_path / "never_read.txt")
    fine = tmp_path / "fine.cpp"
    fine.write_text("extern \"C\" int f() { return 0; }\n")
    monkeypatch.setattr(native, "SOURCE", fine)
    native.library_path(fine, tmp_path / "lib").write_bytes(b"not a shared object")
    with pytest.raises(OSError):
        native.lib()


def test_switched_off_or_no_compiler_gives_the_numpy_paths(tmp_path, monkeypatch):
    seqs = seeded_seqs(seed=4)
    path = tmp_path / "toy.txt"
    write_corpus_file(path, seqs)
    monkeypatch.setenv("BSAREC_NO_NATIVE", "1")
    assert native.lib() is None
    assert load_corpus(path).offsets is None
    calls = []
    monkeypatch.setattr(SeqRecData, "_build_train",
                        staticmethod(lambda *a, _f=SeqRecData._build_train: calls.append(1) or _f(*a)))
    SeqRecData(Corpus(user_seq=seqs, max_item=MAX_ITEM), MAX_LEN)
    assert calls == [1]
    monkeypatch.delenv("BSAREC_NO_NATIVE")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert native.lib() is None
    assert corpus_mod.load_corpus(path).user_seq == seqs


def test_processes_building_at_once_all_load(tmp_path):
    """Four processes build one source into one directory together (as
    test workers do): each loads a whole library, one file is left."""
    code = ("import sys; from pathlib import Path; from bsarec_tpu_torch import native; "
            "native.BUILD_DIR = Path(sys.argv[1]); native._configure(native.ctypes.CDLL("
            "str(native.build(native.SOURCE, native.BUILD_DIR))))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT)
             for _ in range(4)]
    assert [p.wait(timeout=120) for p in procs] == [0] * 4
    assert [f.name for f in tmp_path.iterdir()] == [
        native.library_path(native.SOURCE, tmp_path).name]

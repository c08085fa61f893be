"""Port host data vs the JAX package: split arrays byte-identical, seen
bitmasks decoding to the same seen sets."""

import numpy as np
import pytest
import torch

from bsarec_tpu.data.corpus import Corpus as JaxCorpus
from bsarec_tpu.data.pipeline import SeqRecData as JaxSeqRecData
from bsarec_tpu.ops.pallas_rank import TILE_COLS
from bsarec_tpu.ops.pallas_rank import build_seen_bitmask as jax_build_seen_bitmask
from bsarec_tpu_torch.data.corpus import Corpus, load_corpus
from bsarec_tpu_torch.data.pipeline import SeqRecData
from bsarec_tpu_torch.ops import rank

TOY = [[1, 2, 3, 4, 5], [6, 7, 8, 9, 10, 4, 11], [3, 4], [2, 3, 4]]


def synthetic_seqs(n_users=300, n_items=500, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, n_items, size=rng.integers(1, 30)).tolist() for _ in range(n_users)]


def _decode_port(bitmask: np.ndarray, vocab: int) -> list[set[int]]:
    v = np.arange(vocab)
    bits = (bitmask.view(np.uint32)[:, v >> 5] >> (v & 31).astype(np.uint32)) & 1
    return [set(np.nonzero(row)[0].tolist()) for row in bits]


def _decode_jax(bitmask: np.ndarray, vocab: int) -> list[set[int]]:
    """Bit-plane-per-tile layout of `bsarec_tpu.ops.pallas_rank`."""
    w = TILE_COLS // 32
    v = np.arange(vocab)
    u = v % TILE_COLS
    word, bit = (v // TILE_COLS) * w + u % w, (u // w).astype(np.uint32)
    bits = (bitmask.view(np.uint32)[:, word] >> bit) & 1
    return [set(np.nonzero(row)[0].tolist()) for row in bits]


@pytest.mark.parametrize("seqs,max_len", [(TOY, 4), (synthetic_seqs(), 12)], ids=["toy", "synth300"])
def test_splits_byte_identical(seqs, max_len):
    ours = SeqRecData(Corpus(user_seq=[list(s) for s in seqs], max_item=max(map(max, seqs))), max_len)
    ref = JaxSeqRecData(JaxCorpus(user_seq=[list(s) for s in seqs], max_item=max(map(max, seqs))), max_len)
    assert ours.item_size == ref.item_size
    for split, fields in (("train", ("input_ids", "answers", "user_ids")),
                          ("valid", ("input_ids", "answers", "seen_items")),
                          ("test", ("input_ids", "answers", "seen_items"))):
        for field in fields:
            a, b = getattr(getattr(ours, split), field), getattr(getattr(ref, split), field)
            assert a.dtype == b.dtype and a.shape == b.shape, (split, field)
            assert a.tobytes() == b.tobytes(), (split, field)


def test_load_corpus_reference_format(tmp_path):
    path = tmp_path / "toy.txt"
    path.write_text("".join(f"{u + 1} {' '.join(map(str, s))}\n" for u, s in enumerate(TOY)))
    corpus = load_corpus(path)
    assert corpus.lists == TOY  # parsed into the CSR form where the native library loads
    assert corpus.item_size == 12 and corpus.num_users == 4


@pytest.mark.parametrize("vocab", [300, 5000, 4096 * 2 + 33])
def test_bitmask_builders_match_jax_seen_sets(vocab):
    rng = np.random.default_rng(vocab)
    seen = rng.integers(0, vocab, size=(9, 40)).astype(np.int32)
    seen[:, -6:] = 0  # padding
    seen[2] = 0  # a user with no history
    seen[3, :4] = [7, 7, 7, vocab - 1]  # repeats and the last item
    seen[4, :2] = [31, 32]  # word boundary, bit 31 (the int32 sign bit)
    want = _decode_jax(jax_build_seen_bitmask(seen, vocab), vocab)
    assert all(0 in row for row in want)  # item 0 always masked

    host = rank.build_seen_bitmask(seen, vocab)
    assert host.shape == (9, rank.seen_words(vocab)) and host.dtype == np.int32
    assert _decode_port(host, vocab) == want

    deduped = rank.dedupe_seen_rows(seen)
    for r in range(seen.shape[0]):
        assert set(deduped[r]) - {0} == set(seen[r]) - {0}
    device_built = rank.seen_ids_to_bitmask(torch.from_numpy(deduped), vocab)
    assert device_built.is_contiguous() and device_built.dtype == torch.int32
    np.testing.assert_array_equal(device_built.numpy(), host)

"""Streaming masked top-k: the port's plain version vs the JAX Pallas
kernel (interpret mode on the CPU). The CUDA kernel is held against the
plain version in `tests/test_torch_port_cuda.py` and `chip_smoke.py`."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsarec_tpu.ops.pallas_rank import build_seen_bitmask as jax_build_seen_bitmask
from bsarec_tpu.ops.pallas_rank import streaming_masked_topk as jax_streaming_masked_topk
from bsarec_tpu_torch.ops import rank

# float inputs: fp32 dot products of 64 N(0, 1) terms, summed in another
# order by XLA and by torch
RTOL, ATOL = 1e-5, 1e-5


def _inputs(b, v, h, seed, integer):
    rng = np.random.default_rng(seed)
    if integer:  # dot products are exact, so ids (ties included) must match
        states = rng.integers(-2, 3, size=(b, h)).astype(np.float32)
        table = rng.integers(-2, 3, size=(v, h)).astype(np.float32)
    else:
        states = rng.normal(size=(b, h)).astype(np.float32)
        table = rng.normal(size=(v, h)).astype(np.float32)
    seen = rng.integers(1, v, size=(b, 20)).astype(np.int32)
    seen[:, 1] = seen[:, 0]
    seen[:, 14:] = 0
    return states, table, seen


def _masked_logits(states, table, seen, n_valid):
    logits = states @ table.T
    logits[np.arange(len(seen))[:, None], seen] = 0.0
    logits[:, 0] = 0.0
    logits[:, n_valid:] = -np.inf
    return logits


@pytest.mark.parametrize("k,h", [(5, 64), (20, 64), (20, 128), (20, 256)])
@pytest.mark.parametrize("integer", [False, True], ids=["float", "integer"])
def test_plain_matches_jax_kernel(k, h, integer):
    """B=10, V=5000 (two 4096-wide TPU tiles and a tail), n_valid=4990; at
    H = 64 and at the CUDA kernel's middle widths, H = 128 and 256 (float
    tables scaled by sqrt(64 / H), as the card's checks scale them, so
    that the scores keep H = 64's spread)."""
    b, v, n_valid = 10, 5000, 4990
    states, table, seen = _inputs(b, v, h, seed=k if h == 64 else k + h, integer=integer)
    if not integer and h != 64:
        table *= np.float32(np.sqrt(64 / h))
    want_v, want_i = jax_streaming_masked_topk(
        jnp.asarray(states), jnp.asarray(table), jnp.asarray(jax_build_seen_bitmask(seen, v)),
        k=k, n_valid=n_valid, interpret=True,
    )
    got_v, got_i = rank.streaming_masked_topk(
        torch.from_numpy(states), torch.from_numpy(table),
        torch.from_numpy(rank.build_seen_bitmask(seen, v)), k=k, n_valid=n_valid,
    )
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    if integer:
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    else:
        np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=RTOL, atol=ATOL)
        logits = _masked_logits(states, table, seen, n_valid)
        by_score = np.take_along_axis(logits, got_i.numpy().astype(np.int64), axis=1)
        np.testing.assert_allclose(by_score, np.asarray(want_v), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("k,n_valid,all_seen", [
    (32, 4990, True), (33, 5000, False), (1, 4999, True),
])
def test_plain_matches_jax_kernel_at_the_onchip_route_edges(k, n_valid, all_seen):
    """Integer inputs (exact dot products, many ties) at the CUDA kernel's
    on-chip route bound k=32 and just past it (k=33), V=5000 off the
    64-column tile, n_valid < V, and a row that has seen every item (all
    its valid scores 0.0): values and ids bit-equal to the JAX kernel's."""
    b, v, h = 6, 5000, 64
    states, table, seen = _inputs(b, v, h, seed=40 + k, integer=True)
    if all_seen:
        seen = np.concatenate([seen, np.zeros((b, v), np.int32)], axis=1)
        seen[2, 20:] = np.arange(v)
    want_v, want_i = jax_streaming_masked_topk(
        jnp.asarray(states), jnp.asarray(table), jnp.asarray(jax_build_seen_bitmask(seen, v)),
        k=k, n_valid=n_valid, interpret=True,
    )
    got_v, got_i = rank.streaming_masked_topk(
        torch.from_numpy(states), torch.from_numpy(table),
        torch.from_numpy(rank.build_seen_bitmask(seen, v)), k=k, n_valid=n_valid,
    )
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    if all_seen:
        assert got_i[2].tolist() == list(range(k)) and not got_v[2].any()


@pytest.mark.parametrize("chunk", [7, 64, 4096])
def test_plain_is_chunk_invariant_and_pads(chunk):
    """The running merge across chunks gives the one-shot answer; rows
    with fewer valid columns than k end in (-inf, 0) slots."""
    states, table, seen = _inputs(6, 300, 16, seed=1, integer=True)
    bm = torch.from_numpy(rank.build_seen_bitmask(seen, 300))
    s, t = torch.from_numpy(states), torch.from_numpy(table)
    want = rank.streaming_masked_topk_plain(s, t, bm, k=30, n_valid=300, chunk=1 << 20)
    got = rank.streaming_masked_topk_plain(s, t, bm, k=30, n_valid=300, chunk=chunk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    few_v, few_i = rank.streaming_masked_topk_plain(s, t, bm, k=30, n_valid=12, chunk=chunk)
    assert torch.isinf(few_v[:, 12:]).all() and (few_i[:, 12:] == 0).all()
    assert torch.isfinite(few_v[:, :12]).all()


def test_wrapper_on_cpu_runs_plain_and_validates():
    states, table, seen = _inputs(4, 100, 8, seed=2, integer=False)
    s, t = torch.from_numpy(states), torch.from_numpy(table)
    bm = torch.from_numpy(rank.build_seen_bitmask(seen, 100))
    before = rank.streaming_masked_topk.launches
    got = rank.streaming_masked_topk(s, t, bm, k=3)
    want = rank.streaming_masked_topk_plain(s, t, bm, k=3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert rank.streaming_masked_topk.launches == before  # counts kernel launches only
    for bad in ({"k": 0}, {"k": rank.MAX_K + 1}, {"n_valid": 101}, {"n_valid": -1},
                {"seen_value": 1.0}):
        with pytest.raises(ValueError):
            rank.streaming_masked_topk(s, t, bm, **{"k": 3, **bad})

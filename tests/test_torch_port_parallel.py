"""The vocab-sharded composition in one process (`bsarec_tpu_torch/parallel/`:
m shards through the merge functions, each shard on the kernels' plain
versions) against JAX's `bsarec_tpu/parallel/` on conftest's 8-device
CPU mesh (data = 8 / m), Pallas in interpret mode, as
`tests/test_parallel.py:131-300` runs it; and the bitmask's shard mode
against JAX's `build_seen_bitmask_sharded`. Each limit is in
`bsarec_tpu_torch/parity.py`. The group paths are
`tests/test_torch_port_mesh.py`'s."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from bsarec_tpu.ops import pallas_rank as jax_rank
from bsarec_tpu.ops.topk import masked_topk as jax_masked_topk
from bsarec_tpu.parallel import logits as jax_logits
from bsarec_tpu.parallel.embedding import pad_vocab_rows as jax_pad_vocab_rows
from bsarec_tpu.parallel.embedding import sharded_embedding_lookup as jax_lookup
from bsarec_tpu_torch import parity
from bsarec_tpu_torch.ops import ce, rank
from bsarec_tpu_torch.parallel import embedding
from bsarec_tpu_torch.parallel import logits as plog

B, H = 8, 16


def _mesh(m):
    devices = np.asarray(jax.devices()[:8]).reshape(8 // m, m)
    return Mesh(devices, ("data", "model"))


def _place(mesh, x, spec):
    return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))


def _ce_inputs(v, seed):
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(B, H)).astype(np.float32)
    table = (0.5 * rng.normal(size=(v, H))).astype(np.float32)
    answers = rng.integers(1, v, size=B)
    # item 0, every shard's first and last row at m = 4
    answers[:5] = [0, v // 4, v // 2 - 1, v // 2, v - 1]
    weights = rng.uniform(0.5, 1.5, size=B).astype(np.float32)
    return states, table, answers.astype(np.int32), weights


def _seen(v, m, seed):
    """[B, 8] seen ids: random ones, every shard's first row (local item 0
    on shards past the first), a repeat and 0 padding."""
    rng = np.random.default_rng(seed)
    seen = rng.integers(1, v, size=(B, 8)).astype(np.int32)
    seen[:, :m - 1] = np.arange(1, m) * (v // m)
    seen[:, m] = seen[:, m + 1]
    seen[:, -2:] = 0
    return seen


@pytest.mark.parametrize("m,dtype", [(2, None), (4, "bfloat16")])
def test_sharded_streaming_ce_matches_jax(m, dtype):
    """Loss, ds and dT of m shards merged against JAX's
    `sharded_streaming_ce` (`jax.vjp` of the weighted loss), logZ against
    JAX's logsumexp of the same (rounded) operands. The bf16 form's
    gradients are taken at JAX's logZ, as the unsharded form's are held
    (`parity.BF16_GRAD_TOL`)."""
    v = 64
    states, table, answers, weights = _ce_inputs(v, seed=m)
    mesh = _mesh(m)
    s_j = _place(mesh, states, P("data", None))
    t_j = _place(mesh, table, P("model", None))
    a_j = _place(mesh, answers, P("data"))
    @jax.jit
    def loss_and_grads(s_, t_, w_):
        loss, vjp = jax.vjp(lambda x, y: jax_logits.sharded_streaming_ce(x, y, a_j, mesh,
                                                                         dtype=dtype), s_, t_)
        return loss, *vjp(w_)

    j_loss, j_ds, j_dt = (np.asarray(y) for y in loss_and_grads(s_j, t_j, jnp.asarray(weights)))
    operands = (jnp.asarray(states), jnp.asarray(table))
    if dtype:
        operands = tuple(x.astype(jnp.bfloat16) for x in operands)
    j_logz = np.asarray(jax.nn.logsumexp(
        jnp.einsum("bh,vh->bv", *operands, preferred_element_type=jnp.float32), axis=-1))

    s, t, a, w = (torch.from_numpy(x) for x in (states, table, answers, weights))
    tables = list(t.chunk(m))
    loss, logz = plog.streaming_ce_over_shards(s, tables, a, dtype)
    np.testing.assert_allclose(loss.numpy(), np.asarray(j_loss), **parity.SHARD_LOSS_TOL)
    np.testing.assert_allclose(logz.numpy(), j_logz, **parity.SHARD_LOSS_TOL)
    if dtype is None:
        ds, dt = plog.streaming_ce_grads_over_shards(s, tables, a, logz, w, dtype)
        np.testing.assert_allclose(ds.numpy(), j_ds, **parity.SHARD_GRAD_TOL)
        np.testing.assert_allclose(dt.numpy(), j_dt, **parity.SHARD_GRAD_TOL)
    else:
        ds, dt = plog.streaming_ce_grads_over_shards(s, tables, a, torch.from_numpy(j_logz), w,
                                                     dtype)
        errs = parity.grad_errors(ds, dt, torch.from_numpy(j_ds), torch.from_numpy(j_dt), a, v)
        assert max(errs.values()) <= parity.BF16_GRAD_TOL, errs


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("m", [2, 4])
def test_off_shard_answers_raw_or_mapped_agree(m, dtype):
    """Each shard's stats and gradients from the raw answers a - start (the
    port: the kernels give gold 0 and no one-hot term outside [0, rows))
    bit-equal to those from JAX's mapping of off-shard answers to -1
    (`_local_answers`); and the merge against one unsharded call."""
    v = 64
    states, table, answers, weights = _ce_inputs(v, seed=10 + m)
    s, t, a, w = (torch.from_numpy(x) for x in (states, table, answers, weights))
    rows = v // m
    for i, shard in enumerate(t.chunk(m)):
        local = a.long() - i * rows
        mapped = torch.where((local >= 0) & (local < rows), local, -1)
        raw_stats = ce.streaming_ce_stats(s, shard, local, dtype=dtype)
        for x, y in zip(raw_stats, ce.streaming_ce_stats(s, shard, mapped, dtype=dtype)):
            assert torch.equal(x, y)
        logz = raw_stats[1]
        for x, y in zip(ce.streaming_ce_grads(s, shard, local, logz, w, dtype=dtype),
                        ce.streaming_ce_grads(s, shard, mapped, logz, w, dtype=dtype)):
            assert torch.equal(x, y)
    loss, logz = plog.streaming_ce_over_shards(s, list(t.chunk(m)), a, dtype)
    want_loss, want_logz = ce.ce_loss_logz(s, t, a, dtype=dtype)
    torch.testing.assert_close(loss, want_loss, **parity.SHARD_LOSS_TOL)
    torch.testing.assert_close(logz, want_logz, **parity.SHARD_LOSS_TOL)
    ds, dt = plog.streaming_ce_grads_over_shards(s, list(t.chunk(m)), a, want_logz, w, dtype)
    want_ds, want_dt = ce.ce_grads(s, t, a, want_logz, w, dtype=dtype)
    errs = parity.grad_errors(ds, dt, want_ds, want_dt, a, v)
    assert max(errs.values()) <= (parity.BF16_GRAD_TOL if dtype else parity.SHARD_GRAD_TOL["rtol"])


@pytest.mark.parametrize("m,n_valid", [(2, 16384 - 100), (4, 3 * 4096 - 100)])
def test_sharded_streaming_topk_matches_jax(m, n_valid):
    """Values and ids of m shards' rank-kernel plain versions merged against
    JAX's `sharded_streaming_topk`: n_valid inside a shard, and at m = 4 a
    last shard at n_valid 0 (the kernel's empty case); each shard's bitmask
    from the port's shard mode, JAX's from its own."""
    v = 16384
    rng = np.random.default_rng(20 + m)
    states = rng.normal(size=(B, H)).astype(np.float32)
    table = rng.normal(size=(v, H)).astype(np.float32)
    seen = _seen(v, m, seed=m)
    mesh = _mesh(m)
    j_stack = _place(mesh, jax_rank.build_seen_bitmask_sharded(seen, v, m),
                     P("model", "data", None))
    j_vals, j_ids = jax.jit(lambda s_, t_, m_: jax_logits.sharded_streaming_topk(
        s_, t_, m_, mesh, k=10, max_valid_items=n_valid))(
        _place(mesh, states, P("data", None)), _place(mesh, table, P("model", None)), j_stack)
    stack = torch.from_numpy(rank.build_seen_bitmask_sharded(seen, v, m))
    vals, ids = plog.streaming_topk_over_shards(torch.from_numpy(states),
                                                list(torch.from_numpy(table).chunk(m)), stack,
                                                k=10, max_valid_items=n_valid)
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    assert (ids < n_valid).all()


@pytest.mark.parametrize("m", [2, 4])
def test_dense_pair_matches_jax(m):
    """The dense pair: the mean CE and its gradients against JAX's
    `sharded_softmax_ce` and `jax.grad`; the top-k (a shard's first item
    seen, ids past max_valid at -inf) against JAX's `sharded_masked_topk`."""
    v = 64
    states, table, answers, _ = _ce_inputs(v, seed=30 + m)
    mesh = _mesh(m)
    s_j = _place(mesh, states, P("data", None))
    t_j = _place(mesh, table, P("model", None))
    a_j = _place(mesh, answers, P("data"))
    j_loss, (j_ds, j_dt) = jax.jit(jax.value_and_grad(
        lambda s_, t_: jax_logits.sharded_softmax_ce(s_, t_, a_j, mesh), argnums=(0, 1)))(s_j, t_j)
    j_topk = jax.jit(lambda s_, t_, seen_: jax_logits.sharded_masked_topk(
        s_, t_, seen_, mesh, k=10, max_valid_items=v - 3))
    s = torch.from_numpy(states).requires_grad_()
    t = torch.from_numpy(table).requires_grad_()
    loss = plog.dense_ce_over_shards(s, list(t.chunk(m)), torch.from_numpy(answers)).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(j_loss), **parity.SHARD_LOSS_TOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(j_ds), **parity.SHARD_GRAD_TOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(j_dt), **parity.SHARD_GRAD_TOL)

    # seen ids without a shard's first item: JAX's sharded top-k as it is
    seen = np.random.default_rng(40 + m).integers(1, v, size=(B, 6)).astype(np.int32)
    seen[seen % (v // m) == 0] += 1
    seen[:, -2:] = 0
    j_vals, j_ids = j_topk(s_j, t_j, _place(mesh, seen, P("data", None)))
    with torch.no_grad():
        vals, ids = plog.dense_topk_over_shards(s, list(t.chunk(m)), torch.from_numpy(seen), k=10,
                                                max_valid_items=v - 3)
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    # with every shard's first item seen, against JAX's unsharded `masked_topk`:
    # JAX's sharded one sets column 0 of a shard once from the owned id and
    # once from the 0 padding (which it leaves unmasked), and can keep a seen
    # shard-first item in its result (ROADMAP C); the port counts the owned
    # ids a column
    seen = _seen(v, m, seed=40 + m)
    scores = jnp.asarray(states @ table.T).at[:, v - 3:].set(-jnp.inf)
    j_vals, j_ids = jax_masked_topk(scores, jnp.asarray(seen), k=10)
    with torch.no_grad():
        vals, ids = plog.dense_topk_over_shards(s, list(t.chunk(m)), torch.from_numpy(seen), k=10,
                                                max_valid_items=v - 3)
    np.testing.assert_allclose(vals.numpy(), np.asarray(j_vals), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))


@pytest.mark.parametrize("m", [2, 4])
def test_lookup_and_its_gradient_match_jax(m):
    """The sharded lookup against JAX's `sharded_embedding_lookup`, bit for
    bit; its gradient a scatter-add into the owned rows, JAX's but for row
    0, which id 0 does not update (`padding_idx`); `pad_vocab_rows` as
    JAX's."""
    rng = np.random.default_rng(50 + m)
    v = 40
    table = rng.normal(size=(v, H)).astype(np.float32)
    ids = rng.integers(0, v, size=(B, 5))
    ids[0, :2] = 0
    padded, n = embedding.pad_vocab_rows(torch.from_numpy(table), m)
    j_padded, j_n = jax_pad_vocab_rows(jnp.asarray(table), m)
    assert n == j_n == v and torch.equal(padded, torch.from_numpy(np.asarray(j_padded)))
    mesh = _mesh(m)
    t_j = _place(mesh, j_padded, P("model", None))
    ids_j = _place(mesh, ids.astype(np.int32), P("data", None))
    def squares(t_):
        out = jax_lookup(t_, ids_j, mesh)
        return jnp.sum(out ** 2), out

    (_, j_emb), j_grad = jax.jit(jax.value_and_grad(squares, has_aux=True))(t_j)
    j_emb, j_grad = np.asarray(j_emb), np.asarray(j_grad)
    shards = [x.clone().requires_grad_() for x in padded.chunk(m)]
    emb = embedding.lookup_over_shards(shards, torch.from_numpy(ids))
    np.testing.assert_array_equal(emb.detach().numpy(), j_emb)
    (emb ** 2).sum().backward()
    grad = torch.cat([x.grad for x in shards]).numpy()
    np.testing.assert_allclose(grad[1:], j_grad[1:], rtol=1e-6, atol=1e-6)
    assert not grad[0].any() and j_grad[0].any()


def _seen_sets(bitmask_rows, decode):
    return [set(np.flatnonzero(decode(row))) for row in bitmask_rows]


@pytest.mark.parametrize("m", [2, 4])
def test_bitmask_shard_mode_matches_jax(m):
    """`build_seen_bitmask_sharded` natively and in numpy bit-equal, and each
    shard's seen set (local ids, item 0 on shard 0 only) JAX's, read off
    its bit-plane layout; `seen_ids_to_bitmask`'s shard mode equal to the
    host builder's."""
    v = 1000 * m
    seen = _seen(v, m, seed=60 + m)
    stack = rank.build_seen_bitmask_sharded(seen, v, m)
    os.environ["BSAREC_NO_NATIVE"] = "1"
    try:
        plain = rank.build_seen_bitmask_sharded(seen, v, m)
    finally:
        os.environ.pop("BSAREC_NO_NATIVE")
    assert stack.dtype == np.int32 and np.array_equal(stack, plain)
    j_stack = np.asarray(jax_rank.build_seen_bitmask_sharded(seen, v, m)).view(np.uint32)
    rows = v // m
    tile = jax_rank.TILE_COLS
    w = tile // 32

    def jax_bits(row):
        ids = np.arange(rows)
        u = ids % tile
        words = (ids // tile) * w + u % w
        return (row[words] >> (u // w).astype(np.uint32)) & 1

    def port_bits(row):
        ids = np.arange(rows)
        return (row.view(np.uint32)[ids >> 5] >> (ids & 31).astype(np.uint32)) & 1

    dedup = torch.from_numpy(rank.dedupe_seen_rows(seen))
    for s in range(m):
        assert _seen_sets(stack[s], port_bits) == _seen_sets(j_stack[s], jax_bits)
        on_device = rank.seen_ids_to_bitmask(dedup, rows, s * rows, s == 0)
        np.testing.assert_array_equal(on_device.numpy(), stack[s])


def test_merges_keep_the_smaller_id_and_empty_shards():
    """`merge_topk` orders equal values by global id across shards and
    gives (-inf, 0) to slots nothing filled; `merge_ce_stats` keeps a row
    with no valid column at -inf and ignores an empty shard."""
    vals = torch.tensor([[[2.0, 1.0, float("-inf")]], [[2.0, 1.0, float("-inf")]]])
    ids = torch.tensor([[[3, 1, 0]], [[5, 4, 4]]])
    top, top_ids = plog.merge_topk(vals, ids, 6)
    assert top.tolist() == [[2.0, 2.0, 1.0, 1.0, float("-inf"), float("-inf")]]
    assert top_ids.tolist() == [[3, 5, 1, 4, 0, 0]]
    inf = float("-inf")
    logz, gold = plog.merge_ce_stats(torch.tensor([[1.0, inf], [inf, inf]]),
                                     torch.tensor([[0.5, 0.0], [0.0, 0.0]]))
    assert logz.tolist() == [1.0, inf] and gold.tolist() == [0.5, 0.0]

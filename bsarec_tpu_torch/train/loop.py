"""Training and eval loops (counterpart of `bsarec_tpu/train/loop.py`).

The JAX package runs a whole epoch, or a whole eval pass, as one
`lax.scan` inside one jitted program. Here each is a Python loop over
batches of device-resident data, or under `--multihost` of batches that
each data rank moves from the host (`build_host_fed_epoch`); both run
the one step body, `build_train_step`. The training loop reads nothing
back to the host until the epoch ends (the host-fed epoch its schedule
once at its start): the loss is summed on the device; the
epoch order, the negatives, BERT4Rec's cloze positions and the fused
dropout's seed words come from a generator on the device; Adam keeps its
step counts on the host.

Under a mesh (`core/mesh.py`) every rank draws the global batch, its
negatives and the fused dropout's seed words from the same generator,
as the single run does, and keeps its data rank's rows; after each
backward every gradient is averaged over the data group, the table
shard's with the rest (JAX's `_data_constraint` and the partitioner's
psums, `bsarec_tpu/train/loop.py:31-38`). The fused dropout's key word 1
is offset by the data rank, so data ranks draw other masks while the
ranks of one model group draw the same. An eval pass scores each data
rank's users of every batch and sums the metrics over the data group.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

import torch.distributed as dist

from bsarec_tpu_torch.core.mesh import data_rows, global_rows, using_mesh
from bsarec_tpu_torch.data.multihost import PinnedStaging, global_batch
from bsarec_tpu_torch.ops.losses import SHARDED_IMPLS
from bsarec_tpu_torch.ops.precision import is_bf16, rounded
from bsarec_tpu_torch.ops.rank import seen_ids_to_bitmask, streaming_masked_topk
from bsarec_tpu_torch.ops.topk import TOP_K, masked_topk, topk_metrics
from bsarec_tpu_torch.utils.profiling import annotate

# From this catalog size on (and on CUDA) "auto" picks the streaming
# rank kernel over the dense [B, V] score matrix.
STREAMING_RANK_MIN_VOCAB = 262_144


def make_optimizer(params, train_cfg) -> torch.optim.Adam:
    """torch.optim.Adam as the reference builds it (`src/trainers.py:27-28`),
    which the JAX package copies with optax: weight decay added to the
    gradient (not decoupled), eps 1e-8, bias-corrected moments."""
    return torch.optim.Adam(params, lr=train_cfg.lr,
                            betas=(train_cfg.adam_beta1, train_cfg.adam_beta2),
                            eps=1e-8, weight_decay=train_cfg.weight_decay)


def sample_negatives(generator: torch.Generator, input_ids: torch.Tensor,
                     answers: torch.Tensor, item_size: int, rounds: int = 8) -> torch.Tensor:
    """Uniform negatives in [1, item_size) that avoid the sample's items,
    {nonzero input ids} | {answer} (`src/dataset.py:66-70,120-124`), by 8
    rounds of redrawing the colliding ones. `generator` lives on the
    tensors' device. The pairwise losses (SASRec, FMLP-Rec, GRU4Rec,
    Caser) read these; the full-catalog CE models do not, and the JAX
    epoch's draw for them is dead code that XLA removes, so the port's
    epoch draws them only for models with `reads_negatives`. Under a mesh
    with data ranks (`core/mesh.py:global_rows`) the rows are this rank's
    share of the global batch: each round draws the global batch's vector
    and keeps this rank's entries, and as the collision test is per row,
    the negatives are the single run's rows."""
    batch, dev = answers.shape[0], answers.device
    rows, mine = global_rows(batch)

    def draw():
        return torch.randint(1, item_size, (rows,), generator=generator, device=dev)[mine]

    cand = draw()
    for _ in range(rounds):
        collides = (input_ids == cand[:, None]).any(dim=1) | (cand == answers)
        cand = torch.where(collides, draw(), cand)
    return cand


def epoch_permutation(num_samples: int, batch_size: int, generator: torch.Generator,
                      device: torch.device) -> torch.Tensor:
    """[steps, batch_size] sample indices: a random permutation, wrapped
    around so that the last batch is full (`train/loop.py:181-185`)."""
    steps = math.ceil(num_samples / batch_size)
    perm = torch.randperm(num_samples, generator=generator, device=device)
    wrap = torch.arange(steps * batch_size, device=device) % num_samples
    return perm[wrap].view(steps, batch_size)


def dropout_seeds(generator: torch.Generator, steps: int, device: torch.device) -> torch.Tensor:
    """[steps, 2] int64 seed words in [0, 2^32), one row per step, drawn on
    the device (no host sync)."""
    return torch.randint(0, 1 << 32, (steps, 2), generator=generator, dtype=torch.int64,
                         device=device)


def remat_loss(model, ids, ans, neg, sem, uid, generator: torch.Generator | None):
    """`model.calculate_loss` of one batch with the whole loss recomputed in
    the backward instead of its activations kept (JAX's `jax.checkpoint`
    of the loss, `bsarec_tpu/train/loop.py:173-177`): the same loss and
    gradients as the eager call, bit for bit. The recompute sees what the
    forward saw: torch's default CPU and CUDA streams (nn.Dropout) by
    `preserve_rng_state`; the explicit generator's state (BERT4Rec's cloze
    positions) and the fused dropout's seeds and call index, each set back
    to its value at the loss's entry here, and the generator then returned
    to where the forward left it, so the epoch's stream keeps its order."""
    state = model.dropout_state

    def snapshot():
        return None if generator is None else generator.get_state(), state.seeds, state.call

    def restore(saved):
        if generator is not None:
            generator.set_state(saved[0])
        state.seeds, state.call = saved[1], saved[2]

    entry = snapshot()
    forward_done = False

    def loss_fn(ids, ans, neg, sem, uid):
        nonlocal forward_done
        if forward_done:  # the recompute
            after = snapshot()
            restore(entry)
            try:
                return model.calculate_loss(ids, ans, neg, sem, uid, generator=generator)
            finally:  # also when the recompute stops early, its saved tensors made
                restore(after)
        forward_done = True
        return model.calculate_loss(ids, ans, neg, sem, uid, generator=generator)

    return checkpoint(loss_fn, ids, ans, neg, sem, uid, use_reentrant=False,
                      preserve_rng_state=True)


def average_gradients(params, group, n: int) -> None:
    """Every gradient of `params` averaged over the `n` ranks of `group`,
    in one all_reduce of their concatenation."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    flat /= n
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def data_rank_seeds(seeds: torch.Tensor, mesh) -> torch.Tensor:
    """The fused dropout's [steps, 2] seed words of this data rank: key
    word 1 plus the data rank, mod 2^32 (data rank 0 keeps the single
    run's words)."""
    if mesh is None or mesh.data_rank == 0:
        return seeds
    seeds = seeds.clone()
    seeds[:, 1] = (seeds[:, 1] + mesh.data_rank) % (1 << 32)
    return seeds


def build_train_step(model, optimizer, remat: bool = False, mesh=None):
    """Returns `step(ids, ans, generator, seed_words=None, uid=None,
    sem=None)`: one Adam step on this data rank's rows of a global batch
    (all of it without a mesh; user ids and the same-target view where the
    model reads them), the one body of every training epoch (counterpart
    of `bsarec_tpu/train/loop.py:218-262`). From the generator, in this
    order: the negatives (models with `reads_negatives` only; the global
    batch's draw, this rank's rows), then what the loss itself draws
    (BERT4Rec's cloze positions).
    `seed_words` are the fused dropout's [2] words of the step. `remat`
    recomputes the whole loss in its backward (`remat_loss`), bit-equal to
    the eager step. Under `mesh` the gradients are averaged over the data
    group. Returns the step's loss, detached, on the device."""
    item_size = model.config.item_size
    dropout_state = model.dropout_state
    params = [p for group in optimizer.param_groups for p in group["params"]]
    data_parallel = mesh is not None and mesh.data > 1

    def step(ids, ans, generator, seed_words=None, uid=None, sem=None):
        # the global batch's draws (negatives, cloze positions, their
        # recompute under remat) read the active mesh
        with using_mesh(mesh):
            neg = (sample_negatives(generator, ids, ans, item_size)
                   if model.reads_negatives else None)
            if seed_words is not None:
                dropout_state.begin_step(seed_words)
            if remat:
                loss = remat_loss(model, ids, ans, neg, sem, uid, generator)
            else:
                loss = model.calculate_loss(ids, ans, neg, sem, uid, generator=generator)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        if data_parallel:
            average_gradients(params, mesh.data_group, mesh.data)
        optimizer.step()
        return loss.detach()

    return step


def _epoch_draws(num_samples: int, batch_size: int, steps: int, model, generator,
                 device: torch.device, mesh):
    """The epoch's first draws, in the order every epoch takes them: the
    [steps, batch_size] permutation, then the fused dropout's [steps, 2]
    seed words of this data rank (fused models only, else None)."""
    perm = epoch_permutation(num_samples, batch_size, generator, device)
    seeds = dropout_seeds(generator, steps, device) if model.dropout_state.fused else None
    return perm, None if seeds is None else data_rank_seeds(seeds, mesh)


def _epoch_mean(loss_sum: torch.Tensor, steps: int, mesh) -> torch.Tensor:
    """The mean batch loss of an epoch, averaged over the data group."""
    if mesh is not None:
        dist.all_reduce(loss_sum, group=mesh.data_group)
        loss_sum /= mesh.data
    return loss_sum / steps


def build_train_epoch(model, optimizer, batch_size: int, num_samples: int,
                      device: torch.device, remat: bool = False, mesh=None):
    """Returns `(epoch, steps)`; `epoch(inputs, answers, generator, users,
    same_target)` runs one pass over the [N, L] inputs, [N] answers, [N]
    user ids and [N, L] same-target view on the device (each None where
    the model reads none) in the generator's order, one `build_train_step`
    step per full batch, and returns the mean batch loss as a 0-d tensor
    on the device. From the generator, in this order: the epoch's
    permutation, the fused dropout's [steps, 2] seed words (fused models
    only), then each step's draws. Under `mesh` each step runs on this
    data rank's rows of the global batch and the mean loss over the data
    group is returned."""
    steps = math.ceil(num_samples / batch_size)
    step_fn = build_train_step(model, optimizer, remat=remat, mesh=mesh)

    def epoch(inputs, answers, generator, users=None, same_target=None):
        perm, seeds = _epoch_draws(num_samples, batch_size, steps, model, generator, device, mesh)
        model.train()
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for step in range(steps):
            with annotate("train_step"):
                idx = data_rows(perm[step], mesh)
                loss_sum += step_fn(
                    inputs[idx], answers[idx], generator,
                    None if seeds is None else seeds[step],
                    None if users is None else users[idx],
                    None if same_target is None else same_target[idx])
        return _epoch_mean(loss_sum, steps, mesh)

    return epoch, steps


def build_host_fed_epoch(model, optimizer, batch_size: int, num_samples: int,
                         device: torch.device, remat: bool = False, mesh=None):
    """Returns `(epoch, steps)`; `epoch(dataset, generator)` runs one pass
    of `build_train_epoch`'s over a `data.multihost.HostShardedDataset`
    whose fields stay on the host (`input_ids`, `answers`, and `user_ids`
    and `same_target` where the model reads them) and returns the same
    mean loss (`--multihost`; JAX's `Trainer._train_multihost`). It draws
    from the generator what that epoch draws, in its order: the
    permutation, moved to the host once (the epoch's one sync before its
    end) as the flattened schedule `dataset.epoch_batches_from_perm`
    slices, then the seed words, then each step's draws. Each step moves
    this data rank's rows of its global batch to the device through a
    pinned ring of two buffers (`data.multihost.global_batch`)."""
    steps = math.ceil(num_samples / batch_size)
    step_fn = build_train_step(model, optimizer, remat=remat, mesh=mesh)
    staging = PinnedStaging(device)

    def epoch(dataset, generator):
        perm, seeds = _epoch_draws(num_samples, batch_size, steps, model, generator, device, mesh)
        schedule = perm.reshape(-1).cpu().numpy()
        model.train()
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for step, local in enumerate(dataset.epoch_batches_from_perm(schedule)):
            with annotate("train_step"):
                batch = global_batch(local, mesh, batch_size, staging=staging)
                loss_sum += step_fn(
                    batch["input_ids"], batch["answers"], generator,
                    None if seeds is None else seeds[step],
                    batch.get("user_ids"), batch.get("same_target"))
        return _epoch_mean(loss_sum, steps, mesh)

    return epoch, steps


def resolve_eval_impl(impl: str, item_size: int, device: torch.device) -> str:
    if impl == "auto":
        big = item_size >= STREAMING_RANK_MIN_VOCAB and device.type == "cuda"
        return "streaming" if big else "dense"
    if impl not in ("dense", "streaming", *SHARDED_IMPLS):
        raise NotImplementedError(f"eval_impl {impl!r} is not ported")
    return impl


def build_eval_fn(model, item_size: int, batch_size: int, num_users: int,
                  device: torch.device, impl: str = "auto", collect_topk: bool = False,
                  seen_format: str = "bitmask", dtype: str = "float32", mesh=None):
    """Returns `(evaluate, steps, impl)`; `evaluate(inputs, answers, seen)`
    gives the [9] float32 metric sums (`ops.topk.topk_metrics` layout),
    or with `collect_topk` the [num_users, 20] int32 top-k item ids.

    impl "dense" scores the full catalog per batch and masks/top-ks it;
    "streaming" runs `ops.rank.streaming_masked_topk` and `seen` is then a
    [U, ceil(V/32)] bitmask ("bitmask") or deduplicated [U, S] seen-id
    lists from which each batch's bitmask is built on the device ("ids").
    It scores the whole item table, V = `model.vocab_rows()` rows
    (BERT4Rec's [mask] row included), with n_valid = item_size. The dense
    path always takes id lists. The last batch is padded by clamping user
    indices to num_users-1 and weighted out with `valid`. `model.predict`
    gets the users' indices too (Caser reads them). `dtype` "bfloat16"
    scores the dense path from bf16-rounded states and table with a
    float32 result (`bsarec_tpu/train/loop.py:341-348`); the streaming
    path takes no dtype, as in JAX.

    Under `mesh` each data rank scores its rows of every batch and the
    sums are added over the data group (the top-k ids gathered to every
    rank). "sharded_streaming" and "sharded_dense" score this rank's
    shard of a vocab-sharded table (`parallel/logits.py`): `seen` is then
    the shard's own bitmask ("bitmask"; `build_seen_bitmask` with the
    shard's `id_offset`), its deduplicated id lists ("ids"), or the id
    lists for "sharded_dense".
    """
    steps = math.ceil(num_users / batch_size)
    impl = resolve_eval_impl(impl, item_size, device)
    vocab = model.vocab_rows()
    bf16 = is_bf16(dtype)
    shard_rows = model.item_table.shape[0]
    start = 0 if mesh is None else mesh.model_rank * shard_rows

    @torch.inference_mode()
    def evaluate(inputs, answers, seen):
        model.eval()
        sums = torch.zeros(9, dtype=torch.float32, device=device)
        per_batch = []
        # the dense path's operand, rounded once per pass under bf16
        dense_table = (rounded(model.item_table[:item_size], bf16) if impl == "dense" else None)
        for step in range(steps):
            idx = torch.arange(step * batch_size, (step + 1) * batch_size, device=device)
            idx = data_rows(idx, mesh)
            valid = (idx < num_users).float()
            safe = idx.clamp(max=num_users - 1)
            state = model.predict(inputs[safe], safe)[:, -1, :]
            if impl == "sharded_streaming":
                from bsarec_tpu_torch.parallel.logits import sharded_streaming_topk

                seen_batch = seen[safe]
                if seen_format == "ids":
                    seen_batch = seen_ids_to_bitmask(seen_batch, shard_rows, start, start == 0)
                _, topk_idx = sharded_streaming_topk(state, model.item_table, seen_batch, mesh,
                                                     k=TOP_K, max_valid_items=item_size)
            elif impl == "sharded_dense":
                from bsarec_tpu_torch.parallel.logits import sharded_masked_topk

                _, topk_idx = sharded_masked_topk(state, model.item_table, seen[safe], mesh,
                                                  k=TOP_K, max_valid_items=item_size, dtype=dtype)
            elif impl == "streaming":
                seen_batch = seen[safe]
                if seen_format == "ids":
                    seen_batch = seen_ids_to_bitmask(seen_batch, vocab)
                _, topk_idx = streaming_masked_topk(
                    state.contiguous(), model.item_table, seen_batch, k=TOP_K, n_valid=item_size
                )
            else:
                logits = rounded(state, bf16) @ dense_table.T
                _, topk_idx = masked_topk(logits, seen[safe])
            if collect_topk:
                per_batch.append(topk_idx.int())
            else:
                sums += topk_metrics(topk_idx, answers[safe], valid)
        if collect_topk:
            local = torch.stack(per_batch)  # [steps, b, k]
            if mesh is not None and mesh.data > 1:
                parts = [torch.empty_like(local) for _ in range(mesh.data)]
                dist.all_gather(parts, local, group=mesh.data_group)
                local = torch.stack(parts, dim=1)  # [steps, data, b, k]
            return local.reshape(-1, local.shape[-1])[:num_users]
        if mesh is not None:
            dist.all_reduce(sums, group=mesh.data_group)
        return sums

    return evaluate, steps, impl

"""The PREPRec trainer (counterpart of `bsarec_tpu/preprec/train.py`).

Per-model loss branches, validation every `epoch_test` epochs with
NDCG@topk[0] early stopping (patience `stop_early`), a checkpoint each
validation and of the best state, the final test from the best state,
concurrent training on a second dataset (`fit(second=...)`), transfer
(`load_transfer`), score dumps (`eval_scores`) and user embeddings. A
step is plain PyTorch: the gathers, the model's forward and backward,
Adam.

The loss branches copy the JAX package's, quirks included:
- sasrec: the pairwise BCE, plus `l2_emb` times the Frobenius norm of the
  item table (the norm, not its square);
- bert4rec: the cloze mask (`sampler.cloze_mask`), full-vocabulary
  logits [B, T, V+1] and a logsumexp CE over the masked positions. At
  `mask_prob` 0 (the CLI's default) nothing is masked and the loss is
  exactly 0, so the model never trains; so in both packages;
- newb4rec: the cloze mask, `itemnum // loss_size` uniform candidates a
  position plus the gold column, which is the masked input token, not the
  label (the JAX module's docstring says the label; its code, which the
  port follows, appends the input); a log-softmax over the TIME axis of
  the [B, T, C] logits, then the CE over candidates (`newb4rec_ce`);
- bprmf: each row's items in a random order as positives, per-position
  negatives, the negative log-sigmoid of their difference SUMMED;
- cl4srec: the pairwise BCE plus `aug_coef` times the InfoNCE of two
  views that `sampler.augment_batch` makes on the host from the numpy
  generator, after the epoch's users are drawn: the same users and views
  as the JAX package's for a seed.

The optimiser is the JAX package's optax chain `add_decayed_weights(wd)`
-> `scale_by_adam(0.9, 0.98, 1e-8)` -> `scale(-lr)`, which is
`torch.optim.Adam(lr, betas=(0.9, 0.98), eps=1e-8, weight_decay=wd)`: an
L2 term added to the gradient, not AdamW.

Randomness: the step's users (and CL4SRec's views) come from a numpy
generator seeded as the JAX package's (the same draws for the same
seed); negatives, cloze masks, candidates, permutations and the eval's
tie-break uniforms from a torch generator on the device, dropout from
torch's default generators (both seeded with `seed`), so none of those
matches JAX's threefry draws.

Checkpoints (`epoch={n}.ckpt`, `best.ckpt` under the write dir) are
`torch.save` of the model's `state_dict` in the reference's key layout:
the reference's own format, which the JAX package reads through
`bsarec_tpu.preprec.torch_import.import_preprec_torch` (its own trainer
writes msgpack). `load_transfer` reads such a checkpoint partially:
parameters it lacks (a fresh `fs_layer`) keep their init; under `fs_emb`
every other parameter is frozen and Adam steps `fs_layer` alone, so the
frozen ones stay bit-equal to the loaded values. The JAX package reads
its own msgpack there.

The triplet term takes each user's distance to itself (its own nearest
in-batch user), the norm of a zero vector: `torch.linalg.vector_norm`
gives it the subgradient 0, as the reference's torch norm does, where the
JAX package's `jnp.linalg.norm` has a NaN gradient that turns its step's
parameters into NaN. A deliberate divergence.

BSAREC_PREPREC_QUIRK186=1 reproduces the reference's week-popularity
gather of the positives and negatives with month periods, as the JAX
package's toggle does.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from bsarec_tpu_torch.config import resolve_device, set_fp32_matmul
from bsarec_tpu_torch.preprec.config import PrepRecConfig, PrepRecTrainConfig
from bsarec_tpu_torch.preprec.data import PrepRecDataset
from bsarec_tpu_torch.preprec.evaluate import (
    build_eval_inputs,
    final_state,
    grouped_metrics,
    make_eval_fn,
    metrics_from_ranks,
)
from bsarec_tpu_torch.preprec.models import PREPREC_REGISTRY, init_params
from bsarec_tpu_torch.preprec.sampler import (
    augment_batch,
    cloze_mask,
    draw_user_batches,
    newb4rec_candidates,
    permute_user_items,
    positional_negatives,
)


def masked_pair_bce(pos_logits, neg_logits, valid):
    """Mean over valid positions of softplus(-pos) + softplus(neg)
    (softplus as log(1 + e^x) = logaddexp(x, 0), as `jax.nn.softplus`)."""
    zero = torch.zeros((), dtype=pos_logits.dtype, device=pos_logits.device)
    denom = valid.sum().clamp(min=1.0)
    pos = (torch.logaddexp(-pos_logits, zero) * valid).sum() / denom
    neg = (torch.logaddexp(neg_logits, zero) * valid).sum() / denom
    return pos + neg


def masked_ce(logits, gold, valid):
    """Mean over valid positions of logsumexp(logits) - gold."""
    valid = valid.to(logits.dtype)
    return ((torch.logsumexp(logits, dim=-1) - gold) * valid).sum() / valid.sum().clamp(min=1.0)


def newb4rec_ce(logits, labels):
    """NewB4Rec's loss of raw logits [B, T, C]: a log-softmax over the
    TIME axis (dim 1), which shifts each candidate column differently, so
    the CE over candidates that follows does not cancel it; its target is
    the last (gold) column, at positions with a label."""
    x = logits - torch.logsumexp(logits, dim=1, keepdim=True)
    return masked_ce(x, x[..., -1], labels != 0)


def trajectory_regularisers(anchor, feats, cfg: PrepRecConfig):
    """The triplet and cosine terms over in-batch users: each user's
    `reg_num` nearest and farthest users by trajectory-feature distance
    (`feats` [B, F]; ties go to the lower batch index, as `lax.top_k`),
    compared through their final states `anchor` [B, H]."""
    d = torch.sqrt(((feats[:, None] - feats[None]) ** 2).sum(-1) + 1e-12)
    near = torch.sort(d, dim=1, stable=True).indices[:, :cfg.reg_num]
    far = torch.sort(-d, dim=1, stable=True).indices[:, :cfg.reg_num]
    pu, nu = anchor[near], anchor[far]  # [B, R, H]
    term = torch.zeros((), dtype=anchor.dtype, device=anchor.device)
    if cfg.triplet_loss:
        dp = torch.linalg.vector_norm(anchor[:, None] - pu, dim=-1)
        dn = torch.linalg.vector_norm(anchor[:, None] - nu, dim=-1)
        term = term + cfg.reg_coef * torch.relu(dp - dn).mean()
    if cfg.cos_loss:
        def cos(a, b):
            norms = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1)
            return (a * b).sum(-1) / (norms + 1e-12)

        term = term + cfg.reg_coef * (1 - cos(anchor[:, None], pu)).mean()
        term = term + cfg.reg_coef * torch.relu(cos(anchor[:, None], nu)).mean()
    return term


class PrepRecTrainer:
    def __init__(
        self,
        cfg: PrepRecConfig,
        tcfg: PrepRecTrainConfig,
        dataset: PrepRecDataset,
        logger,
        write_dir: str,
        pop_enc=None,
        eval_pop=None,
        usernegs: np.ndarray | None = None,
        user_feat: np.ndarray | None = None,  # [F, U] trajectory features for the regularisers
    ):
        if cfg.model not in PREPREC_REGISTRY:
            raise ValueError(f"unknown PREPRec model {cfg.model!r}; models: {sorted(PREPREC_REGISTRY)}")
        self.cfg, self.tcfg, self.ds = cfg, tcfg, dataset
        self.logger, self.write_dir = logger, write_dir
        self.pop_enc, self.eval_pop = pop_enc, eval_pop
        self.usernegs = usernegs
        self.device = resolve_device(tcfg.device)
        set_fp32_matmul()
        os.makedirs(write_dir, exist_ok=True)

        self.model = PREPREC_REGISTRY[cfg.model](cfg)
        init_params(self.model, torch.Generator().manual_seed(tcfg.seed))
        self.model.to(self.device)
        torch.manual_seed(tcfg.seed)  # nn.Dropout's generators
        self.generator = torch.Generator(device=self.device).manual_seed(tcfg.seed)
        self.np_rng = np.random.default_rng(tcfg.seed)
        self.optimizer = self._adam(self.model.parameters())
        self._loss = {"newrec": self.newrec_loss, "sasrec": self.sasrec_loss,
                      "bert4rec": self.bert4rec_loss, "newb4rec": self.newb4rec_loss,
                      "bprmf": self.bprmf_loss, "cl4srec": self.cl4srec_loss}[cfg.model]

        self.num_batch = dataset.usernum // tcfg.batch_size
        self._dev = {k: torch.from_numpy(getattr(dataset, k).astype(np.int64)).to(self.device)
                     for k in ("train_seq", "train_t1", "train_t2", "train_te")}
        self.user_feat = (None if user_feat is None else
                          torch.from_numpy(np.asarray(user_feat.T, np.float32)).to(self.device))
        self._eval_arrays = {}
        self._eval_fn = self._score_fn = None

    def _adam(self, params):
        return torch.optim.Adam(params, lr=self.tcfg.lr, betas=(0.9, 0.98), eps=1e-8,
                                weight_decay=self.tcfg.wd)

    # ---- a training step ---------------------------------------------------
    def newrec_loss(self, users: torch.Tensor, neg: torch.Tensor | None = None) -> torch.Tensor:
        """The loss of one step's users [B] (1-based, on the device) in the
        model's current mode; `neg` [B, L] replaces the drawn negatives."""
        cfg, dev = self.cfg, self._dev
        rows = dev["train_seq"][users - 1]  # [B, L+1]
        t1 = (dev["train_t1"][users - 1] - 1 - cfg.lag // 4).clamp(min=0)
        t2 = (dev["train_t2"][users - 1] - cfg.lag).clamp(min=0)
        te = dev["train_te"][users - 1]
        seq, pos = rows[:, :-1], rows[:, 1:]
        if neg is None:
            neg = positional_negatives(self.generator, rows, pos, self.ds.itemnum)
        seq_feats = self.pop_enc(seq, t1[:, :-1], t2[:, :-1])
        if cfg.prev_time:
            m1, m2 = t1[:, :-1], t2[:, :-1]
        else:
            m1, m2 = t1[:, 1:], t2[:, 1:]
        if os.environ.get("BSAREC_PREPREC_QUIRK186"):
            # the reference's gather: the positives' and negatives' WEEK
            # popularity indexed by MONTH periods
            m2 = m1
        pos_l, neg_l, feats = self.model(seq_feats, seq == 0, self.pop_enc(pos, m1, m2),
                                         self.pop_enc(neg, m1, m2),
                                         te if cfg.time_embed else None)
        if cfg.only_reg:
            loss = 0.0 * pos_l.sum()
        else:
            loss = masked_pair_bce(pos_l, neg_l, (pos != 0).to(pos_l.dtype))
        if (cfg.triplet_loss or cfg.cos_loss) and self.user_feat is not None:
            loss = loss + trajectory_regularisers(feats[:, -1, :], self.user_feat[users - 1], cfg)
        return loss

    def _seq_pos_neg(self, users, neg):
        rows = self._dev["train_seq"][users - 1]
        seq, pos = rows[:, :-1], rows[:, 1:]
        if neg is None:
            neg = positional_negatives(self.generator, rows, pos, self.ds.itemnum)
        return seq, pos, neg

    def sasrec_loss(self, users, neg=None):
        seq, pos, neg = self._seq_pos_neg(users, neg)
        pos_l, neg_l = self.model(seq, pos, neg)
        loss = masked_pair_bce(pos_l, neg_l, (pos != 0).to(pos_l.dtype))
        if self.tcfg.l2_emb:  # the Frobenius norm, not its square
            loss = loss + self.tcfg.l2_emb * torch.linalg.vector_norm(self.model.item_emb.weight)
        return loss

    def cl4srec_loss(self, users, aug1, aug2, neg=None):
        seq, pos, neg = self._seq_pos_neg(users, neg)
        pos_l, neg_l, aug = self.model(seq, aug1, aug2, pos, neg)
        return masked_pair_bce(pos_l, neg_l, (pos != 0).to(pos_l.dtype)) + self.cfg.aug_coef * aug

    def _cloze(self, rows, masked, labels):
        if masked is None:
            masked, labels = cloze_mask(self.generator, rows, self.ds.itemnum, self.cfg.mask_prob)
        return masked, labels

    def bert4rec_loss(self, users, masked=None, labels=None):
        rows = self._dev["train_seq"][users - 1][:, 1:]
        masked, labels = self._cloze(rows, masked, labels)
        logits = self.model(masked)
        logits = logits.reshape(-1, logits.shape[-1])
        flat = labels.reshape(-1)
        return masked_ce(logits, logits.gather(1, flat[:, None])[:, 0], flat != 0)

    def newb4rec_loss(self, users, masked=None, labels=None, cands=None):
        dev = self._dev
        rows = dev["train_seq"][users - 1][:, 1:]
        t1, t2 = dev["train_t1"][users - 1][:, 1:], dev["train_t2"][users - 1][:, 1:]
        masked, labels = self._cloze(rows, masked, labels)
        if cands is None:
            compare = max(self.ds.itemnum // self.cfg.loss_size, 1)
            cands = newb4rec_candidates(self.generator, masked, self.ds.itemnum, compare)
        cand_feats = self.pop_enc(cands, t1[..., None].expand(cands.shape),
                                  t2[..., None].expand(cands.shape))
        logits = self.model(self.pop_enc(masked, t1, t2), masked > 0, cand_feats)
        return newb4rec_ce(logits, labels)

    def bprmf_loss(self, users, pos=None, neg=None):
        rows = self._dev["train_seq"][users - 1]
        if pos is None:
            pos = permute_user_items(self.generator, rows)
        if neg is None:
            neg = positional_negatives(self.generator, rows, pos, self.ds.itemnum)
        pos_l, neg_l = self.model(users, pos, neg)
        terms = F.logsigmoid(pos_l - neg_l)
        return -torch.where(pos != 0, terms, torch.zeros_like(terms)).sum()  # a sum, not a mean

    def loss(self, users: torch.Tensor, **draws) -> torch.Tensor:
        """The model's loss on `users` [B] (1-based, on the device) in its
        current mode. `draws` replace the branch's random draws (neg, pos,
        masked and labels, cands) or carry CL4SRec's views (aug1, aug2)."""
        return self._loss(users, **draws)

    def step(self, users: torch.Tensor, neg: torch.Tensor | None = None, **draws) -> torch.Tensor:
        """One Adam step on `users`; returns the loss before the update."""
        if neg is not None:
            draws["neg"] = neg
        loss = self.loss(users, **draws)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    # ---- API ----------------------------------------------------------------
    def epoch_batches(self):
        """An epoch's users [steps, B] and, for CL4SRec, its two views
        [steps, B, L] (else None), drawn from the numpy generator in the
        JAX package's order: the users, then the views of their histories
        (lengths seq_lens - 1)."""
        steps = max(int(self.num_batch * self.tcfg.fs_prop), 1)
        users = draw_user_batches(self.np_rng, self.ds.eligible_users, steps, self.tcfg.batch_size)
        if self.cfg.model != "cl4srec":
            return users, None
        rows = self.ds.train_seq[users - 1][:, :, :-1]
        lens = self.ds.seq_lens[users - 1] - 1
        a1, a2 = augment_batch(self.np_rng, rows.reshape(-1, rows.shape[-1]),
                               np.maximum(lens.reshape(-1), 0))
        return users, (a1.reshape(rows.shape), a2.reshape(rows.shape))

    def train_epoch(self) -> float:
        users, views = self.epoch_batches()

        def dev(a):
            return torch.from_numpy(a.astype(np.int64)).to(self.device)

        users = dev(users)
        if views is not None:
            views = [dev(v) for v in views]
        self.model.train()
        total = torch.zeros((), device=self.device)
        for s in range(users.shape[0]):
            draws = {} if views is None else {"aug1": views[0][s], "aug2": views[1][s]}
            total += self.step(users[s], **draws)
        return float(total / users.shape[0])

    def _eval_batch(self) -> int:
        """The eval scoring batch (`--eval_batch_size`); 0 picks 64 for
        sampled negatives and 32 for the full-catalog sweep."""
        if self.tcfg.eval_batch_size > 0:
            return self.tcfg.eval_batch_size
        return 64 if self.cfg.eval_method != 3 else 32

    def _arrays(self, mode: str) -> dict:
        if mode not in self._eval_arrays:
            inputs = build_eval_inputs(self.ds, self.cfg, mode, self.usernegs)
            self._eval_arrays[mode] = inputs.to_device(self.device)
        return self._eval_arrays[mode]

    def _make_eval_fn(self, return_scores: bool):
        return make_eval_fn(self.model, self.cfg, self.pop_enc, self.eval_pop, self._eval_batch(),
                            self.ds.usernum, self.ds.itemnum,
                            item_chunk=self.tcfg.eval_item_chunk, return_scores=return_scores)

    def _eval(self, mode: str) -> np.ndarray:
        if self._eval_fn is None:
            self._eval_fn = self._make_eval_fn(False)
        return self._eval_fn(self.generator, self._arrays(mode)).cpu().numpy()

    def eval_scores(self, mode: str) -> np.ndarray:
        """The raw score rows of `mode`'s candidates: [U, C] under sampled
        negatives, [U, V+1] under the full catalog (--save_scores)."""
        if self._score_fn is None:
            self._score_fn = self._make_eval_fn(True)
        return self._score_fn(self.generator, self._arrays(mode)).cpu().numpy()

    @torch.no_grad()
    def user_embeddings(self, mode: str, batch: int = 512) -> np.ndarray:
        """[U, H] final encoder states of NewRec, the transferable user
        representation (--export_user_embed), in batches of `batch` users;
        the last batch is filled up with users from the start (indices
        modulo U), as the JAX package's fixed-shape batches are."""
        if self.cfg.model != "newrec":
            raise ValueError("user embeddings are NewRec's (--model newrec)")
        a = self._arrays(mode)
        n = self.ds.usernum
        self.model.eval()
        chunks = []
        for lo in range(0, n, batch):
            idx = torch.arange(lo, lo + batch, device=self.device) % n
            state = final_state(self.model, self.cfg, self.pop_enc, a["seqs"][idx], a["t1"][idx],
                                a["t2"][idx], a["te"][idx])
            chunks.append(state[: min(batch, n - lo)])
        return torch.cat(chunks).cpu().numpy()

    def evaluate(self, mode: str, userpop: np.ndarray | None = None):
        t0 = time.perf_counter()
        ranks = self._eval(mode)
        seconds = time.perf_counter() - t0
        self.logger.info(f"{mode} eval: {ranks.size} users in {seconds:.3f}s "
                         f"({ranks.size / seconds:.1f} users/s)")
        metrics = metrics_from_ranks(ranks, self.cfg.topk)
        if self.cfg.eval_quality and userpop is not None:
            self.logger.info(str(grouped_metrics(ranks, userpop, self.cfg)))
        return metrics, ranks

    def host_state(self) -> dict[str, torch.Tensor]:
        """A CPU copy of the model's state_dict (Adam updates the live one in place)."""
        return {k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()}

    def adopt(self, other: "PrepRecTrainer") -> None:
        """Take over another trainer's model and optimizer (the same
        objects: parameters and Adam state are shared, nothing is copied).
        This trainer keeps its own dataset, popularity tables, generators
        and eval arrays."""
        self.model, self.optimizer = other.model, other.optimizer
        self._eval_fn = self._score_fn = None

    def fit(self, userpop=None, second: "PrepRecTrainer | None" = None):
        """Train with periodic eval and early stopping, then test from the
        best state. With `second`, each epoch runs this dataset's batches,
        then the second dataset's, through the same parameters and
        optimizer."""
        cfg, tcfg = self.cfg, self.tcfg
        best_ndcg, best_state, stop = 0.0, self.host_state(), 0
        mode = "valid" if not cfg.sparse or cfg.override_sparse else "test"
        if tcfg.first_eval:
            m0, _ = self.evaluate(mode, userpop)
            self.logger.info(f"pre-train {mode}: {m0}")
        for epoch in range(1, tcfg.num_epochs + 1):
            t0 = time.perf_counter()
            loss = self.train_epoch()
            seconds = time.perf_counter() - t0
            examples = max(int(self.num_batch * tcfg.fs_prop), 1) * tcfg.batch_size
            if second is not None:
                second.adopt(self)
                loss2 = second.train_epoch()
                self.adopt(second)
                self.logger.info(f"epoch {epoch} dataset-2 loss {loss2:.4f}")
            self.logger.info(f"epoch {epoch}: loss {loss:.4f} ({seconds:.2f}s, "
                             f"{examples / seconds:.1f} examples/s)")
            if epoch % tcfg.epoch_test == 0:
                metrics, _ = self.evaluate(mode, userpop)
                ndcg, hr = metrics[0]
                self.logger.info(
                    f"epoch {epoch} {mode}: NDCG@{cfg.topk[0]} {ndcg}, HR@{cfg.topk[0]} {hr}")
                if second is not None:
                    m2, _ = second.evaluate(mode)
                    self.logger.info(f"epoch {epoch} {mode} dataset-2: {m2}")
                torch.save(self.host_state(), os.path.join(self.write_dir, f"epoch={epoch}.ckpt"))
                if ndcg > best_ndcg:
                    best_ndcg, best_state, stop = ndcg, self.host_state(), 0
                else:
                    stop += 1
            if stop >= tcfg.stop_early:
                break
        if best_ndcg > 0:
            torch.save(best_state, os.path.join(self.write_dir, "best.ckpt"))
            if not tcfg.state_override:
                self.model.load_state_dict(best_state)
        if tcfg.train_only:
            return None, None
        metrics, ranks = self.evaluate("test", userpop)
        for (ndcg, hr), k in zip(metrics, cfg.topk):
            self.logger.info(f"Test NDCG@{k}: {ndcg}, HR@{k}: {hr}")
        return metrics, ranks

    # ---- transfer (zero and few-shot) -----------------------------------------
    def load_transfer(self, path: str) -> None:
        """Load weights trained on another domain: a torch state_dict in the
        reference's layout (the popularity and fixed position tables are
        not parameters, so nothing is dropped). The load is partial:
        parameters the checkpoint lacks keep their values, keys the model
        lacks are ignored, a shape that differs raises. Under `fs_emb`
        every parameter but `fs_layer`'s is frozen. The optimizer starts
        afresh, over `fs_layer` alone under `fs_emb`."""
        loaded = torch.load(path, map_location="cpu")
        with torch.no_grad():
            for name, value in self.model.state_dict().items():
                if name in loaded:
                    if loaded[name].shape != value.shape:
                        raise ValueError(f"{name}: checkpoint shape {tuple(loaded[name].shape)}, "
                                         f"model {tuple(value.shape)}")
                    value.copy_(loaded[name])
        params = list(self.model.parameters())
        if self.cfg.fs_emb:
            for name, p in self.model.named_parameters():
                p.requires_grad_(name.startswith("fs_layer."))
            params = [p for p in params if p.requires_grad]
        self.optimizer = self._adam(params)

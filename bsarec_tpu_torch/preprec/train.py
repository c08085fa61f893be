"""The PREPRec trainer for NewRec (counterpart of `bsarec_tpu/preprec/train.py`).

Validation every `epoch_test` epochs with NDCG@topk[0] early stopping
(patience `stop_early`), a checkpoint each validation and of the best
state, the final test from the best state. A step is plain PyTorch: the
popularity gathers, the model's forward and backward, Adam.

The optimiser is the JAX package's optax chain `add_decayed_weights(wd)`
-> `scale_by_adam(0.9, 0.98, 1e-8)` -> `scale(-lr)`, which is
`torch.optim.Adam(lr, betas=(0.9, 0.98), eps=1e-8, weight_decay=wd)`: an
L2 term added to the gradient, not AdamW.

Randomness: the step's users come from a numpy generator seeded as the
JAX package's (the same users for the same seed); negatives and the
eval's tie-break uniforms from a torch generator on the device, dropout
from torch's default generators (both seeded with `seed`), so neither
matches JAX's threefry draws.

Checkpoints (`epoch={n}.ckpt`, `best.ckpt` under the write dir) are
`torch.save` of the model's `state_dict` in the reference's key layout:
the reference's own format, which the JAX package reads through
`bsarec_tpu.preprec.torch_import.import_preprec_torch` (its own trainer
writes msgpack).

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

from bsarec_tpu_torch.config import resolve_device, set_fp32_matmul
from bsarec_tpu_torch.preprec.config import PrepRecConfig, PrepRecTrainConfig
from bsarec_tpu_torch.preprec.data import PrepRecDataset
from bsarec_tpu_torch.preprec.evaluate import (
    build_eval_inputs,
    grouped_metrics,
    make_eval_fn,
    metrics_from_ranks,
)
from bsarec_tpu_torch.preprec.models import PREPREC_REGISTRY, init_params
from bsarec_tpu_torch.preprec.sampler import draw_user_batches, positional_negatives


def masked_pair_bce(pos_logits, neg_logits, valid):
    """Mean over valid positions of softplus(-pos) + softplus(neg)
    (softplus as log(1 + e^x) = logaddexp(x, 0), as `jax.nn.softplus`)."""
    zero = torch.zeros((), dtype=pos_logits.dtype, device=pos_logits.device)
    denom = valid.sum().clamp(min=1.0)
    pos = (torch.logaddexp(-pos_logits, zero) * valid).sum() / denom
    neg = (torch.logaddexp(neg_logits, zero) * valid).sum() / denom
    return pos + neg


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
            raise NotImplementedError(
                f"PREPRec model {cfg.model!r} is not ported yet (ROADMAP A5b); "
                f"ported: {sorted(PREPREC_REGISTRY)}")
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
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=tcfg.lr, betas=(0.9, 0.98),
                                          eps=1e-8, weight_decay=tcfg.wd)

        self.num_batch = dataset.usernum // tcfg.batch_size
        self._dev = {k: torch.from_numpy(getattr(dataset, k).astype(np.int64)).to(self.device)
                     for k in ("train_seq", "train_t1", "train_t2", "train_te")}
        self.user_feat = (None if user_feat is None else
                          torch.from_numpy(np.asarray(user_feat.T, np.float32)).to(self.device))
        self._eval_arrays = {}
        self._eval_fn = None

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

    def step(self, users: torch.Tensor, neg: torch.Tensor | None = None) -> torch.Tensor:
        """One Adam step on `users`; returns the loss before the update."""
        loss = self.newrec_loss(users, neg)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    # ---- API ----------------------------------------------------------------
    def train_epoch(self) -> float:
        steps = max(int(self.num_batch * self.tcfg.fs_prop), 1)
        users = draw_user_batches(self.np_rng, self.ds.eligible_users, steps, self.tcfg.batch_size)
        users = torch.from_numpy(users.astype(np.int64)).to(self.device)
        self.model.train()
        total = torch.zeros((), device=self.device)
        for s in range(steps):
            total += self.step(users[s])
        return float(total / steps)

    def _eval_batch(self) -> int:
        """The eval scoring batch (`--eval_batch_size`); 0 picks 64 for
        sampled negatives and 32 for the full-catalog sweep."""
        if self.tcfg.eval_batch_size > 0:
            return self.tcfg.eval_batch_size
        return 64 if self.cfg.eval_method != 3 else 32

    def _eval(self, mode: str) -> np.ndarray:
        if mode not in self._eval_arrays:
            inputs = build_eval_inputs(self.ds, self.cfg, mode, self.usernegs)
            self._eval_arrays[mode] = inputs.to_device(self.device)
        if self._eval_fn is None:
            self._eval_fn = make_eval_fn(
                self.model, self.cfg, self.pop_enc, self.eval_pop, self._eval_batch(),
                self.ds.usernum, self.ds.itemnum, item_chunk=self.tcfg.eval_item_chunk)
        return self._eval_fn(self.generator, self._eval_arrays[mode]).cpu().numpy()

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

    def fit(self, userpop=None):
        """Train with periodic eval and early stopping, then test from the best state."""
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
            self.logger.info(f"epoch {epoch}: loss {loss:.4f} ({seconds:.2f}s, "
                             f"{examples / seconds:.1f} examples/s)")
            if epoch % tcfg.epoch_test == 0:
                metrics, _ = self.evaluate(mode, userpop)
                ndcg, hr = metrics[0]
                self.logger.info(
                    f"epoch {epoch} {mode}: NDCG@{cfg.topk[0]} {ndcg}, HR@{cfg.topk[0]} {hr}")
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

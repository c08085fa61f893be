"""Trainer (counterpart of `bsarec_tpu/train/trainer.py`).

Mirrors the reference `Trainer` surface (`src/trainers.py:9-60`):
`train(epoch)` / `valid(epoch)` / `test(epoch)` / `save` / `load`, plus
`fit()`, the run loop of `src/main.py:51-64` (early stop on NDCG@20, reload
the best checkpoint, final test), and full train-state snapshots for
`--resume`.

`--mesh data:N,model:M` (`core/mesh.py`) runs on a ("data", "model")
mesh of N * M ranks, as the JAX Trainer's mesh branch
(`bsarec_tpu/train/trainer.py:47-107,242-265,396-464`): batches split
over "data"; the item table's rows and their Adam moments split over
"model" where M > 1 divides `item_size` (BERT4Rec's table, one row
longer, stays whole and dense); dense parameters replicated, their
gradients averaged over "data". Every rank builds the full model from
the seed, as the single run does, and keeps its rows, so the initial
weights are the single run's. Files keep the single-card layout: the
table and its moments are gathered on save and written by rank 0, and
each rank slices its rows back out on load.

`--multihost` (`TrainConfig.multihost`, JAX's `trainer.py:119-141,267-306`)
keeps the training set on the host: a `data.multihost.HostShardedDataset`
of its arrays, from which every step moves this data rank's rows of the
global batch to the device (`train/loop.py:build_host_fed_epoch`). The
epochs draw what the device-resident epochs draw, in their order, so
the losses are theirs bit for bit, alone and under a mesh. DuoRec's and
FEARec's same-target view is drawn on the host each epoch and stays
there as a field. Eval stays device-resident, and snapshots and
`resume()` are the same.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from bsarec_tpu_torch.config import ModelConfig, TrainConfig, resolve_device, set_fp32_matmul
from bsarec_tpu_torch.core import mesh as meshlib
from bsarec_tpu_torch.data.multihost import HostShardedDataset
from bsarec_tpu_torch.data.pipeline import SeqRecData
from bsarec_tpu_torch.models import build_model
from bsarec_tpu_torch.ops import rank
from bsarec_tpu_torch.ops.losses import STREAMING_CE_MIN_VOCAB, resolve_loss_impl
from bsarec_tpu_torch.ops.topk import metrics_from_sums
from bsarec_tpu_torch.train import checkpoint as ckpt
from bsarec_tpu_torch.train.loop import (build_eval_fn, build_host_fed_epoch, build_train_epoch,
                                         make_optimizer)
from bsarec_tpu_torch.utils.early_stopping import EarlyStopping
from bsarec_tpu_torch.utils.profiling import Throughput, annotate


class Trainer:
    def __init__(self, model_cfg: ModelConfig, train_cfg: TrainConfig, data: SeqRecData,
                 logger, checkpoint_path: str = "output/model.ckpt"):
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.data = data
        self.logger = logger
        self.checkpoint_path = checkpoint_path
        self.device = resolve_device(train_cfg.device)
        mesh_cfg = meshlib.parse_mesh_spec(train_cfg.mesh)
        self.mesh = meshlib.make_mesh(mesh_cfg, self.device.type) if mesh_cfg else None
        if self.mesh is not None:
            self.device = self.mesh.device
        set_fp32_matmul()

        # the vocab-sharded rule and the impls under it (JAX's `_vocab_sharded`
        # and `mesh_impl`): per-shard streaming kernels or each shard's dense
        # logits; BERT4Rec's table stays whole and takes the dense paths
        m = 1 if self.mesh is None else self.mesh.model
        self._vocab_sharded = m > 1 and model_cfg.item_size % m == 0
        self.table_sharded = self._vocab_sharded and model_cfg.model_type.lower() != "bert4rec"
        if self._vocab_sharded:
            big = model_cfg.item_size >= STREAMING_CE_MIN_VOCAB and self.device.type == "cuda"

            def mesh_impl(requested: str) -> str:
                if not self.table_sharded:
                    return "dense"
                if requested in ("streaming", "sharded_streaming") or (requested == "auto" and big):
                    return "sharded_streaming"
                return "sharded_dense"

            model_cfg = model_cfg.replace(loss_impl=mesh_impl(model_cfg.loss_impl))
            train_cfg = dataclasses.replace(train_cfg, eval_impl=mesh_impl(train_cfg.eval_impl))
            self.model_cfg, self.train_cfg = model_cfg, train_cfg

        gen = torch.Generator().manual_seed(train_cfg.seed)
        self.model = build_model(model_cfg, generator=gen, prng=train_cfg.prng)
        if self.table_sharded:
            self.model.shard_item_table(self.mesh)
        self.model.to(self.device)
        n_params = sum(p.numel() for p in self.model.parameters())
        if self.table_sharded:
            n_params += (self.model.vocab_rows() - self.model.item_table.shape[0]) * \
                self.model.item_table.shape[1]
        logger.info(f"Total Parameters: {n_params}")
        if self.mesh is not None:
            table = (f"item table rows split over {m}" if self.table_sharded
                     else "item table replicated")
            logger.info(f"mesh: {self.mesh.shape} ({self.device.type}, {table}; "
                        f"loss {model_cfg.loss_impl}, eval {train_cfg.eval_impl})")

        # nn.Dropout draws from torch's default generators; the epoch order,
        # the negatives, BERT4Rec's cloze positions and the fused dropout's
        # seeds from this one; the same-target view from np_rng, as in JAX.
        # A snapshot keeps the states of all of them. Under a mesh every rank
        # draws the same from this one and from np_rng; torch's default
        # generators are seeded per data rank, so the data ranks draw other
        # nn.Dropout masks and the ranks of one model group the same
        torch.manual_seed(self._default_seed())
        self.generator = torch.Generator(device=self.device).manual_seed(train_cfg.seed)
        self.np_rng = np.random.default_rng(train_cfg.seed)
        self.optimizer = make_optimizer(self.model.parameters(), train_cfg)
        self.loss_impl = resolve_loss_impl(model_cfg.loss_impl, model_cfg.item_size, self.device)
        self._train_dev = None  # moved to the device by the first train(), but under multihost
        self._host_ds = None
        build_epoch = build_host_fed_epoch if train_cfg.multihost else build_train_epoch
        self._epoch_fn, self.steps_per_epoch = build_epoch(
            self.model, self.optimizer, train_cfg.batch_size, data.train.num_samples, self.device,
            remat=train_cfg.remat, mesh=self.mesh)
        if train_cfg.multihost:
            fields = {"input_ids": data.train.input_ids, "answers": data.train.answers}
            if self.model.reads_users:
                fields["user_ids"] = data.train.user_ids
            index, count = (0, 1) if self.mesh is None else (self.mesh.data_rank, self.mesh.data)
            self._host_ds = HostShardedDataset(fields, train_cfg.batch_size, train_cfg.seed,
                                               process_index=index, process_count=count)
        self._announced = False
        # early-stopping state restored by resume(), consumed by fit()
        self._resume_stopper = None

        # streaming eval stages one [U, ceil(V/32)] bitmask per split (of the
        # rank's shard under a sharded table); above the limit the [U, S] id
        # lists stay on the device and each batch's bitmask is built there
        # (1M items x 50k users would stage 2 x 6.25 GB)
        rows = self.model.item_table.shape[0]
        start = self.mesh.model_rank * rows if self.table_sharded else 0
        staged_bytes = 2 * data.valid.num_users * rank.seen_words(rows) * 4
        self._seen_format = "ids" if staged_bytes > rank.SEEN_BITMASK_STAGE_LIMIT else "bitmask"
        self._eval_fn, _, self.eval_impl = self._build_eval(collect_topk=False)

        self._eval_dev = {}
        for split_name in ("valid", "test"):
            split = getattr(data, split_name)
            streaming = self.eval_impl in ("streaming", "sharded_streaming")
            if streaming and self._seen_format == "ids":
                seen = rank.dedupe_seen_rows(split.seen_items)
                if split_name == "valid":
                    logger.info(
                        f"eval seen masks: on-device per-batch bitmasks "
                        f"(staging both splits would take {staged_bytes >> 20} MiB)"
                    )
            elif streaming:
                seen = rank.build_seen_bitmask(split.seen_items, rows, id_offset=start,
                                               mask_item0=start == 0)
            else:
                seen = split.seen_items
            self._eval_dev[split_name] = {
                "inputs": torch.from_numpy(split.input_ids).long().to(self.device),
                "answers": torch.from_numpy(split.answers).long().to(self.device),
                "seen": torch.from_numpy(seen).to(self.device),
            }

    def _default_seed(self) -> int:
        """The seed of torch's default generators: the run's seed, or on
        data rank d > 0 of a mesh one derived from (seed, d)."""
        if self.mesh is None or self.mesh.data_rank == 0:
            return self.train_cfg.seed
        return int(np.random.SeedSequence([self.train_cfg.seed, self.mesh.data_rank])
                   .generate_state(1, np.uint64)[0] >> 1)

    @property
    def writes_files(self) -> bool:
        """True on the rank that writes the run's files (rank 0 of a mesh)."""
        return self.mesh is None or self.mesh.is_writer

    def _build_eval(self, collect_topk: bool):
        return build_eval_fn(
            self.model, self.model_cfg.item_size, self.train_cfg.eval_batch_size,
            self.data.valid.num_users, self.device, impl=self.train_cfg.eval_impl,
            collect_topk=collect_topk, seen_format=self._seen_format,
            dtype=self.model_cfg.compute_dtype, mesh=self.mesh,
        )

    # ---- reference-API surface -----------------------------------------
    def _announce(self) -> None:
        """The run's loss, dropout and input lines, logged by the first train()."""
        ce = f"full-catalog CE ({self.loss_impl}, {self.device.type})"
        self.logger.info(f"loss: {self.model.loss_name(ce)}")
        fused = self.model.dropout_state.fused
        self.logger.info(
            "dropout: fused kernel (--prng rbg, BSAREC_DROPOUT=pallas; "
            f"{'CUDA kernel' if self.device.type == 'cuda' else 'plain version on the CPU'})"
            if fused else "dropout: torch nn.Dropout")
        if self._host_ds is not None:
            ds = self._host_ds
            self.logger.info(
                f"input: host-fed (--multihost), the training set on the host; data rank "
                f"{ds.process_index} of {ds.process_count} moves {ds.local_batch} rows of each "
                f"batch of {ds.batch_size} to {self.device.type}")
        self._announced = True

    def train(self, epoch: int) -> float:
        if not self._announced:
            self._announce()
        if self._host_ds is not None:
            return self._train_host_fed(epoch)
        if self._train_dev is None:
            self._train_dev = {
                "inputs": torch.from_numpy(self.data.train.input_ids).long().to(self.device),
                "answers": torch.from_numpy(self.data.train.answers).long().to(self.device),
                "users": torch.from_numpy(self.data.train.user_ids).long().to(self.device),
            }
        dev = self._train_dev
        sem = None
        if self.model.reads_same_target:
            sem = torch.from_numpy(self.data.sample_same_target(self.np_rng)).long().to(self.device)
        # the epoch's one read back to the host; the user ids only for a
        # model that reads them (a gather a step saved for the others)
        users = dev["users"] if self.model.reads_users else None
        with meshlib.using_mesh(self.mesh):
            loss = float(self._epoch_fn(dev["inputs"], dev["answers"], self.generator, users, sem))
        return self._log_loss(epoch, loss)

    def _train_host_fed(self, epoch: int) -> float:
        """One epoch of `--multihost`: the same-target view drawn on the
        host into the dataset's fields, then the host-fed epoch."""
        if self.model.reads_same_target:
            self._host_ds.fields["same_target"] = self.data.sample_same_target(self.np_rng)
        with meshlib.using_mesh(self.mesh):
            loss = float(self._epoch_fn(self._host_ds, self.generator))
        return self._log_loss(epoch, loss)

    def _log_loss(self, epoch: int, loss: float) -> float:
        if (epoch + 1) % self.train_cfg.log_freq == 0:
            self.logger.info(str({"epoch": epoch, "rec_loss": f"{loss:.4f}"}))
        return loss

    def evaluate_sums(self, split: str) -> np.ndarray:
        """The [9] metric sums of one eval pass over `split`."""
        dev = self._eval_dev[split]
        with meshlib.using_mesh(self.mesh):
            return self._eval_fn(dev["inputs"], dev["answers"], dev["seen"]).cpu().numpy()

    def _evaluate(self, split: str, epoch: int):
        t0 = time.perf_counter()
        sums = self.evaluate_sums(split)  # the copy to the host waits for the device
        seconds = time.perf_counter() - t0
        metrics = metrics_from_sums(sums)
        post_fix = {"Epoch": epoch}
        for k in (5, 10, 20):
            post_fix[f"HR@{k}"] = f"{metrics[f'HR@{k}']:.4f}"
            post_fix[f"NDCG@{k}"] = f"{metrics[f'NDCG@{k}']:.4f}"
        self.logger.info(str(post_fix))
        self.logger.info(
            f"eval {split}: {int(sums[-1])} users in {seconds:.3f}s "
            f"({self.eval_impl}, {self.device.type})"
        )
        scores = [
            metrics["HR@5"], metrics["NDCG@5"],
            metrics["HR@10"], metrics["NDCG@10"],
            metrics["HR@20"], metrics["NDCG@20"],
        ]
        return scores, str(post_fix)

    def valid(self, epoch: int):
        return self._evaluate("valid", epoch)

    def test(self, epoch: int):
        return self._evaluate("test", epoch)

    def export_topk(self, split: str = "test") -> np.ndarray:
        """[num_users, 20] int32 top-k item ids per user: full-catalog
        scoring, seen items at 0.0, the ranking the metrics come from."""
        fn, _, _ = self._build_eval(collect_topk=True)
        dev = self._eval_dev[split]
        with meshlib.using_mesh(self.mesh):
            return fn(dev["inputs"], dev["answers"], dev["seen"]).cpu().numpy()

    def dump_sequence_outputs(self, out_dir: str, tag: str, split: str = "test",
                              batch_size: int | None = None) -> int:
        """Per-layer sequence-output dumps in the reference's layout
        (`<out_dir>/<tag>/{L}layer_{i}iter.npy`, each [b, L, H] float32,
        the input of its `figure3.ipynb`): eval-mode all-layers forwards
        over the `split` inputs, one file per layer output (the embedding
        output included) and eval batch (`main --dump_seqout`). The last
        batch is not padded: its files hold the rows there are, as JAX's
        (`bsarec_tpu/train/trainer.py:367-391`) after its slice. Returns
        the number of batches written."""
        from bsarec_tpu_torch.utils.visualize import dump_sequence_outputs as dump

        b = batch_size or self.train_cfg.eval_batch_size
        inputs = (self.data.test if split == "test" else self.data.valid).input_ids
        n_batches = -(-len(inputs) // b)
        self.model.eval()
        with torch.inference_mode(), meshlib.using_mesh(self.mesh):
            for i in range(n_batches):
                batch = torch.from_numpy(inputs[i * b:(i + 1) * b]).long().to(self.device)
                outs = self.model(batch, all_layers=True)
                if self.writes_files:
                    dump([o.cpu().numpy() for o in outs], out_dir, tag, i)
        return n_batches

    # ---- the single-card layout of a sharded table ----------------------------
    _TABLE = "item_embeddings.weight"

    def _gather_rows(self, local: torch.Tensor) -> torch.Tensor:
        """The full [V, ...] tensor from every model rank's rows."""
        parts = [torch.empty_like(local) for _ in range(self.mesh.model)]
        dist.all_gather(parts, local.detach().contiguous(), group=self.mesh.model_group)
        return torch.cat(parts)

    def _own_rows(self, full: torch.Tensor) -> torch.Tensor:
        rows = full.shape[0] // self.mesh.model
        return full[self.mesh.model_rank * rows:(self.mesh.model_rank + 1) * rows].clone()

    def _table_index(self) -> int:
        """The item table's index in the optimizer's state_dict."""
        params = [p for g in self.optimizer.param_groups for p in g["params"]]
        return next(i for i, p in enumerate(params) if p is self.model.item_table)

    def full_state_dict(self) -> dict:
        """The model's state_dict in the single-card layout (a sharded table
        gathered; collective under a mesh)."""
        sd = self.model.state_dict()
        if self.table_sharded:
            sd = dict(sd) | {self._TABLE: self._gather_rows(sd[self._TABLE])}
        return sd

    def _full_opt_state(self) -> dict:
        opt = self.optimizer.state_dict()
        if not self.table_sharded:
            return opt
        i = self._table_index()
        table_state = dict(opt["state"][i])
        for key in ("exp_avg", "exp_avg_sq"):
            table_state[key] = self._gather_rows(table_state[key])
        return {"state": {**opt["state"], i: table_state}, "param_groups": opt["param_groups"]}

    def _own_opt_state(self, opt: dict) -> dict:
        if not self.table_sharded:
            return opt
        i = self._table_index()
        table_state = dict(opt["state"][i])
        for key in ("exp_avg", "exp_avg_sq"):
            table_state[key] = self._own_rows(table_state[key])
        return {"state": {**opt["state"], i: table_state}, "param_groups": opt["param_groups"]}

    def _written(self) -> None:
        """Under a mesh: every rank waits here until rank 0 has written."""
        if self.mesh is not None:
            dist.barrier()

    def save(self, path: str | None = None):
        sd = self.full_state_dict()
        if self.writes_files:
            ckpt.save_params(sd, path or self.checkpoint_path)
        self._written()

    def load(self, path: str | None = None):
        self.install_params(ckpt.load_params(path or self.checkpoint_path))

    def install_params(self, state_dict: dict):
        """Adopt an externally produced `state_dict` (checkpoint, a
        reference torch checkpoint, or `params_from_jax`) in the
        single-card layout; a sharded table keeps this rank's rows."""
        if self.table_sharded:
            state_dict = dict(state_dict) | {self._TABLE: self._own_rows(state_dict[self._TABLE])}
        self.model.load_state_dict(state_dict)

    def full_model(self):
        """A model on this rank's device holding the full parameters (the
        sharded table gathered), for what needs the whole table (the
        serving export); collective under a mesh."""
        if not self.table_sharded:
            return self.model
        from bsarec_tpu_torch.models import build_model as build

        sd = self.full_state_dict()
        model = build(self.model_cfg, prng=self.train_cfg.prng)
        model.load_state_dict(sd)
        return model.to(self.device)

    # ---- crash recovery -----------------------------------------------------
    @property
    def state_path(self) -> str:
        return self.checkpoint_path + ".state"

    def _config_fingerprint(self) -> str:
        """The model architecture as canonical JSON. `loss_impl` is left
        out: its choices compute the same loss."""
        fields = dataclasses.asdict(self.model_cfg)
        fields.pop("loss_impl", None)
        return json.dumps(fields, sort_keys=True)

    def _rng_states(self) -> dict:
        # "epoch_order" is the trainer's device generator, which also draws
        # the negatives, the cloze positions and the fused dropout's seeds;
        # "numpy" draws the same-target view
        states = {"epoch_order": self.generator.get_state(), "torch": torch.get_rng_state(),
                  "numpy": self.np_rng.bit_generator.state}
        if self.device.type == "cuda":
            states["cuda"] = torch.cuda.get_rng_state(self.device)
        if self.mesh is not None and self.mesh.data > 1:
            # torch's default generators differ per data rank: each data
            # rank's, beside rank 0's under the single-card keys
            mine = {k: states[k] for k in ("torch", "cuda") if k in states}
            every = [None] * dist.get_world_size()
            dist.all_gather_object(every, mine)
            states["data_ranks"] = [every[d * self.mesh.model] for d in range(self.mesh.data)]
        return states

    def save_state(self, epoch: int, stopper: EarlyStopping | None = None):
        params, opt_state, rng = self.full_state_dict(), self._full_opt_state(), self._rng_states()
        if self.writes_files:
            ckpt.save_train_state(
                self.state_path, params, opt_state, epoch, rng,
                best_score=None if stopper is None else stopper.best_score,
                patience_counter=0 if stopper is None else stopper.counter,
                config_fp=self._config_fingerprint(),
            )
        self._written()

    def resume(self) -> int:
        """Restore params, Adam state, generators and early-stopping state
        from the latest snapshot; returns the next epoch to run."""
        state = ckpt.load_train_state(self.state_path)
        saved_fp, here_fp = state["config_fp"], self._config_fingerprint()
        if saved_fp != here_fp:
            saved, here = json.loads(saved_fp), json.loads(here_fp)
            diff = {k: (saved.get(k), here.get(k)) for k in sorted(set(saved) | set(here))
                    if saved.get(k) != here.get(k)}
            raise ValueError(
                f"--resume model config does not match the snapshot at {self.state_path} "
                f"(snapshot vs now): {diff}. Omitted CLI flags fall back to defaults: pass the "
                f"original run's flags again (matching parameter shapes are not enough, e.g. "
                f"a num_attention_heads change keeps every shape)."
            )
        self.install_params(state["params"])
        self.optimizer.load_state_dict(self._own_opt_state(state["opt_state"]))
        rng = state["rng"]
        self.generator.set_state(rng["epoch_order"])
        if "numpy" in rng:
            self.np_rng.bit_generator.state = rng["numpy"]
        # a data rank past those of the snapshot keeps its freshly seeded stream
        mine = rng
        if self.mesh is not None and self.mesh.data_rank > 0:
            ranks = rng.get("data_ranks", [])
            mine = ranks[self.mesh.data_rank] if self.mesh.data_rank < len(ranks) else {}
        if "torch" in mine:
            torch.set_rng_state(mine["torch"])
        if "cuda" in mine and self.device.type == "cuda":
            torch.cuda.set_rng_state(mine["cuda"], self.device)
        self._resume_stopper = (state["best_score"], state["patience_counter"])
        self.logger.info(f"resumed full train state from {self.state_path} (epoch {state['epoch']})")
        return state["epoch"] + 1

    # ---- full run (reference: src/main.py:51-64) ------------------------
    def fit(self, start_epoch: int = 0):
        stopper = EarlyStopping(save_fn=lambda _: self.save(), logger=self.logger,
                                patience=self.train_cfg.patience)
        if self._resume_stopper is not None:
            stopper.best_score, stopper.counter = self._resume_stopper
            self._resume_stopper = None
        tput = Throughput()
        for epoch in range(start_epoch, self.train_cfg.epochs):
            tput.start()
            with annotate("train_epoch"):
                self.train(epoch)
            rate = tput.stop(self.data.train.num_samples)
            t1 = time.perf_counter()
            with annotate("eval_epoch"):
                scores, _ = self.valid(epoch)
            self.logger.info(f"epoch {epoch}: train {rate:.0f} ex/s, "
                             f"eval {time.perf_counter() - t1:.2f}s")
            stopper(np.array(scores[-1:]), None)
            self.save_state(epoch, stopper)
            if stopper.early_stop:
                self.logger.info("Early stopping")
                break
        if tput.steady_rate:
            self.logger.info(f"steady-state train throughput: {tput.steady_rate:.0f} examples/s")
        self.logger.info("---------------Test Score---------------")
        self.load()
        return self.test(0)

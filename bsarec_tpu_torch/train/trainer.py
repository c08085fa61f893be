"""Trainer (counterpart of `bsarec_tpu/train/trainer.py`).

Mirrors the reference `Trainer` surface (`src/trainers.py:9-60`):
`train(epoch)` / `valid(epoch)` / `test(epoch)` / `save` / `load`, plus
`fit()`, the run loop of `src/main.py:51-64` (early stop on NDCG@20, reload
the best checkpoint, final test), and full train-state snapshots for
`--resume`. The JAX package's mesh and multihost branches are not ported
(ROADMAP A6).
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from bsarec_tpu_torch.config import ModelConfig, TrainConfig, resolve_device, set_fp32_matmul
from bsarec_tpu_torch.data.pipeline import SeqRecData
from bsarec_tpu_torch.models import build_model
from bsarec_tpu_torch.ops import rank
from bsarec_tpu_torch.ops.losses import resolve_loss_impl
from bsarec_tpu_torch.ops.topk import metrics_from_sums
from bsarec_tpu_torch.train import checkpoint as ckpt
from bsarec_tpu_torch.train.loop import build_eval_fn, build_train_epoch, make_optimizer
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
        set_fp32_matmul()

        gen = torch.Generator().manual_seed(train_cfg.seed)
        self.model = build_model(model_cfg, generator=gen, prng=train_cfg.prng).to(self.device)
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info(f"Total Parameters: {n_params}")

        # nn.Dropout draws from torch's default generators; the epoch order,
        # the negatives, BERT4Rec's cloze positions and the fused dropout's
        # seeds from this one; the same-target view from np_rng, as in JAX.
        # A snapshot keeps the states of all of them
        torch.manual_seed(train_cfg.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(train_cfg.seed)
        self.np_rng = np.random.default_rng(train_cfg.seed)
        self.optimizer = make_optimizer(self.model.parameters(), train_cfg)
        self.loss_impl = resolve_loss_impl(model_cfg.loss_impl, model_cfg.item_size, self.device)
        self._epoch_fn, self.steps_per_epoch = build_train_epoch(
            self.model, self.optimizer, train_cfg.batch_size, data.train.num_samples, self.device,
            remat=train_cfg.remat)
        self._train_dev = None  # moved to the device by the first train()
        # early-stopping state restored by resume(), consumed by fit()
        self._resume_stopper = None

        # streaming eval stages one [U, ceil(V/32)] bitmask per split;
        # above the limit the [U, S] id lists stay on the device and each
        # batch's bitmask is built there (1M items x 50k users would stage
        # 2 x 6.25 GB)
        vocab = self.model.vocab_rows()
        staged_bytes = 2 * data.valid.num_users * rank.seen_words(vocab) * 4
        self._seen_format = "ids" if staged_bytes > rank.SEEN_BITMASK_STAGE_LIMIT else "bitmask"
        self._eval_fn, _, self.eval_impl = self._build_eval(collect_topk=False)

        self._eval_dev = {}
        for split_name in ("valid", "test"):
            split = getattr(data, split_name)
            if self.eval_impl == "streaming" and self._seen_format == "ids":
                seen = rank.dedupe_seen_rows(split.seen_items)
                if split_name == "valid":
                    logger.info(
                        f"eval seen masks: on-device per-batch bitmasks "
                        f"(staging both splits would take {staged_bytes >> 20} MiB)"
                    )
            elif self.eval_impl == "streaming":
                seen = rank.build_seen_bitmask(split.seen_items, vocab)
            else:
                seen = split.seen_items
            self._eval_dev[split_name] = {
                "inputs": torch.from_numpy(split.input_ids).long().to(self.device),
                "answers": torch.from_numpy(split.answers).long().to(self.device),
                "seen": torch.from_numpy(seen).to(self.device),
            }

    def _build_eval(self, collect_topk: bool):
        return build_eval_fn(
            self.model, self.model_cfg.item_size, self.train_cfg.eval_batch_size,
            self.data.valid.num_users, self.device, impl=self.train_cfg.eval_impl,
            collect_topk=collect_topk, seen_format=self._seen_format,
            dtype=self.model_cfg.compute_dtype,
        )

    # ---- reference-API surface -----------------------------------------
    def train(self, epoch: int) -> float:
        if self._train_dev is None:
            ce = f"full-catalog CE ({self.loss_impl}, {self.device.type})"
            self.logger.info(f"loss: {self.model.loss_name(ce)}")
            fused = self.model.dropout_state.fused
            self.logger.info(
                "dropout: fused kernel (--prng rbg, BSAREC_DROPOUT=pallas; "
                f"{'CUDA kernel' if self.device.type == 'cuda' else 'plain version on the CPU'})"
                if fused else "dropout: torch nn.Dropout")
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
        loss = float(self._epoch_fn(dev["inputs"], dev["answers"], self.generator, users, sem))
        if (epoch + 1) % self.train_cfg.log_freq == 0:
            self.logger.info(str({"epoch": epoch, "rec_loss": f"{loss:.4f}"}))
        return loss

    def evaluate_sums(self, split: str) -> np.ndarray:
        """The [9] metric sums of one eval pass over `split`."""
        dev = self._eval_dev[split]
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
        with torch.inference_mode():
            for i in range(n_batches):
                batch = torch.from_numpy(inputs[i * b:(i + 1) * b]).long().to(self.device)
                outs = self.model(batch, all_layers=True)
                dump([o.cpu().numpy() for o in outs], out_dir, tag, i)
        return n_batches

    def save(self, path: str | None = None):
        ckpt.save_params(self.model.state_dict(), path or self.checkpoint_path)

    def load(self, path: str | None = None):
        self.install_params(ckpt.load_params(path or self.checkpoint_path))

    def install_params(self, state_dict: dict):
        """Adopt an externally produced `state_dict` (checkpoint, a
        reference torch checkpoint, or `params_from_jax`)."""
        self.model.load_state_dict(state_dict)

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
        return states

    def save_state(self, epoch: int, stopper: EarlyStopping | None = None):
        ckpt.save_train_state(
            self.state_path, self.model.state_dict(), self.optimizer.state_dict(), epoch,
            self._rng_states(),
            best_score=None if stopper is None else stopper.best_score,
            patience_counter=0 if stopper is None else stopper.counter,
            config_fp=self._config_fingerprint(),
        )

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
        self.model.load_state_dict(state["params"])
        self.optimizer.load_state_dict(state["opt_state"])
        rng = state["rng"]
        self.generator.set_state(rng["epoch_order"])
        torch.set_rng_state(rng["torch"])
        if "numpy" in rng:
            self.np_rng.bit_generator.state = rng["numpy"]
        if "cuda" in rng and self.device.type == "cuda":
            torch.cuda.set_rng_state(rng["cuda"], self.device)
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

"""Trainer, eval half (counterpart of `bsarec_tpu/train/trainer.py`).

`valid` / `test` / `export_topk` / `load` / `install_params` follow the
reference `Trainer` surface (`src/trainers.py:9-60`). Training (`train`,
`fit`, `resume`) is not ported yet and raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bsarec_tpu_torch.config import ModelConfig, TrainConfig, resolve_device
from bsarec_tpu_torch.data.pipeline import SeqRecData
from bsarec_tpu_torch.models import build_model
from bsarec_tpu_torch.ops import rank
from bsarec_tpu_torch.ops.topk import metrics_from_sums
from bsarec_tpu_torch.train import checkpoint as ckpt
from bsarec_tpu_torch.train.loop import build_eval_fn

TRAINING_NOT_PORTED = "training is not ported yet (ROADMAP)"


def set_fp32_matmul() -> None:
    """Full-fp32 matmuls and convolutions on the card (no TF32), the
    precision the parity tests and the reference's numbers assume."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
        self.model = build_model(model_cfg, generator=gen).to(self.device)
        n_params = sum(p.numel() for p in self.model.parameters())
        logger.info(f"Total Parameters: {n_params}")

        # streaming eval stages one [U, ceil(V/32)] bitmask per split;
        # above the limit the [U, S] id lists stay on the device and each
        # batch's bitmask is built there (1M items x 50k users would stage
        # 2 x 6.25 GB)
        staged_bytes = 2 * data.valid.num_users * rank.seen_words(model_cfg.item_size) * 4
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
                seen = rank.build_seen_bitmask(split.seen_items, model_cfg.item_size)
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
        )

    # ---- reference-API surface -----------------------------------------
    def train(self, epoch: int) -> float:
        raise NotImplementedError(TRAINING_NOT_PORTED)

    def fit(self, start_epoch: int = 0):
        raise NotImplementedError(TRAINING_NOT_PORTED)

    def resume(self) -> int:
        raise NotImplementedError(TRAINING_NOT_PORTED)

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

    def load(self, path: str | None = None):
        self.install_params(ckpt.load_params(path or self.checkpoint_path))

    def install_params(self, state_dict: dict):
        """Adopt an externally produced `state_dict` (checkpoint, a
        reference torch checkpoint, or `params_from_jax`)."""
        self.model.load_state_dict(state_dict)

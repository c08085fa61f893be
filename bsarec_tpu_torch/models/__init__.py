"""Model registry (counterpart of `bsarec_tpu/models/__init__.py`): the
eight model types of the JAX package."""

from __future__ import annotations

import torch

from bsarec_tpu_torch.models.base import SequentialRecModel
from bsarec_tpu_torch.models.bert4rec import BERT4RecModel
from bsarec_tpu_torch.models.bsarec import BSARecModel
from bsarec_tpu_torch.models.caser import CaserModel
from bsarec_tpu_torch.models.duorec import DuoRecModel
from bsarec_tpu_torch.models.fearec import FEARecModel
from bsarec_tpu_torch.models.fmlprec import FMLPRecModel
from bsarec_tpu_torch.models.gru4rec import GRU4RecModel
from bsarec_tpu_torch.models.sasrec import SASRecModel
from bsarec_tpu_torch.ops.precision import is_bf16

MODEL_REGISTRY = {
    "bsarec": BSARecModel,
    "sasrec": SASRecModel,
    "bert4rec": BERT4RecModel,
    "fmlprec": FMLPRecModel,
    "caser": CaserModel,
    "gru4rec": GRU4RecModel,
    "duorec": DuoRecModel,
    "fearec": FEARecModel,
}


def build_model(config, generator: torch.Generator | None = None,
                prng: str = "threefry") -> SequentialRecModel:
    """A freshly initialized model on the CPU (`generator` seeds the init).
    `prng` is the CLI's `--prng`: "rbg" with `BSAREC_DROPOUT=pallas` set
    builds every dropout site on the fused kernel (`modules.make_dropout`).
    `config.compute_dtype` is "float32" or "bfloat16" (the bf16 policy,
    `ops/precision.py`); the parameters are float32 in both."""
    mt = config.model_type.lower()
    if mt not in MODEL_REGISTRY:
        raise ValueError(f"unknown model type {config.model_type!r}; "
                         f"known: {', '.join(MODEL_REGISTRY)}")
    is_bf16(config.compute_dtype)  # raises for a dtype the policy does not know
    return MODEL_REGISTRY[mt](config, generator=generator, prng=prng)

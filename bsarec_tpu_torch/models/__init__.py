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
    builds every dropout site on the fused kernel (`modules.make_dropout`)."""
    mt = config.model_type.lower()
    if mt not in MODEL_REGISTRY:
        raise ValueError(f"unknown model type {config.model_type!r}; "
                         f"known: {', '.join(MODEL_REGISTRY)}")
    if config.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype {config.compute_dtype!r} is not ported yet; use float32"
        )
    return MODEL_REGISTRY[mt](config, generator=generator, prng=prng)

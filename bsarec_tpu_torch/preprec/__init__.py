"""PREPRec on PyTorch — the counterpart of `bsarec_tpu/preprec/`.

PREPRec (RecSys 2024) represents items by time-indexed popularity
features instead of id embeddings. This subpackage ports its NewRec
model (PREPRec itself) module by module: the offline preprocessing
(`preprocess.py`), the CSV loaders (`data.py`), the popularity tables
(`popularity.py`, device tensors), the model (`models.py`, the
reference's torch key layout), the samplers (`sampler.py`), the
sampled-negative and full-catalog eval (`evaluate.py`), the trainer
(`train.py`) and the CLI (`python -m bsarec_tpu_torch.preprec.main`).
The JAX package's PREPRec path runs no Pallas kernel, so neither does
this one: its products are plain torch ops.

The other five models of the family, transfer, serving and score
ensembling are not ported yet (ROADMAP A5b).
"""

from bsarec_tpu_torch.preprec.config import PrepRecConfig, PrepRecTrainConfig

__all__ = ["PrepRecConfig", "PrepRecTrainConfig"]

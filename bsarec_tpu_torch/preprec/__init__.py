"""PREPRec on PyTorch — the counterpart of `bsarec_tpu/preprec/`.

PREPRec (RecSys 2024) represents items by time-indexed popularity
features instead of id embeddings. This subpackage ports it module by module: the offline preprocessing
(`preprocess.py`), the CSV loaders (`data.py`), the popularity tables
(`popularity.py`, device tensors), the six models (`models.py`, NewRec,
NewB4Rec, SASRecB, BERT4RecB, BPRMF and CL4SRec in the reference's torch
key layout), the samplers (`sampler.py`), the sampled-negative and
full-catalog eval, the popularity baseline and score ensembling
(`evaluate.py`), the trainer with transfer and user embeddings
(`train.py`), the exported candidate scorer (`serving.py`) and the CLI
(`python -m bsarec_tpu_torch.preprec.main`). The JAX package's PREPRec
path runs no Pallas kernel, so neither does this one: its products are
plain torch ops.
"""

from bsarec_tpu_torch.preprec.config import PrepRecConfig, PrepRecTrainConfig

__all__ = ["PrepRecConfig", "PrepRecTrainConfig"]

"""PREPRec run configuration (counterpart of `bsarec_tpu/preprec/config.py`).

The fields and defaults are the JAX package's, field for field.
`PrepRecTrainConfig.device` is new: "cuda" (the default) or "cpu"; CUDA
asked for on a host without a card raises (`config.resolve_device`).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PrepRecConfig:
    model: str = "newrec"  # newrec | newb4rec | sasrec | bert4rec | bprmf | cl4srec | mostpop
    usernum: int = 0
    itemnum: int = 0
    maxlen: int = 200
    hidden_units: int = 50
    num_blocks: int = 2
    num_heads: int = 1
    dropout_rate: float = 0.2
    # popularity feature dims (newrec / newb4rec)
    base_dim1: int = 11
    input_units1: int = 132  # base_dim1 * months considered
    base_dim2: int = 6
    input_units2: int = 6  # base_dim2 * 4-week groups considered
    lag: int = 1
    prev_time: bool = False
    use_week_eval: bool = False
    # positional / time embeddings
    no_emb: bool = False
    no_fixed_emb: bool = False
    # few-shot adapter (`--fs_emb`): an extra InitFeedForward after the
    # popularity embed layer
    fs_emb: bool = False
    time_embed: bool = False
    time_no_fixed_embed: bool = False
    time_embed_concat: bool = False
    # bert-style
    mask_prob: float = 0.0
    loss_size: int = 250  # newb4rec sampled-softmax candidates
    # cl4srec
    aug_coef: float = 0.1
    # regularization (newrec user-trajectory)
    triplet_loss: bool = False
    cos_loss: bool = False
    reg_num: int = 10
    reg_coef: float = 1.0
    only_reg: bool = False
    # eval
    eval_method: int = 1  # 1: 100 sampled negs, 3: full catalog
    topk: tuple = (10, 5, 1)
    sparse: bool = False
    override_sparse: bool = False
    no_valid_in_test: bool = False
    eval_quality: bool = False
    quality_size: int = 20

    def replace(self, **kw) -> "PrepRecConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class PrepRecTrainConfig:
    lr: float = 0.001
    wd: float = 1e-5
    batch_size: int = 128
    num_epochs: int = 80
    epoch_test: int = 4
    stop_early: int = 3
    seed: int = 2023
    fs_prop: float = 1.0  # few-shot fraction of batches
    fs_num_epochs: int = 80  # epochs for --fs_transfer
    # eval scoring batch; 0 = auto (64 sampled-negatives / 32 full-catalog)
    eval_batch_size: int = 0
    # full-catalog sweep chunk: peak eval memory is
    # O(eval_batch * eval_item_chunk * feature_dim), catalog-size-free
    eval_item_chunk: int = 4096
    l2_emb: float = 0.0  # SASRec item-emb L2
    first_eval: bool = False  # eval before epoch 1
    train_only: bool = False  # skip final test
    # skip reloading the best validation state before the final test
    state_override: bool = False
    # "cuda" (default) or "cpu"; CPU runs only when asked for
    device: str = "cuda"

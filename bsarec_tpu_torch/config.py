"""Typed run configuration (counterpart of `bsarec_tpu/config.py`).

The fields and defaults are the JAX package's; `TrainConfig.device` and
`TrainConfig.prng` (a JAX-wide setting there, `--prng`) are new.
`scan_unroll` steers the JAX epoch scan and has no counterpart here;
`mesh` runs the Trainer on a ("data", "model") mesh (`core/mesh.py`);
`multihost` keeps the training set on the host and feeds each step's
rows from there (`data/multihost.py`).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    model_type: str = "bsarec"
    item_size: int = 0  # max item id + 1 (row 0 = padding)
    num_users: int = 0  # number of users + 1
    max_seq_length: int = 50
    hidden_size: int = 64
    num_hidden_layers: int = 2
    num_attention_heads: int = 2
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.5
    attention_probs_dropout_prob: float = 0.5
    initializer_range: float = 0.02
    # mixed-precision policy (ops/precision.py): "bfloat16" runs the dense
    # and attention matmuls and the CE products on bf16 operands;
    # parameters, LayerNorm, softmax and loss accumulation stay float32.
    # "float32" reproduces the reference.
    compute_dtype: str = "float32"
    # --- bsarec ---
    c: int = 3
    alpha: float = 0.9
    # --- bert4rec ---
    mask_ratio: float = 0.2
    # --- caser ---
    nh: int = 8
    nv: int = 4
    reg_weight: float = 1e-4
    # --- duorec / fearec (contrastive) ---
    tau: float = 1.0
    lmd: float = 0.1
    lmd_sem: float = 0.1
    ssl: str = "us_x"
    sim: str = "dot"
    # --- fearec ---
    spatial_ratio: float = 0.1
    global_ratio: float = 0.6
    fredom_type: str = "us_x"
    fredom: bool = True
    # --- gru4rec ---
    gru_hidden_size: int = 64
    # "auto" | "dense" | "streaming": full-vocab CE implementation (under a
    # vocab-sharded mesh the Trainer sets "sharded_streaming" or "sharded_dense")
    loss_impl: str = "auto"

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 0.001
    batch_size: int = 256
    epochs: int = 200
    patience: int = 10
    seed: int = 42
    weight_decay: float = 0.0
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    log_freq: int = 1
    eval_batch_size: int = 256
    # "auto" | "dense" | "streaming": full-catalog eval implementation
    # (streaming = the CUDA rank kernel, ops/rank.py)
    eval_impl: str = "auto"
    mesh: str = ""
    scan_unroll: int = 0
    # recompute each step's whole loss in the backward (train/loop.py:
    # remat_loss); JAX's config says "each encoder block", but its loop
    # checkpoints the whole loss too
    remat: bool = False
    # host-fed input pipeline (data/multihost.py): the training set stays
    # on the host, each data rank moves only its rows of every global batch
    # to its device, in the device-resident epoch's global batch order
    multihost: bool = False
    # "cuda" (default) or "cpu"; CPU runs only when asked for
    device: str = "cuda"
    # "threefry" | "rbg" (--prng): "rbg" with BSAREC_DROPOUT=pallas puts
    # every dropout site on the fused kernel (models/modules.py)
    prng: str = "threefry"


def resolve_device(name: str | torch.device) -> torch.device:
    """The torch device for `name`. Asking for CUDA on a host without a
    card raises instead of falling back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {name!r} requested but CUDA is not available; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r}")
    return device


def set_fp32_matmul() -> None:
    """Full-fp32 matmuls and convolutions on the card (no TF32), the
    precision the parity tests and the reference's numbers assume."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

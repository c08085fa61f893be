"""Carry NewRec weights from the JAX package's param tree to the port.

`newrec_from_jax(params)` maps a Flax NewRec param tree (a nested dict of
numpy arrays, e.g. `jax.device_get(trainer.params)`) onto the port's
`state_dict`, whose keys are the reference's torch layout. Dense kernels
are [in, out] in Flax and [out, in] in torch; the conv FFN's kernels take
their Conv1d shape [out, in, 1]. The optional `fs_layer`, `pos_emb` and
`time_pos_emb` come across when the tree has them. The other direction is
the JAX package's own
`bsarec_tpu.preprec.torch_import.import_preprec_torch("newrec", ...)`.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))  # a writable copy


def _dense(sd, prefix, p, conv: bool = False):
    w = np.asarray(p["kernel"]).T
    sd[f"{prefix}.weight"] = _t(w[:, :, None] if conv else w)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _ln(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _init_ffn(sd, prefix, p):
    _dense(sd, f"{prefix}.fc1", p["fc1"])
    _dense(sd, f"{prefix}.fc2", p["fc2"])


def newrec_from_jax(params: dict) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    _init_ffn(sd, "embed_layer", params["embed_layer"])
    if "fs_layer" in params:
        _init_ffn(sd, "fs_layer", params["fs_layer"])
    for name in ("pos_emb", "time_pos_emb"):
        if name in params:
            sd[f"{name}.weight"] = _t(params[name]["embedding"])
    bb = params["backbone"]
    blocks = sorted(int(k.removeprefix("attn_ln_")) for k in bb if k.startswith("attn_ln_"))
    for i in blocks:
        _ln(sd, f"attention_layernorms.{i}", bb[f"attn_ln_{i}"])
        for w in ("Q_w", "K_w", "V_w"):
            _dense(sd, f"attention_layers.{i}.{w}", bb[f"attn_{i}"][w])
        _ln(sd, f"forward_layernorms.{i}", bb[f"ffn_ln_{i}"])
        for w in ("conv1", "conv2"):
            _dense(sd, f"forward_layers.{i}.{w}", bb[f"ffn_{i}"][w], conv=True)
    _ln(sd, "last_layernorm", bb["last_ln"])
    return sd

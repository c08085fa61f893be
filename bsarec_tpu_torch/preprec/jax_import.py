"""Carry PREPRec weights from the JAX package's param trees to the port.

`preprec_from_jax(model, params)` maps a Flax param tree of one of the six
models (a nested dict of numpy arrays, e.g. `jax.device_get(trainer.params)`)
onto the port's `state_dict`, whose keys are the reference's torch layout;
`newrec_from_jax`, `newb4rec_from_jax`, `sasrec_b_from_jax`,
`bert4rec_b_from_jax`, `bprmf_from_jax` and `cl4srec_from_jax` are its
cases. Dense kernels are [in, out] in Flax and [out, in] in torch; the
conv FFN's kernels take their Conv1d shape [out, in, 1]. Optional
parameters (`fs_layer`, `pos_emb`, `time_pos_emb`) come across when the
tree has them. The other direction is the JAX package's own
`bsarec_tpu.preprec.torch_import.import_preprec_torch(model, ...)`.
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


def _tables(sd, params, names):
    for name in names:
        if name in params:
            sd[f"{name}.weight"] = _t(params[name]["embedding"])


def _blocks(tree) -> list[int]:
    return sorted(int(k.removeprefix("attn_ln_")) for k in tree if k.startswith("attn_ln_"))


def _sasrec_backbone(sd, bb):
    for i in _blocks(bb):
        _ln(sd, f"attention_layernorms.{i}", bb[f"attn_ln_{i}"])
        for w in ("Q_w", "K_w", "V_w"):
            _dense(sd, f"attention_layers.{i}.{w}", bb[f"attn_{i}"][w])
        _ln(sd, f"forward_layernorms.{i}", bb[f"ffn_ln_{i}"])
        for w in ("conv1", "conv2"):
            _dense(sd, f"forward_layers.{i}.{w}", bb[f"ffn_{i}"][w], conv=True)
    _ln(sd, "last_layernorm", bb["last_ln"])


def _bert_blocks(sd, params):
    for i in _blocks(params):
        _ln(sd, f"attention_layernorms.{i}", params[f"attn_ln_{i}"])
        attn = params[f"attn_{i}"]
        for j, w in enumerate(("q", "k", "v")):
            _dense(sd, f"attention_layers.{i}.linear_layers.{j}", attn[w])
        _dense(sd, f"attention_layers.{i}.output_linear", attn["out"])
        _ln(sd, f"forward_layernorms.{i}", params[f"ffn_ln_{i}"])
        for w in ("w_1", "w_2"):
            _dense(sd, f"forward_layers.{i}.{w}", params[f"ffn_{i}"][w])
    _dense(sd, "out", params["out"])


def newrec_from_jax(params: dict) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    _init_ffn(sd, "embed_layer", params["embed_layer"])
    if "fs_layer" in params:
        _init_ffn(sd, "fs_layer", params["fs_layer"])
    _tables(sd, params, ("pos_emb", "time_pos_emb"))
    _sasrec_backbone(sd, params["backbone"])
    return sd


def newb4rec_from_jax(params: dict) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    _init_ffn(sd, "embed_layer", params["embed_layer"])
    _tables(sd, params, ("pos_emb",))
    _bert_blocks(sd, params)
    return sd


def sasrec_b_from_jax(params: dict) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    _tables(sd, params, ("item_emb", "pos_emb"))
    _sasrec_backbone(sd, params["backbone"])
    return sd


def bert4rec_b_from_jax(params: dict) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    _tables(sd, params, ("item_emb", "pos_emb"))
    _bert_blocks(sd, params)
    return sd


def bprmf_from_jax(params: dict) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    _tables(sd, params, ("user_emb", "item_emb"))
    return sd


cl4srec_from_jax = sasrec_b_from_jax

PREPREC_FROM_JAX = {
    "newrec": newrec_from_jax,
    "newb4rec": newb4rec_from_jax,
    "sasrec": sasrec_b_from_jax,
    "bert4rec": bert4rec_b_from_jax,
    "bprmf": bprmf_from_jax,
    "cl4srec": cl4srec_from_jax,
}


def preprec_from_jax(model: str, params: dict) -> dict[str, torch.Tensor]:
    """The port's state_dict of `model` (a PREPREC_REGISTRY name) from its
    JAX param tree."""
    return PREPREC_FROM_JAX[model.lower()](params)

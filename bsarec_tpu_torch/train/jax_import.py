"""Carry weights from the JAX package's param tree to the port.

`params_from_jax(tree)` maps a Flax param tree of any of the eight models
(a nested dict of numpy arrays, e.g. `jax.device_get(trainer.params)`)
onto the port's `state_dict`, whose keys are the reference torch layout.
The model is read off the tree's keys. Dense kernels are [in, out] in
Flax and [out, in] in torch, so they are transposed; FMLP-Rec's
`filter_real` / `filter_imag` planes stack into `complex_weight`;
GRU4Rec's `w_ih` / `w_hh` are transposed into `nn.GRU`'s packed gates;
Caser's flattened conv kernels take their Conv2d shapes. The other
direction is the JAX package's own
`bsarec_tpu.train.torch_import.import_torch_checkpoint`, which reads that
layout.

GRU4Rec's and Caser's trees lack the position embeddings and the
embedding LayerNorm, which their forward never reads but the reference
layout holds: those entries come from `base` (a port `state_dict`, such
as the model's own) when it is given, else zeros ([max_seq_length, H]
position rows).
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))  # a writable copy


def _dense(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _ln(sd, prefix, p):
    sd[f"{prefix}.weight"] = _t(p["weight"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _mha(sd, prefix, p):
    for name in ("query", "key", "value", "dense"):
        _dense(sd, f"{prefix}.{name}", p[name])
    _ln(sd, f"{prefix}.LayerNorm", p["LayerNorm"])


def _ffn(sd, prefix, p):
    _dense(sd, f"{prefix}.dense_1", p["dense_1"])
    _dense(sd, f"{prefix}.dense_2", p["dense_2"])
    _ln(sd, f"{prefix}.LayerNorm", p["LayerNorm"])


def _blocks(tree):
    """(index, block) pairs of a tree's top-level `block_{i}` entries."""
    return sorted((int(k.removeprefix("block_")), v) for k, v in tree.items()
                  if k.startswith("block_"))


def _model_type_of(tree: dict) -> str:
    """The model a JAX param tree belongs to, by its keys ("sasrec" stands
    for SASRec, BERT4Rec and DuoRec, which share one layout)."""
    if "gru_0" in tree:
        return "gru4rec"
    if "conv_v_kernel" in tree:
        return "caser"
    if "item_encoder" in tree:
        return "sasrec"
    layer = tree["block_0"]["layer"]
    if "filter_layer" in layer:
        return "bsarec"
    if "filter_real" in layer:
        return "fmlprec"
    if "query" in layer:
        return "fearec"
    raise ValueError(f"unrecognized JAX param tree (block_0/layer keys {sorted(layer)})")


def _unused_base_entries(sd, base, hidden: int, max_seq_length: int):
    """The reference layout's position embeddings and embedding LayerNorm,
    which GRU4Rec's and Caser's JAX trees lack: `base`'s, else zeros."""
    shapes = {"position_embeddings.weight": (max_seq_length, hidden),
              "LayerNorm.weight": (hidden,), "LayerNorm.bias": (hidden,)}
    for key, shape in shapes.items():
        sd[key] = base[key].detach().cpu().clone() if base is not None else torch.zeros(shape)


def params_from_jax(tree: dict, base: dict | None = None,
                    max_seq_length: int = 50) -> dict[str, torch.Tensor]:
    """Flax params of any model -> port `state_dict` (float32 CPU tensors).
    `base` and `max_seq_length` serve only GRU4Rec and Caser (module
    docstring); Caser's bank count gives its sequence length."""
    sd = {"item_embeddings.weight": _t(tree["item_embeddings"]["embedding"])}
    hidden = sd["item_embeddings.weight"].shape[1]
    kind = _model_type_of(tree)
    if kind == "gru4rec":
        layers = sorted(int(k.removeprefix("gru_")) for k in tree if k.startswith("gru_"))
        for i in layers:
            sd[f"gru_layers.weight_ih_l{i}"] = _t(np.asarray(tree[f"gru_{i}"]["w_ih"]).T)
            sd[f"gru_layers.weight_hh_l{i}"] = _t(np.asarray(tree[f"gru_{i}"]["w_hh"]).T)
        _dense(sd, "dense", tree["dense"])
        _unused_base_entries(sd, base, hidden, max_seq_length)
        return sd
    if kind == "caser":
        banks = sum(1 for k in tree if k.startswith("conv_h_") and k.endswith("_kernel"))
        sd["user_embeddings.weight"] = _t(tree["user_embeddings"]["embedding"])
        kv = np.asarray(tree["conv_v_kernel"])  # [L, nv]
        sd["conv_v.weight"] = _t(kv.T.reshape(kv.shape[1], 1, kv.shape[0], 1))
        sd["conv_v.bias"] = _t(tree["conv_v_bias"])
        for i in range(1, banks + 1):
            kh = np.asarray(tree[f"conv_h_{i}_kernel"])  # [i * H, nh]
            sd[f"conv_h.{i - 1}.weight"] = _t(kh.T.reshape(kh.shape[1], 1, i, hidden))
            sd[f"conv_h.{i - 1}.bias"] = _t(tree[f"conv_h_{i}_bias"])
        _dense(sd, "fc1", tree["fc1"])
        _dense(sd, "fc2", tree["fc2"])
        _unused_base_entries(sd, base, hidden, banks)
        return sd

    sd["position_embeddings.weight"] = _t(tree["position_embeddings"]["embedding"])
    _ln(sd, "LayerNorm", tree["emb_layer_norm"])
    if kind == "sasrec":
        for i, blk in _blocks(tree["item_encoder"]):
            _mha(sd, f"item_encoder.blocks.{i}.layer", blk["attention"])
            _ffn(sd, f"item_encoder.blocks.{i}.feed_forward", blk["feed_forward"])
        return sd
    for i, blk in _blocks(tree):
        base_key = f"item_encoder.blocks.{i}"
        layer = blk["layer"]
        if kind == "bsarec":
            flt = layer["filter_layer"]
            sd[f"{base_key}.layer.filter_layer.sqrt_beta"] = _t(flt["sqrt_beta"])
            _ln(sd, f"{base_key}.layer.filter_layer.LayerNorm", flt["LayerNorm"])
            _mha(sd, f"{base_key}.layer.attention_layer", layer["attention_layer"])
        elif kind == "fmlprec":
            sd[f"{base_key}.layer.complex_weight"] = _t(
                np.stack([layer["filter_real"], layer["filter_imag"]], axis=-1))
            _ln(sd, f"{base_key}.layer.LayerNorm", layer["LayerNorm"])
        else:  # fearec
            _mha(sd, f"{base_key}.layer", layer)
        _ffn(sd, f"{base_key}.feed_forward", blk["feed_forward"])
    return sd

"""Carry weights from the JAX package's param tree to the port.

`params_from_jax(tree)` maps a BSARec Flax param tree (a nested dict of
numpy arrays, e.g. `jax.device_get(trainer.params)`) onto the port's
`state_dict`, whose keys are the reference torch layout. Dense kernels
are [in, out] in Flax and [out, in] in torch, so they are transposed.
The other direction is the JAX package's own
`bsarec_tpu.train.torch_import.import_bsarec`, which reads that layout.
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


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """BSARec Flax params -> port `state_dict` (float32 CPU tensors)."""
    sd = {
        "item_embeddings.weight": _t(tree["item_embeddings"]["embedding"]),
        "position_embeddings.weight": _t(tree["position_embeddings"]["embedding"]),
    }
    _ln(sd, "LayerNorm", tree["emb_layer_norm"])
    n_layers = sum(1 for key in tree if key.startswith("block_"))
    for i in range(n_layers):
        blk = tree[f"block_{i}"]
        base = f"item_encoder.blocks.{i}"
        flt = blk["layer"]["filter_layer"]
        sd[f"{base}.layer.filter_layer.sqrt_beta"] = _t(flt["sqrt_beta"])
        _ln(sd, f"{base}.layer.filter_layer.LayerNorm", flt["LayerNorm"])
        att = blk["layer"]["attention_layer"]
        for name in ("query", "key", "value", "dense"):
            _dense(sd, f"{base}.layer.attention_layer.{name}", att[name])
        _ln(sd, f"{base}.layer.attention_layer.LayerNorm", att["LayerNorm"])
        ffn = blk["feed_forward"]
        _dense(sd, f"{base}.feed_forward.dense_1", ffn["dense_1"])
        _dense(sd, f"{base}.feed_forward.dense_2", ffn["dense_2"])
        _ln(sd, f"{base}.feed_forward.LayerNorm", ffn["LayerNorm"])
    return sd

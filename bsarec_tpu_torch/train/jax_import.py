"""Carry weights from the JAX package's param tree to the port.

`params_from_jax(tree)` maps a BSARec or SASRec Flax param tree (a
nested dict of numpy arrays, e.g. `jax.device_get(trainer.params)`) onto
the port's `state_dict`, whose keys are the reference torch layout.
Dense kernels are [in, out] in Flax and [out, in] in torch, so they are
transposed. The other direction is the JAX package's own
`bsarec_tpu.train.torch_import.import_bsarec` / `import_sasrec`, which
read that layout.
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


def params_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """BSARec or SASRec Flax params -> port `state_dict` (float32 CPU
    tensors). SASRec's tree keeps its blocks under `item_encoder`
    (`item_encoder/block_{i}/attention|feed_forward`), BSARec's at the top."""
    sd = {
        "item_embeddings.weight": _t(tree["item_embeddings"]["embedding"]),
        "position_embeddings.weight": _t(tree["position_embeddings"]["embedding"]),
    }
    _ln(sd, "LayerNorm", tree["emb_layer_norm"])
    if "item_encoder" in tree:  # SASRec
        for name, blk in tree["item_encoder"].items():
            base = f"item_encoder.blocks.{int(name.removeprefix('block_'))}"
            _mha(sd, f"{base}.layer", blk["attention"])
            _ffn(sd, f"{base}.feed_forward", blk["feed_forward"])
        return sd
    n_layers = sum(1 for key in tree if key.startswith("block_"))
    for i in range(n_layers):
        blk = tree[f"block_{i}"]
        base = f"item_encoder.blocks.{i}"
        flt = blk["layer"]["filter_layer"]
        sd[f"{base}.layer.filter_layer.sqrt_beta"] = _t(flt["sqrt_beta"])
        _ln(sd, f"{base}.layer.filter_layer.LayerNorm", flt["LayerNorm"])
        _mha(sd, f"{base}.layer.attention_layer", blk["layer"]["attention_layer"])
        _ffn(sd, f"{base}.feed_forward", blk["feed_forward"])
    return sd

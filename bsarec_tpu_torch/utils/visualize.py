"""Post-hoc analysis utilities (counterpart of `bsarec_tpu/utils/visualize.py`,
all numpy, the same functions under the same names; reference:
`src/visualize/figure2.ipynb`, `figure3.ipynb` and their `.npy` dumps).

- `attention_spectral_response`: Fig 2(b), the diagonal magnitude of
  F·A·F⁻¹ for an attention map A (how much each frequency passes).
- `filter_spectral_response`: the spectral magnitude of an FMLP complex
  filter or the BSARec low-pass projection.
- `layerwise_cosine_similarity` / `layerwise_singular_values`: Fig 3,
  oversmoothing diagnostics over per-layer sequence outputs
  (`model(..., all_layers=True)`).
- `dump_sequence_outputs`: .npy dumps in the reference's
  `visualize/sequence_output/<tag>/{L}layer_{i}iter.npy` layout
  (`Trainer.dump_sequence_outputs`, `main --dump_seqout`), read back by
  `load_sequence_outputs`.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np


def attention_spectral_response(attn: np.ndarray) -> np.ndarray:
    """attn: [L, L] attention map -> [L] |diag(F A F^-1)|."""
    length = attn.shape[-1]
    f = np.fft.fft(np.eye(length)) / np.sqrt(length)
    f_inv = np.conj(f).T
    lam = f @ attn @ f_inv
    return np.abs(np.diag(lam))


def filter_spectral_response(w_real: np.ndarray, w_imag: np.ndarray) -> np.ndarray:
    """FMLP complex filter [1, F, H] -> per-frequency mean magnitude [F].

    (|w| rather than |w|² — see `fig2_filter_response` for the
    notebook-exact squared-magnitude curve.)"""
    return np.abs(w_real + 1j * w_imag).mean(axis=-1).reshape(-1)


def fig2_filter_response(complex_weight: np.ndarray) -> np.ndarray:
    """Notebook-exact Fig 2 FMLP curve (`figure2.ipynb` §1): layer-0
    filter `complex_weight` [1, F, H, 2] -> mean over hidden of the
    SQUARED magnitude real² + imag², per frequency [F]."""
    w = np.asarray(complex_weight)[0]
    return (w[:, :, 0] ** 2 + w[:, :, 1] ** 2).mean(axis=1)


def layerwise_cosine_similarity(layer_outputs) -> list[float]:
    """Mean pairwise cosine similarity of positions per layer
    (oversmoothing indicator, Fig 3 left)."""
    sims = []
    for h in layer_outputs:
        x = np.asarray(h, dtype=np.float64)
        x = x.reshape(-1, x.shape[-2], x.shape[-1])  # [B, L, H]
        x = x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)
        gram = np.einsum("blh,bmh->blm", x, x)
        length = gram.shape[-1]
        off_diag = gram.sum(axis=(1, 2)) - np.trace(gram, axis1=1, axis2=2)
        sims.append(float(np.mean(off_diag / (length * (length - 1)))))
    return sims


def layerwise_singular_values(layer_outputs) -> list[np.ndarray]:
    """Normalized singular-value spectra per layer (Fig 3 right)."""
    out = []
    for h in layer_outputs:
        x = np.asarray(h, dtype=np.float64)
        x = x.reshape(-1, x.shape[-1])
        s = np.linalg.svd(x, compute_uv=False)
        out.append(s / (s[0] + 1e-12))
    return out


def fig3_sequence_cosine(states: np.ndarray) -> float:
    """Notebook-exact Fig 3 (left) point (`figure3.ipynb` cell 4):
    pairwise cosine similarity across sequence-level representations
    `states` [N, H] (the notebook feeds last-position hidden states),
    diagonal zeroed (torchmetrics' default), mean over all N² entries."""
    x = np.asarray(states, dtype=np.float64)
    x = x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)
    gram = x @ x.T
    np.fill_diagonal(gram, 0.0)
    return float(gram.sum() / (gram.shape[0] * gram.shape[1]))


def fig3_normalized_svdvals(states: np.ndarray) -> np.ndarray:
    """Notebook-exact Fig 3 (right) curve (`figure3.ipynb` cell 6):
    singular values of `states` [N, H] divided by the largest one."""
    s = np.linalg.svd(np.asarray(states, dtype=np.float64), compute_uv=False)
    return s / (s.max() + 1e-12)


def load_sequence_outputs(dump_dir: str | Path, n_layers: int = 16) -> list[np.ndarray]:
    """Load a reference-layout `sequence_output/<tag>/` directory
    (`{L}layer_{i}iter.npy`, each [B, L, H]) the way `figure3.ipynb`'s
    `get_seqout` does: last-position states, iterations concatenated,
    one [N, H] array per layer 0..n_layers."""
    root = Path(dump_dir)
    per_layer: dict[int, list[np.ndarray]] = {i: [] for i in range(n_layers + 1)}
    pattern = re.compile(r"^(\d+)layer_.*\.npy$")
    for f in sorted(root.iterdir()):
        m = pattern.match(f.name)
        if m is None or int(m.group(1)) > n_layers:
            continue  # stray files (README, markers) and extra layers
        per_layer[int(m.group(1))].append(np.load(f)[:, -1, :])
    missing = [i for i, v in per_layer.items() if not v]
    if missing:
        raise FileNotFoundError(
            f"{root}: no '{{L}}layer_*iter.npy' dumps for layers {missing}")
    return [np.concatenate(per_layer[i]) for i in sorted(per_layer)]


def dump_sequence_outputs(layer_outputs, out_dir: str | Path, tag: str, iteration: int) -> None:
    root = Path(out_dir) / tag
    root.mkdir(parents=True, exist_ok=True)
    for layer, h in enumerate(layer_outputs):
        np.save(root / f"{layer}layer_{iteration}iter.npy", np.asarray(h))


def fig2_attention_response(attn: np.ndarray) -> np.ndarray:
    """Notebook-exact Fig 2(b) curve (`src/visualize/figure2.ipynb` §2):
    Λ = DFT·A·DFT⁻¹, row-mean, magnitude, first L//2+1 bins."""
    length = attn.shape[-1]
    dft_matrix = np.fft.fft(np.eye(length))
    lam = dft_matrix @ attn @ np.linalg.inv(dft_matrix)
    return np.abs(lam.mean(axis=1)[: length // 2 + 1])


def fig2_fftshift(arr: np.ndarray, length: int = 50):
    """Mirror a one-sided response about 0 frequency (`figure2.ipynb` §1)."""
    freq = np.fft.rfftfreq(length)
    x = np.concatenate([np.flip(-freq[1:]), freq])
    y = np.concatenate([np.flip(arr[1:]), arr])
    return x, y

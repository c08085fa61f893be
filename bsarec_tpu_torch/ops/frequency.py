"""BSARec's spectral filter (counterpart of `bsarec_tpu/ops/frequency.py`).

The FrequencyLayer (reference: `src/model/bsarec.py:90-99`) is
`irfft(zero_bins(rfft(x, ortho)), ortho)` along the sequence axis: a
fixed real [L, L] projection, applied here as one small matmul.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def lowpass_projection_matrix(seq_len: int, c: int) -> np.ndarray:
    """Real [L, L] matrix equal to rfft→keep bins [0, c//2+1)→irfft (ortho).

    Built once in float64 from the identity's spectrum and cast to
    float32, cached per (seq_len, c). `c` is the raw `--c` flag; kept
    bins = c//2 + 1 (the reference keeps `x[:, :c//2+1, :]`). Callers
    must not write to the returned array.
    """
    kept = c // 2 + 1
    eye = np.eye(seq_len, dtype=np.float64)
    spec = np.fft.rfft(eye, axis=0, norm="ortho")
    spec[kept:, :] = 0.0
    proj = np.fft.irfft(spec, n=seq_len, axis=0, norm="ortho")
    return proj.astype(np.float32)


def frequency_filter(x: torch.Tensor, proj: torch.Tensor, sqrt_beta: torch.Tensor) -> torch.Tensor:
    """x: [B, L, H]; proj: [L, L] low-pass projection; sqrt_beta: [..., H].
    Returns low_pass + sqrt_beta² ⊙ (x − low_pass) (high-pass rescale)."""
    low = torch.einsum("kl,blh->bkh", proj, x)
    return low + sqrt_beta**2 * (x - low)

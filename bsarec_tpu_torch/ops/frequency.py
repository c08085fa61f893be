"""Spectral sequence-mixing ops (counterpart of `bsarec_tpu/ops/frequency.py`).

- BSARec's FrequencyLayer (reference: `src/model/bsarec.py:90-99`) is
  `irfft(zero_bins(rfft(x, ortho)), ortho)` along the sequence axis: a
  fixed real [L, L] projection, applied here as one small matmul.
- FMLP-Rec's learnable complex filter (`complex_filter_apply`) and the
  spectrum of FEARec's fredom term (`rfft_real_imag`) run on `torch.fft`,
  as the reference does. The JAX package realizes both with real DFT
  matmuls because its TPU compiler has no FFT lowering; the maps are the
  same.
- FEARec's per-layer band maps stay cached real matrices
  (`bandpass_matrices`, float64-built like JAX's): each composes rfft,
  a bin slice and irfft into one [., L] matrix, which keeps the lag
  correlation, whose top-k picks the delays, on JAX's arithmetic.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from bsarec_tpu_torch.ops.precision import rounded


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


def frequency_filter(x: torch.Tensor, proj: torch.Tensor, sqrt_beta: torch.Tensor,
                     bf16: bool = False) -> torch.Tensor:
    """x: [B, L, H]; proj: [L, L] low-pass projection; sqrt_beta: [..., H].
    Returns low_pass + sqrt_beta² ⊙ (x − low_pass) (high-pass rescale).
    With `bf16` (the bf16 policy, `bsarec_tpu/ops/frequency.py:44-52`), x
    and proj are rounded to bf16, the projection takes a float32 result,
    and the rest runs in float32 on the rounded x."""
    x, proj = rounded(x, bf16), rounded(proj, bf16)
    low = torch.einsum("kl,blh->bkh", proj, x)
    return low + sqrt_beta**2 * (x - low)


@functools.lru_cache(maxsize=64)
def bandpass_matrices(seq_len: int, left: int, right: int):
    """FEARec's band maps for rFFT bins [left, right) of length-L signals
    (default fft norm; `src/model/fearec.py:229-249,332-356`), float32:

    - R_re, R_im [nband, L]: signal -> Re/Im of the band's bins;
    - A_re, A_im [L, nband]: band spectrum -> irfft of it scattered into
      the full F bins;
    - BP [L, L]: the band-pass projection irfft(band(rfft(x))).
    Callers must not write to the returned arrays."""
    eye = np.eye(seq_len, dtype=np.float64)
    spec = np.fft.rfft(eye, axis=0)  # [F, L]
    band = spec[left:right, :]
    nband = right - left
    scatter = np.zeros((seq_len // 2 + 1, nband), dtype=np.complex128)
    scatter[left:right, :] = np.eye(nband)
    a_re = np.fft.irfft(scatter, n=seq_len, axis=0)
    a_im = np.fft.irfft(scatter * 1j, n=seq_len, axis=0)
    full = np.zeros_like(spec)
    full[left:right, :] = band
    bp = np.fft.irfft(full, n=seq_len, axis=0)
    return tuple(m.astype(np.float32) for m in (band.real, band.imag, a_re, a_im, bp))


def complex_filter_apply(x: torch.Tensor, complex_weight: torch.Tensor) -> torch.Tensor:
    """FMLP-Rec's learnable spectral filter (reference
    `src/model/fmlprec.py:97-108`): irfft(rfft(x) * w) along the sequence
    axis, ortho norms. x: [B, L, H] f32; complex_weight: [1, L//2+1, H, 2]
    (real, imag) in the reference layout."""
    spec = torch.fft.rfft(x, dim=1, norm="ortho") * torch.view_as_complex(complex_weight)
    return torch.fft.irfft(spec, n=x.shape[1], dim=1, norm="ortho")


def rfft_real_imag(x: torch.Tensor, dim: int = 1):
    """(Re, Im) of the ortho rFFT along `dim`."""
    spec = torch.fft.rfft(x, dim=dim, norm="ortho")
    return spec.real, spec.imag

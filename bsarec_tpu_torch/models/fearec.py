"""FEARec (counterpart of `bsarec_tpu/models/fearec.py`).

Frequency-enhanced hybrid attention (reference: `src/model/fearec.py`).
Each layer projects Q, K, V ([B, h, d, L], the lag axis last) and blends
two branches as `(1 - spatial_ratio) * autocorrelation + spatial_ratio *
dual-domain`:

1. autocorrelation: the Q and K spectra restricted to the layer's band
   [left, right) of rFFT bins (`fearec_band`), the cross-power
   q * conj(k) taken back to a lag correlation; the top-k lags
   (k = int(10 ln L)) of its mean weight rolled copies of V. In training
   the lags are shared by the batch (`time_delay_agg_train`), in eval
   mode each row has its own (`time_delay_agg_infer`), as `module.training`
   says. The top-k comes from a stable descending sort, which orders
   equal values by the smaller lag as `jax.lax.top_k` does.
2. dual-domain: causal attention over the band-limited Q, K, V.

Then the output dense, dropout, LN(x + res) and the shared FeedForward.
The loss is the full-catalog CE, DuoRec's InfoNCE terms and, with
`fredom`, 0.1 x the mean spectral L1 distance between views
(`fearec.py:227-247`). The reference's fredom crashes for every
`fredom_type` but "us_x"; the JAX package keeps the others defined on the
last-position states (along the hidden axis), and so does the port.

The band maps are cached real matrices (`ops.frequency.bandpass_matrices`);
the rolled-V sum is one circulant [L, L] matrix per row (`_delay_circulant`),
as in JAX, where a [B, h, d, k, L] gather would not fit the TPU.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from bsarec_tpu_torch.models.base import SequentialRecModel
from bsarec_tpu_torch.models.duorec import contrastive_terms
from bsarec_tpu_torch.models.modules import (
    Dense,
    DropoutState,
    FeedForward,
    TFLayerNorm,
    init_linear,
    make_dropout,
)
from bsarec_tpu_torch.ops.frequency import bandpass_matrices, rfft_real_imag
from bsarec_tpu_torch.ops.losses import full_softmax_ce
from bsarec_tpu_torch.ops.topk import stable_topk


def fearec_band(max_seq_length: int, num_hidden_layers: int, global_ratio: float,
                layer: int) -> tuple[int, int]:
    """The layer's frequency window [left, right) (`fearec.py:216-249`)."""
    nfreq = max_seq_length // 2 + 1
    if global_ratio > 1.0 / num_hidden_layers:
        w = global_ratio
        s = (nfreq * (1 - global_ratio)) // (num_hidden_layers - 1) if num_hidden_layers > 1 else 0
    else:
        w = 1.0 / num_hidden_layers
        s = w * nfreq
    return int((nfreq * (1 - w)) - layer * s), int(nfreq - layer * s)


def _delay_circulant(weights: torch.Tensor, delay: torch.Tensor, length: int) -> torch.Tensor:
    """[B, L, L] matrix C with C[b, l, m] = sum_k weights[b, k] where
    (m - l) mod L == delay[(b,) k], so that V @ C^T == sum_k w_k roll(V, -d_k)
    along the last axis. `delay` is [k] (shared) or [B, k] (per row)."""
    b = weights.shape[0]
    if delay.dim() == 1:
        delay = delay.expand(b, -1)
    lag_profile = weights.new_zeros((b, length)).scatter_add(1, delay, weights)
    pos = torch.arange(length, device=weights.device)
    diff = (pos[None, :] - pos[:, None]) % length  # [l, m]: (m - l) mod L
    return lag_profile[:, diff]


def _aggregate(values: torch.Tensor, weights: torch.Tensor, delay: torch.Tensor) -> torch.Tensor:
    comb = _delay_circulant(torch.softmax(weights, dim=-1), delay, values.shape[-1])
    return values @ comb.transpose(1, 2)[:, None]  # [B, h, d, L]


def time_delay_agg_train(values: torch.Tensor, corr: torch.Tensor, top_k: int) -> torch.Tensor:
    """Batch-shared top-k delays (`fearec.py:253-274`): the top lags of the
    batch mean of the [B, L] mean correlation, weighted by each row's
    softmax over them. values, corr: [B, h, d, L]."""
    mean_value = corr.mean(dim=(1, 2))
    _, index = stable_topk(mean_value.mean(dim=0), top_k)
    return _aggregate(values, mean_value[:, index], index)


def time_delay_agg_infer(values: torch.Tensor, corr: torch.Tensor, top_k: int) -> torch.Tensor:
    """Per-row top-k delays (`fearec.py:276-303`)."""
    weights, delay = stable_topk(corr.mean(dim=(1, 2)), top_k)
    return _aggregate(values, weights, delay)


class FEARecLayer(nn.Module):
    factor = 10

    def __init__(self, cfg, dropout_state: DropoutState, layer_num: int):
        super().__init__()
        h, dt = cfg.hidden_size, cfg.compute_dtype
        self.num_heads = cfg.num_attention_heads
        self.head_dim = h // self.num_heads
        self.spatial_ratio = cfg.spatial_ratio
        self.band = fearec_band(cfg.max_seq_length, cfg.num_hidden_layers, cfg.global_ratio,
                                layer_num)
        # bf16 Dense layers under the bf16 policy (`bsarec_tpu/models/fearec.py:126,168`)
        self.query = Dense(h, h, dt)
        self.key = Dense(h, h, dt)
        self.value = Dense(h, h, dt)
        self.attn_dropout = make_dropout(cfg.attention_probs_dropout_prob, dropout_state)
        self.dense = Dense(h, h, dt)
        self.LayerNorm = TFLayerNorm(h)
        self.out_dropout = make_dropout(cfg.hidden_dropout_prob, dropout_state)
        # on the model's device, as BSARec's projection is
        for name, m in zip(("r_re", "r_im", "a_re", "a_im", "bp"),
                           bandpass_matrices(cfg.max_seq_length, *self.band)):
            self.register_buffer(name, torch.from_numpy(m), persistent=False)

    def reset_parameters(self, std: float, generator=None) -> None:
        for layer in (self.query, self.key, self.value, self.dense):
            init_linear(layer, std, generator)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        b, seq_len, hidden = x.shape
        r_re, r_im, a_re, a_im, bp = self.r_re, self.r_im, self.a_re, self.a_im, self.bp
        if seq_len != bp.shape[0]:
            raise ValueError(f"FEARec takes inputs of max_seq_length {bp.shape[0]}, got {seq_len}")

        def heads(y):  # [B, L, H] -> [B, h, d, L]; a bf16 projection promotes to
            # float32 against the float32 band maps, as in JAX
            return y.float().view(b, seq_len, self.num_heads, self.head_dim).permute(0, 2, 3, 1)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))

        # autocorrelation: band-limited cross-power -> lags
        q_re, q_im = q @ r_re.T, q @ r_im.T
        k_re, k_im = k @ r_re.T, k @ r_im.T
        prod_re = q_re * k_re + q_im * k_im  # Re(q conj(k))
        prod_im = q_im * k_re - q_re * k_im  # Im(q conj(k))
        corr = prod_re @ a_re.T + prod_im @ a_im.T
        # int(factor ln L) exceeds L for tiny sequences (the reference crashes there)
        top_k = min(int(self.factor * math.log(seq_len)), seq_len)
        agg = time_delay_agg_train if self.training else time_delay_agg_infer
        context = agg(v, corr, top_k).permute(0, 3, 1, 2).reshape(b, seq_len, hidden)

        # dual-domain: attention over the band-limited signals, [B, h, L, d]
        qt, kt, vt = ((y @ bp.T).transpose(-1, -2) for y in (q, k, v))
        scores = qt @ kt.transpose(-1, -2) / math.sqrt(self.head_dim) + attention_mask
        probs = self.attn_dropout(torch.softmax(scores, dim=-1))
        ctx_sp = (probs @ vt).transpose(1, 2).reshape(b, seq_len, hidden)

        context = (1.0 - self.spatial_ratio) * context + self.spatial_ratio * ctx_sp
        out = self.out_dropout(self.dense(context))
        return self.LayerNorm(out + x)


class FEARecBlock(nn.Module):
    def __init__(self, cfg, dropout_state: DropoutState, layer_num: int):
        super().__init__()
        self.layer = FEARecLayer(cfg, dropout_state, layer_num)
        self.feed_forward = FeedForward(cfg, dropout_state)

    def forward(self, x, attention_mask):
        return self.feed_forward(self.layer(x, attention_mask))


class FEARecEncoder(nn.Module):
    """The blocks under the reference's names (`item_encoder.blocks.{i}`);
    each block knows its layer number, which picks its band."""

    def __init__(self, cfg, dropout_state: DropoutState):
        super().__init__()
        self.blocks = nn.ModuleList(
            [FEARecBlock(cfg, dropout_state, i) for i in range(cfg.num_hidden_layers)])

    def forward(self, x, attention_mask, all_layers: bool = False):
        outputs = [x]
        for block in self.blocks:
            x = block(x, attention_mask)
            outputs.append(x)
        return outputs if all_layers else x


def _spectral_l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    re, im = rfft_real_imag(a - b, dim=1)
    return torch.sqrt(re**2 + im**2 + 1e-12).mean()


class FEARecModel(SequentialRecModel):
    reads_same_target = True

    def loss_name(self, ce: str) -> str:
        cfg = self.config
        fredom = f", fredom {cfg.fredom_type}" if cfg.fredom else ""
        return f"{ce} + InfoNCE (ssl={cfg.ssl}{fredom})"

    def __init__(self, cfg, generator: torch.Generator | None = None, prng: str = "threefry"):
        super().__init__(cfg, prng)
        self.item_encoder = FEARecEncoder(cfg, self.dropout_state)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator | None = None) -> None:
        super().reset_parameters(generator)
        std = self.config.initializer_range
        for block in self.item_encoder.blocks:
            block.layer.reset_parameters(std, generator)
            block.feed_forward.reset_parameters(std, generator)

    def forward(self, input_ids, user_ids=None, all_layers: bool = False):
        mask = self.get_attention_mask(input_ids)
        x = self.add_position_embedding(input_ids)
        return self.item_encoder(x, mask, all_layers=all_layers)

    def calculate_loss(self, input_ids, answers, neg_answers=None, same_target=None,
                       user_ids=None, *, generator=None):
        cfg = self.config
        last = self.forward(input_ids)[:, -1, :]
        loss = full_softmax_ce(last, self.item_table, answers, impl=cfg.loss_impl,
                               dtype=cfg.compute_dtype)
        terms, aug, sem = contrastive_terms(cfg, self.forward, input_ids, same_target, last)
        loss = loss + terms
        if cfg.fredom:
            # us_x pairs the two [B, L, H] views along the time axis, as the
            # reference does; the other types are JAX's extension on the
            # [B, H] last-position states, along the hidden axis
            if cfg.fredom_type in ("us", "un") and aug is not None:
                loss = loss + 0.1 * _spectral_l1(last, aug[:, -1, :])
            if cfg.fredom_type in ("us", "su") and sem is not None:
                loss = loss + 0.1 * _spectral_l1(last, sem[:, -1, :])
            if cfg.fredom_type == "us_x" and aug is not None and sem is not None:
                loss = loss + 0.1 * _spectral_l1(aug, sem)
        return loss

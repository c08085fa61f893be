"""Fused dropout: the port's plain Philox against the published
known-answer vectors, the apply half against the JAX package's dropout
on the same random words, the mask's statistics and its independence of
the launch, and the forward/backward mask identity.

The TPU kernel's hardware bits cannot be made off the TPU, so the JAX
side is `fast_dropout` under `BSAREC_DROPOUT=pallas` on the CPU, which
takes its threshold path (`core/dropout.py:191-197`) with the words of
`jax.random.bits`; the port is fed those words. The zero pattern must be
identical. Kept values agree exactly at rate 0.5 (x * 2 == x / 0.5) and
within 1 ulp at rate 0.2, since JAX divides by keep_prob and the kernel
multiplies by 1 / keep_prob rounded to fp32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bsarec_tpu.core.dropout import fast_dropout
from bsarec_tpu_torch.models.modules import DropoutState, FusedDropout, make_dropout, use_fused_dropout
from bsarec_tpu_torch.ops import dropout as fd

# Random123's known-answer vectors for philox4x32-10: counter words, key
# words, output words
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
SEEDS = torch.tensor([0x1234ABCD, 0xFEDCBA98], dtype=torch.int64)


@pytest.mark.parametrize("counter,key,want", KAT)
def test_philox_known_answers(counter, key, want):
    words = fd.philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in counter],
                             [torch.tensor(k, dtype=torch.int64) for k in key])
    assert [int(w) for w in words] == list(want)


@pytest.mark.parametrize("rate", [0.5, 0.2])
@pytest.mark.parametrize("shape", [(8, 5, 16), (8, 2, 5, 5), (3, 7)])
def test_apply_matches_jax_on_the_same_bits(monkeypatch, rate, shape):
    monkeypatch.setenv("BSAREC_DROPOUT", "pallas")
    key = jax.random.PRNGKey(sum(shape))
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    want = np.asarray(fast_dropout(key, rate, jnp.asarray(x)))
    bits = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
    got = fd.dropout_from_bits(torch.from_numpy(x), torch.from_numpy(bits), rate).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    if rate == 0.5:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_apply_bf16_rounds_as_the_jax_rule():
    """bf16: x * inv_keep in bf16, the TPU kernel's rule (`pallas_dropout.py:77-82`)."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=4096).astype(np.float32)).bfloat16()
    bits = fd.philox_bits(x.numel(), SEEDS, 0)
    got = fd.dropout_from_bits(x, bits, 0.2)
    assert got.dtype == torch.bfloat16
    keep = bits >= fd.threshold(0.2)
    assert torch.equal(got[keep], (x[keep].float() * 1.25).bfloat16())
    assert not got[~keep].any()


@pytest.mark.parametrize("rate", [0.5, 0.2, 0.9])
def test_keep_rate_scale_and_chunks(rate):
    """The checks of `benchmarks/validate_pallas_dropout.py`: keep fraction
    within 0.01 of 1 - rate, kept values exactly inv_keep, and every
    64K-element chunk within 0.05."""
    x = torch.ones(256 * 50 * 64)
    y = fd.fused_dropout(x, rate, SEEDS, 3)
    kept = y != 0
    assert abs(float(kept.float().mean()) - (1 - rate)) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], fd.inv_keep(rate, torch.float32)))
    chunks = kept[: (x.numel() // 65536) * 65536].view(-1, 65536).float().mean(dim=1)
    assert float((chunks - (1 - rate)).abs().max()) < 0.05


def test_seed_and_call_sensitivity_and_determinism():
    x = torch.ones(50_000)
    base = fd.fused_dropout(x, 0.5, SEEDS, 0)
    assert torch.equal(base, fd.fused_dropout(x, 0.5, SEEDS.clone(), 0))
    for seeds, call in ((SEEDS + torch.tensor([1, 0]), 0), (SEEDS + torch.tensor([0, 1]), 0),
                        (SEEDS, 1)):
        other = fd.fused_dropout(x, 0.5, seeds, call)
        agree = float(((other != 0) == (base != 0)).float().mean())
        assert 0.45 < agree < 0.55  # independent masks agree on about half


def test_mask_is_a_function_of_the_index_only():
    """The words of a prefix are the prefix of the words: neither the
    element count nor the shape enters the mask. Only the low 32 bits of
    each seed word are the key."""
    long_bits = fd.philox_bits(4097, SEEDS, 5)
    for n in (1, 3, 4, 5, 4096):
        assert torch.equal(fd.philox_bits(n, SEEDS, 5), long_bits[:n])
    assert torch.equal(fd.philox_bits(64, SEEDS + (7 << 32), 5), long_bits[:64])
    assert int(long_bits.min()) >= 0 and int(long_bits.max()) < 1 << 32
    x = torch.randn(6, 7, generator=torch.Generator().manual_seed(0))
    assert torch.equal(fd.fused_dropout(x, 0.5, SEEDS, 5),
                       fd.fused_dropout(x.reshape(-1), 0.5, SEEDS, 5).view(6, 7))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_regenerates_the_forward_mask(dtype):
    x = (torch.rand(256, 2, 10, 10, generator=torch.Generator().manual_seed(0)) + 0.5).to(dtype)
    x.requires_grad_()
    y = fd.fused_dropout(x, 0.2, SEEDS, 4)
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    y.backward(g)
    assert torch.equal(x.grad != 0, y.detach() != 0)
    assert torch.equal(x.grad, fd.fused_dropout_plain(g, SEEDS, 0.2, 4))
    keep = y.detach() != 0
    assert torch.equal(y.detach()[keep], (x.detach()[keep].float() * 1.25).to(dtype))


def test_rate_zero_and_one():
    x = torch.randn(5, 8, requires_grad=True)
    assert fd.fused_dropout(x, 0.0, SEEDS, 0) is x
    y = fd.fused_dropout(x, 1.0, SEEDS, 0)
    assert not y.any()
    y.sum().backward()
    assert x.grad is None or not x.grad.any()
    with pytest.raises(NotImplementedError, match="float32 and bfloat16"):
        fd.fused_dropout(torch.ones(4, dtype=torch.float16), 0.5, SEEDS, 0)


def test_dropout_module_selection(monkeypatch):
    """The fused path needs both --prng rbg and BSAREC_DROPOUT=pallas; its
    sites take call indices in turn and need the step's seeds."""
    monkeypatch.delenv("BSAREC_DROPOUT", raising=False)
    assert not use_fused_dropout("rbg")
    monkeypatch.setenv("BSAREC_DROPOUT", "pallas")
    assert use_fused_dropout("rbg") and not use_fused_dropout("threefry")
    assert isinstance(make_dropout(0.5, DropoutState(fused=False)), torch.nn.Dropout)
    state = DropoutState(fused=True)
    sites = [make_dropout(0.5, state) for _ in range(3)]
    assert all(isinstance(s, FusedDropout) for s in sites)
    x = torch.ones(1000)
    with pytest.raises(RuntimeError, match="begin_step"):
        sites[0](x)
    state.begin_step(SEEDS)
    outs = [s(x) for s in sites]
    assert state.call == 3
    for call, out in enumerate(outs):
        assert torch.equal(out, fd.fused_dropout_plain(x, SEEDS, 0.5, call))
    sites[0].eval()
    assert sites[0](x) is x and state.call == 3


@pytest.mark.parametrize("rate", [-0.1, float("nan")])
def test_a_site_checks_its_rate_when_it_is_built(rate):
    """A bad rate raises where the site is made, not at its first call;
    rate 0 and rates >= 1 need no kernel constants."""
    state = DropoutState(fused=True)
    with pytest.raises(ValueError, match="rate"):
        make_dropout(rate, state)
    assert FusedDropout(0.0, state).site is None and FusedDropout(1.5, state).site is None
    site = FusedDropout(0.2, state).site
    assert site.rate == 0.2
    assert site.consts[torch.float32] == (0, fd.threshold(0.2), fd.inv_keep(0.2, torch.float32))
    assert site.consts[torch.bfloat16] == (1, fd.threshold(0.2), fd.inv_keep(0.2, torch.bfloat16))
    for bad in (1.0, -0.5):
        with pytest.raises(ValueError, match="rate"):
            fd.DropoutSite(bad)


@pytest.mark.parametrize("seeds", [
    SEEDS.int(),                      # int32
    torch.zeros(3, dtype=torch.int64),  # three words
    torch.zeros(2, 2, dtype=torch.int64)[:, 0],  # not contiguous
    [1, 2],                           # not a tensor
])
def test_a_step_checks_its_seeds_once(seeds):
    """`begin_step` rejects what the kernel cannot read; `dropout_apply`
    and `fused_dropout`, the per-call entries, check the same."""
    state = DropoutState(fused=True)
    with pytest.raises(ValueError, match="seeds"):
        state.begin_step(seeds)
    x = torch.ones(8)
    with pytest.raises(ValueError, match="seeds"):
        fd.dropout_apply(x, seeds, 0.5, 0)
    with pytest.raises(ValueError, match="seeds"):
        fd.fused_dropout(x, 0.5, seeds, 0)


def test_call_index_and_per_call_checks():
    """The call index is checked where it is made (`next_call`) and by the
    per-call entries; a site's call checks only x."""
    state = DropoutState(fused=True)
    site = make_dropout(0.5, state)
    state.begin_step(SEEDS)
    state.call = fd.MAX_CALLS - 1
    site(torch.ones(4))  # the last index the kernel's counter word takes
    with pytest.raises(ValueError, match="call index"):
        site(torch.ones(4))
    x = torch.ones(8)
    for call in (-1, 1 << 32):
        with pytest.raises(ValueError, match="call index"):
            fd.dropout_apply(x, SEEDS, 0.5, call)
        with pytest.raises(ValueError, match="call index"):
            fd.fused_dropout(x, 0.5, SEEDS, call)
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="rate"):
            fd.dropout_apply(x, SEEDS, rate, 0)
    state.begin_step(SEEDS)
    with pytest.raises(NotImplementedError, match="float32 and bfloat16"):
        site(torch.ones(4, dtype=torch.float16))
    # a non-contiguous input is made contiguous; the values are those of its copy
    y = torch.randn(6, 4, generator=torch.Generator().manual_seed(2)).T
    state.begin_step(SEEDS)
    assert torch.equal(site(y), fd.fused_dropout_plain(y.contiguous(), SEEDS, 0.5, 0))

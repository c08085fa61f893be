"""The vocab splits of the tensor-core CE kernels (`ops/ce.py:tc_splits`):
pure arithmetic, no card needed. The C entries `ce_logz` and `ce_grads`
refuse a launch whose splits are not whole tiles, leave a split empty or
fall short of V."""

import pytest

from bsarec_tpu_torch.ops import ce


@pytest.mark.parametrize("v", [1, 63, 64, 127, 128, 129, 12101, 1_000_001])
def test_tc_splits_are_whole_tiles_that_cover_the_catalog(v):
    for tile in (ce._TC_FWD_VT, ce._TC_VT):  # ce_fwd_wide_tc_kernel's, ce_bwd_wide_tc_kernel's
        unit = tile // ce._VT  # 64-column units a tile
        n_tiles = -(-v // tile)
        for sms in (1, 132):
            n_splits, per = ce.tc_splits(v, tile, sms)
            assert 1 <= n_splits <= min(sms, n_tiles)
            assert per % unit == 0 and per >= unit  # whole tiles, at least one a split
            assert n_splits * per * ce._VT >= v  # the splits cover V
            assert (n_splits - 1) * per * ce._VT < v  # the last split starts inside V
            assert per // unit == -(-n_tiles // min(sms, n_tiles))  # as even as whole tiles allow


@pytest.mark.parametrize("backward", [False, True], ids=["ce_logz", "ce_grads"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("route", ["onchip", "wide", "sweep", "mid"])
@pytest.mark.parametrize("v", [1, 129, 12101, 1_000_001])
def test_split_plan_meets_its_kernels_tiles(v, route, bf16, backward):
    """`ops/ce.py:split_plan`, the splits each C entry is launched with: on
    the on-chip, middle and wide routes one block per SM, each split whole
    tiles of the kernel the route and form take (the bf16 on-chip forward,
    ce_fwd_onchip_tc_kernel, the wide forward and the middle route's
    kernels in both forms, ce_fwd_mid_tc_kernel, ce_bwd_mid_tc_kernel,
    ce_fwd_mid_tf32_kernel and ce_bwd_wide_tf32_kernel, 128 columns; the
    wide backward
    256 in the bf16 form and 128 in the fp32 form; 64 elsewhere), at least
    one; on the sweeps two blocks per SM, the forward's over (splits x batch
    tiles of 64 rows); the splits cover V and none is empty."""
    b = 300 if route == "sweep" else 256
    if route == "wide":
        tile = ((ce._TC_VT if bf16 else ce._TF_VT) if backward else ce._TC_FWD_VT)
    elif route == "onchip" and bf16 and not backward:
        tile = ce._TC_FWD_VT
    elif route == "mid":
        tile = ce._MID_VT if backward else ce._TC_FWD_VT
        assert ce._MID_VT == ce._TF_VT  # the fp32 backward there, ce_bwd_wide_tf32_kernel's tiles
    else:
        tile = ce._VT
    unit = tile // ce._VT
    sweep = route == "sweep"
    for sms in (1, 132):
        n_splits, per = ce.split_plan(b, v, route == "onchip", route == "wide", bf16, backward, sms,
                                      mid=route == "mid")
        assert per % unit == 0 and per >= unit
        assert n_splits * per * ce._VT >= v  # the splits cover V
        assert (n_splits - 1) * per * ce._VT < v  # the last split starts inside V
        if sweep:
            rows = 1 if backward else -(-b // ce._BT)  # the forward's grid: splits x batch tiles
            assert 1 <= n_splits <= -(-2 * sms // rows)
        else:
            assert 1 <= n_splits <= sms
            assert per // unit == -(-(-(-v // tile)) // min(sms, -(-v // tile)))  # even as whole tiles allow

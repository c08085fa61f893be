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

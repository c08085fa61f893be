"""The vocab splits of the rank kernel's tensor-core and middle routes
(`ops/rank.py:_splits(..., tc=True)`, which both take): pure arithmetic,
no card needed. The C entry `streaming_rank` refuses a launch on those
routes whose splits leave a split empty or fall short of V. The tile
width the wrapper plans with is the kernels' (read from the CUDA
sources)."""

import inspect
import re

import pytest

from bsarec_tpu_torch.ops import _build, rank


@pytest.mark.parametrize("route,batches", [("tc", (1, 16, 256, 300)), ("mid", (1, 16, 256))])
@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("v", [1, 127, 128, 129, 12101, 1_000_001])
def test_tc_splits_are_whole_tiles_that_cover_the_catalog(v, sms, route, batches):
    """On the tensor-core route at any B, on the middle route at B <= 256."""
    n_tiles = -(-v // rank._VT)  # 128-column tiles: tiles_per_split counts whole ones
    for b in batches:  # one block per SM whatever B
        n_splits, per = rank._splits(b, v, False, sms, tc=True)
        assert 1 <= n_splits <= min(sms, n_tiles)
        assert per >= 1
        assert n_splits * per >= n_tiles  # the splits cover V
        assert (n_splits - 1) * per < n_tiles  # the last split starts inside V: none is empty
        assert per == -(-n_tiles // min(sms, n_tiles))  # as even as whole tiles allow


def test_tc_tile_width_is_the_kernels():
    """rank_wide_tf32_kernel walks tiles of tc::WIDE_COLS = 128 columns,
    the wrapper's `_VT`."""
    source = _build.SOURCES["streaming_rank"].read_text()
    header = (_build.SOURCES["streaming_rank"].parent / "tensor_core.cuh").read_text()
    assert re.search(r"constexpr int TW_COLS = tc::WIDE_COLS;", source)
    assert int(re.search(r"constexpr int WIDE_COLS = (\d+);", header).group(1)) == rank._VT


def test_mid_tile_width_is_the_kernels():
    """rank_mid_tf32_kernel walks tiles of MF_COLS = 128 columns
    (wgmma_tf32_tile.cuh), the wrapper's `_VT`, and its source ties them to
    the older route's and the tensor-core route's tiles; the wrapper plans
    the middle route's splits as the tensor-core route's."""
    csrc = _build.SOURCES["streaming_rank"].parent
    source = _build.SOURCES["streaming_rank"].read_text()
    header = (csrc / "wgmma_tf32_tile.cuh").read_text()
    assert '#include "wgmma_tf32_tile.cuh"' in source
    assert int(re.search(r"constexpr int MF_COLS = (\d+);", header).group(1)) == rank._VT
    assert re.search(r"MF_COLS == TW_COLS && MF_COLS == VT", source)
    launch = inspect.getsource(rank._launch)
    assert "_splits(b, v, onchip, sm_count(index), tc or mid)" in launch

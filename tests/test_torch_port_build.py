"""The kernel build's cache key (`bsarec_tpu_torch/ops/_build.py`): a
library is named by a hash of its source and of every header beside it,
so an edited header never loads a stale library. Runs without nvcc."""

import re
import shutil

from bsarec_tpu_torch.ops import _build


def test_every_included_header_is_in_csrc():
    """The headers that the sources include by quotes are the `*.cuh`
    files the hash covers."""
    for path in _build.SOURCES.values():
        for header in re.findall(r'#include "([^"]+)"', path.read_text()):
            assert (path.parent / header).is_file() and header.endswith(".cuh"), (path, header)


def test_library_path_follows_the_source_and_its_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.SOURCES["streaming_ce"].parent, csrc)
    monkeypatch.setattr(_build, "SOURCES", {"streaming_ce": csrc / "streaming_ce.cu"})
    first = _build.library_path("streaming_ce")
    assert first.parent == _build.BUILD_DIR and first.name.startswith("streaming_ce-")
    assert _build.library_path("streaming_ce") == first
    header = csrc / "onchip_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    second = _build.library_path("streaming_ce")
    assert second != first
    source = csrc / "streaming_ce.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    assert _build.library_path("streaming_ce") not in (first, second)


def test_ablation_variants_apply_to_the_source():
    """`tools/ablate_ce_tc.py` cuts parts out of the tensor-core kernel by
    text replacement; each replacement still matches the source exactly
    once (so the tool's readings mean what PERF.md says)."""
    from bsarec_tpu_torch.tools import ablate_ce_tc

    texts = ablate_ce_tc.sources()
    assert list(texts) == list(ablate_ce_tc.VARIANTS)
    assert len(set(texts.values())) == len(texts)


def test_rank_ablation_variants_apply_to_the_source():
    """`tools/ablate_rank_tc.py` cuts parts out of the rank kernel's
    tensor-core route by text replacement; each replacement still matches
    the source exactly once."""
    from bsarec_tpu_torch.tools import ablate_rank_tc

    texts = ablate_rank_tc.sources()
    assert list(texts) == list(ablate_rank_tc.VARIANTS)
    assert len(set(texts.values())) == len(texts)


def test_onchip_ablation_variants_apply_to_the_source():
    """`tools/ablate_ce_tc.py --onchip` routes the bf16 on-chip shapes to the
    wide tensor-core kernels and cuts parts out of the on-chip tensor-core
    kernels by text replacement; each replacement still matches the source
    exactly once, and every variant differs from the others."""
    from bsarec_tpu_torch.tools import ablate_ce_tc

    texts = ablate_ce_tc.sources(ablate_ce_tc.ONCHIP_VARIANTS)
    assert list(texts) == list(ablate_ce_tc.ONCHIP_VARIANTS)
    assert len(set(texts.values())) == len(texts)


def test_mid_ablation_variants_apply_to_the_source():
    """`tools/ablate_ce_tc.py --mid` routes the bf16 middle-route shapes to
    the wide kernels and the older sweeps, cuts parts out of the middle
    pair and builds the backward's other choice (the wide kernel's tiling
    with the states streamed from fp32, no scratch); each replacement still
    matches the source exactly once, every variant differs from the
    others, and the streamed variants launch no states_bf16_kernel from
    ce_grads."""
    from bsarec_tpu_torch.tools import ablate_ce_tc

    texts = ablate_ce_tc.sources(ablate_ce_tc.MID_VARIANTS)
    assert list(texts) == list(ablate_ce_tc.MID_VARIANTS)
    assert len(set(texts.values())) == len(texts)
    streamed = [name for name in texts if "states streamed from fp32" in name]
    assert len(streamed) == 2
    for name in streamed:
        entry = texts[name][texts[name].index("int ce_grads("):]
        assert "states_bf16_kernel<<<" not in entry
        assert "ce_bwd_wide_tc_kernel<<<" in entry
    assert "states_bf16_kernel<<<" in texts["kernel"][texts["kernel"].index("int ce_grads("):]


def test_mid_fp32_ablation_variants_apply_to_the_source():
    """`tools/ablate_ce_tc.py --mid`'s fp32 variants: the forward's
    yardstick (the fp32 middle shapes on the wide 3xTF32 kernels from both
    C entries), the backward on the wgmma kernel ce_bwd_mid_tf32_kernel
    (the source routes it to ce_bwd_wide_tf32_kernel), the logits'
    partial-sum lengths, and each new kernel's MMAs alone and memory path
    alone; each replacement matches once, and every variant but the
    yardstick keeps the wgmma backward."""
    from bsarec_tpu_torch.tools import ablate_ce_tc

    texts = ablate_ce_tc.sources(ablate_ce_tc.MID_VARIANTS)
    fp32 = [name for name in texts if name.startswith("fp32 ")]
    assert {"fp32 on the wide 3xTF32 kernels", "fp32 backward on ce_bwd_mid_tf32_kernel",
            "fp32 middle kernels: MMAs alone", "fp32 middle kernels: everything but the MMAs",
            "fp32 partial sums of one k8 block"} <= set(fp32)
    assert "on the older sweeps" in ablate_ce_tc.MID_BOTH_FORMS
    wgmma_bwd = "auto sweep = bf16 ? ce_bwd_mid_tc_kernel : ce_bwd_mid_tf32_kernel;"
    assert wgmma_bwd not in texts["kernel"]
    assert "const bool tc = wide_route(H) || (!bf16 && mid_route(B, H));" in texts["kernel"]
    for name in fp32:
        assert (wgmma_bwd in texts[name]) == (name != "fp32 on the wide 3xTF32 kernels"), name
    yardstick = texts["fp32 on the wide 3xTF32 kernels"]
    assert "const bool wide = wide_route(H) || (!bf16 && mid_route(B, H));" in yardstick
    assert "const bool tc = wide_route(H) || (!bf16 && mid_route(B, H));" in yardstick
    assert "constexpr int MF_CHAIN = 2;" in texts["kernel"]
    assert "constexpr int MF_CHAIN = 1;" in texts["fp32 partial sums of one k8 block"]
    assert "wg::mma_3xtf32" not in texts["fp32 middle kernels: everything but the MMAs"].split(
        "__global__ void __launch_bounds__(THREADS, 1)\nce_fwd_mid_tf32_kernel(")[1].split(
        "bool bad_shape(")[0]

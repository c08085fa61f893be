"""What every kernel wrapper reads on the host before a launch.

- `raw_stream(index)`: the current stream's `cudaStream_t` as an int,
  from `torch._C._cuda_getCurrentRawStream` (PyTorch's own generated
  kernels read it so), without building a `torch.cuda.Stream` object;
- `current_device()`: `torch._C._cuda_getDevice`;
- `sm_count(index)`: the card's SM count, read once per device.

The private functions are looked up at the call, so a CPU-only build of
PyTorch imports this module. A wrapper switches devices only when its
tensor lies on another card than the current one. Nothing here touches
CUDA at import time.
"""

from __future__ import annotations

import functools

import torch


def raw_stream(index: int) -> int:
    return torch._C._cuda_getCurrentRawStream(index)


def current_device() -> int:
    return torch._C._cuda_getDevice()


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def call_on(index: int, fn, *args) -> int:
    """fn(*args) with card `index` current; the device switch is skipped
    when it already is."""
    if index == current_device():
        return fn(*args)
    with torch.cuda.device(index):
        return fn(*args)

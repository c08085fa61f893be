"""The host-fed input pipeline (counterpart of `bsarec_tpu/data/multihost.py`).

`--multihost` keeps the training set in host memory for the whole run.
Every data rank reads only its rows of each global batch and moves them
to its device, so no device ever holds the training set, and the global
batch schedule is the device-resident epoch's, batch for batch.

In JAX a process is a host that owns several devices; in the port every
rank owns one device, so the unit that owns a slice of each global batch
is the data rank: `(mesh.data_rank, mesh.data)` under a mesh
(`core/mesh.py`), `(0, 1)` without one. The ranks of one model group
read the same rows, as `core/mesh.py:data_rows` gives them. Each function
takes the index and the count from the active mesh, or as arguments.

- `init_distributed()` joins `torch.distributed` from the launcher's
  environment (a no-op without one, or when a group exists);
- `host_shard(n)` is this data rank's contiguous [lo, hi) row range;
- `global_batch(local, mesh, global_rows, device)` moves this rank's
  rows of a global batch to its device: int32 through pinned host memory,
  widened to int64 there. No rank builds the global batch;
- `HostShardedDataset` yields the local rows of every global batch of an
  epoch, the same schedule on every rank (use a np.memmap so that rows
  no rank reads never load).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bsarec_tpu_torch.config import resolve_device
from bsarec_tpu_torch.core import mesh as meshlib


def init_distributed(device_type: str = "cuda") -> None:
    """Join the process group of the launcher's environment (`RANK`,
    `WORLD_SIZE`, `MASTER_ADDR`, `MASTER_PORT`; NCCL on the card, gloo on
    the CPU). A no-op when a group exists already or when no launcher
    environment is set (a single-process run); any other failure
    propagates: going on alone would let every process train as an
    independent job with duplicated work."""
    meshlib.join_launcher_group(meshlib.rank_device(device_type))


def data_process(process_index: int | None = None,
                 process_count: int | None = None) -> tuple[int, int]:
    """(index, count) of this data rank: the arguments where given, else
    the active mesh's `(data_rank, data)`, else `(0, 1)`."""
    mesh = meshlib.current_mesh()
    index, count = (0, 1) if mesh is None else (mesh.data_rank, mesh.data)
    index = index if process_index is None else process_index
    count = count if process_count is None else process_count
    if not 0 <= index < count:
        raise ValueError(f"data rank {index} out of {count}")
    return index, count


def host_shard(n_rows: int, process_index: int | None = None,
               process_count: int | None = None) -> tuple[int, int]:
    """This data rank's contiguous [lo, hi) slice of a global row range."""
    p, n = data_process(process_index, process_count)
    per = -(-n_rows // n)
    return p * per, min((p + 1) * per, n_rows)


class PinnedStaging:
    """The host buffers that batches pass through on their way to `device`:
    `slots` int32 buffers, pinned on the card and used in turn. A copy out
    of a pinned buffer is non-blocking, so before a buffer is written again
    the host waits on the event recorded after the copy that last read it:
    a step never reads rows that a later step wrote. On the CPU the
    widening copies the rows out of the buffer, and no event is needed."""

    def __init__(self, device: torch.device, slots: int = 2):
        self.device = device
        self._cuda = device.type == "cuda"
        self._buffers: list[torch.Tensor | None] = [None] * slots
        self._events: list[torch.cuda.Event | None] = [None] * slots
        self._next = 0

    def to_device(self, local: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """Every field of `local` as an int64 tensor on the device, all of
        them in one copy of their int32 concatenation (item and user ids
        fit in int32)."""
        n = sum(v.size for v in local.values())
        slot = self._next
        self._next = (slot + 1) % len(self._buffers)
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        buf = self._buffers[slot]
        if buf is None or buf.numel() < n:
            buf = torch.empty(n, dtype=torch.int32, pin_memory=self._cuda)
            self._buffers[slot] = buf
        host = buf.numpy()
        offset = 0
        for v in local.values():
            host[offset:offset + v.size] = v.reshape(-1)
            offset += v.size
        flat = buf[:n].to(self.device, non_blocking=True)
        if self._cuda:
            event = torch.cuda.Event()
            event.record()
            self._events[slot] = event
        out, offset = {}, 0
        for k, v in local.items():
            out[k] = flat[offset:offset + v.size].view(v.shape).long()
            offset += v.size
        return out


def global_batch(local: dict[str, np.ndarray], mesh: meshlib.Mesh | None, global_rows: int,
                 device: torch.device | str | None = None,
                 staging: PinnedStaging | None = None) -> dict[str, torch.Tensor]:
    """This data rank's rows of a global batch of `global_rows`, each field
    moved to the device as int64: JAX assembles the global array, here
    each rank goes on with its own rows. The rows must be
    `mesh.data_slice(global_rows)`'s count (all of them without a mesh).
    `staging` carries the pinned buffers, and the device, from one step to
    the next; without it one is made for the call, on `device` (the
    mesh's by default, else the card)."""
    rows = mesh.data_slice(global_rows) if mesh is not None else slice(0, global_rows)
    want = rows.stop - rows.start
    for k, v in local.items():
        if v.shape[0] != want:
            raise ValueError(f"field {k!r} holds {v.shape[0]} rows, this data rank's share of a "
                             f"global batch of {global_rows} is {want}")
    if staging is None:
        if device is None:
            device = mesh.device if mesh is not None else "cuda"
        staging = PinnedStaging(resolve_device(device), slots=1)
    return staging.to_device(local)


@dataclasses.dataclass
class HostShardedDataset:
    """A batch schedule over global arrays that every data rank draws alike
    (the same seed), each rank reading only its slice of every global
    batch, in the single run's global batch order.

    `process_index` and `process_count` are the data rank and the number
    of data ranks (`data_process`: the active mesh's when not given)."""

    # the GLOBAL arrays, indexed by global row id (a np.memmap works: a
    # rank reads only the rows it owns, nothing loads the rest)
    fields: dict[str, np.ndarray]
    batch_size: int  # global batch size
    seed: int
    process_index: int | None = None
    process_count: int | None = None

    def __post_init__(self):
        self.n_rows = next(iter(self.fields.values())).shape[0]
        self.process_index, self.process_count = data_process(self.process_index,
                                                              self.process_count)
        if self.batch_size % self.process_count:
            raise ValueError(
                f"process count ({self.process_count}) must divide the global batch "
                f"size ({self.batch_size})"
            )
        self.local_batch = self.batch_size // self.process_count

    def epoch_batches(self, epoch: int):
        """Yield this rank's local batch dicts for one epoch (feed each to
        `global_batch`): a permutation from `(seed, epoch)`, the trailing
        partial batch dropped, as JAX does."""
        rng = np.random.default_rng((self.seed, epoch))
        perm = rng.permutation(self.n_rows)
        steps = self.n_rows // self.batch_size
        yield from self.epoch_batches_from_perm(perm[: steps * self.batch_size])

    def epoch_batches_from_perm(self, perm: np.ndarray):
        """Local slices of a given global batch schedule, whose length must
        be a multiple of the global batch size. The Trainer passes the
        device-resident epoch's flattened `[steps * B]` schedule
        (`train/loop.py:epoch_permutation`, wrapped so that the last batch
        is full), which makes the host-fed run's global batches that
        epoch's."""
        if len(perm) % self.batch_size:
            raise ValueError(
                f"schedule length {len(perm)} not a multiple of the "
                f"global batch size {self.batch_size}"
            )
        lo = self.process_index * self.local_batch
        for s in range(len(perm) // self.batch_size):
            rows = perm[s * self.batch_size: (s + 1) * self.batch_size]
            mine = rows[lo: lo + self.local_batch]
            yield {k: v[mine] for k, v in self.fields.items()}

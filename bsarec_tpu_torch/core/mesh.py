"""The ("data", "model") device mesh over `torch.distributed` (counterpart
of `bsarec_tpu/core/mesh.py`).

The "data" axis carries batch-parallel replicas of the dense towers; the
"model" axis splits the item table's rows (vocab sharding). JAX leaves
the collectives to XLA's partitioner; here they are explicit:
`parallel/embedding.py` and `parallel/logits.py` reduce or gather over
the model group, and the training loop averages every gradient over the
data group after each backward.

Ranks run row-major, as JAX's `reshape(data, model)` lays out its
devices: rank = data_index * model + model_index. The process group
comes from the launcher's environment (`torchrun` sets `RANK`,
`WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), or is one
that the caller initialized already; with neither, a one-rank group is
made on its own in-process store. The backend is NCCL on the card (the
rank's device is `cuda:LOCAL_RANK`) and gloo on the CPU. A mesh whose
size is not the world size raises: JAX takes the first data * model
devices it finds, a process group has no spare ranks to leave out.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """How to carve the ranks into (data, model) axes."""

    data: int = -1  # -1: every rank the model axis leaves
    model: int = 1

    def resolve(self, world_size: int) -> tuple[int, int]:
        model = max(1, self.model)
        data = self.data if self.data > 0 else max(1, world_size // model)
        if data * model != world_size:
            raise ValueError(f"mesh {data}x{model} needs {data * model} ranks, the process "
                             f"group has {world_size}")
        return data, model


def parse_mesh_spec(spec: str) -> MeshConfig | None:
    """"" -> None; "auto" -> every rank data-parallel; "data:N,model:M"."""
    if not spec:
        return None
    if spec == "auto":
        return MeshConfig()
    kw = {}
    for part in spec.split(","):
        axis, _, n = part.partition(":")
        kw[axis.strip()] = int(n)
    return MeshConfig(**kw)


def rank_device(device_type: str) -> torch.device:
    """This rank's device: `cuda:LOCAL_RANK` (made current) on the card,
    the CPU otherwise."""
    if device_type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("a process group on the card asked for, but CUDA is not available")
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(device)
    return device


def join_launcher_group(device: torch.device) -> bool:
    """Join the group of the launcher's environment (`RANK`, `WORLD_SIZE`,
    `MASTER_ADDR`, `MASTER_PORT`): NCCL on the card, gloo on the CPU.
    True when a group exists afterwards (joined here or before), False
    when there is none and no launcher environment; a group that fails to
    form raises."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method="env://")
    return True


def init_process_group(device_type: str) -> torch.device:
    """Join (or make) the process group; returns this rank's device. The
    launcher's environment when it is set, else a one-rank group on an
    in-process store. On the card the group is NCCL's and its failure to
    form raises."""
    device = rank_device(device_type)
    if not join_launcher_group(device):
        backend = "nccl" if device.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return device


class Mesh:
    """A 2-D `DeviceMesh` over ("data", "model") with this rank's place in
    it: `data_rank`, `model_rank`, their groups, and `shape` as a dict, as
    JAX's `Mesh.shape` reads."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.data, self.model = device_mesh.shape
        self.shape = {DATA_AXIS: self.data, MODEL_AXIS: self.model}
        self.data_rank = device_mesh.get_local_rank(DATA_AXIS)
        self.model_rank = device_mesh.get_local_rank(MODEL_AXIS)
        self.data_group = device_mesh.get_group(DATA_AXIS)
        self.model_group = device_mesh.get_group(MODEL_AXIS)

    @property
    def is_writer(self) -> bool:
        """Rank 0, which writes the run's files and logs."""
        return dist.get_rank() == 0

    def data_slice(self, global_rows: int) -> slice:
        """This rank's rows of a global batch of `global_rows`."""
        if global_rows % self.data:
            raise ValueError(f"a global batch of {global_rows} rows does not split over "
                             f"{self.data} data ranks")
        b = global_rows // self.data
        return slice(self.data_rank * b, (self.data_rank + 1) * b)


def make_mesh(config: MeshConfig | None = None, device_type: str = "cuda") -> Mesh:
    """The mesh over every rank of the (joined or made) process group."""
    from torch.distributed.device_mesh import init_device_mesh

    device = init_process_group(device_type)
    data, model = (config or MeshConfig()).resolve(dist.get_world_size())
    dm = init_device_mesh(device.type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    mesh = Mesh(dm, device)
    # NCCL forms a group's communicator at its first collective: form both
    # here, so that a group that cannot form fails before the run starts and
    # the first epoch does not carry the set-up
    for group in (mesh.data_group, mesh.model_group):
        dist.all_reduce(torch.zeros(1, device=device), group=group)
    return mesh


def data_rows(x: torch.Tensor, mesh: Mesh | None) -> torch.Tensor:
    """This rank's rows of the global batch `x` (all of it without a mesh)."""
    return x if mesh is None else x[mesh.data_slice(x.shape[0])]


# The mesh a Trainer is running on. The model code (losses, lookups, the
# cloze draw) reads it, as JAX's loss reads its registered mesh at trace
# time; the Trainer sets it around its training and eval calls.
_ACTIVE_MESH: Mesh | None = None


def set_active_mesh(mesh: Mesh | None) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def active_mesh() -> Mesh:
    if _ACTIVE_MESH is None:
        raise RuntimeError("no active mesh registered (set_active_mesh); "
                           "'sharded_streaming' impls require a Trainer mesh run")
    return _ACTIVE_MESH


def current_mesh() -> Mesh | None:
    """The active mesh, or None outside a mesh run."""
    return _ACTIVE_MESH


@contextlib.contextmanager
def using_mesh(mesh: Mesh | None):
    """`mesh` active inside the block, the previous one after it."""
    before = _ACTIVE_MESH
    set_active_mesh(mesh)
    try:
        yield mesh
    finally:
        set_active_mesh(before)


def global_rows(b: int) -> tuple[int, slice]:
    """(rows of the global batch, this rank's slice of them) for a local
    batch of `b` rows: what a draw that must equal the single run's (the
    cloze positions) draws and keeps."""
    mesh = _ACTIVE_MESH
    if mesh is None or mesh.data == 1:
        return b, slice(0, b)
    return b * mesh.data, slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)


# ---- collectives -------------------------------------------------------------
#
# Every rank of a model group computes the same loss from the same states,
# so the autograd rules are those of a replicated value (Megatron-LM's f
# and g): a sum over the group is the identity backwards, and a value
# copied into per-shard work sums its gradient over the group.


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, summed):
        ctx.rank, ctx.group, ctx.summed = dist.get_rank(group), group, summed
        parts = [torch.empty_like(x) for _ in range(_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, grad):
        if ctx.summed:
            grad = grad.contiguous().clone()
            dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank], None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; backwards, the gradient summed over `group` (a value
    every rank holds, fed into each rank's share of the work)."""
    return x if _size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group`; backwards the identity (every rank goes on
    with the same sum and takes the same gradient)."""
    return x if _size(group) == 1 else _ReduceFromGroup.apply(x, group)


def gather_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] every rank's `x` in rank order; backwards, this rank's slot
    of its own gradient: every rank goes on with the same stack."""
    return x[None] if _size(group) == 1 else _Gather.apply(x, group, False)


def gather_summed(x: torch.Tensor, group) -> torch.Tensor:
    """[n, ...] every rank's `x` in rank order; backwards, this rank's slot
    summed over every rank's gradient (as `torch.distributed.nn`'s
    all_gather): the rule for ranks that each go on with their own loss
    over the stack and whose gradients are averaged afterwards."""
    return x[None] if _size(group) == 1 else _Gather.apply(x, group, True)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of a value that takes no gradient."""
    out = x.detach().contiguous().clone()
    if _size(group) > 1:
        dist.all_reduce(out, group=group)
    return out

"""Data and tensor parallelism, the port's counterpart of
`mde_tpu/parallel/mesh.py` and of what `mde_tpu/kernels/sharded.py` means for
the training step.

The JAX package runs one program over a ('data',) or ('data', 'model') mesh:
GSPMD shards the batch over 'data', and the step's loss is the loss of the
*global* batch, with batch statistics and SILog's variance over every data
shard's pixels; `train_state_sharding` splits the targeted layers' weights
over 'model'. The port runs one process a rank (torchrun, or a caller that
spawns them) and keeps those numbers:

* The process grid (`Grid`). `--mesh_shape d,m` puts a world of d·m ranks on
  a (data, model) grid as `make_mesh` reshapes its devices: rank r has data
  index r // m and model index r % m (`mde_tpu/parallel/mesh.py:50-52`). The
  **model group** holds the m ranks of one data index, which see the same
  images and each hold a slice of the tensor-parallel layers
  (`parallel/tensor.py`, `models/tp.py`); the **data group** holds the d
  ranks of one model index, which see different images. One size (`8`), or
  none, is data parallelism over the whole world (m = 1). A world that is
  not d·m raises, where JAX takes the first d·m devices and leaves the rest
  idle: a rank outside the grid would hang the collectives.
* `init_distributed(rank, world_size, init_method, backend, device,
  mesh_shape)` joins the process group, NCCL on cuda and gloo on the CPU
  unless the caller names the backend, and makes the grid's subgroups. The
  data group is `sync_group()`, the group of the collectives inside the
  model and the loss (BatchNorm's moments, SILog's sums): with several data
  ranks it is a group of its own even where it spans the world, so that its
  collectives, which run inside autograd, never interleave with DDP's
  gradient buckets on the default group. `maybe_init_distributed(args)`
  reads torchrun's environment and `--mesh_shape`.
* `all_reduce_sum(t)` sums over the data group through
  `torch.distributed.nn.functional.all_reduce`, whose backward sums the
  ranks' gradients. Every rank then computes the same global value; its
  backward hands each rank d times its share of the global gradient, and
  the mean over the d data ranks gives the global gradient (module
  docstring of `train/loop.py`). The model group's own collectives, whose
  backward must not sum, are `parallel/tensor.py`'s.
* `shard_batch_size` is `mde_tpu/parallel/mesh.py:135-145`, given the
  grid's data size as JAX reads the mesh's data axis.
"""

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Grid:
    """A rank's place on the (data, model) grid of a world of data·model
    ranks, in JAX's device order: data index rank // model, model index
    rank % model."""
    data: int = 1
    model: int = 1
    rank: int = 0

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def model_ranks(self, data_index: int = None) -> list:
        """The ranks of the model group of `data_index` (this rank's by
        default)."""
        i = self.data_index if data_index is None else data_index
        return [i * self.model + j for j in range(self.model)]

    def data_ranks(self, model_index: int = None) -> list:
        """The ranks of the data group of `model_index` (this rank's by
        default)."""
        j = self.model_index if model_index is None else model_index
        return [i * self.model + j for i in range(self.data)]


_GRID = Grid()
_SYNC_GROUP = None   # the data group, with more than one data rank
_MODEL_GROUP = None  # the model group, with more than one model rank


def parse_mesh_shape(mesh_shape, world_size: int) -> tuple:
    """(data, model) of `--mesh_shape` ('d,m', one size 'd', or None for the
    whole world on the data axis) for a world of `world_size` ranks; raises
    unless the grid holds exactly the world."""
    sizes = [int(s) for s in str(mesh_shape or "").split(",") if s.strip()]
    if not sizes:
        sizes = [world_size]
    if len(sizes) > 2 or min(sizes) < 1:
        raise ValueError(f"--mesh_shape {mesh_shape!r}: expected 'data' or 'data,model' sizes")
    d, m = (sizes + [1])[:2]
    if d * m != world_size:
        raise ValueError(f"--mesh_shape {mesh_shape!r} asks for {d} x {m} = {d * m} ranks, "
                         f"but the world has {world_size}: start {d * m} processes")
    return d, m


def world() -> tuple:
    """(rank, world_size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def grid() -> Grid:
    """This rank's grid; Grid() (one rank) without a process group."""
    return _GRID


def sync_group():
    """The data group (the in-model and loss collectives of the global
    batch), or None with one data rank."""
    return _SYNC_GROUP


def model_group():
    """The model group (the tensor-parallel layers' collectives), or None
    with one model rank."""
    return _MODEL_GROUP


def init_distributed(rank: int, world_size: int, init_method: str,
                     backend: str = None, device: str = "cuda", mesh_shape=None):
    """Join a process group of `world_size` ranks as `rank` and make the
    subgroups of the `mesh_shape` grid; `backend` defaults to NCCL for a
    cuda `device` and gloo for the CPU."""
    global _GRID, _SYNC_GROUP, _MODEL_GROUP
    d, m = parse_mesh_shape(mesh_shape, world_size)
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    _GRID = Grid(d, m, rank)
    # every rank makes every group, in the same order
    if m > 1:
        for i in range(d):
            group = dist.new_group(_GRID.model_ranks(i))
            if i == _GRID.data_index:
                _MODEL_GROUP = group
    if d > 1:
        for j in range(m):
            group = dist.new_group(_GRID.data_ranks(j))
            if j == _GRID.model_index:
                _SYNC_GROUP = group
    return rank, world_size


def maybe_init_distributed(args, backend: str = None) -> tuple:
    """With `--distributed` under torchrun (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT set), join its group on the grid `--mesh_shape` names;
    returns (rank, world_size), (0, 1) otherwise. A cuda run takes the card
    LOCAL_RANK names. A group that is already there must hold that grid; a
    mesh of more than one rank without a group raises."""
    mesh_shape = getattr(args, "mesh_shape", None)
    if dist.is_initialized():
        rank, world_size = world()
        if mesh_shape and parse_mesh_shape(mesh_shape, world_size) != (_GRID.data, _GRID.model):
            raise ValueError(f"--mesh_shape {mesh_shape}: the process group was made on a "
                             f"{_GRID.data},{_GRID.model} grid")
        return rank, world_size
    if not (getattr(args, "distributed", False) and "WORLD_SIZE" in os.environ):
        parse_mesh_shape(mesh_shape, 1)
        return 0, 1
    device = getattr(args, "device", "cuda")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    return init_distributed(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                            "env://", backend, device, mesh_shape)


def destroy_distributed():
    global _GRID, _SYNC_GROUP, _MODEL_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _GRID, _SYNC_GROUP, _MODEL_GROUP = Grid(), None, None


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of `t` over the ranks of `sync_group()`, differentiable; `t`
    itself with one data rank."""
    if _SYNC_GROUP is None:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, op=dist.ReduceOp.SUM, group=_SYNC_GROUP)


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """Mean of a detached `t` over the data ranks (logged scalars)."""
    if _SYNC_GROUP is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=_SYNC_GROUP)
    return t / dist.get_world_size(_SYNC_GROUP)


def broadcast_object(obj, src: int = 0):
    """`obj` of rank `src` on every rank (the run id, the experiment
    directory, the validation's metrics)."""
    if not (dist.is_available() and dist.is_initialized()):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def shard_batch_size(global_bs: int, data_size: int, use_new_batching: bool) -> int:
    """Both reference batching policies (train.py:286-293): legacy (default),
    `bs` is the global batch, split over the data ranks and rounded down to
    a multiple of them (at least one a rank); use_new_batching, `bs` is per
    data rank. Returns the global batch."""
    n = data_size
    if use_new_batching:
        return global_bs * n
    if global_bs % n != 0:
        return max(n, (global_bs // n) * n)
    return global_bs

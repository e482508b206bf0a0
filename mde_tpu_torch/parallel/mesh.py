"""Data parallelism, the port's counterpart of `mde_tpu/parallel/mesh.py` and
of what `mde_tpu/kernels/sharded.py` means for the training step.

The JAX package runs one program over a ('data',) mesh: GSPMD shards the
batch, and the step's loss is the loss of the *global* batch, with batch
statistics and SILog's variance over every device's pixels. The port runs
one process a rank (torchrun, or a caller that spawns them) and keeps those
numbers:

* `init_distributed(rank, world_size, init_method, backend)` joins the
  process group, NCCL on cuda and gloo on the CPU unless the caller names
  the backend, and with more than one rank makes a second group, `sync_group()`,
  for the collectives inside the model and the loss (BatchNorm's moments,
  SILog's sums). They run inside autograd, so they get their own group and
  never interleave with DDP's gradient buckets on the default one.
  `maybe_init_distributed(args)` reads torchrun's environment.
* `all_reduce_sum(t)` sums over the ranks through
  `torch.distributed.nn.functional.all_reduce`, whose backward sums the
  ranks' gradients. Every rank then computes the same global value; its
  backward hands each rank R times its share of the global gradient, and
  DDP's mean over R ranks gives the global gradient (module docstring of
  `train/loop.py`).
* `shard_batch_size` is `mde_tpu/parallel/mesh.py:135-145` with the world
  size in place of the mesh's data axis.

Tensor parallelism (`--mesh_shape d,m`, `train_state_sharding`) is not
ported: the flag parses and changes nothing.
"""

import os

import torch
import torch.distributed as dist

_SYNC_GROUP = None


def world() -> tuple:
    """(rank, world_size) of this process; (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def sync_group():
    """The group of the in-model collectives, or None with one rank."""
    return _SYNC_GROUP


def init_distributed(rank: int, world_size: int, init_method: str,
                     backend: str = None, device: str = "cuda"):
    """Join a process group of `world_size` ranks as `rank`; `backend`
    defaults to NCCL for a cuda `device` and gloo for the CPU."""
    global _SYNC_GROUP
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    _SYNC_GROUP = dist.new_group(list(range(world_size))) if world_size > 1 else None
    return rank, world_size


def maybe_init_distributed(args, backend: str = None) -> tuple:
    """With `--distributed` under torchrun (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT set), join its group; returns (rank, world_size), (0, 1)
    otherwise. A cuda run takes the card LOCAL_RANK names."""
    if dist.is_initialized():
        return world()
    if not (getattr(args, "distributed", False) and "WORLD_SIZE" in os.environ):
        return 0, 1
    device = getattr(args, "device", "cuda")
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    return init_distributed(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                            "env://", backend, device)


def destroy_distributed():
    global _SYNC_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _SYNC_GROUP = None


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum of `t` over the ranks of `sync_group()`, differentiable; `t`
    itself with one rank."""
    if _SYNC_GROUP is None:
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t, op=dist.ReduceOp.SUM, group=_SYNC_GROUP)


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """Mean of a detached `t` over the ranks (logged scalars)."""
    if _SYNC_GROUP is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=_SYNC_GROUP)
    return t / dist.get_world_size()


def broadcast_object(obj, src: int = 0):
    """`obj` of rank `src` on every rank (the run id, the experiment
    directory)."""
    if not (dist.is_available() and dist.is_initialized()):
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def shard_batch_size(global_bs: int, world_size: int, use_new_batching: bool) -> int:
    """Both reference batching policies (train.py:286-293): legacy (default),
    `bs` is the global batch, split over the ranks and rounded down to a
    multiple of them (at least one a rank); use_new_batching, `bs` is per
    rank. Returns the global batch."""
    n = world_size
    if use_new_batching:
        return global_bs * n
    if global_bs % n != 0:
        return max(n, (global_bs // n) * n)
    return global_bs

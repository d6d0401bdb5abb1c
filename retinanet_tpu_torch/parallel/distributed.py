"""Multi-process runs on ``torch.distributed`` (port of
``retinanet_tpu/parallel/distributed.py``).

The port's model of parallelism: each process (a *rank*) drives one device,
``cuda:{LOCAL_RANK}`` on the card or the CPU under ``--device cpu``.  Ranks
are started by ``torchrun --nproc-per-node N`` (or spawned by a test), and
:func:`initialize` joins them from the launcher's ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.  Each
rank reads a disjoint shard of the dataset (:func:`shard_loader`) and
steps on its slice of the global batch; the loss's global reductions
(:func:`global_sum`) and one flat bucket of gradients
(:func:`all_reduce_sum`) make the step that of the global batch.

The JAX package's ``parallel/mesh.py`` has no counterpart here: a rank owns
one device, so there is no device mesh to lay out, no sharding to name and
no global array to assemble (``global_batch_from_local``); each rank feeds
its local batch to its own device.  One process over several devices is
not this model and is refused where the JAX package would build a mesh.

The backend follows a fixed rule (:func:`backend_for`), logged when the
group starts: NCCL when every rank has a card of its own, gloo on the CPU
and when ranks share a card (NCCL does not put two ranks on one device).
It is never switched after a failure.  Gloo takes CUDA tensors only in
``all_reduce`` and ``broadcast``, so every collective here that carries
device tensors is one of those two.
"""

from __future__ import annotations

import logging
import os
from typing import Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import Tensor

logger = logging.getLogger(__name__)

Device = Union[str, torch.device]


def local_rank() -> int:
    """This process's index among the ranks of its host (``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def rank() -> int:
    """This process's rank in the started group; 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """Ranks in the started group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_lead() -> bool:
    """Whether this rank writes what one process should write: metrics,
    image summaries, checkpoints."""
    return rank() == 0


def group() -> Optional[dist.ProcessGroup]:
    """The group a data-parallel step reduces over: the whole world when
    there are several ranks, else None (a one-process step)."""
    return dist.group.WORLD if world_size() > 1 else None


def rank_device(device: Device) -> torch.device:
    """The device this rank drives: ``cuda`` without an index becomes
    ``cuda:{LOCAL_RANK}``, round the host's cards when it has fewer than
    ranks (they then share cards, over gloo); any other device is taken
    as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        cards = torch.cuda.device_count()
        return torch.device("cuda", local_rank() % cards if cards
                            else local_rank())
    return device


def backend_for(device: Device, local_world: int) -> Tuple[str, str]:
    """``(backend, reason)`` for ranks of which ``local_world`` share this
    host, all given ``device``: NCCL when every local rank has a card of
    its own, gloo otherwise.  A rank has a card of its own when ``device``
    is ``cuda`` without an index (each rank takes ``cuda:{LOCAL_RANK}``)
    or it is the host's only rank, and the host has a card for each rank.
    The rule reads only what the ranks of a host share (the device they
    were given, their count and the host's cards), never the rank itself,
    so every rank picks the same backend: ranks that named one card, as
    ``--device cuda:0`` under ``torchrun`` does, all share it over
    gloo."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo", f"ranks on {device.type}"
    cards = torch.cuda.device_count()
    if device.index is not None and local_world > 1:
        return "gloo", (f"{local_world} local ranks share {device} "
                        f"({cards} card(s) on the host)")
    if cards >= local_world:
        return "nccl", (f"{local_world} local rank(s), {cards} card(s), "
                         f"one each")
    return "gloo", f"{local_world} local ranks share {cards} card(s)"


def initialize(device: Device = "cuda") -> Optional[str]:
    """Join this process to its group from the launcher's environment
    (``env://``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) and return the backend; a no-op
    (None) at one process or when the group is already started.  The
    backend is :func:`backend_for`'s, logged; under NCCL the rank's card
    becomes the current device."""
    if dist.is_initialized():
        return dist.get_backend()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    this = int(os.environ.get("RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    backend, reason = backend_for(device, local_world)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    logger.info("torch.distributed: rank %d of %d, backend %s (%s)", this,
                world, backend, reason)
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=this)
    return backend


def process_batch_slice(global_batch_size: int) -> Tuple[int, int]:
    """(start, size) of this rank's slice of the global batch."""
    n, i = world_size(), rank()
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by "
            f"{n} processes")
    per = global_batch_size // n
    return i * per, per


class _LoaderShard:
    """View of a loader restricted to samples ``i % num_shards == shard``.

    Keeps the loader interface (``class_names`` / ``num_classes`` /
    ``__iter__`` / ``__len__``) so the pipeline is shard-agnostic; every
    rank iterates a disjoint subset, together covering the dataset.
    """

    def __init__(self, loader, shard: int, num_shards: int):
        self.loader = loader
        self.shard = shard
        self.num_shards = num_shards
        self.class_names = loader.class_names
        self.num_classes = loader.num_classes

    def __len__(self) -> int:
        n, s = len(self.loader), self.num_shards
        return n // s + (1 if n % s > self.shard else 0)

    def __iter__(self):
        for i, sample in enumerate(self.loader):
            if i % self.num_shards == self.shard:
                yield sample


def shard_loader(loader, shard: int, num_shards: int):
    """A rank's shard of a dataset (each rank feeds only its slice of the
    global batch); the loader itself at one shard."""
    if num_shards <= 1:
        return loader
    if not 0 <= shard < num_shards:
        raise ValueError(f"shard {shard} out of range [0, {num_shards})")
    return _LoaderShard(loader, shard, num_shards)


def allgather_pyobjs(obj) -> list:
    """All-gather one picklable host object per rank: every rank returns
    ``[obj_from_rank_0, ..., obj_from_rank_{n-1}]`` (``[obj]`` at one
    process).  Host metadata only, e.g. the evaluator's per-image
    records.  Payloads are unpickled, so every rank must trust the others,
    as the ranks of one job do."""
    n = world_size()
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj)
    return out


def barrier() -> None:
    """Wait for every rank; nothing at one process."""
    if world_size() > 1:
        dist.barrier()


class _GlobalSum(torch.autograd.Function):
    """All-reduce-sum forward; the backward hands the cotangent through
    unchanged.  Each rank's loss is then the global one, and its backward
    gives the gradient of that loss through its own inputs only: the sum
    over ranks of those gradients (one all-reduce of the parameter
    gradients) is the global gradient.  ``torch.distributed.nn``'s
    ``all_reduce`` all-reduces the cotangent as well, which counts every
    gradient world-size times once the parameter gradients are summed."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad: Tensor):
        return grad, None


def global_sum(x: Tensor, group: Optional[dist.ProcessGroup] = None
               ) -> Tensor:
    """``x`` summed over the ranks of ``group`` (``x`` itself when None),
    its backward the identity (``_GlobalSum``)."""
    if group is None:
        return x
    return _GlobalSum.apply(x, group)


def _flat(tensors: Sequence[Tensor]) -> Tensor:
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1:
        raise ValueError(f"one bucket holds one dtype, got {dtypes}")
    return torch.cat([t.reshape(-1) for t in tensors])


def _split(flat: Tensor, like: Sequence[Tensor]) -> List[Tensor]:
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in like]), like)]


def all_reduce_sum(tensors: Sequence[Tensor],
                   group: dist.ProcessGroup) -> List[Tensor]:
    """Each tensor summed over the group's ranks, through one flat bucket
    (one collective); the results are views of the bucket."""
    flat = _flat(tensors)
    dist.all_reduce(flat, group=group)
    return _split(flat, tensors)


@torch.no_grad()
def broadcast_(tensors: Iterable[Tensor], src: int = 0,
               group: Optional[dist.ProcessGroup] = None) -> None:
    """Copy rank ``src``'s values into every rank's ``tensors`` in place,
    one flat bucket per dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        flat = _flat(same)
        dist.broadcast(flat, src=src, group=group)
        for t, part in zip(same, _split(flat, same)):
            t.copy_(part)

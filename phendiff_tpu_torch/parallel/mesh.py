"""Data and tensor parallelism over processes: one process a card,
``torch.distributed``.

Counterpart of ``phendiff_tpu/parallel/mesh.py``.  The JAX package lays a
``(data, model)`` device mesh out in one process and lets XLA's collectives
average the gradients; PyTorch runs one process a card (``torchrun``) and
the collectives are explicit.  The group's backend is NCCL for CUDA and
gloo for the CPU; gloo also takes CUDA tensors, staging them through the
host.

* ``init_distributed`` reads torchrun's environment (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or takes
  an explicit ``init_method`` (``file://`` in tests), sets the rank's card
  before anything else touches it, and is a no-op at world size 1 without
  an environment.  It never falls back to world 1: with ``WORLD_SIZE > 1``
  and no reachable group it raises.
* ``make_mesh(model_parallel)`` lays the processes out as JAX reshapes its
  devices, ``(world // model_parallel, model_parallel)``: the model ranks of
  one replica are consecutive.  It makes one process group a data index
  (the ranks holding the same shard of every replica) and one a replica
  (its model ranks), and raises when ``model_parallel`` does not divide the
  world.  With a model axis of 1 the data group is the default group.
* ``data_size``/``data_rank`` are the data axis's, ``model_size``/
  ``model_rank`` the model axis's (``parallel/tp.py`` shards over it).
  ``shard_batch`` keeps this data rank's rows of a global batch: contiguous
  and rank-major, the order ``jax.make_array_from_process_local_data``
  assembles, the same rows on every model rank of a replica.
  ``all_gather_rows`` is its inverse over the data group, ``replicate``
  broadcasts from rank 0 to every process, and ``is_main`` is global rank 0,
  the one process that writes.

The JAX module's ``data_sharding`` and ``replicated`` are ``NamedSharding``
objects, placements inside one process; one process a card has no
counterpart for them.  Without a process group every helper acts as the
one rank of a world of one.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from phendiff_tpu_torch.core.device import DeviceLike, resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"
# How long a collective waits for the slowest rank.  Rank 0 alone runs the
# host metric passes (reference Inception features, a float64 sqrtm of 2048 x
# 2048 for each FID, ~12 s apiece) while the other ranks wait in their next
# collective; NCCL's own default (10 minutes) would tear a long comparison or
# eval down on every other rank.
GROUP_TIMEOUT = datetime.timedelta(hours=2)


# The layout ``make_mesh`` made: the model axis's size and this process's
# data and model groups (None: the default group, or no group of its own).
_LAYOUT = {"model": 1, "data_group": None, "model_group": None}


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def _world() -> int:
    return dist.get_world_size() if _active() else 1


def _rank() -> int:
    return dist.get_rank() if _active() else 0


def model_size() -> int:
    """Processes holding shards of one replica (1 without a model axis)."""
    return _LAYOUT["model"]


def model_rank() -> int:
    """This process's shard index within its replica."""
    return _rank() % model_size()


def data_size() -> int:
    """Replicas: processes in the data group (1 without a group)."""
    return _world() // model_size()


def data_rank() -> int:
    """This process's replica index (0 without a group)."""
    return _rank() // model_size()


def data_group():
    """The data group's handle for ``torch.distributed`` calls (None: the
    default group)."""
    return _LAYOUT["data_group"]


def model_group():
    """This replica's model group (None without a model axis)."""
    return _LAYOUT["model_group"]


def is_main() -> bool:
    """True on global rank 0, the process that writes files."""
    return _rank() == 0


def barrier() -> None:
    if _active():
        dist.barrier()


def init_distributed(device: DeviceLike = None, backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     timeout: Optional[datetime.timedelta] = None) -> torch.device:
    """Join the process group this process was launched into, and return its
    device: ``cuda:{LOCAL_RANK}`` for CUDA (set as the current card first),
    else the device asked for.

    A group is made when ``init_method`` is given, ``WORLD_SIZE`` is above
    1 or ``MASTER_ADDR`` is set (the rank and world size come from ``RANK``
    and ``WORLD_SIZE``, 0 and 1 by default); otherwise this is a no-op.
    The backend defaults to NCCL for CUDA and gloo for the CPU.  With ``WORLD_SIZE > 1`` and neither
    ``init_method`` nor ``MASTER_ADDR``/``MASTER_PORT`` it raises at once,
    and an unreachable group raises when the rendezvous times out: there is
    no fallback to one process.  Collectives wait ``timeout`` for the
    slowest rank, ``GROUP_TIMEOUT`` by default."""
    dev = resolve_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if init_method is None and world == 1 and "MASTER_ADDR" not in os.environ:
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if _active():
        return dev
    if init_method is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"WORLD_SIZE={world} but {', '.join(missing)} unset and no "
                               "init_method: no process group to join")
        init_method = "env://"
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = {"timeout": timeout or GROUP_TIMEOUT}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=int(os.environ.get("RANK", "0")), **kw)
    return dev


def destroy() -> None:
    """Leave the process group, if any, and forget the layout."""
    _LAYOUT.update(model=1, data_group=None, model_group=None)
    if _active():
        dist.destroy_process_group()


def make_mesh(model_parallel: int = 1) -> Dict[str, int]:
    """Lay the processes out as ``(data, model)`` and return the axes' sizes.

    Rank ``r`` is data rank ``r // model_parallel`` and model rank
    ``r % model_parallel``.  Every process must call this with the same
    ``model_parallel`` (the groups are made collectively); calling it again
    with the layout it already has makes nothing."""
    world = _world()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} processes not divisible by model_parallel={model_parallel}")
    if model_parallel != _LAYOUT["model"]:
        layout = {"model": model_parallel, "data_group": None, "model_group": None}
        if model_parallel > 1:
            ranks = np.arange(world).reshape(world // model_parallel, model_parallel)
            me = _rank()
            for col in ranks.T:  # every process takes part in making every group
                g = dist.new_group(col.tolist())
                if me in col:
                    layout["data_group"] = g
            for row in ranks:
                g = dist.new_group(row.tolist())
                if me in row:
                    layout["model_group"] = g
        _LAYOUT.update(layout)
    return {DATA_AXIS: data_size(), MODEL_AXIS: model_size()}


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def local_rows(n: int) -> slice:
    """This rank's rows of a global batch of ``n`` rows (``n`` a multiple of
    the data size)."""
    world, rank = data_size(), data_rank()
    if n % world:
        raise ValueError(f"a global batch of {n} rows does not split over {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(batch):
    """This data rank's rows of every array or tensor of a global batch (a
    tree of tuples, lists and dicts); the JAX function's mesh argument is
    the layout ``make_mesh`` made."""
    return _map(lambda x: x[local_rows(x.shape[0])], batch)


def padded_rows(n: int, mode: str) -> np.ndarray:
    """The global row indices this rank computes for a batch of ``n`` real
    rows padded to a multiple of the data size: ``"cycle"`` pads by cycling
    the batch (``jnp.resize``, the JAX Evaluator's), ``"repeat_last"`` by
    repeating its last row (the JAX comparison engine's)."""
    world = data_size()
    total = n + (-n) % world
    idx = np.arange(total)
    idx = idx % n if mode == "cycle" else np.minimum(idx, n - 1)
    return idx[local_rows(total)]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every data rank's ``x`` (equal shapes), concatenated in rank order
    along dim 0; ``x`` itself with one replica."""
    if data_size() == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(data_size())]
    dist.all_gather(parts, x.contiguous(), group=data_group())
    return torch.cat(parts)


def replicate(tree):
    """Rank 0's tensors on every rank (broadcast in place); the tree is
    returned."""
    if _active():
        _map(lambda t: dist.broadcast(t.data, src=0) if isinstance(t, torch.Tensor) else None,
             tree)
    return tree


def broadcast_object(obj):
    """Rank 0's picklable ``obj`` on every rank."""
    if not _active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """Average ``tensors`` over the data group, in place: one flat buffer a
    dtype, all-reduced with SUM and divided by the number of replicas (gloo
    has no AVG, and the arithmetic is then the same on both backends).  A
    no-op without a group."""
    if not _active():
        return
    world = data_size()
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=data_group())
        flat.div_(world)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))

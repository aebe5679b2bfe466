"""Several processes, one sharded world (the counterpart of
``ponyc_tpu/parallel/distributed.py``, over ``torch.distributed``).

Every process of the job calls `initialize()` and then runs the SAME
host program (the same declares, spawns, sends and run calls: the SPMD
host-driver contract of the JAX package's multi-host runs). A Runtime
with ``mesh_shards == world size`` then drives one shard a process
through `DistComm`: the tick's collectives are ``torch.distributed``
collectives (NCCL for CUDA tensors, gloo on the CPU), and at the end of
each window every rank gathers the whole world, so the host API reads
the same state on every rank.

Typical launch (one process a shard)::

    torchrun --nproc_per_node 2 script.py      # or explicit arguments:
    import ponyc_tpu_torch.parallel.distributed as dist
    dist.initialize("tcp://127.0.0.1:29500", world_size=2, rank=r)
    rt = Runtime(RuntimeOptions(mesh_shards=dist.device_count()),
                 device="cpu")
    ...                       # the identical program on every rank

NCCL takes one card a rank: it refuses two ranks on one device, so a
one-card machine runs its shards in one process (LocalComm) instead.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join (or start) a multi-process job; a no-op for a single process.
    Arguments default to torchrun's environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK; LOCAL_RANK picks the card). The
    backend defaults to NCCL where CUDA is available, else gloo."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(env.get("RANK", 0))
    if int(world_size) <= 1 and init_method is None:
        return
    if init_method is None:
        addr = env.get("MASTER_ADDR", "127.0.0.1")
        port = env.get("MASTER_PORT")
        if port is None:
            raise RuntimeError("initialize: no init_method and no "
                               "MASTER_PORT in the environment")
        init_method = f"tcp://{addr}:{port}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=int(world_size), rank=int(rank))


def is_initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def device_count() -> int:
    """Shards of the job: one a process (1 without a job)."""
    if not is_initialized():
        return 1
    import torch.distributed as dist
    return dist.get_world_size()


def process_index() -> int:
    if not is_initialized():
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def is_leader() -> bool:
    """True on exactly one process: put driver-only side effects (prints,
    checkpoint writes) behind it, as every process runs the same
    program."""
    return process_index() == 0


def shutdown() -> None:
    """Leave the job (destroy the process group)."""
    if is_initialized():
        import torch.distributed as dist
        dist.destroy_process_group()

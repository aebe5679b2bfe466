"""Mesh sharding of the PyTorch port (the counterpart of
``ponyc_tpu/parallel``): actor rows shard over the 'actors' axis and
messages cross shards through the collective layer (comm.py): shards in
one process (LocalComm) or one shard a process over torch.distributed
(DistComm, distributed.py)."""

from . import distributed  # noqa: F401
from .comm import DistComm, LocalComm  # noqa: F401
from .mesh import Mesh, Sharded, gather_state, make_mesh, shard_state  # noqa: F401

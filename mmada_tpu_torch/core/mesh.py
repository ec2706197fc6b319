"""Device meshes over ranks: one process a card, three named axes.

Counterpart of `mmada_tpu/core/mesh.py` (:30-93). The JAX package builds one
logical (data, fsdp, tensor) mesh and lets GSPMD insert the collectives; the
port builds the same mesh as a `torch.distributed.device_mesh.DeviceMesh`
over the ranks of a process group and writes its collectives out
(`parallel/collectives.py`):

  * ``data``   - batch rows (replicas of the weights)
  * ``fsdp``   - batch rows too, and every weight's shards (the ZeRO-3
                 analogue): a layer's shards are gathered before its block
  * ``tensor`` - attention heads and MLP hidden (Megatron's split)

Ranks lie in the mesh as JAX lays devices out: rank = (d * fsdp + f) *
tensor + t. Beside the DeviceMesh's own groups (one axis each), `make_mesh`
makes the groups of the joined axes the port reduces over: (data, fsdp), the
batch's, and (fsdp, tensor), the embedding rows'. `axis_size`, `axis_index`
and `axis_group` take one axis name or a tuple of them (joined major first).

`control_store` is the serving engine's control channel (`serve/ranks.py`):
a key-value store on the hosts, beside the collectives' groups, so that
control never queues behind a card's stream and a wait can time out.

`initialize_distributed` joins the ranks that `torchrun` (or any launcher
setting `MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`, `RANK`, `LOCAL_RANK`)
started: NCCL on the card, gloo on the CPU. `make_mesh` with no process group
makes a group of one rank in the process, so one card (or the CPU) runs a
mesh of (1, 1, 1) with no launcher.
"""

from __future__ import annotations

import datetime
import itertools
import math
import os
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mmada_tpu_torch.core.device import DeviceLike, resolve_device

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tensor"
MESH_AXES = (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS)
BATCH_AXES = (DATA_AXIS, FSDP_AXIS)

Axes = Union[str, Sequence[str], None]

#: seconds a collective may wait for the other ranks before it fails
DEFAULT_TIMEOUT_S = 600
#: seconds the serving engine's control channel waits for a rank
CONTROL_TIMEOUT_S = 30


def mesh_shape(n: int, data: int = 1, fsdp: int = -1, tensor: int = 1) -> tuple[int, int, int]:
    """The (data, fsdp, tensor) sizes over `n` ranks; one axis may be -1
    (inferred). The errors are JAX's `make_mesh`'s."""
    sizes = [data, fsdp, tensor]
    if sizes.count(-1) > 1:
        raise ValueError("at most one mesh axis may be -1")
    if -1 in sizes:
        known = math.prod(s for s in sizes if s != -1)
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {sizes} != {n} devices")
    return tuple(sizes)


def _backend_device() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _ensure_group(device: DeviceLike) -> None:
    """A process group of this one process, when none exists."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":   # the communicator's card, before it is made
        torch.cuda.set_device(dev.index if dev.index is not None else torch.cuda.current_device())
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))


def make_mesh(data: int = 1, fsdp: int = -1, tensor: int = 1,
              device: DeviceLike = None) -> DeviceMesh:
    """The (data, fsdp, tensor) mesh over every rank of the process group
    (one axis may be -1), with the groups of its joined axes. Without a
    process group, one of this process alone is made on `device`'s backend
    (NCCL on the card, the default; gloo for `device="cpu"`)."""
    _ensure_group(device)
    sizes = mesh_shape(dist.get_world_size(), data, fsdp, tensor)
    ranks = torch.arange(dist.get_world_size()).reshape(sizes)
    mesh = DeviceMesh(_backend_device(), ranks, mesh_dim_names=MESH_AXES)
    groups = {}
    for axes in ((DATA_AXIS, FSDP_AXIS), (FSDP_AXIS, TENSOR_AXIS), MESH_AXES):
        dims = [MESH_AXES.index(a) for a in axes]
        rest = [i for i in range(3) if i not in dims]
        for fixed in itertools.product(*(range(sizes[i]) for i in rest)):
            index = [slice(None)] * 3
            for i, v in zip(rest, fixed):
                index[i] = v
            members = ranks[tuple(index)].reshape(-1).tolist()
            group = dist.new_group(members) if len(members) > 1 else None
            if dist.get_rank() in members:
                groups[axes] = group
    mesh.joined_groups = groups
    return mesh


def mesh_from_config(cfg, device: DeviceLike = None) -> DeviceMesh:
    """The mesh of the config's `parallel.{data,fsdp,tensor}` (fsdp -1 by
    default: every rank the data and tensor axes leave)."""
    p = cfg.get_path("parallel", None) or {}
    return make_mesh(data=int(p.get("data", 1)), fsdp=int(p.get("fsdp", -1)),
                     tensor=int(p.get("tensor", 1)), device=device)


def control_store(timeout_s: float = CONTROL_TIMEOUT_S):
    """A key-value store that every rank of the process group reaches: a TCP
    store served by rank 0 (on `MASTER_ADDR`, else this host, at a port the
    system picks; its address sent over the default group, so every rank
    must call this), whose waits fail after `timeout_s`."""
    timeout = datetime.timedelta(seconds=timeout_s)
    address = [None]
    if dist.get_rank() == 0:
        host = os.environ.get("MASTER_ADDR") or "127.0.0.1"
        store = dist.TCPStore(host, 0, dist.get_world_size(), True, timeout=timeout,
                              wait_for_workers=False)
        address = [(host, store.port)]
    dist.broadcast_object_list(address, src=0)
    if dist.get_rank() != 0:
        store = dist.TCPStore(address[0][0], address[0][1], dist.get_world_size(), False,
                              timeout=timeout)
    return store


def single_device_mesh(device: DeviceLike = None) -> DeviceMesh:
    return make_mesh(data=1, fsdp=1, tensor=1, device=device)


def _axes(axes: Axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh: Optional[DeviceMesh], axes: Axes) -> int:
    """The number of ranks along `axes` (1 without a mesh)."""
    if mesh is None:
        return 1
    return math.prod(mesh.size(MESH_AXES.index(a)) for a in _axes(axes))


def axis_index(mesh: Optional[DeviceMesh], axes: Axes) -> int:
    """This rank's index along `axes`, the first axis major."""
    index = 0
    for a in _axes(axes):
        index = index * axis_size(mesh, a) + (mesh.get_local_rank(a) if mesh is not None else 0)
    return index


def axis_group(mesh: DeviceMesh, axes: Axes):
    """The process group of this rank's fellows along `axes` (None when it
    holds this rank alone)."""
    axes = tuple(a for a in MESH_AXES if a in _axes(axes))
    if axis_size(mesh, axes) == 1:
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh.joined_groups[axes]


def world_size(mesh: Optional[DeviceMesh]) -> int:
    return axis_size(mesh, MESH_AXES)


def is_main_process() -> bool:
    """Rank 0, or the only process: the one that prints and writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join this process to the ranks of its run: the counterpart of
    `jax.distributed.initialize` (`mmada_tpu/core/mesh.py:53-71`). The
    rendezvous is the launcher's environment (`MASTER_ADDR:MASTER_PORT`,
    `WORLD_SIZE`, `RANK`, as torchrun sets them) unless the arguments name
    it: `coordinator_address` as `host:port` or an init-method URL
    (`tcp://...`, `file://...`). NCCL on the card, whose device is set to
    `LOCAL_RANK` before anything touches it; gloo when `device="cpu"`.
    Returns False, and does nothing, when the run is one process or the
    group exists already."""
    if dist.is_initialized():
        return False
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    if world <= 1:
        return False
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            resolve_device(None)  # raises, naming device='cpu'
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dist.init_process_group("gloo" if on_cpu else "nccl", init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def batch_sharding(mesh: Optional[DeviceMesh] = None) -> tuple:
    """The batch rule: rows over data x fsdp (both act as data parallelism
    for activations), every other dim replicated; as a spec."""
    return (BATCH_AXES,)


def process_local_batch_slice(global_batch: int, mesh: Optional[DeviceMesh] = None) -> slice:
    """This rank's rows of a global batch: over data x fsdp with a mesh
    (tensor ranks share rows), else over the process group's ranks."""
    if mesh is not None:
        n, i = axis_size(mesh, BATCH_AXES), axis_index(mesh, BATCH_AXES)
    elif dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    if global_batch % n:
        raise ValueError(f"batch {global_batch} does not divide over {n} ranks")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)

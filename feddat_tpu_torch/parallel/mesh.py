"""The (client, data[, model]) mesh of ranks (counterpart of ``feddat_tpu/parallel/mesh.py``).

The JAX package runs one controller over a mesh of devices.  The port runs
one process per device, as ``torchrun`` starts them, joined in a
``torch.distributed`` process group: rank ``r`` owns ``cuda:LOCAL_RANK`` (or
the CPU, with gloo, in the tests).  A mesh of ``C`` clients by ``D``
data-parallel ranks is JAX's grid ``devices[:C*D].reshape(C, D)`` with ranks
in place of devices, wrapped in a ``DeviceMesh`` whose dimensions are named
``("client", "data")``:

  * ``client`` — the federated clients: FedAvg is one all-reduce over a
    rank's client group (the ranks of one data index, one per client);
  * ``data``   — data parallelism within a client: the gradient mean is one
    all-reduce over a rank's data group (the ranks of one client);
  * ``model``  — with ``model_parallel > 1``, tensor parallelism within a
    (client, data) slot (``parallel/tp.py``): the axis is innermost, JAX's
    ``reshape(C, D, M)``, so a slot's model group is ``M`` consecutive ranks
    (one host's cards under ``torchrun --nproc_per_node``).

:func:`make_mesh` keeps JAX's arithmetic and its errors (``not divisible``,
``need N devices, have M``), with the world's ranks as the devices.  Unlike
JAX, which leaves devices past ``C*D`` idle, a mesh must take every rank: a
process with no slot would have nothing to feed and no collective to join.

``initialize_multihost`` joins a group across hosts from the launcher's
environment (``torchrun --nnodes ...``) or explicit arguments and raises
without them, as JAX's does; :func:`world` starts a world of one in-process
(a file store in a temporary directory) when no launcher started this
process.
"""

from __future__ import annotations

import contextlib
import os
import shutil
import socket
import tempfile
from typing import Callable, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from feddat_tpu_torch.device import resolve_device

CLIENT_AXIS = "client"
DATA_AXIS = "data"
MODEL_AXIS = "model"
_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def local_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (made current), or the CPU."""
    if device_type != "cuda":
        return torch.device("cpu")
    resolve_device("cuda")  # raises without a card
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(device)
    return device


def _init(device: torch.device, **kwargs) -> None:
    if device.type == "cuda":  # eager NCCL init: no communicator is made inside a capture
        kwargs["device_id"] = device
    dist.init_process_group(_backend(device), **kwargs)


@contextlib.contextmanager
def world(device: torch.device) -> Iterator[int]:
    """The process group for the block -> its size.  An initialised group is
    used as it is; a launcher's environment (``torchrun``) joins its world;
    otherwise a world of one starts here, from a file store in a temporary
    directory.  A group started here is destroyed at the end of the block."""
    if dist.is_initialized():
        yield dist.get_world_size()
        return
    tmp = None
    if all(k in os.environ for k in _LAUNCHER_ENV):
        _init(device, init_method="env://")
    else:
        tmp = tempfile.mkdtemp(prefix="feddat_world_")
        _init(device, store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        yield dist.get_world_size()
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: Optional[torch.device] = None) -> int:
    """Join a process group across hosts -> the world size.

    With no arguments the launcher's environment gives the rendezvous
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as ``torchrun``
    sets them); explicit arguments cover a bare-metal launch.  Every caller
    came here through ``--multihost``, so a missing rendezvous or a failed
    init raises: falling back to a world of one would train each host alone
    with no FedAvg across hosts.  A group already initialised is kept.
    ``device`` defaults to this rank's card, and raises without one; the CPU
    (gloo) only when it is passed."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    missing = [name for name, v in (("coordinator address (MASTER_ADDR, MASTER_PORT)", coordinator_address),
                                    ("number of processes (WORLD_SIZE)", num_processes),
                                    ("process id (RANK)", process_id)) if v is None]
    if missing:
        raise RuntimeError(
            "--multihost needs the launcher's rendezvous and found no "
            f"{', '.join(missing)}; refusing to fall back to a world of one "
            "(each host training alone, with no FedAvg across hosts).  Launch with "
            "torchrun --nnodes N --nproc_per_node G, or pass --coordinator_address/"
            "--num_processes/--process_id")
    device = device or local_device("cuda")  # raises without a card: no CPU fallback
    try:
        _init(device, init_method=f"tcp://{coordinator_address}", world_size=num_processes,
              rank=process_id)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            "torch.distributed.init_process_group failed under --multihost; refusing to "
            f"fall back to a world of one.  Cause: {e}") from e
    return dist.get_world_size()


def mesh_grid(num_clients: int = 1, data_parallel: Optional[int] = None,
              world_size: Optional[int] = None, model_parallel: int = 1) -> np.ndarray:
    """JAX's ``make_mesh`` arithmetic on ranks -> the ``[C, D]`` grid of ranks,
    ``[C, D, M]`` with ``model_parallel > 1`` (``data_parallel`` defaults to
    the world over the clients and the model axis)."""
    n = dist.get_world_size() if world_size is None else world_size
    if data_parallel is None:
        if n % (num_clients * model_parallel) != 0:
            raise ValueError(f"{n} devices not divisible by {num_clients} clients"
                             + (f" x model={model_parallel}" if model_parallel > 1 else ""))
        data_parallel = n // (num_clients * model_parallel)
    need = num_clients * data_parallel * model_parallel
    if need > n:
        raise ValueError(f"need {need} devices, have {n}")
    shape = (num_clients, data_parallel) + ((model_parallel,) if model_parallel > 1 else ())
    _every_rank_has_a_slot(need, n, shape)
    return np.arange(need).reshape(shape)


def _every_rank_has_a_slot(need: int, n: int, shape: Sequence[int]) -> None:
    if need < n:
        raise ValueError(
            f"a {tuple(shape)} mesh takes {need} of the world's {n} ranks; every rank needs a "
            "slot: start that many processes")


class RankMesh:
    """A grid of ranks over named axes (``("client", "data")``, with
    ``"model"`` innermost under tensor parallelism, or the sequential
    engine's ``("data", "model")``) and this rank's place in it: its index
    and the ``DeviceMesh``'s group along each axis.  An axis the mesh lacks
    has index 0, size 1 and no group."""

    def __init__(self, grid: np.ndarray, device_type: str, names: Sequence[str] = None):
        from torch.distributed.device_mesh import DeviceMesh

        self.grid = np.asarray(grid)
        self.names = tuple(names or (CLIENT_AXIS, DATA_AXIS, MODEL_AXIS)[:self.grid.ndim])
        self.device_mesh = DeviceMesh(device_type, torch.as_tensor(self.grid),
                                      mesh_dim_names=self.names)
        self.rank = dist.get_rank()
        place = np.argwhere(self.grid == self.rank)[0]
        self.index = {n: int(i) for n, i in zip(self.names, place)}
        self.groups = {n: self.device_mesh.get_group(n) for n in self.names}

    @property
    def shape(self):
        return dict(zip(self.names, self.grid.shape))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    client_index = property(lambda self: self.index.get(CLIENT_AXIS, 0))
    data_index = property(lambda self: self.index.get(DATA_AXIS, 0))
    model_index = property(lambda self: self.index.get(MODEL_AXIS, 0))
    client_group = property(lambda self: self.groups.get(CLIENT_AXIS))
    data_group = property(lambda self: self.groups.get(DATA_AXIS))
    model_group = property(lambda self: self.groups.get(MODEL_AXIS))


def make_mesh(num_clients: int = 1, data_parallel: Optional[int] = None,
              model_parallel: int = 1, device_type: str = "cuda") -> RankMesh:
    """The ``(client=num_clients, data=data_parallel[, model=model_parallel])``
    mesh over the initialised world (:func:`mesh_grid`'s errors first)."""
    return RankMesh(mesh_grid(num_clients, data_parallel, model_parallel=model_parallel), device_type)


def arrange_multihost_grid(ranks: Sequence[int], host_of: Callable[[int], int], num_clients: int,
                           data_parallel: Optional[int] = None) -> np.ndarray:
    """Order ranks into a ``[C, D]`` grid that keeps each client's data group
    on as few hosts as possible, so the gradient mean stays on a host's own
    links and only FedAvg crosses hosts.  ``host_of(rank) -> host index``."""
    ranks = list(ranks)
    n = len(ranks)
    if data_parallel is None:
        if n % num_clients != 0:
            raise ValueError(f"{n} devices not divisible by {num_clients} clients")
        data_parallel = n // num_clients
    need = num_clients * data_parallel
    if need > n:
        raise ValueError(f"need {need} devices, have {n}")
    by_host: dict = {}
    for r in ranks:
        by_host.setdefault(host_of(r), []).append(r)
    ordered = [r for h in sorted(by_host) for r in by_host[h]]
    return np.asarray(ordered[:need]).reshape(num_clients, data_parallel)


def host_indices() -> List[int]:
    """Every rank's host, numbered in order of first appearance (a collective)."""
    names: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    order = {name: i for i, name in enumerate(dict.fromkeys(names))}
    return [order[name] for name in names]


def make_multihost_mesh(num_clients: int, data_parallel: Optional[int] = None,
                        device_type: str = "cuda") -> RankMesh:
    """The ``(client, data)`` mesh over every rank of every host, clients on
    host blocks (:func:`arrange_multihost_grid`).  Call
    :func:`initialize_multihost` first."""
    hosts = host_indices()
    grid = arrange_multihost_grid(range(len(hosts)), hosts.__getitem__, num_clients, data_parallel)
    _every_rank_has_a_slot(grid.size, len(hosts), grid.shape)
    return RankMesh(grid, device_type)


def clients_for_process(grid: np.ndarray, host_of: Callable[[int], int], host_index: int) -> List[int]:
    """The client rows of a ``[C, D]`` grid with at least one rank on host
    ``host_index``: the clients that host feeds."""
    return [c for c in range(grid.shape[0]) if any(host_of(r) == host_index for r in grid[c])]

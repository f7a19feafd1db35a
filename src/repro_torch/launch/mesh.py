"""Fleet meshes over ``torch.distributed`` (counterpart of ``repro.launch.mesh``).

The reference's fleet mesh is a ``('data', 'fsdp', 'tp')`` device mesh; its
fleet engines put the stacked client axis on ``data`` and the SL server
suffix on the ``fsdp`` x ``tp`` sub-mesh. Here ``make_fleet_mesh`` builds
the same layout as a ``torch.distributed`` ``DeviceMesh`` of shape
``(data, fsdp, tp)``, ``data`` outermost (rank ``d*fsdp*tp + f*tp + t``),
and ``FleetMesh`` carries the rank's own ``data`` group: each rank holds
``num_clients / data`` clients' rows, and the engines' collectives
(FedAvg, the EPSL server gradient) are ``all_reduce`` / ``all_gather``
calls over that group. The ranks of one ``(fsdp, tp)`` sub-mesh hold the
same clients; the server state lives on that sub-mesh as DTensors
(``fleet.engine.shard_server_state``). ``server_mesh_sizes`` reads a
mesh's ``(fsdp, tp)``.

The backend follows the device: NCCL for a CUDA device, gloo for the CPU,
and a mesh whose group's backend does not serve its device is refused, so
card tensors never travel through gloo. ``single_device_fleet_mesh`` is the
single-rank mesh with no group: every collective is the identity (the
reference's "collectives become no-ops").

``make_production_mesh`` is the reference's 16x16 ``('data', 'model')`` (or
2x16x16 ``('pod', 'data', 'model')``) mesh with no device behind it: a
``DeviceMesh`` over ``torch.distributed``'s ``"fake"`` backend, whose
collectives do nothing, the counterpart of the reference's 512 forced host
devices. It starts a default process group of 256 (512) ranks, this
process rank 0, so it runs only in a process of its own (the dry run's),
never beside a fleet mesh or inside a test runner's process; both
meshes are ranks of one 512-rank group.
``abstract_mesh`` is a mesh's shape alone, for specs.

``run_ranks`` is the counterpart of the reference's forced host devices
(``make_host_mesh`` over ``--xla_force_host_platform_device_count``): it
runs a callable on R local processes (``torch.multiprocessing``, spawn), a
default process group in each set up from a ``FileStore`` in a directory
the caller gives (no TCP port), and returns rank 0's result.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import traceback
import uuid
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
BACKEND_OF_DEVICE = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass(frozen=True)
class FleetMesh:
    """The data group of a fleet: ``group`` (None on the single-rank mesh),
    this process's ``rank`` in it, its ``size`` and the ``device`` the
    rank's tensors live on; the server axes' sizes ``fsdp`` and ``tp``,
    and the ``(data, fsdp, tp)`` ``device_mesh`` they come from (None on a
    data group alone, ``data_mesh``, where both are 1)."""
    group: Any
    rank: int
    size: int
    device: torch.device
    fsdp: int = 1
    tp: int = 1
    device_mesh: Any = None

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size, "fsdp": self.fsdp, "tp": self.tp}

    @property
    def server_mesh(self):
        """This rank's ``(fsdp, tp)`` sub-mesh (None without a
        ``device_mesh``)."""
        if self.device_mesh is None:
            return None
        return self.device_mesh["fsdp", "tp"]

    @property
    def writes(self) -> bool:
        """Whether this rank writes the run's telemetry: data rank 0 at the
        first place of its server sub-mesh."""
        if self.rank != 0:
            return False
        sub = self.server_mesh
        return sub is None or tuple(sub.get_coordinate()) == (0, 0)


def server_mesh_sizes(mesh) -> tuple[int, int]:
    """(fsdp, tp) sizes of a fleet mesh's server sub-mesh (1, 1 without
    one)."""
    if mesh is None:
        return 1, 1
    return mesh.fsdp, mesh.tp


def _check_backend(group, device: torch.device) -> None:
    backend = dist.get_backend(group)
    want = BACKEND_OF_DEVICE.get(device.type)
    if backend != want:
        raise ValueError(f"a {backend} process group cannot carry a fleet on "
                         f"{device}: the {device.type} fleet's collectives "
                         f"run on {want}")


def _group_device(group) -> torch.device:
    """The device a rank of ``group`` works on: the current CUDA device
    under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def data_mesh(group=None, *, device=None) -> FleetMesh:
    """The fleet mesh over an initialised process group (the default group
    when ``group`` is None), one client shard a rank. ``device`` defaults
    to the group's (``_group_device``); a device the group's backend does
    not serve is refused."""
    if not dist.is_initialized():
        raise RuntimeError("data_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    group = dist.group.WORLD if group is None else group
    device = _group_device(group) if device is None else torch.device(device)
    _check_backend(group, device)
    return FleetMesh(group=group, rank=dist.get_rank(group),
                     size=dist.get_world_size(group), device=device)


def fleet_data_size(num_clients: int, world: int,
                    max_data: Optional[int] = None) -> int:
    """The reference's rule: the largest divisor of ``num_clients`` that
    fits ``world`` ranks (and ``max_data``)."""
    limit = world if max_data is None else min(world, max_data)
    data = 1
    for d in range(1, min(limit, num_clients) + 1):
        if num_clients % d == 0:
            data = d
    return data


def fleet_layout(num_clients: int, world: int, *,
                 max_data: Optional[int] = None, fsdp: int = 1,
                 tp: int = 1) -> Optional[tuple]:
    """The reference's ``make_fleet_mesh`` rule on ``world`` ranks: ``data``
    the largest divisor of ``num_clients`` within ``world // (fsdp * tp)``
    (and ``max_data``); ``(data, fsdp, tp)``, or None when the layout
    needs more ranks than exist or collapses to one rank."""
    if fsdp * tp > world:
        return None
    data = fleet_data_size(num_clients, world // (fsdp * tp), max_data)
    if data * fsdp * tp <= 1:
        return None
    return data, fsdp, tp


def fleet_mesh_of(device_mesh, *, device=None) -> Optional[FleetMesh]:
    """The ``FleetMesh`` of this rank on a ``(data, fsdp, tp)``
    ``DeviceMesh``: its ``data`` group and coordinate, the server axes'
    sizes; None on a rank outside the mesh. ``device`` defaults to the
    data group's (``_group_device``); a device the group's backend does
    not serve is refused."""
    coord = device_mesh.get_coordinate()
    if coord is None:
        return None
    sizes = dict(zip(device_mesh.mesh_dim_names, device_mesh.shape))
    group = device_mesh.get_group(DATA_AXIS)
    device = _group_device(group) if device is None else torch.device(device)
    _check_backend(group, device)
    return FleetMesh(group=group, rank=coord[0], size=sizes[DATA_AXIS],
                     device=device, fsdp=sizes["fsdp"], tp=sizes["tp"],
                     device_mesh=device_mesh)


def make_fleet_mesh(num_clients: int, *, max_data: Optional[int] = None,
                    fsdp: int = 1, tp: int = 1,
                    device=None) -> Optional[FleetMesh]:
    """The ``('data', 'fsdp', 'tp')`` fleet mesh of ``num_clients`` over
    the default process group (the reference's rule, ``fleet_layout``): a
    ``DeviceMesh`` over the first ``data * fsdp * tp`` ranks, ``data``
    outermost (every rank must call this: the mesh makes its groups).
    Returns None when no process group is initialised, when the layout
    needs more ranks than exist or collapses to one rank (the reference's
    single-device case: callers fall back to ``single_device_fleet_mesh``),
    and on a rank past the mesh, which holds no clients."""
    if not dist.is_initialized():
        return None
    layout = fleet_layout(num_clients, dist.get_world_size(),
                          max_data=max_data, fsdp=fsdp, tp=tp)
    if layout is None:
        return None
    from torch.distributed.device_mesh import DeviceMesh
    device = (_group_device(dist.group.WORLD) if device is None
              else torch.device(device))
    n = layout[0] * layout[1] * layout[2]
    device_mesh = DeviceMesh(device.type, torch.arange(n).reshape(layout),
                             mesh_dim_names=(DATA_AXIS, "fsdp", "tp"))
    return fleet_mesh_of(device_mesh, device=device)


def single_device_fleet_mesh(device="cpu") -> FleetMesh:
    """The single-rank fleet mesh: no process group, every collective the
    identity, so the explicit-collective engines run on one device with
    the same code path as a real fleet."""
    return FleetMesh(group=None, rank=0, size=1, device=torch.device(device))


def server_only_mesh(mesh: Optional[FleetMesh]) -> Optional[FleetMesh]:
    """The fleet mesh with its ``data`` axis collapsed to 1 (the
    reference's ``_server_only_mesh``): no data group, so every data rank
    runs all the clients, and the same ``fsdp`` x ``tp`` server sub-mesh.
    For a bucket whose size does not divide ``data``."""
    if mesh is None or mesh.size == 1:
        return mesh
    return dataclasses.replace(mesh, group=None, rank=0, size=1)


def all_gather_rows(mesh: Optional[FleetMesh], items) -> list:
    """Every rank's rows of each ``(local tensor, client dim)`` in
    ``items``, concatenated in rank order along that dim, in ONE
    ``all_gather`` of the tensors' bytes (any dtypes; each piece padded to
    16 bytes); the local tensors themselves on the single-rank mesh."""
    if mesh is None or mesh.group is None:
        return [t for t, _ in items]
    pieces, spans, at = [], [], 0
    for t, _ in items:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        pad = -b.numel() % 16
        pieces.append(b)
        if pad:
            pieces.append(b.new_zeros(pad))
        spans.append((at, b.numel()))
        at += b.numel() + pad
    flat = torch.cat(pieces)
    bufs = [torch.empty_like(flat) for _ in range(mesh.size)]
    dist.all_gather(bufs, flat, group=mesh.group)
    out = []
    for (t, dim), (start, nbytes) in zip(items, spans):
        rows = [buf[start:start + nbytes].view(t.dtype).reshape(t.shape)
                for buf in bufs]
        out.append(torch.cat(rows, dim=dim))
    return out


# ---------------------------------------------------------------------------
# local ranks: spawned processes over a FileStore
# ---------------------------------------------------------------------------

def _rank_main(rank: int, world: int, store_path: str, out_dir: str,
               backend: str, timeout_s: float, fn: Callable, args: tuple):
    """One spawned rank: a default process group from the ``FileStore`` at
    ``store_path``, ``fn(*args)``, its result (rank 0) or its exception
    (any rank) written under ``out_dir``, the group destroyed on exit."""
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            # every rank's connections made before any rank runs ``fn``: a
            # rank that fails at once and exits must not cut a slower
            # rank's set-up short, which would then report its own error
            dist.barrier()
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "result.pt"))
    except BaseException as exc:
        text = traceback.format_exc()
        try:
            blob = pickle.dumps((exc, text))
        except Exception:
            blob = pickle.dumps((RuntimeError(text), text))
        with open(os.path.join(out_dir, f"error-{rank}.pkl"), "wb") as f:
            f.write(blob)
        raise


def run_ranks(fn: Callable, nranks: int, store_dir: str, *, args=(),
              backend: str = "gloo", timeout_s: float = 120.0):
    """``fn(*args)`` on ``nranks`` spawned local processes, each a rank of
    a default process group on ``backend`` (gloo: CPU ranks; nccl: one card
    a rank), set up from a ``FileStore`` in ``store_dir`` (no TCP port, no
    ``MASTER_*`` variables). Each rank runs one thread and under
    ``timeout_s`` for its collectives; the caller's process starts no group.
    Returns rank 0's result; raises the exception of a rank that failed
    (the first to fail), or ``TimeoutError`` when the ranks outlast
    ``timeout_s`` plus start-up (the ranks are then killed).

    ``fn`` and ``args`` are pickled into the children, which import
    ``fn``'s module: keep it a module-level function of a module that
    imports what the ranks need and nothing more."""
    import torch.multiprocessing as mp
    run_dir = os.path.join(store_dir, f"ranks-{uuid.uuid4().hex}")
    os.makedirs(run_dir)
    store_path = os.path.join(run_dir, "store")
    ctx = mp.start_processes(
        _rank_main, args=(nranks, store_path, run_dir, backend, timeout_s,
                          fn, tuple(args)),
        nprocs=nranks, join=False, start_method="spawn")
    deadline = timeout_s + 60.0
    waited = 0.0
    try:
        while not ctx.join(timeout=5.0):
            waited += 5.0
            if waited > deadline:
                raise TimeoutError(f"{nranks} ranks did not finish in "
                                   f"{deadline:.0f} s")
    except mp.ProcessRaisedException as err:
        path = os.path.join(run_dir, f"error-{err.error_index}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                exc, text = pickle.load(f)
            raise exc from RuntimeError(
                f"rank {err.error_index} failed:\n{text}")
        raise
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return torch.load(os.path.join(run_dir, "result.pt"), weights_only=False)


def abstract_mesh(shape: tuple, axes: tuple):
    """A device-free mesh of ``shape`` over ``axes`` (the reference's
    ``abstract_mesh``): sizes and names for the spec builders, no group."""
    from ..parallel.sharding import AbstractMesh
    return AbstractMesh(tuple(shape), tuple(axes))


def fake_mesh(shape: tuple, axes: tuple, *, world: Optional[int] = None):
    """A ``DeviceMesh`` of ``shape`` over ``axes`` on the ``"fake"`` backend
    (``torch.testing._internal.distributed.fake_pg``): its collectives
    return at once and move nothing. The mesh is ranks 0 .. prod(shape) - 1
    of the default process group, which it starts with ``world`` ranks
    (default prod(shape)), this process rank 0, unless one is up."""
    import math
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world or n)
    if dist.get_world_size() < n:
        raise ValueError(f"a process group of {dist.get_world_size()} ranks "
                         f"is up; a {shape} mesh needs {n}")
    return DeviceMesh("cpu", torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 single pod (256 ranks) or 2x16x16 (512 ranks, 2 pods), on the
    fake backend (``fake_mesh``) of a 512-rank group, so both meshes come
    from one process's group."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return fake_mesh(shape, axes, world=512)

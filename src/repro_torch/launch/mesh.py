"""Fleet meshes over ``torch.distributed`` (counterpart of ``repro.launch.mesh``).

The reference's fleet mesh is a ``('data', 'fsdp', 'tp')`` device mesh; its
shard_map engines put the stacked client axis on ``data``. Here the ``data``
axis is a process group: each rank holds ``num_clients / size`` clients'
rows, and the engines' collectives (FedAvg, the EPSL server gradient) are
``all_reduce`` / ``all_gather`` calls over that group. ``fsdp`` and ``tp``
are 1: a server sub-mesh is not ported (ROADMAP queue 1 item 16b).

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
    rank's tensors live on. The server axes ``fsdp`` and ``tp`` are 1."""
    group: Any
    rank: int
    size: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size, "fsdp": 1, "tp": 1}


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


def make_fleet_mesh(num_clients: int, *, max_data: Optional[int] = None,
                    device=None) -> Optional[FleetMesh]:
    """The fleet mesh of ``num_clients`` over the default process group:
    ``data`` the largest divisor of ``num_clients`` that fits the world
    (and ``max_data``), over the first ``data`` ranks (a new group when it
    is not the whole world; every rank must call this). Returns None when
    no process group is initialised, when the layout collapses to one rank
    (the reference's single-device case: callers fall back to
    ``single_device_fleet_mesh``), and on a rank past ``data``, which holds
    no clients."""
    if not dist.is_initialized():
        return None
    world = dist.get_world_size()
    data = fleet_data_size(num_clients, world, max_data)
    if data <= 1:
        return None
    group = None
    if data < world:
        group = dist.new_group(ranks=list(range(data)))
        if dist.get_rank() >= data:
            return None
    return data_mesh(group, device=device)


def single_device_fleet_mesh(device="cpu") -> FleetMesh:
    """The single-rank fleet mesh: no process group, every collective the
    identity, so the explicit-collective engines run on one device with
    the same code path as a real fleet."""
    return FleetMesh(group=None, rank=0, size=1, device=torch.device(device))


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

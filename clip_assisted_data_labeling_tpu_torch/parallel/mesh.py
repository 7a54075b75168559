"""The device mesh and its collectives (port of the JAX package's
``parallel/mesh.py``).

A :class:`Mesh` is what a JAX ``Mesh`` is to one process: a numpy object
array of this process's ``torch.device``s under named axes — 1-D
``('data',)`` for data-parallel embedding, prediction and the ring dedup, or
2-D ``('data', 'model')`` for tensor-parallel towers (``parallel/tp.py``).
One process drives every device of its mesh and runs one body per device,
as ``shard_map`` does; a device may be listed more than once (``[cpu] * 8``
in the tests, ``[cuda:0] * 2`` on a one-card machine), and then its shards
run one after another on it.

Collectives between a process's devices are copies: :func:`psum` moves the
parts onto one device and adds them (integer sums are exact in any order),
:func:`all_gather` concatenates them, :func:`pmax` takes their elementwise
maximum, and :func:`ring_shift` (the ring's ``ppermute``) hands each panel to
the next device. Between processes (:func:`get_global_mesh`, after
:func:`multihost_init`) the ring and the fetches ride gloo over host memory:
a panel is staged with ``.cpu()``, exchanged, and moved back onto the
device, so the same code runs in CPU processes and in two processes that
share one card.

``get_mesh()`` takes every local card and raises where there is none: only
an explicit ``devices=`` list makes a CPU or repeated-device mesh.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch


def _object_array(items: list) -> np.ndarray:
    arr = np.empty(len(items), dtype=object)
    for i, item in enumerate(items):
        arr[i] = item
    return arr


class Mesh:
    """This process's devices in an array shaped by ``axis_names``. On a
    global mesh (:func:`get_global_mesh`) the ``data`` axis spans
    ``process_count`` processes of the same local shape; ``shape`` gives the
    global sizes, ``devices`` only this process's."""

    def __init__(self, devices, axis_names: tuple[str, ...], process_index: int = 0,
                 process_count: int = 1):
        if not isinstance(devices, np.ndarray):
            devices = _object_array([torch.device(d) for d in devices])
        if devices.ndim != len(axis_names):
            raise ValueError(f"devices of shape {devices.shape} for axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.process_index = process_index
        self.process_count = process_count

    @property
    def shape(self) -> dict[str, int]:
        sizes = dict(zip(self.axis_names, self.devices.shape))
        sizes[self.axis_names[0]] *= self.process_count
        return sizes

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def spans_processes(self) -> bool:
        return self.process_count > 1

    def local_devices(self, axis: str = "data") -> list[torch.device]:
        """The devices along ``axis`` (the first of each row across the
        other axis): where that axis's shards live."""
        ax = self.axis_names.index(axis)
        return list(np.moveaxis(self.devices, ax, 0).reshape(self.devices.shape[ax], -1)[:, 0])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]}, "
                f"process {self.process_index}/{self.process_count})")


def device_count() -> int:
    """The cards this process sees (``jax.device_count``'s counterpart on a
    single host)."""
    return torch.cuda.device_count()


def _local_devices(devices) -> list[torch.device]:
    if devices is not None:
        return [torch.device(d) for d in devices]
    if not torch.cuda.is_available():
        raise RuntimeError(
            "get_mesh: no cuda device (torch.cuda.is_available() is False); a mesh takes "
            "every local card, and only an explicit devices=[...] list makes a CPU mesh"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def stage_devices(device: torch.device) -> list[torch.device] | None:
    """The devices a stage's mesh takes for its ``device`` argument: every
    local card (None) for a ``cuda`` that names no index, else that one
    device."""
    return None if device.type == "cuda" and device.index is None else [device]


def get_mesh(n_devices: int | None = None, axis: str = "data", devices=None) -> Mesh:
    """1-D mesh over this process's devices: every local card, or the given
    ``devices`` (repeats allowed); ``n_devices`` keeps the first n."""
    devs = _local_devices(devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def get_mesh_2d(data: int, model: int, devices=None) -> Mesh:
    """``('data', 'model')`` mesh over the first ``data · model`` devices,
    row-major as the JAX package reshapes them."""
    devs = _local_devices(devices)
    if len(devs) < data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} devices, got {len(devs)}")
    return Mesh(_object_array(devs[: data * model]).reshape(data, model), ("data", "model"))


def get_global_mesh(axis: str = "data", devices=None) -> Mesh:
    """1-D mesh over every device of the job: this process's devices (every
    local card, or ``devices``) as its block of the ``data`` axis, each
    process one block in rank order. Programs over it run in every process
    at once; a single process gets its local mesh."""
    mesh = get_mesh(axis=axis, devices=devices)
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        counts = [None] * dist.get_world_size()
        dist.all_gather_object(counts, len(mesh.devices))
        if len(set(counts)) != 1:
            raise ValueError(f"processes hold different device counts {counts}")
        return Mesh(mesh.devices, mesh.axis_names, dist.get_rank(), dist.get_world_size())
    return mesh


def shard_batch(mesh: Mesh, tensor, axis: str = "data") -> list[torch.Tensor]:
    """Split ``tensor``'s leading axis into one equal part per device along
    ``axis``, each part on its device."""
    devs = mesh.local_devices(axis)
    t = torch.as_tensor(tensor)
    if t.shape[0] % len(devs):
        raise ValueError(f"leading dim {t.shape[0]} does not split over {len(devs)} devices")
    return [part.to(d) for part, d in zip(t.chunk(len(devs)), devs)]


def replicate(mesh: Mesh, tensor) -> list[torch.Tensor]:
    """One copy of ``tensor`` per mesh device (flat order), a single copy
    per distinct device."""
    t = torch.as_tensor(tensor)
    copies: dict[torch.device, torch.Tensor] = {}
    return [copies.setdefault(d, t.to(d)) for d in mesh.devices.flat]


# ---- collectives between one process's devices: copies ---------------------------

def psum(parts: list[torch.Tensor], device: torch.device | None = None) -> torch.Tensor:
    """The sum of ``parts`` on ``device`` (the first part's by default), in
    list order."""
    device = parts[0].device if device is None else device
    out = parts[0].to(device, copy=True)
    for p in parts[1:]:
        out += p.to(device)
    return out


def pmax(parts: list[torch.Tensor], device: torch.device | None = None) -> torch.Tensor:
    """The elementwise maximum of ``parts`` on ``device``."""
    device = parts[0].device if device is None else device
    out = parts[0].to(device, copy=True)
    for p in parts[1:]:
        out = torch.maximum(out, p.to(device))
    return out


def all_gather(parts: list[torch.Tensor], device: torch.device | None = None,
               dim: int = -1) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` on ``device`` (tiled, as
    ``jax.lax.all_gather(..., tiled=True)``)."""
    device = parts[0].device if device is None else device
    return torch.cat([p.to(device) for p in parts], dim=dim)


def ring_shift(mesh: Mesh,
               panels: list[tuple[torch.Tensor, ...]]) -> list[tuple[torch.Tensor, ...]]:
    """The ring's ``ppermute``: the panel (a tuple of tensors) of global shard
    g goes to shard g + 1 (mod the ring). ``panels`` are this process's, one
    per local device; across processes the last local panel is staged on
    the host and sent to the next rank over gloo while the first local
    device receives the previous rank's."""
    devs = list(mesh.devices.flat)
    shifted = [tuple(t.to(devs[i + 1]) for t in panels[i]) for i in range(len(panels) - 1)]
    last = panels[-1]
    if not mesh.spans_processes:
        return [tuple(t.to(devs[0]) for t in last)] + shifted
    dist = torch.distributed
    rank, world = mesh.process_index, mesh.process_count
    send = [t.cpu().contiguous() for t in last]
    recv = [torch.empty_like(t) for t in send]
    ops = [dist.P2POp(dist.isend, t, (rank + 1) % world) for t in send]
    ops += [dist.P2POp(dist.irecv, t, (rank - 1) % world) for t in recv]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [tuple(t.to(devs[0]) for t in recv)] + shifted


def process_allgather(mesh: Mesh, array: np.ndarray) -> np.ndarray:
    """This process's block of a ``data``-sharded result → the whole result
    on every process, blocks in rank order (the leading axis concatenated);
    the block itself on a single-process mesh."""
    if not mesh.spans_processes:
        return array
    t = torch.from_numpy(np.ascontiguousarray(array))
    out = [torch.empty_like(t) for _ in range(mesh.process_count)]
    torch.distributed.all_gather(out, t)
    return np.concatenate([o.numpy() for o in out], axis=0)


# ---- processes ---------------------------------------------------------------------

def multihost_init(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> tuple[int, int]:
    """Join a multi-process run; returns ``(process_index, process_count)``.

    Launch one process per host (or several on one host) with the same
    arguments but ``process_id``, or set the JAX package's variables:
    ``COORDINATOR_ADDRESS`` (host:port of process 0), ``JAX_NUM_PROCESSES``
    and ``JAX_PROCESS_ID``, so one launcher serves both packages. The
    processes meet through ``torch.distributed`` with the gloo backend
    (``tcp://<coordinator>``). With no coordinator it is a no-op that
    returns (0, 1); a second call returns the live state."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
        if coordinator_address is None:
            return 0, 1
        if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
            num_processes = int(os.environ["JAX_NUM_PROCESSES"])
        if process_id is None and os.environ.get("JAX_PROCESS_ID"):
            process_id = int(os.environ["JAX_PROCESS_ID"])
        if num_processes is None or process_id is None:
            raise ValueError(
                "multihost_init: a coordinator needs the process count and this process's "
                "id (--num_processes/--process_id or JAX_NUM_PROCESSES/JAX_PROCESS_ID)"
            )
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(minutes=30))
    return dist.get_rank(), dist.get_world_size()


def multihost_shutdown() -> None:
    """Leave the process group :func:`multihost_init` joined (a no-op
    without one)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()

"""Device mesh and sharding helpers (the port of `fedrann_tpu/parallel/mesh.py`).

A mesh is a list of torch devices driven from one process, as JAX's
single-controller `Mesh` over `jax.devices()` is: read rows (both
orientations) are data-parallel over the "data" axis, tables are
replicated, and the k-NN candidate blocks move between the entries
(knn/ring.py). A 2-D ("hosts", "data") mesh lists its devices host-major,
so entry (h, j) is `devices[h * n_local + j]` and owns the (h * n_local +
j)-th block of rows.

An entry may repeat a device: a mesh of one card repeated runs the real
schedule on one card, and the CPU tests use `[cpu] * 8` for the JAX
package's eight virtual CPU devices. A copy to the device a tensor already
lies on is that tensor, so nothing that crosses the mesh may be modified in
place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch

from fedrann_tpu_torch.device import get_device

DATA_AXIS = "data"
HOST_AXIS = "hosts"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices laid out (data,) or (hosts, data), host-major."""

    devices: tuple[torch.device, ...]
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names) or \
                math.prod(self.shape) != len(self.devices) or \
                not self.devices:
            raise ValueError(f"{len(self.devices)} devices do not fill a "
                             f"mesh of shape {self.shape}")

    @property
    def size(self) -> int:
        return len(self.devices)


def _devices(devices: Optional[Sequence]) -> list[torch.device]:
    """The given devices (names or torch.devices), else every visible CUDA
    card; raises RuntimeError as device.get_device does where a CUDA device
    is asked for and there is none."""
    if devices is None:
        get_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [get_device(d) for d in devices]


def make_mesh(shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D "data" mesh over the given devices, else every visible CUDA
    card; with `shape`, over the first prod(shape) of them (JAX's
    truncation)."""
    devices = _devices(devices)
    if shape is not None:
        devices = devices[: math.prod(shape)]
    return Mesh(tuple(devices), (len(devices),), (DATA_AXIS,))


def make_mesh_2d(n_hosts: int, devices: Optional[Sequence] = None) -> Mesh:
    """2-D ("hosts", "data") mesh: the devices (every visible CUDA card by
    default) split into n_hosts rows of equal length, host-major. The
    inner axis is the ring2d schedule's cheap hop, the outer one its bulk
    hop (knn/ring.py)."""
    devices = _devices(devices)
    if len(devices) % n_hosts:
        raise ValueError(
            f"{len(devices)} devices do not split over {n_hosts} hosts")
    return Mesh(tuple(devices), (n_hosts, len(devices) // n_hosts),
                (HOST_AXIS, DATA_AXIS))


def to_device(t, dev: torch.device):
    """t (a tensor, or anything with `.to`) on `dev`: itself where it
    already lies there. A copy to a CUDA device does not wait for the host
    (the device's stream orders it before any use there); a copy to the
    host does, since the host reads it at once."""
    return t.to(dev, non_blocking=dev.type == "cuda")


def shard_rows(rows, mesh: Mesh) -> list:
    """(N, ...) rows cut into mesh.size equal blocks, block i copied to
    entry i's device (a block already there is a view of `rows`). Takes a
    tensor or anything with row slicing and `.to(device)` (a
    codec.PackedChunk). N must divide by the mesh size:
    pad_rows_to_multiple first."""
    n = rows.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over a mesh of "
                         f"{mesh.size}: pad them to a multiple first")
    b = n // mesh.size
    return [to_device(rows[i * b : (i + 1) * b], dev)
            for i, dev in enumerate(mesh.devices)]


def replicate(t: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """t on every entry's device: one copy per distinct device, shared by
    the entries that repeat it."""
    copies: dict[torch.device, torch.Tensor] = {}
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = to_device(t, dev)
    return [copies[dev] for dev in mesh.devices]


def pad_rows_to_multiple(t: torch.Tensor, multiple: int):
    """Zero-pad rows so the leading dim divides `multiple`; returns
    (padded, original_rows)."""
    n = t.shape[0]
    pad = (-n) % multiple
    if pad:
        t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
    return t, n

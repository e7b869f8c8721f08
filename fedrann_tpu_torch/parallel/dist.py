"""The process group of a multi-process run (the port's counterpart of
`jax.distributed` and `jax.experimental.multihost_utils`).

One process per host (or per card set), launched with --num-processes,
--process-id and --coordinator (else JAX_COORDINATOR_ADDRESS), joins one
`torch.distributed` group at tcp://<coordinator>. Two transports:

- the host collectives run on a gloo group over host memory: numpy
  all-gathers (`process_allgather`, `allgather_ragged`) and named barriers
  (`barrier`, the counterpart of `sync_global_devices`);
- the k-NN's device blocks cross processes over the transport chosen once,
  before the search, from the cards each rank holds (`DeviceTransport`):
  NCCL where the ranks' card sets are disjoint, else gloo, staged through
  pinned host buffers (two ranks on one card, or the CPU). NCCL binds one
  card per process, so a rank's blocks leave from and arrive at its first
  card (`hop_device`); blocks of its other cards reach that card first.
  The choice never depends on whether an NCCL call fails: a failure on
  disjoint cards fails the run.

Every collective has the group's finite timeout, so a rank that dies or
stalls fails the others instead of hanging them.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from fedrann_tpu_torch.logging_utils import logger
from fedrann_tpu_torch.parallel.mesh import to_device

TIMEOUT = datetime.timedelta(seconds=900)


@dataclasses.dataclass
class ProcessGroup:
    """This process's place in the run: rank and size (a size of 1 has no
    torch.distributed group behind it)."""

    rank: int = 0
    size: int = 1

    def process_allgather(self, arr: np.ndarray) -> np.ndarray:
        """Every rank's `arr` (the same shape and dtype on all ranks)
        stacked rank by rank: (size, *arr.shape)."""
        arr = np.ascontiguousarray(arr)
        if self.size == 1:
            return arr[None].copy()
        raw = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
        out = [torch.empty_like(raw) for _ in range(self.size)]
        dist.all_gather(out, raw)
        return np.stack([o.numpy().view(arr.dtype).reshape(arr.shape)
                         for o in out])

    def allgather_ragged(self, arr: np.ndarray) -> list[np.ndarray]:
        """Every rank's `arr`, whose first dimension may differ by rank:
        the sizes are gathered, each array padded to the largest, gathered
        and cut back (as the JAX runtime pads before process_allgather)."""
        arr = np.asarray(arr)
        sizes = self.process_allgather(np.asarray([arr.shape[0]], np.int64))
        cap = max(int(sizes.max()), 1)
        buf = np.zeros((cap, *arr.shape[1:]), arr.dtype)
        buf[: arr.shape[0]] = arr
        gathered = self.process_allgather(buf)
        return [gathered[r, : int(sizes[r, 0])] for r in range(self.size)]

    def barrier(self, name: str) -> None:
        """Wait until every rank reaches the barrier `name`; each rank
        must pass each barrier exactly once."""
        if self.size > 1:
            logger.debug("[rank %d] barrier %s", self.rank, name)
            dist.barrier()


def coordinator_address(coordinator: Optional[str]) -> Optional[str]:
    return coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           timeout: datetime.timedelta = TIMEOUT
                           ) -> ProcessGroup:
    """Join the run's process group when a multi-process launch is asked
    for (a coordinator, from the argument or JAX_COORDINATOR_ADDRESS, or
    num_processes > 1): torch.distributed over gloo at
    tcp://<coordinator>, with this world size and rank. Otherwise, or
    with one process, rank 0 of 1 and no group."""
    coordinator = coordinator_address(coordinator)
    if not coordinator and not (num_processes and num_processes > 1):
        return ProcessGroup()
    if not coordinator or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs --coordinator host:port (or "
            "JAX_COORDINATOR_ADDRESS), --num-processes and --process-id; "
            f"got {coordinator!r}, {num_processes!r}, {process_id!r}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is not in [0, "
                         f"{num_processes})")
    if num_processes == 1:
        return ProcessGroup()
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    logger.info("distributed runtime: process %d/%d (gloo at %s)",
                process_id, num_processes, coordinator)
    return ProcessGroup(rank=process_id, size=num_processes)


def shutdown(group: ProcessGroup) -> None:
    """Leave the process group (a no-op for one process)."""
    if group.size > 1 and dist.is_initialized():
        dist.destroy_process_group()


def card_ids(devices: Sequence[torch.device]) -> list[str]:
    """A name per distinct card of `devices` that is the same in every
    process (the CUDA UUID; "cpu" for the host)."""
    out = []
    for dev in devices:
        key = (str(torch.cuda.get_device_properties(dev).uuid)
               if dev.type == "cuda" else "cpu")
        if key not in out:
            out.append(key)
    return out


def choose_transport(group: ProcessGroup,
                     devices: Sequence[torch.device]) -> str:
    """ "nccl" where every rank holds CUDA cards and no card is held by two
    ranks (their UUIDs, gathered over gloo), else "gloo". Every rank
    reaches the same answer."""
    ids = card_ids(devices)
    everyone: list = [ids]
    if group.size > 1:
        everyone = [None] * group.size
        dist.all_gather_object(everyone, ids)
    seen = [i for rank_ids in everyone for i in rank_ids]
    disjoint = "cpu" not in seen and len(set(seen)) == len(seen)
    return "nccl" if disjoint else "gloo"


class DeviceTransport:
    """Moves the k-NN's (rows, d) float32 blocks between processes: NCCL
    from and to `hop_device` (a subgroup made here), or gloo through
    pinned host buffers. Counts its blocks and bytes in `.blocks` and
    `.bytes` (sent by this rank)."""

    def __init__(self, group: ProcessGroup,
                 devices: Sequence[torch.device]):
        self.group = group
        self.hop_device = devices[0]
        self.kind = choose_transport(group, devices)
        self._nccl = None
        if self.kind == "nccl" and group.size > 1:
            torch.cuda.set_device(self.hop_device)
            self._nccl = dist.new_group(backend="nccl", timeout=TIMEOUT)
        self.blocks = 0
        self.bytes = 0
        logger.info("[rank %d] device transport: %s (cards %s; "
                    "cross-process blocks leave from %s)", group.rank,
                    self.kind, ", ".join(card_ids(devices)), self.hop_device)

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """A contiguous host copy of t: pinned when t is on a card."""
        if t.device.type == "cpu":
            return t.contiguous()
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t)
        return buf

    def exchange(self, sends: list, recvs: list) -> list[torch.Tensor]:
        """Point-to-point: sends [(peer, tensor)] and recvs [(peer, shape,
        device)], each listed in one order that every rank agrees on (a
        peer's sends in the order that peer lists its recvs from us).
        Returns the received float32 tensors, each on its device."""
        ops, out = [], []
        for peer, t in sends:
            self.blocks += 1
            self.bytes += t.numel() * t.element_size()
        if self.kind == "nccl":
            for peer, t in sends:
                ops.append(dist.P2POp(dist.isend, t.to(self.hop_device)
                                      .contiguous(), peer, self._nccl))
            for peer, shape, _ in recvs:
                buf = torch.empty(shape, dtype=torch.float32,
                                  device=self.hop_device)
                ops.append(dist.P2POp(dist.irecv, buf, peer, self._nccl))
                out.append(buf)
        else:
            staged = [(peer, self._host(t)) for peer, t in sends]
            # tags keep a pair's messages apart: the i-th send to a peer
            # matches that peer's i-th receive from us
            n_to: dict = {}
            for peer, t in staged:
                ops.append(dist.P2POp(dist.isend, t, peer,
                                      tag=n_to.setdefault(peer, [0])[0]))
                n_to[peer][0] += 1
            n_from: dict = {}
            for peer, shape, dev in recvs:
                buf = torch.empty(shape, dtype=torch.float32,
                                  pin_memory=dev.type == "cuda")
                ops.append(dist.P2POp(dist.irecv, buf, peer,
                                      tag=n_from.setdefault(peer, [0])[0]))
                n_from[peer][0] += 1
                out.append(buf)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return [to_device(b, dev) for b, (_, _, dev) in zip(out, recvs)]

    def all_gather(self, block: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's block (the same shape on all ranks), rank by rank,
        on hop_device."""
        if self.group.size == 1:
            return [to_device(block, self.hop_device)]
        self.blocks += 1
        self.bytes += block.numel() * block.element_size()
        if self.kind == "nccl":
            mine = block.to(self.hop_device).contiguous()
            out = [torch.empty_like(mine) for _ in range(self.group.size)]
            dist.all_gather(out, mine, group=self._nccl)
            return out
        mine = self._host(block)
        pin = self.hop_device.type == "cuda"
        out = [torch.empty(mine.shape, dtype=mine.dtype, pin_memory=pin)
               for _ in range(self.group.size)]
        dist.all_gather(out, mine)
        return [to_device(o, self.hop_device) for o in out]

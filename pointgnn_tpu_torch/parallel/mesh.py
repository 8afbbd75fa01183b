"""Data-parallel groups of processes (counterpart of
:mod:`pointgnn_tpu.parallel.mesh`).

The JAX package runs data parallelism in one process: a 1-D mesh over
``DATA_AXIS`` and one SPMD program whose ``psum`` and ``pmean`` cross
the chips.  The port runs one process per card, the PyTorch idiom:
:func:`launch` spawns one process per rank, joins them into a
``torch.distributed`` group and calls ``fn(mesh, *args)`` on every rank.
Each rank holds one device and its own share of a step's frames, and
runs the same step; the step's collectives (:func:`sum_across`,
:func:`gather_stack`) stand where the JAX step has ``psum``, ``pmean``
and its per-device outputs.

NCCL joins ranks on distinct cards and gloo joins ranks on the CPU.
gloo also joins ranks that share a card (``devices=["cuda:0",
"cuda:0"]``): that is how a machine with one card runs two ranks, to
check the data-parallel path there, not a fallback for NCCL.  gloo's
collectives run on host copies of the tensors.
"""

import datetime
import os
import tempfile
import time
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pointgnn_tpu_torch.utils.device import resolve_device

DATA_AXIS = "dp"
# every rank's device, in rank order, as launch() hands them to a rank
DEVICES_ENV = "POINTGNN_MESH_DEVICES"


class Mesh(NamedTuple):
    """This process's place in a data-parallel group: its ``rank`` and
    every rank's device (``devices[rank]`` is its own)."""

    rank: int
    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[self.rank]


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh of this process in an initialized group: the devices
    :func:`launch` gave the ranks, else ``cuda:r`` for rank ``r``.
    ``n_devices``, when given, must be the group's size."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed group: start "
            "the ranks with pointgnn_tpu_torch.parallel.mesh.launch"
        )
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError("a mesh of %d devices in a group of %d ranks"
                         % (n_devices, size))
    env = os.environ.get(DEVICES_ENV)
    devices = env.split(",") if env else ["cuda:%d" % r for r in range(size)]
    if len(devices) != size:
        raise ValueError("%d devices for %d ranks" % (len(devices), size))
    return Mesh(dist.get_rank(), tuple(torch.device(d) for d in devices))


def _on_host(mesh: Mesh) -> bool:
    """gloo reduces host tensors: a card's tensors go through copies."""
    return dist.get_backend() == "gloo" and mesh.device.type != "cpu"


def sum_across(mesh: Mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Each tensor summed over the ranks (``psum``): one ``all_reduce``
    of one flat bucket per dtype.  Returns new tensors (detached, on
    each input's device); every rank gets the same bytes."""
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        if _on_host(mesh):
            flat = flat.cpu()
        dist.all_reduce(flat)
        off = 0
        for i in idx:
            t = tensors[i]
            out[i] = flat[off:off + t.numel()].view(t.shape).to(t.device)
            off += t.numel()
    return out


def gather_stack(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``tensor`` stacked along a new leading device axis
    (the JAX step's per-device outputs, ``P(DATA_AXIS)``)."""
    t = tensor.detach()
    if _on_host(mesh):
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t.contiguous())
    return torch.stack(parts).to(tensor.device)


def barrier(mesh: Mesh):
    """Wait until every rank reaches this point."""
    sum_across(mesh, [torch.zeros(1, device=mesh.device)])


def _rank_main(rank, fn, args, devices, backend, store_dir, timeout):
    """A spawned rank: join the group, run ``fn(mesh, *args)``, write
    its result for :func:`launch`."""
    os.environ[DEVICES_ENV] = ",".join(devices)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        # CPU ranks share the host's cores with each other (and with
        # whatever else runs there): intra-op threads would oversubscribe
        # them, and a parallel region waits for its slowest thread
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(store_dir, "store"),
        rank=rank, world_size=len(devices),
        timeout=datetime.timedelta(seconds=timeout),
    )
    try:
        out = fn(make_mesh(len(devices)), *args)
        path = os.path.join(store_dir, "rank%d.pt" % rank)
        torch.save(out, path + ".tmp")
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


def launch(fn, n_devices: int, *args, devices=None, timeout: float = 600.0,
           join_timeout: Optional[float] = None) -> list:
    """Run ``fn(mesh, *args)`` in ``n_devices`` spawned processes, one
    per rank, and return their results in rank order.

    ``fn`` and ``args`` are pickled by import path: ``fn`` is a
    module-level function, and a spawned rank imports its module.
    ``devices`` names each rank's device (a list, or one device for
    every rank); by default rank ``r`` runs on ``cuda:r``.  The ranks
    join over NCCL when they hold distinct cards and over gloo otherwise,
    which also lets several ranks share one card (see the module
    docstring).  ``timeout`` (seconds) bounds the rendezvous
    (a ``file://`` store in a temporary directory) and every collective;
    ``join_timeout`` bounds the whole launch.  A rank that raises, or a
    launch past ``join_timeout``, ends every rank and raises here."""
    if devices is None:
        devices = ["cuda:%d" % r for r in range(n_devices)]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices] * n_devices
    devices = [resolve_device(d) for d in devices]
    if len(devices) != n_devices:
        raise ValueError("%d devices for %d ranks" % (len(devices),
                                                      n_devices))
    if any(d.type == "cuda" and d.index is None for d in devices):
        raise ValueError("name each rank's card with its index (cuda:0)")
    distinct = len(set(devices)) == len(devices)
    backend = ("nccl" if distinct and all(d.type == "cuda" for d in devices)
               else "gloo")
    names = [str(d) for d in devices]
    with tempfile.TemporaryDirectory(prefix="pointgnn_mesh_") as store:
        ctx = mp.start_processes(
            _rank_main, args=(fn, args, names, backend, store, timeout),
            nprocs=n_devices, join=False, start_method="spawn",
        )
        deadline = (None if join_timeout is None
                    else time.monotonic() + join_timeout)
        try:
            # join() raises when a rank fails, after ending the others
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        "launch of %d ranks ran past %.0f s"
                        % (n_devices, join_timeout))
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(store, "rank%d.pt" % r),
                           weights_only=False)
                for r in range(n_devices)]

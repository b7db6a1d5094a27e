"""Starts the ranks of a mesh (``--mesh-task/--mesh-data/--mesh-model``).

An entry point keeps its one-command interface: ``run(cfg, device, fn,
*args)`` with a mesh of one rank calls ``fn(None, *args)`` in the calling
process, today's single-process path. Otherwise the calling process becomes
rank 0 and starts ranks 1..N-1 itself (``multiprocessing``, start method
``spawn``), which meet at a ``TCPStore`` that rank 0 serves on a free
localhost port. Every rank calls ``fn(mesh, *args)``; rank 0's return value
is ``run``'s, and only rank 0 prints (``utils/logger.silence`` in the
others). The other ranks exit when ``fn`` returns.

Devices: ``cpu`` puts every rank on the CPU over gloo. ``cuda`` puts rank r
on ``cuda:(r % device_count)``; with a card per rank the backend is NCCL,
else the ranks share the cards over gloo (NCCL refuses two ranks on one
device), which is the one-card case. The caller resolves the device before
``run`` (``--device cuda`` without a card raises there, before any rank
starts) and ``run`` builds the CUDA kernels once before the ranks start.

The ranks share the caller's ``torch.get_num_threads()``: each of the N
runs with max(1, threads // N), rank 0 too while the mesh runs (spawned
processes do not inherit a caller's setting, and N ranks at torch's
thread-per-core default oversubscribe the host, whose CPU ops then wait on
spinning threads: 3 s against 0.04 s a tiny meta step, 4 ranks on 8
cores). A rank that fails makes
``run`` raise: rank 0's own exception after the other ranks are stopped,
or a ``RuntimeError`` naming the ranks that exited non-zero.

As the ranks leave, rank 0 gathers each rank's kernel launch counts
(``ops/native.py``) and peak device memory into ``rank_stats``, so that a
caller can show that every rank of the last mesh run went through the
kernels.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import native
from ..utils.logger import silence
from . import comm
from .mesh import make_mesh, mesh_shape, requested_size

# how long a rank waits at a collective (rank 0 evaluates and writes
# checkpoints alone while the others wait at the next one)
TIMEOUT = datetime.timedelta(minutes=30)
HOST = "127.0.0.1"

# rank 0's record of the last mesh run: per rank, in rank order, the kernel
# launch counts and ``peak_bytes`` (torch.cuda.max_memory_allocated; 0 on
# the CPU)
rank_stats: List[Dict[str, int]] = []


def rank_device(rank: int, device: torch.device) -> torch.device:
    if device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(device: torch.device, world: int) -> str:
    """NCCL with a card per rank, else gloo."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def plan(cfg, device: torch.device) -> Tuple[int, int, int]:
    """The mesh shape ``run`` starts for ``cfg`` on ``device``."""
    n = torch.cuda.device_count() if device.type == "cuda" else 1
    return mesh_shape(cfg, n)


def _join_group(rank: int, shape: Sequence[int], store, device: torch.device,
                backend: str):
    world = int(np.prod(shape))
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    return make_mesh(shape, dev)


def _leave_group(mesh) -> None:
    """Gathers the ranks' launch counts and peak memory (kept on rank 0 in
    ``rank_stats``), then leaves the process group."""
    keys = sorted(native.launch_counts)
    peak = (torch.cuda.max_memory_allocated(mesh.device)
            if mesh.device.type == "cuda" else 0)
    mine = torch.tensor([native.launch_counts[k] for k in keys] + [peak],
                        dtype=torch.int64, device=mesh.device)
    every = comm.all_gather(mine, mesh.world).cpu().tolist()
    if mesh.is_root:
        rank_stats[:] = [dict(zip(keys + ["peak_bytes"], row))
                         for row in every]
    dist.barrier()
    dist.destroy_process_group()


def _rank_main(rank: int, shape: Sequence[int], port: int,
               device: torch.device, backend: str, threads: int,
               fn: Callable, args: tuple) -> None:
    """A spawned rank: join the group, run ``fn``, leave."""
    torch.set_num_threads(threads)
    silence()
    store = dist.TCPStore(HOST, port, int(np.prod(shape)), is_master=False,
                          timeout=TIMEOUT)
    mesh = _join_group(rank, shape, store, device, backend)
    fn(mesh, *args)
    _leave_group(mesh)


def run(cfg, device: torch.device, fn: Callable, *args) -> Any:
    """``fn(mesh, *args)`` on every rank of ``cfg``'s mesh (the module
    docstring); ``fn(None, *args)`` when the mesh is one rank."""
    if requested_size(cfg) <= 1:
        return fn(None, *args)
    shape = plan(cfg, device)
    world = int(np.prod(shape))
    if world == 1:
        return fn(None, *args)
    if device.type == "cuda":
        from ..ops import native

        native.build()
    backend = backend_for(device, world)
    store = dist.TCPStore(HOST, 0, world, is_master=True,
                          wait_for_workers=False, timeout=TIMEOUT)
    threads = torch.get_num_threads()
    share = max(1, threads // world)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, shape, store.port, device, backend,
                               share, fn, args))
             for r in range(1, world)]
    for p in procs:
        p.start()
    torch.set_num_threads(share)
    try:
        mesh = _join_group(0, shape, store, device, backend)
        try:
            result = fn(mesh, *args)
            _leave_group(mesh)
        except BaseException:
            if dist.is_initialized():
                dist.destroy_process_group()
            raise
    except BaseException:
        for p in procs:
            p.terminate()
        for p in procs:
            p.join(timeout=30)
        raise
    finally:
        torch.set_num_threads(threads)
    for p in procs:
        p.join(timeout=TIMEOUT.total_seconds())
    failed = [r for r, p in enumerate(procs, start=1) if p.exitcode != 0]
    if failed:
        for p in procs:
            p.kill()
        raise RuntimeError(f"mesh rank(s) {failed} exited with codes "
                           f"{[procs[r - 1].exitcode for r in failed]}")
    return result

"""Start a world of ranks: spawned here, or joined under ``torchrun``.

    from gmf_tpu_torch.parallel.launch import launch
    results = launch(fn, 4, *args, device="cpu")   # fn(rank, world, *args)

``launch`` spawns ``world`` processes, each of which joins the world
through a ``FileStore`` in a temporary directory (no TCP port, so runs
side by side do not collide), calls ``fn(rank, world, *args)`` and hands
back what it returns; the results come back in rank order. An exception
on any rank, or a rank that dies, stops the others and raises here with
that rank's traceback. ``fn`` must be importable by name (a module-level
function): the children are spawned, not forked.

``init_world`` chooses the backend from the layout, once: gloo on the
CPU; on the card NCCL when every rank has a card of its own, else gloo
with ranks sharing cards round robin (NCCL refuses two ranks on one
card), whose all-gathers and ring hops the mesh then stages through the
host (``Mesh.staging``).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Optional

import torch
import torch.distributed as dist


def world_layout(world: int, device: str = "cuda"):
    """(backend, device of each rank) for ``world`` ranks on ``device``
    ("cuda" or "cpu")."""
    if torch.device(device).type == "cpu":
        return "gloo", [torch.device("cpu")] * world
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the ranks on the CPU")
    devices = [torch.device("cuda", r % count) for r in range(world)]
    return ("nccl" if world <= count else "gloo"), devices


def init_world(rank: int, world: int, init_method: str = "env://",
               device: str = "cuda", local_rank: Optional[int] = None
               ) -> torch.device:
    """Join the world as ``rank`` of ``world`` and return this rank's
    device (``world_layout``). Under ``torchrun`` pass the environment's
    RANK and WORLD_SIZE with the default ``env://``; ``local_rank`` picks
    the card (default LOCAL_RANK, else the rank)."""
    from gmf_tpu_torch.parallel import mesh

    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    backend, devices = world_layout(world, device)
    dev = devices[local_rank]
    if dev.type == "cuda":
        from gmf_tpu_torch.utils.device import resolve_device

        resolve_device(dev)
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    mesh._WORLD_DEVICE = dev
    return dev


def _child(fn, rank, world, tmp, device, threads, args):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_world(rank, world, f"file://{os.path.join(tmp, 'store')}",
                   device, local_rank=rank)
        result = fn(rank, world, *args)
        with open(os.path.join(tmp, f"result{rank}.pkl.part"), "wb") as f:
            pickle.dump(result, f)
        os.replace(os.path.join(tmp, f"result{rank}.pkl.part"),
                   os.path.join(tmp, f"result{rank}.pkl"))
        if dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def launch(fn: Callable, world: int, *args, device: str = "cuda",
           timeout: float = 600.0, threads: int = 0) -> List:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks and
    return their results in rank order (module docstring). ``threads``:
    each rank's torch CPU threads (0 = torch's default)."""
    tmp = tempfile.mkdtemp(prefix="gmf_world_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child,
                         args=(fn, r, world, tmp, device, threads, args),
                         daemon=False)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(_failure(tmp, procs, failed))
            if time.monotonic() > deadline:
                raise RuntimeError(f"a world of {world} ranks did not finish "
                                   f"within {timeout:.0f} s")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(_failure(tmp, procs, failed))
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def _failure(tmp, procs, failed) -> str:
    lines = []
    for r in failed:
        path = os.path.join(tmp, f"error{r}.txt")
        text = f"exit code {procs[r].exitcode}"
        if os.path.exists(path):
            with open(path) as f:
                text = f.read()
        lines.append(f"rank {r} failed:\n{text}")
    return "\n".join(lines)

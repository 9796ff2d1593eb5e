"""Process-group bootstrap, per-rank data sharding and a local rank launcher
(counterpart of ``stereo_vo_tpu/parallel/distributed.py``).

``initialize_multihost`` brings up ``torch.distributed`` from explicit
arguments or from ``SVO_COORDINATOR`` / ``SVO_NUM_PROCESSES`` /
``SVO_PROCESS_ID`` and is a no-op without either, so one entry point serves a
single process and a multi-host run. ``shard_for_host`` splits a work list
over ranks, ``local_dp_block`` keeps a rank's block of a batch, and
``spawn_ranks`` runs a function on N local processes joined in one gloo group
(the sharded solver's tests and ``parallel/dryrun.py`` use it).
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _init_method(address: str) -> str:
    return address if "://" in address else f"tcp://{address}"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join a ``torch.distributed`` world if (and only if) one is requested;
    returns ``(rank, world_size)``.

    - explicit arguments: ``coordinator_address`` (``host:port`` or an
      ``init_method`` URL such as ``file:///path``), ``num_processes`` and
      ``process_id``;
    - else the environment: ``SVO_COORDINATOR``, ``SVO_NUM_PROCESSES``,
      ``SVO_PROCESS_ID``;
    - neither: no-op, ``(0, 1)``.

    The backend is ``nccl`` when CUDA is available and ``gloo`` otherwise.
    An already initialized world is returned as it is."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("SVO_COORDINATOR")
        if num_processes is None and os.environ.get("SVO_NUM_PROCESSES"):
            num_processes = int(os.environ["SVO_NUM_PROCESSES"])
        if process_id is None and os.environ.get("SVO_PROCESS_ID"):
            process_id = int(os.environ["SVO_PROCESS_ID"])
    if not dist.is_initialized() and coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and process_id")
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                                world_size=num_processes, rank=process_id)
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def shard_for_host(
    items: Sequence,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> List:
    """Contiguous per-rank slice of a work list (sequences, frame chunks).

    Rank ``i`` of ``n`` gets ``len(items) // n`` items, the first
    ``len(items) % n`` ranks one more; the union over ranks is ``items``."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    i = rank if process_index is None else process_index
    n = world if process_count is None else process_count
    base, extra = divmod(len(items), n)
    start = i * base + min(i, extra)
    stop = start + base + (1 if i < extra else 0)
    return list(items[start:stop])


def _map_leaves(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_map_leaves(fn, v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def local_dp_block(batch, mesh, dp_axis: str = "dp"):
    """This rank's contiguous block of a batch along the ``dp`` mesh axis.

    The counterpart of the JAX package's ``host_local_problem_to_global``:
    JAX assembles per-host blocks into one global array laid out as
    ``NamedSharding(mesh, P("dp"))``; torch has no global array, so each rank
    keeps the block that layout would place on it. ``batch`` is a tensor,
    array, dict, list or (named) tuple of them, each with the batch leading;
    the batch must divide by the axis size."""
    n = mesh.size(mesh.mesh_dim_names.index(dp_axis))
    i = mesh.get_local_rank(dp_axis)

    def block(x):
        b = x.shape[0]
        if b % n:
            raise ValueError(f"batch of {b} not divisible by {n} {dp_axis!r} ranks")
        return x[i * (b // n):(i + 1) * (b // n)]

    return _map_leaves(block, batch)


def _rank_main(rank, world, run_dir, target, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(run_dir, 'store')}",
                            world_size=world, rank=rank)
    try:
        out = target(rank, world, *args)
    finally:
        dist.destroy_process_group()
    # a file, not a queue: a child whose result is still in a pipe nobody
    # reads yet cannot exit, and the parent waits for the exits first
    with open(os.path.join(run_dir, f"result_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def spawn_ranks(target: Callable, n_ranks: int, args: tuple = (),
                store_dir: Optional[str] = None, timeout: float = 120.0) -> list:
    """Run ``target(rank, world, *args)`` on ``n_ranks`` spawned processes
    joined in one gloo world (a file store in a new directory under
    ``store_dir``, the system's temporary directory by default); returns the
    targets' results by rank.

    ``target`` and its arguments are pickled, so ``target`` is a module-level
    function of an importable module. If a rank fails, the others are
    terminated and ``torch.multiprocessing.ProcessRaisedException`` carries
    its traceback; if the ranks have not all finished within ``timeout``
    seconds, they are terminated and ``TimeoutError`` is raised."""
    import torch.multiprocessing as mp

    run_dir = tempfile.mkdtemp(prefix="svo_ranks_", dir=store_dir)
    ctx = mp.start_processes(_rank_main, (n_ranks, run_dir, target, args), nprocs=n_ranks,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{n_ranks} ranks did not all finish within {timeout} s")
        out = []
        for r in range(n_ranks):
            with open(os.path.join(run_dir, f"result_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
        shutil.rmtree(run_dir, ignore_errors=True)

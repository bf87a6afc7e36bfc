"""Start N ranks of one function under a process group.

    results = spawn(fn, 4, backend="gloo", args=(x,))

runs ``fn(rank, world, *args)`` in ``nprocs`` fresh processes (the
``spawn`` start method), each inside
``init_process_group(backend, rank=rank, world_size=nprocs)`` over
``MASTER_ADDR=127.0.0.1`` and a free local port, and returns each rank's
return value, in rank order.  A rank that raises makes `spawn` raise
`RankError` with that rank's traceback; every process it started is
stopped before it returns or raises.  ``fn`` and its return value must
pickle (``torch.multiprocessing`` shares CUDA tensors between processes
of one host through IPC handles; results travel by value).

The caller picks the backend: NCCL when each rank has its own card,
gloo on the CPU or for several ranks on one card.  ``threads`` caps each
rank's intra-op threads (ranks of one host share its cores).
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import socket
import traceback

import torch.multiprocessing as mp


class RankError(RuntimeError):
    """A rank of a `spawn` raised or died."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, backend, threads, device_id, args,
               results):
    import torch
    import torch.distributed as dist
    os.environ["MASTER_ADDR"] = "127.0.0.1"
    os.environ["MASTER_PORT"] = str(port)
    if threads:
        torch.set_num_threads(threads)
    try:
        kw = {}
        if device_id is not None:
            torch.cuda.set_device(device_id)
            if backend == "nccl":
                kw["device_id"] = torch.device("cuda", device_id)
        dist.init_process_group(backend, rank=rank, world_size=world, **kw)
        try:
            out = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        # by value: a tensor shared by handle would die with this process
        results.put((rank, True, pickle.dumps(out)))
    except Exception:  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, nprocs: int, *, backend: str = "gloo", args: tuple = (),
          threads: int | None = 1, device_id: int | None = None,
          timeout: float = 600.0) -> list:
    """``[fn(rank, nprocs, *args) for rank in range(nprocs)]``, each in
    its own process of one process group.  ``device_id``: the CUDA
    device every rank sets as current (None: the CPU ranks set none).

    Raises:
      RankError: a rank raised (its traceback in the message), died, or
        none answered within ``timeout`` seconds.
    """
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, nprocs, port, backend, threads,
                               device_id, args, results), daemon=True)
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got: dict = {}
    waited = 0.0
    try:
        while len(got) < nprocs:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(procs) if r not in got
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RankError(f"ranks {dead} of {nprocs} died "
                                    f"(exit codes "
                                    f"{[procs[r].exitcode for r in dead]})"
                                    ) from None
                if waited >= timeout:
                    raise RankError(f"ranks {sorted(set(range(nprocs)) - set(got))}"
                                    f" gave no result within {timeout} s"
                                    ) from None
                continue
            if not ok:
                raise RankError(f"rank {rank} of {nprocs} raised:\n{out}")
            got[rank] = pickle.loads(out)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return [got[r] for r in range(nprocs)]

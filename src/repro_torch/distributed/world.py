"""A local world of processes for the distributed bodies.

``run_world(fn, world_size, args)`` spawns ``world_size`` processes with
the ``spawn`` start method, joins each to one process group through a
``FileStore`` in a fresh temporary directory (no TCP port to pick or to
clash), calls ``fn(rank, world_size, *args)`` in every rank and returns
the ranks' return values in rank order.  A rank that raises fails the
world with its traceback; a world that outlives ``timeout`` seconds (a
hung collective) is killed and fails.  Every rank checks that importing
the port brought in no JAX.

The card is shared: on ``cuda`` every rank uses device 0 unless the
machine has a card per rank.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import tempfile
import time
import traceback

import torch


def _child(rank: int, world_size: int, store_dir: str, backend: str,
           threads: int | None, fn, args) -> None:
    import torch.distributed as dist
    import repro_torch.distributed  # noqa: F401
    out = os.path.join(store_dir, f"rank{rank}")
    try:
        if "jax" in sys.modules:
            raise AssertionError("importing repro_torch.distributed "
                                 "imported jax")
        if threads is not None:
            torch.set_num_threads(threads)
        if torch.cuda.is_available():
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)
        try:
            result = fn(rank, world_size, *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, out + ".pt")
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise


def run_world(fn, world_size: int, args: tuple = (), backend: str = "gloo",
              timeout: float = 120.0, threads: int | None = None) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes of one process group; returns their results in rank order.

    ``fn`` and ``args`` must pickle (``fn`` a module-level function).
    ``threads`` sets each rank's intra-op thread count.  Raises
    ``RuntimeError`` with the failing ranks' tracebacks, or when the world
    has not ended after ``timeout`` seconds (every rank is then killed).
    """
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as d:
        procs = [ctx.Process(target=_child, daemon=True,
                             args=(r, world_size, d, backend, threads, fn,
                                   args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        # a rank that failed leaves the others waiting in a collective:
        # stop waiting as soon as one has
        while (any(p.is_alive() for p in procs)
               and not any(p.exitcode for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        failed = any(p.exitcode for p in procs)
        hung = [] if failed else [r for r, p in enumerate(procs)
                                  if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        errors = []
        for r in range(world_size):
            err = os.path.join(d, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    errors.append(f"rank {r}:\n{f.read()}")
        if errors or hung:
            raise RuntimeError(
                (f"world of {world_size} timed out after {timeout:.0f} s; "
                 f"ranks still running: {hung}\n" if hung else "")
                + "\n".join(errors))
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
        return [torch.load(os.path.join(d, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(world_size)]

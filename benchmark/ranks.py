"""The ranks of a cell that takes several cards: one process a card.

``benchmark/run.py`` is rank 0: it starts ranks 1 .. n-1 with
``multiprocessing``'s spawn method (``rank_main``), and every rank joins the
port's process group through its own ``t2v_torch.parallel.multihost.initialize``
(an ``env://`` rendezvous on localhost; NCCL when each rank has a card of
its own, gloo on the CPU). Every rank then runs the cell's set-up, the
window's units and the traced units in lockstep, since the units are
collective; rank 0 alone times the window, traces, reads the metrics, runs
the reference and prints. The other ranks print nothing on standard output
(it is pointed at standard error) and end once their captures are gathered
and they have told rank 0 whether their process loaded JAX.

A rank that ends with an error ends the cell: rank 0 watches the others
(``Watch``) and, when one fails, stops the rest and exits without a result,
rather than wait in a collective for a peer that is gone; a rank whose
parent is gone exits.
"""

from __future__ import annotations

import os
import socket
import sys
import threading
import time

import torch


class Ranks:
    """This process's place in the cell's group of ranks. The default is a
    group of one, whose exchanges return this rank's own values."""

    def __init__(self, world: int = 1, rank: int = 0, device=None):
        self.world, self.rank, self.device = world, rank, device

    @property
    def primary(self) -> bool:
        return self.rank == 0

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        if self.world == 1:
            return flag
        import torch.distributed as dist

        t = torch.tensor([int(flag)], dtype=torch.int64, device=self.device)
        dist.broadcast(t, src=0)
        return bool(t.item())

    def each(self, value: int) -> list[int]:
        """Every rank's ``value``, in rank order, on every rank."""
        if self.world == 1:
            return [int(value)]
        import torch.distributed as dist

        t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t)
        return [int(p.item()) for p in parts]

    def close(self) -> None:
        """Leave the process group (a group of one has none)."""
        if self.world > 1:
            from t2v_torch.parallel import multihost

            multihost.shutdown()


ONE = Ranks()


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def join(rank: int, world: int, port: int, device_type: str) -> Ranks:
    """Join the port's process group as ``rank`` of ``world`` and return
    this rank's ``Ranks``, on the device the port gives the rank. Each rank
    keeps one CPU thread for PyTorch's own operators, as ``torchrun`` sets
    ``OMP_NUM_THREADS=1`` for its workers: ranks that each spread over
    every core would spin against one another."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    from t2v_torch.parallel import multihost

    multihost.initialize(device=device_type)
    return Ranks(world, rank, multihost.rank_device(device_type))


def _exit_with_parent(parent: int) -> None:
    while True:
        if os.getppid() != parent:
            os._exit(1)
        time.sleep(1.0)


def rank_main(cell, seed: int, seconds: float, trace: bool, rank: int, port: int,
              device_type: str, fault: str | None) -> None:
    """Rank ``rank`` (1 or more) of a cell: the same set-up and units as
    rank 0, nothing printed on standard output."""
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    threading.Thread(target=_exit_with_parent, args=(os.getppid(),), daemon=True).start()
    from benchmark import faults, run

    run.cache_env(run.ROOT)
    ranks = join(rank, cell.chips, port, device_type)
    with faults.planted(fault):
        run.run_cell(cell, seed, seconds, trace, ranks.device, ranks=ranks)


def start(cell, seed: int, seconds: float, trace: bool, port: int, device_type: str,
          fault: str | None) -> list:
    """Start ranks 1 .. chips - 1 of ``cell``; returns their processes."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, name=f"rank{r}",
                         args=(cell, seed, seconds, trace, r, port, device_type, fault))
             for r in range(1, cell.chips)]
    for p in procs:
        p.start()
    return procs


class Watch:
    """Rank 0's watch over the other ranks: when one ends with an error,
    the rest are stopped and this process exits with code 1."""

    def __init__(self, procs: list):
        self.procs = procs
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._watch, daemon=True)
        self.thread.start()

    def _watch(self) -> None:
        while not self.done.wait(0.5):
            failed = [p for p in self.procs if p.exitcode not in (None, 0)]
            if failed:
                print(f"benchmark: {failed[0].name} ended with code {failed[0].exitcode}; "
                      "stopping the other ranks", file=sys.stderr, flush=True)
                stop(self.procs, grace=5.0)
                os._exit(1)

    def close(self) -> None:
        self.done.set()
        self.thread.join()


def stop(procs: list, grace: float = 120.0) -> None:
    """Wait up to ``grace`` seconds for each process to end, then
    terminate, then kill what is left, and wait for it."""
    deadline = time.monotonic() + grace
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10.0)
        if p.is_alive():
            p.kill()
            p.join()

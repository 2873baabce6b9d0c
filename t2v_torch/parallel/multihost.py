"""Process-group initialisation and the seed and work-split policy.

The port of the JAX package's ``parallel/multihost.py`` (the reference's
DDP wrapper: an ``env://`` rendezvous, one process a rank, seeds offset by
the rank, media written by rank 0), on ``torch.distributed``:

  * ``initialize()`` joins the process group. With no arguments it reads
    the ``env://`` variables that ``torchrun`` sets; a coordinator address,
    a process count and an index rendezvous over TCP instead;
  * each rank drives ``cuda:{local_rank % device_count}``. The backend is
    NCCL when every rank of a host has a card of its own, and gloo when
    ranks share a card (NCCL refuses two ranks on one device) or run on the
    CPU, decided from the device count;
  * ``host_seed`` offsets a seed by the rank, ``shared_seed`` hands rank
    0's seed to every rank (a random seed is drawn on each rank alone),
    ``local_shard`` splits n samples over the ranks with the remainder on
    the first ones, and ``is_primary`` gates media and checkpoint writes to
    rank 0.

The JAX package's ``host_key`` (a process index folded into a PRNG key) has
no counterpart: the port draws from explicit ``torch.Generator``s seeded by
``host_seed`` or per sample (``parallel/dp_sample.py``).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from t2v_torch.parallel import audit


def process_index() -> int:
    """This process's rank in the default group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """Ranks in the default group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK`` under torchrun)."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def backend_for(local_world: int, device: str = "cuda") -> str:
    """NCCL when every one of ``local_world`` ranks on a host has a card of
    its own, else gloo (ranks sharing a card, or CPU ranks)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if torch.device(device).type == "cuda" and 0 < local_world <= cards:
        return "nccl"
    return "gloo"


def rank_device(device: str = "cuda") -> torch.device:
    """The device this rank drives: ``cuda:{local_rank % device_count}``
    on the card, the CPU when the caller asks for it."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("t2v_torch: CUDA was asked for but no GPU is available; pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device: str = "cuda") -> str:
    """Join the default process group and return its backend. Without
    arguments the rendezvous is ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, as torchrun sets them); ``coordinator_address``
    ("host:port") with ``num_processes`` and ``process_id`` rendezvous over
    TCP, all processes on one host."""
    if coordinator_address is None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        kwargs = dict(init_method="env://")
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize: a coordinator address needs num_processes and "
                             "process_id")
        world = local_world = num_processes
        os.environ.setdefault("LOCAL_RANK", str(process_id))
        kwargs = dict(init_method=f"tcp://{coordinator_address}", world_size=num_processes,
                      rank=process_id)
    backend = backend_for(local_world, device)
    if backend == "nccl":
        torch.cuda.set_device(rank_device(device))
    dist.init_process_group(backend=backend, **kwargs)
    if is_primary():
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"t2v_torch.parallel: {process_count()} ranks, {local_world} on this host, "
              f"{cards} CUDA devices here: backend {backend}", flush=True)
    return backend


def shutdown() -> None:
    """Leave the default process group (a no-op without one)."""
    if dist.is_initialized():
        from t2v_torch.parallel import mesh

        mesh.forget_meshes()
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the process that writes media and checkpoints (rank 0)."""
    return process_index() == 0


def host_seed(seed: int) -> int:
    """seed + rank: the reference's per-rank seed. Inside one sharded
    request prefer the per-sample seed + i (``dp_sample.batched_noise``)."""
    return seed + process_index()


def shared_seed(seed: int) -> int:
    """Rank 0's ``seed`` on every rank of the default group (``seed``
    itself without one). Every rank of the group must call it."""
    if process_count() == 1:
        return seed
    box = [seed]
    if audit.recorders:  # recorded as the one int64 it carries
        audit.record("broadcast", "default", torch.zeros(1, dtype=torch.int64))
    dist.broadcast_object_list(box, src=0)
    return int(box[0])


def local_shard(n_samples: int, world: int | None = None,
                rank: int | None = None) -> tuple[int, int]:
    """(start, count) of a rank's share of ``n_samples``: contiguous, with
    the remainder spread over the first ranks. ``world`` and ``rank``
    default to the default group's."""
    world = process_count() if world is None else world
    rank = process_index() if rank is None else rank
    base, rem = divmod(n_samples, world)
    count = base + (1 if rank < rem else 0)
    start = rank * base + min(rank, rem)
    return start, count

"""Process-group initialization (counterpart of
idgrec_tpu/parallel/distributed.py; ROADMAP A.9).

One process a card. Under ``torchrun`` (or any launcher that sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``) a bare `initialize()` joins the group; explicit
arguments name the rendezvous instead:

    from idgrec_torch.parallel import distributed
    distributed.initialize()              # torchrun's environment
    mesh = make_mesh()                    # every rank of the group

NCCL on the card, gloo when the caller asks for the CPU; each rank is
bound to ``cuda:LOCAL_RANK``. The state machine is the JAX package's:
idempotent; a bare call that finds no cluster environment is a no-op
single-process run, once; an explicit call after that still joins; a
join that fails raises, so no rank ever goes on alone while its peers
wait.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

_initialized: str | None = None  # None | "local" | "cluster"

# how long a collective may wait for a peer before the group fails
TIMEOUT = datetime.timedelta(seconds=600)


def _env_cluster() -> tuple[str, int, int] | None:
    """(init_method, world size, rank) from a launcher's environment, or
    None where it sets none."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT", "29500")
    return f"tcp://{addr}:{port}", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device=None) -> None:
    """Join the process group (idempotent). ``coordinator_address``
    ("host:port"), ``num_processes`` and ``process_id`` name it
    explicitly; without them the launcher's environment does, and with
    neither the run stays single-process. ``device`` "cpu" takes gloo,
    otherwise NCCL on ``cuda:LOCAL_RANK``."""
    global _initialized
    if _initialized == "cluster":
        return
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if _initialized == "local" and not explicit:
        return
    if explicit:
        found = _env_cluster()
        init = (f"tcp://{coordinator_address}" if coordinator_address is not None
                else (found[0] if found else None))
        world = num_processes if num_processes is not None else (found[1] if found else None)
        rank = process_id if process_id is not None else (found[2] if found else None)
        if init is None or world is None or rank is None:
            raise ValueError("initialize: name the coordinator address, the process count and "
                             "this process's id, or run under a launcher that sets them")
    else:
        found = _env_cluster()
        if found is None:
            _initialized = "local"
            return
        init, world, rank = found
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to join a gloo group")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init, world_size=world,
                            rank=rank, timeout=TIMEOUT)
    _initialized = "cluster"


def shutdown() -> None:
    """Leave the process group (every rank calls it) and reset the state."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = None


def free_port() -> int:
    """A free TCP port on localhost: the rendezvous of a group this host
    starts itself."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the rank that owns the run's side effects (log files,
    checkpoints, stdout); always True single-process."""
    return process_index() == 0

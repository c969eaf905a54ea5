"""Process-group initialisation (counterpart of
``whisper_sae_tpu/parallel/multihost.py``).

``torchrun`` starts one process per GPU and gives each its place in the
environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``); :func:`initialize_if_needed` reads it, as the JAX
helper reads ``JAX_COORDINATOR_ADDRESS`` and friends.  With no such
environment and no arguments it does nothing and returns ``False``: the
single-device path runs as it always has.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def initialize_if_needed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout_s: float | None = None,
) -> bool:
    """Initialise ``torch.distributed`` when a launch environment is found
    (or explicit arguments are given); ``True`` if a group exists after.

    ``coordinator_address``: ``host:port`` (TCP) or any init URL
    (``file://...``, ``tcp://...``); by default ``env://`` from torchrun's
    ``MASTER_ADDR``/``MASTER_PORT``.  ``backend``: ``nccl`` where there is
    a card, else ``gloo``, unless the caller names one (two ranks sharing
    one card need ``gloo``).  Each rank's card is ``cuda:LOCAL_RANK``
    (without ``LOCAL_RANK``: the rank modulo the cards)."""
    if dist.is_initialized():
        return True
    num_processes = num_processes or _int_env("WORLD_SIZE")
    process_id = process_id if process_id is not None else _int_env("RANK")
    if coordinator_address is None and num_processes is None:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a process group needs both the world size and this rank")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if torch.cuda.is_available():
        local = _int_env("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None
                              else process_id % torch.cuda.device_count())
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, **kw)
    return True


def _int_env(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def launched() -> bool:
    """Whether this process was started by a launcher (``torchrun`` sets
    ``WORLD_SIZE``) or already belongs to a process group."""
    return dist.is_initialized() or "WORLD_SIZE" in os.environ


def is_primary() -> bool:
    """True on the process that writes checkpoints, metrics and the
    console: rank 0, or the only process when no group exists."""
    return not dist.is_initialized() or dist.get_rank() == 0

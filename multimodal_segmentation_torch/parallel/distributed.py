"""Start the process group of a multi-process run.

Port of multimodal_segmentation_tpu/parallel/distributed.py:19-46. Every
process runs the same program; `maybe_initialize_distributed()` joins
them into one torch.distributed process group from the variables that
torchrun sets (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK).
Without them it does nothing and returns False, so one entry point runs
alone or under torchrun:

    torchrun --nproc_per_node 4 train.py    # train.py calls it first
"""

import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger("distributed")

_VARIABLES = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def local_device():
    """This process's device: cuda:(LOCAL_RANK % cards) when a card is
    present (LOCAL_RANK 0 without the variable), else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def maybe_initialize_distributed(backend=None):
    """Initialise the default process group from torchrun's variables.

    The backend defaults to NCCL with a card and gloo without one; pass
    backend='gloo' to run several ranks on one card (NCCL refuses two
    ranks on one device). With a card, each rank's current device is
    local_device(). Returns True when it initialised a group, False when
    the variables are missing or a group exists already."""
    if not all(v in os.environ for v in _VARIABLES):
        return False
    if dist.is_initialized():
        log.warning("torch.distributed is initialised already; left as it is")
        return False
    device = local_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))
    log.info("torch.distributed initialised: rank %d/%d, %s on %s", dist.get_rank(),
             dist.get_world_size(), backend, device)
    return True


def is_writer(mesh):
    """Whether this process writes a run's files: always without a mesh,
    else only rank 0 of the mesh."""
    return mesh is None or mesh.rank == 0


def barrier(mesh):
    """Under a mesh of several processes, wait until every rank is here
    (the ranks that do not write wait for the one that does)."""
    if mesh is not None and dist.is_initialized():
        dist.barrier()

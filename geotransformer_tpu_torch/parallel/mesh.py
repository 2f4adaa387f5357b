r"""The process group of data-parallel training (``geotransformer_tpu/parallel/mesh.py``;
reference `engine/base_trainer.py:66-72`).

The JAX package runs one program over a mesh of devices and reduces over its
``data`` axis. Here each process owns one card and takes one pair a step, as
the reference's one process per GPU does: the processes join a
``torch.distributed`` group, and the train and eval steps reduce gradients
and metrics across it (:func:`mean_`, :func:`max_`), so the group plays the
mesh's part. Without a group every helper acts on this process alone.

Launch (``torch.distributed.run`` sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT):

    python -m torch.distributed.run --nproc_per_node N \
        -m geotransformer_tpu_torch.scripts.trainval --dataset 3dmatch --data_root ...
"""

import datetime
import os

import torch
import torch.distributed as dist


def init_process_group(device=None, backend=None, timeout=datetime.timedelta(minutes=30)):
    """Join the process group the launcher's environment describes (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return this
    process's device: ``cuda:LOCAL_RANK`` unless ``device`` names another
    (``"cpu"``, or a card that several ranks share). The backend is NCCL for
    a CUDA device and Gloo for the CPU, unless ``backend`` names one (Gloo
    also reduces CUDA tensors: two ranks on one card, where NCCL refuses).
    A collective that waits past ``timeout`` raises."""
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    device = torch.device(device if device is not None
                          else f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=timeout)
    return device


def destroy_process_group():
    if is_initialized():
        dist.destroy_process_group()


def is_initialized():
    return dist.is_available() and dist.is_initialized()


def world_size():
    return dist.get_world_size() if is_initialized() else 1


def rank():
    return dist.get_rank() if is_initialized() else 0


def barrier():
    if is_initialized():
        dist.barrier()


def check_pairs_per_process(pairs):
    """One pair per device (JAX ``make_mesh``): a process owns one card, so
    a group of more pairs a step has no device to go to."""
    if pairs != 1:
        raise ValueError(
            f"a process owns one card and takes one pair a step; got {pairs} pairs a step "
            "(one pair per device: launch one process per card, e.g. "
            "python -m torch.distributed.run --nproc_per_node N)")


def mean_(tensor):
    """In place: the mean of ``tensor`` over the group's ranks (``pmean``),
    the same on every rank. Without a group, ``tensor`` as it is."""
    if is_initialized():
        dist.all_reduce(tensor)
        tensor.div_(dist.get_world_size())
    return tensor


def max_(tensor):
    """In place: the largest ``tensor`` over the group's ranks (``pmax``)."""
    if is_initialized():
        dist.all_reduce(tensor, op=dist.ReduceOp.MAX)
    return tensor


def all_gather_object(obj):
    """Every rank's ``obj``, in rank order (``[obj]`` without a group)."""
    if not is_initialized():
        return [obj]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, obj)
    return gathered

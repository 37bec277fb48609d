"""Process groups, device meshes and the ZeRO rule (counterpart of
audio_calm_tpu/parallel/mesh.py).

The JAX package gets data parallelism from sharding annotations: the batch
sharded on a "data" mesh axis, optimizer state ZeRO-sharded on it, and XLA
inserting the collectives. PyTorch has no GSPMD, so the port writes them
out, in two forms that follow what the JAX package runs:

  - training: one process per device over torch.distributed (NCCL on the
    card, gloo on the CPU), the counterpart of JAX's multi-process
    `--distributed` runs. `init_distributed_from_env` reads torchrun's
    variables; each rank loads only its rows of a global batch
    (`shard_host_batch` puts them on its device); train/steps.py gathers
    the batch's rows and train/optim.AdamW reduce-scatters the gradients
    on `zero_leaf_spec`'s dim (ZeRO-2).
  - inference: one process and a `Mesh` of devices [data, model]
    (parallel/infer_shard.py). Devices may repeat, so that one card or the
    CPU stands in for several, as JAX's tests use
    `--xla_force_host_platform_device_count=8`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def init_distributed_from_env(device=None) -> torch.device:
    """Join the process group torchrun's variables describe (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK) -> this rank's device.
    device None (the card): NCCL on cuda:LOCAL_RANK, which becomes the
    current device; device "cpu": gloo on the CPU. Without a card and
    without device="cpu" it raises."""
    env = os.environ
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE",
                           "RANK") if k not in env]
    if missing:
        raise RuntimeError(f"--distributed needs torchrun's variables; "
                           f"{missing} not set")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local = int(env.get("LOCAL_RANK", rank))
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("--distributed on the card needs CUDA; pass "
                               "--device cpu for gloo on the CPU")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        dev = torch.device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if dev.type == "cuda":
            dev = torch.device("cuda", local)
            torch.cuda.set_device(dev)
    if not dist.is_initialized():
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method=f"tcp://{env['MASTER_ADDR']}:"
                                 f"{env['MASTER_PORT']}",
            world_size=world, rank=rank, **kw)
    return dev


def rank_world() -> Tuple[int, int]:
    """(rank, world size) of the default process group, (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    """Rank 0, or no process group: the process that logs and writes."""
    return rank_world()[0] == 0


def barrier() -> None:
    if rank_world()[1] > 1:
        dist.barrier()


def finish_distributed() -> None:
    """Leave the process group (a no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


class Mesh:
    """A [data, model] array of torch devices (JAX's Mesh with axes
    ("data", "model")). `devices[d][m]`; `shape` {"data": D, "model": M}.
    The same device may appear more than once."""

    def __init__(self, devices: Sequence[Sequence[torch.device]]):
        self.devices: List[List[torch.device]] = [
            [torch.device(x) for x in row] for row in devices]
        widths = {len(row) for row in self.devices}
        if not self.devices or len(widths) != 1:
            raise ValueError("a mesh needs equal, non-empty rows")
        self.shape: Dict[str, int] = {"data": len(self.devices),
                                      "model": widths.pop()}


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (data, model) mesh over `devices` (default every CUDA device);
    data defaults to len(devices) // model."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices "
                               "(for example ['cpu'] * 4)")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"{data}x{model} != {n} devices")
    return Mesh([devices[i * model:(i + 1) * model] for i in range(data)])


def serving_devices(n: int, device=None) -> List[torch.device]:
    """The devices of an n-device serving mesh: cuda:0 .. n-1 (raising when
    the machine has fewer, as JAX asserts), or `device` n times when it is
    given (the CPU, or one card standing in for several)."""
    if device is not None:
        return [torch.device(device)] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise ValueError(f"dp * tp = {n} devices, the machine has {have}")
    return [torch.device("cuda", i) for i in range(n)]


def shard_host_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (the collator's
    process_index slice) as tensors on its device; host-side keys (the
    task, n_samples) are dropped. JAX stitches the ranks' rows into one
    global array here; the port's train step gathers them itself
    (train/steps.py)."""
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            for k, v in batch.items()
            if isinstance(v, (np.ndarray, torch.Tensor))}


def gather_rows(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The global batch from every rank's rows, in rank order (each rank
    holds the same shapes); the batch itself with one rank."""
    _, world = rank_world()
    if world == 1:
        return batch
    out = {}
    for k, v in batch.items():
        parts = [torch.empty_like(v) for _ in range(world)]
        dist.all_gather(parts, v.contiguous())
        out[k] = torch.cat(parts)
    return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of `t` (in place; returned)."""
    if rank_world()[1] > 1:
        dist.all_reduce(t)
    return t


def _data_size(mesh) -> int:
    if isinstance(mesh, Mesh):
        return mesh.shape["data"]
    return int(mesh)


def zero_leaf_spec(mesh, leaf, min_size: int = 2 ** 14) -> Optional[int]:
    """ZeRO's rule for one leaf (JAX's zero_leaf_spec): the dim to shard
    over the data size (a Mesh's "data" axis, or the world size), the
    largest dim when it divides and the leaf has at least `min_size`
    elements; None (replicate) for scalars, small or indivisible
    shapes."""
    n = _data_size(mesh)
    shape = tuple(getattr(leaf, "shape", ()))
    if not shape or int(np.prod(shape)) < min_size:
        return None
    best = int(np.argmax(shape))
    return best if shape[best] % n == 0 else None


def zero_sharding(mesh, tree, min_size: int = 2 ** 14):
    """zero_leaf_spec over a nested dict / list of leaves."""
    if isinstance(tree, dict):
        return {k: zero_sharding(mesh, v, min_size) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zero_sharding(mesh, v, min_size) for v in tree)
    return zero_leaf_spec(mesh, tree, min_size)

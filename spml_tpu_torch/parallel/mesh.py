"""The data-parallel layer: one process per rank, joined in a
torch.distributed process group.

Port of spml_tpu/parallel/mesh.py:27-108. There, the train step is one
SPMD program over a 1-D 'data' mesh and XLA inserts the collectives. Here
each rank runs the step on its own slice of the global batch and the
port issues the collectives itself:

* batch-norm statistics over the global batch (models/resnet.py::
  BatchNorm2d);
* the all-gather of every image's prototypes, labels, tags and validity,
  whose backward returns each rank's prototype gradient to its owner
  (all_gather);
* the loss means over the groups of the global batch, and the sum of the
  parameter gradients (train/step.py).

Rank r of a global batch of W * b images takes images [r * b, (r + 1) * b)
(Mesh.shard). World size 1 (no process group) takes no collective at all:
every helper here returns its input unchanged and the callers keep their
single-process code.

Backends: NCCL when every rank has its own card, gloo on the CPU. gloo on
CUDA tensors, ranks sharing a card, is the one-card case a caller may ask
for by name (NCCL refuses two ranks on one card). A backend or a rank
that fails raises; nothing falls back to one process or to the CPU.

Collectives use all_reduce and barrier alone, which every backend has on
every device: a gather is the sum of zero buffers each rank filled at its
own slice (exact: the other ranks add zeros).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import socket
import tempfile

import torch
import torch.distributed as dist

from spml_tpu_torch.utils.device import resolve_device

SPATIAL_NEXT = ("tpu.spatial_partition > 1 (image height sharded over "
                "devices, with halo exchange for the dilated convolutions, "
                "batch norm and k-means) is not ported: it is the next slice "
                "of the port; tests/test_spatial_partition.py is its JAX "
                "reference")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The 'data' axis seen from one process: rank `rank` of `world`."""
    rank: int = 0
    world: int = 1

    def shard(self, global_batch: int) -> slice:
        """This rank's images of a global batch."""
        if global_batch % self.world:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {self.world} ranks")
        b = global_batch // self.world
        return slice(self.rank * b, (self.rank + 1) * b)


def world_size() -> int:
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def make_mesh(spatial: int = 1) -> Mesh:
    """The mesh of this process's group (rank 0 of 1 without one). spatial
    > 1, the JAX package's ('data', 'space') mesh, raises."""
    if spatial > 1:
        raise NotImplementedError(SPATIAL_NEXT)
    if world_size() == 1:
        return Mesh()
    return Mesh(dist.get_rank(), dist.get_world_size())


def _comm_device(x: torch.Tensor) -> torch.device:
    """NCCL reduces card tensors only: a host tensor goes to this rank's
    card for the collective."""
    if x.device.type == "cpu" and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return x.device


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over every rank, as a new tensor on x's device, without
    gradient; x itself at world size 1."""
    if world_size() == 1:
        return x
    out = x.detach().to(_comm_device(x), copy=True)
    dist.all_reduce(out)
    return out.to(x.device)


def _gather(x: torch.Tensor) -> torch.Tensor:
    rank, n = dist.get_rank(), x.shape[0]
    src = x.detach()
    if src.dtype == torch.bool:
        src = src.to(torch.uint8)
    out = src.new_zeros((world_size() * n, *x.shape[1:]),
                        device=_comm_device(x))
    out[rank * n:(rank + 1) * n] = src
    dist.all_reduce(out)
    return out.to(x.device, x.dtype)


class _AllGather(torch.autograd.Function):
    """Concatenation of every rank's x along dim 0, in rank order. The
    backward sums the gathered gradient over the ranks (each rank's loss
    reads every rank's rows) and keeps this rank's slice."""

    @staticmethod
    def forward(ctx, x):
        ctx.n = x.shape[0]
        return _gather(x)

    @staticmethod
    def backward(ctx, grad):
        rank = dist.get_rank()
        return all_reduce(grad.contiguous())[rank * ctx.n:
                                             (rank + 1) * ctx.n]


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's x concatenated along dim 0 in rank order (x itself at
    world size 1). Differentiable when x requires grad: the gradient of
    this rank's rows is their gradient summed over every rank's use."""
    if world_size() == 1:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _AllGather.apply(x)
    return _gather(x)


def barrier() -> None:
    if world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


# ---------------------------------------------------------------------------
# Launching ranks
# ---------------------------------------------------------------------------

def rank_devices(device: str = "cuda") -> list[torch.device]:
    """The device of each rank a --device value asks for: 'cuda' every
    visible card, one rank each (as the JAX package uses every visible
    chip); 'cpu:N' N ranks on the CPU (the JAX package's
    SPML_TPU_PLATFORM=cpu:N); anything else one process on that device.
    Raises on a host without a card when a card is asked for."""
    kind, _, n = str(device).partition(":")
    if kind == "cuda" and not n:
        resolve_device("cuda")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if kind == "cpu" and n:
        if int(n) < 1:
            raise ValueError(f"--device {device}: at least one rank")
        return [torch.device("cpu")] * int(n)
    return [resolve_device(device)]


def default_backend(devices) -> str:
    """gloo on the CPU, NCCL when every rank has its own card. Ranks that
    share a card, or mix a card and the CPU, must name gloo."""
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds == {"cuda"} and len({d.index for d in devices}) == len(devices):
        return "nccl"
    raise ValueError(f"ranks on {[str(d) for d in devices]}: NCCL needs one "
                     "card a rank; name backend='gloo' to share a card")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, args, devices, backend, port, out_dir):
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // len(devices)))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=len(devices), rank=rank)
    try:
        result = fn(*args, device=device)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, args, devices, backend: str | None = None) -> list:
    """fn(*args, device=devices[r]) in one spawned process per rank r,
    joined in a process group of `backend` (default_backend when None);
    returns each rank's result (pickled through a temporary file, so it
    should hold host tensors). fn must be importable by name. A rank that
    raises or dies ends the others and raises here."""
    devices = [torch.device(d) for d in devices]
    backend = backend or default_backend(devices)
    with tempfile.TemporaryDirectory() as out_dir:
        torch.multiprocessing.start_processes(
            _rank_main, nprocs=len(devices), join=True,
            start_method="spawn",
            args=(fn, tuple(args), devices, backend, _free_port(), out_dir))
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False)
                for r in range(len(devices))]


def _no_result(fn, *args, device):
    fn(*args, device=device)


def launch(fn, args=(), device: str = "cuda") -> None:
    """Runs fn(*args, device=...) on the ranks `device` asks for
    (rank_devices): under torchrun (WORLD_SIZE and RANK in the
    environment) this process joins its group as one rank, on card
    LOCAL_RANK or on the CPU; one rank runs here, with no process group;
    more are spawned (fn's results are dropped: a train state does not
    pickle)."""
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        if str(device).partition(":")[0] == "cuda":
            dev = resolve_device(
                f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
            torch.cuda.set_device(dev)
            backend = "nccl"
        else:
            dev, backend = torch.device("cpu"), "gloo"
        dist.init_process_group(backend)
        try:
            fn(*args, device=dev)
        finally:
            dist.destroy_process_group()
        return
    devices = rank_devices(device)
    if len(devices) == 1:
        fn(*args, device=devices[0])
    else:
        spawn(functools.partial(_no_result, fn), args, devices)

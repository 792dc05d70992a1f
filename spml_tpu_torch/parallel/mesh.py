"""The data-parallel layer: one process per rank, joined in a
torch.distributed process group.

Port of spml_tpu/parallel/mesh.py:27-108. There, the train step is one
SPMD program over a 1-D 'data' mesh, or a 2-D ('data', 'space') mesh
that also shards the image height (tpu.spatial_partition), and XLA
inserts the collectives. Here each rank runs the step on its own slice
of the global batch and the port issues the collectives itself:

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

With space S > 1 (make_mesh(spatial=S)), rank r is data rank r // S and
space rank r % S, row-major as the JAX package's
devices.reshape(-1, spatial): the D = W / S data ranks split the batch
and the S space ranks of a data rank split each of its images' rows
(Mesh.rows: H / S each), the leaves of SPATIAL_KEYS alone; every map
below the images is split by parallel/halo.py::partition. The halo
exchanges around the row-coupled operations (parallel/halo.py) and the
per-segment sums of an image (k-means, the prototypes) run within a
space group; the prototypes are gathered over a data group (each data
rank's once), and the loss groups are counted over a data group.

Backends: NCCL when every rank has its own card, gloo on the CPU. gloo on
CUDA tensors, ranks sharing a card, is the one-card case a caller may ask
for by name (NCCL refuses two ranks on one card). A backend or a rank
that fails raises; nothing falls back to one process or to the CPU.

Collectives use all_reduce and barrier alone, which every backend has on
every device: a gather is the sum of zero buffers each rank filled at its
own slice (exact: the other ranks add zeros). A sum that must give the
same bits on every rank and in every run (group_sum, sum_in_order: the
per-segment sums of a height-sharded image) gathers the ranks' partial
sums and adds them in rank order.

Each collective runs under the label of what it serves (collective():
"gradient", "batch norm", "gather", "halo", "segments", "pool" (PSPP's
pools), "colour" (DensePose's colour features), "other"); a timer set with
set_collective_timer wraps every collective with its label. None is set
unless a caller sets one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import socket
import tempfile
import threading
import time

import torch
import torch.distributed as dist

from spml_tpu_torch.utils.device import resolve_device

# Batch keys whose axis 1 is the image height: the only leaves that shard
# over 'space' (spml_tpu/parallel/mesh.py:58-63).
SPATIAL_KEYS = frozenset({"image", "semantic_label", "instance_label"})


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ('data', 'space') mesh seen from one process: rank `rank` of
    `world`, `space` ranks a data rank (1: the 'data' axis alone)."""
    rank: int = 0
    world: int = 1
    space: int = 1

    @property
    def data(self) -> int:
        """Data ranks: the ranks that split the batch."""
        return self.world // self.space

    @property
    def data_rank(self) -> int:
        return self.rank // self.space

    @property
    def space_rank(self) -> int:
        return self.rank % self.space

    def shard(self, global_batch: int) -> slice:
        """This rank's images of a global batch (its data rank's)."""
        if global_batch % self.data:
            raise ValueError(f"global batch {global_batch} does not split "
                             f"over {self.data} ranks")
        b = global_batch // self.data
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def rows(self, height: int) -> slice:
        """This rank's rows of an image `height` rows high."""
        if height % self.space:
            raise ValueError(f"height {height} does not split over "
                             f"{self.space} space ranks")
        h = height // self.space
        return slice(self.space_rank * h, (self.space_rank + 1) * h)

    def space_group(self):
        """The process group of this rank's space ranks (None at space
        1: no collective runs over it)."""
        return _groups(self.space)[0][self.data_rank] if self.space > 1 \
            else None

    def data_group(self):
        """The process group of the data ranks of this space rank (None
        at space 1: the whole group)."""
        return _groups(self.space)[1][self.space_rank] if self.space > 1 \
            else None


_GROUPS: dict = {}


def _groups(space: int):
    """(space groups by data rank, data groups by space rank) of the
    current process group, made once: every rank makes every group, in
    the same order, as dist.new_group requires."""
    world = dist.group.WORLD
    if _GROUPS.get("world") is not world:
        _GROUPS.clear()
        _GROUPS["world"] = world
    if space not in _GROUPS:
        n = world_size()
        spaces = [dist.new_group(list(range(d * space, (d + 1) * space)))
                  for d in range(n // space)]
        datas = [dist.new_group(list(range(s, n, space)))
                 for s in range(space)]
        _GROUPS[space] = (spaces, datas)
    return _GROUPS[space]


def destroy_groups() -> None:
    """Destroys the space and data groups, then the process group."""
    for spaces, datas in (v for k, v in _GROUPS.items() if k != "world"):
        for g in spaces + datas:
            dist.destroy_process_group(g)
    _GROUPS.clear()
    dist.destroy_process_group()


def world_size() -> int:
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def make_mesh(spatial: int = 1) -> Mesh:
    """The mesh of this process's group (rank 0 of 1 without one), with
    `spatial` space ranks a data rank; a group whose size spatial does
    not divide raises ValueError, as the JAX package's make_mesh does."""
    n = world_size()
    if spatial < 1 or n % spatial:
        raise ValueError(f"{n} rank(s) not divisible by spatial={spatial}")
    if n == 1:
        return Mesh()
    mesh = Mesh(dist.get_rank(), n, spatial)
    if spatial > 1:
        _groups(spatial)
    return mesh


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

_LABEL = threading.local()  # .kind: what the collectives issued now serve
_TIMER = None


def set_collective_timer(timer) -> None:
    """timer(kind) -> a context manager around each collective, kind its
    label (None for an unlabelled one); None: no timing."""
    global _TIMER
    _TIMER = timer


@contextlib.contextmanager
def collective(kind: str):
    """Labels the collectives issued inside as serving `kind`; an outer
    label holds (a batch norm's gather is the batch norm's)."""
    outer = getattr(_LABEL, "kind", None)
    _LABEL.kind = outer or kind
    try:
        yield
    finally:
        _LABEL.kind = outer


def _timed():
    timer = _TIMER
    if timer is None:
        return contextlib.nullcontext()
    return timer(getattr(_LABEL, "kind", None))


def _comm_device(x: torch.Tensor) -> torch.device:
    """NCCL reduces card tensors only: a host tensor goes to this rank's
    card for the collective."""
    if x.device.type == "cpu" and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return x.device


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of x over every rank of `group` (None: every rank), as a
    new tensor on x's device, without gradient; x itself at world size
    1."""
    if world_size() == 1:
        return x
    with _timed():
        out = x.detach().to(_comm_device(x), copy=True)
        dist.all_reduce(out, group=group)
        return out.to(x.device)


def sum_disjoint(buf: torch.Tensor, group) -> torch.Tensor:
    """The sum over the ranks of `group` of buffers each element of which
    is nonzero on one rank at most: that rank's bits, whatever the dtype
    (the bytes travel as int32 words, whose sum of disjoint bytes never
    carries). A new tensor of buf's shape, dtype and device."""
    with _timed():
        flat = buf.detach().contiguous().reshape(-1).view(torch.uint8)
        pad = -flat.numel() % 4
        words = torch.cat([flat, flat.new_zeros(pad)]) if pad else \
            flat.clone()
        words = words.view(torch.int32).to(_comm_device(buf))
        dist.all_reduce(words, group=group)
        flat = words.to(buf.device).view(torch.uint8)[:flat.numel()]
        return flat.view(buf.dtype).reshape(buf.shape)


def group_size(group=None) -> int:
    """Ranks in `group` (None: every rank)."""
    return dist.get_world_size(group) if world_size() > 1 else 1


def _gather(x: torch.Tensor, group=None) -> torch.Tensor:
    with _timed():
        rank, n = dist.get_rank(group), x.shape[0]
        src = x.detach()
        if src.dtype == torch.bool:
            src = src.to(torch.uint8)
        out = src.new_zeros((group_size(group) * n, *x.shape[1:]),
                            device=_comm_device(x))
        out[rank * n:(rank + 1) * n] = src
        dist.all_reduce(out, group=group)
        return out.to(x.device, x.dtype)


class _AllGather(torch.autograd.Function):
    """Concatenation of every rank's x of `group` along dim 0, in the
    group's rank order. The backward sums the gathered gradient over the
    group's ranks (each rank's loss reads every rank's rows) and keeps
    this rank's slice."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.n, ctx.group = x.shape[0], group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, grad):
        rank, n = dist.get_rank(ctx.group), ctx.n
        with collective("gather"):
            return all_reduce(grad.contiguous(), ctx.group)[
                rank * n:(rank + 1) * n], None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's x of `group` (None: every rank) concatenated along
    dim 0 in the group's rank order (x itself in a group of one).
    Differentiable when x requires grad: the gradient of this rank's rows
    is their gradient summed over every use by the group's ranks."""
    if group_size(group) == 1:
        return x
    with collective("gather"):
        if x.requires_grad and torch.is_grad_enabled():
            return _AllGather.apply(x, group)
        return _gather(x, group)


def gather_stack(x: torch.Tensor, group) -> torch.Tensor:
    """[group size, *x.shape]: every rank's x of `group` in its rank
    order, each with its own bits (sum_disjoint of zero-filled slots);
    without gradient."""
    if group_size(group) == 1:
        return x.detach()[None]
    buf = x.new_zeros((group_size(group), *x.shape))
    buf[dist.get_rank(group)] = x.detach()
    return sum_disjoint(buf, group)


def sum_in_order(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks of `group`, added in rank order after
    a gather of every rank's x: the same bits on every rank and in every
    run at the same group size (x itself in a group of one); without
    gradient."""
    if group_size(group) == 1:
        return x
    parts = gather_stack(x, group)
    out = parts[0]
    for part in parts[1:]:
        out = out + part
    return out


class _GroupSum(torch.autograd.Function):
    """sum_in_order with gradient: the gradient of each rank's x is the
    sum of the output's gradient over the group's ranks (every rank reads
    the sum), added in the same order, under the forward's label."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.kind = group, getattr(_LABEL, "kind", None)
        return sum_in_order(x, group)

    @staticmethod
    def backward(ctx, grad):
        with collective(ctx.kind):
            return sum_in_order(grad.contiguous(), ctx.group), None


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks of `group` in rank order
    (sum_in_order), differentiable when x requires grad."""
    if group_size(group) == 1:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _GroupSum.apply(x, group)
    return sum_in_order(x, group)


def gather_rows(x: torch.Tensor, mesh: Mesh, rows: int,
                dim: int = 1) -> torch.Tensor:
    """The rows along `dim` of every space rank of this rank's data rank,
    each its rows of a map `rows` high (parallel/halo.py::partition),
    joined in order (x itself at space 1); without gradient."""
    if mesh.space == 1:
        return x
    from spml_tpu_torch.parallel.halo import share

    mine = share(mesh, rows, x.shape[dim])
    shape = list(x.shape)
    shape[dim] = rows
    buf = x.new_zeros(shape)
    buf.narrow(dim, mine.start, len(mine)).copy_(x.detach())
    with collective("gather"):
        return sum_disjoint(buf, mesh.space_group())


def shard_rows(batch: dict, mesh: Mesh) -> dict:
    """A batch of this rank's images with the SPATIAL_KEYS leaves ([B, H,
    ...], ndim >= 3) cut to this rank's rows; the other leaves whole."""
    if mesh.space == 1:
        return batch
    return {k: (v[:, mesh.rows(v.shape[1])]
                if k in SPATIAL_KEYS and v.ndim >= 3 else v)
            for k, v in batch.items()}


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
        destroy_groups()


def spawn(fn, args, devices, backend: str | None = None,
          timeout: float | None = None) -> list:
    """fn(*args, device=devices[r]) in one spawned process per rank r,
    joined in a process group of `backend` (default_backend when None);
    returns each rank's result (pickled through a temporary file, so it
    should hold host tensors). fn must be importable by name. A rank that
    raises or dies ends the others and raises here. timeout: seconds
    until the ranks must have joined, else they are killed and
    TimeoutError raised (ranks that wait in a collective one of them
    never entered wait forever); None waits."""
    devices = [torch.device(d) for d in devices]
    backend = backend or default_backend(devices)
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, nprocs=len(devices), join=False,
            start_method="spawn",
            args=(fn, tuple(args), devices, backend, _free_port(), out_dir))
        deadline = None if timeout is None else time.monotonic() + timeout
        while not ctx.join(None if deadline is None
                           else max(deadline - time.monotonic(), 0.0)):
            if deadline is not None and time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(
                    f"{len(devices)} ranks of {fn.__name__} not joined "
                    f"after {timeout} s (a collective some rank never "
                    "entered?); killed")
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
            destroy_groups()
        return
    devices = rank_devices(device)
    if len(devices) == 1:
        fn(*args, device=devices[0])
    else:
        spawn(functools.partial(_no_result, fn), args, devices)

"""Training loop drivers of the train entry points.

Port of spml_tpu/train/driver.py (reference: pyscripts/train/train.py:
41-313 and train_classifier.py:54-189 in twke18/SPML): dataset and
loader from an image list on disk, models, resume or pretrained weights,
the loop around the train step, scalars and image panels every
tensorboard_step (vis.py:15-101), a checkpoint every snapshot_step and
at the last iteration.

Each rank of the process group (parallel/mesh.py; one process without
one) steps train.batch_size images of a global batch of train.batch_size
x ranks, as the JAX driver sizes its global batch by the device count
(spml_tpu/train/driver.py:131-137), and sets tpu.num_devices to the rank
count (a value given as neither 1 nor that count raises). Rank 0 alone
writes the checkpoints (then every rank waits at a barrier), the
TensorBoard scalars and images, the log lines and the profiler trace;
every rank reads the same checkpoint on resume. A checkpoint also holds
every rank's dropout generator state (utils/checkpoint.py). Batches
reach the card from pinned host memory. A resumed run starts at the
latest checkpoint's step (the schedule reads the restored state's step)
and restarts the loader's index stream from its beginning, as the JAX
package's does. The first logging interval reports its seconds as
warmup_secs: it holds the kernels' build at first use and cuDNN's
autotuning. tpu.profile_dir traces a window of steps with torch.profiler
(TraceWindow).

With tpu.spatial_partition S > 1 (the JAX package's ('data', 'space')
mesh, spml_tpu/train/driver.py:134-137) the ranks form W / S data ranks
of S space ranks each: the global batch is train.batch_size x the data
ranks, every space rank of a data rank loads that data rank's images
and keeps its rows of the image and label leaves (parallel/mesh.py::
shard_rows). The crop height must be a multiple of 8 x S. The image
panels' eval forward runs on every space rank of data rank 0, and rank
0 joins their rows.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from spml_tpu_torch.data import datasets as datasets_lib
from spml_tpu_torch.models.embeddings import build_embedding_model
from spml_tpu_torch.parallel import halo, mesh as mesh_lib
from spml_tpu_torch.train import classifier_step as cstep_lib
from spml_tpu_torch.train import step as step_lib
from spml_tpu_torch.utils import checkpoint as ckpt
from spml_tpu_torch.utils import torch_import, vis
from spml_tpu_torch.utils.device import resolve_device


def _writer(snapshot_dir):
    if mesh_lib.make_mesh().rank != 0:
        return None
    try:
        import tensorboardX
        return tensorboardX.SummaryWriter(logdir=snapshot_dir)
    except Exception:  # tensorboard logging is optional, as in JAX's
        return None


def _load_pretrained(config, state):
    """network.pretrained, a reference-format .pth (the CUHK ResNet names
    renamed), overlaid on the embedding model by the names and shapes it
    shares with it (reference train.py:124-126)."""
    path = config.network.pretrained
    if not path or not os.path.exists(path):
        if path:
            print(f"pretrained not found, training from scratch: {path}")
        return state
    skipped = torch_import.load_pretrained(
        state.emb_model, path, key="embedding_model", cuhk_names=True)
    print(f"loaded pretrained weights from {path} ({len(skipped)} entries "
          f"without a counterpart skipped: {skipped[:10]})")
    return state


def _closing(writer):
    """Closes the writer (its event-file thread) when the run ends."""
    return (contextlib.closing(writer) if writer is not None
            else contextlib.nullcontext())


def _log_metrics(writer, metrics, step, prefix=""):
    if mesh_lib.make_mesh().rank != 0:
        return
    line = " ".join(f"{k}={float(v):.4f}" for k, v in sorted(
        metrics.items()) if np.ndim(v) == 0)
    print(f"iter {step}: {line}", flush=True)
    if writer is not None:
        for k, v in metrics.items():
            if np.ndim(v) == 0:
                writer.add_scalar(prefix + k, float(v), step)


def _log_images(writer, config, emb_model, batch, step,
                mesh=mesh_lib.Mesh()):
    """Image panels: colorized semantic and instance labels and PCA-RGB
    embeddings in eval mode (reference train.py:222-258, vis.py:15-101).
    Height-sharded, every space rank of data rank 0 runs the forward on
    its rows (its halo exchanges need them all), writer or not, and the
    rows are joined."""
    if (writer is None if mesh.space == 1 else mesh.data_rank != 0):
        return
    height = config.train.crop_size[0]
    emb_model.eval()
    with torch.no_grad(), halo.sharded(mesh, height):
        emb, _ = emb_model(batch["image"][:2])
    emb_model.train()
    emb = mesh_lib.gather_rows(emb, mesh, emb_model.embedding_rows(height))
    sem, inst = (mesh_lib.gather_rows(t, mesh, height) for t in (
        batch["semantic_label"][:2], batch["instance_label"][:2]))
    if writer is None:
        return
    emb_rgb = vis.embedding_to_rgb(emb.float().cpu().numpy())
    cmap = vis.load_color_map(config.dataset.color_map_path)
    sem_rgb = vis.label_to_color(sem.cpu().numpy().astype(np.int32), cmap)
    inst_rgb = vis.label_to_color(
        inst.cpu().numpy().astype(np.int32) % 256, cmap)
    for i in range(emb_rgb.shape[0]):
        writer.add_image(f"embedding_pca/{i}", emb_rgb[i], step,
                         dataformats="HWC")
        writer.add_image(f"semantic_label/{i}", sem_rgb[i], step,
                         dataformats="HWC")
        writer.add_image(f"instance_label/{i}", inst_rgb[i], step,
                         dataformats="HWC")


def _to_train_batch(batch, config=None):
    """A loader batch as CPU tensors. tpu.compact_feed: labels and tags as
    uint8 (PNG 'L' labels; 255 is the ignore index) and, under bf16
    convolutions, the image as bf16, which the model casts it to on entry
    anyway: both casts are exact and quarter the bytes sent."""
    out = {"image": torch.from_numpy(batch["image"]),
           "semantic_label": torch.from_numpy(batch["semantic_label"]),
           "instance_label": torch.from_numpy(batch["instance_label"])}
    out["semantic_tag"] = torch.from_numpy(batch.get(
        "semantic_tag",
        np.zeros((batch["image"].shape[0], 256), np.int32)))
    if config is not None and config.tpu.compact_feed:
        for k in ("semantic_label", "instance_label", "semantic_tag"):
            out[k] = out[k].to(torch.uint8)
        if config.tpu.compute_dtype == "bfloat16":
            out["image"] = out["image"].to(torch.bfloat16)
    return out


def _to_device(batch, device: torch.device):
    """The tensors on `device`, copied from pinned memory to a card."""
    if device.type != "cuda":
        return {k: v.to(device) for k, v in batch.items()}
    return {k: v.pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}


def _loader(args, config, dataset_cls, mesh):
    """This rank's slice of the global batch's loader (its data rank's;
    the space ranks cut their rows with mesh_lib.shard_rows)."""
    dataset = dataset_cls(
        data_dir=args.data_dir or config.dataset.data_dir,
        data_list=args.data_list or config.dataset.train_data_list,
        img_mean=config.network.pixel_means,
        img_std=config.network.pixel_stds,
        size=tuple(config.train.crop_size),
        random_crop=config.train.random_crop,
        random_scale=config.train.random_scale,
        random_mirror=config.train.random_mirror, training=True,
        seed=config.train.seed)
    return iter(datasets_lib.Loader(
        dataset, config.train.batch_size * mesh.data,
        shuffle=config.train.shuffle, seed=config.train.seed,
        num_workers=config.num_threads,
        shard=(mesh.data_rank, mesh.data)))


def _next_batch(loader, config, mesh, device):
    """The loader's next batch, this rank's rows of it, on `device`."""
    return _to_device(_to_train_batch(
        mesh_lib.shard_rows(next(loader), mesh), config), device)


class TraceWindow:
    """A torch.profiler trace of tpu.profile_steps iterations from
    iteration start_iter + tpu.profile_start (relative to the run's first
    iteration, so a resumed run traces too) into tpu.profile_dir as a
    Chrome trace, steps_<first>-<end>.pt.trace.json; an empty profile_dir
    traces nothing (spml_tpu/train/driver.py::_TraceWindow). CPU and CUDA
    activity on a card, CPU alone on the CPU; the card is synchronized
    before the window opens (the steps before it stay out) and before it
    closes (its steps' kernels stay in). step(it) at the top of every
    iteration; close() (or leaving the with block) ends a window the run
    ends inside. In a process group rank 0 alone traces. The trace holds
    the program's spans (utils/spans.py): spml.train.step and its phases
    for each traced step."""

    def __init__(self, config, start_iter, device: torch.device):
        self.dir = (os.path.expanduser(config.tpu.profile_dir)
                    if mesh_lib.make_mesh().rank == 0 else "")
        self.begin = start_iter + config.tpu.profile_start
        self.end = self.begin + config.tpu.profile_steps
        self.device = device
        self.prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def step(self, it):
        if not self.dir or self.end <= self.begin:
            return
        if it == self.begin and self.prof is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._sync()
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
        elif it == self.end and self.prof is not None:
            self._sync()
            self.prof.stop()
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(
                self.dir, f"steps_{self.begin}-{self.end}.pt.trace.json")
            self.prof.export_chrome_trace(path)
            self.prof = None
            print(f"profiler trace written to {path}", flush=True)

    def close(self):
        if self.prof is not None:
            self.step(self.end)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _snapshot_due(config, it) -> bool:
    return ((it + 1) % config.train.snapshot_step == 0
            or it == config.train.max_iteration - 1)


def _save(ck_dir, step, state, mesh) -> None:
    """Rank 0 writes the checkpoint with every rank's generator state (a
    collective), then every rank waits for the file."""
    gens = mesh_lib.all_gather(state.generator.get_state()[None])
    if mesh.rank == 0:
        ckpt.save(ck_dir, step, state,
                  rank_generators=list(gens) if mesh.world > 1 else None)
    mesh_lib.barrier()


def _mesh(config):
    """The process group's mesh; tpu.num_devices set to its rank count.
    The ranks come from the launch (--device, torchrun): a num_devices
    given as neither the default 1 nor that count raises, and so does a
    count that tpu.spatial_partition does not divide or a crop height
    that it does not (halo.check_height)."""
    mesh = mesh_lib.make_mesh(config.tpu.spatial_partition)
    halo.check_height(config.train.crop_size[0], mesh.space)
    if config.tpu.num_devices not in (1, mesh.world):
        raise ValueError(
            f"tpu.num_devices {config.tpu.num_devices}, but the process "
            f"group has {mesh.world} rank(s): the ranks are those the "
            "launch starts (--device cuda: every visible card; cpu:N; "
            "torchrun)")
    config.tpu.num_devices = mesh.world
    return mesh


def train_spml(args, config, dataset_cls=datasets_lib.ListTagDataset,
               device="cuda"):
    """SPML contrastive training (reference train.py) on `device`; returns
    the final TrainState. args: data_dir, data_list, snapshot_dir
    (checkpoints go to snapshot_dir/checkpoints)."""
    device = resolve_device(device)
    mesh = _mesh(config)
    global_batch = config.train.batch_size * mesh.data
    loader = _loader(args, config, dataset_cls, mesh)
    state = step_lib.init_state(
        config, 235 + config.train.seed,
        torch.zeros(global_batch, *config.train.crop_size, 3), device)

    ck_dir = os.path.join(args.snapshot_dir, "checkpoints")
    start = config.train.begin_iteration
    if config.train.resume and ckpt.latest_step(ck_dir) is not None:
        start = ckpt.latest_step(ck_dir)
        state = ckpt.restore(ck_dir, state)
        if mesh.rank == 0:
            print(f"resumed from iteration {start}")
    else:
        state = _load_pretrained(config, state)

    train_step = step_lib.make_train_step(config)
    writer = _writer(args.snapshot_dir)
    t0 = time.time()
    with contextlib.closing(loader), _closing(writer), \
            TraceWindow(config, start, device) as trace:
        for it in range(start, config.train.max_iteration):
            trace.step(it)
            batch = _next_batch(loader, config, mesh, device)
            state, metrics = train_step(state, batch)
            if it % config.train.tensorboard_step == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                if it > start:
                    metrics["imgs_per_sec"] = (
                        global_batch * config.train.tensorboard_step / dt)
                else:
                    metrics["warmup_secs"] = dt
                _log_metrics(writer, metrics, it)
                _log_images(writer, config, state.emb_model, batch, it,
                            mesh)
                t0 = time.time()
            if _snapshot_due(config, it):
                _save(ck_dir, it + 1, state, mesh)
                if mesh.rank == 0:
                    print(f"snapshot at iteration {it + 1}")
    return state


def train_classifier(args, config,
                     dataset_cls=datasets_lib.ListTagClassifierDataset,
                     device="cuda"):
    """Stage-2 classifier training (reference train_classifier.py) over the
    frozen embedding of network.pretrained (checkpoint.load_embedding: a
    port snapshot directory, the stage-1 one, or a reference .pth);
    returns the final TrainState of the head."""
    device = resolve_device(device)
    mesh = _mesh(config)
    loader = _loader(args, config, dataset_cls, mesh)
    emb_model = build_embedding_model(
        config.network.backbone_types, config.network.embedding_dim,
        compute_dtype=step_lib._compute_dtype(config),
        bn_momentum=config.network.bn_momentum,
        generator=torch.Generator().manual_seed(0))
    ckpt.load_embedding(config, config.network.pretrained, emb_model)
    if mesh.rank == 0:
        print("loaded frozen embedding model from "
              f"{config.network.pretrained}")
    emb_model = emb_model.to(device, memory_format=torch.channels_last)

    state = cstep_lib.init_classifier_state(config, 235 + config.train.seed,
                                            device)
    ck_dir = os.path.join(args.snapshot_dir, "checkpoints")
    start = config.train.begin_iteration
    if config.train.resume and ckpt.latest_step(ck_dir) is not None:
        start = ckpt.latest_step(ck_dir)
        state = ckpt.restore(ck_dir, state)

    train_step = cstep_lib.make_classifier_train_step(config, emb_model)
    writer = _writer(args.snapshot_dir)
    with contextlib.closing(loader), _closing(writer), \
            TraceWindow(config, start, device) as trace:
        for it in range(start, config.train.max_iteration):
            trace.step(it)
            batch = _next_batch(loader, config, mesh, device)
            state, metrics = train_step(state, batch)
            if it % config.train.tensorboard_step == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                _log_metrics(writer, metrics, it, prefix="classifier/")
            if _snapshot_due(config, it):
                _save(ck_dir, it + 1, state, mesh)
    return state

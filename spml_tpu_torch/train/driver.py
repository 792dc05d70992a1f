"""Training loop drivers of the train entry points.

Port of spml_tpu/train/driver.py (reference: pyscripts/train/train.py:
41-313 and train_classifier.py:54-189 in twke18/SPML): dataset and
loader from an image list on disk, models, resume or pretrained weights,
the loop around the train step, scalars and image panels every
tensorboard_step (vis.py:15-101), a checkpoint every snapshot_step and
at the last iteration.

One card: the batch is train.batch_size. Batches reach the card from
pinned host memory. A resumed run starts at the latest checkpoint's step
(the schedule reads the restored state's step) and restarts the loader's
index stream from its beginning, as the JAX package's does. The first
logging interval reports its seconds as warmup_secs: it holds the
kernels' build at first use and cuDNN's autotuning.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from spml_tpu_torch.data import datasets as datasets_lib
from spml_tpu_torch.models.embeddings import build_embedding_model
from spml_tpu_torch.train import classifier_step as cstep_lib
from spml_tpu_torch.train import step as step_lib
from spml_tpu_torch.utils import checkpoint as ckpt
from spml_tpu_torch.utils import torch_import, vis
from spml_tpu_torch.utils.device import resolve_device


def _writer(snapshot_dir):
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


def _log_metrics(writer, metrics, step, prefix=""):
    line = " ".join(f"{k}={float(v):.4f}" for k, v in sorted(
        metrics.items()) if np.ndim(v) == 0)
    print(f"iter {step}: {line}", flush=True)
    if writer is not None:
        for k, v in metrics.items():
            if np.ndim(v) == 0:
                writer.add_scalar(prefix + k, float(v), step)


def _log_images(writer, config, emb_model, batch, step):
    """Image panels: colorized semantic and instance labels and PCA-RGB
    embeddings in eval mode (reference train.py:222-258, vis.py:15-101)."""
    if writer is None:
        return
    emb_model.eval()
    with torch.no_grad():
        emb, _ = emb_model(batch["image"][:2])
    emb_model.train()
    emb_rgb = vis.embedding_to_rgb(emb.float().cpu().numpy())
    cmap = vis.load_color_map(config.dataset.color_map_path)
    sem_rgb = vis.label_to_color(
        batch["semantic_label"][:2].cpu().numpy().astype(np.int32), cmap)
    inst_rgb = vis.label_to_color(
        batch["instance_label"][:2].cpu().numpy().astype(np.int32) % 256,
        cmap)
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


def _loader(args, config, dataset_cls):
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
        dataset, config.train.batch_size, shuffle=config.train.shuffle,
        seed=config.train.seed, num_workers=config.num_threads))


def _snapshot_due(config, it) -> bool:
    return ((it + 1) % config.train.snapshot_step == 0
            or it == config.train.max_iteration - 1)


def train_spml(args, config, dataset_cls=datasets_lib.ListTagDataset,
               device="cuda"):
    """SPML contrastive training (reference train.py) on `device`; returns
    the final TrainState. args: data_dir, data_list, snapshot_dir
    (checkpoints go to snapshot_dir/checkpoints)."""
    device = resolve_device(device)
    batch_size = config.train.batch_size
    loader = _loader(args, config, dataset_cls)
    state = step_lib.init_state(
        config, 235 + config.train.seed,
        torch.zeros(batch_size, *config.train.crop_size, 3), device)

    ck_dir = os.path.join(args.snapshot_dir, "checkpoints")
    start = config.train.begin_iteration
    if config.train.resume and ckpt.latest_step(ck_dir) is not None:
        start = ckpt.latest_step(ck_dir)
        state = ckpt.restore(ck_dir, state)
        print(f"resumed from iteration {start}")
    else:
        state = _load_pretrained(config, state)

    train_step = step_lib.make_train_step(config)
    writer = _writer(args.snapshot_dir)
    t0 = time.time()
    try:
        for it in range(start, config.train.max_iteration):
            batch = _to_device(_to_train_batch(next(loader), config),
                               device)
            state, metrics = train_step(state, batch)
            if it % config.train.tensorboard_step == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t0
                if it > start:
                    metrics["imgs_per_sec"] = (
                        batch_size * config.train.tensorboard_step / dt)
                else:
                    metrics["warmup_secs"] = dt
                _log_metrics(writer, metrics, it)
                _log_images(writer, config, state.emb_model, batch, it)
                t0 = time.time()
            if _snapshot_due(config, it):
                ckpt.save(ck_dir, it + 1, state)
                print(f"snapshot at iteration {it + 1}")
    finally:
        loader.close()
    return state


def train_classifier(args, config,
                     dataset_cls=datasets_lib.ListTagClassifierDataset,
                     device="cuda"):
    """Stage-2 classifier training (reference train_classifier.py) over the
    frozen embedding of network.pretrained (checkpoint.load_embedding: a
    port snapshot directory, the stage-1 one, or a reference .pth);
    returns the final TrainState of the head."""
    device = resolve_device(device)
    loader = _loader(args, config, dataset_cls)
    emb_model = build_embedding_model(
        config.network.backbone_types, config.network.embedding_dim,
        compute_dtype=step_lib._compute_dtype(config),
        bn_momentum=config.network.bn_momentum,
        generator=torch.Generator().manual_seed(0))
    ckpt.load_embedding(config, config.network.pretrained, emb_model)
    print(f"loaded frozen embedding model from {config.network.pretrained}")
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
    try:
        for it in range(start, config.train.max_iteration):
            batch = _to_device(_to_train_batch(next(loader), config),
                               device)
            state, metrics = train_step(state, batch)
            if it % config.train.tensorboard_step == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                _log_metrics(writer, metrics, it, prefix="classifier/")
            if _snapshot_due(config, it):
                ckpt.save(ck_dir, it + 1, state)
    finally:
        loader.close()
    return state

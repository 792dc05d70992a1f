"""Stage-2 softmax-classifier training step over a frozen embedding model.

Port of spml_tpu/train/classifier_step.py (reference in twke18/SPML:
pyscripts/train/train_classifier.py:54-189 and
spml/models/predictions/softmax_classifier.py:15-117): the embedding
model runs in eval mode (frozen weights and frozen BN statistics) under
no_grad, its output L2-normalized in float32; a classifier head (conv3x3
-> BN -> ReLU -> Dropout .65 -> conv1x1) is trained with cross-entropy
on the logits upsampled to the input, by SGD with the head's groups (x10
weights, x20 biases without weight decay).

Data parallel (parallel/mesh.py): each rank steps its slice of the global
batch. The frozen embedding runs in eval mode, so nothing of it is
synchronized; the head's batch norm takes the global batch's statistics,
the cross-entropy is the one masked mean of the global batch (the
all-reduced sum over the all-reduced count, as the JAX step's single
mean, spml_tpu/train/classifier_step.py:75) and the head's gradients are
summed over the ranks.

Height-sharded (tpu.spatial_partition > 1, parallel/halo.py): each rank
holds its rows of its data rank's images. The frozen embedding (eval
mode: no batch-norm collective; a PSPNet's pools summed over the space
group without gradient) and the head exchange halo rows on every rank,
the logits are resized to the rank's rows of the full-resolution grid,
and the cross-entropy is the same global masked mean.
"""

from __future__ import annotations

import dataclasses

import torch

from spml_tpu_torch.models.embeddings import build_classifier_head
from spml_tpu_torch.ops import common
from spml_tpu_torch.parallel import halo, mesh as mesh_lib
from spml_tpu_torch.train import optim
from spml_tpu_torch.train.state import TrainState
from spml_tpu_torch.train.step import (_accuracy, _compute_dtype,
                                       _cross_entropy, _sum_gradients)
from spml_tpu_torch.utils.device import resolve_device

DROPOUT = 0.65


def build_classifier(config, device="cuda", generator=None):
    """The stage-2 head (hidden 2 * embedding_dim, dropout 0.65) on
    `device`, weights drawn from `generator` (seed train.seed when
    None)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(config.train.seed)
    head = build_classifier_head(
        config.dataset.num_classes, config.network.embedding_dim,
        dropout_rate=DROPOUT, compute_dtype=_compute_dtype(config),
        generator=generator)
    return head.to(device, memory_format=torch.channels_last)


def init_classifier_state(config, seed: int, device="cuda") -> TrainState:
    """The head, its SGD buffers and its dropout generator (seeded seed +
    the world rank); no embedding model and no memory bank."""
    device = resolve_device(device)
    head = build_classifier(config, device,
                            torch.Generator().manual_seed(seed))
    return TrainState(step=0, emb_model=None, cls_model=head, momentum={},
                      memory=None,
                      generator=torch.Generator(device).manual_seed(
                          seed + mesh_lib.make_mesh().rank))


def make_classifier_train_step(config, emb_model):
    """Returns train_step(state, batch) -> (state, metrics) over
    `emb_model`, which is frozen here: eval mode (its BN statistics do not
    move) and every parameter out of autograd. batch as make_train_step's.
    The head and its momentum buffers are updated in place."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emb_model.eval()
    for p in emb_model.parameters():
        p.requires_grad_(False)
    C = config.dataset.num_classes
    tcfg = config.train
    schedule = optim.make_schedule(tcfg)
    mesh = mesh_lib.make_mesh(config.tpu.spatial_partition)
    world = mesh.world
    crop = config.train.crop_size[0]
    halo.check_height(crop, mesh.space)

    def train_step(state: TrainState, batch):
        images = batch["image"]
        labels = batch["semantic_label"].long()
        # the global rows of the images and of the embeddings
        height = crop if mesh.space > 1 else images.shape[1]
        with halo.sharded(mesh, height):
            with torch.no_grad():
                emb, _ = emb_model(images)
                emb = common.normalize_embedding(emb.float())
            rows = emb_model.embedding_rows(height)
            state.cls_model.train()
            logits = state.cls_model(emb, state.generator, rows)
            logits_up = halo.resize_bilinear(
                logits, (height, images.shape[2]), rows)
        ce = _cross_entropy(logits_up, labels, C, mesh=mesh)
        params = [("prediction." + n, p)
                  for n, p in state.cls_model.named_parameters()]
        for _, p in params:
            p.grad = None
        ce.backward()
        if world > 1:
            _sum_gradients(params)
        lr = schedule(state.step)
        optim.sgd_step(params, state.momentum, lr, tcfg.weight_decay,
                       tcfg.momentum)
        with mesh_lib.collective("other"):
            loss = mesh_lib.all_reduce(ce.detach())
        return dataclasses.replace(state, step=state.step + 1), {
            "loss": loss,
            "accuracy": _accuracy(logits_up.detach(), labels, C),
            "learning_rate": lr}

    return train_step

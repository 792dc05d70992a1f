"""The SPML train step.

Port of the segsort branch of spml_tpu/train/step.py (behavioral
reference in twke18/SPML: pyscripts/train/train.py:154-293 plus
spml/models/predictions/segsort_softmax.py:103-242 and, for DensePose,
segsort_softmax_densepose.py): embedding forward -> per-image vMF k-means
(no gradient through the assignments) -> prototypes joined with the
memory bank -> CE + SegSort sem_ann, SetSegSort sem_occ (with
tpu.use_fused_loss one fused sweep through the CUDA kernels of
ops/segsort_loss.py: the joint kernels with both losses on, the
hard-label kernels with sem_ann alone, the tag-set kernels with sem_occ
alone; else the dense losses), per-image
img_sim and, DensePose with tpu.apply_feat_aff, the dense feat_aff set
loss -> backward -> SGD -> memory-bank push.

DensePose (backbone_types containing "densepose"): local features are
[y, x, r, g, b]; the embeddings are scaled by 0.1 before joining them;
img_sim uses the plain embeddings; tags are propagated from the nearest
labelled prototype of the same image.

Loss reduction: tpu.loss_reduction='per_device_mean' groups the batch
into train.batch_size-image groups and means each group's pixels, then
the groups (the reference's per-GPU mean, train.py:211-219).

With sem_ann off (the VOC image-tag recipe's "tags only" arm), the
sem_ann metric is the classifier head's cross-entropy alone.

network.prediction_types 'softmax_classifier' is the fully supervised
baseline (spml_tpu/train/step.py:192-222; softmax_classifier.py:50-90):
the classifier head's cross-entropy on the L2-normalized embeddings
trains the backbone end to end (nothing detached), with no k-means, no
SegSort loss and no memory-bank push.

The update is train.optimizer's: SGD or the reference's Adam
(train/optim.py).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from spml_tpu_torch.models.embeddings import (build_classifier_head,
                                              build_embedding_model)
from spml_tpu_torch.models.spp import resize_bilinear
from spml_tpu_torch.ops import common, kmeans, knn, losses
from spml_tpu_torch.ops.segsort_loss import (fused_joint_losses,
                                             fused_segsort_loss,
                                             fused_set_segsort_loss)
from spml_tpu_torch.train import optim
from spml_tpu_torch.train.state import MemoryBank, TrainState
from spml_tpu_torch.utils.device import resolve_device



def loc_feature_dim(config) -> int:
    """Local feature channels: [y, x, r, g, b] for DensePose, else
    [y, x]."""
    return 5 if "densepose" in config.network.backbone_types else 2


def _compute_dtype(config) -> torch.dtype:
    return (torch.bfloat16 if config.tpu.compute_dtype == "bfloat16"
            else torch.float32)


def build_models(config, device="cuda", generator=None):
    """(embedding model, classifier head) on `device`, weights drawn from
    `generator` (seeded with train.seed when None)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(config.train.seed)
    dtype = _compute_dtype(config)
    emb_model = build_embedding_model(
        config.network.backbone_types, config.network.embedding_dim,
        compute_dtype=dtype, bn_momentum=config.network.bn_momentum,
        generator=generator)
    cls_model = build_classifier_head(
        config.dataset.num_classes, config.network.embedding_dim,
        dropout_rate=0.75, compute_dtype=dtype, generator=generator)
    fmt = torch.channels_last
    return (emb_model.to(device, memory_format=fmt),
            cls_model.to(device, memory_format=fmt))


def init_state(config, seed: int, sample_image, device="cuda") -> TrainState:
    """Models, optimizer state and memory bank.

    sample_image: [B_global, H, W, 3]; only its batch size is read. The
    frozen groups (stem, res2) get requires_grad=False: their update is
    zero either way, and the backward pass then stops at res3.
    """
    device = resolve_device(device)
    emb_model, cls_model = build_models(
        config, device, torch.Generator().manual_seed(seed))
    for name, p in emb_model.named_parameters():
        if optim.label_param(name) == optim.FROZEN:
            p.requires_grad_(False)
    memory = MemoryBank.create(
        max(config.train.memory_bank_size, 1),
        sample_image.shape[0] * config.tpu.segment_capacity,
        config.network.embedding_dim, loc_feature_dim(config),
        config.tpu.tag_width, device)
    return TrainState(step=0, emb_model=emb_model, cls_model=cls_model,
                      momentum={}, memory=memory,
                      generator=torch.Generator(device).manual_seed(seed))


def _grouped_masked_mean(values, mask, n_groups=1):
    """Mean over each group's masked entries, then over non-empty groups
    (n_groups=1: plain masked mean)."""
    v = values.reshape(n_groups, -1).float()
    m = mask.reshape(n_groups, -1).float()
    gsum = torch.sum(v * m, dim=1)
    gcnt = torch.sum(m, dim=1)
    gmean = gsum / torch.clamp(gcnt, min=1.0)
    has = (gcnt > 0).float()
    return torch.sum(gmean * has) / torch.clamp(torch.sum(has), min=1.0)


def _cross_entropy(logits, labels, num_classes, n_groups=1):
    """Softmax CE over pixels with labels < num_classes."""
    valid = labels < num_classes
    safe = torch.where(valid, labels, 0)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return _grouped_masked_mean(nll, valid, n_groups)


def _accuracy(logits, labels, num_classes):
    """Share of the pixels with labels < num_classes whose argmax is their
    label."""
    valid = labels < num_classes
    hit = (torch.argmax(logits, dim=-1) == labels) & valid
    return hit.sum() / torch.clamp(valid.sum(), min=1)


def _named_params(state: TrainState):
    yield from (("embedding." + n, p)
                for n, p in state.emb_model.named_parameters())
    yield from (("prediction." + n, p)
                for n, p in state.cls_model.named_parameters())


def make_train_step(config):
    """Returns train_step(state, batch) -> (state, metrics).

    batch: image [B, H, W, 3] float, semantic_label / instance_label
    [B, H, W] integer (uint8 widens here), semantic_tag [B, tag_width],
    all on the state's device. The models and the optimizer's buffers
    are updated in place.

    Sets torch.backends.{cuda.matmul,cudnn}.allow_tf32 = False: the
    k-means E-step, the top-5 ranking and the dense losses stay full
    float32, because exp(kappa * x) amplifies logit error.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if config.tpu.loss_operand_dtype not in ("", "float32"):
        raise NotImplementedError(
            f"tpu.loss_operand_dtype {config.tpu.loss_operand_dtype!r}: the "
            "fused loss kernels take float32 operands only")
    C = config.dataset.num_classes
    P = config.tpu.segment_capacity
    ignore = config.dataset.semantic_ignore_index
    n_clusters = tuple(config.network.kmeans_num_clusters)
    km_iters = config.network.kmeans_iterations
    mem_size = config.train.memory_bank_size
    tcfg = config.train
    use_sem_ann = tcfg.sem_ann_loss_types != "none"
    use_sem_occ = tcfg.sem_occ_loss_types != "none"
    use_img_sim = tcfg.img_sim_loss_types != "none"
    # feat_aff: constructed but never called by the reference
    # (segsort_softmax_densepose.py:64-68 vs :195-254); tpu.apply_feat_aff
    # adds it (the JAX package's paper-semantics term)
    use_feat_aff = (tcfg.feat_aff_loss_types != "none"
                    and config.tpu.apply_feat_aff)
    densepose = "densepose" in config.network.backbone_types
    fused = config.tpu.use_fused_loss
    softmax = config.network.prediction_types == "softmax_classifier"
    schedule = optim.make_schedule(tcfg)
    update = optim.build_optimizer(tcfg)

    def _n_groups(b):
        bs = tcfg.batch_size
        if (config.tpu.loss_reduction != "per_device_mean"
                or bs <= 0 or b % bs != 0):
            return 1
        return b // bs

    def forward_and_losses(state: TrainState, batch, compute_metrics):
        """Total loss and (metrics, current prototypes) for one batch.
        Runs the models in their current mode (train_step sets train)."""
        images = batch["image"]
        sem_full = batch["semantic_label"].long()
        inst_full = batch["instance_label"].long()
        tags = batch["semantic_tag"].long()
        B = images.shape[0]
        dev = images.device

        emb, loc = state.emb_model(images)
        if softmax:
            # the fully supervised baseline: CE through the backbone
            logits = state.cls_model(
                common.normalize_embedding(emb.float()), state.generator)
            logits_up = resize_bilinear(logits, images.shape[1:3])
            ce = _cross_entropy(logits_up, sem_full, C, _n_groups(B))
            return ce, ({"sem_ann_loss": ce,
                         "accuracy": _accuracy(logits_up, sem_full, C)},
                        None)
        h, w, D = emb.shape[1], emb.shape[2], emb.shape[3]
        N = h * w
        sem = common.resize_labels(sem_full, (h, w))
        inst = common.resize_labels(inst_full, (h, w))

        # ---- clustering (no gradient through assignments) ----
        with torch.no_grad():
            segs, _, _ = kmeans.segment_batch(
                emb.detach(), loc, sem, inst, n_clusters, P, km_iters,
                ignore, label_cap=config.tpu.label_cap)

        # ---- differentiable pixel embeddings & prototypes ----
        emb_flat = common.normalize_embedding(emb.float()).reshape(B, N, D)
        # DensePose squeezes the embedding's weight against the local
        # features (resnet_pspnet_densepose.py:141-154)
        emb_part = emb_flat * 0.1 if densepose else emb_flat
        emb_loc = common.normalize_embedding(
            torch.cat([emb_part, loc.reshape(B, N, -1).float()], dim=-1))
        weights = segs.pixel_valid.float()
        protos = kmeans.calculate_prototypes_from_labels(
            emb_flat, segs.pixel_segment_ids, P, weights)
        protos_loc = kmeans.calculate_prototypes_from_labels(
            emb_loc, segs.pixel_segment_ids, P, weights)

        img_idx = torch.arange(B, device=dev)
        proto_sem = segs.segment_semantic.reshape(-1)
        proto_valid = segs.segment_valid.reshape(-1)
        proto_tag = tags.repeat_interleave(P, dim=0)
        proto_batch = img_idx.repeat_interleave(P)
        cur = dict(prototype=protos.reshape(B * P, D),
                   prototype_with_loc=protos_loc.reshape(B * P, -1),
                   semantic_label=proto_sem,
                   instance_label=segs.segment_instance.reshape(-1),
                   batch_index=proto_batch, tag=proto_tag,
                   valid=proto_valid)

        # ---- join the memory bank (snapshots without gradient) ----
        memory = state.memory
        if mem_size > 0:
            all_protos = torch.cat(
                [cur["prototype"], memory.prototype.reshape(-1, D)])
            all_sem = torch.cat(
                [proto_sem, memory.semantic_label.reshape(-1)])
            all_valid = torch.cat([proto_valid, memory.valid.reshape(-1)])
            all_tag = torch.cat(
                [proto_tag, memory.tag.reshape(-1, memory.tag.shape[-1])])
        else:
            all_protos, all_sem = cur["prototype"], proto_sem
            all_valid, all_tag = proto_valid, proto_tag

        pix_sem = sem.reshape(-1)
        pix_own = (segs.pixel_segment_ids + img_idx[:, None] * P).reshape(-1)
        pix_valid = segs.pixel_valid.reshape(-1)
        metrics = {}

        # ---- semantic annotation: CE on the detached embeddings ----
        cls_in = common.normalize_embedding(emb.float()).detach()
        logits = state.cls_model(cls_in, state.generator)
        logits_up = resize_bilinear(logits, images.shape[1:3])
        ce = _cross_entropy(logits_up, sem_full, C, _n_groups(B))

        # ---- semantic co-occurrence tags ----
        # VOC: the dataset-level tags (segsort_softmax.py:146-151).
        # DensePose: each prototype's tags come from its nearest labelled
        # prototype of the same image over prototype_with_loc
        # (segsort_softmax_densepose.py:174-193; top-1, threshold 0.95);
        # prototypes without one get all ones (unconstrained).
        if densepose and (use_sem_occ or use_feat_aff):
            if mem_size > 0:
                all_ploc = torch.cat([
                    cur["prototype_with_loc"],
                    memory.prototype_with_loc.reshape(
                        -1, cur["prototype_with_loc"].shape[-1])])
                all_pbatch = torch.cat(
                    [proto_batch, memory.batch_index.reshape(-1)])
            else:
                all_ploc, all_pbatch = cur["prototype_with_loc"], proto_batch
            with torch.no_grad():
                nn_tags = knn.nearest_neighbor_multiset_labels(
                    all_ploc, all_ploc, all_sem, all_pbatch, all_pbatch, C,
                    top_k=1, threshold=0.95, prototype_mask=all_valid)
                tagless = nn_tags.amax(dim=1, keepdim=True) == 0
                occ_proto_tags = torch.where(tagless, 1, nn_tags)
            occ_pix_tags = occ_proto_tags[pix_own]
        else:
            occ_proto_tags = all_tag[:, 1:C]
            occ_pix_tags = tags[:, 1:C].repeat_interleave(N, dim=0)

        # ---- sem_ann (SegSort) and sem_occ (SetSegSort) ----
        ann_pix_mask = pix_valid & (pix_sem < C)
        ann_proto_mask = all_valid & (all_sem < C)
        emb_rows = emb_flat.reshape(-1, D)
        ann = occ = None
        if fused and use_sem_ann and use_sem_occ:
            ann_ll, occ_ll = fused_joint_losses(
                emb_rows, pix_sem, pix_own, occ_pix_tags, all_protos,
                torch.where(ann_proto_mask, all_sem, -1), occ_proto_tags,
                tcfg.sem_ann_concentration, tcfg.sem_occ_concentration,
                ann_pix_mask, pix_valid, all_valid, reduction="none")
            ann = _grouped_masked_mean(ann_ll, ann_pix_mask, _n_groups(B))
            occ = _grouped_masked_mean(occ_ll, pix_valid, _n_groups(B))
        else:
            if use_sem_ann:
                # the hard-label kernels or the dense loss: one signature
                ann_loss = fused_segsort_loss if fused else \
                    losses.segsort_loss
                ann_ll = ann_loss(
                    emb_rows, pix_sem, pix_own, all_protos, all_sem,
                    tcfg.sem_ann_concentration, ann_pix_mask,
                    ann_proto_mask, reduction="none")
                ann = _grouped_masked_mean(ann_ll, ann_pix_mask,
                                           _n_groups(B))
            if use_sem_occ:
                # the tag-set kernels or the dense loss: one signature
                occ_loss = fused_set_segsort_loss if fused else \
                    losses.set_segsort_loss
                occ_ll = occ_loss(
                    emb_rows, occ_pix_tags, pix_own, all_protos,
                    occ_proto_tags, tcfg.sem_occ_concentration, pix_valid,
                    all_valid, reduction="none")
                occ = _grouped_masked_mean(occ_ll, pix_valid, _n_groups(B))

        sem_ann = (ce + ann) * tcfg.sem_ann_loss_weight \
            if ann is not None else ce
        metrics["sem_ann_loss"] = sem_ann
        total = sem_ann
        if occ is not None:
            occ = occ * tcfg.sem_occ_loss_weight
            metrics["sem_occ_loss"] = occ
            total = total + occ

        # ---- low-level image similarity (per image) ----
        # emb ++ location for VOC (segsort_softmax.py:222), the plain
        # embeddings for DensePose (segsort_softmax_densepose.py:236)
        if use_img_sim:
            per_img = losses.segsort_loss(
                emb_flat if densepose else emb_loc, inst.reshape(B, N),
                segs.pixel_segment_ids, protos if densepose else protos_loc,
                segs.segment_instance,
                tcfg.img_sim_concentration, segs.pixel_valid,
                segs.segment_valid)
            img_sim = _grouped_masked_mean(
                per_img, segs.pixel_valid.any(dim=-1), _n_groups(B))
            img_sim = img_sim * tcfg.img_sim_loss_weight
            metrics["img_sim_loss"] = img_sim
            total = total + img_sim

        # ---- feature affinity (DensePose, tpu.apply_feat_aff) ----
        if use_feat_aff and densepose:
            aff_ll = losses.set_segsort_loss(
                emb_rows, occ_pix_tags, pix_own, all_protos, occ_proto_tags,
                tcfg.feat_aff_concentration, pix_valid, all_valid,
                reduction="none")
            aff = _grouped_masked_mean(aff_ll, pix_valid, _n_groups(B))
            aff = aff * tcfg.feat_aff_loss_weight
            metrics["feat_aff_loss"] = aff
            total = total + aff

        # ---- top-5 prototype retrieval accuracy (logged steps only) ----
        if compute_metrics:
            with torch.no_grad():
                acc = knn.top_k_ranking(all_protos, all_sem, all_protos,
                                        all_sem, 5, all_valid, all_valid)[0]
        else:
            acc = torch.zeros((), device=dev)
        metrics["accuracy"] = acc
        metrics["num_segments"] = proto_valid.sum()
        return total, (metrics, cur)

    def train_step(state: TrainState, batch):
        state.emb_model.train()
        state.cls_model.train()
        compute = (not config.tpu.lazy_metrics
                   or state.step % tcfg.tensorboard_step == 0)
        total, (metrics, cur) = forward_and_losses(state, batch, compute)
        params = list(_named_params(state))
        for _, p in params:
            p.grad = None
        total.backward()
        lr = schedule(state.step)
        state = update(params, state, lr)
        memory = state.memory if softmax else state.memory.push(
            cur["prototype"].detach(), cur["prototype_with_loc"].detach(),
            cur["semantic_label"], cur["instance_label"],
            cur["batch_index"], cur["tag"], cur["valid"],
            batch["image"].shape[0])
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = total.detach()
        metrics["learning_rate"] = lr
        return dataclasses.replace(state, step=state.step + 1,
                                   memory=memory), metrics

    return train_step

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

Data parallel (parallel/mesh.py), the JAX step sharded over a 'data'
mesh: in a process group of W ranks each rank steps its b images of the
global batch of W * b (rank r: images r * b .. (r + 1) * b - 1). The
prototypes, their labels, tags, validity and global batch indices are
gathered from every rank (the prototypes with gradient, which the
gather's backward returns to their owner); each rank's own segment ids
point into the gathered list; the memory bank pushes the gathered
prototypes and stays replicated. Each loss mean runs over the groups of
the global batch: a rank's share of a group mean is scaled by the
all-reduced count of non-empty groups (a single group, by the
all-reduced count of its entries), so the shares sum to the JAX step's
loss, and the parameter gradients are summed over the ranks. Batch-norm
statistics are the global batch's (models/resnet.py::BatchNorm2d). The
logged losses and accuracy are the global values. The dropout generator
of rank r is seeded seed + r: the JAX step's one dropout stream over the
global batch cannot be matched. At world size 1 nothing of this runs.

Height-sharded (tpu.spatial_partition S > 1, the JAX step on a ('data',
'space') mesh; parallel/halo.py), the DeepLab backbones: each rank steps
its data rank's b images of the global batch of D * b (D = W / S data
ranks), its rows of them (the image and labels cut by
parallel/mesh.py::shard_rows). The forwards of the embedding network and
the classifier head run under halo.sharded(): the networks exchange halo
rows, the logits are resized to the rank's rows of the full-resolution
grid. Every map has its own partition over the space ranks
(parallel/halo.py::partition: equal blocks where S divides its height),
and each operation is told its input's global height, from the crop
height down (the embeddings' is EmbeddingModel.embedding_rows). The
loss groups are those of the global batch of D * b images; a group's
pixel count is all-reduced over the space ranks that hold its
images' rows, and each rank's share of a group mean is its masked sum
over that count. The SegSort branch: the labels are resized to the
rank's rows of the embedding grid from global coordinates; k-means runs
over the space group (ops/kmeans.py::segment_batch); each prototype is
its segment's sums over the rank's pixels added over the space group
with gradient (parallel/mesh.py::group_sum), then normalized; the
prototypes are gathered over the data group (each data rank's once) and
the losses (K1-K9 or the dense ones) read the rank's pixel rows against
them and the bank; img_sim's per-image mean is the sum over the rank's
pixels over the image's count over the space group, and each image
counts once in the mean over images. The PSPNet backbones (PSPP's
pools summed over the space group, models/spp.py) and DensePose run so
too: the colour features are made from the gathered whole images
(models/local.py), the NN-propagated tags read the gathered, complete
prototypes, and feat_aff and the hard-label loss read the rank's pixel
rows with their means counted over the space group. A crop height that
S does not divide raises (halo.check_height); a deeper map may leave a
rank no row (crop 24 over 4: the stride-8 map's 3 rows as none, 1, 1,
1; crop 8 over 4: ranks 0 and 2 hold no pixel of the embeddings, N =
0), and such a rank runs every collective of the step with the others.
Ranks:
the loss groups and the global image indices are the data rank's; the
dropout generator, the world rank's (init_state).

float64 models and images (the parity checks' runs) keep the step in
float64 with the dense losses.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from spml_tpu_torch.models.embeddings import (build_classifier_head,
                                              build_embedding_model)
from spml_tpu_torch.ops import common, kmeans, knn, losses
from spml_tpu_torch.ops.segsort_loss import (OPERAND_DTYPES,
                                             fused_joint_losses,
                                             fused_segsort_loss,
                                             fused_set_segsort_loss)
from spml_tpu_torch.parallel import halo, mesh as mesh_lib
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


def backbone_remat(config):
    """tpu.remat_stages as a (res2, res3, res4, res5) tuple when it names
    any stage, else tpu.remat_backbone (spml_tpu/train/step.py:50-53)."""
    stages = tuple(config.tpu.remat_stages)
    if stages:
        return tuple(i in stages for i in (2, 3, 4, 5))
    return config.tpu.remat_backbone


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
        generator=generator, remat=backbone_remat(config))
    cls_model = build_classifier_head(
        config.dataset.num_classes, config.network.embedding_dim,
        dropout_rate=0.75, compute_dtype=dtype, generator=generator)
    fmt = torch.channels_last
    return (emb_model.to(device, memory_format=fmt),
            cls_model.to(device, memory_format=fmt))


def init_state(config, seed: int, sample_image, device="cuda") -> TrainState:
    """Models, optimizer state and memory bank.

    sample_image: [B_global, H, W, 3]; only its batch size is read (the
    global batch of every rank: the bank holds every rank's prototypes).
    The frozen groups (stem, res2) get requires_grad=False: their update
    is zero either way, and the backward pass then stops at res3. The
    dropout generator is seeded seed + the world rank (0 without a
    process group): under spatial partitioning the space ranks of an
    image draw its rows' masks from their own streams.
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
                      generator=torch.Generator(device).manual_seed(
                          seed + mesh_lib.make_mesh().rank))


def _grouped_masked_mean(values, mask, n_groups=1, mesh=mesh_lib.Mesh(),
                         per_image=False):
    """Mean over each group's masked entries, then over non-empty groups
    (n_groups=1: plain masked mean). n_groups counts the groups of the
    global batch; with mesh.world > 1 ranks, values and mask are this
    rank's share and the result is its share of the global mean: with
    whole groups a data rank (n_groups a multiple of mesh.data), its
    masked sum of each group over the group's count (all-reduced over
    the space ranks holding the group's rows), over the all-reduced
    count of non-empty groups of the data ranks; with one group, its
    masked sum over the all-reduced count. per_image: an entry is an
    image's, its mask the same on each of the image's space ranks and
    its value the sum of their shares: each image counts once (no count
    is summed over the space group)."""
    with mesh_lib.collective("other"):
        if mesh.world > 1 and n_groups == 1:
            m = mask.reshape(-1).float()
            count = mesh_lib.all_reduce(
                m.sum(), mesh.data_group() if per_image else None)
            v = common.at_least_float32(values.reshape(-1))
            return (v * m).sum() / torch.clamp(count, min=1.0)
        if n_groups % mesh.data:
            raise ValueError(f"{n_groups} loss groups do not split over "
                             f"{mesh.data} ranks")
        # [groups, entries]: a rank may hold no entries (no rows)
        shape = (n_groups // mesh.data, values.numel() * mesh.data // n_groups)
        v = common.at_least_float32(values.reshape(shape))
        m = mask.reshape(shape).float()
        gsum = torch.sum(v * m, dim=1)
        gcnt = mesh_lib.all_reduce(torch.sum(m, dim=1), mesh.space_group()) \
            if mesh.space > 1 and not per_image else torch.sum(m, dim=1)
        share = gsum / torch.clamp(gcnt, min=1.0)  # the group mean's
        has = (gcnt > 0).float()
        groups = mesh_lib.all_reduce(torch.sum(has), mesh.data_group())
        return torch.sum(share * has) / torch.clamp(groups, min=1.0)


def _cross_entropy(logits, labels, num_classes, n_groups=1,
                   mesh=mesh_lib.Mesh()):
    """Softmax CE over pixels with labels < num_classes."""
    valid = labels < num_classes
    safe = torch.where(valid, labels, 0)
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return _grouped_masked_mean(nll, valid, n_groups, mesh)


def _accuracy(logits, labels, num_classes):
    """Share of the pixels with labels < num_classes whose argmax is their
    label, over every rank's pixels."""
    valid = labels < num_classes
    hit = (torch.argmax(logits, dim=-1) == labels) & valid
    with mesh_lib.collective("other"):
        counts = mesh_lib.all_reduce(torch.stack([hit.sum(), valid.sum()]))
    return counts[0] / torch.clamp(counts[1], min=1)


def _sum_gradients(params) -> None:
    """Every parameter gradient summed over the ranks, through one flat
    all-reduce (a parameter without a gradient adds zeros)."""
    live = [p for _, p in params if p.requires_grad]
    with mesh_lib.collective("gradient"):
        flat = mesh_lib.all_reduce(torch.cat([
            (p.grad if p.grad is not None else torch.zeros_like(p))
            .reshape(-1) for p in live]))
    for p, g in zip(live, flat.split([p.numel() for p in live])):
        p.grad = g.view_as(p)


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

    # the fused losses' operand type (spml_tpu/train/step.py:154); a name
    # the kernels have no form for raises here, where JAX would read it as
    # float32, so that a typo is not a silent float32 run
    operand_dtype = config.tpu.loss_operand_dtype or "float32"
    if operand_dtype not in OPERAND_DTYPES:
        raise ValueError(
            f"tpu.loss_operand_dtype {config.tpu.loss_operand_dtype!r}: the "
            f"fused loss kernels take {sorted(OPERAND_DTYPES)}")
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
    mesh = mesh_lib.make_mesh(config.tpu.spatial_partition)
    world = mesh.world
    crop = config.train.crop_size[0]
    halo.check_height(crop, mesh.space)
    wide = common.at_least_float32

    def _n_groups(b):
        """Loss groups of the global batch of a rank's b images."""
        b, bs = b * mesh.data, tcfg.batch_size
        if (config.tpu.loss_reduction != "per_device_mean"
                or bs <= 0 or b % bs != 0):
            return 1
        return b // bs

    def mean(values, mask, b):
        return _grouped_masked_mean(values, mask, _n_groups(b), mesh)

    def forward_and_losses(state: TrainState, batch, compute_metrics):
        """Total loss and (metrics, current prototypes) for one batch.
        Runs the models in their current mode (train_step sets train)."""
        images = batch["image"]
        sem_full = batch["semantic_label"].long()
        inst_full = batch["instance_label"].long()
        tags = batch["semantic_tag"].long()
        B = images.shape[0]
        dev = images.device
        # the global rows of the images and of the embeddings
        height = crop if mesh.space > 1 else images.shape[1]
        rows = state.emb_model.embedding_rows(height)
        full = (height, images.shape[2])

        if softmax:
            # the fully supervised baseline: CE through the backbone
            with halo.sharded(mesh, height):
                emb, _ = state.emb_model(images)
                logits = state.cls_model(
                    common.normalize_embedding(wide(emb)), state.generator,
                    rows)
                logits_up = halo.resize_bilinear(logits, full, rows)
            ce = _cross_entropy(logits_up, sem_full, C, _n_groups(B), mesh)
            return ce, ({"sem_ann_loss": ce,
                         "accuracy": _accuracy(logits_up, sem_full, C)},
                        None)
        with halo.sharded(mesh, height):
            emb, loc = state.emb_model(images)
            h, w, D = emb.shape[1], emb.shape[2], emb.shape[3]
            sem = common.resize_labels(sem_full, (rows, w), height)
            inst = common.resize_labels(inst_full, (rows, w), height)
        N = h * w

        # ---- clustering (no gradient through assignments) ----
        with torch.no_grad():
            segs, _, _ = kmeans.segment_batch(
                emb.detach(), loc, sem, inst, n_clusters, P, km_iters,
                ignore, label_cap=config.tpu.label_cap, mesh=mesh,
                rows=rows)

        # ---- differentiable pixel embeddings & prototypes ----
        emb_flat = common.normalize_embedding(wide(emb)).reshape(B, N, D)
        # DensePose squeezes the embedding's weight against the local
        # features (resnet_pspnet_densepose.py:141-154)
        emb_part = emb_flat * 0.1 if densepose else emb_flat
        emb_loc = common.normalize_embedding(
            torch.cat([emb_part, wide(loc.reshape(B, N, loc.shape[-1]))],
                      dim=-1))
        weights = segs.pixel_valid.float()

        def prototypes(x):
            """Each segment's normalized sum of x over its pixels (of
            every space rank: the rank's sums added over the group)."""
            sums = common.segment_sum(x, segs.pixel_segment_ids, P, weights)
            if mesh.space > 1:
                with mesh_lib.collective("segments"):
                    sums = mesh_lib.group_sum(sums, mesh.space_group())
            return common.normalize_embedding(sums)

        protos, protos_loc = prototypes(emb_flat), prototypes(emb_loc)

        # global image indices: this (data) rank's images of the global
        # batch
        img_idx = torch.arange(B, device=dev) + mesh.data_rank * B
        # every data rank's prototypes, in rank order (the prototypes
        # with gradient); the names below hold the gathered lists
        cur = {k: mesh_lib.all_gather(v, mesh.data_group()) for k, v in dict(
            prototype=protos.reshape(B * P, D),
            prototype_with_loc=protos_loc.detach().reshape(B * P, -1),
            semantic_label=segs.segment_semantic.reshape(-1),
            instance_label=segs.segment_instance.reshape(-1),
            batch_index=img_idx.repeat_interleave(P),
            tag=tags.repeat_interleave(P, dim=0),
            valid=segs.segment_valid.reshape(-1)).items()}
        proto_sem, proto_valid = cur["semantic_label"], cur["valid"]
        proto_tag, proto_batch = cur["tag"], cur["batch_index"]

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
        cls_in = common.normalize_embedding(wide(emb)).detach()
        with halo.sharded(mesh, height):
            logits = state.cls_model(cls_in, state.generator, rows)
            logits_up = halo.resize_bilinear(logits, full, rows)
        ce = _cross_entropy(logits_up, sem_full, C, _n_groups(B), mesh)

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
                ann_pix_mask, pix_valid, all_valid, reduction="none",
                operand_dtype=operand_dtype)
            ann = mean(ann_ll, ann_pix_mask, B)
            occ = mean(occ_ll, pix_valid, B)
        else:
            if use_sem_ann:
                # the hard-label kernels or the dense loss: one signature
                ann_loss = functools.partial(
                    fused_segsort_loss, operand_dtype=operand_dtype) \
                    if fused else losses.segsort_loss
                ann_ll = ann_loss(
                    emb_rows, pix_sem, pix_own, all_protos, all_sem,
                    tcfg.sem_ann_concentration, ann_pix_mask,
                    ann_proto_mask, reduction="none")
                ann = mean(ann_ll, ann_pix_mask, B)
            if use_sem_occ:
                # the tag-set kernels or the dense loss: one signature
                occ_loss = functools.partial(
                    fused_set_segsort_loss, operand_dtype=operand_dtype) \
                    if fused else losses.set_segsort_loss
                occ_ll = occ_loss(
                    emb_rows, occ_pix_tags, pix_own, all_protos,
                    occ_proto_tags, tcfg.sem_occ_concentration, pix_valid,
                    all_valid, reduction="none")
                occ = mean(occ_ll, pix_valid, B)

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
        # Height-sharded, an image's mean is its rank's sum over the
        # image's count over the space group, and the image counts once.
        if use_img_sim:
            sim_ll = losses.segsort_loss(
                emb_flat if densepose else emb_loc, inst.reshape(B, N),
                segs.pixel_segment_ids, protos if densepose else protos_loc,
                segs.segment_instance,
                tcfg.img_sim_concentration, segs.pixel_valid,
                segs.segment_valid, reduction="none")
            m = segs.pixel_valid.to(sim_ll.dtype)
            count = torch.sum(m, dim=-1)
            if mesh.space > 1:
                with mesh_lib.collective("other"):
                    count = mesh_lib.all_reduce(count, mesh.space_group())
            per_img = torch.sum(sim_ll * m, dim=-1) / torch.clamp(count,
                                                                   min=1.0)
            img_sim = _grouped_masked_mean(per_img, count > 0, _n_groups(B),
                                           mesh, per_image=True)
            img_sim = img_sim * tcfg.img_sim_loss_weight
            metrics["img_sim_loss"] = img_sim
            total = total + img_sim

        # ---- feature affinity (DensePose, tpu.apply_feat_aff) ----
        if use_feat_aff and densepose:
            aff_ll = losses.set_segsort_loss(
                emb_rows, occ_pix_tags, pix_own, all_protos, occ_proto_tags,
                tcfg.feat_aff_concentration, pix_valid, all_valid,
                reduction="none")
            aff = mean(aff_ll, pix_valid, B)
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
        if world > 1:
            _sum_gradients(params)
        lr = schedule(state.step)
        state = update(params, state, lr)
        memory = state.memory if softmax else state.memory.push(
            cur["prototype"].detach(), cur["prototype_with_loc"].detach(),
            cur["semantic_label"], cur["instance_label"],
            cur["batch_index"], cur["tag"], cur["valid"],
            batch["image"].shape[0] * mesh.data)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = total.detach()
        if world > 1:  # the ranks' shares of each loss sum to its value
            names = [k for k in metrics if k.endswith("loss")]
            with mesh_lib.collective("other"):
                summed = mesh_lib.all_reduce(torch.stack(
                    [common.at_least_float32(metrics[k]) for k in names]))
            metrics.update(zip(names, summed))
        metrics["learning_rate"] = lr
        return dataclasses.replace(state, step=state.step + 1,
                                   memory=memory), metrics

    return train_step

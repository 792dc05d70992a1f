"""Rank functions of the height-sharded tests (tests/test_torch_sp_*.py).

The ranks are spawned processes (spml_tpu_torch/parallel/mesh.py::spawn)
that import this module by name, so it imports torch and the port alone:
no JAX. Every function takes its inputs as numpy arrays or CPU tensors,
returns CPU tensors, and cuts its rank's images (Mesh.shard) and rows
(Mesh.rows, mesh_lib.shard_rows) from the global batch itself; without a
process group it runs as one process, the tests' one-process reference.
"""

import numpy as np
import torch

from spml_tpu_torch.models.embeddings import build_embedding_model
from spml_tpu_torch.parallel import halo
from spml_tpu_torch.parallel import mesh as mesh_lib
from spml_tpu_torch.train import classifier_step as cstep
from spml_tpu_torch.train import step as tstep
import torch_dp_ranks

# seconds a test's spawn may take to join before its ranks are killed
# (mesh_lib.spawn(timeout=)): a rank that skips a collective the others
# entered hangs them, and the test then fails instead of waiting
SPAWN_TIMEOUT = 900


def _mesh(spatial):
    return mesh_lib.make_mesh(spatial if mesh_lib.world_size() > 1 else 1)


def _rows(mesh, height):
    """This rank's rows of a map `height` rows high (halo.partition)."""
    p = halo.partition(height, mesh.space)[mesh.space_rank]
    return slice(p.start, p.stop)


def _local(mesh, batch, device, rows=()):
    """This rank's images and rows of a global numpy batch (the leaves
    of SPATIAL_KEYS and `rows` cut to its rows of their partition)."""
    part = {k: np.ascontiguousarray(v[mesh.shard(v.shape[0])])
            for k, v in batch.items()}
    part = {k: v[:, _rows(mesh, v.shape[1])] if k in rows else v
            for k, v in mesh_lib.shard_rows(part, mesh).items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in part.items()}


def _join(x, mesh, rows):
    """The rows of every space rank (of a map `rows` high), then the
    images of every data rank, of an NHWC tensor: the global batch in
    order (x at world size 1)."""
    if mesh.world == 1:
        return x
    every = mesh_lib.all_gather(mesh_lib.gather_rows(x.contiguous(), mesh,
                                                     rows))
    return every.reshape(mesh.data, mesh.space, *x.shape[:1],
                         *every.shape[1:])[:, 0].flatten(0, 1)


def forward_backward(backbone, dim, init, images, cot, spatial, remat=False,
                     *, device):
    """The embedding model (state dict `init`, BN momentum 0.1 so the
    running statistics move) in train mode on this rank's rows of its
    images, in the images' dtype (float32 or float64): the global
    batch's embeddings and location features joined from every rank, the
    running statistics after the forward, and every parameter's gradient
    of sum(embeddings * cot) summed over the ranks."""
    mesh = _mesh(spatial)
    dtype = torch.from_numpy(images[:0]).dtype
    model = build_embedding_model(backbone, dim, compute_dtype=dtype,
                                  bn_momentum=0.1, remat=remat)
    model.load_state_dict(init, strict=True)
    model = model.to(device, dtype,
                     memory_format=torch.channels_last).train()
    local = _local(mesh, {"image": images, "cot": cot}, device, ("cot",))
    with halo.sharded(mesh, images.shape[1]):
        emb, loc = model(local["image"])
    (emb * local["cot"]).sum().backward()
    grads = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
    grads = mesh_lib.all_reduce(grads)
    sizes = [p.numel() for p in model.parameters()]
    return {"emb": _join(emb.detach(), mesh, cot.shape[1]).cpu(),
            "loc": _join(loc, mesh, cot.shape[1]).cpu(),
            "stats": {k: v.cpu() for k, v in model.state_dict().items()
                      if "running" in k},
            "grads": {n: g.view_as(p).cpu() for (n, p), g in zip(
                model.named_parameters(), grads.split(sizes))}}


def softmax_steps(cfg, init, batches, *, device):
    """len(batches) steps of the softmax baseline (make_train_step) from
    the model state dict `init`, dropout 0, on this rank's rows of its
    images: each step's metrics and the model tensors after."""
    mesh = _mesh(cfg.tpu.spatial_partition)
    if mesh.world == 1:
        cfg.tpu.spatial_partition = 1
    b_global = batches[0]["image"].shape[0]
    state = tstep.init_state(cfg, 0, torch.zeros(b_global, 1, 1, 3),
                             device=device)
    load_init(state, init)
    step = tstep.make_train_step(cfg)
    metrics = []
    for nb in batches:
        state, m = step(state, _local(mesh, nb, device))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "tensors": torch_dp_ranks.model_tensors(state)}


def segsort_steps(cfg, init, batches, float64=False, *, device):
    """len(batches) SegSort steps (make_train_step) from the model state
    dict `init`, dropout 0, on this rank's rows of its images: each
    step's metrics, the model tensors and the memory bank after, and
    each step's k-means Segments of this rank (its rows of its images'
    pixel fields, the segment fields whole). float64: the models, the
    bank and the images in float64 (the dense losses), and every
    parameter's gradient of the last step, summed over the ranks."""
    import dataclasses

    from spml_tpu_torch.ops import kmeans

    mesh = _mesh(cfg.tpu.spatial_partition)
    if mesh.world == 1:
        cfg.tpu.spatial_partition = 1
    b_global = batches[0]["image"].shape[0]
    state = tstep.init_state(cfg, 0, torch.zeros(b_global, 1, 1, 3),
                             device=device)
    load_init(state, init)
    if float64:
        for model in (state.emb_model, state.cls_model):
            model.double()
            model.compute_dtype = torch.float64
        state.memory = dataclasses.replace(state.memory, **{
            k: v.double() for k, v in vars(state.memory).items()
            if v.is_floating_point()})
    step = tstep.make_train_step(cfg)
    orig, segments = kmeans.segment_batch, []

    def recording(*a, **k):
        out = orig(*a, **k)
        segments.append([t.cpu() for t in out[0]])
        return out

    metrics = []
    kmeans.segment_batch = recording
    try:
        for nb in batches:
            batch = _local(mesh, nb, device)
            if float64:
                batch["image"] = batch["image"].double()
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    finally:
        kmeans.segment_batch = orig
    out = {"metrics": metrics, "tensors": torch_dp_ranks.model_tensors(state),
           "memory": {k: v.cpu() for k, v in vars(state.memory).items()},
           "segments": segments}
    if float64:
        out["grads"] = {n: p.grad.detach().cpu().clone()
                        for n, p in tstep._named_params(state)
                        if p.grad is not None}
    return out


def load_init(state, init):
    state.emb_model.load_state_dict(
        {k[len("embedding."):]: v for k, v in init.items()
         if k.startswith("embedding.")}, strict=True)
    state.cls_model.load_state_dict(
        {k[len("prediction."):]: v for k, v in init.items()
         if k.startswith("prediction.")}, strict=True)
    state.cls_model.semantic_classifier[3].p = 0.0


def classifier_steps(cfg, emb_init, head_init, batches, *, device):
    """Stage-2 classifier steps over a frozen embedding of the state dict
    emb_init, from the head head_init (dropout 0), on this rank's rows of
    its images: the logged metrics and the head after."""
    mesh = _mesh(cfg.tpu.spatial_partition)
    if mesh.world == 1:
        cfg.tpu.spatial_partition = 1
    emb = build_embedding_model(cfg.network.backbone_types,
                                cfg.network.embedding_dim)
    emb.load_state_dict(emb_init, strict=True)
    st = cstep.init_classifier_state(cfg, 0, device)
    st.cls_model.load_state_dict(head_init, strict=True)
    st.cls_model.semantic_classifier[3].p = 0.0
    step = cstep.make_classifier_train_step(
        cfg, emb.to(device, memory_format=torch.channels_last))
    metrics = []
    for nb in batches:
        st, m = step(st, _local(mesh, nb, device))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "head": {k: v.cpu() for k, v in
                     st.cls_model.state_dict().items()}}


def many(jobs, *, device):
    """Each (function name, args) job in turn: one spawn serves every case
    of a test file."""
    return [globals()[name](*args, device=device) for name, args in jobs]


def driver_run(fn, init, args, config, *, device):
    """A training driver fn(args, config, device=...) with the initial
    model state dict `init` in place of the port's init (the embedding
    and head of train_spml, the head of train_classifier) and the
    classifier's dropout 0: the metrics logged and the iterations whose
    image panels were drawn (with the embeddings drawn, rank 0), the
    final tensors and generator state."""
    from spml_tpu_torch.train import driver
    from spml_tpu_torch.utils import vis

    init_state, init_cls = tstep.init_state, cstep.init_classifier_state

    def from_init(*a, **k):
        st = init_state(*a, **k)
        load_init(st, init)
        return st

    def cls_from_init(*a, **k):
        st = init_cls(*a, **k)
        st.cls_model.load_state_dict(
            {k[len("prediction."):]: v for k, v in init.items()
             if k.startswith("prediction.")}, strict=True)
        st.cls_model.semantic_classifier[3].p = 0.0
        return st

    logged, drawn = [], []
    log_metrics, to_rgb = driver._log_metrics, vis.embedding_to_rgb

    def capture(writer, metrics, it, prefix=""):
        logged.append((it, {k: float(v) for k, v in metrics.items()}))
        log_metrics(writer, metrics, it, prefix)

    def capture_rgb(emb, *a, **k):
        drawn.append(torch.from_numpy(np.array(emb)))
        return to_rgb(emb, *a, **k)

    tstep.init_state, cstep.init_classifier_state = from_init, cls_from_init
    driver._log_metrics, vis.embedding_to_rgb = capture, capture_rgb
    try:
        state = fn(args, config, device=device)
    finally:
        tstep.init_state, cstep.init_classifier_state = init_state, init_cls
        driver._log_metrics, vis.embedding_to_rgb = log_metrics, to_rgb
    tensors = {"prediction." + k: v.detach().cpu().clone()
               for k, v in state.cls_model.state_dict().items()}
    if state.emb_model is not None:
        tensors.update(torch_dp_ranks.model_tensors(state))
    return {"logged": logged, "drawn": drawn, "tensors": tensors,
            "generator": state.generator.get_state()}


def drivers(overrides, init, head_init, data_dir, data_list, root,
            segsort=None, *, device):
    """train_spml (the softmax baseline) for train.max_iteration
    iterations, the same resumed for one more, then train_classifier
    over its snapshot from the head head_init; with `segsort` (a SegSort
    recipe's overrides) train_spml on it from `init` and resumed for one
    more: driver_run's results of each."""
    import argparse

    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.train import driver

    def args(name):
        return argparse.Namespace(data_dir=data_dir, data_list=data_list,
                                  snapshot_dir=f"{root}/{name}")

    cfg = load_config(overrides=overrides)
    first = driver_run(driver.train_spml, init, args("stage1"), cfg,
                       device=device)
    cfg = load_config(overrides=overrides)
    cfg.train.max_iteration += 1
    cfg.train.resume = True
    resumed = driver_run(driver.train_spml, init, args("stage1"), cfg,
                         device=device)
    cfg = load_config(overrides=overrides)
    cfg.network.pretrained = f"{root}/stage1"
    stage2 = driver_run(driver.train_classifier, head_init, args("stage2"),
                        cfg, device=device)
    out = {"first": first, "resumed": resumed, "stage2": stage2}
    if segsort is not None:
        cfg = load_config(overrides=segsort)
        out["segsort"] = driver_run(driver.train_spml, init,
                                    args("segsort"), cfg, device=device)
        cfg = load_config(overrides=segsort)
        cfg.train.max_iteration += 1
        cfg.train.resume = True
        out["segsort_resumed"] = driver_run(
            driver.train_spml, init, args("segsort"), cfg, device=device)
    return out


def halo_ops(spatial, *, device):
    """halo.conv2d (ASPP's dilation 24 over 2-row shards, the stem's
    stride 2, a 1x1 stride-2 conv over uneven shards), halo.max_pool2d
    and halo.interpolate (x4; and 5 rows to 10, whose output partition is
    not the input's scaled) on this rank's rows of their partition, in
    float64, forward and backward, against the whole operation on the
    whole tensor on the same device; then the same on maps of one row,
    which leave space rank 0 none (convs at dilation 24 and 1x1, a
    stride-2 conv and the max pool whose one output row is rank 1's, the
    x2 and x4 resizes, where rank 0's output rows read rank 1's row
    alone): the largest difference of the outputs and of the input
    gradients over every case."""
    import torch.nn.functional as F

    mesh = _mesh(spatial)
    g = torch.Generator().manual_seed(0)
    cases = [  # (height, op on a tensor, its sharded form)
        (4, lambda x, w: F.conv2d(x, w, None, 1, 24, 24),
         lambda x, w, r: halo.conv2d(x, w, None, (1, 1), (24, 24),
                                     (24, 24), rows=r)),
        (16, lambda x, w: F.conv2d(x, w, None, 2, 1, 1),
         lambda x, w, r: halo.conv2d(x, w, None, (2, 2), (1, 1), (1, 1),
                                     rows=r)),
        (9, lambda x, w: F.conv2d(x, w[:, :, :1, :1], None, 2),
         lambda x, w, r: halo.conv2d(x, w[:, :, :1, :1], None, (2, 2),
                                     (0, 0), (1, 1), rows=r)),
        (8, lambda x, w: F.max_pool2d(x, 3, 2, 1),
         lambda x, w, r: halo.max_pool2d(x, 3, 2, 1, rows=r)),
        (4, lambda x, w: F.interpolate(x, size=(16, 20), mode="bilinear",
                                       align_corners=False),
         lambda x, w, r: halo.interpolate(x, (16, 20), r)),
        (5, lambda x, w: F.interpolate(x, size=(10, 20), mode="bilinear",
                                       align_corners=False),
         lambda x, w, r: halo.interpolate(x, (10, 20), r)),
        # fewer rows than space ranks: rank 0 holds no input row
        (1, lambda x, w: F.conv2d(x, w, None, 1, 24, 24),
         lambda x, w, r: halo.conv2d(x, w, None, (1, 1), (24, 24),
                                     (24, 24), rows=r)),
        (1, lambda x, w: F.conv2d(x, w[:, :, :1, :1]),
         lambda x, w, r: halo.conv2d(x, w[:, :, :1, :1], None, (1, 1),
                                     (0, 0), (1, 1), rows=r)),
        (2, lambda x, w: F.conv2d(x, w, None, 2, 1, 1),
         lambda x, w, r: halo.conv2d(x, w, None, (2, 2), (1, 1), (1, 1),
                                     rows=r)),
        (2, lambda x, w: F.max_pool2d(x, 3, 2, 1),
         lambda x, w, r: halo.max_pool2d(x, 3, 2, 1, rows=r)),
        (1, lambda x, w: F.interpolate(x, size=(2, 10), mode="bilinear",
                                       align_corners=False),
         lambda x, w, r: halo.interpolate(x, (2, 10), r)),
        (1, lambda x, w: F.interpolate(x, size=(4, 10), mode="bilinear",
                                       align_corners=False),
         lambda x, w, r: halo.interpolate(x, (4, 10), r))]
    out = []
    for height, whole, part in cases:
        x = torch.randn(2 * mesh.data, 3, height, 5, generator=g,
                        dtype=torch.float64).to(device)
        w = torch.randn(4, 3, 3, 3, generator=g,
                        dtype=torch.float64).to(device)
        xf = x.clone().requires_grad_()
        yf = whole(xf, w)
        cot = torch.randn(yf.shape, generator=g,
                          dtype=torch.float64).to(device)
        (yf * cot).sum().backward()
        imgs = mesh.shard(x.shape[0])
        xl = x[imgs, :, _rows(mesh, height)].clone().requires_grad_()
        with halo.sharded(mesh):
            y = part(xl, w, height)
        rows = _rows(mesh, yf.shape[2])
        (y * cot[imgs, :, rows]).sum().backward()
        out.append((_largest(y - yf[imgs, :, rows]),
                    _largest(xl.grad - xf.grad[imgs, :, _rows(mesh,
                                                              height)])))
    return out


def _largest(t):
    """max |t|, 0 for a tensor of no elements (a rank's rows of none)."""
    return float(t.detach().abs().max()) if t.numel() else 0.0


def batch_norm_rows(x, cot, weight, bias, spatial, *, device):
    """models/resnet.py::BatchNorm2d (float64, train mode, momentum 0.1)
    on this rank's rows of x [B, C, H, W] (NCHW) inside halo.sharded,
    H < spatial, so that some space ranks hold no row (count 0), with
    cotangent `cot`: the output and input gradient, the ranks' rows
    joined; the weight and bias gradients summed over the ranks; the
    running statistics; whether this rank's output and gradients are
    finite."""
    from spml_tpu_torch.models import resnet

    mesh = _mesh(spatial)
    bn = resnet.BatchNorm2d(x.shape[1], eps=resnet.BN_EPS, momentum=0.1)
    bn = bn.double().to(device)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    rows = _rows(mesh, x.shape[2])
    xl = torch.from_numpy(x[:, :, rows]).to(device).requires_grad_()
    with halo.sharded(mesh):
        y = bn(xl)
    (y * torch.from_numpy(cot[:, :, rows]).to(device)).sum().backward()
    grads = mesh_lib.all_reduce(torch.cat([bn.weight.grad, bn.bias.grad]))

    def join(t):
        return mesh_lib.gather_rows(t.detach().contiguous(), mesh,
                                    x.shape[2], dim=2).cpu()

    return {"rows": xl.shape[2], "y": join(y), "dx": join(xl.grad),
            "dw": grads[:x.shape[1]].cpu(), "db": grads[x.shape[1]:].cpu(),
            "stats": {k: v.cpu() for k, v in bn.named_buffers()},
            "finite": bool(torch.isfinite(y).all()
                           and torch.isfinite(xl.grad).all()
                           and torch.isfinite(grads).all())}


def sharded_segments(emb, loc, sem, inst, args, *, device):
    """ops/kmeans.py::segment_batch(*args) on this rank's rows of the
    global batch's numpy inputs (its images and rows), on `device`: its
    Segments as CPU tensors."""
    from spml_tpu_torch.ops import kmeans

    mesh = mesh_lib.make_mesh(2)
    t = _local(mesh, {"emb": emb, "loc": loc, "semantic_label": sem,
                      "instance_label": inst}, device, ("emb", "loc"))
    segs = kmeans.segment_batch(t["emb"], t["loc"], t["semantic_label"],
                                t["instance_label"], *args, mesh=mesh,
                                rows=emb.shape[1])[0]
    return [x.cpu() for x in segs]


def _seeded_pspp(cin, cout, seed):
    """A float64 PSPP(cin, cout) in train mode, weights and BN affine
    drawn from `seed`, BN momentum 0.1 (the running statistics move
    visibly in one forward)."""
    from spml_tpu_torch.models.resnet import BatchNorm2d
    from spml_tpu_torch.models.spp import PSPP

    g = torch.Generator().manual_seed(seed)
    model = PSPP(cin, cout).double()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g,
                                           dtype=torch.float64) * 0.3)
            elif isinstance(m, BatchNorm2d):
                m.momentum = 0.1
                m.weight.copy_(1 + 0.2 * torch.randn(
                    m.weight.shape, generator=g, dtype=torch.float64))
                m.bias.copy_(0.2 * torch.randn(m.bias.shape, generator=g,
                                               dtype=torch.float64))
    return model.train()


def pspp_case(height, spatial, *, device):
    """halo.adaptive_avg_pools and PSPP (float64, train mode) over this
    rank's rows of a seeded [2, 8, height, 6] map, inside halo.sharded:
    the pooled maps (whole on every rank) and the gradient of
    sum(pools x this rank's own cotangent) (one process: the sum of the
    ranks' cotangents), then PSPP's output and the gradient of
    sum(output x a cotangent), the ranks' rows joined, every parameter
    gradient summed over the ranks, and the running statistics. One
    process (no group) computes the whole map."""
    from spml_tpu_torch.models.spp import PSPP_BINS

    mesh = _mesh(spatial)
    rng = np.random.RandomState(height)
    x = torch.from_numpy(rng.randn(2, 8, height, 6))
    pool_cots = [torch.from_numpy(rng.randn(spatial, 2, 8, s, s))
                 for s in PSPP_BINS]
    cot = torch.from_numpy(rng.randn(2, 4, height, 6))
    rows = _rows(mesh, height)
    xl = x[:, :, rows].to(device).requires_grad_()
    with halo.sharded(mesh):
        pools = halo.adaptive_avg_pools(xl, PSPP_BINS, height)
    own = [c[mesh.space_rank] if mesh.world > 1 else c.sum(0)
           for c in pool_cots]
    sum((p * c.to(device)).sum() for p, c in zip(pools, own)).backward()
    pool_dx = xl.grad
    model = _seeded_pspp(8, 4, 0).to(device)
    xl = x[:, :, rows].to(device).requires_grad_()
    with halo.sharded(mesh):
        y = model(xl, height)
    (y * cot[:, :, rows].to(device)).sum().backward()
    params = list(model.named_parameters())
    grads = mesh_lib.all_reduce(torch.cat([p.grad.reshape(-1)
                                           for _, p in params]))

    def join(t):
        return mesh_lib.gather_rows(t.detach().contiguous(), mesh, height,
                                    dim=2).cpu()

    return {"pools": [p.detach().cpu() for p in pools],
            "pool_dx": join(pool_dx), "out": join(y), "dx": join(xl.grad),
            "grads": {n: g.view_as(p).cpu() for (n, p), g in zip(
                params, grads.split([p.numel() for _, p in params]))},
            "stats": {k: v.cpu() for k, v in model.state_dict().items()
                      if "running" in k}}


def colour_case(shape, spatial, *, device):
    """DensePose's local features (location + colour: a 5x5 blur, the
    resize to the stride-4 grid, the per-image normalization) of this
    rank's rows of its images of a seeded [4, H, W, 3] batch, inside
    halo.sharded, joined over every rank: the global batch's."""
    from spml_tpu_torch.models import local

    mesh = _mesh(spatial)
    h, w = shape
    images = np.random.RandomState(h + w).rand(4, h, w, 3).astype(
        np.float32)
    x = _local(mesh, {"image": images}, device)["image"]
    size = (h // 4, w // 4)
    with halo.sharded(mesh, h):
        feats = local.location_color_features(
            x, size, use_color=True, norm_color=True, smooth_ksize=5)
    return _join(feats, mesh, size[0]).cpu()


def train_spml_run(overrides, init, data_dir, data_list, snapshot_dir, *,
                   device):
    """train_spml on `overrides` from `init`: driver_run's results."""
    import argparse

    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.train import driver

    return driver_run(driver.train_spml, init, argparse.Namespace(
        data_dir=data_dir, data_list=data_list, snapshot_dir=snapshot_dir),
        load_config(overrides=overrides), device=device)


def densepose_drivers(overrides, init, head_init, data_dir, data_list,
                      root, *, device):
    """train_spml with DenseposeTagDataset (the DensePose CLI's) for
    train.max_iteration iterations from `init`, then train_classifier
    with DenseposeClassifierDataset over its snapshot from the head
    head_init: driver_run's results of each."""
    import argparse
    import functools

    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.data import datasets
    from spml_tpu_torch.train import driver

    def args(name):
        return argparse.Namespace(data_dir=data_dir, data_list=data_list,
                                  snapshot_dir=f"{root}/{name}")

    cfg = load_config(overrides=overrides)
    stage1 = driver_run(functools.partial(
        driver.train_spml, dataset_cls=datasets.DenseposeTagDataset),
        init, args("densepose"), cfg, device=device)
    cfg = load_config(overrides=overrides)
    cfg.network.pretrained = f"{root}/densepose"
    stage2 = driver_run(functools.partial(
        driver.train_classifier,
        dataset_cls=datasets.DenseposeClassifierDataset),
        head_init, args("densepose_classifier"), cfg, device=device)
    return {"stage1": stage1, "stage2": stage2}

"""Rank functions of the data-parallel tests (tests/test_torch_dp_*.py).

The ranks are spawned processes (spml_tpu_torch/parallel/mesh.py::spawn)
that import this module by name, so it imports torch and the port alone:
no JAX. Every function takes its inputs as numpy arrays or CPU tensors and
returns CPU tensors; without a process group it runs as one process, which
is the tests' one-process reference.
"""

import numpy as np
import torch

from spml_tpu_torch.parallel import mesh as mesh_lib
from spml_tpu_torch.train import step as tstep


def model_tensors(state) -> dict:
    """Every parameter and buffer of both models, by the JAX-comparable
    names of tests/test_torch_train_step.py."""
    out = {"embedding." + k: v.detach().cpu().clone()
           for k, v in state.emb_model.state_dict().items()}
    out.update({"prediction." + k: v.detach().cpu().clone()
                for k, v in state.cls_model.state_dict().items()})
    return out


def train_steps(cfg, init, batches, patch=None, *, device):
    """len(batches) train steps of this rank's slice of each global batch
    from the model state dict `init` (the classifier's dropout 0, as the
    parity tests keep it). patch: (name in parallel/mesh.py, name of the
    function of this module that stands in for it during the steps).
    Returns the metrics of each step, the model tensors and the memory
    bank after the last."""
    if patch is None:
        return _train_steps(cfg, init, batches, device)
    target, name = patch
    orig = getattr(mesh_lib, target)
    setattr(mesh_lib, target, globals()[name])
    try:
        return _train_steps(cfg, init, batches, device)
    finally:
        setattr(mesh_lib, target, orig)


def _train_steps(cfg, init, batches, device):
    mesh = mesh_lib.make_mesh()
    b_global = batches[0]["image"].shape[0]
    shard = mesh.shard(b_global)
    state = tstep.init_state(cfg, 0, torch.zeros(b_global, 1, 1, 3),
                             device=device)
    state.emb_model.load_state_dict(
        {k[len("embedding."):]: v for k, v in init.items()
         if k.startswith("embedding.")}, strict=True)
    state.cls_model.load_state_dict(
        {k[len("prediction."):]: v for k, v in init.items()
         if k.startswith("prediction.")}, strict=True)
    state.cls_model.semantic_classifier[3].p = 0.0
    step = tstep.make_train_step(cfg)
    metrics = []
    for nb in batches:
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[shard]))
                 .to(device) for k, v in nb.items()}
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "tensors": model_tensors(state),
            "memory": {k: v.cpu() for k, v in vars(state.memory).items()}}


def plain_gather(x, group=None):
    """A gather (over every rank: the data-parallel tests' group) without
    the gradient of the other ranks' use: this rank's rows carry their
    own rank's gradient alone (what a bare dist.all_gather with the local
    tensor put back in gives)."""
    if mesh_lib.world_size() == 1:
        return x
    assert group is None
    full = mesh_lib._gather(x)
    rank, n = mesh_lib.make_mesh().rank, x.shape[0]
    return torch.cat([full[:rank * n], x, full[(rank + 1) * n:]])


def many(jobs, *, device):
    """train_steps of each (cfg, init, batches, patch) job in turn: one
    spawn serves every case of a test file."""
    return [train_steps(*job, device=device) for job in jobs]


def batch_norm(x, cot, weight, bias, momentum, *, device):
    """models/resnet.py::BatchNorm2d in train mode on this rank's slice of
    x [B, H, W, C] (NHWC, as the JAX package's) with cotangent `cot`:
    output, input gradient, this rank's weight and bias gradients, the
    buffers after the step; then a remat recomputation of the same
    input, whose output must equal the step's and whose buffers must stay
    as they are."""
    from spml_tpu_torch.models import resnet

    shard = mesh_lib.make_mesh().shard(x.shape[0])
    bn = resnet.BatchNorm2d(x.shape[-1], eps=resnet.BN_EPS,
                            momentum=momentum).to(device)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))

    def nchw(a):
        return torch.from_numpy(np.ascontiguousarray(a[shard])).to(
            device).permute(0, 3, 1, 2)

    xl = nchw(x).requires_grad_()
    y = bn(xl)
    (y * nchw(cot)).sum().backward()
    buffers = {k: v.clone() for k, v in bn.named_buffers()}
    with torch.no_grad(), resnet._recomputing():
        again = bn(xl.detach())
    return {"y": y.detach().permute(0, 2, 3, 1).cpu(),
            "dx": xl.grad.permute(0, 2, 3, 1).cpu(),
            "dw": bn.weight.grad.cpu(), "db": bn.bias.grad.cpu(),
            "buffers": {k: v.cpu() for k, v in buffers.items()},
            "recomputed_equal": torch.equal(again, y.detach()),
            "buffers_kept": all(torch.equal(v, buffers[k])
                                for k, v in bn.named_buffers())}


def with_jax_init(fn, init, out, *args, device):
    """fn(*args, device=device) (a training driver, as tools/train.py
    launches it) with the initial weights `init` in place of the port's
    init (the JAX package's initial state, converted) and the
    classifier's dropout 0; rank 0 writes the logged metrics to
    out.json, every rank its model tensors to out.rank{r}.pt."""
    import json

    from spml_tpu_torch.train import driver

    init_state = tstep.init_state

    def from_init(*a, **k):
        st = init_state(*a, **k)
        st.emb_model.load_state_dict(
            {k[len("embedding."):]: v for k, v in init.items()
             if k.startswith("embedding.")}, strict=True)
        st.cls_model.load_state_dict(
            {k[len("prediction."):]: v for k, v in init.items()
             if k.startswith("prediction.")}, strict=True)
        st.cls_model.semantic_classifier[3].p = 0.0
        return st

    logged = []
    log_metrics = driver._log_metrics

    def capture(writer, metrics, it, prefix=""):
        logged.append((it, {k: float(v) for k, v in metrics.items()}))
        log_metrics(writer, metrics, it, prefix)

    tstep.init_state, driver._log_metrics = from_init, capture
    try:
        state = fn(*args, device=device)
    finally:
        tstep.init_state, driver._log_metrics = init_state, log_metrics
    rank = mesh_lib.make_mesh().rank
    if rank == 0:
        with open(out + ".json", "w") as f:
            json.dump(logged, f)
    torch.save({"tensors": model_tensors(state),
                "memory": {k: v.cpu() for k, v in vars(state.memory).items()},
                "generator": state.generator.get_state()},
               f"{out}.rank{rank}.pt")


def classifier_steps(cfg, emb_init, head_init, batches, *, device):
    """Stage-2 classifier steps on this rank's slice of each global batch
    over a frozen embedding of the state dict emb_init, from the head
    head_init (dropout 0): the logged losses and the head after."""
    from spml_tpu_torch.models.embeddings import build_embedding_model
    from spml_tpu_torch.train import classifier_step as cstep

    shard = mesh_lib.make_mesh().shard(batches[0]["image"].shape[0])
    emb = build_embedding_model(cfg.network.backbone_types,
                                cfg.network.embedding_dim)
    emb.load_state_dict(emb_init, strict=True)
    st = cstep.init_classifier_state(cfg, 0, device)
    st.cls_model.load_state_dict(head_init, strict=True)
    st.cls_model.semantic_classifier[3].p = 0.0
    step = cstep.make_classifier_train_step(cfg, emb.to(device))
    losses = []
    for nb in batches:
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[shard]))
                 .to(device) for k, v in nb.items()}
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
    return {"losses": losses,
            "head": {k: v.cpu() for k, v in
                     st.cls_model.state_dict().items()}}


def fail_on_rank(bad, *, device):
    """Raises on rank `bad`; the other ranks return."""
    if mesh_lib.make_mesh().rank == bad:
        raise RuntimeError(f"rank {bad} fails on {device}")

"""The port's DensePose point-supervision train step against the JAX train
step on the CPU, at a small size of the recipe in
spml_tpu_torch/train/densepose_point.py (panoptic_pspnet_10_densepose,
dim 8, crop 32, batch 2, 2x2 k-means, capacity 32, no memory bank, fused
loss) on a point-labelled batch from the port's point_batch.

* Two steps with the recipe as it ships (sem_occ off, feat_aff inert):
  the hard-label fused loss, the JAX side through its Pallas kernels in
  interpret mode, the port through the plain version of K4-K6.
* Two steps with sem_occ on, tpu.apply_feat_aff and a one-step memory
  bank: NN-propagated tags (over the bank too at the second step), the
  joint fused loss and the dense feat_aff loss.

Tolerances are those of tests/test_torch_train_step.py (losses and
metrics rtol 1e-4; labels, batch indices, tags and validity exactly
equal) with three exceptions, all set
by how far the JAX step is from itself on this configuration. In train
mode the flax PSPNet's float32 embeddings are 2.6e-5 (of max|e| 1.0) off
a float64 run of the same flax model on this batch, the port's 8.5e-6:
* img_sim_loss rtol 2e-3: its concentration of 16 amplifies that error;
  the jitted and the eager JAX steps differ by 1.8e-4 at the first step
  (the port by 1.9e-4) and the port by 9.7e-4 at the second;
* parameter and BN statistic updates within 3e-2 * max|update|: the
  jitted and the eager JAX steps differ by up to 2.34e-2 (the 4096-input
  fuse conv of PSPP, pspp.0.conv.0.weight), 1.53e-2 (res5.0.conv2) and
  9.7e-3 (pspp_4's BN bias), and the port by the same amounts;
* memory-bank prototypes (unit rows, from the second step) atol 5e-3:
  the jitted and the eager JAX steps differ by 3.2e-3 there (4.3e-4 with
  location), the port by about as much.
"""

import copy
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import torch

from spml_tpu.config import load_config as jload_config
from spml_tpu.models.embeddings import ClassifierHead as JHead
from spml_tpu.ops.pallas import segsort_loss as jfused
from spml_tpu.train import step as jstep
from spml_tpu_torch.config import load_config
from spml_tpu_torch.train import densepose_point, step as tstep
from tests.test_torch_train_step import (_close, _port_state_dict,
                                         _state_dicts)

UPDATE_RTOL = 3e-2

OVERRIDES = copy.deepcopy(densepose_point.OVERRIDES)
OVERRIDES["network"].update(backbone_types="panoptic_pspnet_10_densepose",
                            embedding_dim=8, kmeans_num_clusters=[2, 2],
                            kmeans_iterations=2)
OVERRIDES["train"].update(batch_size=2, crop_size=[32, 32],
                          max_iteration=100, warmup_iteration=10)
OVERRIDES["tpu"].update(segment_capacity=32, compute_dtype="float32")

CHECKED_PARAMS = [
    "embedding.pspp.0.pspp_1.1.weight", "embedding.pspp.0.pspp_4.2.bias",
    "embedding.pspp.0.conv.0.weight", "embedding.pspp.0.conv.1.weight",
    "embedding.pspp.1.weight", "embedding.pspp.1.bias",
    "embedding.resnet_backbone.res5.0.conv2.weight",
    "embedding.resnet_backbone.res3.0.bn1.weight",
    "prediction.semantic_classifier.0.weight",
]
CHECKED_STATS = [
    "embedding.pspp.0.pspp_3.2.running_mean",
    "embedding.pspp.0.conv.1.running_var",
    "embedding.resnet_backbone.res4.0.bn2.running_mean",
    "prediction.semantic_classifier.1.running_var",
]
EXACT_MEMORY = ("semantic_label", "instance_label", "batch_index", "tag",
                "valid")


def _interpret(module, name):
    orig = getattr(module, name)
    return mock.patch.object(
        module, name, lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def _run_both(overrides, steps):
    """`steps` train steps of the JAX package and of the port from the
    same weights and batch; returns (JAX state, port state, initial
    state dict, per-step metric pairs)."""
    nb = {k: v.numpy() for k, v in densepose_point.point_batch(
        2, 32, seed=5, device="cpu").items()}
    jcfg = jload_config(overrides=overrides)
    jst = jstep.init_state(jcfg, jax.random.PRNGKey(0),
                           jnp.zeros((2, 32, 32, 3)))
    emb_def, _ = jstep.build_models(jcfg)
    head = JHead(num_classes=15, hidden_dim=16, dropout_rate=0.0,
                 dtype=jnp.float32)

    cfg = load_config(overrides=overrides)
    st = tstep.init_state(cfg, 0, torch.zeros(2, 32, 32, 3), device="cpu")
    sd = _state_dicts(jst.params, jst.batch_stats)
    for prefix, model in (("embedding.", st.emb_model),
                          ("prediction.", st.cls_model)):
        model.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                               if k.startswith(prefix)}, strict=True)
    st.cls_model.semantic_classifier[3].p = 0.0
    step = tstep.make_train_step(cfg)

    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    metrics = []
    with _interpret(jfused, "fused_segsort_loss"), \
            _interpret(jfused, "fused_joint_losses"):
        jfn = jax.jit(jstep.make_train_step(jcfg, emb_def, head))
        for _ in range(steps):
            jst, jm = jfn(jst, jbatch)
            st, tm = step(st, tbatch)
            metrics.append((jm, tm))
    return jst, st, sd, metrics


def _check_metrics(metrics):
    for i, (jm, tm) in enumerate(metrics):
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(
                float(tm[k]), float(jm[k]),
                rtol=2e-3 if k == "img_sim_loss" else 1e-4, atol=1e-7,
                err_msg=f"step {i} {k}")


def _check_memory(jst, st):
    jmem, tmem = jst.memory, st.memory
    assert tmem.prototype_with_loc.shape[-1] == 8 + 5
    for name in ("prototype", "prototype_with_loc"):
        np.testing.assert_allclose(getattr(tmem, name).numpy(),
                                   np.asarray(getattr(jmem, name)),
                                   rtol=0, atol=5e-3, err_msg=name)
    for name in EXACT_MEMORY:
        np.testing.assert_array_equal(getattr(tmem, name).numpy(),
                                      np.asarray(getattr(jmem, name)),
                                      err_msg=name)


def test_two_densepose_steps_match_jax():
    """The recipe as it ships: sem_ann through the hard-label fused loss,
    img_sim on the plain embeddings, no sem_occ, no feat_aff."""
    jst, st, sd, metrics = _run_both(OVERRIDES, 2)
    _check_metrics(metrics)
    assert "sem_occ_loss" not in metrics[0][1]
    assert "feat_aff_loss" not in metrics[0][1]
    assert st.step == int(jst.step) == 2
    assert float(metrics[-1][1]["num_segments"]) > 0

    want = _state_dicts(jst.params, jst.batch_stats)
    got = _port_state_dict(st)
    for k in CHECKED_PARAMS + CHECKED_STATS:
        _close(got[k].detach().numpy() - sd[k].numpy(),
               want[k].numpy() - sd[k].numpy(), rel_atol=UPDATE_RTOL)
    _check_memory(jst, st)


def test_densepose_steps_with_nn_tags_match_jax():
    """sem_occ on, tpu.apply_feat_aff and a memory bank: tags propagated
    from the nearest labelled prototype of the same image (the bank's
    included at the second step), sem_ann + sem_occ through the joint
    fused loss, the dense feat_aff loss."""
    overrides = copy.deepcopy(OVERRIDES)
    overrides["train"].update(sem_occ_loss_types="segsort",
                              memory_bank_size=1)
    overrides["tpu"]["apply_feat_aff"] = True
    jst, st, _, metrics = _run_both(overrides, 2)
    _check_metrics(metrics)
    assert {"sem_occ_loss", "feat_aff_loss"} <= set(metrics[0][1])
    _check_memory(jst, st)

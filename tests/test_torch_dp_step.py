"""The data-parallel train step of the port (spml_tpu_torch/parallel/
mesh.py) on two gloo ranks on the CPU, spawned once for every case.

* Against the JAX package's make_train_step sharded over a 2-device CPU
  mesh (spml_tpu/parallel/mesh.py::make_mesh, shard_train_step) on the
  same global batch of 4 (train.batch_size 2: two loss groups, one a
  rank), the flagship configuration of tests/test_torch_train_step.py
  with the fused joint loss (JAX's Pallas kernel in interpret mode, the
  port's plain version), two steps so that step 2 sees the memory bank.
  Tolerances as in that file: losses and metrics rtol 1e-4, parameter
  and BN statistic updates within 1e-2 * max|update| (plus one float32
  unit of the tensor's largest value, below which no two float32 values
  differ: JAX's sharded and single-device steps differ by that unit on a
  BN scale here), bank labels, batch indices, tags and validity equal.
  Bank prototypes (unit rows, after step 2) atol 2e-3, set as
  tests/test_torch_densepose_step.py sets its own, by how far the JAX
  step is from itself: at this global batch JAX's eager step is 1.06e-3
  off its sharded one there (its jitted single-device step 5.0e-6), the
  port 5.6e-4 off, one process or two ranks alike. The two ranks'
  parameters, buffers and banks are torch.equal.
* The same run with a gather that drops the other ranks' gradient of a
  rank's prototypes (what a bare dist.all_gather gives) fails that
  comparison: the update of some checked parameter is off by more than
  its tolerance.
* Cases of one parametrised test against the port's own one-process
  step at the global batch (same weights, same batches, world size 1):
  the VOC tag-only recipe (sem_ann off, the tag-set loss), the DensePose
  recipe as it ships (hard-label loss) and with sem_occ on and a bank
  (NN-propagated tags over the gathered prototypes with location and
  global batch indices), remat_stages (4,), and a rank whose labels are
  all ignore (its loss groups empty). Tolerances as above; DensePose's
  those of tests/test_torch_densepose_step.py (img_sim rtol 2e-3,
  updates 3e-2 * max|update|, bank prototypes atol 5e-3), which that
  file sets from how far the JAX step is from itself there.
"""

import copy
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spml_tpu.config import load_config as jload_config
from spml_tpu.models.embeddings import ClassifierHead as JHead
from spml_tpu.ops.pallas import segsort_loss as jfused
from spml_tpu.parallel import mesh as jmesh
from spml_tpu.train import step as jstep
from spml_tpu_torch.config import load_config
from spml_tpu_torch.parallel import mesh as mesh_lib
from spml_tpu_torch.train import densepose_point
from spml_tpu_torch.train import step as tstep
import torch_dp_ranks
from test_torch_train_step import (CHECKED_PARAMS, CHECKED_STATS, OVERRIDES,
                                   _state_dicts)

B_GLOBAL = 4
FLAGSHIP = copy.deepcopy(OVERRIDES)  # train.batch_size 2 a rank
TAG_ONLY = copy.deepcopy(OVERRIDES)
TAG_ONLY["train"].update(sem_ann_loss_types="none",
                         sem_occ_concentration=8.0)
DENSEPOSE = copy.deepcopy(densepose_point.OVERRIDES)
DENSEPOSE["network"].update(backbone_types="panoptic_pspnet_10_densepose",
                            embedding_dim=8, kmeans_num_clusters=[2, 2],
                            kmeans_iterations=2)
DENSEPOSE["train"].update(batch_size=2, crop_size=[32, 32],
                          max_iteration=100, warmup_iteration=10)
DENSEPOSE["tpu"].update(segment_capacity=32, compute_dtype="float32")
DENSEPOSE_TAGS = copy.deepcopy(DENSEPOSE)
DENSEPOSE_TAGS["train"].update(sem_occ_loss_types="segsort",
                               memory_bank_size=1)
REMAT = copy.deepcopy(OVERRIDES)
REMAT["tpu"]["remat_stages"] = (4,)

DP_CHECKED = [
    "embedding.pspp.0.pspp_1.1.weight", "embedding.pspp.0.pspp_4.2.bias",
    "embedding.resnet_backbone.res3.0.conv2.weight",
    "embedding.resnet_backbone.res5.0.bn2.running_mean",
    "prediction.semantic_classifier.0.weight"]


def _batch(seed, num_classes=5):
    rng = np.random.RandomState(seed)
    return {
        "image": rng.randn(B_GLOBAL, 32, 32, 3).astype(np.float32),
        "semantic_label": rng.randint(0, num_classes,
                                      (B_GLOBAL, 32, 32)).astype(np.int64),
        "instance_label": rng.randint(0, 3,
                                      (B_GLOBAL, 32, 32)).astype(np.int64),
        "semantic_tag": (rng.rand(B_GLOBAL, 256) > 0.6).astype(np.int64)}


def _point_batches():
    return [{k: v.numpy() for k, v in densepose_point.point_batch(
        B_GLOBAL, 32, seed=s, device="cpu").items()} for s in (5, 6)]


def _empty_group_batches():
    out = [_batch(3), _batch(4)]
    for nb in out:  # rank 1's images: every label the ignore index
        nb["semantic_label"][B_GLOBAL // 2:] = 255
    return out


# case -> (overrides, batches, checked tensors, metric rtol by name,
# update tolerance, bank prototype atol)
CASES = {
    "tag_only": (TAG_ONLY, lambda: [_batch(3), _batch(4)],
                 CHECKED_PARAMS + CHECKED_STATS, {}, 1e-2, 3e-4),
    "densepose": (DENSEPOSE, _point_batches, DP_CHECKED,
                  {"img_sim_loss": 2e-3}, 3e-2, 5e-3),
    "densepose_nn_tags": (DENSEPOSE_TAGS, _point_batches, DP_CHECKED,
                          {"img_sim_loss": 2e-3}, 3e-2, 5e-3),
    "remat_stages": (REMAT, lambda: [_batch(3), _batch(4)],
                     CHECKED_PARAMS + CHECKED_STATS, {}, 1e-2, 3e-4),
    "empty_group": (FLAGSHIP, _empty_group_batches,
                    CHECKED_PARAMS + CHECKED_STATS, {}, 1e-2, 3e-4),
}


def _jax_initial(overrides):
    jcfg = jload_config(overrides=overrides)
    jst = jstep.init_state(jcfg, jax.random.PRNGKey(0),
                           jnp.zeros((B_GLOBAL, 32, 32, 3)))
    return jcfg, jst, _state_dicts(jst.params, jst.batch_stats)


def _port_initial(overrides):
    cfg = load_config(overrides=overrides)
    st = tstep.init_state(cfg, 0, torch.zeros(B_GLOBAL, 1, 1, 3), "cpu")
    return cfg, torch_dp_ranks.model_tensors(st)


@pytest.fixture(scope="module")
def runs():
    """Every case's two ranks, spawned once: {case: (rank 0, rank 1)}, and
    the JAX side of the flagship."""
    jcfg, jst, init = _jax_initial(FLAGSHIP)
    flagship = [_batch(3), _batch(4)]
    cfg = load_config(overrides=FLAGSHIP)
    jobs = {"flagship": (cfg, init, flagship, None),
            "plain_gather": (cfg, init, flagship,
                             ("all_gather", "plain_gather"))}
    inits = {}
    for name, (overrides, batches, *_) in CASES.items():
        ccfg, cinit = _port_initial(overrides)
        inits[name] = (ccfg, cinit, batches())
        jobs[name] = (*inits[name], None)
    ranks = mesh_lib.spawn(torch_dp_ranks.many, (list(jobs.values()),),
                           ["cpu", "cpu"])
    out = {name: pair for name, pair in zip(jobs, zip(*ranks))}
    return out, (jcfg, jst, init, flagship), inits


def _jax_steps(jcfg, jst, batches):
    emb_def, _ = jstep.build_models(jcfg)
    head = JHead(num_classes=jcfg.dataset.num_classes,
                 hidden_dim=2 * jcfg.network.embedding_dim,
                 dropout_rate=0.0, dtype=jnp.float32)
    mesh = jmesh.make_mesh(num_devices=2)
    orig = jfused.fused_joint_losses
    metrics = []
    with mock.patch.object(
            jfused, "fused_joint_losses",
            lambda *a, **k: orig(*a, **{**k, "interpret": True})):
        fn = jmesh.shard_train_step(
            jstep.make_train_step(jcfg, emb_def, head), mesh)
        jst = jmesh.device_put_replicated(jst, mesh)
        for nb in batches:
            jst, m = fn(jst, jmesh.device_put_batch(
                {k: jnp.asarray(v) for k, v in nb.items()}, mesh))
            metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _state_dicts(jst.params, jst.batch_stats), jst.memory


def _update_errors(got, want, init, names, tol):
    """{name: max|update difference| / (tol * max|update| + one float32
    unit of the tensor's largest value)}: within tolerance at <= 1. The
    float32 unit is the floor of any difference of two float32 values
    (a BN scale of 1 moved by ~3e-6 is ~50 units: JAX's sharded and
    single-device steps differ by one unit there, 1.74e-2 of the update,
    on res4.0.bn1.weight of the flagship case)."""
    out = {}
    for k in names:
        want_k = np.asarray(want[k], np.float64)
        upd = want_k - init[k].numpy()
        diff = np.asarray(got[k], np.float64) - want_k
        unit = np.spacing(np.float32(np.abs(want_k).max()))
        out[k] = np.abs(diff).max() / (tol * np.abs(upd).max() + unit)
    return out


def _assert_ranks_equal(pair):
    a, b = pair
    assert a["tensors"].keys() == b["tensors"].keys()
    for k, v in a["tensors"].items():
        assert torch.equal(v, b["tensors"][k]), k
    for k, v in a["memory"].items():
        assert torch.equal(v, b["memory"][k]), k
    assert a["metrics"] == b["metrics"]


def _assert_metrics(got, want, rtols):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=rtols.get(k, 1e-4),
                                       atol=1e-7, err_msg=f"step {i} {k}")


def _assert_bank(got, want, atol):
    for name in ("prototype", "prototype_with_loc"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=0, atol=atol, err_msg=name)
    for name in ("semantic_label", "instance_label", "batch_index", "tag",
                 "valid"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


def test_two_ranks_match_jax_sharded_step(runs):
    out, (jcfg, jst, init, batches), _ = runs
    pair = out["flagship"]
    _assert_ranks_equal(pair)
    jmetrics, want, jmem = _jax_steps(jcfg, jst, batches)
    _assert_metrics(pair[0]["metrics"], jmetrics, {})
    errs = _update_errors(pair[0]["tensors"], want, init,
                          CHECKED_PARAMS + CHECKED_STATS, 1e-2)
    assert max(errs.values()) <= 1, errs
    # the frozen stem never moves
    k = "embedding.resnet_backbone.conv1.conv1.0.weight"
    assert torch.equal(pair[0]["tensors"][k], init[k])
    _assert_bank(pair[0]["memory"], vars(jmem), 2e-3)
    # the bank holds the global batch: 4 images of 32 prototypes
    assert pair[0]["memory"]["prototype"].shape == (1, B_GLOBAL * 32, 8)


def test_gather_without_gradient_fails_the_comparison(runs):
    """The plain gather's forward is the same, so step 1's losses agree;
    the embedding's update lacks the other rank's use of this rank's
    prototypes (the dP that K3 computes there)."""
    out, (_, _, init, _), _ = runs
    good, bad = out["flagship"][0], out["plain_gather"][0]
    for k in good["metrics"][0]:
        assert bad["metrics"][0][k] == pytest.approx(good["metrics"][0][k],
                                                     rel=1e-6), k
    errs = _update_errors(bad["tensors"], good["tensors"], init,
                          CHECKED_PARAMS, 1e-2)
    assert max(errs.values()) > 1, errs


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_one_process(runs, case):
    out, _, inits = runs
    _, _, names, rtols, upd_tol, bank_atol = CASES[case]
    pair = out[case]
    _assert_ranks_equal(pair)
    cfg, init, batches = inits[case]
    one = torch_dp_ranks.train_steps(cfg, init, batches, device="cpu")
    _assert_metrics(pair[0]["metrics"], one["metrics"], rtols)
    errs = _update_errors(pair[0]["tensors"], one["tensors"], init, names,
                          upd_tol)
    assert max(errs.values()) <= 1, errs
    _assert_bank(pair[0]["memory"], one["memory"], bank_atol)
    if case == "empty_group":  # rank 1's groups are empty, rank 0's not
        assert one["metrics"][0]["sem_ann_loss"] > 0

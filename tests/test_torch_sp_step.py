"""Height-sharded training (tpu.spatial_partition 2, spml_tpu_torch/
parallel/halo.py) on gloo ranks on the CPU: one spawn of 2 ranks (data 1
x space 2) and one of 4 (data 2 x space 2), each running every case on
the tiny network (panoptic_deeplab_10, 8-d, crop 32: 16 image rows a
rank, 2 rows of res5 a rank, so ASPP's dilation 24 reads rows two ranks
away and beyond the image) and a global batch of 4:

* the embedding network's train-mode forward in float32 (embeddings,
  location features, BN running statistics), the ranks' rows joined,
  against the JAX package's EmbeddingModel applied under jax.jit to an
  input that spml_tpu.parallel.mesh.batch_sharding places on a (data 2,
  space 2) CPU mesh: tests/test_torch_models.py's train-mode tolerances
  (rtol 1e-4 / atol 1e-5 x max|ref|, statistics rtol 1e-4 / atol 1e-6;
  the location features, a linspace of either library, rtol 1e-5 /
  atol 1e-6 as that file holds them);
* every parameter gradient of sum(embeddings x a seeded cotangent),
  summed over the ranks, against the port's one process, in float64 on
  both sides (float32 would let a ReLU whose input sits within a
  rounding of zero flip, which moves a tiny network's gradient by
  percents): atol 1e-9 x max|ref|, and so the embeddings and statistics;
  the location features (the rows of one global grid) torch.equal;
* two softmax-baseline steps (network.prediction_types
  softmax_classifier, train.batch_size 2: two loss groups) against the
  JAX package's one-device make_train_step, which
  tests/test_spatial_partition.py holds equal to its (data, space)
  step; two stage-2 classifier steps against the JAX package's; a
  remat_stages (4,) softmax case against the port's one process.
  tests/test_torch_classifier_step.py's tolerances: metrics rtol 1e-4,
  the updates of the tensors it checks within 1e-2 x max|update| plus
  one float32 spacing; the ranks' tensors torch.equal. Against JAX's
  softmax steps each update's tolerance adds JAX's own float32 spread,
  as tests/test_torch_dp_step.py adds it: how far JAX's jitted steps
  move with the batch's images in another order. At this global batch
  of two loss groups that spread is 12 tolerances on
  res3.0.conv2.weight and 2.7 on res4.0.bn1.weight (JAX's eager steps
  and the port's one process lie as far from the jitted steps), and
  1e-3 of a tolerance or less elsewhere.
"""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spml_tpu.config import load_config as jload_config
from spml_tpu.models.embeddings import ClassifierHead
from spml_tpu.models.embeddings import build_embedding_model as jbuild
from spml_tpu.parallel import mesh as jmesh
from spml_tpu.train import classifier_step as jcstep
from spml_tpu.train import step as jstep
from spml_tpu_torch.config import load_config
from spml_tpu_torch.parallel import mesh as mesh_lib
from spml_tpu_torch.utils import from_jax
import torch_sp_ranks
from test_torch_train_step import _state_dicts

B_GLOBAL = 4
SOFTMAX = {
    "network": {"backbone_types": "panoptic_deeplab_10", "embedding_dim": 8,
                "kmeans_num_clusters": [1, 1], "kmeans_iterations": 0,
                "prediction_types": "softmax_classifier"},
    "dataset": {"num_classes": 4},
    "train": {"batch_size": 2, "crop_size": [32, 32], "max_iteration": 100,
              "warmup_iteration": 10},
    "tpu": {"segment_capacity": 32, "compute_dtype": "float32",
            "spatial_partition": 2},
}
REMAT = copy.deepcopy(SOFTMAX)
REMAT["tpu"]["remat_stages"] = (4,)
CHECKED = [  # tests/test_torch_classifier_step.py's softmax-branch checks
    "embedding.resnet_backbone.res3.0.conv2.weight",
    "embedding.resnet_backbone.res4.0.bn1.weight",
    "embedding.resnet_backbone.res5.0.bn2.running_mean",
    "embedding.aspp.aspp_1.0.weight", "embedding.aspp.aspp_3.0.bias",
    "prediction.semantic_classifier.0.weight",
    "prediction.semantic_classifier.1.running_var",
    "prediction.semantic_classifier.4.bias"]
FROZEN = ["embedding.resnet_backbone.conv1.conv1.0.weight",
          "embedding.resnet_backbone.res2.0.conv2.weight"]
MESHES = {"1x2": 2, "2x2": 4}  # data x space -> ranks


def _batch(seed):
    rng = np.random.RandomState(seed)
    return {
        "image": rng.randn(B_GLOBAL, 32, 32, 3).astype(np.float32),
        "semantic_label": rng.choice([0, 1, 2, 3, 255],
                                     (B_GLOBAL, 32, 32)).astype(np.int64),
        "instance_label": rng.randint(0, 3,
                                      (B_GLOBAL, 32, 32)).astype(np.int64),
        "semantic_tag": (rng.rand(B_GLOBAL, 256) > 0.6).astype(np.int64)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def inputs():
    """Everything both sides start from: the JAX models and states, their
    weights converted for the port, the batches and the cotangent."""
    rng = np.random.RandomState(7)
    images = rng.randn(B_GLOBAL, 32, 32, 3).astype(np.float32)
    cot = rng.randn(B_GLOBAL, 8, 8, 8)
    jcfg = jload_config(overrides=SOFTMAX)
    jst = jstep.init_state(jcfg, jax.random.PRNGKey(0),
                           jnp.zeros((B_GLOBAL, 32, 32, 3)))
    init = _state_dicts(jst.params, jst.batch_stats)
    emb_def = jstep.build_models(jcfg)[0]
    # the step's embedding weights; BN momentum flax 0.9 (torch 0.1) so
    # that the running statistics visibly move in one forward
    jmodel = jbuild("panoptic_deeplab_10", 8, dtype=jnp.float32,
                    bn_momentum=0.9)
    jvars = {"params": _np(jst.params["embedding"]),
             "batch_stats": _np(jst.batch_stats["embedding"])}
    emb_init = from_jax.embedding_state_dict(jvars["params"],
                                             jvars["batch_stats"])
    emb64 = {k: v.double() if v.is_floating_point() else v
             for k, v in emb_init.items()}
    # stage 2: the same embedding, frozen, and a head of its own
    evars, frozen = jvars, emb_init
    jcst = jcstep.init_classifier_state(jcfg, jax.random.PRNGKey(2), 8)
    head = from_jax.classifier_state_dict(
        _np(jcst.params["prediction"]), _np(jcst.batch_stats["prediction"]))
    return dict(images=images, cot=cot, jmodel=jmodel, jvars=jvars,
                emb_init=emb_init, emb64=emb64, jcfg=jcfg, jst=jst,
                init=init, emb_def=emb_def, evars=evars, jcst=jcst,
                frozen=frozen, head=head,
                batches=[_batch(3), _batch(4)])


def _jobs(inp, remat):
    cfg, rcfg = load_config(overrides=SOFTMAX), load_config(overrides=REMAT)
    jobs = [
        ("forward_backward", ("panoptic_deeplab_10", 8, inp["emb_init"],
                              inp["images"], inp["cot"].astype(np.float32),
                              2)),
        ("forward_backward", ("panoptic_deeplab_10", 8, inp["emb64"],
                              inp["images"].astype(np.float64), inp["cot"],
                              2)),
        ("softmax_steps", (cfg, inp["init"], inp["batches"])),
        ("classifier_steps", (cfg, inp["frozen"], inp["head"],
                              inp["batches"]))]
    if remat:
        jobs.append(("softmax_steps", (rcfg, inp["init"], inp["batches"])))
    return jobs


@pytest.fixture(scope="module")
def runs(inputs):
    """{mesh: every rank's results of every job}, each mesh spawned once;
    the remat case on the 2-rank mesh alone."""
    return {name: mesh_lib.spawn(torch_sp_ranks.many,
                                 (_jobs(inputs, name == "1x2"),),
                                 ["cpu"] * n)
            for name, n in MESHES.items()}


def _assert_ranks_equal(ranks, job, key):
    first = ranks[0][job][key]
    for r in ranks[1:]:
        for k, v in first.items():
            assert torch.equal(v, r[job][key][k]), (job, k)


@pytest.fixture(scope="module")
def jax_forward(inputs):
    """JAX's train-mode forward on a (data 2, space 2) CPU mesh."""
    jm = jmesh.make_mesh(num_devices=4, spatial=2)
    assert jm.shape == {"data": 2, "space": 2}
    x = jax.device_put(jnp.asarray(inputs["images"]),
                       jmesh.batch_sharding(jm, 4, "image"))
    fn = jax.jit(lambda v, im: inputs["jmodel"].apply(
        v, im, train=True, mutable=["batch_stats"]))
    return fn(jmesh.device_put_replicated(inputs["jvars"], jm), x)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_forward_matches_jax_on_a_data_space_mesh(inputs, runs, jax_forward,
                                                  mesh):
    got = runs[mesh][0][0]
    (emb, loc), mut = jax_forward
    want = np.asarray(emb)
    np.testing.assert_allclose(got["emb"].numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got["loc"].numpy(), np.asarray(loc),
                               rtol=1e-5, atol=1e-6)
    new = from_jax.embedding_state_dict(inputs["jvars"]["params"],
                                        _np(mut["batch_stats"]))
    assert set(got["stats"]) == {k for k in new if "running" in k}
    for k, v in got["stats"].items():
        np.testing.assert_allclose(v.numpy(), new[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    for r in runs[mesh]:  # every rank joined the same global batch
        assert torch.equal(r[0]["emb"], got["emb"])


@pytest.fixture(scope="module")
def one_process64(inputs):
    return torch_sp_ranks.forward_backward(
        "panoptic_deeplab_10", 8, inputs["emb64"],
        inputs["images"].astype(np.float64), inputs["cot"], 2, device="cpu")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_float64_gradients_match_one_process(one_process64, runs, mesh):
    got, want = runs[mesh][0][1], one_process64
    assert got["emb"].dtype == torch.float64
    assert torch.equal(got["loc"], want["loc"])
    np.testing.assert_allclose(got["emb"].numpy(), want["emb"].numpy(),
                               rtol=0, atol=1e-9 * float(want["emb"].abs()
                                                         .max()))
    for k, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-9 * float(v.abs().max()),
                                   err_msg=k)
    assert got["grads"].keys() == want["grads"].keys()
    for k, v in want["grads"].items():
        assert float(v.abs().max()) > 0, k
        np.testing.assert_allclose(got["grads"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-9 * float(v.abs().max()),
                                   err_msg=k)


def _assert_steps(got, want_metrics, want, before, floor=None):
    """Metrics rtol 1e-4; each tensor's update within 1e-2 max|update|
    plus one float32 spacing, plus floor[name] where given."""
    assert len(got["metrics"]) == len(want_metrics)
    for i, (g, w) in enumerate(zip(got["metrics"], want_metrics)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    for k in want:
        upd = np.asarray(want[k], np.float64) - before[k].numpy()
        diff = np.abs(got[k].numpy() - np.asarray(want[k], np.float64))
        tol = (1e-2 * max(np.abs(upd).max(), 1e-6)
               + np.spacing(np.abs(want[k].numpy()).max())
               + (floor or {}).get(k, 0.0))
        assert diff.max() <= tol, (k, diff.max(), tol)


FLOOR_ORDERS = ([2, 3, 0, 1], [1, 0, 3, 2])  # groups swapped; within


def _jax_softmax_steps(inputs, fn, order=(0, 1, 2, 3)):
    jst, metrics = inputs["jst"], []
    for nb in inputs["batches"]:
        jst, m = fn(jst, {k: jnp.asarray(v[list(order)])
                          for k, v in nb.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _state_dicts(jst.params, jst.batch_stats)


@pytest.fixture(scope="module")
def jax_softmax(inputs):
    """JAX's two jitted steps, and each checked tensor's float32 floor:
    how far the same steps are from them with the batch's images in
    another order (FLOOR_ORDERS: the two loss groups swapped, the images
    within each swapped), which runs every reduction over the batch in
    another order and none of the port. At this global batch that floor
    is 12 tolerances on res3.0.conv2.weight and 2.7 on res4.0.bn1.weight,
    whose updates are sums that mostly cancel (JAX's eager steps lie as
    far from its jitted ones, and so does the port's one process)."""
    fn = jax.jit(jstep.make_train_step(
        inputs["jcfg"], inputs["emb_def"],
        ClassifierHead(num_classes=4, hidden_dim=16, dropout_rate=0.0,
                       dtype=jnp.float32)))
    metrics, want = _jax_softmax_steps(inputs, fn)
    floor = dict.fromkeys(CHECKED, 0.0)
    for order in FLOOR_ORDERS:
        other = _jax_softmax_steps(inputs, fn, order)[1]
        for k in CHECKED:
            floor[k] = max(floor[k], float(np.abs(
                np.asarray(want[k], np.float64)
                - np.asarray(other[k], np.float64)).max()))
    return metrics, want, floor


@pytest.mark.parametrize("mesh", list(MESHES))
def test_softmax_steps_match_jax(inputs, runs, jax_softmax, mesh):
    metrics, sd, floor = jax_softmax
    got = runs[mesh][0][2]
    _assert_ranks_equal(runs[mesh], 2, "tensors")
    _assert_steps({"metrics": got["metrics"], **got["tensors"]}, metrics,
                  {k: sd[k] for k in CHECKED}, inputs["init"], floor)
    for k in FROZEN:
        assert torch.equal(got["tensors"][k], inputs["init"][k]), k


@pytest.fixture(scope="module")
def jax_classifier(inputs):
    """JAX's two jitted stage-2 steps: metrics and the head after."""
    jfn = jax.jit(jcstep.make_classifier_train_step(
        inputs["jcfg"], inputs["emb_def"], inputs["evars"],
        ClassifierHead(num_classes=4, hidden_dim=16, dropout_rate=0.0,
                       dtype=jnp.float32)))
    jst, metrics = inputs["jcst"], []
    for nb in inputs["batches"]:
        jst, m = jfn(jst, {k: jnp.asarray(v) for k, v in nb.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    want = from_jax.classifier_state_dict(
        _np(jst.params["prediction"]), _np(jst.batch_stats["prediction"]))
    return metrics, {k: v for k, v in want.items()
                     if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_classifier_steps_match_jax(inputs, runs, jax_classifier, mesh):
    metrics, want = jax_classifier
    got = runs[mesh][0][3]
    _assert_ranks_equal(runs[mesh], 3, "head")
    _assert_steps({"metrics": got["metrics"], **got["head"]}, metrics, want,
                  inputs["head"])


def test_remat_stages_match_one_process(inputs, runs):
    cfg = load_config(overrides=REMAT)
    one = torch_sp_ranks.softmax_steps(cfg, inputs["init"],
                                       inputs["batches"], device="cpu")
    got = runs["1x2"][0][4]
    _assert_ranks_equal(runs["1x2"], 4, "tensors")
    _assert_steps(got["tensors"] | {"metrics": got["metrics"]},
                  one["metrics"],
                  {k: one["tensors"][k] for k in CHECKED}, inputs["init"])

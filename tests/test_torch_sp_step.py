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
* two SegSort steps (network.prediction_types segsort, train.batch_size
  2) in each of four arms against the JAX package's one-device
  make_train_step (its Pallas kernels in interpret mode): the dense
  losses (tpu.use_fused_loss off, tests/test_train_step.py's
  _tiny_config) and, with tests/test_torch_train_step.py's
  configuration (memory_bank_size 1), the fused joint loss (K1-K3), the
  hard-label loss (sem_occ off: K4-K6) and the tag-set loss (sem_ann
  off: K7-K9), the port through their plain versions.
  tests/test_torch_dp_step.py's tolerances for the same comparison:
  metrics (the losses, num_segments) rtol 1e-4, the updates of the
  tensors it checks within 1e-2 x max|update| plus one float32 unit of
  the tensor's largest value, the bank's labels, batch indices, tags and
  validity equal and its prototypes atol 2e-3; the ranks' tensors and
  banks torch.equal. As for the softmax steps, each update's tolerance
  adds JAX's own float32 spread over FLOOR_ORDERS: res3.0.conv2.weight
  moves 1.77 tolerances there in the dense arm, as far as the port's
  one process lies from JAX's step. In the tag-set arm, step 2's
  sem_occ and img_sim losses, which XLA's fusions under jit move by
  2.3e-4 and 1.2e-4 relative from JAX's eager step
  (tests/test_torch_tag_step.py), are held at rtol 1e-4 of the port's
  one process, which that file holds to JAX's eager step at rtol 1e-4;
* one dense SegSort step in float64 (the models, the bank and the
  images) against the port's one process: each rank's k-means Segments,
  its rows of the pixel fields joined over the space ranks and the
  segment fields the same on each, equal the one process's exactly;
  the bank (the gathered prototypes) and every parameter gradient
  within 1e-9 x max|ref|.
* uneven height shards, on the 1 x 2 mesh alone: crop 40 (res5's 5 rows
  as 2 and 3, the embeddings' 10 as 5 and 5, whose rows read the other
  rank's res5 rows): a softmax-baseline step and a step of the fused
  joint arm against the JAX package's one-device steps at crop 40
  (which equal its sharded ones: GSPMD's padding enters no result), at
  the tolerances above with the same kind of floor; and the joint arm
  with the dense losses in float64 against the port's one process at
  crop 40, as the float64 step above.
* space ranks that hold no row of a map, as 1 x 4 jobs of the 4-rank
  spawn (each job builds its own mesh): crop 24 (the stride-8 map's 3
  rows as none, 1, 1, 1; the x2 upsample gives rank 0 an embedding row
  that it reads from ranks 1 and 2): a softmax-baseline step, a stage-2
  classifier step, a fused joint step, and the joint step (K1-K3) and
  the tags-only step (sem_ann off, K7-K9) with tpu.loss_operand_dtype
  "bfloat16", against the JAX package's one-device steps at crop 24
  (its bf16 kernels in interpret mode), at the tolerances above with
  the same kind of floor, but for
  the SegSort steps' img_sim loss: on this batch it lies 7e-5 (JAX's
  jitted step), 1.3e-4 (JAX's eager step) and 8.4e-5 (the port's one
  process) from the port's float64 step, 1.5e-4 between the port and
  JAX's jitted step, so it is held at rtol 1e-4 against the port's one
  process in float32 (as JIT_MOVED's are), which the float64 steps tie
  to the sharded one; crop 16 (stride 8: none, 1, none, 1) and crop 8
  (the embeddings' 2 rows as none, 1, none, 1: ranks 0 and 2 run
  k-means, the losses and the kernels' plain versions on no pixel), a
  dense SegSort step in float64 against the port's one process, as the
  float64 step above; and the port's batch norm over the rows of a
  3-row map, rank 0 counting no pixel: finite, and its output,
  gradients and running statistics within 1e-12 of one process's.

The spawns run in a thread while this process computes the JAX
references; each must join within torch_sp_ranks.SPAWN_TIMEOUT
seconds (a rank that skips a collective the others enter hangs them).
"""

import copy
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spml_tpu.config import load_config as jload_config
from spml_tpu.models.embeddings import ClassifierHead
from spml_tpu.models.embeddings import build_embedding_model as jbuild
from spml_tpu.ops.pallas import segsort_loss as jfused
from spml_tpu.parallel import mesh as jmesh
from spml_tpu.train import classifier_step as jcstep
from spml_tpu.train import step as jstep
from spml_tpu_torch.config import load_config
from spml_tpu_torch.ops.kmeans import Segments
from spml_tpu_torch.parallel import mesh as mesh_lib
from spml_tpu_torch.utils import from_jax
import torch_sp_ranks
from test_torch_train_step import CHECKED_PARAMS, CHECKED_STATS
from test_torch_train_step import OVERRIDES as TRAIN_OVERRIDES
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
DENSE = {  # tests/test_train_step.py::_tiny_config(batch=2, crop=32)
    "network": {"backbone_types": "panoptic_deeplab_10", "embedding_dim": 8,
                "kmeans_num_clusters": [2, 2], "kmeans_iterations": 3},
    "dataset": {"num_classes": 4},
    "train": {"batch_size": 2, "crop_size": [32, 32], "memory_bank_size": 1,
              "max_iteration": 100, "warmup_iteration": 10, "base_lr": 3e-3},
    "tpu": {"segment_capacity": 32, "compute_dtype": "float32"},
}
JOINT = copy.deepcopy(TRAIN_OVERRIDES)  # use_fused_loss, memory_bank_size 1
HARD = copy.deepcopy(JOINT)
HARD["train"]["sem_occ_loss_types"] = "none"
TAG_SET = copy.deepcopy(JOINT)
TAG_SET["train"].update(sem_ann_loss_types="none", sem_occ_concentration=8.0)
ARMS = {"dense": DENSE, "joint": JOINT, "hard": HARD, "tag_set": TAG_SET}
SEG_CHECKED = CHECKED_PARAMS + CHECKED_STATS
N_JOBS = 4  # the jobs before the SegSort ones (_jobs)
UNEVEN_CROP = 40  # res5: 5 rows over the 2 space ranks, 2 and 3


def _at_crop(overrides, crop=UNEVEN_CROP, **tpu):
    over = copy.deepcopy(overrides)
    over["train"]["crop_size"] = [crop, crop]
    over["tpu"].update(tpu)
    return over


UNEVEN = {"softmax": _at_crop(SOFTMAX), "joint": _at_crop(JOINT)}
UNEVEN64 = _at_crop(JOINT, use_fused_loss=False)  # float64: dense losses
ROWS_CROP = 24  # over 4 space ranks: res5's 3 rows as none, 1, 1, 1
ROWS = {"softmax": _at_crop(SOFTMAX, ROWS_CROP),
        "joint": _at_crop(JOINT, ROWS_CROP),
        "joint_bf16": _at_crop(JOINT, ROWS_CROP,
                               loss_operand_dtype="bfloat16"),
        "tags_bf16": _at_crop(TAG_SET, ROWS_CROP,
                              loss_operand_dtype="bfloat16")}
ROWS_ARMS = ("joint", "joint_bf16", "tags_bf16")  # SegSort steps vs JAX
ROWS64 = {16: _at_crop(DENSE, 16), 8: _at_crop(DENSE, 8)}  # float64


def _batch(seed, crop=32):
    rng = np.random.RandomState(seed)
    return {
        "image": rng.randn(B_GLOBAL, crop, crop, 3).astype(np.float32),
        "semantic_label": rng.choice([0, 1, 2, 3, 255],
                                     (B_GLOBAL, crop, crop)).astype(np.int64),
        "instance_label": rng.randint(0, 3,
                                      (B_GLOBAL, crop, crop)).astype(np.int64),
        "semantic_tag": (rng.rand(B_GLOBAL, 256) > 0.6).astype(np.int64)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _spatial(overrides, space=2):
    over = copy.deepcopy(overrides)
    over["tpu"]["spatial_partition"] = space
    return over


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
    # the SegSort arms: one JAX initial state serves all four (the same
    # network, bank and optimizer; init_state reads nothing else)
    acfgs = {name: jload_config(overrides=over)
             for name, over in ARMS.items()}
    assert len({(c.network.embedding_dim, c.train.memory_bank_size,
                 c.tpu.segment_capacity, c.train.optimizer)
                for c in acfgs.values()}) == 1
    ast = jstep.init_state(acfgs["dense"], jax.random.PRNGKey(0),
                           jnp.zeros((B_GLOBAL, 32, 32, 3)))
    ainit = _state_dicts(ast.params, ast.batch_stats)
    arms = {name: (c, ast, ainit) for name, c in acfgs.items()}
    init64 = {k: v.double() if v.is_floating_point() else v
              for k, v in arms["dense"][2].items()}
    return dict(images=images, cot=cot, jmodel=jmodel, jvars=jvars,
                emb_init=emb_init, emb64=emb64, jcfg=jcfg, jst=jst,
                init=init, emb_def=emb_def, evars=evars, jcst=jcst,
                frozen=frozen, head=head, arms=arms, init64=init64,
                batches=[_batch(3), _batch(4)],
                uneven=[_batch(5, UNEVEN_CROP)],
                rows=[_batch(6, ROWS_CROP)],
                rows64={crop: [_batch(crop, crop)] for crop in ROWS64},
                bn=_bn_inputs())


def _bn_inputs():
    """batch_norm_rows' map [2, 4, 3, 5] (3 rows over 4 ranks), its
    cotangent, weight and bias, in float64."""
    rng = np.random.RandomState(11)
    return (rng.randn(2, 4, 3, 5) * 2 + 1, rng.randn(2, 4, 3, 5),
            rng.uniform(0.5, 1.5, 4), rng.randn(4))


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
    jobs += [("segsort_steps", (load_config(overrides=_spatial(over)),
                                inp["arms"][name][2], inp["batches"]))
             for name, over in ARMS.items()]
    jobs.append(("segsort_steps", (load_config(overrides=_spatial(DENSE)),
                                   inp["init64"], inp["batches"][:1], True)))
    if remat:  # the 1 x 2 mesh: remat, then the uneven height's jobs
        jobs.append(("softmax_steps", (rcfg, inp["init"], inp["batches"])))
        jobs += [
            ("softmax_steps", (load_config(overrides=_spatial(
                UNEVEN["softmax"])), inp["init"], inp["uneven"])),
            ("segsort_steps", (load_config(overrides=_spatial(
                UNEVEN["joint"])), inp["arms"]["joint"][2],
                inp["uneven"])),
            ("segsort_steps", (load_config(overrides=_spatial(UNEVEN64)),
                               inp["init64"], inp["uneven"][:1], True))]
        return jobs
    # the 4-rank spawn: 1 x 4 jobs, ranks that hold no row of a map
    def rows(over):
        return load_config(overrides=_spatial(over, 4))
    jobs += [
        ("softmax_steps", (rows(ROWS["softmax"]), inp["init"], inp["rows"])),
        ("classifier_steps", (rows(ROWS["softmax"]), inp["frozen"],
                              inp["head"], inp["rows"]))]
    jobs += [("segsort_steps", (rows(ROWS[arm]), inp["arms"]["joint"][2],
                                inp["rows"])) for arm in ROWS_ARMS]
    jobs += [("segsort_steps", (rows(ROWS64[crop]), inp["init64"],
                                inp["rows64"][crop], True))
             for crop in ROWS64]
    jobs.append(("batch_norm_rows", (*inp["bn"], 4)))
    return jobs


SEG_JOBS = {name: N_JOBS + i for i, name in enumerate(ARMS)}
F64_JOB = N_JOBS + len(ARMS)
REMAT_JOB = F64_JOB + 1
UNEVEN_JOBS = {"softmax": REMAT_JOB + 1, "joint": REMAT_JOB + 2,
               "float64": REMAT_JOB + 3}
ROWS_JOBS = {name: REMAT_JOB + i for i, name in enumerate(
    ("softmax", "classifier", *ROWS_ARMS, *(f"float64_{c}" for c in ROWS64),
     "batch_norm"))}  # in the 4-rank spawn, after its F64_JOB


@pytest.fixture(scope="module")
def spawned(inputs):
    """The meshes' spawns (each mesh once, the remat case on the 2-rank
    mesh alone), started in a thread so that the JAX references are
    computed while the ranks run: a future of {mesh: every rank's
    results of every job}."""
    pool = ThreadPoolExecutor(1)
    yield pool.submit(lambda: {
        name: mesh_lib.spawn(torch_sp_ranks.many,
                             (_jobs(inputs, name == "1x2"),), ["cpu"] * n,
                             timeout=torch_sp_ranks.SPAWN_TIMEOUT)
        for name, n in MESHES.items()})
    pool.shutdown()


@pytest.fixture(scope="module")
def runs(spawned, jax_forward, jax_softmax, jax_classifier, jax_segsort,
         one_process_segsort, jax_uneven, jax_rows):
    """The spawns' results, taken after every JAX reference."""
    return spawned.result()


def _assert_ranks_equal(ranks, job, key):
    first = ranks[0][job][key]
    for r in ranks[1:]:
        for k, v in first.items():
            assert torch.equal(v, r[job][key][k]), (job, k)


@pytest.fixture(scope="module")
def jax_forward(inputs, spawned):
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


def _jax_softmax_steps(inputs, fn, order=(0, 1, 2, 3), batches="batches"):
    jst, metrics = inputs["jst"], []
    for nb in inputs[batches]:
        jst, m = fn(jst, {k: jnp.asarray(v[list(order)])
                          for k, v in nb.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, _state_dicts(jst.params, jst.batch_stats)


@pytest.fixture(scope="module")
def jax_softmax(inputs, spawned):
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
def jax_classifier(inputs, spawned):
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
    got = runs["1x2"][0][REMAT_JOB]
    _assert_ranks_equal(runs["1x2"], REMAT_JOB, "tensors")
    _assert_steps(got["tensors"] | {"metrics": got["metrics"]},
                  one["metrics"],
                  {k: one["tensors"][k] for k in CHECKED}, inputs["init"])


def _interpret(name):
    orig = getattr(jfused, name)
    return mock.patch.object(
        jfused, name, lambda *a, **k: orig(*a, **{**k, "interpret": True}))


JIT_MOVED = {"tag_set": ("sem_occ_loss", "img_sim_loss")}  # at step 2


@pytest.fixture(scope="module")
def jax_segsort(inputs, spawned):
    """{arm: (metrics of each step, the tensors after, the bank after,
    each checked tensor's float32 floor)} of JAX's two jitted one-device
    SegSort steps; the floor as jax_softmax's."""
    return {name: _jax_segsort_arm(acfg, ast0, inputs["batches"])
            for name, (acfg, ast0, _) in inputs["arms"].items()}


def _jax_segsort_arm(acfg, ast0, batches):
    """(metrics of each step, the tensors after, the bank after, each
    checked tensor's float32 floor) of JAX's jitted one-device SegSort
    steps of `acfg` from ast0 over `batches`."""
    head = ClassifierHead(num_classes=4, hidden_dim=16,
                          dropout_rate=0.0, dtype=jnp.float32)
    with _interpret("fused_joint_losses"), \
            _interpret("fused_segsort_loss"), \
            _interpret("fused_set_segsort_loss"):
        fn = jax.jit(jstep.make_train_step(
            acfg, jstep.build_models(acfg)[0], head))
        runs = []
        for order in ((0, 1, 2, 3),) + FLOOR_ORDERS:
            ast, metrics = ast0, []
            for nb in batches:
                ast, m = fn(ast, {k: jnp.asarray(v[list(order)])
                                  for k, v in nb.items()})
                metrics.append({k: float(v) for k, v in m.items()})
            runs.append((metrics, ast))
    (metrics, ast), others = runs[0], runs[1:]
    want = _state_dicts(ast.params, ast.batch_stats)
    floor = dict.fromkeys(SEG_CHECKED, 0.0)
    for _, other in others:
        sd = _state_dicts(other.params, other.batch_stats)
        for k in SEG_CHECKED:
            floor[k] = max(floor[k], float(np.abs(
                np.asarray(want[k], np.float64)
                - np.asarray(sd[k], np.float64)).max()))
    return (metrics, want,
            {k: np.asarray(v) for k, v in vars(ast.memory).items()}, floor)


@pytest.fixture(scope="module")
def one_process_segsort(inputs, spawned):
    """The port's one-process steps of the arms of JIT_MOVED."""
    return {name: torch_sp_ranks.segsort_steps(
        load_config(overrides=ARMS[name]), inputs["arms"][name][2],
        inputs["batches"], device="cpu") for name in JIT_MOVED}


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_segsort_steps_match_jax(inputs, runs, jax_segsort,
                                 one_process_segsort, mesh, arm):
    moved = {k: one_process_segsort[arm]["metrics"][1][k]
             for k in JIT_MOVED.get(arm, ())}
    _assert_segsort_steps(runs[mesh], SEG_JOBS[arm], jax_segsort[arm],
                          inputs["arms"][arm][2], arm, moved)


def _assert_segsort_steps(ranks, job, ref, init, arm, moved, moved_step=1):
    """A SegSort job's steps against JAX's (ref: _jax_segsort_arm's),
    the metrics `moved` of step moved_step (0: the first) against the
    port's one process instead."""
    metrics, want, bank, floor = ref
    got = ranks[0][job]
    _assert_ranks_equal(ranks, job, "tensors")
    _assert_ranks_equal(ranks, job, "memory")
    assert len(got["metrics"]) == len(metrics)
    for i, (g, w) in enumerate(zip(got["metrics"], metrics)):
        assert set(g) == set(w)
        for k in w:
            expect = moved[k] if i == moved_step and k in moved else w[k]
            np.testing.assert_allclose(g[k], expect, rtol=1e-4, atol=1e-7,
                                       err_msg=f"{arm} step {i} {k}")
    for k in SEG_CHECKED:
        want_k = np.asarray(want[k], np.float64)
        upd = np.abs(want_k - init[k].numpy()).max()
        diff = np.abs(got["tensors"][k].numpy() - want_k).max()
        tol = (1e-2 * upd + np.spacing(np.float32(np.abs(want_k).max()))
               + floor[k])
        assert diff <= tol, (arm, k, diff, tol)
    # the bank holds the global batch once: 4 images of 32 prototypes
    assert got["memory"]["prototype"].shape == (1, B_GLOBAL * 32, 8)
    for name in ("prototype", "prototype_with_loc"):
        np.testing.assert_allclose(got["memory"][name].numpy(), bank[name],
                                   rtol=0, atol=2e-3, err_msg=name)
    for name in ("semantic_label", "instance_label", "batch_index", "tag",
                 "valid"):
        np.testing.assert_array_equal(got["memory"][name].numpy(),
                                      bank[name], err_msg=name)


@pytest.fixture(scope="module")
def one_process_segsort64(inputs):
    return torch_sp_ranks.segsort_steps(
        load_config(overrides=DENSE), inputs["init64"], inputs["batches"][:1],
        True, device="cpu")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_float64_segsort_step_matches_one_process(one_process_segsort64,
                                                  runs, mesh):
    _assert_float64_step(one_process_segsort64, runs[mesh], F64_JOB, 8)


def _assert_float64_step(want, ranks, job, width, space=2):
    """A float64 SegSort job (its first step's Segments, bank and
    gradients) against the port's one process: the Segments equal, the
    rest within 1e-9; width: the embedding grid's columns; space: the
    job's space ranks (its ranks' pixel rows joined in order, a rank's
    rows possibly none)."""
    segs = [r[job]["segments"][0] for r in ranks]
    for f, name in enumerate(Segments._fields):
        ref = want["segments"][0][f]
        if name.startswith("pixel"):  # each data rank's images, by rows
            b = ref.shape[0] // (len(ranks) // space)
            joined = torch.cat([
                torch.cat([s[f].reshape(b, -1, width)
                           for s in segs[d:d + space]], dim=1)
                for d in range(0, len(ranks), space)]).reshape(ref.shape)
        else:
            for d in range(0, len(ranks), space):
                for r in range(d + 1, d + space):
                    assert torch.equal(segs[d][f], segs[r][f]), name
            joined = torch.cat([s[f] for s in segs[::space]])
        assert torch.equal(joined, ref), name
    got = ranks[0][job]
    for k in ("prototype", "prototype_with_loc"):
        ref = want["memory"][k]
        assert ref.dtype == torch.float64
        np.testing.assert_allclose(got["memory"][k].numpy(), ref.numpy(),
                                   rtol=0, atol=1e-9, err_msg=k)
    assert got["grads"].keys() == want["grads"].keys()
    for k, v in want["grads"].items():
        assert v.dtype == torch.float64 and float(v.abs().max()) > 0, k
        np.testing.assert_allclose(got["grads"][k].numpy(), v.numpy(),
                                   rtol=0, atol=1e-9 * float(v.abs().max()),
                                   err_msg=k)


@pytest.fixture(scope="module")
def jax_uneven(inputs, spawned):
    """JAX's jitted one-device steps at crop 40: {"softmax": (metrics,
    tensors, floor) as jax_softmax's, "joint": _jax_segsort_arm's}."""
    jcfg = jload_config(overrides=UNEVEN["softmax"])
    fn = jax.jit(jstep.make_train_step(
        jcfg, jstep.build_models(jcfg)[0],
        ClassifierHead(num_classes=4, hidden_dim=16, dropout_rate=0.0,
                       dtype=jnp.float32)))
    metrics, want = _jax_softmax_steps(inputs, fn, batches="uneven")
    floor = dict.fromkeys(CHECKED, 0.0)
    for order in FLOOR_ORDERS:
        other = _jax_softmax_steps(inputs, fn, order, "uneven")[1]
        for k in CHECKED:
            floor[k] = max(floor[k], float(np.abs(
                np.asarray(want[k], np.float64)
                - np.asarray(other[k], np.float64)).max()))
    acfg = jload_config(overrides=UNEVEN["joint"])
    joint = _jax_segsort_arm(acfg, inputs["arms"]["joint"][1],
                             inputs["uneven"])
    return {"softmax": (metrics, want, floor), "joint": joint}


def test_uneven_softmax_steps_match_jax(inputs, runs, jax_uneven):
    metrics, sd, floor = jax_uneven["softmax"]
    job = UNEVEN_JOBS["softmax"]
    got = runs["1x2"][0][job]
    _assert_ranks_equal(runs["1x2"], job, "tensors")
    _assert_steps({"metrics": got["metrics"], **got["tensors"]}, metrics,
                  {k: sd[k] for k in CHECKED}, inputs["init"], floor)


def test_uneven_joint_steps_match_jax(inputs, runs, jax_uneven):
    _assert_segsort_steps(runs["1x2"], UNEVEN_JOBS["joint"],
                          jax_uneven["joint"], inputs["arms"]["joint"][2],
                          "joint at crop 40", {})


@pytest.fixture(scope="module")
def one_process_uneven64(inputs):
    return torch_sp_ranks.segsort_steps(
        load_config(overrides=UNEVEN64), inputs["init64"],
        inputs["uneven"][:1], True, device="cpu")


def test_uneven_float64_step_matches_one_process(one_process_uneven64,
                                                 runs):
    _assert_float64_step(one_process_uneven64, runs["1x2"],
                         UNEVEN_JOBS["float64"], 10)


@pytest.fixture(scope="module")
def jax_rows(inputs, spawned):
    """JAX's jitted one-device steps at crop 24: {"softmax": (metrics,
    tensors, floor) as jax_softmax's, "classifier": (metrics, head) as
    jax_classifier's, each of ROWS_ARMS: _jax_segsort_arm's}."""
    jcfg = jload_config(overrides=ROWS["softmax"])
    head = ClassifierHead(num_classes=4, hidden_dim=16, dropout_rate=0.0,
                          dtype=jnp.float32)
    fn = jax.jit(jstep.make_train_step(jcfg, jstep.build_models(jcfg)[0],
                                       head))
    metrics, want = _jax_softmax_steps(inputs, fn, batches="rows")
    floor = dict.fromkeys(CHECKED, 0.0)
    for order in FLOOR_ORDERS:
        other = _jax_softmax_steps(inputs, fn, order, "rows")[1]
        for k in CHECKED:
            floor[k] = max(floor[k], float(np.abs(
                np.asarray(want[k], np.float64)
                - np.asarray(other[k], np.float64)).max()))
    out = {"softmax": (metrics, want, floor)}
    cfn = jax.jit(jcstep.make_classifier_train_step(
        jcfg, inputs["emb_def"], inputs["evars"], head))
    jst, cmetrics = inputs["jcst"], []
    for nb in inputs["rows"]:
        jst, m = cfn(jst, {k: jnp.asarray(v) for k, v in nb.items()})
        cmetrics.append({k: float(v) for k, v in m.items()})
    chead = from_jax.classifier_state_dict(
        _np(jst.params["prediction"]), _np(jst.batch_stats["prediction"]))
    out["classifier"] = (cmetrics, {k: v for k, v in chead.items()
                                    if not k.endswith("num_batches_tracked")})
    for arm in ROWS_ARMS:
        out[arm] = _jax_segsort_arm(jload_config(overrides=ROWS[arm]),
                                    inputs["arms"]["joint"][1],
                                    inputs["rows"])
    return out


def test_rows_fewer_than_ranks_softmax_step_matches_jax(inputs, runs,
                                                        jax_rows):
    metrics, sd, floor = jax_rows["softmax"]
    job = ROWS_JOBS["softmax"]
    got = runs["2x2"][0][job]
    _assert_ranks_equal(runs["2x2"], job, "tensors")
    _assert_steps({"metrics": got["metrics"], **got["tensors"]}, metrics,
                  {k: sd[k] for k in CHECKED}, inputs["init"], floor)


def test_rows_fewer_than_ranks_classifier_step_matches_jax(inputs, runs,
                                                           jax_rows):
    metrics, want = jax_rows["classifier"]
    job = ROWS_JOBS["classifier"]
    got = runs["2x2"][0][job]
    _assert_ranks_equal(runs["2x2"], job, "head")
    _assert_steps({"metrics": got["metrics"], **got["head"]}, metrics, want,
                  inputs["head"])


ROWS_MOVED = ("img_sim_loss",)  # held against the port's one process


@pytest.fixture(scope="module")
def one_process_rows(inputs, spawned):
    """The port's one-process steps of ROWS_ARMS at crop 24."""
    return {arm: torch_sp_ranks.segsort_steps(
        load_config(overrides=ROWS[arm]), inputs["arms"]["joint"][2],
        inputs["rows"], device="cpu") for arm in ROWS_ARMS}


@pytest.mark.parametrize("arm", ROWS_ARMS)
def test_rows_fewer_than_ranks_segsort_step_matches_jax(
        inputs, runs, jax_rows, one_process_rows, arm):
    moved = {k: one_process_rows[arm]["metrics"][0][k] for k in ROWS_MOVED}
    _assert_segsort_steps(runs["2x2"], ROWS_JOBS[arm], jax_rows[arm],
                          inputs["arms"]["joint"][2], f"{arm} at crop 24",
                          moved, moved_step=0)


@pytest.fixture(scope="module")
def one_process_rows64(inputs):
    return {crop: torch_sp_ranks.segsort_steps(
        load_config(overrides=over), inputs["init64"],
        inputs["rows64"][crop], True, device="cpu")
        for crop, over in ROWS64.items()}


@pytest.mark.parametrize("crop", list(ROWS64))
def test_rows_fewer_than_ranks_float64_step_matches_one_process(
        one_process_rows64, runs, crop):
    """Crop 16 over 4: no stride-8 row on ranks 0 and 2; crop 8: no
    embedding row either (k-means and the losses on no pixel there)."""
    ranks = runs["2x2"]
    job = ROWS_JOBS[f"float64_{crop}"]
    grid = 2 * -(-crop // 8)
    if crop == 8:
        assert [r[job]["segments"][0][0].shape[1] for r in ranks] == [
            0, grid, 0, grid]
    _assert_float64_step(one_process_rows64[crop], ranks, job, grid, space=4)


def test_batch_norm_with_a_rank_without_rows_matches_one_process(inputs,
                                                                  runs):
    want = torch_sp_ranks.batch_norm_rows(*inputs["bn"], 4, device="cpu")
    ranks = [r[ROWS_JOBS["batch_norm"]] for r in runs["2x2"]]
    assert [r["rows"] for r in ranks] == [0, 1, 1, 1]
    for got in ranks:
        assert got["finite"]
        for key in ("y", "dx", "dw", "db"):
            np.testing.assert_allclose(
                got[key].numpy(), want[key].numpy(), rtol=0,
                atol=1e-12 * float(want[key].abs().max()), err_msg=key)
        for k, v in want["stats"].items():
            np.testing.assert_allclose(got["stats"][k].numpy(), v.numpy(),
                                       rtol=1e-12, atol=1e-15, err_msg=k)

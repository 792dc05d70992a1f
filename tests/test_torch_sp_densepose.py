"""Height-sharded PSPP and DensePose (tpu.spatial_partition, spml_tpu_torch/
parallel/halo.py, models/spp.py, models/local.py) on gloo ranks on the
CPU: one spawn of 2 ranks (data 1 x space 2) and one of 4 (data 1 x
space 4), each running every case of its mesh, in a thread while this
process computes the JAX references:

* halo.adaptive_avg_pools and PSPP (models/spp.py) in float64 on a
  seeded [2, 8, H, 6] map, the ranks' rows against the whole map in one
  process: H 4, 8, 64 and 5 on space 2 (res5 of crop 32, 64, 512 and
  40; the 6-bin pool's bins straddle the shard boundary, at H 4 and 5
  they overlap, s > H; at 5 the ranks hold 2 and 3 rows), H 4, 8 and 7
  on space 4 (one or two rows a rank, bins spanning several ranks), and
  H 3 and 1 on space 4 (res5 of crop 24 and 8: ranks that hold no row
  still sum their bins, none, over the space group and get the maps).
  The pooled maps (whole on every rank) and the gradient of the sum of
  them times each rank's own cotangent (one process: the
  ranks' cotangents summed); PSPP's output (the ranks' rows joined), its
  input gradient, every parameter gradient summed over the ranks and
  the BN running statistics (momentum 0.1, the pooled maps' BN counting
  each pixel once a rank): all within 1e-12 x max|one process's|;
* DensePose's local features (location, colour blurred 5x5, resized to
  the stride-4 grid, normalized per image) of the ranks' rows of 4
  images, 32 x 32, 64 x 48 and 40 x 48 (on 4 ranks a grid of 10 rows as
  2, 3, 2, 3), and 8 x 8 (on 4 ranks a grid of 2 rows as none, 1,
  none, 1), joined: torch.equal to one process's (the colour is made
  from the gathered whole images);
* one step of the DensePose point recipe at the size of
  tests/test_torch_densepose_step.py (panoptic_pspnet_10_densepose,
  8-d, crop 32: 16 image rows and 2 rows of res5 a rank, batch 2, 2x2
  k-means, capacity 32, the fused loss) on 1 x 2 ranks against the JAX
  package's one-device make_train_step (its Pallas kernels in interpret
  mode), in three arms: the recipe as it ships (the hard-label loss,
  K4-K6's plain version), sem_occ with tpu.apply_feat_aff and a
  one-step bank (NN-propagated tags, the joint loss, the dense
  feat_aff), tpu.loss_operand_dtype "bfloat16" (the hard-label
  loss's bf16-operand plain version against JAX's bf16 kernels), and
  the shipped recipe at crop 40 (uneven shards: res5's 5 rows as 2 and
  3), against JAX's one-device step at crop 40; and the shipped recipe
  at crop 24 on 1 x 4 ranks (res5's 3 rows as none, 1, 1, 1: rank 0
  runs PSPP's branches on no row of its own), against JAX's
  one-device step at crop 24.
  Tolerances, those of tests/test_torch_sp_step.py: metrics rtol 1e-4,
  but img_sim_loss rtol 2e-3 (tests/test_torch_densepose_step.py: its
  concentration of 16 amplifies the flax PSPNet's float32 error, which
  moves it 1.8e-4 between JAX's jitted and eager steps); the update of
  each tensor that file checks within 1e-2 x max|update| plus one
  float32 unit of its largest value plus JAX's own float32 spread (the
  same step with the batch's two images swapped); the bank's labels,
  batch indices, tags and validity equal and its prototypes atol 2e-3;
  the ranks' tensors and banks torch.equal;
* the NN-tags arm in float64 with the dense losses against the port's
  one process: losses, every parameter gradient, the BN running
  statistics (PSPP's among them) and the bank within 1e-7 x max|one
  process's|, the k-means segments equal.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spml_tpu.config import load_config as jload_config
from spml_tpu.models.embeddings import ClassifierHead as JHead
from spml_tpu.ops.pallas import segsort_loss as jfused
from spml_tpu.train import step as jstep
from spml_tpu_torch.config import load_config
from spml_tpu_torch.ops.kmeans import Segments
from spml_tpu_torch.parallel import mesh as mesh_lib
from spml_tpu_torch.train import densepose_point
import torch_sp_ranks
from test_torch_densepose_step import (CHECKED_PARAMS, CHECKED_STATS,
                                       EXACT_MEMORY, OVERRIDES, _interpret)
from test_torch_train_step import _state_dicts

NN_TAGS = copy.deepcopy(OVERRIDES)
NN_TAGS["train"].update(sem_occ_loss_types="segsort", memory_bank_size=1)
NN_TAGS["tpu"]["apply_feat_aff"] = True
BF16 = copy.deepcopy(OVERRIDES)
BF16["tpu"]["loss_operand_dtype"] = "bfloat16"
UNEVEN = copy.deepcopy(OVERRIDES)
UNEVEN["train"]["crop_size"] = [40, 40]
ROWS = copy.deepcopy(OVERRIDES)  # over 4 space ranks: rank 0 holds no
ROWS["train"]["crop_size"] = [24, 24]  # row of res5's 3
ARMS = {"shipped": OVERRIDES, "nn_tags": NN_TAGS, "bf16": BF16,
        "uneven": UNEVEN, "rows": ROWS}
ARM_MESH = {name: "1x4" if name == "rows" else "1x2" for name in ARMS}
ARM_CROP = {name: over["train"]["crop_size"][0]
            for name, over in ARMS.items()}
F64 = copy.deepcopy(NN_TAGS)
F64["tpu"]["use_fused_loss"] = False  # the kernels take float32 alone
CHECKED = CHECKED_PARAMS + CHECKED_STATS
POOL_CASES = {"1x2": (4, 8, 64, 5), "1x4": (4, 8, 7, 3, 1)}  # heights
COLOUR_SHAPES = ((32, 32), (64, 48), (40, 48), (8, 8))
MESHES = {"1x2": 2, "1x4": 4}  # data x space -> ranks (space = ranks)


def _spatial(overrides, space=2):
    over = copy.deepcopy(overrides)
    over["tpu"]["spatial_partition"] = space
    return over


def _mesh_arms(mesh):
    return [name for name in ARMS if ARM_MESH[name] == mesh]


def _jobs(mesh, inp):
    space = MESHES[mesh]
    jobs = [("pspp_case", (h, space)) for h in POOL_CASES[mesh]]
    jobs += [("colour_case", (shape, space)) for shape in COLOUR_SHAPES]
    jobs += [("segsort_steps", (load_config(overrides=_spatial(
        ARMS[name], space)), inp["init"][name],
        [inp["batches"][ARM_CROP[name]]])) for name in _mesh_arms(mesh)]
    if mesh == "1x2":
        jobs.append(("segsort_steps", (load_config(overrides=_spatial(F64)),
                                       inp["init64"], [inp["batch"]], True)))
    return jobs


def _job(mesh, kind, key):
    """The index of a case among _jobs(mesh)."""
    n_pool = len(POOL_CASES[mesh])
    if kind == "pspp":
        return POOL_CASES[mesh].index(key)
    if kind == "colour":
        return n_pool + COLOUR_SHAPES.index(key)
    if kind == "step":
        return n_pool + len(COLOUR_SHAPES) + _mesh_arms(mesh).index(key)
    # the float64 step
    return n_pool + len(COLOUR_SHAPES) + len(_mesh_arms(mesh))


@pytest.fixture(scope="module")
def inputs():
    """The point-labelled batch, the JAX initial states and their weights
    converted for the port (the shipped and bf16 arms share one)."""
    batches = {crop: {k: v.numpy() for k, v in densepose_point.point_batch(
        2, crop, seed=5, device="cpu").items()}
        for crop in sorted(set(ARM_CROP.values()))}
    jinit, init = {}, {}
    for name, over in ARMS.items():
        if name in ("bf16", "uneven", "rows"):  # the shipped arm's state
            jinit[name], init[name] = jinit["shipped"], init["shipped"]
            continue
        jst = jstep.init_state(jload_config(overrides=over),
                               jax.random.PRNGKey(0),
                               jnp.zeros((2, 32, 32, 3)))
        jinit[name] = jst
        init[name] = _state_dicts(jst.params, jst.batch_stats)
    init64 = {k: v.double() if v.is_floating_point() else v
              for k, v in init["nn_tags"].items()}
    return dict(batch=batches[32], batches=batches, jinit=jinit, init=init,
                init64=init64)


@pytest.fixture(scope="module")
def spawned(inputs):
    """Each mesh's spawn, in a thread: a future of {mesh: every rank's
    results of every job}."""
    pool = ThreadPoolExecutor(1)
    yield pool.submit(lambda: {
        mesh: mesh_lib.spawn(torch_sp_ranks.many, (_jobs(mesh, inputs),),
                             ["cpu"] * n,
                             timeout=torch_sp_ranks.SPAWN_TIMEOUT)
        for mesh, n in MESHES.items()})
    pool.shutdown()


@pytest.fixture(scope="module")
def jax_steps(inputs, spawned):
    """{arm: (metrics, tensors after, bank after, each checked tensor's
    float32 floor)} of JAX's jitted one-device step; the floor: its
    difference from the same step with the batch's two images swapped."""
    out = {}
    for name, over in ARMS.items():
        jcfg = jload_config(overrides=over)
        head = JHead(num_classes=15, hidden_dim=16, dropout_rate=0.0,
                     dtype=jnp.float32)
        with _interpret(jfused, "fused_segsort_loss"), \
                _interpret(jfused, "fused_joint_losses"):
            fn = jax.jit(jstep.make_train_step(
                jcfg, jstep.build_models(jcfg)[0], head))
            runs = []
            for order in ([0, 1], [1, 0]):
                jst, m = fn(inputs["jinit"][name], {
                    k: jnp.asarray(v[order]) for k, v in
                    inputs["batches"][ARM_CROP[name]].items()})
                runs.append(({k: float(v) for k, v in m.items()}, jst))
        (metrics, jst), (_, other) = runs
        want = _state_dicts(jst.params, jst.batch_stats)
        swapped = _state_dicts(other.params, other.batch_stats)
        floor = {k: float(np.abs(np.asarray(want[k], np.float64)
                                 - np.asarray(swapped[k], np.float64)).max())
                 for k in CHECKED}
        out[name] = (metrics, want, {k: np.asarray(v) for k, v in
                                     vars(jst.memory).items()}, floor)
    return out


@pytest.fixture(scope="module")
def one_process64(inputs, spawned):
    return torch_sp_ranks.segsort_steps(
        load_config(overrides=F64), inputs["init64"], [inputs["batch"]],
        True, device="cpu")


@pytest.fixture(scope="module")
def runs(spawned, jax_steps, one_process64):
    """The spawns' results, taken after every reference."""
    return spawned.result()


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("mesh,height", [(m, h) for m, hs in
                                         POOL_CASES.items() for h in hs])
def test_sharded_pools_and_pspp_match_the_whole_map(runs, mesh, height):
    want = torch_sp_ranks.pspp_case(height, MESHES[mesh], device="cpu")
    job = _job(mesh, "pspp", height)
    for rank in runs[mesh]:
        got = rank[job]
        assert len(got["pools"]) == 4
        for g, w in zip(got["pools"], want["pools"]):
            assert g.shape == w.shape and _rel(g, w) <= 1e-12
        for key in ("pool_dx", "out", "dx"):
            assert got[key].shape == want[key].shape, key
            assert _rel(got[key], want[key]) <= 1e-12, key
        for part in ("grads", "stats"):
            assert got[part].keys() == want[part].keys()
            for k, v in want[part].items():
                assert float(v.abs().max()) > 0, k
                assert _rel(got[part][k], v) <= 1e-12, (part, k)


@pytest.mark.parametrize("mesh,shape", [(m, s) for m in MESHES
                                        for s in COLOUR_SHAPES])
def test_sharded_colour_features_equal_the_whole_image(runs, mesh, shape):
    want = torch_sp_ranks.colour_case(shape, MESHES[mesh], device="cpu")
    assert want.shape == (4, shape[0] // 4, shape[1] // 4, 5)
    for rank in runs[mesh]:
        assert torch.equal(rank[_job(mesh, "colour", shape)], want)


@pytest.mark.parametrize("arm", list(ARMS))
def test_densepose_step_on_a_space_axis_matches_jax(inputs, runs,
                                                    jax_steps, arm):
    metrics, want, bank, floor = jax_steps[arm]
    job = _job(ARM_MESH[arm], "step", arm)
    ranks = runs[ARM_MESH[arm]]
    got = ranks[0][job]
    for part in ("tensors", "memory"):
        for k, v in got[part].items():
            for rank in ranks[1:]:
                assert torch.equal(v, rank[job][part][k]), (part, k)
    (g,) = got["metrics"]
    assert set(g) == set(metrics)
    if arm == "nn_tags":
        assert {"sem_occ_loss", "feat_aff_loss"} <= set(g)
    for k, w in metrics.items():
        np.testing.assert_allclose(
            g[k], w, rtol=2e-3 if k == "img_sim_loss" else 1e-4, atol=1e-7,
            err_msg=f"{arm} {k}")
    init = inputs["init"][arm]
    for k in CHECKED:
        want_k = np.asarray(want[k], np.float64)
        upd = np.abs(want_k - init[k].numpy()).max()
        diff = np.abs(got["tensors"][k].numpy() - want_k).max()
        tol = (1e-2 * upd + np.spacing(np.float32(np.abs(want_k).max()))
               + floor[k])
        assert diff <= tol, (arm, k, diff, tol)
    for name in ("prototype", "prototype_with_loc"):
        np.testing.assert_allclose(got["memory"][name].numpy(), bank[name],
                                   rtol=0, atol=2e-3, err_msg=name)
    for name in EXACT_MEMORY:
        np.testing.assert_array_equal(got["memory"][name].numpy(),
                                      bank[name], err_msg=name)


def test_float64_densepose_step_matches_one_process(inputs, one_process64,
                                                    runs):
    want, ranks, init64 = one_process64, runs["1x2"], inputs["init64"]
    got = ranks[0][_job("1x2", "f64", None)]
    for k, v in want["metrics"][0].items():
        np.testing.assert_allclose(got["metrics"][0][k], v, rtol=1e-7,
                                   err_msg=k)
    assert {"sem_occ_loss", "feat_aff_loss"} <= set(want["metrics"][0])
    segs = [r[_job("1x2", "f64", None)]["segments"][0] for r in ranks]
    for f, name in enumerate(Segments._fields):
        ref = want["segments"][0][f]
        if name.startswith("pixel"):  # the ranks' rows, in order
            joined = torch.cat([s[f].reshape(ref.shape[0], -1, 8)
                                for s in segs], dim=1).reshape(ref.shape)
        else:
            assert torch.equal(segs[0][f], segs[1][f]), name
            joined = segs[0][f]
        assert torch.equal(joined, ref), name
    assert got["grads"].keys() == want["grads"].keys()
    assert any("pspp" in k for k in want["grads"])
    for k, v in want["grads"].items():
        assert v.dtype == torch.float64 and float(v.abs().max()) > 0, k
        assert _rel(got["grads"][k], v) <= 1e-7, k
    stats = [k for k in want["tensors"] if "running" in k]
    assert any("pspp" in k for k in stats)
    for k in stats:  # within 1e-7 of the largest update of the statistic
        upd = float((want["tensors"][k] - init64[k]).abs().max())
        assert upd > 0, k
        diff = float((got["tensors"][k] - want["tensors"][k]).abs().max())
        assert diff <= 1e-7 * upd, k
    for k in ("prototype", "prototype_with_loc"):
        ref = want["memory"][k]
        assert ref.dtype == torch.float64
        assert _rel(got["memory"][k], ref) <= 1e-7, k

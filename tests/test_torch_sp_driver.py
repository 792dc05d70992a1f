"""The training drivers with tpu.spatial_partition 2 on two gloo ranks on
the CPU (data 1 x space 2: each rank loads the global batch and keeps its
rows), spawned once, against the port's one-process drivers at the same
global batch, on tests/test_torch_driver.py's synthetic world:

* train_spml with the softmax baseline (network.prediction_types
  softmax_classifier), 2 iterations, tensorboard_step 1: every logged
  loss and the accuracy within rtol 1e-4 and the learning rate equal;
  the image panels drawn at every iteration, rank 0 drawing the rows of
  both ranks (the embeddings drawn within 1e-5 x max|ref| of one
  process's: one eval forward); the checkpoint from rank 0 with both
  ranks' generator states; the L2 norm of the update differences over
  every parameter and BN buffer within 1e-2 of the updates' (the
  chip_smoke.py [dp] rule: single tensors whose updates mostly cancel,
  res3.0.conv2.weight here, move by float32 rounding alone, which
  tests/test_torch_sp_step.py measures); the two ranks' tensors
  torch.equal and their dropout generators distinct;
* the same run resumed with train.resume to 3 iterations: its first
  logged iteration is the saved step 2, checkpoints 2 and 3;
* train_classifier over that snapshot, 2 iterations: losses rtol 1e-4,
  each of the head's updates within 1e-2 x max|update| plus one float32
  spacing, the ranks' heads torch.equal;
* train_spml on a SegSort recipe (the fused joint loss, memory bank 1,
  2x2 k-means), 2 iterations and resumed to 3, in the same spawn: every
  logged loss, the accuracy and num_segments within rtol 1e-4, the
  panels drawn by rank 0, the checkpoints from rank 0, the update L2
  within 1e-2 and the ranks torch.equal, as the softmax run;
* train_spml with the softmax baseline at crop 40 (res5's 5 rows as 2
  and 3 over the ranks), 1 iteration, against one process at the
  softmax run's checks;
* the DensePose CLIs' drivers on 6 point-labelled images of 15 classes
  (the point recipe at panoptic_pspnet_10_densepose, 8-d, crop 32,
  batch 2: PSPP's pools and the colour features over the space ranks):
  train_spml with DenseposeTagDataset for 2 iterations, then
  train_classifier with DenseposeClassifierDataset over its snapshot for
  2, against one process at the checks above.
"""

import copy

import numpy as np
import pytest
import torch

from spml_tpu_torch.config import load_config
from spml_tpu_torch.data import synthetic
from spml_tpu_torch.parallel import mesh as mesh_lib
from spml_tpu_torch.train import densepose_point
from spml_tpu_torch.train import step as tstep
from spml_tpu_torch.utils import checkpoint as ckpt
import torch_dp_ranks
import torch_sp_ranks
from test_torch_driver import world  # noqa: F401

SP = {
    "network": {"backbone_types": "panoptic_deeplab_10", "embedding_dim": 8,
                "kmeans_num_clusters": [1, 1], "kmeans_iterations": 0,
                "prediction_types": "softmax_classifier"},
    "dataset": {"num_classes": 5},
    "train": {"batch_size": 2, "crop_size": [32, 32], "max_iteration": 2,
              "snapshot_step": 1000, "tensorboard_step": 1,
              "warmup_iteration": 10},
    "tpu": {"compute_dtype": "float32", "spatial_partition": 2},
    "num_threads": 2,
}
ONE = copy.deepcopy(SP)
ONE["tpu"]["spatial_partition"] = 1
SEGSORT = copy.deepcopy(SP)
SEGSORT["network"].update(prediction_types="segsort",
                          kmeans_num_clusters=[2, 2], kmeans_iterations=2)
SEGSORT["train"]["memory_bank_size"] = 1
SEGSORT["tpu"].update(segment_capacity=32, use_fused_loss=True)
SEGSORT_ONE = copy.deepcopy(SEGSORT)
SEGSORT_ONE["tpu"]["spatial_partition"] = 1
SEGSORT_LOGGED = ("loss", "sem_ann_loss", "sem_occ_loss", "img_sim_loss",
                  "accuracy", "num_segments")
# the DensePose point recipe (train/densepose_point.py) at a tiny size:
# train_spml with DenseposeTagDataset, then train_classifier with
# DenseposeClassifierDataset over its snapshot (the DensePose CLIs)
DENSEPOSE = copy.deepcopy(densepose_point.OVERRIDES)
DENSEPOSE["network"].update(backbone_types="panoptic_pspnet_10_densepose",
                            embedding_dim=8, kmeans_num_clusters=[2, 2],
                            kmeans_iterations=2)
DENSEPOSE["train"].update(batch_size=2, crop_size=[32, 32], max_iteration=2,
                          snapshot_step=1000, tensorboard_step=1,
                          warmup_iteration=10)
DENSEPOSE["tpu"].update(segment_capacity=32, compute_dtype="float32",
                        spatial_partition=2)
DENSEPOSE["num_threads"] = 2
DENSEPOSE_ONE = copy.deepcopy(DENSEPOSE)
DENSEPOSE_ONE["tpu"]["spatial_partition"] = 1
DENSEPOSE_LOGGED = ("loss", "sem_ann_loss", "img_sim_loss", "accuracy",
                    "num_segments")
UNEVEN = copy.deepcopy(SP)  # crop 40: 5 rows at stride 8 over 2 ranks
UNEVEN["train"].update(crop_size=[40, 40], max_iteration=1)
UNEVEN_ONE = copy.deepcopy(UNEVEN)
UNEVEN_ONE["tpu"]["spatial_partition"] = 1


@pytest.fixture(scope="module")
def densepose_world(tmp_path_factory):
    """6 point-labelled images of DensePose's 15 classes."""
    root = tmp_path_factory.mktemp("densepose_world")
    lst = synthetic.write_world(str(root / "data"), 6,
                                shapes=((40, 48), (48, 40)),
                                num_classes=densepose_point.NUM_CLASSES,
                                segments=8, seed=3, points=300)
    return str(root / "data"), lst


def _inits(overrides):
    """The seed-0 models' tensors of a recipe and a head moved off
    them."""
    st = tstep.init_state(load_config(overrides=overrides), 0,
                          torch.zeros(2, 1, 1, 3), "cpu")
    init = torch_dp_ranks.model_tensors(st)
    head = {k: v for k, v in init.items() if k.startswith("prediction.")}
    head = {k: v + 0.01 * torch.randn(v.shape, generator=torch.Generator()
                                      .manual_seed(1))
            if v.is_floating_point() else v for k, v in head.items()}
    return init, head


@pytest.fixture(scope="module")
def runs(world, densepose_world, tmp_path_factory):  # noqa: F811
    _, data, lst = world
    root = tmp_path_factory.mktemp("sp_driver")
    init, head = _inits(ONE)
    dp_init, dp_head = _inits(DENSEPOSE_ONE)
    jobs = [("drivers", (SP, init, head, data, lst, str(root / "sp"),
                         SEGSORT)),
            ("densepose_drivers", (DENSEPOSE, dp_init, dp_head,
                                   *densepose_world, str(root / "sp"))),
            ("train_spml_run", (UNEVEN, init, data, lst,
                                str(root / "sp" / "uneven")))]
    ranks = mesh_lib.spawn(torch_sp_ranks.many, (jobs,), ["cpu", "cpu"],
                           timeout=torch_sp_ranks.SPAWN_TIMEOUT)
    one = torch_sp_ranks.drivers(ONE, init, head, data, lst,
                                 str(root / "one"), SEGSORT_ONE,
                                 device="cpu")
    dp_one = torch_sp_ranks.densepose_drivers(
        DENSEPOSE_ONE, dp_init, dp_head, *densepose_world,
        str(root / "one"), device="cpu")
    uneven_one = torch_sp_ranks.train_spml_run(
        UNEVEN_ONE, init, data, lst, str(root / "one" / "uneven"),
        device="cpu")
    return ([r[0] for r in ranks], one, init, head, root,
            ([r[1] for r in ranks], dp_one, dp_init, dp_head),
            ([r[2] for r in ranks], uneven_one))


def _assert_logged(got, want, names):
    assert [it for it, _ in got] == [it for it, _ in want]
    for (it, g), (_, w) in zip(got, want):
        for k in names:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=f"iter {it} {k}")
        assert g["learning_rate"] == w["learning_rate"]


def _assert_updates(got, want, before, names):
    for k in names:
        upd = (want[k].double() - before[k].double()).abs().max()
        diff = (got[k].double() - want[k].double()).abs().max()
        tol = 1e-2 * upd + np.spacing(np.float32(want[k].abs().max()))
        assert diff <= tol, (k, float(diff), float(tol))


def _assert_update_l2(got, want, before):
    diff2 = upd2 = 0.0
    for k, w in want.items():
        if w.is_floating_point():
            diff2 += float(((got[k].double() - w.double()) ** 2).sum())
            upd2 += float(((w.double() - before[k].double()) ** 2).sum())
    assert diff2 ** 0.5 <= 1e-2 * upd2 ** 0.5, (diff2, upd2)


def _assert_ranks_equal(a, b):
    assert a["tensors"].keys() == b["tensors"].keys()
    for k, v in a["tensors"].items():
        assert torch.equal(v, b["tensors"][k]), k
    timing = ("warmup_secs", "imgs_per_sec")  # each rank's own clock
    assert [(it, {k: v for k, v in m.items() if k not in timing})
            for it, m in a["logged"]] == [
        (it, {k: v for k, v in m.items() if k not in timing})
        for it, m in b["logged"]]


def test_train_spml_on_a_space_axis_matches_one_process(runs):
    ranks, one, init, _, root, _, _ = runs
    a, b = (r["first"] for r in ranks)
    _assert_ranks_equal(a, b)
    assert not torch.equal(a["generator"], b["generator"])
    _assert_logged(a["logged"], one["first"]["logged"],
                   ("loss", "sem_ann_loss", "accuracy"))
    _assert_update_l2(a["tensors"], one["first"]["tensors"], init)
    assert [it for it, _ in a["logged"]] == [0, 1]
    # the panels of both iterations: rank 0 draws both ranks' rows
    assert len(a["drawn"]) == 2 and b["drawn"] == []
    for got, want in zip(a["drawn"], one["first"]["drawn"]):
        assert got.shape == want.shape == (2, 8, 8, 8)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    events = (root / "sp" / "stage1").glob("events.out.tfevents.*")
    assert any(b"embedding_pca/0" in e.read_bytes() for e in events)
    d = str(root / "sp" / "stage1" / "checkpoints")
    saved = ckpt.read(d, 2)
    assert len(saved["rank_generators"]) == 2


def test_resume_on_a_space_axis(runs):
    ranks, one, _, _, root, _, _ = runs
    a, b = (r["resumed"] for r in ranks)
    _assert_ranks_equal(a, b)
    assert [it for it, _ in a["logged"]] == [2]
    _assert_logged(a["logged"], one["resumed"]["logged"],
                   ("loss", "sem_ann_loss", "accuracy"))
    assert ckpt.steps(str(root / "sp" / "stage1" / "checkpoints")) == [2, 3]


def test_train_classifier_on_a_space_axis_matches_one_process(runs):
    ranks, one, _, head, _, _, _ = runs
    a, b = (r["stage2"] for r in ranks)
    _assert_ranks_equal(a, b)
    _assert_logged(a["logged"], one["stage2"]["logged"],
                   ("loss", "accuracy"))
    names = [k for k, v in head.items() if v.is_floating_point()
             and not k.endswith("num_batches_tracked")]
    _assert_updates(a["tensors"], one["stage2"]["tensors"], head, names)


def test_segsort_train_spml_on_a_space_axis_matches_one_process(runs):
    ranks, one, init, _, root, _, _ = runs
    a, b = (r["segsort"] for r in ranks)
    _assert_ranks_equal(a, b)
    assert [it for it, _ in a["logged"]] == [0, 1]
    _assert_logged(a["logged"], one["segsort"]["logged"], SEGSORT_LOGGED)
    _assert_update_l2(a["tensors"], one["segsort"]["tensors"], init)
    assert len(a["drawn"]) == 2 and b["drawn"] == []
    for got, want in zip(a["drawn"], one["segsort"]["drawn"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    a, b = (r["segsort_resumed"] for r in ranks)
    _assert_ranks_equal(a, b)
    assert [it for it, _ in a["logged"]] == [2]
    _assert_logged(a["logged"], one["segsort_resumed"]["logged"],
                   SEGSORT_LOGGED)
    d = str(root / "sp" / "segsort" / "checkpoints")
    assert ckpt.steps(d) == [2, 3]
    assert len(ckpt.read(d, 3)["rank_generators"]) == 2


def test_densepose_drivers_on_a_space_axis_match_one_process(runs):
    """train_spml with DenseposeTagDataset (tools/train_densepose.py's),
    2 iterations, then train_classifier with DenseposeClassifierDataset
    (tools/train_densepose_classifier.py's) over its snapshot, 2
    iterations: the logged losses, accuracy and num_segments within rtol
    1e-4 and the learning rate equal; the stage-1 update L2 within 1e-2
    of the updates', rank 0 drawing both ranks' rows; each of the head's
    updates within 1e-2 x max|update| plus one float32 spacing; the
    ranks torch.equal. The embeddings drawn lie within 1e-4 x max|ref|
    (the other runs' 1e-5 does not hold here): this float32 step's
    updates differ between the ranks and one process by up to 2% of an
    update on single tensors (tests/test_torch_sp_densepose.py holds the
    same step within 1e-7 in float64), which the eval forward after the
    first iteration carries to 3.8e-5 of the panel's max."""
    ranks, one, init, head = runs[-2]
    a, b = (r["stage1"] for r in ranks)
    _assert_ranks_equal(a, b)
    assert [it for it, _ in a["logged"]] == [0, 1]
    _assert_logged(a["logged"], one["stage1"]["logged"], DENSEPOSE_LOGGED)
    _assert_update_l2(a["tensors"], one["stage1"]["tensors"], init)
    assert len(a["drawn"]) == 2 and b["drawn"] == []
    for got, want in zip(a["drawn"], one["stage1"]["drawn"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4 * float(want.abs().max()))
    a, b = (r["stage2"] for r in ranks)
    _assert_ranks_equal(a, b)
    _assert_logged(a["logged"], one["stage2"]["logged"],
                   ("loss", "accuracy"))
    names = [k for k, v in head.items() if v.is_floating_point()
             and not k.endswith("num_batches_tracked")]
    _assert_updates(a["tensors"], one["stage2"]["tensors"], head, names)


def test_uneven_train_spml_on_a_space_axis_matches_one_process(runs):
    """Crop 40 over 2 space ranks (res5's rows 2 and 3): the softmax
    run's checks."""
    ranks, one = runs[-1]
    init = runs[2]
    a, b = ranks
    _assert_ranks_equal(a, b)
    assert [it for it, _ in a["logged"]] == [0]
    _assert_logged(a["logged"], one["logged"],
                   ("loss", "sem_ann_loss", "accuracy"))
    _assert_update_l2(a["tensors"], one["tensors"], init)
    assert len(a["drawn"]) == 1 and b["drawn"] == []
    for got, want in zip(a["drawn"], one["drawn"]):
        assert got.shape == want.shape == (2, 10, 10, 8)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))

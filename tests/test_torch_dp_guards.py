"""The data-parallel layer's ground rules (spml_tpu_torch/parallel/
mesh.py), on the CPU and without JAX:

* the parallel package is under tests/test_torch_guards.py's import scan
  and passes its rules;
* what tpu.spatial_partition > 1 refuses and what it builds
  (parametrised cases): make_mesh(spatial) in a group whose size
  spatial does not divide (ValueError, as the JAX package's make_mesh);
  the SegSort and stage-2 steps of the DeepLab, PSPNet and DensePose
  backbones build, and so do the PSPNet softmax steps, and PSPP runs
  inside halo.sharded (its pools' sum and its conv's halo over a group
  of one rank); crop height 40 (5 rows at stride 8 over 2 ranks)
  builds and 41, which 2 ranks do not divide, raises ValueError;
  the drivers set tpu.num_devices to the
  world size, and one given as neither 1 nor that size raises;
* --device values and backends: 'cuda' raises on a host without a card,
  'cpu:N' is N CPU ranks; NCCL for one card a rank, gloo on the CPU, a
  shared card only by name;
* world size 1 takes no collective: the helpers hand back their input;
  one rank runs in this process without a process group; a torchrun
  environment is joined;
* a rank that raises fails the launch (no fallback to fewer ranks);
* with a card (marked gpu, skipped here): two ranks on the card (NCCL on
  two cards, gloo sharing one) against one process on the card at the
  global batch, float32 with TF32 off, the fused joint loss (K1-K3 at
  the kernels' width 32), tests/test_torch_dp_step.py's tolerances. On a
  CUDA host without JAX:
  `python -m pytest --noconftest -m gpu tests/test_torch_dp_guards.py`.
"""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing

from spml_tpu_torch.config import load_config
from spml_tpu_torch.parallel import mesh as mesh_lib
from spml_tpu_torch.train import classifier_step as cstep
from spml_tpu_torch.train import driver
from spml_tpu_torch.train import step as tstep
import torch_dp_ranks
from test_torch_guards import ROOT, _forbidden, _imported_modules

OVERRIDES = {
    "network": {"backbone_types": "panoptic_deeplab_10", "embedding_dim": 32,
                "kmeans_num_clusters": [2, 2], "kmeans_iterations": 2},
    "dataset": {"num_classes": 4},
    "train": {"batch_size": 2, "crop_size": [32, 32], "memory_bank_size": 1,
              "max_iteration": 100, "warmup_iteration": 10},
    "tpu": {"segment_capacity": 32, "compute_dtype": "float32",
            "use_fused_loss": True},
}


@pytest.mark.parametrize("module", ["parallel/__init__.py",
                                    "parallel/mesh.py"])
def test_parallel_modules_pass_the_import_scan(module):
    path = ROOT / "spml_tpu_torch" / module
    assert path.exists()
    assert [m for m in _imported_modules(path) if _forbidden(m)] == []


def _spatial_config(**network):
    return load_config(overrides={
        **OVERRIDES, "network": {**OVERRIDES["network"], **network},
        "tpu": {**OVERRIDES["tpu"], "spatial_partition": 2}})


@pytest.mark.parametrize("case", ["no dividing group", "segsort branch",
                                  "pspp", "uneven height"])
def test_spatial_partition_raises(case, monkeypatch):
    """What tpu.spatial_partition 2 refuses, and the backbones it no
    longer refuses ("segsort branch", "pspp": the steps build). Outside a
    group of two ranks make_mesh itself refuses; for the others a 2-rank
    mesh stands in for make_mesh's (the guards run before any
    collective)."""
    cfg = _spatial_config(prediction_types="softmax_classifier")
    assert cfg.tpu.spatial_partition == 2 and cfg.tpu.num_devices == 1
    if case == "no dividing group":
        for spatial in (2, 3):
            with pytest.raises(ValueError, match="not divisible"):
                mesh_lib.make_mesh(spatial=spatial)
        with pytest.raises(ValueError, match="not divisible"):
            driver._mesh(cfg)
        with pytest.raises(ValueError, match="not divisible"):
            tstep.make_train_step(cfg)
        return
    monkeypatch.setattr(mesh_lib, "make_mesh",
                        lambda spatial=1: mesh_lib.Mesh(0, 2, spatial))
    if case == "segsort branch":  # every backbone's SegSort step builds
        for backbone in ("panoptic_deeplab_10", "panoptic_pspnet_50",
                         "panoptic_pspnet_10_densepose"):
            cfg = _spatial_config(backbone_types=backbone)
            assert cfg.network.prediction_types == "segsort"
            tstep.make_train_step(cfg)
            cstep.make_classifier_train_step(cfg, torch.nn.Identity())
    elif case == "pspp":  # the PSPNet steps build and PSPP runs sharded
        for backbone in ("panoptic_pspnet_101",
                         "panoptic_pspnet_10_densepose"):
            cfg = _spatial_config(prediction_types="softmax_classifier",
                                  backbone_types=backbone)
            tstep.make_train_step(cfg)
            cstep.make_classifier_train_step(cfg, torch.nn.Identity())
        from spml_tpu_torch.models.spp import PSPP
        from spml_tpu_torch.parallel import halo
        # a group of one rank stands for the space group: the pools' sum
        # over it is the rank's own, the fusing conv's halo rows zeros
        monkeypatch.setattr(mesh_lib.Mesh, "space_group", lambda self: None)
        monkeypatch.setattr(mesh_lib, "group_size", lambda group=None: 1)
        monkeypatch.setattr(halo, "exchange",
                            lambda x, mesh, plans, height, fill:
                            torch.nn.functional.pad(x, (0, 0, 1, 1)))
        with halo.sharded(mesh_lib.Mesh(0, 2, 2)):
            y = PSPP(8, 4).eval()(torch.randn(1, 8, 4, 5), 8)
        assert y.shape == (1, 4, 4, 5) and bool(torch.isfinite(y).all())
    else:  # any height the space ranks divide builds, another raises
        builds = (tstep.make_train_step, driver._mesh,
                  lambda c: cstep.make_classifier_train_step(
                      c, torch.nn.Identity()))
        cfg.train.crop_size = (40, 32)  # 5 rows at stride 8 over 2 ranks
        for build in builds:
            build(cfg)
        cfg.train.crop_size = (41, 32)
        for build in builds:
            with pytest.raises(ValueError,
                               match="multiple of spatial_partition"):
                build(cfg)


@pytest.mark.parametrize("given", [1, 3])
def test_num_devices_is_the_world_size(given):
    cfg = load_config(overrides={**OVERRIDES,
                                 "tpu": {**OVERRIDES["tpu"],
                                         "num_devices": given}})
    if given == 1:
        assert driver._mesh(cfg) == mesh_lib.Mesh()
        assert cfg.tpu.num_devices == 1
        return
    with pytest.raises(ValueError, match="num_devices 3.*1 rank"):
        driver._mesh(cfg)


def test_rank_devices():
    assert mesh_lib.rank_devices("cpu:3") == [torch.device("cpu")] * 3
    assert mesh_lib.rank_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(ValueError, match="at least one"):
        mesh_lib.rank_devices("cpu:0")
    if not torch.cuda.is_available():
        for spec in ("cuda", "cuda:1"):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                mesh_lib.rank_devices(spec)


def test_default_backend():
    cpu, c0, c1 = (torch.device("cpu"), torch.device("cuda", 0),
                   torch.device("cuda", 1))
    assert mesh_lib.default_backend([cpu, cpu]) == "gloo"
    assert mesh_lib.default_backend([c0, c1]) == "nccl"
    for devices in ([c0, c0], [c0, cpu]):
        with pytest.raises(ValueError, match="gloo"):
            mesh_lib.default_backend(devices)


def test_world_one_takes_no_collective():
    assert not dist.is_initialized()
    x = torch.arange(6.0, requires_grad=True)
    assert mesh_lib.all_gather(x) is x and mesh_lib.all_reduce(x) is x
    mesh_lib.barrier()
    assert mesh_lib.make_mesh() == mesh_lib.Mesh(0, 1)
    assert mesh_lib.Mesh(1, 2).shard(8) == slice(4, 8)
    with pytest.raises(ValueError, match="split"):
        mesh_lib.Mesh(0, 2).shard(7)


def test_one_rank_runs_here_without_a_group():
    seen = []

    def fn(a, *, device):
        seen.append((a, device, dist.is_initialized()))
    mesh_lib.launch(fn, (5,), "cpu")
    assert seen == [(5, torch.device("cpu"), False)]


def test_torchrun_environment_is_joined(monkeypatch):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    for k, v in dict(WORLD_SIZE="1", RANK="0", LOCAL_RANK="0",
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    seen = []

    def fn(*, device):
        seen.append((device, dist.is_initialized(), dist.get_backend(),
                     mesh_lib.make_mesh()))
    mesh_lib.launch(fn, (), "cpu")
    assert seen == [(torch.device("cpu"), True, "gloo", mesh_lib.Mesh(0, 1))]
    assert not dist.is_initialized()


def test_a_failed_rank_fails_the_launch():
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 fails"):
        mesh_lib.spawn(torch_dp_ranks.fail_on_rank, (1,), ["cpu", "cpu"])


@pytest.mark.gpu
def test_two_ranks_on_the_card_match_one_process():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from spml_tpu_torch.ops import segsort_loss as fused
    cfg = load_config(overrides=OVERRIDES)
    st = tstep.init_state(cfg, 0, torch.zeros(4, 1, 1, 3), "cpu")
    init = torch_dp_ranks.model_tensors(st)
    rng = np.random.RandomState(3)
    batches = [{
        "image": rng.randn(4, 32, 32, 3).astype(np.float32),
        "semantic_label": rng.randint(0, 5, (4, 32, 32)),
        "instance_label": rng.randint(0, 3, (4, 32, 32)),
        "semantic_tag": (rng.rand(4, 256) > 0.6).astype(np.int64)}
        for _ in range(2)]
    if torch.cuda.device_count() >= 2:
        devices, backend = ["cuda:0", "cuda:1"], None
    else:
        devices, backend = ["cuda:0", "cuda:0"], "gloo"
    a, b = mesh_lib.spawn(torch_dp_ranks.many,
                          ([(cfg, init, batches, None)],), devices,
                          backend)
    a, b = a[0], b[0]
    fused.reset_launch_counts()
    one = torch_dp_ranks.train_steps(cfg, init, batches, device="cuda")
    assert fused.LAUNCHES["joint_stats"] == 2
    for k, v in a["tensors"].items():
        assert torch.equal(v, b["tensors"][k]), k
    for g, w in zip(a["metrics"], one["metrics"]):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-7,
                                       err_msg=k)
    for k, w in one["tensors"].items():
        if not w.is_floating_point():
            assert torch.equal(a["tensors"][k], w), k
            continue
        upd = (w.double() - init[k].double()).abs().max()
        unit = np.spacing(np.float32(w.abs().max()))
        diff = (a["tensors"][k].double() - w.double()).abs().max()
        assert diff <= 1e-2 * upd + unit, k
    for k in ("prototype", "prototype_with_loc"):
        np.testing.assert_allclose(a["memory"][k].numpy(),
                                   one["memory"][k].numpy(), rtol=0,
                                   atol=3e-4, err_msg=k)

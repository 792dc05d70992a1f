"""Around height-sharded training (spml_tpu_torch/parallel/halo.py), on
the CPU unless marked:

* the parallel package's new module passes tests/test_torch_guards.py's
  import scan;
* inference ignores tpu.spatial_partition, as the JAX package's runner
  does (spml_tpu/inference/runner.py:47 builds make_mesh() without it):
  a config with spatial_partition 2 writes the PNGs of one with 1, per
  image and batched, in one process;
* the halo exchange through a process group of 2 and 4 gloo ranks
  (space 2): conv (ASPP's dilation 24 on 2-row shards, the stem's
  stride 2), the max pool and the x4 resize in float64, forward and
  backward, equal the whole operation's rows within 1e-12; also on maps
  of one row, which leave space rank 0 none (its empty results stay in
  the graph: its input gradient comes back, and its backward enters the
  exchanges' collectives);
* with a card (marked gpu, skipped here): the same on the card, two
  ranks (NCCL on two cards, gloo sharing one); and k-means segment
  formation (ops/kmeans.py::segment_batch) over two space ranks on the
  card, in float64, against one process on the CPU: every field of the
  Segments equal. On a CUDA host without JAX:
  `python -m pytest --noconftest -m gpu tests/test_torch_sp_guards.py`.
"""

import argparse
import copy

import numpy as np
import pytest
import torch

from spml_tpu_torch.parallel import mesh as mesh_lib
import torch_sp_ranks
from test_torch_guards import ROOT, _forbidden, _imported_modules


def test_halo_module_passes_the_import_scan():
    path = ROOT / "spml_tpu_torch" / "parallel" / "halo.py"
    assert [m for m in _imported_modules(path) if _forbidden(m)] == []


@pytest.mark.parametrize("world", [2, 4])
def test_halo_exchange_over_gloo_ranks(world):
    for ranks in zip(*mesh_lib.spawn(torch_sp_ranks.halo_ops, (2,),
                                     ["cpu"] * world,
                                     timeout=torch_sp_ranks.SPAWN_TIMEOUT)):
        for y_err, dx_err in ranks:
            assert y_err <= 1e-12 and dx_err <= 1e-12, ranks


@pytest.fixture(scope="module")
def infer_world(tmp_path_factory):
    """Two images, a snapshot and its memory bank (run_prototype)."""
    from test_torch_inference_runner import OVERRIDES, _write_snapshot
    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.data import synthetic
    from spml_tpu_torch.inference import runner

    root = tmp_path_factory.mktemp("sp_infer")
    lst = synthetic.write_world(str(root / "data"), 2,
                                shapes=((48, 64), (48, 64)), num_classes=4,
                                segments=6, seed=1)
    _write_snapshot(str(root / "snap"))

    def args(save):
        return argparse.Namespace(
            snapshot_dir=str(root / "snap"), save_dir=str(save),
            data_dir=str(root / "data"), data_list=lst,
            semantic_memory_dir=str(root / "bank" / "semantic_prototype"))
    runner.run_prototype(args(root / "bank"),
                         load_config(overrides=OVERRIDES), device="cpu")
    return root, args, OVERRIDES


@pytest.mark.parametrize("infer_batch", [1, 2])
def test_inference_ignores_spatial_partition(infer_world, infer_batch):
    from test_torch_batch_inference import _pngs
    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.inference import runner

    root, args, overrides = infer_world
    pngs = {}
    for spatial in (1, 2):
        over = copy.deepcopy(overrides)
        over["tpu"].update(spatial_partition=spatial,
                           infer_batch=infer_batch)
        save = root / f"out{infer_batch}_{spatial}"
        runner.run_knn_inference(args(save), load_config(overrides=over),
                                 device="cpu")
        pngs[spatial] = _pngs(str(save))
    assert len(pngs[1]) == 4 and pngs[1].keys() == pngs[2].keys()
    for k, v in pngs[1].items():
        np.testing.assert_array_equal(pngs[2][k], v, err_msg=str(k))


@pytest.mark.gpu
def test_halo_exchange_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    devices, backend = _card_devices()
    for ranks in zip(*mesh_lib.spawn(torch_sp_ranks.halo_ops, (2,),
                                     devices, backend)):
        for y_err, dx_err in ranks:
            assert y_err <= 1e-12 and dx_err <= 1e-12, ranks


def _card_devices():
    if torch.cuda.device_count() >= 2:
        return ["cuda:0", "cuda:1"], None
    return ["cuda:0", "cuda:0"], "gloo"


@pytest.mark.gpu
def test_sharded_segments_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from spml_tpu_torch.ops import common, kmeans

    rng = np.random.RandomState(0)
    b, h, w = 2, 32, 24
    emb = rng.randn(b, h, w, 16)
    loc = np.broadcast_to(common.generate_location_features(h, w).double()
                          .numpy(), (b, h, w, 2)).copy()
    sem = rng.choice([0, 1, 2, 255], (b, h, w))
    inst = rng.randint(0, 3, (b, h, w))
    sem[:, :h // 2] = np.where(rng.rand(b, h // 2, w) < 0.9, 255,
                               sem[:, :h // 2])
    args = ((3, 3), 24, 4, 255)  # capacity 24: some segments overflow
    want = kmeans.segment_batch(*(torch.from_numpy(a) for a in (
        emb, loc, sem, inst)), *args)[0]
    devices, backend = _card_devices()
    ranks = mesh_lib.spawn(torch_sp_ranks.sharded_segments,
                           (emb, loc, sem, inst, args), devices, backend)
    for f, name in enumerate(kmeans.Segments._fields):
        if name.startswith("pixel"):
            got = torch.cat([r[f].reshape(b, h // 2, w) for r in ranks], 1)
            assert torch.equal(got.reshape(b, -1), want[f]), name
        else:
            assert all(torch.equal(r[f], want[f]) for r in ranks), name
    assert not want.pixel_valid.all() and want.segment_valid.all()

"""The data-parallel training driver, loader, stage 2 and batched
inference of the port on two gloo ranks on the CPU.

* The stage-1 CLI, `spml_tpu_torch.tools.train --device cpu:2` (its
  launch of two ranks wrapped by this test to put the JAX package's
  initial weights in place and the classifier's dropout at 0 in each
  rank), against the JAX package's `pyscripts/train/train.py` with
  SPML_TPU_PLATFORM=cpu:2 (a 2-device mesh) on tests/test_torch_driver.py's
  world and config: train.batch_size 2 a rank, a global batch of 4, two
  iterations. Every logged loss within rtol 1e-4 as that file states it;
  the learning rate and the segment count equal. Rank 0 alone wrote the
  checkpoint, which holds both ranks' generator states.
* Resume: a second 2-rank run with train.resume logs its first
  iteration at the saved step and writes step 3; the two ranks end with
  torch.equal parameters, buffers and banks, and distinct dropout
  generators. The 2-rank checkpoint restores in one process at the same
  global batch (train.batch_size 4) with every tensor equal.
* The Loader's shard (rank, world) yields the global batch's slice of
  the one-process loader, item for item.
* Stage 2 over 2 ranks: the cross-entropy is the one masked mean of the
  global batch (the JAX step's, spml_tpu/train/classifier_step.py:75),
  not the mean of the ranks' means: the losses equal the one-process
  step's at the global batch within rtol 1e-5 and the head's updates
  within 1e-2 * max|update| (plus one float32 unit), while the ranks'
  valid pixel counts differ.
* Batched KNN inference (tpu.infer_batch 2) over 2 ranks writes the PNGs
  of the port's one-process run and of the JAX runner, whose groups
  go through predict_semantic_batch sharded over its device mesh.
"""

import copy
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from spml_tpu.inference import runner as jrunner
from spml_tpu_torch.config import load_config
from spml_tpu_torch.data import datasets
from spml_tpu_torch.inference import runner
from spml_tpu_torch.parallel import mesh as mesh_lib
from spml_tpu_torch.tools import train as train_tool
from spml_tpu_torch.train import driver, optim
from spml_tpu_torch.train import step as tstep
from spml_tpu_torch.utils import checkpoint as ckpt
import torch_dp_ranks
from test_torch_batch_inference import _pngs
from test_torch_driver import (CONFIG, JAX_CLI, LOSSES, _jax_initial_state,
                               _load_jax_state, _write_config,
                               world)  # noqa: F401
from test_torch_dp_step import _update_errors
from test_torch_guards import ROOT
from test_torch_inference_runner import runs  # noqa: F401


def _jax_init_tensors():
    cfg = load_config(overrides=CONFIG)
    st = tstep.init_state(cfg, 0, torch.zeros(2, 1, 1, 3), "cpu")
    _load_jax_state(st, _jax_initial_state())
    return torch_dp_ranks.model_tensors(st)


def _run_port_cli(monkeypatch, argv, init, out):
    """tools/train.py's main with `argv` and --device cpu:2; returns the
    logged metrics and each rank's final tensors."""
    real, calls = mesh_lib.launch, []

    def launch(fn, args, device):
        calls.append((fn, device))
        real(functools.partial(torch_dp_ranks.with_jax_init, fn, init, out),
             args, device)
    monkeypatch.setattr(mesh_lib, "launch", launch)
    monkeypatch.setattr(sys, "argv",
                        ["train.py", *argv, "--device", "cpu:2"])
    train_tool.main()
    assert calls == [(driver.train_spml, "cpu:2")]
    with open(out + ".json") as f:
        logged = json.load(f)
    return logged, [torch.load(f"{out}.rank{r}.pt") for r in range(2)]


@pytest.fixture(scope="module")
def dp_stage1(world, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("dp")
    _, data, lst = world
    cfg_path = _write_config(root / "config.yaml")
    common_args = ["--cfg_path", cfg_path, "--data_dir", data,
                   "--data_list", lst]
    out = root / "jax_metrics.json"
    env = dict(os.environ, SPML_TPU_PLATFORM="cpu:2", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_CLI, str(out), *common_args,
         "--snapshot_dir", str(root / "jax_stage1")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    jax_logged = json.loads(out.read_text())
    init = _jax_init_tensors()
    mp = pytest.MonkeyPatch()
    try:
        port_logged, ranks = _run_port_cli(
            mp, [*common_args, "--snapshot_dir", str(root / "stage1")],
            init, str(root / "run1"))
    finally:
        mp.undo()
    return jax_logged, port_logged, ranks, root, common_args, init


def test_train_cli_on_two_ranks_matches_jax(dp_stage1):
    jax_logged, port_logged, ranks, root, _, _ = dp_stage1
    assert [it for it, _ in port_logged] == [it for it, _ in jax_logged] \
        == [0, 1]
    for (it, got), (_, want) in zip(port_logged, jax_logged):
        for k in LOSSES:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=f"iter {it} {k}")
        assert got["learning_rate"] == pytest.approx(want["learning_rate"],
                                                     rel=1e-6)
        assert got["num_segments"] == want["num_segments"]
    assert "imgs_per_sec" in port_logged[1][1]
    d = str(root / "stage1" / "checkpoints")
    assert ckpt.steps(d) == [2]
    saved = ckpt.read(d)
    assert len(saved["rank_generators"]) == 2
    assert torch.equal(saved["rank_generators"][0], saved["generator"])
    # the bank holds the global batch's prototypes
    assert saved["memory"]["prototype"].shape == (1, 4 * 32, 8)


def test_resume_on_two_ranks(dp_stage1, monkeypatch):
    _, _, _, root, common_args, init = dp_stage1
    resume_cfg = _write_config(root / "resume.yaml", max_iteration=3,
                               resume=True)
    args = [a if a != common_args[1] else resume_cfg for a in common_args]
    logged, ranks = _run_port_cli(
        monkeypatch, [*args, "--snapshot_dir", str(root / "stage1")], init,
        str(root / "run2"))
    assert [it for it, _ in logged] == [2]
    sched = optim.make_schedule(load_config(resume_cfg).train)
    assert logged[0][1]["learning_rate"] == sched(2)
    assert ckpt.steps(str(root / "stage1" / "checkpoints")) == [2, 3]
    a, b = ranks
    for part in ("tensors", "memory"):
        assert a[part].keys() == b[part].keys()
        for k, v in a[part].items():
            assert torch.equal(v, b[part][k]), (part, k)
    assert not torch.equal(a["generator"], b["generator"])


def test_two_rank_checkpoint_restores_in_one_process(dp_stage1):
    _, _, ranks, root, _, _ = dp_stage1
    cfg = load_config(overrides=CONFIG)
    cfg.train.batch_size = 4  # the 2-rank run's global batch
    st = tstep.init_state(cfg, 7, torch.zeros(4, 1, 1, 3), "cpu")
    d = str(root / "stage1" / "checkpoints")
    st = ckpt.restore(d, st, step=2)
    saved = ckpt.read(d, 2)
    assert st.step == 2
    got = torch_dp_ranks.model_tensors(st)
    want = ranks[0]["tensors"]  # after 2 steps, as saved
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in got)
    for k, v in vars(st.memory).items():
        assert torch.equal(v, saved["memory"][k]), k
    assert torch.equal(st.generator.get_state(), saved["generator"])


def test_loader_shard_is_the_global_slice(world):  # noqa: F811
    _, data, lst = world
    ds = datasets.ListTagDataset(
        data_dir=data, data_list=lst, img_mean=(0.5,) * 3,
        img_std=(0.25,) * 3, size=(32, 32), random_crop=True,
        random_scale=True, random_mirror=True, training=True, seed=3)
    full = iter(datasets.Loader(ds, 4, seed=3, num_workers=2))
    shards = [iter(datasets.Loader(ds, 4, seed=3, num_workers=2,
                                   shard=(r, 2))) for r in range(2)]
    for _ in range(3):  # past the end of the 6-image list
        whole = next(full)
        parts = [next(s) for s in shards]
        for k, v in whole.items():
            np.testing.assert_array_equal(
                np.concatenate([p[k] for p in parts]), v, err_msg=k)
    with pytest.raises(ValueError, match="split"):
        datasets.Loader(ds, 3, shard=(0, 2))


def test_stage2_cross_entropy_is_the_global_mean():
    cfg = load_config(overrides=CONFIG)
    st = tstep.init_state(cfg, 0, torch.zeros(4, 1, 1, 3), "cpu")
    emb_init = st.emb_model.state_dict()
    head_init = st.cls_model.state_dict()
    rng = np.random.RandomState(4)
    batches = []
    for _ in range(2):
        sem = rng.randint(0, 5, (4, 32, 32)).astype(np.int64)
        sem[2:, :, 4:] = 255  # rank 1: a few valid pixels, rank 0 many
        batches.append({
            "image": rng.randn(4, 32, 32, 3).astype(np.float32),
            "semantic_label": sem,
            "instance_label": np.zeros((4, 32, 32), np.int64),
            "semantic_tag": np.zeros((4, 256), np.int64)})
    ranks = mesh_lib.spawn(torch_dp_ranks.classifier_steps,
                           (cfg, emb_init, head_init, batches),
                           ["cpu", "cpu"])
    one = torch_dp_ranks.classifier_steps(cfg, emb_init, head_init,
                                          batches, device="cpu")
    assert ranks[0]["losses"] == ranks[1]["losses"]
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"],
                               rtol=1e-5)
    init = {"prediction." + k: v for k, v in head_init.items()}
    got = {"prediction." + k: v for k, v in ranks[0]["head"].items()}
    want = {"prediction." + k: v for k, v in one["head"].items()}
    names = [k for k, v in init.items() if v.is_floating_point()]
    errs = _update_errors(got, want, init, names, 1e-2)
    assert max(errs.values()) <= 1, errs
    for k, v in ranks[0]["head"].items():
        assert torch.equal(v, ranks[1]["head"][k]), k
    # the mean of the two ranks' own masked means is another number
    per_rank = [torch_dp_ranks.classifier_steps(
        cfg, emb_init, head_init,
        [{k: v[sl] for k, v in batches[0].items()}], device="cpu")
        ["losses"][0] for sl in (slice(0, 2), slice(2, 4))]
    assert abs(np.mean(per_rank) - one["losses"][0]) > 1e-3


def test_batched_inference_over_two_ranks(runs, tmp_path):  # noqa: F811
    (jargs, jcfg), (args, cfg) = runs
    jcfg, cfg = copy.deepcopy(jcfg), copy.deepcopy(cfg)
    jcfg.tpu.infer_batch = cfg.tpu.infer_batch = 2
    jargs, one_args, dp_args = (copy.copy(jargs), copy.copy(args),
                                copy.copy(args))
    jargs.save_dir = str(tmp_path / "jax")
    one_args.save_dir = str(tmp_path / "one")
    dp_args.save_dir = str(tmp_path / "dp")
    jrunner.run_knn_inference(jargs, jcfg)
    runner.run_knn_inference(one_args, cfg, device="cpu")
    mesh_lib.launch(runner.run_knn_inference, (dp_args, cfg), "cpu:2")
    got, one, want = (_pngs(dp_args.save_dir), _pngs(one_args.save_dir),
                      _pngs(jargs.save_dir))
    assert got.keys() == one.keys() == want.keys() and len(got) == 6
    for k in want:
        np.testing.assert_array_equal(got[k], one[k], err_msg=str(k))
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))

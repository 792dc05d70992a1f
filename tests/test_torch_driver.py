"""The training drivers, checkpoints and pretrained loading of the port
against the JAX package's, on the CPU.

* The stage-1 CLI: `spml_tpu_torch.tools.train --device cpu` in this
  process against the JAX package's `pyscripts/train/train.py` in a
  subprocess with SPML_TPU_PLATFORM=cpu:1 (one device, so both global
  batches are train.batch_size), on one synthetic world on disk and one
  YAML config: two iterations, dense losses, float32. Both start from the
  JAX package's initial state for train.seed (PRNGKey(235 + seed),
  carried into the port's init through utils/from_jax.py by a monkeypatch
  of this test) with the classifier's dropout 0 on both sides (the RNG
  streams cannot match), and the JAX datasets take their Python path
  (use_native = False, set in the subprocess): the items are then equal
  (tests/test_torch_train_data.py). Every logged loss within rtol 1e-4,
  as tests/test_torch_train_step.py states it; the learning rate and the
  segment count equal.
* Resume: a second port run with train.resume logs its first iteration
  at the saved step with the schedule's LR of that step.
* Stage 2 reads stage 1's checkpoint: the frozen embedding equals it
  (torch.equal) after training, the head moves; build_eval_models reads
  both snapshots.
* Checkpoints: save, overwrite and restore round trips, torch.equal on
  every tensor, the generator state and the counts.
* Pretrained loading from a synthetic CUHK-named .pth against the JAX
  package's driver._load_pretrained, compared through from_jax, exactly.
* pca against the JAX package's up to each component's sign (rtol 1e-4,
  atol 1e-5: float32 SVDs of two libraries), embedding_to_rgb exactly.
"""

import argparse
import json
import math
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

from spml_tpu.config import load_config as jload_config
from spml_tpu.ops import common as jcommon
from spml_tpu.train import driver as jdriver
from spml_tpu.train import step as jstep
from spml_tpu.utils import vis as jvis
from spml_tpu_torch import cli
from spml_tpu_torch.config import load_config
from spml_tpu_torch.data import synthetic
from spml_tpu_torch.ops import common
from spml_tpu_torch.tools import train as train_tool
from spml_tpu_torch.train import classifier_step as cstep
from spml_tpu_torch.train import driver, optim
from spml_tpu_torch.train import step as tstep
from spml_tpu_torch.utils import checkpoint as ckpt
from spml_tpu_torch.utils import from_jax, torch_import, vis
from test_torch_guards import ROOT

LOSSES = ("loss", "sem_ann_loss", "sem_occ_loss", "img_sim_loss")
CONFIG = {
    "network": {"backbone_types": "panoptic_deeplab_10", "embedding_dim": 8,
                "kmeans_num_clusters": [2, 2], "kmeans_iterations": 2},
    "dataset": {"num_classes": 5},
    "train": {"batch_size": 2, "crop_size": [32, 32], "max_iteration": 2,
              "snapshot_step": 1000, "tensorboard_step": 1,
              "memory_bank_size": 1, "warmup_iteration": 10},
    "tpu": {"segment_capacity": 32, "compute_dtype": "float32"},
    "num_threads": 2,
}

# the JAX package's CLI with the classifier's dropout at 0 and its
# datasets on their Python path; every logged metric dumped to JSON
JAX_CLI = """
import json, runpy, sys
from spml_tpu.data import datasets
from spml_tpu.models.embeddings import ClassifierHead
from spml_tpu.train import driver, step
datasets.ListDataset.use_native = False
build_models = step.build_models
def no_dropout(config):
    emb, head = build_models(config)
    return emb, ClassifierHead(num_classes=head.num_classes,
                               hidden_dim=head.hidden_dim,
                               dropout_rate=0.0, dtype=head.dtype)
step.build_models = no_dropout
logged = []
log_metrics = driver._log_metrics
def capture(writer, metrics, it, prefix=""):
    logged.append((it, {k: float(v) for k, v in metrics.items()}))
    log_metrics(writer, metrics, it, prefix)
driver._log_metrics = capture
out = sys.argv.pop(1)
sys.argv[0] = "pyscripts/train/train.py"
runpy.run_path(sys.argv[0], run_name="__main__")
json.dump(logged, open(out, "w"))
"""


def _write_config(path, **train):
    cfg = {k: (dict(v) if isinstance(v, dict) else v)
           for k, v in CONFIG.items()}
    cfg["train"].update(train)
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(path)


def _jax_initial_state():
    jcfg = jload_config(overrides=CONFIG)
    return jstep.init_state(jcfg, jax.random.PRNGKey(235 + 0),
                            jnp.zeros((2, 32, 32, 3)))


def _load_jax_state(st, jst):
    p = jax.tree.map(np.asarray, jst.params)
    s = jax.tree.map(np.asarray, jst.batch_stats)
    st.emb_model.load_state_dict(from_jax.embedding_state_dict(
        p["embedding"], s["embedding"]), strict=True)
    st.cls_model.load_state_dict(from_jax.classifier_state_dict(
        p["prediction"], s["prediction"]), strict=True)
    st.cls_model.semantic_classifier[3].p = 0.0


def _run_port_cli(monkeypatch, argv, jst=None):
    """tools/train.py's main with `argv`; the logged metrics by
    iteration. With jst, the initial state is the JAX package's."""
    logged = []
    log_metrics = driver._log_metrics

    def capture(writer, metrics, it, prefix=""):
        logged.append((it, dict(metrics)))
        log_metrics(writer, metrics, it, prefix)
    monkeypatch.setattr(driver, "_log_metrics", capture)
    if jst is not None:
        init_state = tstep.init_state

        def from_jax_init(*a, **k):
            st = init_state(*a, **k)
            _load_jax_state(st, jst)
            return st
        monkeypatch.setattr(tstep, "init_state", from_jax_init)
    monkeypatch.setattr(sys, "argv", ["train.py", *argv, "--device", "cpu"])
    train_tool.main()
    return logged


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("world")
    lst = synthetic.write_world(str(root / "data"), 6,
                                shapes=((40, 48), (48, 40)), num_classes=5,
                                segments=8, seed=2)
    return root, str(root / "data"), lst


@pytest.fixture(scope="module")
def stage1(world, tmp_path_factory):
    """The JAX CLI's and the port CLI's logged metrics of the same run, and
    the port's snapshot directory."""
    root, data, lst = world
    cfg_path = _write_config(root / "config.yaml")
    common_args = ["--cfg_path", cfg_path, "--data_dir", data,
                   "--data_list", lst]
    out = root / "jax_metrics.json"
    env = dict(os.environ, SPML_TPU_PLATFORM="cpu:1", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_CLI, str(out), *common_args,
         "--snapshot_dir", str(root / "jax_stage1")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    jax_logged = json.loads(out.read_text())
    mp = pytest.MonkeyPatch()
    try:
        port_logged = _run_port_cli(
            mp, [*common_args, "--snapshot_dir", str(root / "stage1")],
            _jax_initial_state())
    finally:
        mp.undo()
    return jax_logged, port_logged, root, cfg_path, common_args


def test_train_cli_matches_jax(stage1):
    jax_logged, port_logged, root, _, _ = stage1
    assert [it for it, _ in port_logged] == [it for it, _ in jax_logged] \
        == [0, 1]
    for (it, got), (_, want) in zip(port_logged, jax_logged):
        for k in LOSSES:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       err_msg=f"iter {it} {k}")
        assert got["learning_rate"] == pytest.approx(want["learning_rate"],
                                                     rel=1e-6)
        assert got["num_segments"] == want["num_segments"]
        assert all(math.isfinite(got[k]) for k in LOSSES)
    assert "warmup_secs" in port_logged[0][1]
    assert "imgs_per_sec" in port_logged[1][1]
    assert ckpt.steps(str(root / "stage1" / "checkpoints")) == [2]


def test_resume_starts_at_the_saved_step(stage1, monkeypatch):
    _, _, root, _, common_args = stage1
    resume_cfg = _write_config(root / "resume.yaml", max_iteration=3,
                               resume=True)
    args = [a if a != common_args[1] else resume_cfg for a in common_args]
    logged = _run_port_cli(monkeypatch,
                           [*args, "--snapshot_dir", str(root / "stage1")])
    assert [it for it, _ in logged] == [2]
    sched = optim.make_schedule(load_config(resume_cfg).train)
    assert logged[0][1]["learning_rate"] == sched(2)
    assert ckpt.steps(str(root / "stage1" / "checkpoints")) == [2, 3]


def test_stage2_reads_stage1_and_eval_models_read_both(stage1, world,
                                                       monkeypatch):
    _, _, root, cfg_path, _ = stage1
    _, data, lst = world
    cfg = load_config(cfg_path)
    cfg.network.pretrained = str(root / "stage1")
    cfg.network.prediction_types = "softmax_classifier"
    cfg.network.kmeans_iterations = 0
    cfg.network.kmeans_num_clusters = (1, 1)
    cfg.train.max_iteration = 2
    saved = ckpt.read(str(root / "stage1" / "checkpoints"))
    frozen = []
    make = cstep.make_classifier_train_step

    def keep(config, emb_model):
        frozen.append(emb_model)
        return make(config, emb_model)
    monkeypatch.setattr(cstep, "make_classifier_train_step", keep)
    args = argparse.Namespace(data_dir=data, data_list=lst,
                              snapshot_dir=str(root / "stage2"))
    head0 = cstep.init_classifier_state(cfg, 235, "cpu").cls_model
    state = driver.train_classifier(args, cfg, device="cpu")
    assert state.step == 2 and state.emb_model is None
    for k, v in frozen[0].state_dict().items():
        assert torch.equal(v, saved["emb_model"][k]), k
    moved = [not torch.equal(a, b) for a, b in zip(
        head0.parameters(), state.cls_model.parameters())]
    assert all(moved)
    stage2 = ckpt.read(str(root / "stage2" / "checkpoints"))
    assert stage2["emb_model"] is None and stage2["step"] == 2

    emb1 = cli.build_eval_models(cfg, str(root / "stage1"), device="cpu")
    emb2, head2 = cli.build_eval_models(cfg, str(root / "stage2"),
                                        device="cpu", with_classifier=True)
    for k, v in saved["emb_model"].items():
        assert torch.equal(emb1.state_dict()[k], v), k
        assert torch.equal(emb2.state_dict()[k], v), k
    for k, v in state.cls_model.state_dict().items():
        assert torch.equal(head2.state_dict()[k], v), k
    assert not emb2.training and not head2.training
    cfg.network.pretrained = ""
    with pytest.raises(FileNotFoundError, match="pretrained"):
        cli.build_eval_models(cfg, str(root / "stage2"), device="cpu")


def _tiny_state(optimizer, seed=0):
    cfg = load_config(overrides={**CONFIG, "train": {
        **CONFIG["train"], "optimizer": optimizer}})
    cfg.tpu.use_fused_loss = True
    st = tstep.init_state(cfg, seed, torch.zeros(2, 32, 32, 3), "cpu")
    return cfg, st


def _step_once(cfg, st, seed):
    rng = np.random.RandomState(seed)
    batch = {"image": torch.from_numpy(rng.randn(2, 32, 32, 3).astype(
                 np.float32)),
             "semantic_label": torch.from_numpy(rng.randint(0, 5, (2, 32,
                                                                   32))),
             "instance_label": torch.from_numpy(rng.randint(0, 3, (2, 32,
                                                                   32))),
             "semantic_tag": torch.from_numpy(rng.randint(0, 2, (2, 256)))}
    return tstep.make_train_step(cfg)(st, batch)[0]


def _assert_states_equal(a, b):
    assert a.step == b.step and a.adam_count == b.adam_count
    for ma, mb in ((a.emb_model, b.emb_model), (a.cls_model, b.cls_model)):
        if ma is None:
            assert mb is None
            continue
        sa, sb = ma.state_dict(), mb.state_dict()
        assert sa.keys() == sb.keys()
        assert all(torch.equal(sa[k], sb[k]) for k in sa)
    for name in ("momentum", "adam_mu", "adam_nu"):
        da, db = getattr(a, name), getattr(b, name)
        assert da.keys() == db.keys()
        assert all(torch.equal(da[k], db[k]) for k in da), name
    if a.memory is None:
        assert b.memory is None
    else:
        for k, v in vars(a.memory).items():
            assert torch.equal(v, getattr(b.memory, k)), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_checkpoint_round_trip(optimizer, tmp_path):
    cfg, st = _tiny_state(optimizer)
    st = _step_once(cfg, st, 1)
    torch.rand(3, generator=st.generator)  # a generator state of its own
    d = str(tmp_path / "checkpoints")
    (tmp_path / "checkpoints" / "10").mkdir(parents=True)  # orbax-like
    assert ckpt.latest_step(d) is None
    ckpt.save(d, 1, st)
    fresh = _tiny_state(optimizer, seed=9)[1]
    restored = ckpt.restore(d, fresh)
    _assert_states_equal(restored, st)
    assert restored.momentum if optimizer == "sgd" else restored.adam_mu
    assert restored.memory.valid.any()

    st = _step_once(cfg, st, 2)  # step 2, saved over step 1
    ckpt.save(d, 1, st)
    assert ckpt.steps(d) == [1]
    assert sorted(os.listdir(d)) == ["10", "ckpt-1.pt"]
    _assert_states_equal(ckpt.restore(d, _tiny_state(optimizer, 5)[1]), st)


def test_classifier_checkpoint_round_trip(tmp_path):
    cfg = load_config(overrides=CONFIG)
    st = cstep.init_classifier_state(cfg, 3, "cpu")
    st.momentum["prediction.semantic_classifier.0.weight"] = torch.randn(
        16, 8, 3, 3)
    ckpt.save(str(tmp_path), 7, st)
    restored = ckpt.restore(str(tmp_path),
                            cstep.init_classifier_state(cfg, 4, "cpu"))
    _assert_states_equal(restored, st)
    assert ckpt.latest_step(str(tmp_path)) == 7


def _to_cuhk_name(name):
    """The inverse of torch_import.apply_reference_name_mapping."""
    if name.startswith("resnet_backbone.conv1."):
        return name[len("resnet_backbone.conv1."):]
    return (name.replace("resnet_backbone.res2", "layer1")
                .replace("resnet_backbone.res3", "layer2")
                .replace("resnet_backbone.res4", "layer3")
                .replace("resnet_backbone.res5", "layer4"))


def test_pretrained_loading_matches_jax(tmp_path):
    """A CUHK-named backbone file (random weights and BN statistics), one
    entry of a wrong shape and one without a counterpart: JAX's and the
    port's merged embeddings are equal on every entry the file gives, and
    keep their own init elsewhere."""
    g = torch.Generator().manual_seed(11)
    src = tstep.build_models(load_config(overrides=CONFIG), "cpu", g)[0]
    file_sd = {}
    for k, v in src.state_dict().items():
        if k.startswith("resnet_backbone.") and v.is_floating_point():
            file_sd[_to_cuhk_name(k)] = torch.randn(v.shape, generator=g) \
                if "running_var" not in k else torch.rand(v.shape,
                                                          generator=g) + .5
    bad = "layer4.0.conv1.weight"
    file_sd[bad] = torch.zeros(3, 3)
    file_sd["fc.weight"] = torch.zeros(10, 4)
    path = str(tmp_path / "resnet-cuhk.pth")
    torch.save(file_sd, path)

    over = {**CONFIG, "network": {**CONFIG["network"], "pretrained": path}}
    jst = _jax_initial_state()
    jinit = from_jax.embedding_state_dict(
        *(jax.tree.map(np.asarray, t["embedding"])
          for t in (jst.params, jst.batch_stats)))
    jst = jdriver._load_pretrained(jload_config(overrides=over), jst)
    want = from_jax.embedding_state_dict(
        *(jax.tree.map(np.asarray, t["embedding"])
          for t in (jst.params, jst.batch_stats)))
    cfg = load_config(overrides=over)
    st = tstep.init_state(cfg, 0, torch.zeros(2, 32, 32, 3), "cpu")
    init = {k: v.clone() for k, v in st.emb_model.state_dict().items()}
    got = driver._load_pretrained(cfg, st).emb_model.state_dict()

    given = {torch_import.apply_reference_name_mapping(k): v
             for k, v in file_sd.items() if k not in (bad, "fc.weight")}
    assert len(given) > 50
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        if k in given:
            assert torch.equal(got[k], given[k]), k
            assert torch.equal(want[k], given[k]), k
        else:  # not in the file or of another shape: each side's init
            assert torch.equal(got[k], init[k]), k
            assert torch.equal(want[k], jinit[k]), k


def test_pca_matches_jax_up_to_sign():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 7, 8).astype(np.float32)
    x[..., 0] *= 5.0
    x[..., 3] *= 2.0
    got = common.pca(torch.from_numpy(x)).numpy()
    want = np.asarray(jcommon.pca(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 9, 7, 3)
    gc = common.calculate_principal_components(
        torch.from_numpy(x.reshape(-1, 8))).numpy()
    wc = np.asarray(jcommon.calculate_principal_components(
        jnp.asarray(x.reshape(-1, 8))))
    for c in range(3):
        sign = np.sign(np.dot(gc[:, c], wc[:, c]))
        np.testing.assert_allclose(gc[:, c] * sign, wc[:, c], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got[..., c] * sign, want[..., c],
                                   rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(vis.embedding_to_rgb(x),
                                  jvis.embedding_to_rgb(x))

"""The training drivers' ground rules, on the CPU and without JAX:

* the new modules are under tests/test_torch_guards.py's import scan and
  pass its rules;
* the drivers' entry points default to the CUDA card and raise without
  one; `--device` defaults to cuda;
* with a card (marked gpu, skipped here): two train_spml steps at the
  small size on the card against the same two on the CPU, float32 with
  TF32 off, the fused joint loss on (K1-K3 on the card, their plain
  version on the CPU), the classifier's dropout 0 (the two devices'
  generators draw differently). Losses within rtol 1e-4 (cuDNN against
  oneDNN through the conv stack, as the inference card test's stitched
  map), the learning rate and the segment count equal, K1-K3 launched
  once per step. On a CUDA host without JAX: `python -m pytest
  --noconftest -m gpu tests/test_torch_driver_guards.py`.
"""

import argparse
import sys

import numpy as np
import pytest
import torch

from spml_tpu_torch import cli
from spml_tpu_torch.config import load_config
from spml_tpu_torch.data import synthetic
from spml_tpu_torch.train import classifier_step as cstep
from spml_tpu_torch.train import driver
from spml_tpu_torch.train import step as tstep
from test_torch_guards import ROOT, _forbidden, _imported_modules

NEW_MODULES = ["train/driver.py", "train/classifier_step.py",
               "utils/checkpoint.py", "utils/torch_import.py",
               "data/synthetic.py", "tools/train.py",
               "tools/train_classifier.py", "tools/train_densepose.py",
               "tools/train_densepose_classifier.py"]
OVERRIDES = {
    "network": {"backbone_types": "panoptic_deeplab_10", "embedding_dim": 32,
                "kmeans_num_clusters": [2, 2], "kmeans_iterations": 2},
    "dataset": {"num_classes": 5},
    "train": {"batch_size": 2, "crop_size": [32, 32], "max_iteration": 2,
              "snapshot_step": 1000, "tensorboard_step": 1,
              "memory_bank_size": 1},
    "tpu": {"segment_capacity": 32, "compute_dtype": "float32",
            "use_fused_loss": True},
    "num_threads": 2,
}


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_pass_the_import_scan(module):
    path = ROOT / "spml_tpu_torch" / module
    assert path in set((ROOT / "spml_tpu_torch").rglob("*.py"))
    assert [m for m in _imported_modules(path) if _forbidden(m)] == []


@pytest.mark.parametrize("entry", ["train_spml", "train_classifier",
                                   "init_classifier_state",
                                   "build_classifier"])
def test_driver_entry_points_default_to_the_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = load_config(overrides=OVERRIDES)
    args = argparse.Namespace(data_dir=str(tmp_path), data_list="",
                              snapshot_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "train_spml":
            driver.train_spml(args, cfg)
        elif entry == "train_classifier":
            driver.train_classifier(args, cfg)
        elif entry == "init_classifier_state":
            cstep.init_classifier_state(cfg, 0)
        else:
            cstep.build_classifier(cfg)


def test_device_flag_defaults_to_cuda(tmp_path, monkeypatch):
    cfg_path = tmp_path / "c.yaml"
    cfg_path.write_text("train:\n  batch_size: 3\n")
    monkeypatch.setattr(sys, "argv", [
        "train.py", "--cfg_path", str(cfg_path), "--snapshot_dir",
        str(tmp_path), "--kmeans_num_clusters", "3,4", "--data_dir", "d"])
    args, config = cli.parse_args()
    assert args.device == "cuda"
    assert config.train.batch_size == 3
    assert config.network.kmeans_num_clusters == (3, 4)
    assert config.dataset.data_dir == "d"


@pytest.mark.gpu
def test_train_spml_on_card_matches_cpu(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from spml_tpu_torch.ops import segsort_loss as fused
    lst = synthetic.write_world(str(tmp_path / "data"), 4,
                                shapes=((40, 48), (48, 40)), num_classes=5,
                                segments=8, seed=3)
    init_state = tstep.init_state

    def no_dropout(*a, **k):
        st = init_state(*a, **k)
        st.cls_model.semantic_classifier[3].p = 0.0
        return st
    monkeypatch.setattr(tstep, "init_state", no_dropout)
    runs = {}
    for device in ("cpu", "cuda"):
        logged = []
        monkeypatch.setattr(driver, "_log_metrics",
                            lambda w, m, it, prefix="": logged.append(m))
        cfg = load_config(overrides=OVERRIDES)
        args = argparse.Namespace(data_dir=str(tmp_path / "data"),
                                  data_list=lst,
                                  snapshot_dir=str(tmp_path / device))
        fused.reset_launch_counts()
        driver.train_spml(args, cfg, device=device)
        runs[device] = (logged, dict(fused.LAUNCHES))
    (cpu, cpu_launches), (card, card_launches) = runs["cpu"], runs["cuda"]
    assert not any(cpu_launches.values())
    assert {k: v for k, v in card_launches.items() if v} == {
        "joint_stats": 2, "joint_grad_emb": 2, "joint_grad_proto": 2}
    for want, got in zip(cpu, card):
        for k in ("loss", "sem_ann_loss", "sem_occ_loss", "img_sim_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
        assert got["learning_rate"] == want["learning_rate"]
        assert got["num_segments"] == want["num_segments"]

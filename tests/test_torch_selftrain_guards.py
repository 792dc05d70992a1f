"""The self-training slice's ground rules, on the CPU:

* its modules are under tests/test_torch_guards.py's import scan and
  pass its rules;
* its entry points default to the CUDA card and raise without one, and
  each inference entry turns TF32 off;
* cli.parse_args reads the six --crf_* flags with the JAX package's
  defaults and values, and crf_from_args builds the same DenseCRF;
* each of the 15 inference CLIs of spml_tpu_torch/tools/ makes the runner
  call its pyscripts/inference/ counterpart makes, with the same
  arguments and the device of --device; the two benchmark CLIs print
  what theirs print.

Tests marked gpu run on a CUDA host (`python -m pytest --noconftest -m
gpu tests/test_torch_selftrain_guards.py`) and skip here: the float32
engine built in a fresh process, where cuDNN's TF32 is on until the
engine turns it off, against the CPU at chip_smoke.py's STITCH_RTOL; the
KNN and softmax pyramids on the card against the CPU (float32
probabilities rtol 1e-4 / atol 1e-5, labels equal); the walk on the card
against float64.
"""

import argparse
import importlib
import importlib.util
import subprocess
import sys

import numpy as np
import PIL.Image
import pytest
import torch

from spml_tpu_torch import cli
from spml_tpu_torch.config import load_config
from spml_tpu_torch.inference import msc, runner
from spml_tpu_torch.inference.softmax import SoftmaxInferenceEngine
from spml_tpu_torch.models.embeddings import (build_classifier_head,
                                              build_embedding_model)
from spml_tpu_torch.ops import randomwalk
from test_torch_guards import ROOT, _forbidden, _imported_modules

NEW_MODULES = ["crf.py", "inference/msc.py", "inference/softmax.py",
               "inference/runner.py", "inference/engine.py",
               "ops/randomwalk.py", "data/synthetic.py"]
INFERENCE_CLIS = ["inference", "inference_crf", "inference_crf_msc",
                  "inference_msc", "inference_softmax",
                  "inference_softmax_crf", "inference_softmax_crf_msc",
                  "inference_softmax_msc", "prototype", "prototype_msc",
                  "pseudo_camrw_crf", "pseudo_denseposerw_crf",
                  "pseudo_inference_crf_msc", "pseudo_softmax",
                  "pseudo_softmaxrw_crf"]
RUNNERS = ["run_prototype", "run_knn_inference", "run_softmax_inference",
           "run_pseudo_camrw_crf", "run_pseudo_softmax", "run_pseudo_knn",
           "run_pseudo_densepose"]
ARGV = ["--snapshot_dir", "SNAP", "--save_dir", "OUT", "--data_dir",
        "DATA", "--data_list", "LIST", "--cam_dir", "CAMS",
        "--semantic_memory_dir", "BANK", "--kmeans_num_clusters", "5,4",
        "--crf_iter_max", "7", "--crf_bi_xy_std", "50"]


@pytest.fixture
def argv(tmp_path):
    """ARGV with --cfg_path of a small YAML both packages read."""
    cfg = tmp_path / "config.yaml"
    cfg.write_text("dataset:\n  num_classes: 21\nnetwork:\n"
                   "  embedding_dim: 32\n  kmeans_num_clusters: [6, 6]\n")
    return ["--cfg_path", str(cfg)] + ARGV


def _config():
    return load_config(overrides={
        "network": {"backbone_types": "panoptic_deeplab_10",
                    "embedding_dim": 8, "kmeans_num_clusters": [2, 2],
                    "kmeans_iterations": 2},
        "dataset": {"num_classes": 4},
        "test": {"crop_size": [32, 32], "stride": [16, 16]},
        "tpu": {"compute_dtype": "float32"}})


@pytest.mark.parametrize("module", NEW_MODULES + [
    f"tools/{n}.py" for n in INFERENCE_CLIS
    + ["benchmark_by_mIoU", "benchmark_by_instance"]])
def test_new_modules_pass_the_import_scan(module):
    path = ROOT / "spml_tpu_torch" / module
    assert path in set((ROOT / "spml_tpu_torch").rglob("*.py"))
    assert [m for m in _imported_modules(path) if _forbidden(m)] == []


@pytest.mark.parametrize("entry", ["softmax_engine"] + RUNNERS[1:])
def test_entry_points_default_to_the_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = _config()
    args = argparse.Namespace(snapshot_dir=str(tmp_path),
                              save_dir=str(tmp_path), data_dir="",
                              data_list="", semantic_memory_dir="",
                              cam_dir="")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "softmax_engine":
            SoftmaxInferenceEngine(
                cfg, build_embedding_model("panoptic_deeplab_10", 8),
                build_classifier_head(4, 8))
        elif entry == "run_knn_inference":
            runner.run_knn_inference(args, cfg, msc=True, crf=True)
        else:
            getattr(runner, entry)(args, cfg)


@pytest.mark.parametrize("entry", ["engine", "softmax_engine",
                                   "build_eval_models", "walk"])
def test_inference_entry_turns_tf32_off(entry, tmp_path, monkeypatch):
    """Whatever the process set before, every inference entry leaves
    cuDNN and cuBLAS in float32, as the train steps do."""
    from spml_tpu_torch.inference import engine

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    cfg = _config()
    model = build_embedding_model("panoptic_deeplab_10", 8)
    if entry == "engine":
        engine.InferenceEngine(cfg, model, device="cpu")
    elif entry == "softmax_engine":
        SoftmaxInferenceEngine(cfg, model, build_classifier_head(4, 8),
                               device="cpu")
    elif entry == "build_eval_models":
        cli.build_eval_models(cfg, str(tmp_path), device="cpu")
    else:
        randomwalk.random_walk(torch.eye(3), torch.ones(2, 3))
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_crf_flags_parse_as_jax(argv, monkeypatch):
    """Defaults and given values of the --crf_* flags, and the DenseCRF
    built from them."""
    from spml_tpu import cli as jcli

    monkeypatch.setattr(jcli, "enable_compilation_cache", lambda cfg: None)
    keys = ("crf_iter_max", "crf_pos_xy_std", "crf_pos_w", "crf_bi_xy_std",
            "crf_bi_w", "crf_bi_rgb_std")
    for flags in (argv[:6], argv):
        monkeypatch.setattr(sys, "argv", ["prog"] + flags)
        jargs, _ = jcli.parse_args()
        args, _ = cli.parse_args()
        assert {k: getattr(args, k) for k in keys} == \
            {k: getattr(jargs, k) for k in keys}
        assert vars(cli.crf_from_args(args)) == \
            vars(jcli.crf_from_args(jargs))
    assert args.crf_iter_max == 7 and args.crf_bi_xy_std == 50
    assert args.device == "cuda"


def _recorder(monkeypatch, module, calls):
    for name in RUNNERS:
        monkeypatch.setattr(
            module, name,
            lambda a, c, *p, _n=name, **k: calls.append((_n, a, c, p, k)))


@pytest.mark.parametrize("name", INFERENCE_CLIS)
def test_cli_makes_the_jax_scripts_runner_call(name, argv, monkeypatch):
    from spml_tpu import cli as jcli
    from spml_tpu.inference import runner as jrunner

    monkeypatch.setattr(jcli, "enable_compilation_cache", lambda cfg: None)
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script adds one
    jcalls, calls = [], []
    _recorder(monkeypatch, jrunner, jcalls)
    _recorder(monkeypatch, runner, calls)
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "pyscripts" / "inference" / f"{name}.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    tool = importlib.import_module(f"spml_tpu_torch.tools.{name}")
    monkeypatch.setattr(sys, "argv", [name] + argv)
    script.main()
    monkeypatch.setattr(sys, "argv", [name] + argv + ["--device", "cpu"])
    tool.main()
    (jfn, jargs, jcfg, jpos, jkw), = jcalls
    (fn, args, cfg, pos, kw), = calls
    assert (fn, pos) == (jfn, jpos)
    assert kw.pop("device") == "cpu"
    assert kw == jkw
    assert vars(args) == dict(vars(jargs), device="cpu")
    assert cfg.network.kmeans_num_clusters == \
        jcfg.network.kmeans_num_clusters == (5, 4)
    assert cfg.network.embedding_dim == jcfg.network.embedding_dim == 32


@pytest.mark.parametrize("name", ["benchmark_by_mIoU",
                                  "benchmark_by_instance"])
def test_benchmark_cli_prints_as_jax(name, monkeypatch, capsys, tmp_path):
    rng = np.random.RandomState(0)
    for sub in ("pred", "gt", "inst"):
        (tmp_path / sub).mkdir()
    for i in range(3):
        for sub, hi in (("pred", 5), ("gt", 5), ("inst", 3)):
            lab = rng.randint(0, hi, (12, 10)).astype(np.uint8)
            if sub == "gt":
                lab[:2] = 255
            PIL.Image.fromarray(lab).save(tmp_path / sub / f"{i}.png")
    argv = [name, "--pred_dir", str(tmp_path / "pred"), "--gt_dir",
            str(tmp_path / "gt"), "--num_classes", "5"]
    if name == "benchmark_by_instance":
        argv += ["--inst_dir", str(tmp_path / "inst")]
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "pyscripts" / "benchmark" / f"{name}.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    tool = importlib.import_module(f"spml_tpu_torch.tools.{name}")
    monkeypatch.setattr(sys, "argv", argv)
    capsys.readouterr()
    script.main()
    want = capsys.readouterr().out
    tool.main()
    assert capsys.readouterr().out == want
    assert "mean IOU" in want


# -- on the card --

def _tiny_memory(rng, n=40):
    p = rng.randn(n, 8).astype(np.float32)
    p /= np.linalg.norm(p, axis=1, keepdims=True)
    return p, rng.randint(0, 4, n).astype(np.int32), np.ones(n, bool)


@pytest.mark.gpu
def test_float32_engine_in_a_fresh_process_matches_cpu():
    """A fresh process with torch's TF32 defaults: InferenceEngine turns
    TF32 off, and its float32 stitched map equals the CPU's at
    STITCH_RTOL (1e-4, atol 1e-5 * max|CPU|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    code = """
import numpy as np, torch
from spml_tpu_torch.config import load_config
from spml_tpu_torch.inference import engine
from spml_tpu_torch.models.embeddings import build_embedding_model
assert torch.backends.cudnn.allow_tf32, "not torch's default"
cfg = load_config(overrides={
    "network": {"backbone_types": "panoptic_deeplab_101", "embedding_dim": 64},
    "test": {"crop_size": [128, 128], "stride": [64, 64]},
    "tpu": {"compute_dtype": "float32"}})
img = np.random.RandomState(1).randn(192, 160, 3).astype(np.float32)
out = {}
for dev in ("cuda", "cpu"):
    eng = engine.InferenceEngine(
        cfg, build_embedding_model("panoptic_deeplab_101", 64), dev)
    out[dev] = eng.stitched_embeddings(img).cpu()
assert not torch.backends.cudnn.allow_tf32
assert not torch.backends.cuda.matmul.allow_tf32
want = out["cpu"]
torch.testing.assert_close(out["cuda"], want, rtol=1e-4,
                           atol=1e-5 * float(want.abs().max()))
print("fresh process ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "fresh process ok" in res.stdout


@pytest.mark.gpu
def test_pyramids_on_card_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from spml_tpu_torch.inference import engine

    cfg = _config()
    rng = np.random.RandomState(2)
    img = rng.randn(40, 36, 3).astype(np.float32)
    mem = _tiny_memory(rng)
    for dev_probs in ("knn", "softmax"):
        out = {}
        for dev in ("cpu", "cuda"):
            model = build_embedding_model("panoptic_deeplab_10", 8)
            if dev_probs == "knn":
                eng = engine.InferenceEngine(cfg, model, dev)
                args = eng.memory(*mem)
            else:
                eng = SoftmaxInferenceEngine(cfg, model,
                                             build_classifier_head(4, 8), dev)
                args = ()
            out[dev] = (
                msc.msc_predict_probs_device(eng, img, args, (0.75, 1.0),
                                             transfer_dtype=np.float32),
                msc.msc_predict_labels_device(eng, img, args, (0.75, 1.0)))
        np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])


@pytest.mark.gpu
def test_walk_on_card_matches_float64():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(3)
    emb = rng.randn(600, 16)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    scores = rng.rand(5, 600)
    got = randomwalk.random_walk(
        torch.tensor(emb, dtype=torch.float32, device="cuda"),
        torch.tensor(scores, dtype=torch.float32, device="cuda")).cpu()
    e32 = torch.tensor(emb, dtype=torch.float32).double()
    aff = torch.exp(e32 @ e32.T * 5.0 - 5.0) ** 20
    trans = aff / aff.sum(0, keepdim=True)
    want = torch.tensor(scores, dtype=torch.float32).double() \
        @ torch.linalg.matrix_power(trans, 64)
    torch.testing.assert_close(got.double(), want, rtol=1e-3,
                               atol=1e-4 * float(want.abs().max()))

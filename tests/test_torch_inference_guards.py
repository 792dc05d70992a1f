"""The inference path's ground rules, on the CPU:

* every branch not ported yet raises NotImplementedError (batched
  prediction, an orbax snapshot);
* the entry points default to the CUDA card and raise without one;
* the engine imports and predicts with PIL unimportable;
* the new modules are under tests/test_torch_guards.py's import scan and
  pass its rules.

One test marked gpu runs the engine on the card at the small size
against its CPU run (`python -m pytest --noconftest -m gpu
tests/test_torch_inference_guards.py` on a CUDA host); it skips here.
"""

import argparse
import subprocess
import sys

import numpy as np
import pytest
import torch

from spml_tpu_torch import cli
from spml_tpu_torch.config import load_config
from spml_tpu_torch.inference import engine, runner
from spml_tpu_torch.models.embeddings import build_embedding_model
from test_torch_guards import ROOT, _forbidden, _imported_modules

NEW_MODULES = ["cli.py", "data/datasets.py", "data/transforms.py",
               "inference/engine.py", "inference/runner.py",
               "utils/metrics.py", "utils/vis.py"]


def _config(**tpu):
    return load_config(overrides={
        "network": {"backbone_types": "panoptic_deeplab_10",
                    "embedding_dim": 8, "kmeans_num_clusters": [2, 2],
                    "kmeans_iterations": 2},
        "dataset": {"num_classes": 4},
        "test": {"crop_size": [32, 32], "stride": [32, 32]},
        "tpu": {"compute_dtype": "float32", **tpu}})


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_pass_the_import_scan(module):
    path = ROOT / "spml_tpu_torch" / module
    assert path in set((ROOT / "spml_tpu_torch").rglob("*.py"))
    assert [m for m in _imported_modules(path) if _forbidden(m)] == []


@pytest.mark.parametrize("what", ["infer_batch"])
def test_unported_inference_branches_raise(what, tmp_path):
    cfg = _config(infer_batch=2)
    args = argparse.Namespace(snapshot_dir=str(tmp_path),
                              save_dir=str(tmp_path), data_dir="",
                              data_list="", semantic_memory_dir="")
    with pytest.raises(NotImplementedError, match=what):
        runner.run_knn_inference(args, cfg, device="cpu")


def test_orbax_snapshot_raises(tmp_path):
    (tmp_path / "checkpoints" / "10").mkdir(parents=True)
    with pytest.raises(NotImplementedError, match="orbax"):
        cli.build_eval_models(_config(), str(tmp_path), device="cpu")


def test_no_snapshot_builds_seeded_random_weights(tmp_path):
    """No model-*.pth: the weights come from a generator of seed 0, the
    same in every call, in eval mode on the device asked for."""
    a = cli.build_eval_models(_config(), str(tmp_path), device="cpu")
    b = cli.build_eval_models(_config(), str(tmp_path), device="cpu")
    assert not a.training
    assert all(torch.equal(x, y) for x, y in
               zip(a.state_dict().values(), b.state_dict().values()))


@pytest.mark.parametrize("entry", ["engine", "build_eval_models"])
def test_inference_entry_points_default_to_the_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = _config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "engine":
            engine.InferenceEngine(cfg, build_embedding_model(
                "panoptic_deeplab_10", 8))
        else:
            cli.build_eval_models(cfg, str(tmp_path))


def test_engine_runs_without_pil():
    """With PIL unimportable, the engine module imports and predicts."""
    code = """
import sys
sys.modules["PIL"] = None
import numpy as np
from spml_tpu_torch.config import load_config
from spml_tpu_torch.inference import engine
from spml_tpu_torch.models.embeddings import build_embedding_model
cfg = load_config(overrides={
    "network": {"backbone_types": "panoptic_deeplab_10", "embedding_dim": 8,
                "kmeans_num_clusters": [2, 2], "kmeans_iterations": 2},
    "dataset": {"num_classes": 4},
    "test": {"crop_size": [32, 32], "stride": [16, 16]},
    "tpu": {"compute_dtype": "float32"}})
eng = engine.InferenceEngine(cfg, build_embedding_model(
    "panoptic_deeplab_10", 8), device="cpu")
rng = np.random.RandomState(0)
img = rng.randn(40, 36, 3).astype(np.float32)
p, lab, v = eng.build_prototypes(img, np.zeros((40, 36), np.int32))
pred = eng.predict_semantic(img, np.tile(p[v], (5, 1)),
                            np.tile(lab[v], 5), np.ones(5 * int(v.sum()), bool))
assert pred.shape == (40, 36)
try:
    import PIL
except ImportError:
    print("no PIL, predicted", pred.shape)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "no PIL, predicted (40, 36)" in out.stdout


@pytest.mark.gpu
def test_engine_on_card_matches_cpu():
    """The engine on the card at the small size, float32 with TF32 off,
    against its CPU run on the same weights: stitched map rtol 1e-4 /
    atol 1e-5 * max|ref|, prototypes rtol 1e-4 / atol 1e-6, cluster maps,
    labels and predictions equal (chip_smoke.py's inference phase checks
    the flagship at VOC's test geometry)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _config()
    cfg.test.stride = (16, 16)
    model = build_embedding_model("panoptic_deeplab_10", 8)
    cpu = engine.InferenceEngine(cfg, model, device="cpu")
    gpu = engine.InferenceEngine(
        cfg, build_embedding_model("panoptic_deeplab_10", 8), device="cuda")
    rng = np.random.RandomState(1)
    img = rng.randn(40, 36, 3).astype(np.float32)
    gt = np.zeros((40, 36), np.int32)
    gt[20:] = 2
    want = cpu.stitched_embeddings(img).numpy()
    got = gpu.stitched_embeddings(img).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    pc, lc, vc, cc = cpu.build_prototypes(img, gt, return_clusters=True)
    pg, lg, vg, cg = gpu.build_prototypes(img, gt, return_clusters=True)
    np.testing.assert_array_equal(cg, cc)
    np.testing.assert_array_equal(lg, lc)
    np.testing.assert_array_equal(vg, vc)
    np.testing.assert_allclose(pg, pc, rtol=1e-4, atol=1e-6)
    mem = (np.tile(pc[vc], (12, 1)), np.tile(lc[vc], 12),
           np.ones(12 * int(vc.sum()), bool))
    np.testing.assert_array_equal(gpu.predict_semantic(img, *mem),
                                  cpu.predict_semantic(img, *mem))

"""The port's ground rules, checked on the CPU.

* spml_tpu_torch/ and chip_smoke.py import nothing of jax, flax, optax,
  spml_tpu or pyscripts (exact module matching: spml_tpu_torch starts
  with "spml_tpu");
* the entry points default to the CUDA card and raise on a host without
  one instead of carrying on on the CPU;
* the SegSort wrappers (joint and hard-label) take the plain version
  only for a CPU tensor; a CUDA tensor goes to the kernel binding, and a
  launch error raises (no fallback). A CUDA tensor is stood in for by a
  subclass that reports is_cuda, with the binding monkeypatched;
* make_train_step raises NotImplementedError, naming what is missing,
  for what is not ported yet.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from spml_tpu_torch.config import load_config
from spml_tpu_torch.ops import _cuda, segsort_loss as fused
from spml_tpu_torch.train import step as tstep

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "flax", "optax", "spml_tpu", "pyscripts")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_forbidden_prefix_matching_is_exact():
    assert _forbidden("spml_tpu.ops") and _forbidden("jax")
    assert not _forbidden("spml_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


def test_port_imports_nothing_of_the_jax_package():
    files = sorted((ROOT / "spml_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert bad == []


def _tiny_config():
    return load_config(overrides={
        "network": {"backbone_types": "panoptic_deeplab_10",
                    "embedding_dim": 8},
        "tpu": {"compute_dtype": "float32"}})


@pytest.mark.parametrize("entry", ["init_state", "build_models"])
def test_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    cfg = _tiny_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "init_state":
            tstep.init_state(cfg, 0, torch.zeros(1, 32, 32, 3))
        else:
            tstep.build_models(cfg)
    # an explicit CPU device works
    if entry == "build_models":
        emb, cls = tstep.build_models(cfg, device="cpu")
        assert next(emb.parameters()).device.type == "cpu"


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports is_cuda, to drive the kernel dispatch."""
    __torch_function__ = torch._C._disabled_torch_function_impl

    @property
    def is_cuda(self):
        return True


class _FakeLib:
    def __init__(self, err=0):
        self.calls = []
        self.err = err

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append(name)
            return self.err
        return fn


def _joint_inputs(rng, n=40, p=12, d=16):
    emb = torch.from_numpy(rng.randn(n, d).astype(np.float32))
    protos = torch.from_numpy(rng.randn(p, d).astype(np.float32))
    ints = [torch.from_numpy(rng.randint(0, 3, n)) for _ in range(3)]
    pints = [torch.from_numpy(rng.randint(0, 3, p)) for _ in range(3)]
    return emb, protos, ints, pints


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    def no_binding(name):
        raise AssertionError("the kernel binding was loaded for CPU input")
    monkeypatch.setattr(_cuda, "load", no_binding)
    fused.reset_launch_counts()
    emb, protos, (lab, own, tag), (plab, ptag, pval) = _joint_inputs(
        np.random.RandomState(0))
    stats = fused.joint_segsort_stats(emb, lab, own, tag, protos, plab,
                                      ptag, pval, torch.tensor([12]), 6.0,
                                      12.0)
    assert stats.shape == (6, 40)
    assert all(v == 0 for v in fused.LAUNCHES.values())


def test_cuda_tensor_calls_the_binding(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "load", lambda name: lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)

    def no_reference(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(fused, "joint_segsort_stats_reference",
                        no_reference)
    fused.reset_launch_counts()
    emb, protos, (lab, own, tag), (plab, ptag, pval) = _joint_inputs(
        np.random.RandomState(1))
    emb = torch.Tensor._make_subclass(_FakeCuda, emb, True)
    protos = torch.Tensor._make_subclass(_FakeCuda, protos, True)
    stats = fused.joint_segsort_stats(emb, lab, own, tag, protos, plab,
                                      ptag, pval, torch.tensor([12]), 6.0,
                                      12.0)
    assert lib.calls == ["segsort_joint_stats"]
    stats.sum().backward()
    assert lib.calls == ["segsort_joint_stats", "segsort_joint_grad_emb",
                         "segsort_joint_grad_proto"]
    assert fused.LAUNCHES == {"joint_stats": 1, "joint_grad_emb": 1,
                              "joint_grad_proto": 1, "hard_stats": 0,
                              "hard_grad_emb": 0, "hard_grad_proto": 0}


def test_hard_family_dispatch(monkeypatch):
    """segsort_stats: a CPU tensor takes the plain version and launches
    nothing; a CUDA tensor calls K4, then K5 and K6 in backward."""
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "load", lambda name: lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    fused.reset_launch_counts()
    emb, protos, (lab, own, _), (plab, _, _) = _joint_inputs(
        np.random.RandomState(5))
    stats = fused.segsort_stats(emb, lab, own, protos, plab,
                                torch.tensor([12]), 6.0)
    assert stats.shape == (3, 40) and lib.calls == []

    def no_reference(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(fused, "segsort_stats_reference", no_reference)
    emb = torch.Tensor._make_subclass(_FakeCuda, emb, True)
    protos = torch.Tensor._make_subclass(_FakeCuda, protos, True)
    stats = fused.segsort_stats(emb, lab, own, protos, plab,
                                torch.tensor([12]), 6.0)
    assert stats.shape == (3, 40)
    stats.sum().backward()
    assert lib.calls == ["segsort_hard_stats", "segsort_hard_grad_emb",
                         "segsort_hard_grad_proto"]
    assert fused.LAUNCHES == {"joint_stats": 0, "joint_grad_emb": 0,
                              "joint_grad_proto": 0, "hard_stats": 1,
                              "hard_grad_emb": 1, "hard_grad_proto": 1}


@pytest.mark.parametrize("what", ["tag_only_fused", "softmax_classifier"])
def test_unported_paths_raise(what):
    cfg = _tiny_config()
    if what == "tag_only_fused":
        cfg.tpu.use_fused_loss = True
        cfg.train.sem_ann_loss_types = "none"
        match = "tag-only fused loss"
    else:
        cfg.network.prediction_types = "softmax_classifier"
        match = "softmax_classifier"
    with pytest.raises(NotImplementedError, match=match):
        tstep.make_train_step(cfg)


def test_launch_error_raises(monkeypatch):
    monkeypatch.setattr(_cuda, "load", lambda name: _FakeLib(err=700))
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    emb, protos, (lab, own, tag), (plab, ptag, pval) = _joint_inputs(
        np.random.RandomState(2))
    emb = torch.Tensor._make_subclass(_FakeCuda, emb, False)
    with pytest.raises(RuntimeError, match="error 700"):
        fused.joint_segsort_stats(emb, lab, own, tag, protos, plab, ptag,
                                  pval, torch.tensor([12]), 6.0, 12.0)


def test_unsupported_width_raises():
    emb, protos, (lab, own, tag), (plab, ptag, pval) = _joint_inputs(
        np.random.RandomState(3), d=12)
    emb = torch.Tensor._make_subclass(_FakeCuda, emb, False)
    with pytest.raises(ValueError, match="embedding width"):
        fused.joint_segsort_stats(emb, lab, own, tag, protos, plab, ptag,
                                  pval, torch.tensor([12]), 6.0, 12.0)


@pytest.mark.gpu
def test_joint_kernels_match_plain_version_on_card():
    """K1-K3 against the plain version on the card, at a small size (on
    a CUDA host without JAX: `python -m pytest --noconftest -m gpu
    tests/test_torch_guards.py`; chip_smoke.py checks the same at the
    flagship shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.RandomState(4)
    n, p, d = 3000, 700, 64
    emb = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(n, d).astype(np.float32)), dim=1).cuda()
    protos = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(p, d).astype(np.float32)), dim=1).cuda()
    ints = [torch.from_numpy(rng.randint(-1, 4, k)).cuda()
            for k in (n, n, n, p, p, p)]
    lab, own, tag, plab, ptag, pval = ints
    own = own.clamp(0, p - 1)
    nv = torch.tensor([500], device="cuda")
    g = torch.randn(6, n, device="cuda")
    e1 = emb.clone().requires_grad_(True)
    p1 = protos.clone().requires_grad_(True)
    s1 = fused.joint_segsort_stats(e1, lab, own, tag, p1, plab, ptag, pval,
                                   nv, 6.0, 12.0)
    (s1 * g).sum().backward()
    # the plain version in float64 on the same values: the check measures
    # the kernels' own float32 error (stats rtol 1e-5; dE / dP rtol 1e-4,
    # atol 1e-5 * max|ref|)
    e2 = emb.double().requires_grad_(True)
    p2 = protos.double().requires_grad_(True)
    s2 = fused.joint_segsort_stats_reference(e2, lab, own, tag, p2, plab,
                                             ptag, pval, nv, 6.0, 12.0)
    (s2 * g.double()).sum().backward()
    torch.testing.assert_close(s1, s2.detach().float(), rtol=1e-5, atol=0.0)
    for a, b in ((e1.grad, e2.grad.float()), (p1.grad, p2.grad.float())):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.gpu
def test_hard_kernels_match_plain_version_on_card():
    """K4-K6 against the plain version in float64 on the card, at a small
    size, D = 32 (stats rtol 1e-5; dE / dP rtol 1e-4, atol 1e-5 *
    max|ref|; chip_smoke.py checks the same at the DensePose shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.RandomState(6)
    n, p, d = 3000, 700, 32
    emb = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(n, d).astype(np.float32)), dim=1).cuda()
    protos = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(p, d).astype(np.float32)), dim=1).cuda()
    lab = torch.from_numpy(rng.randint(0, 4, n)).cuda()
    own = torch.from_numpy(rng.randint(0, p, n)).cuda()
    plab = torch.from_numpy(rng.randint(-1, 4, p)).cuda()
    nv = torch.tensor([500], device="cuda")
    g = torch.randn(3, n, device="cuda")
    e1 = emb.clone().requires_grad_(True)
    p1 = protos.clone().requires_grad_(True)
    s1 = fused.segsort_stats(e1, lab, own, p1, plab, nv, 6.0)
    (s1 * g).sum().backward()
    e2 = emb.double().requires_grad_(True)
    p2 = protos.double().requires_grad_(True)
    s2 = fused.segsort_stats_reference(e2, lab, own, p2, plab, nv, 6.0)
    (s2 * g.double()).sum().backward()
    torch.testing.assert_close(s1, s2.detach().float(), rtol=1e-5, atol=0.0)
    for a, b in ((e1.grad, e2.grad.float()), (p1.grad, p2.grad.float())):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))

"""The port's ground rules, checked on the CPU.

* spml_tpu_torch/ and chip_smoke.py import nothing of jax, flax, optax,
  spml_tpu or pyscripts (exact module matching: spml_tpu_torch starts
  with "spml_tpu");
* the entry points default to the CUDA card and raise on a host without
  one instead of carrying on on the CPU;
* the kernel wrappers (SegSort joint, hard-label and tag-set; the
  dilated conv) take the plain version only for a CPU tensor; a CUDA
  tensor goes to the kernel binding, and a launch error raises (no
  fallback). A CUDA tensor is stood in for by a subclass that reports
  is_cuda, with the binding monkeypatched;
* make_train_step raises NotImplementedError, naming what is missing,
  for what is not ported yet, and routes the tag-only fused loss to the
  tag-set kernels.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from spml_tpu_torch.config import load_config
from spml_tpu_torch.ops import _cuda, dilated_conv, segsort_loss as fused
from spml_tpu_torch.train import recipes
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
    names = {str(f.relative_to(ROOT)) for f in files}
    assert {"spml_tpu_torch/ops/dilated_conv.py",
            "spml_tpu_torch/train/voc_tag.py",
            "spml_tpu_torch/train/recipes.py",
            "spml_tpu_torch/tools/dilated_conv_probe.py"} <= names
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert bad == []


@pytest.mark.parametrize("name", ["flagship", "densepose_point",
                                  "voc_tag"])
def test_recipe_setup(name):
    """Each recipe the tools name builds its configuration and a batch of
    that configuration's size, the same batch from the same seed."""
    cfg, batch = recipes.setup(name, device="cpu")
    b, crop = cfg.train.batch_size, cfg.train.crop_size[0]
    assert batch["image"].shape == (b, crop, crop, 3)
    assert batch["semantic_label"].shape == (b, crop, crop)
    assert batch["semantic_tag"].shape == (b, 256)
    assert cfg.tpu.use_fused_loss
    again = recipes.RECIPES[name].make_batch(cfg, device="cpu")
    assert all(torch.equal(batch[k], again[k]) for k in batch)


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


# every exported C function's argtypes, whatever its source
_SIGNATURES = {fn: sig for source in _cuda.SIGNATURES.values()
               for fn, sig in source.items()}


class _FakeLib:
    """Stands in for a bound library: records each call's name and
    arguments, and holds the argument count to the C signature."""

    def __init__(self, err=0):
        self.calls = []
        self.args = []
        self.err = err

    def __getattr__(self, name):
        def fn(*args):
            assert len(args) == len(_SIGNATURES[name]), (
                f"{name}: {len(args)} arguments, the C function takes "
                f"{len(_SIGNATURES[name])}")
            self.calls.append(name)
            self.args.append(args)
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
                              "hard_grad_emb": 0, "hard_grad_proto": 0,
                              "set_stats": 0, "set_grad_emb": 0,
                              "set_grad_proto": 0}


def test_hard_family_dispatch(monkeypatch):
    """segsort_stats: a CPU tensor takes the plain version and launches
    nothing; a CUDA tensor calls K4, then K5 and K6 in backward, K6 with
    the tiled dP kernel's scratch [blocks, 128, D], blocks >= ceil(P /
    128)."""
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
    allocated = {}  # data pointer -> shape of each tensor torch.empty made
    empty = torch.empty

    def recording_empty(*a, **k):
        t = empty(*a, **k)
        allocated[t.data_ptr()] = tuple(t.shape)
        return t
    monkeypatch.setattr(torch, "empty", recording_empty)
    stats.sum().backward()
    monkeypatch.setattr(torch, "empty", empty)
    assert lib.calls == ["segsort_hard_stats", "segsort_hard_grad_emb",
                         "segsort_hard_grad_proto"]
    # K6's arguments: ..., p, d, kappa, grads, partial, blocks, d_protos,
    # stream
    args = lib.args[-1]
    p, d, partial, blocks = args[7], args[8], args[11], args[12]
    assert (p, d) == tuple(protos.shape)
    assert blocks == fused.dp_blocks(p) and blocks >= -(-p // 128)
    assert allocated[partial] == (blocks, 128, d)
    assert fused.LAUNCHES == {"joint_stats": 0, "joint_grad_emb": 0,
                              "joint_grad_proto": 0, "hard_stats": 1,
                              "hard_grad_emb": 1, "hard_grad_proto": 1,
                              "set_stats": 0, "set_grad_emb": 0,
                              "set_grad_proto": 0}


def _set_inputs(rng, n=40, p=12, d=16):
    emb, protos, (tag, own, _), (ptag, pval, _) = _joint_inputs(rng, n, p, d)
    return emb, tag, own, protos, ptag, pval, torch.tensor([12])


def test_set_family_dispatch(monkeypatch):
    """set_segsort_stats: a CPU tensor takes the plain version and
    launches nothing; a CUDA tensor calls K7, then K8 and K9 in backward,
    K9 with the tiled dP kernel's scratch [blocks, 128, D], blocks >=
    ceil(P / 128)."""
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "load", lambda name: lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    fused.reset_launch_counts()
    emb, tag, own, protos, ptag, pval, nv = _set_inputs(
        np.random.RandomState(7))
    stats = fused.set_segsort_stats(emb, tag, own, protos, ptag, pval, nv,
                                    8.0)
    assert stats.shape == (3, 40) and lib.calls == []

    def no_reference(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(fused, "set_segsort_stats_reference", no_reference)
    emb = torch.Tensor._make_subclass(_FakeCuda, emb, True)
    protos = torch.Tensor._make_subclass(_FakeCuda, protos, True)
    stats = fused.set_segsort_stats(emb, tag, own, protos, ptag, pval, nv,
                                    8.0)
    assert lib.calls == ["segsort_set_stats"]
    allocated = {}  # data pointer -> shape of each tensor torch.empty made
    empty = torch.empty

    def recording_empty(*a, **k):
        t = empty(*a, **k)
        allocated[t.data_ptr()] = tuple(t.shape)
        return t
    monkeypatch.setattr(torch, "empty", recording_empty)
    stats.sum().backward()
    monkeypatch.setattr(torch, "empty", empty)
    assert lib.calls == ["segsort_set_stats", "segsort_set_grad_emb",
                         "segsort_set_grad_proto"]
    # K9's arguments: ..., p, d, kappa, grads, partial, blocks, d_protos,
    # stream
    args = lib.args[-1]
    p, d, partial, blocks = args[8], args[9], args[12], args[13]
    assert (p, d) == tuple(protos.shape)
    assert blocks == fused.dp_blocks(p) and blocks >= -(-p // 128)
    assert allocated[partial] == (blocks, 128, d)
    assert fused.LAUNCHES == {"joint_stats": 0, "joint_grad_emb": 0,
                              "joint_grad_proto": 0, "hard_stats": 0,
                              "hard_grad_emb": 0, "hard_grad_proto": 0,
                              "set_stats": 1, "set_grad_emb": 1,
                              "set_grad_proto": 1}


def test_dilated_conv_dispatch(monkeypatch):
    """dilated_conv3x3: a CPU tensor takes the plain version; a CUDA
    tensor calls the C function once and counts it; channel counts that
    are not multiples of 16, and weights on another device than the input,
    raise before any launch."""
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "load", lambda name: lib)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 0)
    dilated_conv.reset_launch_counts()
    x = torch.zeros(1, 5, 6, 16, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 16, 32, dtype=torch.bfloat16)
    assert dilated_conv.dilated_conv3x3(x, w, 2).shape == (1, 5, 6, 32)
    assert lib.calls == [] and dilated_conv.LAUNCHES["dilated_conv3x3"] == 0

    def no_reference(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(dilated_conv, "dilated_conv3x3_reference",
                        no_reference)
    xc = torch.Tensor._make_subclass(_FakeCuda, x, False)
    out = dilated_conv.dilated_conv3x3(xc, w, 2)
    assert out.shape == (1, 5, 6, 32) and out.dtype == torch.bfloat16
    assert lib.calls == ["dilated_conv3x3_bf16"]
    assert dilated_conv.LAUNCHES["dilated_conv3x3"] == 1
    for c, o in ((8, 32), (16, 24)):
        xc = torch.Tensor._make_subclass(
            _FakeCuda, torch.zeros(1, 5, 6, c, dtype=torch.bfloat16), False)
        with pytest.raises(ValueError, match="multiples of 16"):
            dilated_conv.dilated_conv3x3(
                xc, torch.zeros(3, 3, c, o, dtype=torch.bfloat16), 2)
    with pytest.raises(ValueError, match="bf16"):
        dilated_conv.dilated_conv3x3(
            torch.Tensor._make_subclass(_FakeCuda, x.float(), False),
            w.float(), 2)
    for xd in (x, torch.Tensor._make_subclass(_FakeCuda, x, False)):
        with pytest.raises(ValueError, match="but w on meta"):
            dilated_conv.dilated_conv3x3(xd, w.to("meta"), 2)
    assert lib.calls == ["dilated_conv3x3_bf16"]
    monkeypatch.setattr(_cuda, "load", lambda name: _FakeLib(err=700))
    with pytest.raises(RuntimeError, match="error 700"):
        dilated_conv.dilated_conv3x3(
            torch.Tensor._make_subclass(_FakeCuda, x, False), w, 2)


@pytest.mark.parametrize("what", ["loss_operand_dtype"])
def test_unported_paths_raise(what):
    # the JAX package would run its fused losses on bf16 operands
    cfg = load_config(overrides={
        "network": {"backbone_types": "panoptic_deeplab_10",
                    "embedding_dim": 8},
        "tpu": {"loss_operand_dtype": "bfloat16"}})
    assert cfg.tpu.loss_operand_dtype == "bfloat16"
    with pytest.raises(NotImplementedError, match=what):
        tstep.make_train_step(cfg)


def test_tag_only_fused_step_reaches_set_kernels(monkeypatch):
    """sem_ann off, sem_occ on, tpu.use_fused_loss: make_train_step builds
    the step, and the step's sem_occ term goes through
    fused_set_segsort_loss (the tag-set kernels K7-K9 on a card) and no
    other fused loss."""
    cfg = load_config(overrides={
        "network": {"backbone_types": "panoptic_deeplab_10",
                    "embedding_dim": 8, "kmeans_num_clusters": [2, 2],
                    "kmeans_iterations": 1},
        "dataset": {"num_classes": 4},
        "train": {"batch_size": 1, "crop_size": [32, 32],
                  "memory_bank_size": 1, "sem_ann_loss_types": "none"},
        "tpu": {"segment_capacity": 16, "compute_dtype": "float32",
                "use_fused_loss": True}})
    calls = []

    def spy(name):
        orig = getattr(tstep, name)

        def wrapped(*a, **k):
            calls.append(name)
            return orig(*a, **k)
        monkeypatch.setattr(tstep, name, wrapped)
    for name in ("fused_set_segsort_loss", "fused_segsort_loss",
                 "fused_joint_losses"):
        spy(name)
    step = tstep.make_train_step(cfg)
    rng = np.random.RandomState(0)
    batch = {"image": torch.from_numpy(rng.rand(1, 32, 32, 3).astype(
                 np.float32)),
             "semantic_label": torch.from_numpy(rng.randint(0, 4, (1, 32,
                                                                   32))),
             "instance_label": torch.from_numpy(rng.randint(0, 3, (1, 32,
                                                                   32))),
             "semantic_tag": torch.ones(1, 256, dtype=torch.int64)}
    state = tstep.init_state(cfg, 0, batch["image"], device="cpu")
    _, metrics = step(state, batch)
    assert calls == ["fused_set_segsort_loss"]
    assert {"sem_ann_loss", "sem_occ_loss"} <= set(metrics)
    assert all(np.isfinite(float(v)) for k, v in metrics.items()
               if k.endswith("loss"))


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
@pytest.mark.parametrize(
    "n,nv,d,kappa_o",
    [(3000, 500, 64, 12.0), (3009, 449, 64, 12.0), (3007, 447, 64, 10.0),
     (3000, 0, 64, 12.0), (3000, 1, 64, 10.0), (3000, 500, 32, 12.0),
     (3001, 65, 32, 10.0)],
    ids=["mid", "one_past_tiles", "one_short_of_tiles", "none_valid",
         "one_valid_two_exps", "d32", "d32_ragged_two_exps"])
def test_joint_kernels_match_plain_version_on_card(n, nv, d, kappa_o):
    """K1-K3 against the plain version on the card, at small sizes that
    straddle the dE / dP kernels' 64-row tiles: N and num_valid one past
    or one short of a multiple, none or one valid row, D = 32, kappa_o =
    2 kappa_a (s_o = s_a^2) and 10 with kappa_a = 6 (on a CUDA host
    without JAX: `python -m pytest --noconftest -m gpu
    tests/test_torch_guards.py`; chip_smoke.py checks the same at the
    flagship shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.RandomState(4)
    p = 700
    emb = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(n, d).astype(np.float32)), dim=1).cuda()
    protos = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(p, d).astype(np.float32)), dim=1).cuda()
    ints = [torch.from_numpy(rng.randint(-1, 4, k)).cuda()
            for k in (n, n, n, p, p, p)]
    lab, own, tag, plab, ptag, pval = ints
    own = own.clamp(0, p - 1)
    nv = torch.tensor([nv], device="cuda")
    g = torch.randn(6, n, device="cuda")
    e1 = emb.clone().requires_grad_(True)
    p1 = protos.clone().requires_grad_(True)
    s1 = fused.joint_segsort_stats(e1, lab, own, tag, p1, plab, ptag, pval,
                                   nv, 6.0, kappa_o)
    (s1 * g).sum().backward()
    # the plain version in float64 on the same values: the check measures
    # the kernels' own float32 error (stats rtol 1e-5; dE / dP rtol 1e-4,
    # atol 1e-5 * max|ref|)
    e2 = emb.double().requires_grad_(True)
    p2 = protos.double().requires_grad_(True)
    s2 = fused.joint_segsort_stats_reference(e2, lab, own, tag, p2, plab,
                                             ptag, pval, nv, 6.0, kappa_o)
    (s2 * g.double()).sum().backward()
    torch.testing.assert_close(s1, s2.detach().float(), rtol=1e-5, atol=0.0)
    for a, b in ((e1.grad, e2.grad.float()), (p1.grad, p2.grad.float())):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))
    assert not p1.grad[int(nv):].any()  # rows past num_valid: exactly 0


@pytest.mark.gpu
def test_hard_kernels_match_plain_version_on_card():
    """K4-K6 against the plain version in float64 on the card, at a small
    size, D = 32, with 500 valid rows and with 65 (one row in the last
    64-row prototype tile) (stats rtol 1e-5; dE / dP rtol 1e-4, atol 1e-5
    * max|ref|; chip_smoke.py checks the same at the DensePose shapes)."""
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
    g = torch.randn(3, n, device="cuda")
    for valid in (500, 65):
        nv = torch.tensor([valid], device="cuda")
        e1 = emb.clone().requires_grad_(True)
        p1 = protos.clone().requires_grad_(True)
        s1 = fused.segsort_stats(e1, lab, own, p1, plab, nv, 6.0)
        (s1 * g).sum().backward()
        e2 = emb.double().requires_grad_(True)
        p2 = protos.double().requires_grad_(True)
        s2 = fused.segsort_stats_reference(e2, lab, own, p2, plab, nv, 6.0)
        (s2 * g.double()).sum().backward()
        torch.testing.assert_close(s1, s2.detach().float(), rtol=1e-5,
                                   atol=0.0)
        for a, b in ((e1.grad, e2.grad.float()),
                     (p1.grad, p2.grad.float())):
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-5 * float(b.abs().max()))


@pytest.mark.gpu
def test_set_kernels_match_plain_version_on_card():
    """K7-K9 against the plain version in float64 on the card, at a small
    size, D = 64 (stats rtol 1e-5; dE / dP rtol 1e-4, atol 1e-5 *
    max|ref|; chip_smoke.py checks the same at the tag step's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    rng = np.random.RandomState(8)
    n, p, d = 3000, 700, 64
    emb = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(n, d).astype(np.float32)), dim=1).cuda()
    protos = torch.nn.functional.normalize(
        torch.from_numpy(rng.randn(p, d).astype(np.float32)), dim=1).cuda()
    tag = torch.from_numpy(rng.randint(0, 2 ** 20, n)).cuda()
    own = torch.from_numpy(rng.randint(0, p, n)).cuda()
    ptag = torch.from_numpy(rng.randint(0, 2 ** 20, p)).cuda()
    ptag[::7] = 0
    pval = torch.from_numpy(rng.randint(0, 2, p)).cuda()
    nv = torch.tensor([500], device="cuda")
    g = torch.randn(3, n, device="cuda")
    e1 = emb.clone().requires_grad_(True)
    p1 = protos.clone().requires_grad_(True)
    s1 = fused.set_segsort_stats(e1, tag, own, p1, ptag, pval, nv, 8.0)
    (s1 * g).sum().backward()
    e2 = emb.double().requires_grad_(True)
    p2 = protos.double().requires_grad_(True)
    s2 = fused.set_segsort_stats_reference(e2, tag, own, p2, ptag, pval, nv,
                                           8.0)
    (s2 * g.double()).sum().backward()
    torch.testing.assert_close(s1, s2.detach().float(), rtol=1e-5, atol=0.0)
    for a, b in ((e1.grad, e2.grad.float()), (p1.grad, p2.grad.float())):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.gpu
def test_dilated_conv_kernel_matches_plain_version_on_card():
    """K10 against the plain version in float64 from the same bf16
    values, at small ragged shapes (rtol 2^-8: one bf16 rounding of the
    output; atol 1e-3 * max|ref| for float32 sums that cancel; chip_smoke.py
    checks the same at the probe's shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator("cuda").manual_seed(9)
    # B = 1; H, W not multiples of the 8 x 16 tile; C = 16 and 48 under a
    # 64-channel box; O = 16 and 144 in part of a 256-channel tile; every
    # tap but the centre outside a 3 x 3 image; two chunks and N tiles;
    # no input channel (zeros)
    for (b, h, w, c, o), d in (((2, 9, 7, 16, 16), 1),
                               ((1, 13, 20, 48, 32), 2),
                               ((3, 6, 5, 32, 144), 4),
                               ((1, 3, 3, 16, 16), 4),
                               ((1, 10, 17, 80, 272), 3),
                               ((1, 4, 5, 0, 16), 1)):
        x = torch.randn(b, h, w, c, device="cuda", generator=gen).bfloat16()
        wt = (0.2 * torch.randn(3, 3, c, o, device="cuda",
                                generator=gen)).bfloat16()
        got = dilated_conv.dilated_conv3x3(x, wt, d)
        want = dilated_conv.dilated_conv3x3_reference(x.double(),
                                                      wt.double(), d)
        torch.testing.assert_close(got.double(), want, rtol=2.0 ** -8,
                                   atol=1e-3 * float(want.abs().max()))

"""The random walk and the dense CRF, port against the JAX package on the
CPU.

* The four walk functions on the same numpy inputs: pixel_affinity within
  1e-5 relative (a d-term float32 dot in another order is off by up to
  d * 2^-24, 1e-6 at d = 16, which 5 * cos turns into 5e-6 of exp; exp
  in two libraries), x ** 20 equal (the power's products are JAX's own)
  but where XLA flushes a subnormal result to 0, the walks
  rtol 1e-4 / atol 1e-5 * max|JAX| (T ** 64 by six float32 squarings of
  [n, n] products summed in another order), cam_to_full_scores exactly.
* DenseCRF: the port builds its own library from native/densecrf/ into
  spml_tpu_torch/_build/ and gives JAX's marginals, equal, on one image at
  the reference's defaults and at the JAX package's test settings; the
  tracked native/densecrf/libdensecrf.so is byte-identical afterwards;
  threaded calls equal serial ones bitwise; the C signatures the wrapper
  declares are the arities of densecrf.cc's exports, and a fake library
  holding SIGNATURES' arities takes every call the wrapper makes.
"""

import concurrent.futures
import hashlib
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spml_tpu import crf as jcrf
from spml_tpu.ops import randomwalk as jwalk
from spml_tpu_torch import crf
from spml_tpu_torch.ops import randomwalk
from test_torch_guards import ROOT

TRACKED = ROOT / "native" / "densecrf" / "libdensecrf.so"


def _inputs(n, d, c, seed):
    rng = np.random.RandomState(seed)
    emb = rng.randn(n, d).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    return emb, rng.rand(c, n).astype(np.float32)


@pytest.mark.parametrize("n,d,c", [(12, 4, 3), (96, 8, 4), (300, 16, 5)])
def test_walk_matches_jax(n, d, c):
    emb, scores = _inputs(n, d, c, seed=n)
    t_emb, t_scores = torch.from_numpy(emb), torch.from_numpy(scores)
    want_aff = np.asarray(jwalk.pixel_affinity(jnp.asarray(emb)))
    aff = randomwalk.pixel_affinity(t_emb)
    np.testing.assert_allclose(aff.numpy(), want_aff, rtol=1e-5)
    # x ** 20 in JAX's products: equal where JAX keeps a normal result
    want_pow = np.asarray(jnp.asarray(want_aff) ** 20)
    got_pow = randomwalk.integer_pow(torch.from_numpy(want_aff.copy()),
                                     20).numpy()
    normal = want_pow >= np.finfo(np.float32).tiny
    np.testing.assert_array_equal(got_pow[normal], want_pow[normal])
    assert (got_pow[~normal] < np.finfo(np.float32).tiny).all()

    want = np.asarray(jwalk.random_walk(jnp.asarray(emb),
                                        jnp.asarray(scores)))
    got = randomwalk.random_walk(t_emb, t_scores).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    want = np.asarray(jwalk.random_walk_from_affinity(
        jnp.asarray(want_aff), jnp.asarray(scores), beta=3, walk_steps=2))
    got = randomwalk.random_walk_from_affinity(
        torch.from_numpy(want_aff.copy()), t_scores, beta=3,
        walk_steps=2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("y", [1, 2, 3, 20, 21])
def test_integer_pow_is_the_power(y):
    x = torch.linspace(0.5, 1.5, 11, dtype=torch.float64)
    torch.testing.assert_close(randomwalk.integer_pow(x, y), x ** y)


def test_cam_to_full_scores_matches_jax():
    rng = np.random.RandomState(4)
    cam = {0: rng.rand(6, 7).astype(np.float32),
           2: rng.rand(6, 7).astype(np.float32)}
    want = jwalk.cam_to_full_scores(cam, 5, 6, 7, bg_alpha=6.0)
    got = randomwalk.cam_to_full_scores(cam, 5, 6, 7, bg_alpha=6.0)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _crf_case(seed, h=40, w=56, c=5):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    img[:, : w // 2] //= 3  # an edge for the bilateral term
    probs = rng.dirichlet(np.ones(c), (h, w)).transpose(2, 0, 1)
    return img, np.ascontiguousarray(probs, np.float32)


@pytest.mark.parametrize("settings", [
    {},  # the reference's defaults
    dict(iter_max=5, pos_w=3, pos_xy_std=3, bi_w=4, bi_xy_std=30,
         bi_rgb_std=5)])
def test_densecrf_matches_jax(settings):
    before = hashlib.sha256(TRACKED.read_bytes()).hexdigest()
    img, probs = _crf_case(1)
    want = jcrf.DenseCRF(**settings)(img, probs)
    got = crf.DenseCRF(**settings)(img, probs)
    assert got.dtype == np.float32 and got.shape == probs.shape
    np.testing.assert_array_equal(got, want)
    assert hashlib.sha256(TRACKED.read_bytes()).hexdigest() == before
    built = crf.target(crf._gxx())
    assert built.parent == ROOT / "spml_tpu_torch" / "_build"
    assert built.exists() and built != TRACKED


def test_densecrf_threaded_matches_serial():
    """The library's Gaussian lattice is cached and shared between
    same-sized images; four threads reproduce the serial outputs."""
    cases = [_crf_case(s) for s in range(6)]
    model = crf.DenseCRF(iter_max=5, pos_w=3, pos_xy_std=3, bi_w=4,
                         bi_xy_std=30, bi_rgb_std=5)
    serial = [model(*a) for a in cases]
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        threaded = list(pool.map(lambda a: model(*a), cases))
    for s, t in zip(serial, threaded):
        np.testing.assert_array_equal(s, t)


def test_densecrf_rejects_a_mismatched_image():
    img, probs = _crf_case(2)
    with pytest.raises(ValueError, match="does not match"):
        crf.DenseCRF()(img[:-1], probs)


def test_signatures_are_the_sources_arities():
    src = (crf.NATIVE / "densecrf.cc").read_text()
    exported = src[src.index('extern "C" {'):]
    found = {name: len([a for a in args.split(",") if a.strip()])
             for name, args in re.findall(r"\b(crf2d_\w+)\(([^)]*)\)\s*\{",
                                          exported)}
    assert found == {fn: len(argtypes)
                     for fn, (_, argtypes) in crf.SIGNATURES.items()}


def test_wrapper_calls_match_signatures(monkeypatch):
    """Every call DenseCRF makes passes SIGNATURES' argument count."""
    calls = []

    class FakeLib:
        def __getattr__(self, name):
            def fn(*args):
                assert len(args) == len(crf.SIGNATURES[name][1]), name
                calls.append(name)
                return 1 if name == "crf2d_new" else None
            return fn

    monkeypatch.setattr(crf, "load", FakeLib)
    img, probs = _crf_case(3, 8, 8, 2)
    crf.DenseCRF()(img, probs)
    assert calls == list(crf.SIGNATURES)[:1] + list(crf.SIGNATURES)[2:] \
        + ["crf2d_free"]

"""Synchronized batch norm of the port (models/resnet.py::BatchNorm2d in
a process group; parallel/mesh.py) on two gloo ranks on the CPU, against
flax's BatchNorm (the JAX package's) over the concatenated batch.

A global batch of 4 NHWC images, 6 x 5, 8 channels, with per-channel
means of 3 and up to 2 and spreads of 0.5 to 4 (the statistics' own
precision matters), split 2 + 2 over the ranks; a random cotangent.
Output and input gradient within rtol 1e-5 / atol 1e-5 (float32 sums in
another order: flax's mean of squares against the port's per-rank
two-pass moments), the weight and bias gradients summed over the ranks
(the train step's gradient all-reduce) within rtol 1e-5 / atol 1e-5,
running mean and variance (flax momentum 0.9 == torch 0.1, the biased
global variance) within rtol 1e-6 / atol 1e-7, num_batches_tracked 1.
Both ranks hold the same buffers. A remat recomputation (the
_RECOMPUTE flag) gives the same output again, collectives and all, and
leaves the buffers as they were.

World size 1 stays the single-process code: its output, gradients and
buffers are bit for bit those of the normalization with zeroed scratch
buffers and momentum 1 that the port used before the process group.
"""

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as nn
import torch
import torch.nn.functional as F

from spml_tpu_torch.models import resnet
from spml_tpu_torch.parallel import mesh as mesh_lib
import torch_dp_ranks

MOMENTUM = 0.1  # torch convention; flax 0.9


def _inputs():
    rng = np.random.RandomState(0)
    c = 8
    mean = rng.uniform(-2, 3, c).astype(np.float32)
    std = rng.uniform(0.5, 4, c).astype(np.float32)
    x = (rng.randn(4, 6, 5, c) * std + mean).astype(np.float32)
    cot = rng.randn(4, 6, 5, c).astype(np.float32)
    weight = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    return x, cot, weight, bias


def _flax(x, cot, weight, bias):
    bn = nn.BatchNorm(use_running_average=False, momentum=1.0 - MOMENTUM,
                      epsilon=resnet.BN_EPS)
    variables = bn.init(jax.random.PRNGKey(0), x)
    params = {"scale": jnp.asarray(weight), "bias": jnp.asarray(bias)}

    rest = {k: v for k, v in variables.items() if k != "params"}

    def fwd(xx, pp):
        return bn.apply({"params": pp, **rest}, xx, mutable=["batch_stats"])

    xx = jnp.asarray(x)
    y, stats = fwd(xx, params)
    _, pull = jax.vjp(lambda a, p: fwd(a, p)[0], xx, params)
    dx, dp = pull(jnp.asarray(cot))
    return (np.asarray(y), np.asarray(dx), np.asarray(dp["scale"]),
            np.asarray(dp["bias"]),
            jax.tree.map(np.asarray, stats["batch_stats"]))


def test_two_ranks_match_flax_global_batch_norm():
    x, cot, weight, bias = _inputs()
    ranks = mesh_lib.spawn(torch_dp_ranks.batch_norm,
                           (x, cot, weight, bias, MOMENTUM), ["cpu", "cpu"])
    y, dx, dw, db, stats = _flax(x, cot, weight, bias)
    got_y = torch.cat([r["y"] for r in ranks]).numpy()
    got_dx = torch.cat([r["dx"] for r in ranks]).numpy()
    np.testing.assert_allclose(got_y, y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dx, dx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sum(r["dw"] for r in ranks).numpy(), dw,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sum(r["db"] for r in ranks).numpy(), db,
                               rtol=1e-5, atol=1e-5)
    for r in ranks:
        buf = r["buffers"]
        np.testing.assert_allclose(buf["running_mean"].numpy(),
                                   stats["mean"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(buf["running_var"].numpy(),
                                   stats["var"], rtol=1e-6, atol=1e-7)
        assert int(buf["num_batches_tracked"]) == 1
        assert r["recomputed_equal"] and r["buffers_kept"]
    for k, v in ranks[0]["buffers"].items():
        assert torch.equal(v, ranks[1]["buffers"][k]), k


def test_world_one_is_the_single_process_batch_norm():
    x, cot, weight, bias = _inputs()
    got = torch_dp_ranks.batch_norm(x, cot, weight, bias, MOMENTUM,
                                    device="cpu")
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    w = torch.from_numpy(weight).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    scratch = torch.zeros(2, x.shape[-1])
    y = F.batch_norm(xt, scratch[0], scratch[1], w, b, True, 1.0,
                     resnet.BN_EPS)
    (y * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    n = x.size // x.shape[-1]
    assert torch.equal(got["y"], y.detach().permute(0, 2, 3, 1))
    assert torch.equal(got["dx"], xt.grad.permute(0, 2, 3, 1))
    assert torch.equal(got["dw"], w.grad) and torch.equal(got["db"], b.grad)
    assert torch.equal(got["buffers"]["running_mean"],
                       torch.zeros(x.shape[-1]).mul_(1 - MOMENTUM).add_(
                           scratch[0], alpha=MOMENTUM))
    assert torch.equal(got["buffers"]["running_var"],
                       torch.ones(x.shape[-1]).mul_(1 - MOMENTUM).add_(
                           scratch[1], alpha=MOMENTUM * (n - 1) / n))
    assert got["recomputed_equal"] and got["buffers_kept"]

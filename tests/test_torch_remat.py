"""Backbone remat (tpu.remat_backbone, tpu.remat_stages) of the port on the
CPU: per-block activation checkpointing.

* The step with remat equals the step without from the same state and
  batch: metrics, every parameter and every BN buffer, num_batches_tracked
  included, torch.equal (the recomputation runs the same CPU ops on the
  same values; a checkpoint that let BN update its buffers again in
  backward would move the running statistics twice and count the batch
  twice). Only the blocks backward reaches are checkpointed: with the
  stem and res2 frozen, res2's blocks run plainly.
* The port's remat steps against the JAX package's remat steps (flax
  nn.remat), two from the same weights, at
  tests/test_torch_train_step.py's tolerances: metrics rtol 1e-4,
  parameter and BN statistic updates within 1e-2 * max|update|.
"""

from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.utils.checkpoint

from spml_tpu.config import load_config as jload_config
from spml_tpu.models.embeddings import ClassifierHead as JHead
from spml_tpu.ops.pallas import segsort_loss as jfused
from spml_tpu.train import step as jstep
from spml_tpu_torch.config import load_config
from spml_tpu_torch.models import resnet
from spml_tpu_torch.train import step as tstep
from test_torch_train_step import (CHECKED_PARAMS, CHECKED_STATS, OVERRIDES,
                                   UPDATE_RTOL, _batch, _close,
                                   _port_state_dict, _state_dicts)

REMAT = {"backbone": {"remat_backbone": True},
         "stages_4_5": {"remat_stages": (4, 5)},
         "stage_4": {"remat_stages": (4,)}}


def _config(**tpu):
    cfg = load_config(overrides=OVERRIDES)
    for k, v in tpu.items():
        setattr(cfg.tpu, k, v)
    return cfg


def _one_step(cfg, batch):
    st = tstep.init_state(cfg, 0, batch["image"], device="cpu")
    calls = []
    orig = torch.utils.checkpoint.checkpoint

    def counting(fn, *a, **k):
        calls.append(fn.__self__)
        return orig(fn, *a, **k)

    with mock.patch.object(torch.utils.checkpoint, "checkpoint", counting):
        st, metrics = tstep.make_train_step(cfg)(st, batch)
    return st, {k: float(v) for k, v in metrics.items()}, calls


@pytest.mark.parametrize("name", list(REMAT))
def test_remat_step_equals_plain_step(name):
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    ref, ref_m, ref_calls = _one_step(_config(), batch)
    cfg = _config(**REMAT[name])
    got, got_m, calls = _one_step(cfg, batch)
    assert ref_calls == []
    assert got_m == ref_m
    want_sd, got_sd = _port_state_dict(ref), _port_state_dict(got)
    assert want_sd.keys() == got_sd.keys()
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k
    for k, v in got_sd.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == 1, k  # one training forward, counted once
    # the blocks checkpointed: those of the remat stages that backward
    # reaches (res2 is frozen and its input carries no gradient)
    backbone = got.emb_model.resnet_backbone
    stages = tstep.backbone_remat(cfg)
    stages = resnet.stage_remat(stages)
    want = [blk for i, on in enumerate(stages) if on and i > 0
            for blk in getattr(backbone, f"res{i + 2}")]
    assert calls == want and want


def test_stage_remat_resolution():
    cfg = _config(remat_backbone=True, remat_stages=(4,))
    assert tstep.backbone_remat(cfg) == (False, False, True, False)
    assert tstep.backbone_remat(_config(remat_backbone=True)) is True
    assert resnet.stage_remat(True) == (True,) * 4
    with pytest.raises(ValueError, match="res2-res5"):
        resnet.stage_remat((True, False))


def test_remat_step_matches_jax():
    """Two steps with remat_backbone on both sides from the same weights
    (the protocol of test_two_train_steps_match_jax)."""
    nb = _batch()
    overrides = {**OVERRIDES,
                 "tpu": {**OVERRIDES["tpu"], "remat_backbone": True}}
    jcfg = jload_config(overrides=overrides)
    jst = jstep.init_state(jcfg, jax.random.PRNGKey(0),
                           jnp.zeros((2, 32, 32, 3)))
    emb_def, _ = jstep.build_models(jcfg)
    assert emb_def.remat is True
    head = JHead(num_classes=4, hidden_dim=16, dropout_rate=0.0,
                 dtype=jnp.float32)

    cfg = load_config(overrides=overrides)
    st = tstep.init_state(cfg, 0, torch.zeros(2, 32, 32, 3), device="cpu")
    sd = _state_dicts(jst.params, jst.batch_stats)
    st.emb_model.load_state_dict(
        {k[len("embedding."):]: v for k, v in sd.items()
         if k.startswith("embedding.")}, strict=True)
    st.cls_model.load_state_dict(
        {k[len("prediction."):]: v for k, v in sd.items()
         if k.startswith("prediction.")}, strict=True)
    st.cls_model.semantic_classifier[3].p = 0.0

    step = tstep.make_train_step(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    orig = jfused.fused_joint_losses
    with mock.patch.object(
            jfused, "fused_joint_losses",
            lambda *a, **k: orig(*a, **{**k, "interpret": True})):
        jfn = jax.jit(jstep.make_train_step(jcfg, emb_def, head))
        for i in range(2):
            jst, jm = jfn(jst, jbatch)
            st, tm = step(st, tbatch)
            assert set(tm) == set(jm)
            for k in jm:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-4, atol=1e-7,
                                           err_msg=f"step {i} {k}")
    want = _state_dicts(jst.params, jst.batch_stats)
    got = _port_state_dict(st)
    for k in CHECKED_PARAMS + CHECKED_STATS:
        _close(got[k].detach().numpy() - sd[k].numpy(),
               want[k].numpy() - sd[k].numpy(), rel_atol=UPDATE_RTOL)

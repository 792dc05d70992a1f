"""The port's tag-only train step (sem_ann off, sem_occ on, fused loss:
the VOC image-tag recipe's "tags only" arm, spml_tpu_torch/train/
voc_tag.py) against the JAX train step on the CPU, at the tiny size of
tests/test_torch_train_step.py with train.sem_ann_loss_types = "none":
two steps from the same weights and batch, so that step 2 sees the
memory bank and the momentum buffers.

The JAX side takes fused_set_segsort_loss with its SetSegSort Pallas
kernels in interpret mode (the mock.patch pattern of that file); the port
takes its own fused_set_segsort_loss, whose plain version is what a CPU
tensor gets (K7-K9 on a card). The classifier's dropout is 0 on both
sides. The JAX step runs eagerly (jax.disable_jit): on this configuration
XLA's fusions under jit move the second step's sem_occ and img_sim losses
by 2.3e-4 and 1.2e-4 relative from the eager step, while the port stays
within 1e-5 of the eager step (and as far from the jitted one as the
eager step is).

Tolerances are those of tests/test_torch_train_step.py: losses and
metrics rtol 1e-4; parameter and BN statistic updates within
1e-2 * max|update|; memory-bank prototypes atol 3e-4; labels, batch
indices, tags and validity exactly equal. With sem_ann off the sem_ann
metric is the classifier head's cross-entropy alone, bit for bit.
"""

import copy
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import torch

from spml_tpu.config import load_config as jload_config
from spml_tpu.models.embeddings import ClassifierHead as JHead
from spml_tpu.ops.pallas import segsort_loss as jfused
from spml_tpu.train import step as jstep
from spml_tpu_torch.config import load_config
from spml_tpu_torch.train import step as tstep
from tests import test_torch_train_step as base

OVERRIDES = copy.deepcopy(base.OVERRIDES)
OVERRIDES["train"]["sem_ann_loss_types"] = "none"
OVERRIDES["train"]["sem_occ_concentration"] = 8.0


def test_two_tag_only_steps_match_jax(monkeypatch):
    nb = base._batch()
    jcfg = jload_config(overrides=OVERRIDES)
    jst = jstep.init_state(jcfg, jax.random.PRNGKey(0),
                           jnp.zeros((2, 32, 32, 3)))
    emb_def, _ = jstep.build_models(jcfg)
    head = JHead(num_classes=4, hidden_dim=16, dropout_rate=0.0,
                 dtype=jnp.float32)

    cfg = load_config(overrides=OVERRIDES)
    st = tstep.init_state(cfg, 0, torch.zeros(2, 32, 32, 3), device="cpu")
    sd = base._state_dicts(jst.params, jst.batch_stats)
    for prefix, model in (("embedding.", st.emb_model),
                          ("prediction.", st.cls_model)):
        model.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                               if k.startswith(prefix)}, strict=True)
    st.cls_model.semantic_classifier[3].p = 0.0

    ces, calls = [], []
    orig_ce = tstep._cross_entropy
    orig_set = tstep.fused_set_segsort_loss

    def ce_spy(*a, **k):
        ces.append(orig_ce(*a, **k))
        return ces[-1]

    def set_spy(*a, **k):
        calls.append("fused_set_segsort_loss")
        return orig_set(*a, **k)
    monkeypatch.setattr(tstep, "_cross_entropy", ce_spy)
    monkeypatch.setattr(tstep, "fused_set_segsort_loss", set_spy)
    step = tstep.make_train_step(cfg)

    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    orig = jfused.fused_set_segsort_loss
    with mock.patch.object(
            jfused, "fused_set_segsort_loss",
            lambda *a, **k: orig(*a, **{**k, "interpret": True})):
        jfn = jstep.make_train_step(jcfg, emb_def, head)
        for i in range(2):
            with jax.disable_jit():
                jst, jm = jfn(jst, jbatch)
            st, tm = step(st, tbatch)
            assert set(tm) == set(jm)
            assert {"sem_ann_loss", "sem_occ_loss", "img_sim_loss"} <= set(tm)
            for k in jm:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-4, atol=1e-7,
                                           err_msg=f"step {i} {k}")
            # sem_ann off: the metric is the CE term alone, unweighted
            assert float(tm["sem_ann_loss"]) == float(ces[-1].detach())
    assert calls == ["fused_set_segsort_loss"] * 2
    assert st.step == int(jst.step) == 2

    want = base._state_dicts(jst.params, jst.batch_stats)
    got = base._port_state_dict(st)
    for k in base.CHECKED_PARAMS + base.CHECKED_STATS:
        base._close(got[k].detach().numpy() - sd[k].numpy(),
                    want[k].numpy() - sd[k].numpy(),
                    rel_atol=base.UPDATE_RTOL)
    jmem, tmem = jst.memory, st.memory
    for name in ("prototype", "prototype_with_loc"):
        np.testing.assert_allclose(getattr(tmem, name).numpy(),
                                   np.asarray(getattr(jmem, name)),
                                   rtol=0, atol=3e-4, err_msg=name)
    for name in ("semantic_label", "instance_label", "batch_index", "tag",
                 "valid"):
        np.testing.assert_array_equal(getattr(tmem, name).numpy(),
                                      np.asarray(getattr(jmem, name)),
                                      err_msg=name)

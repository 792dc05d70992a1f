"""The stage-2 classifier step and the softmax_classifier baseline of the
train step against the JAX package's on the CPU, two steps each from the
same weights (carried over by spml_tpu_torch.utils.from_jax) and batch,
float32, dropout 0 on both sides (the two RNG streams cannot match).

Tolerances, as tests/test_torch_train_step.py states them: metrics rtol
1e-4; the two steps' parameter and BN statistic updates (after minus
before) within 1e-2 * max|update| plus one float32 spacing of the
largest value (a BN scale near 1 moves by ~1e-6 a step, which its float32
spacing of 1.2e-7 resolves to 3% only). Under Adam the updates are held
as a whole, ||port - JAX|| <= 1e-2 * ||JAX|| in L2: Adam's step is
~lr * sign(gradient) for every element, so the few elements whose
gradient is float32 noise (10 of res3's 147456) step either way in
either framework. Exact: the frozen embedding model of stage 2 (every
parameter and BN buffer, torch.equal to its start) and the memory bank
of the baseline (never pushed: equal to its empty start).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from spml_tpu.config import load_config as jload_config
from spml_tpu.models.embeddings import (INIT_SAMPLE_HW, ClassifierHead,
                                        host_init)
from spml_tpu.train import classifier_step as jcstep
from spml_tpu.train import step as jstep
from spml_tpu_torch.config import load_config
from spml_tpu_torch.models.embeddings import build_embedding_model
from spml_tpu_torch.train import classifier_step as cstep
from spml_tpu_torch.train import step as tstep
from spml_tpu_torch.utils import from_jax

UPDATE_RTOL = 1e-2
OVERRIDES = {
    "network": {"backbone_types": "panoptic_deeplab_10",
                "embedding_dim": 8, "kmeans_num_clusters": [1, 1],
                "kmeans_iterations": 0},
    "dataset": {"num_classes": 4},
    "train": {"batch_size": 2, "crop_size": [32, 32], "max_iteration": 100,
              "warmup_iteration": 10},
    "tpu": {"segment_capacity": 32, "compute_dtype": "float32"},
}


def _batch():
    rng = np.random.RandomState(3)
    return {
        "image": rng.randn(2, 32, 32, 3).astype(np.float32),
        "semantic_label": rng.choice([0, 1, 2, 3, 255], (2, 32, 32)).astype(
            np.int32),
        "instance_label": rng.randint(0, 3, (2, 32, 32)).astype(np.int32),
        "semantic_tag": (rng.rand(2, 256) > 0.6).astype(np.int32),
    }


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close_update(name, got, before, want, whole=False):
    upd = np.asarray(want) - before
    got_upd = np.asarray(got) - before
    if whole:
        assert (np.linalg.norm(got_upd - upd)
                <= UPDATE_RTOL * np.linalg.norm(upd)), name
        return
    np.testing.assert_allclose(
        got_upd, upd, rtol=0,
        atol=(UPDATE_RTOL * max(np.abs(upd).max(), 1e-6)
              + np.spacing(np.abs(want).max())), err_msg=name)


def test_classifier_steps_match_jax():
    jcfg = jload_config(overrides=OVERRIDES)
    cfg = load_config(overrides=OVERRIDES)
    emb_def = jstep.build_models(jcfg)[0]
    evars = host_init(emb_def, jax.random.PRNGKey(1),
                      np.zeros((1, *INIT_SAMPLE_HW, 3), np.float32))
    head = ClassifierHead(num_classes=4, hidden_dim=16, dropout_rate=0.0,
                          dtype=jnp.float32)
    jst = jcstep.init_classifier_state(jcfg, jax.random.PRNGKey(2), 8)
    jfn = jax.jit(jcstep.make_classifier_train_step(jcfg, emb_def, evars,
                                                    head))

    emb = build_embedding_model("panoptic_deeplab_10", 8)
    emb.load_state_dict(from_jax.embedding_state_dict(
        _np(evars["params"]), _np(evars["batch_stats"])), strict=True)
    emb.train()  # the step must put it in eval mode itself
    frozen = {k: v.clone() for k, v in emb.state_dict().items()}
    st = cstep.init_classifier_state(cfg, 0, device="cpu")
    before = from_jax.classifier_state_dict(
        _np(jst.params["prediction"]), _np(jst.batch_stats["prediction"]))
    st.cls_model.load_state_dict(before, strict=True)
    assert st.cls_model.semantic_classifier[3].p == cstep.DROPOUT == 0.65
    st.cls_model.semantic_classifier[3].p = 0.0
    step = cstep.make_classifier_train_step(cfg, emb)

    nb = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    for i in range(2):
        jst, jm = jfn(jst, jbatch)
        st, tm = step(st, tbatch)
        assert set(tm) == set(jm) == {"loss", "accuracy", "learning_rate"}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    assert st.step == int(jst.step) == 2
    assert not emb.training
    for k, v in emb.state_dict().items():
        assert torch.equal(v, frozen[k]), k
    assert all(not p.requires_grad for p in emb.parameters())
    want = from_jax.classifier_state_dict(
        _np(jst.params["prediction"]), _np(jst.batch_stats["prediction"]))
    got = st.cls_model.state_dict()
    for k in want:
        if k.endswith("num_batches_tracked"):
            continue
        _close_update(k, got[k].numpy(), before[k].numpy(), want[k].numpy())


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_softmax_classifier_branch_matches_jax(optimizer):
    """prediction_types softmax_classifier: CE on the upsampled logits
    trains the backbone end to end; the bank is never pushed."""
    over = {**OVERRIDES,
            "network": {**OVERRIDES["network"],
                        "prediction_types": "softmax_classifier"},
            "train": {**OVERRIDES["train"], "optimizer": optimizer,
                      "memory_bank_size": 1}}
    jcfg = jload_config(overrides=over)
    cfg = load_config(overrides=over)
    jst = jstep.init_state(jcfg, jax.random.PRNGKey(0),
                           jnp.zeros((2, 32, 32, 3)))
    emb_def, _ = jstep.build_models(jcfg)
    head = ClassifierHead(num_classes=4, hidden_dim=16, dropout_rate=0.0,
                          dtype=jnp.float32)
    jfn = jax.jit(jstep.make_train_step(jcfg, emb_def, head))

    st = tstep.init_state(cfg, 0, torch.zeros(2, 32, 32, 3), device="cpu")
    p, s = _np(jst.params), _np(jst.batch_stats)
    st.emb_model.load_state_dict(from_jax.embedding_state_dict(
        p["embedding"], s["embedding"]), strict=True)
    st.cls_model.load_state_dict(from_jax.classifier_state_dict(
        p["prediction"], s["prediction"]), strict=True)
    st.cls_model.semantic_classifier[3].p = 0.0
    before = {k: v.clone() for k, v in st.emb_model.state_dict().items()}
    bank = {k: v.clone() for k, v in vars(st.memory).items()}
    step = tstep.make_train_step(cfg)

    nb = _batch()
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    for i in range(2):
        jst, jm = jfn(jst, jbatch)
        st, tm = step(st, tbatch)
        assert set(tm) == set(jm) == {"loss", "sem_ann_loss", "accuracy",
                                      "learning_rate"}
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    for k, v in vars(st.memory).items():
        assert torch.equal(v, bank[k]), k
    assert not st.memory.valid.any()
    want = from_jax.embedding_state_dict(_np(jst.params["embedding"]),
                                         _np(jst.batch_stats["embedding"]))
    got = st.emb_model.state_dict()
    for k in ("resnet_backbone.conv1.conv1.0.weight",  # frozen
              "resnet_backbone.res2.0.conv2.weight",  # frozen
              "resnet_backbone.res3.0.conv2.weight",
              "resnet_backbone.res4.0.bn1.weight",
              "resnet_backbone.res5.0.bn2.running_mean",
              "aspp.aspp_1.0.weight", "aspp.aspp_3.0.bias"):
        _close_update(k, got[k].numpy(), before[k].numpy(), want[k].numpy(),
                      whole=optimizer == "adam")
    for k in ("resnet_backbone.conv1.conv1.0.weight",
              "resnet_backbone.res2.0.conv2.weight"):
        assert torch.equal(got[k], before[k]), k
    assert not torch.equal(got["resnet_backbone.res5.0.conv2.weight"],
                           before["resnet_backbone.res5.0.conv2.weight"])
    if optimizer == "adam":
        assert st.adam_count == 2 and not st.momentum

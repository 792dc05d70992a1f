"""drivers/train.py::SegsortWork reads the fused losses' masks by their
parameter names, gives no bound where a call does not bind to them, and
refuses traced steps that made different numbers of calls."""

from __future__ import annotations

import types

import pytest
import torch

from portbench.drivers.train import SegsortWork


def _joint(embeddings, semantic_labels, own_segment_ids, semantic_tags,
           prototypes, prototype_labels, prototype_tags, kappa_ann,
           kappa_occ, ann_pixel_mask, occ_pixel_mask, prototype_mask,
           reduction="mean", compact=True, operand_dtype="float32"):
    return embeddings[:, 0], embeddings[:, 1]


def _hard(embeddings, semantic_labels, own_segment_ids, prototypes,
          prototype_semantic_labels, concentration, pixel_mask,
          prototype_mask, reduction="mean", compact=True,
          operand_dtype="float32"):
    return embeddings[:, 0]


def _renamed(embeddings, labels, own, protos, plab, kappa, rows, cols,
             reduction="mean"):
    return embeddings[:, 0]


def _lib(hard=_hard):
    return types.SimpleNamespace(fused_joint_losses=_joint,
                                 fused_segsort_loss=hard)


def _call_joint(lib, n=64, p=16, d=8, rows=10, protos=5):
    emb = torch.randn(n, d)
    ann = torch.zeros(n, dtype=torch.bool)
    ann[:rows] = True
    occ = torch.zeros(n, dtype=torch.bool)
    occ[rows:2 * rows] = True
    pm = torch.zeros(p, dtype=torch.bool)
    pm[:protos] = True
    lib.fused_joint_losses(emb, None, None, None, None, None, None, 6.0,
                           12.0, ann, occ, pm, reduction="none")


def test_masks_by_name_and_restored():
    lib = _lib()
    with SegsortWork(lib, keep=True) as work:
        for _ in range(2):
            _call_joint(lib)
            work.mark()
    assert lib.fused_joint_losses is _joint
    assert [c[:3] for c in work.calls] == [("joint", 64, 8)] * 2
    # carrying rows: ann | occ; valid prototypes: the prototype mask
    assert [int(c[3]) for c in work.calls] == [20, 20]
    assert [int(c[4]) for c in work.calls] == [5, 5]
    assert len(work.outputs) == 4 and work.bound_ms() > 0


def test_a_call_that_does_not_bind_reads_nothing():
    lib = _lib(hard=_renamed)
    with SegsortWork(lib) as work:
        lib.fused_segsort_loss(torch.randn(4, 2), None, None, None, None,
                               1.0, torch.ones(4, dtype=torch.bool),
                               torch.ones(3, dtype=torch.bool))
        work.mark()
    assert work.unbound and work.bound_ms() is None


def test_steps_with_different_calls_raise():
    lib = _lib()
    with SegsortWork(lib) as work:
        _call_joint(lib)
        work.mark()
        _call_joint(lib)
        _call_joint(lib)
        work.mark()
    with pytest.raises(RuntimeError):
        work.bound_ms()


def test_no_call_reads_nothing():
    with SegsortWork(_lib()) as work:
        work.mark()
    assert work.bound_ms() is None

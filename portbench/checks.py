"""The comparisons that decide `correct`, and their numbers.

Training (a cell's first three steps, which set-up drives through the
window's own call and feed), compared:
* loss_gap_step1: step 1's gap of each loss term over the reference's
  total. Step 1's forward starts from the same weights and batch, so it
  reads the loss arithmetic alone; steps 2 and 3 follow weights that
  the program's non-deterministic backward has already moved, and their
  gap (printed, not compared) is that noise;
* segsort_gap: step 1's SegSort losses pixel by pixel, as the fused
  kernels returned them, against the reference's dense ones (the mean
  gap over the masked pixels, the larger of sem_ann's and sem_occ's);
* grad_gap: the first gradient as SGD got it (from the momentum after
  step 1: buf = lr x multiplier x (g + wd p)), the worst leaf's gap of
  norms over the larger of its reference norm and the median leaf's;
* update_gap_median: the same gap of each leaf's change after the three
  steps, the median leaf (the worst leaf, printed, swings by about 0.1
  between equally exact runs of the program).
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out (a gradient nought to rounding, moved by round-off
alone).

Training, the window's state: once the window has closed, the program's
state as the window left it (weights, momentum, bank, step count,
dropout stream) is copied and one more step goes through the window's
call; the reference, started from that copy, takes the same step.
Compared:
* loss_gap_window: that step's gap of each loss term over the
  reference's total;
* step_gap_window: the step's momentum increment (buf after - momentum
  x buf before = lr x multiplier x (g + wd p), so the learning rate past
  warm-up too), the worst leaf's gap of norms as grad_gap's;
* update_gap_window: the step's change of each leaf, the worst leaf;
* bank_gap_window (a cell with a memory bank): the prototypes the step
  pushed, the mean over the entries valid on either side of their gap
  (1 where validity or label differ).

Inference (each pool image as the window last predicted it): the
stitched embeddings, the k-means segment of each valid pixel, each
segment's top-20 labels and the prediction, against the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import train as ref_train

SKIP_BELOW = 1e-3  # of the median leaf's reference gradient norm


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double().cpu()))
            for k, v in leaves.items()}


def leaf_gaps(prog: dict, ref: dict, keep) -> list:
    """Each leaf's |‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖); a leaf
    missing on the program's side has norm 0."""
    rn = _norms({k: ref[k] for k in keep})
    pn = _norms({k: prog[k] for k in keep if k in prog})
    med = float(np.median(list(rn.values())))
    return [abs(pn.get(k, 0.0) - rn[k]) / max(rn[k], med) for k in keep]


def gradient_from_momentum(buf: dict, p0: dict, train_cfg: dict) -> dict:
    """The step-1 gradient of each leaf from its SGD momentum after one
    step (a leaf without a buffer: none)."""
    lr = ref_train.learning_rate(train_cfg, 0)
    wd = train_cfg["weight_decay"]
    out = {}
    for k, b in buf.items():
        mult, decay = ref_train.group(k)
        g = b.double() / (lr * mult)
        out[k] = g - wd * p0[k].double().cpu() if decay else g
    return out


def train_numbers(prog: dict, ref: dict, p0: dict):
    """(numbers compared, numbers printed beside them) of prog against
    ref: {losses: [{term: value}] a step, grad: {leaf: g}, theta: {leaf:
    after the steps}}; p0: the initial leaves (CPU)."""
    gaps = []
    for lp, lr in zip(prog["losses"], ref["losses"]):
        gaps.append(max(abs(lp.get(k, float("nan")) - v) / abs(lr["loss"])
                        for k, v in lr.items()))  # each term over the total
    if len(prog["losses"]) != len(ref["losses"]):
        gaps = [float("inf")] * len(ref["losses"])
    rn = _norms(ref["grad"])
    med = float(np.median(list(rn.values())))
    keep = [k for k, v in rn.items() if v >= SKIP_BELOW * med]
    moved_p = {k: prog["theta"][k].double() - p0[k].double() for k in keep}
    moved_r = {k: ref["theta"][k].double() - p0[k].double() for k in keep}
    update = leaf_gaps(moved_p, moved_r, keep)
    numbers = {"loss_gap_step1": gaps[0],
               "segsort_gap": segsort_gap(prog.get("segsort", []),
                                          ref.get("segsort", [])),
               "grad_gap": max(leaf_gaps(prog["grad"], ref["grad"], keep)),
               "update_gap_median": float(np.median(update))}
    info = {"loss_gap_later_steps": max(gaps[1:], default=0.0),
            "update_gap_worst_leaf": max(update), "leaves": len(keep)}
    return numbers, info


def momentum_increment(before: dict, after: dict, momentum: float) -> dict:
    """{leaf: after - momentum x before} in float64 on the CPU; a leaf
    missing on either side counts as zeros."""
    out = {}
    for k in set(before) | set(after):
        b = before.get(k)
        a = after.get(k, None if b is None else torch.zeros_like(b))
        b = torch.zeros_like(a) if b is None else b
        out[k] = a.double().cpu() - momentum * b.double().cpu()
    return out


def bank_gap(prog: dict, ref: dict) -> float:
    """The newest bank slot ({prototype, semantic, valid}: [B x cap,
    ...]) of prog against ref: the mean over the entries valid on either
    side of |prototype gap|, 1 where validity or label differ."""
    vp, vr = prog["valid"].bool().cpu(), ref["valid"].bool().cpu()
    either = vp | vr
    if not either.any():
        return 0.0
    same = (vp == vr) & (prog["semantic"].cpu() == ref["semantic"].cpu())
    gap = torch.linalg.vector_norm(prog["prototype"].double().cpu()
                                   - ref["prototype"].double().cpu(), dim=-1)
    gap = torch.where(same, gap, torch.ones_like(gap))
    return float(gap[either].mean())


def window_numbers(prog: dict, ref: dict, momentum: float) -> dict:
    """The step after the window of prog against ref, each {losses:
    {term: value}, buf0, buf1: momentum before and after, theta0,
    theta1: leaves before and after, grad (ref only): {leaf: g}, bank:
    the newest slot or None}."""
    rn = _norms(ref["grad"])
    med = float(np.median(list(rn.values())))
    keep = [k for k, v in rn.items() if v >= SKIP_BELOW * med]
    lr = ref["losses"]
    step_p = momentum_increment(prog["buf0"], prog["buf1"], momentum)
    step_r = momentum_increment(ref["buf0"], ref["buf1"], momentum)
    moved_p = {k: prog["theta1"][k].double() - prog["theta0"][k].double()
               for k in keep}
    moved_r = {k: ref["theta1"][k].double() - ref["theta0"][k].double()
               for k in keep}
    out = {"loss_gap_window": max(
               abs(prog["losses"].get(k, float("nan")) - v) / abs(lr["loss"])
               for k, v in lr.items()),
           "step_gap_window": max(leaf_gaps(step_p, step_r, keep)),
           "update_gap_window": max(leaf_gaps(moved_p, moved_r, keep))}
    if ref.get("bank") is not None:
        out["bank_gap_window"] = bank_gap(prog["bank"], ref["bank"])
    return out


def follow(reference, ring, steps: int) -> dict:
    """The reference through `steps` steps of the ring: {losses, grad,
    theta, segsort} on the CPU (grad and segsort: step 1's)."""
    losses, grad, segsort = [], None, None
    for i in range(steps):
        got, g = reference.step(ring[i])
        losses.append(got)
        if grad is None:
            grad = {k: v.detach().cpu() for k, v in g.items()}
            segsort = [(ll.cpu(), m.cpu()) for ll, m in reference.segsort]
    theta = {k: v.cpu() for k, v in reference.weights().items()}
    return {"losses": losses, "grad": grad, "theta": theta,
            "segsort": segsort}


def segsort_gap(prog: list, ref: list) -> float:
    """Step 1's SegSort losses pixel by pixel: the largest over the
    losses (sem_ann; sem_occ) of the mean |NLL gap| (nats) over the
    pixels both sides mask in; inf when the program made none."""
    if len(prog) != len(ref):
        return float("inf")
    gap = 0.0
    for (lp, mp), (lr, mr) in zip(prog, ref):
        both = mp.bool() & mr.bool()
        if both.any():
            d = (lp.double() - lr.double()).abs()[both]
            gap = max(gap, float(d.mean()))
    return gap


def infer_numbers(prog: list, ref: list) -> dict:
    """prog / ref: one dict an image {stitched, ids, topk, pred, valid}
    (ref also valid); shares in %."""
    gap, moved, seg_n, seg_bad, pix_n, pix_bad = 0.0, 0, 0, 0, 0, 0
    for p, r in zip(prog, ref):
        v = r["valid"].cpu()
        st = (p["stitched"].float().cpu() - r["stitched"].cpu()).abs()
        gap = max(gap, float(st.reshape(-1, st.shape[-1])[v].max()))
        ids_p, ids_r = p["ids"].cpu(), r["ids"].cpu()
        moved += int((ids_p[v] != ids_r[v]).sum())
        present = torch.zeros(r["topk"].shape[0], dtype=torch.bool)
        present[ids_r[v]] = True
        seg_n += int(present.sum())
        seg_bad += int((p["topk"].cpu()[present] != r["topk"].cpu()[present]
                        ).any(1).sum())
        pred_p = torch.as_tensor(np.asarray(p["pred"])).long()
        pix_n += pred_p.numel()
        pix_bad += int((pred_p != r["pred"].cpu().long()).sum())
    return {"stitched_max_gap": gap,
            "segment_pixels_moved": 100.0 * moved / max(pix_n, 1),
            "topk_segments_differ": 100.0 * seg_bad / max(seg_n, 1),
            "prediction_pixels_differ": 100.0 * pix_bad / max(pix_n, 1)}

"""Plain PyTorch SPML train step (twke18/SPML: pyscripts/train/train.py
:154-293, spml/models/predictions/segsort_softmax.py:103-242 and
segsort_softmax_densepose.py, spml/utils/segsort/loss.py 'segsort+',
lib/nn/optimizer.py SGD), for one process, followed from the seed
through its first steps. Imports nothing of the program.

A step: embeddings and local features ([y, x], DensePose also colour)
-> per-image k-means segments (segments.py, no gradient) -> prototypes,
the normalized per-segment sums, joined with the memory bank -> losses:

* sem_ann = (CE of the classifier on the detached embeddings + SegSort
  over semantic labels) x weight;
* sem_occ (VOC) = SetSegSort over the dataset-level tags (the sets
  intersect or not) x weight;
* img_sim = per image SegSort over instance labels (VOC on [embedding,
  location], DensePose on the embeddings), meaned over images x weight.

SegSort ('segsort+'): sims = exp(kappa * cos) against every valid
prototype; numerator = the same-label sims minus the own one when that
is positive, else the own sim; loss = -log(numerator / (numerator +
different-label sims)), meaned over the masked pixels. Dense [N, P]
matrices, computed here in float32 with TF32 off.

Then SGD in the reference's order: d = (g + wd p [weights]) x group
multiplier x lr, buf = momentum buf + d, p -= buf; groups: stem and res2
frozen, res3-5 weights x1 / biases x2, heads x10 / x20; lr the poly
schedule with linear warm-up from 0.1 x base. The bank FIFOs each step's
prototypes, earlier batch indices shifted by the batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import model as net_lib
from portbench.reference import segments as seg_lib


def group(name: str):
    """(multiplier, weight decay) of a parameter, None when frozen."""
    parts = name.split(".")
    bias = parts[-1] == "bias"
    if "resnet_backbone" in parts:
        if parts[parts.index("resnet_backbone") + 1] in ("conv1", "res2"):
            return None
        return (2.0, False) if bias else (1.0, True)
    return (20.0, False) if bias else (10.0, True)


def learning_rate(t: dict, step: int) -> float:
    left = 1.0 - step / t["max_iteration"]
    poly = t["base_lr"] * left ** 0.9
    if step < t["warmup_iteration"]:
        a = step / t["warmup_iteration"]
        return min(t["base_lr"] * (0.1 * (1.0 - a) + a), poly)
    return poly


def segsort_nll(emb, protos, same, diff, own, kappa):
    """[N] -log p of each pixel's own segment ('segsort+'); same / diff
    [N, P] bool, own [N] column index."""
    s = torch.exp(kappa * (emb @ protos.T))
    own_s = s.gather(1, own[:, None])[:, 0]
    same_s = torch.where(same, s, 0.0).sum(1) - own_s
    num = torch.where(same_s > 0, same_s, own_s)
    return -torch.log(num / (torch.where(diff, s, 0.0).sum(1) + num))


def masked_mean(v, m):
    m = m.float()
    return (v * m).sum() / m.sum().clamp(min=1.0)


class Reference:
    """The plain step of one configuration (the overrides dict of its
    file), from the state dicts `emb_w`, `cls_w` and dropout seed."""

    def __init__(self, cfg: dict, emb_w: dict, cls_w: dict,
                 dropout_seed: int, device, lower: str | None = None,
                 tf32: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        self.net_cfg, self.t = cfg["network"], cfg["train"]
        self.tpu, self.c = cfg["tpu"], cfg["dataset"]["num_classes"]
        self.densepose = "densepose" in self.net_cfg["backbone_types"]
        self.w = {**{f"embedding.{k}": v.clone() for k, v in emb_w.items()},
                  **{f"prediction.{k}": v.clone() for k, v in cls_w.items()}}
        self.params = {k: v.requires_grad_(True) for k, v in self.w.items()
                       if v.is_floating_point() and group(k) is not None
                       and not k.endswith(("running_mean", "running_var"))}
        self.buf = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.gen = torch.Generator(device).manual_seed(dropout_seed)
        self.lower, self.device = lower, device
        self.bank = None
        self.step_count = 0
        self.segsort = []  # the last step's [(per-pixel SegSort NLL, mask)]

    def resume(self, buf: dict, bank: dict, step_count: int,
               generator_state: torch.Tensor) -> "Reference":
        """Continue from a state taken after some steps: the momentum
        buffers ({leaf: tensor}; a leaf without one starts at zero), the
        bank ({prototype, semantic, valid, tag, batch}: [M, B x cap,
        ...]), the step count and the dropout generator's state."""
        for k, v in buf.items():
            self.buf[k] = v.to(self.device, copy=True)
        self.bank = {k: v.to(self.device, copy=True) for k, v in bank.items()}
        self.step_count = step_count
        self.gen.set_state(generator_state)
        return self

    def _net(self, prefix):
        w = {k[len(prefix):]: v for k, v in self.w.items()
             if k.startswith(prefix)}
        return net_lib.Net(w, self.net_cfg["backbone_types"], lower=self.lower)

    def losses(self, batch):
        """{term: loss} and the step's prototypes for the bank."""
        t, c, dev = self.t, self.c, self.device
        images = batch["image"]
        b, hh, ww = images.shape[:3]
        emb = self._net("embedding.").embeddings(images)
        _, h, w, d = emb.shape
        n = h * w
        loc = net_lib.location(h, w, dev)[None].expand(b, h, w, 2)
        if self.densepose:
            loc = torch.cat([loc, net_lib.colour(images, (h, w))], -1)
        ys = torch.floor(torch.arange(h, dtype=torch.float32)
                         * (hh / h)).long().to(dev)
        xs = torch.floor(torch.arange(w, dtype=torch.float32)
                         * (ww / w)).long().to(dev)
        small = lambda lab: lab.long()[:, ys][:, :, xs]  # nearest resize
        sem, inst = small(batch["semantic_label"]), small(
            batch["instance_label"])
        cap = self.tpu["segment_capacity"]
        with torch.no_grad():
            seg = seg_lib.segments(
                emb.detach(), loc, sem, inst,
                tuple(self.net_cfg["kmeans_num_clusters"]), cap,
                self.net_cfg["kmeans_iterations"], 255)
        e = seg_lib.normalize(emb.float()).reshape(b, n, d)
        e_part = e * 0.1 if self.densepose else e
        e_loc = seg_lib.normalize(torch.cat([e_part, loc.reshape(b, n, -1)],
                                            -1))
        wts = seg["pixel_valid"].float()

        def protos(x):
            return seg_lib.normalize(seg_lib.cluster_sums(x, seg["ids"], cap,
                                                          wts))

        p, p_loc = protos(e), protos(e_loc)
        cur = {"prototype": p.reshape(b * cap, d),
               "semantic": seg["semantic"].reshape(-1),
               "valid": seg["valid"].reshape(-1),
               "tag": batch["semantic_tag"].long().repeat_interleave(cap, 0),
               "batch": torch.arange(b, device=dev).repeat_interleave(cap)}
        mem = t["memory_bank_size"]
        if self.bank is None:
            self.bank = {k: torch.zeros((max(mem, 1),) + v.shape,
                                        dtype=v.dtype, device=dev)
                         for k, v in cur.items()}
        if mem > 0:
            all_ = {k: torch.cat([cur[k], self.bank[k].reshape(
                (-1,) + cur[k].shape[1:])]) for k in cur}
        else:
            all_ = cur
        pix_sem = sem.reshape(-1)
        pix_own = (seg["ids"] + torch.arange(b, device=dev)[:, None]
                   * cap).reshape(-1)
        pix_valid = seg["pixel_valid"].reshape(-1)
        out = {}

        # CE of the classifier on the detached normalized embeddings
        logits = self._net("prediction.").classifier(
            seg_lib.normalize(emb.float()).detach(), self.gen)
        logits = F.interpolate(logits.permute(0, 3, 1, 2), size=(hh, ww),
                               mode="bilinear", align_corners=False
                               ).permute(0, 2, 3, 1)
        lab = batch["semantic_label"].long()
        ok = lab < c
        nll = -torch.gather(F.log_softmax(logits, -1), -1,
                            torch.where(ok, lab, 0)[..., None])[..., 0]
        ce = masked_mean(nll, ok)

        rows = e.reshape(-1, d)
        pv = all_["valid"]
        ann_pix = pix_valid & (pix_sem < c)
        ann_proto = pv & (all_["semantic"] < c)
        same = (pix_sem[:, None] == all_["semantic"][None, :]) & ann_proto
        diff = (pix_sem[:, None] != all_["semantic"][None, :]) & ann_proto
        ann_ll = segsort_nll(rows, all_["prototype"], same, diff, pix_own,
                             t["sem_ann_concentration"])
        self.segsort = [(ann_ll.detach(), ann_pix)]
        ann = masked_mean(ann_ll, ann_pix)
        out["sem_ann_loss"] = (ce + ann) * t["sem_ann_loss_weight"]
        if t.get("sem_occ_loss_types", "segsort") != "none":
            ptag = (all_["tag"][:, 1:c] > 0).float()
            img_tag = (batch["semantic_tag"].long()[:, 1:c] > 0).float()
            inter = ((img_tag @ ptag.T) > 0).repeat_interleave(n, 0)
            occ_ll = segsort_nll(rows, all_["prototype"], inter & pv,
                                 ~inter & pv, pix_own,
                                 t["sem_occ_concentration"])
            self.segsort.append((occ_ll.detach(), pix_valid))
            occ = masked_mean(occ_ll, pix_valid)
            out["sem_occ_loss"] = occ * t["sem_occ_loss_weight"]
        # img_sim: per image over instance labels, meaned over images
        xi, pi = (e, p) if self.densepose else (e_loc, p_loc)
        per_img, has = [], []
        for i in range(b):
            same = ((inst[i].reshape(-1)[:, None]
                     == seg["instance"][i][None, :]) & seg["valid"][i])
            diff = ((inst[i].reshape(-1)[:, None]
                     != seg["instance"][i][None, :]) & seg["valid"][i])
            ll = segsort_nll(xi[i], pi[i], same, diff, seg["ids"][i],
                             t["img_sim_concentration"])
            per_img.append(masked_mean(ll, seg["pixel_valid"][i]))
            has.append(seg["pixel_valid"][i].any())
        out["img_sim_loss"] = masked_mean(torch.stack(per_img), torch.stack(
            has)) * t["img_sim_loss_weight"]
        return out, cur

    def step(self, batch):
        """One step; returns ({term: float}, {leaf: gradient}) with the
        gradients as the optimizer gets them."""
        out, cur = self.losses(batch)
        total = sum(out.values())
        names = list(self.params)
        grads = torch.autograd.grad(total, [self.params[k] for k in names],
                                    allow_unused=True)
        lr = learning_rate(self.t, self.step_count)
        wd, mom = self.t.get("weight_decay", 5e-4), self.t.get("momentum",
                                                              0.9)
        got = {}
        with torch.no_grad():
            for k, g in zip(names, grads):
                if g is None:
                    continue
                got[k] = g
                mult, decay = group(k)
                p = self.params[k]
                dk = (g + wd * p) if decay else g.clone()
                self.buf[k].mul_(mom).add_(dk * mult * lr)
                p.sub_(self.buf[k])
            b, gb = self.bank, b_images(cur, self.tpu["segment_capacity"])
            for k, v in cur.items():
                b[k] = torch.cat([b[k][1:], v.detach()[None].to(b[k].dtype)])
            b["batch"] += gb  # every entry's batch index, the new ones too
        self.step_count += 1
        losses = {k: float(v.detach()) for k, v in out.items()}
        losses["loss"] = sum(losses.values())
        return losses, got

    def weights(self) -> dict:
        return {k: v.detach() for k, v in self.params.items()}


def b_images(cur: dict, capacity: int) -> int:
    """The images of a step's prototypes."""
    return cur["batch"].shape[0] // capacity

"""Inference engine: sliding-window embeddings, per-image clustering,
memory-bank entries and KNN semantic prediction, single scale.

Port of spml_tpu/inference/engine.py (reference in twke18/SPML:
pyscripts/inference/inference.py:114-228, the sliding window with
overlap-averaged L2-normalized embeddings, fake zero labels padded with
ignore, k-means, then the KNN vote; spml/models/predictions/segsort.py:
68-125, per-cluster prototypes, top-20 KNN against the memory bank,
majority vote, scatter to pixels; pyscripts/inference/prototype.py:
150-227, the memory bank's prototypes with the majority ground-truth label
of each cluster).

The padded image stays on the device from the window forward to the
labels; only the image goes up and the labels, prototypes or
probabilities come down. Each public method runs the one path that the
JAX package's `fused=True` form runs (its eager twin is equal by the JAX
package's own tests), so there is no `fused` flag. Nothing here has a
counterpart of `warmup`, which pre-compiles the XLA programs of each pad
bucket: eager PyTorch has nothing to compile. `predict_semantic_batch`
runs a group of images through one window forward on one device (the
JAX package's with mesh=None).

The multi-scale members (engine.py:553-743 in the JAX package) are built
from the base image on the device (device_member_resize); both flips of
a scale share one window forward (eval BN: each window's result is its
own), and each member's k-means runs under its own bucket's fake labels.
WindowEngine holds what the KNN engine and the softmax engine
(inference/softmax.py) share: buckets, upload, windows and members.

Under a torch profiler predict_semantic is one spml.infer.image span and
upload_image one spml.infer.upload span (utils/spans.py).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from spml_tpu_torch.data import transforms
from spml_tpu_torch.inference import msc
from spml_tpu_torch.ops import common, kmeans, knn
from spml_tpu_torch.utils.device import float32_matmuls, resolve_device
from spml_tpu_torch.utils.spans import span

TOP_K = 20  # retrieved prototypes per segment (segsort.py:68-125)
LABEL_BINS = 256  # histogram bins of the ground-truth labels (uint8)


def patch_ends(pad: int, crop: int, stride: int) -> np.ndarray:
    """End indices of the sliding windows along one axis
    (inference.py:164-171)."""
    n = int(math.ceil((pad - crop) / stride)) + 1
    return np.linspace(crop, pad, n).astype(np.int32)


def bucket_dim(size: int, crop: int, stride: int) -> int:
    """A padded dimension rounded up to crop + k * stride."""
    if size <= crop:
        return crop
    k = int(math.ceil((size - crop) / stride))
    return crop + k * stride


def device_member_resize(base: torch.Tensor, base_hw, member_hw, flip: bool,
                         member_bucket) -> torch.Tensor:
    """One pyramid member [Hb, Wb, 3] float32 from the padded base image on
    the device: the valid base_hw region resized bilinearly to member_hw
    (cv2.INTER_LINEAR, inference_msc.py:150-160), flipped horizontally
    inside the valid region when flip (the bucket padding stays at the
    bottom right), zero past member_hw up to the member's bucket."""
    member = msc.bilinear_resize(base.float(), base_hw, member_hw,
                                 out_shape=member_bucket, flip=flip)
    rows = torch.arange(member_bucket[0], device=base.device)[:, None]
    cols = torch.arange(member_bucket[1], device=base.device)[None, :]
    inside = (rows < member_hw[0]) & (cols < member_hw[1])
    return torch.where(inside[..., None], member, 0.0)


class WindowEngine:
    """What the sliding-window engines of one embedding model share on
    one device: pad buckets, the image upload, the windows' embeddings
    and the multi-scale members.

    emb_model: the port's EmbeddingModel (moved to `device`, put in eval
    mode: running-average BN). Images are [H, W, 3] float32 numpy arrays,
    already resized and normalized.

    Turns TF32 off (utils/device.py::float32_matmuls), as the train
    steps do: near-ties of the affinities decide cluster and retrieved
    labels. Subclasses define
    member_probs(members [n, Hb, Wb, 3], member_hw, *member_args) ->
    [n, Hb, Wb, C] probabilities.
    """

    def __init__(self, config, emb_model, device="cuda"):
        float32_matmuls()
        self.device = resolve_device(device)
        self.config = config
        self.emb_model = emb_model.to(self.device).eval()
        self.crop = tuple(config.test.crop_size)
        self.stride = tuple(config.test.stride)
        self.pad_buckets = bool(config.tpu.pad_to_stride_buckets)
        # with bf16 convs the image goes up in bf16, as the JAX engine
        # uploads it; only colour features read the rounded pixels again
        self.img_dtype = (torch.bfloat16
                          if config.tpu.compute_dtype == "bfloat16"
                          else torch.float32)

    def bucket_shape(self, h: int, w: int) -> tuple[int, int]:
        """The padded shape of an h x w image: buckets of crop + k *
        stride, or just the crop's size at least."""
        if not self.pad_buckets:
            return max(h, self.crop[0]), max(w, self.crop[1])
        return (bucket_dim(h, self.crop[0], self.stride[0]),
                bucket_dim(w, self.crop[1], self.stride[1]))

    def upload_image(self, image: np.ndarray) -> torch.Tensor:
        """[H, W, 3] image bucket-padded with zeros (bottom and right), on
        the device in the image dtype."""
        with span("spml.infer.upload"):
            pad = self.bucket_shape(*image.shape[:2])
            img = transforms.resize_with_pad(image, pad, 0.0)
            return torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(
                self.device).to(self.img_dtype)

    def windows(self, pad_h: int, pad_w: int) -> list[tuple[int, int]]:
        """Top-left corners of the sliding windows, row-major."""
        ch, cw = self.crop
        return [(int(eh) - ch, int(ew) - cw)
                for eh in patch_ends(pad_h, ch, self.stride[0])
                for ew in patch_ends(pad_w, cw, self.stride[1])]

    def patches(self, img: torch.Tensor) -> torch.Tensor:
        """The windows of a padded image [..., Hb, Wb, 3] (a batch of one
        shape or one image): [n_windows, ..., crop_h, crop_w, 3]."""
        ch, cw = self.crop
        return torch.stack([img[..., sh:sh + ch, sw:sw + cw, :]
                            for sh, sw in self.windows(*img.shape[-3:-1])])

    @torch.no_grad()
    def embed_windows(self, img: torch.Tensor) -> torch.Tensor:
        """Every window of a padded image [..., Hb, Wb, 3] through one
        batched forward: [n_windows, ..., crop_h, crop_w, D] L2-normalized
        float32."""
        patches = self.patches(img)
        emb, _ = self.emb_model(patches.flatten(0, -4),
                                resize_as_input=True)
        emb = common.normalize_embedding(emb.float())
        return emb.reshape(*patches.shape[:-1], emb.shape[-1])

    def sum_windows(self, values: torch.Tensor, pad_h: int,
                    pad_w: int) -> torch.Tensor:
        """Window values [n_windows, ..., crop_h, crop_w, K] summed into
        the [..., pad_h, pad_w, K] map in window order."""
        ch, cw = self.crop
        total = torch.zeros(*values.shape[1:-3], pad_h, pad_w,
                            values.shape[-1], device=values.device)
        for v, (sh, sw) in zip(values, self.windows(pad_h, pad_w)):
            total[..., sh:sh + ch, sw:sw + cw, :] += v
        return total

    # -- multi-scale members --

    def members(self, base: torch.Tensor, base_hw, member_hw,
                flips) -> torch.Tensor:
        """The members [len(flips), Hb, Wb, 3] of one scale, in the member
        size's bucket."""
        bucket = self.bucket_shape(*member_hw)
        return torch.stack([device_member_resize(base, base_hw, member_hw,
                                                 f, bucket) for f in flips])

    def predict_member_probs(self, base: torch.Tensor, base_hw, member_hw,
                             flip: bool, *member_args) -> torch.Tensor:
        """One member's probabilities [Hb, Wb, C] in its bucket from the
        padded base image on the device (base_hw its valid size), still
        flipped when flip."""
        return self.member_probs(
            self.members(base, base_hw, member_hw, (flip,)), member_hw,
            *member_args)[0]

    def predict_member_pair_probs(self, base: torch.Tensor, base_hw,
                                  member_hw, *member_args) -> torch.Tensor:
        """Both flips of one scale through one window forward: [2, Hb, Wb,
        C], index 1 still flipped."""
        return self.member_probs(
            self.members(base, base_hw, member_hw, (False, True)),
            member_hw, *member_args)

    def accumulate_member_pair(self, acc: torch.Tensor, base: torch.Tensor,
                               base_hw, member_hw,
                               *member_args) -> torch.Tensor:
        """acc [h, w, C] plus both flips' probabilities of one scale,
        resized to acc's size and un-flipped."""
        pair = self.predict_member_pair_probs(base, base_hw, member_hw,
                                              *member_args)
        acc = msc.resize_accumulate(acc, pair[0], member_hw, flip=False)
        return msc.resize_accumulate(acc, pair[1], member_hw, flip=True)


class InferenceEngine(WindowEngine):
    """KNN inference of one embedding model on one device (WindowEngine's
    arguments); memory banks are (prototypes [P, D], labels [P], valid
    [P]) tensors or arrays."""

    def memory(self, prototypes, labels, valid):
        """A memory bank as tensors on the engine's device."""
        return (torch.as_tensor(prototypes, dtype=torch.float32,
                                device=self.device),
                torch.as_tensor(labels, device=self.device),
                torch.as_tensor(valid, dtype=torch.bool,
                                device=self.device))

    # -- the stages of one image, each on the device --

    def overlap_average(self, emb: torch.Tensor, pad_h: int,
                        pad_w: int) -> torch.Tensor:
        """Window embeddings summed into the [..., pad_h, pad_w, D] map in
        window order, over the count of windows at each pixel."""
        ones = torch.ones(emb.shape[0], *self.crop, 1, device=emb.device)
        return (self.sum_windows(emb, pad_h, pad_w)
                / self.sum_windows(ones, pad_h, pad_w))

    def stitch(self, img: torch.Tensor) -> torch.Tensor:
        """Padded image(s) [..., Hb, Wb, 3] -> overlap-averaged embedding
        map [..., Hb, Wb, D]."""
        return self.overlap_average(self.embed_windows(img),
                                    *img.shape[-3:-1])

    @torch.no_grad()
    def segment(self, emb_map: torch.Tensor, hw: tuple[int, int]):
        """k-means of the map under fake labels (0 inside the valid h x w,
        ignore outside); returns (segment id of each pixel [Hb * Wb],
        prototypes [ky * kx, D], segment valid [ky * kx])."""
        h, w, _ = emb_map.shape
        net = self.config.network
        ignore = self.config.dataset.semantic_ignore_index
        k_clusters = tuple(net.kmeans_num_clusters)
        capacity = k_clusters[0] * k_clusters[1]
        rows = torch.arange(h, device=emb_map.device)[:, None]
        cols = torch.arange(w, device=emb_map.device)[None, :]
        fake = torch.where((rows < hw[0]) & (cols < hw[1]), 0, ignore)
        loc = common.generate_location_features(h, w,
                                                device=emb_map.device) - 0.5
        segs, emb_flat = kmeans.segment_batch_single_group(
            emb_map[None], loc[None], fake[None], k_clusters,
            net.kmeans_iterations, ignore)
        seg_ids = segs.pixel_segment_ids[0]
        protos = kmeans.calculate_prototypes_from_labels(
            emb_flat[0], seg_ids, capacity, segs.pixel_valid[0].float())
        return seg_ids, protos, segs.segment_valid[0]

    @torch.no_grad()
    def retrieve(self, protos: torch.Tensor, seg_valid: torch.Tensor,
                 memory) -> torch.Tensor:
        """Labels of each segment's top-20 bank prototypes
        [ky * kx, 20] (ties to the lower bank index)."""
        mem_p, mem_l, mem_v = memory
        queries = torch.zeros(protos.shape[0], dtype=torch.long,
                              device=protos.device)
        return knn.top_k_ranking(protos, queries, mem_p, mem_l, TOP_K,
                                 seg_valid, mem_v)[1]

    def vote(self, topk: torch.Tensor, seg_ids: torch.Tensor,
             shape: tuple[int, int]) -> torch.Tensor:
        """Majority label of each segment, gathered to its pixels."""
        majority = knn.majority_label_from_topk(
            topk, self.config.dataset.num_classes)
        return majority[seg_ids].reshape(shape)

    @staticmethod
    def majority_labels(seg_ids: torch.Tensor, labels: torch.Tensor,
                        valid: torch.Tensor, num_segments: int,
                        num_bins: int = LABEL_BINS) -> torch.Tensor:
        """Most frequent valid label of each segment (a segment with none
        gets 0, the argmax of an empty histogram), int32."""
        keep = valid & (labels >= 0) & (labels < num_bins)
        counts = torch.bincount((seg_ids * num_bins + labels)[keep],
                                minlength=num_segments * num_bins)
        return counts.reshape(num_segments, num_bins).argmax(-1).int()

    # -- per image --

    def stitched_embeddings(self, image: np.ndarray) -> torch.Tensor:
        """Overlap-averaged normalized embeddings [Hb, Wb, D] of one
        image, on the device."""
        return self.stitch(self.upload_image(image))

    def _topk(self, image: np.ndarray, memory):
        h, w = image.shape[:2]
        img = self.upload_image(image)
        seg_ids, protos, seg_valid = self.segment(self.stitch(img), (h, w))
        topk = self.retrieve(protos, seg_valid, self.memory(*memory))
        return topk, seg_ids, tuple(img.shape[:2])

    def predict_semantic(self, image: np.ndarray, memory_protos,
                         memory_labels, memory_valid) -> np.ndarray:
        """Single-scale KNN prediction of one (resized) image: [H, W]
        int32 classes."""
        h, w = image.shape[:2]
        with span("spml.infer.image"):
            topk, seg_ids, pad = self._topk(
                image, (memory_protos, memory_labels, memory_valid))
            pred = self.vote(topk, seg_ids, pad)
            return pred[:h, :w].cpu().numpy().astype(np.int32)

    def predict_semantic_batch(self, images, memory_protos, memory_labels,
                               memory_valid) -> list[np.ndarray]:
        """Single-scale KNN prediction of a group of (resized) images: each
        padded to the group's largest bucket, every window of the group
        through one forward, then clustering, retrieval and vote per
        image; per-image [h, w] int32 classes. Retrieval stays per image,
        each image's segments one call of knn.top_k_ranking (on the card
        two kernel launches that write no [segments, bank] score matrix;
        no path batches it across images). An image in the group's own
        bucket gets predict_semantic's result; a smaller bucket's image
        sees another window grid (runner.py groups by bucket)."""
        if not images:
            return []
        shapes = [im.shape[:2] for im in images]
        pads = [self.bucket_shape(h, w) for h, w in shapes]
        pad = (max(p[0] for p in pads), max(p[1] for p in pads))
        imgs = np.stack([transforms.resize_with_pad(im, pad, 0.0)
                         for im in images]).astype(np.float32, copy=False)
        imgs = torch.from_numpy(imgs).to(self.device).to(self.img_dtype)
        memory = self.memory(memory_protos, memory_labels, memory_valid)
        preds = []
        for emb_map, (h, w) in zip(self.stitch(imgs), shapes):
            seg_ids, protos, seg_valid = self.segment(emb_map, (h, w))
            topk = self.retrieve(protos, seg_valid, memory)
            preds.append(self.vote(topk, seg_ids, pad)[:h, :w])
        return [p.cpu().numpy().astype(np.int32) for p in preds]

    @torch.no_grad()
    def cluster_probs(self, emb_map: torch.Tensor, hw: tuple[int, int],
                      memory) -> torch.Tensor:
        """[Hb, Wb, C] probabilities of a stitched map under fake labels
        of valid size hw: each segment's mean one-hot of its top-20
        retrieved labels (inference_msc.py:221-240)."""
        c = self.config.dataset.num_classes
        seg_ids, protos, seg_valid = self.segment(emb_map, hw)
        topk = self.retrieve(protos, seg_valid, memory)
        seg_probs = common.one_hot(topk, c).mean(dim=1)
        return seg_probs[seg_ids].reshape(*emb_map.shape[:2], c)

    def predict_topk_probs(self, image: np.ndarray, memory_protos,
                           memory_labels, memory_valid) -> np.ndarray:
        """[H, W, C] float32 probabilities of one image (cluster_probs)."""
        h, w = image.shape[:2]
        probs = self.cluster_probs(
            self.stitched_embeddings(image), (h, w),
            self.memory(memory_protos, memory_labels, memory_valid))
        return probs[:h, :w].cpu().numpy()

    def member_probs(self, members: torch.Tensor, member_hw, memory_protos,
                     memory_labels, memory_valid) -> torch.Tensor:
        """Pyramid members [n, Hb, Wb, 3] of valid size member_hw through
        one window forward, each clustered under its bucket's fake labels:
        [n, Hb, Wb, C] probabilities."""
        memory = self.memory(memory_protos, memory_labels, memory_valid)
        return torch.stack([self.cluster_probs(e, member_hw, memory)
                            for e in self.stitch(members)])

    @torch.no_grad()
    def build_prototypes(self, image: np.ndarray,
                         semantic_label: np.ndarray,
                         return_clusters: bool = False):
        """Memory-bank entry of one train image (prototype.py:194-227):
        (prototypes [K, D] float32, majority ground-truth label [K] int32,
        valid [K] bool) and, with return_clusters, the [H, W] int32
        cluster map. semantic_label: [H, W] at the image's resolution."""
        h, w = image.shape[:2]
        ignore = self.config.dataset.semantic_ignore_index
        img = self.upload_image(image)
        real = np.full(tuple(img.shape[:2]), ignore, np.uint8)
        real[:h, :w] = semantic_label
        seg_ids, protos, seg_valid = self.segment(self.stitch(img), (h, w))
        real_dev = torch.from_numpy(real).to(self.device).long().reshape(-1)
        labels = self.majority_labels(seg_ids, real_dev, real_dev != ignore,
                                      protos.shape[0])
        out = (protos.cpu().numpy(), labels.cpu().numpy(),
               seg_valid.cpu().numpy())
        if return_clusters:
            seg_map = seg_ids.reshape(img.shape[:2])[:h, :w]
            return out + (seg_map.cpu().numpy().astype(np.int32),)
        return out


def save_prototypes(path: str, prototypes: np.ndarray,
                    labels: np.ndarray) -> None:
    """The reference's npy dict layout (prototype.py:222-225)."""
    np.save(path, {"prototype": prototypes, "prototype_label": labels})


def load_memory_banks(memory_dir: str):
    """Concatenated {prototype, prototype_label} of every .npy in a
    directory, in name order (spml/utils/segsort/others.py:11-41)."""
    protos, labels = [], []
    for name in sorted(os.listdir(memory_dir)):
        if not name.endswith(".npy"):
            continue
        data = np.load(os.path.join(memory_dir, name),
                       allow_pickle=True).item()
        protos.append(data["prototype"])
        labels.append(data["prototype_label"])
    return np.concatenate(protos, 0), np.concatenate(labels, 0)

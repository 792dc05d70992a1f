"""Entry points of inference and pseudo-labelling: memory banks, KNN and
softmax predictions (single scale or multi-scale, with or without a
dense CRF), the four pseudo-label paths, mIoU.

Port of spml_tpu/inference/runner.py (reference in twke18/SPML,
pyscripts/inference/): prototype.py / prototype_msc.py (memory banks);
inference.py / inference_msc.py / inference_crf[_msc].py (KNN prediction,
the scale and flip average, DenseCRF over the top-20 one-hot
probabilities); inference_softmax*.py (classifier logits, MSC and/or
CRF); pseudo_camrw_crf.py, pseudo_softmaxrw_crf.py, pseudo_softmax.py,
pseudo_inference_crf_msc.py and pseudo_denseposerw_crf.py (pseudo-labels
from CAM, softmax, KNN or DensePose point scores, the stride-8 affinity
random walk and the CRF); pyscripts/benchmark/benchmark_by_{mIoU,
instance}.py. Predictions go back to each image's original size (nearest
for labels, inference.py:236-240; bilinear for probabilities before a
CRF). Batched prediction (tpu.infer_batch > 1) is not ported yet and
raises. The JAX runner's per-bucket warm-up and its cache of compiled
affinity programs have no counterpart: eager PyTorch compiles nothing.

The host tail of an image (download, resize, CRF, argmax, PNGs) runs on
_AsyncSink's threads, over the next image's device work. `args` carries
the reference's flags as attributes: snapshot_dir, save_dir, data_dir,
data_list, semantic_memory_dir, cam_dir and the crf_* ones
(cli.parse_args).
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

from spml_tpu_torch import cli
from spml_tpu_torch.data import transforms
from spml_tpu_torch.inference import engine as engine_lib
from spml_tpu_torch.inference import msc as msc_lib
from spml_tpu_torch.inference.softmax import SoftmaxInferenceEngine
from spml_tpu_torch.models.spp import resize_bilinear
from spml_tpu_torch.ops import common, kmeans, knn, randomwalk
from spml_tpu_torch.utils import vis

MSC_SCALES = (0.5, 0.75, 1, 1.25, 1.5)  # inference_msc.py


class _AsyncSink:
    """A bounded thread pool for the host tails of images (download, CRF,
    argmax, PNGs): ctypes drops the GIL in the CRF, so the tails overlap
    the next image's device work and each other. At most max_inflight
    tails are queued (each holds a [C, H, W] float32 map); close() waits
    for all and raises the first failure. Outputs are per-image files, so
    the order they finish in does not matter."""

    def __init__(self, workers=None, max_inflight=None):
        workers = workers or min(8, os.cpu_count() or 1)
        self._pool = concurrent.futures.ThreadPoolExecutor(workers)
        self._limit = max_inflight or 2 * workers
        self._pending = []

    def submit(self, fn, *args):
        self._pending.append(self._pool.submit(fn, *args))
        while len(self._pending) >= self._limit:
            self._pending.pop(0).result()

    def close(self):
        try:
            for f in self._pending:
                f.result()
        finally:
            self._pending.clear()
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _maybe_resize_input(config, image, sem=None, inst=None):
    """The larger side resized to test.image_size when it is set, the
    image bilinearly and the labels nearest (inference.py:123-134)."""
    if config.test.image_size > 0:
        image = transforms.resize_with_interpolation(
            image, config.test.image_size, method="bilinear")
        if sem is not None:
            sem = transforms.resize_with_interpolation(
                sem, config.test.image_size, method="nearest")
        if inst is not None:
            inst = transforms.resize_with_interpolation(
                inst, config.test.image_size, method="nearest")
    return image, sem, inst


def _resize_pred_to(pred, h, w):
    """Nearest label resize back to h x w on the host: src = floor(dst *
    in / out) with the product in float32, as the JAX package computes it
    (a float64 product can floor to the next source row)."""
    pred = np.asarray(pred)
    ph, pw = pred.shape[-2:]
    ys = np.floor(np.arange(h, dtype=np.float32)
                  * np.float32(ph / h)).astype(np.int64)
    xs = np.floor(np.arange(w, dtype=np.float32)
                  * np.float32(pw / w)).astype(np.int64)
    ys = np.minimum(ys, ph - 1)
    xs = np.minimum(xs, pw - 1)
    return pred[..., ys[:, None], xs[None, :]]


def _load_memory(args, config, eng):
    """The memory bank on the engine's device, ignore-labelled prototypes
    dropped (a cluster with no valid label keeps label 0 and stays)."""
    protos, labels = engine_lib.load_memory_banks(args.semantic_memory_dir)
    keep = labels != config.dataset.semantic_ignore_index
    protos, labels = protos[keep], labels[keep]
    return eng.memory(protos, labels, np.ones((protos.shape[0],), bool))


def run_prototype(args, config, scales=None, save_clusters=True,
                  device="cuda"):
    """The memory bank of a list (save_dir/semantic_prototype/*.npy), one
    file per image with the valid prototypes of every scale; with
    save_clusters also the cluster maps at scale 1 (semantic_cluster/
    mode-I PNGs, semantic_cluster_rgb/)."""
    import PIL.Image

    eng = engine_lib.InferenceEngine(
        config, cli.build_eval_models(config, args.snapshot_dir, device),
        device)
    out_dir = os.path.join(args.save_dir, "semantic_prototype")
    os.makedirs(out_dir, exist_ok=True)
    if save_clusters:
        cluster_dir = os.path.join(args.save_dir, "semantic_cluster")
        cluster_rgb_dir = os.path.join(args.save_dir,
                                       "semantic_cluster_rgb")
        os.makedirs(cluster_dir, exist_ok=True)
        os.makedirs(cluster_rgb_dir, exist_ok=True)
        color_map = vis.load_color_map(config.dataset.color_map_path)
    for _, base, image, sem, _ in cli.iterate_test_images(
            config, args.data_dir, args.data_list):
        image, sem, _ = _maybe_resize_input(config, image, sem)
        all_p, all_l = [], []
        for scale in (scales or [1.0]):
            h, w = image.shape[:2]
            img_s, sem_s = image, sem
            if scale != 1.0:
                img_s = transforms._resize_image(image, int(h * scale),
                                                 int(w * scale))
                sem_s = transforms._resize_nearest(sem, *img_s.shape[:2])
            want_clusters = save_clusters and scale == 1.0
            result = eng.build_prototypes(img_s, sem_s,
                                          return_clusters=want_clusters)
            protos, labels, valid = result[:3]
            all_p.append(protos[valid])
            all_l.append(labels[valid])
            if want_clusters:
                clusters = result[3]
                PIL.Image.fromarray(clusters.astype(np.int32),
                                    mode="I").save(
                    os.path.join(cluster_dir, base))
                PIL.Image.fromarray(
                    vis.label_to_color(clusters % 256, color_map),
                    mode="RGB").save(os.path.join(cluster_rgb_dir, base))
        engine_lib.save_prototypes(
            os.path.join(out_dir, base.replace(".png", ".npy")),
            np.concatenate(all_p, 0), np.concatenate(all_l, 0))
        print(f"prototype {base}", flush=True)


def _prob_tail(postprocessor, config, save_dir, color_map, what):
    """The host tail of a probability path: probs [h, w, C] (or the
    resolve() of an asynchronous download) resized bilinearly to the
    original image's size, refined by the CRF when there is one, argmaxed
    and saved."""
    def tail(probs, image0, base, oh, ow):
        if callable(probs):
            probs = probs()
        probs = transforms._resize_image(probs, oh, ow)
        if postprocessor is not None:
            rgb = cli.denormalize_image(image0, config)
            probs = postprocessor(rgb, probs.transpose(2, 0, 1))
            probs = probs.transpose(1, 2, 0)
        pred = probs.argmax(-1).astype(np.uint8)
        cli.save_semantic_pngs(pred, base, save_dir, color_map)
        print(f"{what} {base}", flush=True)
    return tail


def _run_probs(args, config, eng, member_args, predict_probs, msc, crf,
               scales, what):
    """The image loop of the KNN and softmax paths: with MSC and no CRF
    the labels are finished on the device; otherwise the probabilities
    (MSC's float16 download, or one scale's) go to the host tail."""
    color_map = vis.load_color_map(config.dataset.color_map_path)
    tail = _prob_tail(cli.crf_from_args(args) if crf else None, config,
                      args.save_dir, color_map, what)
    with _AsyncSink() as sink:
        for _, base, image0, _, _ in cli.iterate_test_images(
                config, args.data_dir, args.data_list):
            oh, ow = image0.shape[:2]
            image, _, _ = _maybe_resize_input(config, image0)
            if msc and not crf:
                pred = msc_lib.msc_predict_labels_device(
                    eng, image, member_args, scales, is_flip=True,
                    final_hw=(oh, ow))
                cli.save_semantic_pngs(pred, base, args.save_dir, color_map)
                print(f"{what} {base}", flush=True)
                continue
            probs = (msc_lib.msc_predict_probs_device_async(
                eng, image, member_args, scales, is_flip=True) if msc
                else predict_probs(image))
            sink.submit(tail, probs, image0, base, oh, ow)


def run_knn_inference(args, config, msc=False, crf=False, scales=MSC_SCALES,
                      device="cuda"):
    """KNN prediction of a list against args.semantic_memory_dir:
    save_dir/semantic_gray/ and semantic_color/ PNGs at each image's
    original size. msc: the mean of the scales x flips pyramid; crf: the
    DenseCRF of the crf_* flags over the top-20 probabilities."""
    if not (msc or crf) and config.tpu.infer_batch > 1:
        raise NotImplementedError(
            "run_knn_inference: tpu.infer_batch > 1 (batched prediction) "
            "is not ported yet")
    eng = engine_lib.InferenceEngine(
        config, cli.build_eval_models(config, args.snapshot_dir, device),
        device)
    memory = _load_memory(args, config, eng)
    if msc or crf:
        _run_probs(args, config, eng, memory,
                   lambda image: eng.predict_topk_probs(image, *memory),
                   msc, crf, scales, "inference")
        return
    color_map = vis.load_color_map(config.dataset.color_map_path)
    for _, base, image0, _, _ in cli.iterate_test_images(
            config, args.data_dir, args.data_list):
        oh, ow = image0.shape[:2]
        image, _, _ = _maybe_resize_input(config, image0)
        pred = _resize_pred_to(eng.predict_semantic(image, *memory), oh, ow)
        cli.save_semantic_pngs(pred, base, args.save_dir, color_map)
        print(f"inference {base}", flush=True)


def run_softmax_inference(args, config, msc=False, crf=False,
                          scales=MSC_SCALES, device="cuda"):
    """Stage-2 classifier prediction of a list: the PNGs of
    run_knn_inference from the softmax of the summed window logits."""
    emb_model, cls_model = cli.build_eval_models(
        config, args.snapshot_dir, device, with_classifier=True)
    eng = SoftmaxInferenceEngine(config, emb_model, cls_model, device)
    _run_probs(args, config, eng, (), eng.predict_probs, msc, crf, scales,
               "softmax inference")


@torch.no_grad()
def _stride8_embeddings(config, emb_model, image: np.ndarray):
    """The image's embeddings on the stride-8 grid, unflipped and from the
    flipped image (pseudo_camrw_crf.py:139-155): the image padded to
    test.crop_size, both flips in one forward at the padded size, the
    flipped map flipped back, cropped to h x w, resized bilinearly to
    (h // 8, w // 8), L2-normalized: [2, n, D] float32, n = (h // 8) *
    (w // 8)."""
    h, w = image.shape[:2]
    device = next(emb_model.parameters()).device
    img = torch.from_numpy(transforms.resize_with_pad(
        image, config.test.crop_size, 0.0)).to(device)
    emb, _ = emb_model(torch.stack([img, img.flip(1)]),
                       resize_as_input=True)
    emb = torch.stack([emb[0], emb[1].flip(1)]).float()[:, :h, :w]
    emb8 = resize_bilinear(emb, (h // 8, w // 8))
    return common.normalize_embedding(emb8).reshape(2, -1, emb8.shape[-1])


def _stride8_affinity(config, emb_model, image: np.ndarray) -> torch.Tensor:
    """The flip-averaged pixel affinity [n, n] on the stride-8 grid (the
    reference averages the two flips' affinities, not their
    embeddings)."""
    e = _stride8_embeddings(config, emb_model, image)
    return (randomwalk.pixel_affinity(e[0])
            + randomwalk.pixel_affinity(e[1])) * 0.5


def _walk_scores(aff: torch.Tensor, scores_full: np.ndarray,
                 grid_hw) -> np.ndarray:
    """Scores [C, h, w] resized bilinearly to the stride-8 grid, walked
    over the affinity, resized back: [C, h, w] float32."""
    c, h, w = scores_full.shape
    gh, gw = grid_hw
    scores = torch.from_numpy(np.ascontiguousarray(
        scores_full.transpose(1, 2, 0))).to(aff.device)
    scores8 = resize_bilinear(scores[None], (gh, gw))[0]
    walked = randomwalk.random_walk_from_affinity(
        aff, scores8.reshape(-1, c).T).reshape(c, gh, gw)
    out = resize_bilinear(walked.permute(1, 2, 0)[None], (h, w))[0]
    return out.permute(2, 0, 1).cpu().numpy()


def _label_tail(postprocessor, config, save_dir, color_map, what):
    """The host tail of a pseudo-label path: scores [C, h, w] refined by
    the CRF when there is one, argmaxed and saved."""
    def tail(scores, image, base):
        if postprocessor is not None:
            rgb = cli.denormalize_image(image, config)
            scores = postprocessor(rgb, np.ascontiguousarray(scores))
        pred = scores.argmax(0).astype(np.uint8)
        cli.save_semantic_pngs(pred, base, save_dir, color_map)
        print(f"{what} {base}", flush=True)
    return tail


def _tag_mask(probs: np.ndarray, sem, num_classes: int) -> np.ndarray:
    """probs [C, h, w] with the classes absent from the image's label map
    zeroed (pseudo_softmaxrw_crf.py:146-158); unchanged without one."""
    if sem is None:
        return probs
    tags = np.zeros(num_classes, np.float32)
    uniq = np.unique(sem)
    tags[uniq[uniq < num_classes]] = 1.0
    return probs * tags[:, None, None]


def run_pseudo_camrw_crf(args, config, bg_alpha=6.0, with_crf=True,
                         device="cuda"):
    """Pseudo-labels from SEAM CAMs (args.cam_dir/<image>.npy, a dict of
    class - 1 -> [h, w] scores): the background prior, the stride-8
    random walk, the CRF (pseudo_camrw_crf.py)."""
    emb_model = cli.build_eval_models(config, args.snapshot_dir, device)
    tail = _label_tail(cli.crf_from_args(args) if with_crf else None,
                       config, args.save_dir,
                       vis.load_color_map(config.dataset.color_map_path),
                       "pseudo_camrw")
    with _AsyncSink() as sink:
        for _, base, image, _, _ in cli.iterate_test_images(
                config, args.data_dir, args.data_list):
            h, w = image.shape[:2]
            cam = np.load(os.path.join(args.cam_dir,
                                       base.replace(".png", ".npy")),
                          allow_pickle=True).item()
            scores = randomwalk.cam_to_full_scores(
                cam, config.dataset.num_classes, h, w, bg_alpha)
            aff = _stride8_affinity(config, emb_model, image)
            sink.submit(tail, _walk_scores(aff, scores, (h // 8, w // 8)),
                        image, base)


def run_pseudo_softmax(args, config, with_crf=False, with_walk=True,
                       scales=(0.75, 1.0), device="cuda"):
    """Pseudo-labels from the classifier: the scales x flips mean of the
    softmax (float16 download), masked to the image's tags and divided
    by each class's maximum, walked, refined by the CRF
    (pseudo_softmaxrw_crf.py / pseudo_softmax.py)."""
    emb_model, cls_model = cli.build_eval_models(
        config, args.snapshot_dir, device, with_classifier=True)
    eng = SoftmaxInferenceEngine(config, emb_model, cls_model, device)
    tail = _label_tail(cli.crf_from_args(args) if with_crf else None,
                       config, args.save_dir,
                       vis.load_color_map(config.dataset.color_map_path),
                       "pseudo_softmax")
    with _AsyncSink() as sink:
        for _, base, image, sem, _ in cli.iterate_test_images(
                config, args.data_dir, args.data_list):
            h, w = image.shape[:2]
            probs = msc_lib.msc_predict_probs_device(eng, image, (), scales,
                                                     is_flip=True)
            probs = _tag_mask(probs.transpose(2, 0, 1), sem,
                              config.dataset.num_classes)
            probs = probs / np.maximum(
                probs.max(axis=(1, 2), keepdims=True), 1e-8)
            if with_walk:
                aff = _stride8_affinity(config, eng.emb_model, image)
                probs = _walk_scores(aff, probs, (h // 8, w // 8))
            sink.submit(tail, probs, image, base)


def run_pseudo_knn(args, config, scales=(0.5, 1.0, 1.5, 2.0),
                   prob_floor=0.15, with_crf=True, device="cuda"):
    """Pseudo-labels from KNN retrieval: the scales x flips mean of the
    top-20 probabilities (float16 download), masked to the image's tags,
    refined by the CRF, argmaxed, and the pixels whose largest
    probability is below prob_floor set to the ignore label
    (pseudo_inference_crf_msc.py:135-292)."""
    eng = engine_lib.InferenceEngine(
        config, cli.build_eval_models(config, args.snapshot_dir, device),
        device)
    memory = _load_memory(args, config, eng)
    postprocessor = cli.crf_from_args(args) if with_crf else None
    color_map = vis.load_color_map(config.dataset.color_map_path)
    c = config.dataset.num_classes
    ignore = config.dataset.semantic_ignore_index

    def tail(resolve, image, sem, base):
        probs = _tag_mask(resolve().transpose(2, 0, 1), sem, c)
        if postprocessor is not None:
            rgb = cli.denormalize_image(image, config)
            probs = postprocessor(rgb, np.ascontiguousarray(probs))
        pred = probs.argmax(0).astype(np.uint8)
        pred = np.where(probs.max(0) < prob_floor, ignore,
                        pred).astype(np.uint8)
        cli.save_semantic_pngs(pred, base, args.save_dir, color_map)
        print(f"pseudo_knn {base}", flush=True)

    with _AsyncSink() as sink:
        for _, base, image, sem, _ in cli.iterate_test_images(
                config, args.data_dir, args.data_list):
            sink.submit(tail, msc_lib.msc_predict_probs_device_async(
                eng, image, memory, scales, is_flip=True), image, sem, base)


def run_benchmark(args, config, instance=False):
    """mIoU (or instance-weighted IoU) of save_dir/semantic_gray against
    the list's ground truth (benchmark_by_mIoU.py /
    benchmark_by_instance.py)."""
    import PIL.Image

    from spml_tpu_torch.utils import metrics
    c = config.dataset.num_classes
    meter = (metrics.InstanceWeightedIoU(c) if instance
             else metrics.MeanIoU(c))
    pred_dir = os.path.join(args.save_dir, "semantic_gray")
    for _, base, _, sem, inst in cli.iterate_test_images(
            config, args.data_dir, args.data_list):
        pred = np.array(PIL.Image.open(os.path.join(pred_dir, base)))
        if instance:
            meter.update(pred, sem, inst)
        else:
            meter.update(pred, sem)
    result = meter.result()
    print("class IoU:", np.round(result["class_iou"], 4).tolist())
    print(f"mean IoU: {result['mean_iou']:.4f}")
    if "pixel_accuracy" in result:
        print(f"pixel accuracy: {result['pixel_accuracy']:.4f}")
    return result


def _densepose_scores(config, emb_model, image, sem, inst, capacity):
    """The walked class scores [C, h, w] of one point-labelled image
    (pseudo_denseposerw_crf.py:95-243): embeddings at half size; k-means
    with the point labels, the ignore label made an extra class C so its
    pixels cluster too; every segment tagged with the class of its
    nearest labelled prototype (top 1, threshold -1); per-pixel class
    distributions of the segments; on the stride-8 grid, divided by each
    class's maximum, classes without a point zeroed; the random walk over
    the half-size embeddings, L2-normalized before and after the resize;
    back to full size with PIL's bilinear resize."""
    device = next(emb_model.parameters()).device
    net, c = config.network, config.dataset.num_classes
    ignore = config.dataset.semantic_ignore_index
    h, w = image.shape[:2]
    h2, w2, gh, gw = h // 2, w // 2, h // 8, w // 8
    img = torch.from_numpy(transforms.resize_with_pad(
        image, config.test.crop_size, 0.0)).to(device)
    with torch.no_grad():
        emb, _ = emb_model(img[None], resize_as_input=True)
    emb = resize_bilinear(emb.float(), (img.shape[0] // 2,
                                        img.shape[1] // 2))[0, :h2, :w2]

    sem_u = sem.astype(np.int32)
    sem_u[sem_u == ignore] = c
    labels = [torch.from_numpy(transforms._resize_nearest(x, h2, w2)).to(
        device)[None] for x in (sem_u, inst.astype(np.int32))]
    loc = common.generate_location_features(h2, w2, device=device) - 0.5
    segs, emb_flat, _ = kmeans.segment_batch(
        emb[None], loc[None], *labels, tuple(net.kmeans_num_clusters),
        capacity, net.kmeans_iterations, ignore,
        label_cap=config.tpu.label_cap)
    seg_ids = segs.pixel_segment_ids[0]
    weights = segs.pixel_valid[0].float()
    protos = kmeans.calculate_prototypes_from_labels(emb_flat[0], seg_ids,
                                                     capacity, weights)
    tags = knn.nearest_neighbor_multiset_labels(
        emb_flat[0], protos, segs.segment_semantic[0],
        torch.zeros(h2 * w2, dtype=torch.long, device=device),
        torch.zeros(capacity, dtype=torch.long, device=device), c,
        top_k=1, threshold=-1.0, prototype_mask=segs.segment_valid[0])
    s_probs = common.segment_mean(tags.float(), seg_ids, capacity, weights)
    s_probs = s_probs / torch.clamp(s_probs.sum(1, keepdim=True), min=1e-8)
    probs_half = s_probs[seg_ids].reshape(1, h2, w2, c)

    present = torch.zeros(c, dtype=torch.bool, device=device)
    tags_img = np.unique(sem)
    present[torch.from_numpy(tags_img[tags_img < c].astype(np.int64))] = True
    scores8 = resize_bilinear(probs_half, (gh, gw))[0].permute(2, 0, 1)
    scores8 = scores8 / torch.clamp(
        scores8.reshape(c, -1).max(1)[0][:, None, None], min=1e-8)
    scores8 = torch.where(present[:, None, None], scores8, 0.0)

    emb8 = resize_bilinear(common.normalize_embedding(emb, eps=1e-12)[None],
                           (gh, gw))[0]
    emb8 = common.normalize_embedding(emb8, eps=1e-12)
    walked = randomwalk.random_walk(emb8.reshape(-1, emb8.shape[-1]),
                                    scores8.reshape(c, -1))
    walked = walked.reshape(c, gh, gw).permute(1, 2, 0).cpu().numpy()
    return np.ascontiguousarray(
        transforms._resize_image(walked, h, w).transpose(2, 0, 1))


def run_pseudo_densepose(args, config, with_crf=True, device="cuda"):
    """DensePose pseudo-labels from point labels: _densepose_scores, the
    CRF, the argmax, and the pixels without a point label set back to
    the ignore label."""
    emb_model = cli.build_eval_models(config, args.snapshot_dir, device)
    postprocessor = cli.crf_from_args(args) if with_crf else None
    color_map = vis.load_color_map(config.dataset.color_map_path)
    ignore = config.dataset.semantic_ignore_index
    capacity = max(config.tpu.segment_capacity,
                   2 * int(np.prod(config.network.kmeans_num_clusters)))

    def tail(scores, image, sem, base):
        if postprocessor is not None:
            rgb = cli.denormalize_image(image, config)
            scores = postprocessor(rgb, scores)
        pred = scores.argmax(0).astype(np.uint8)
        pred[sem == ignore] = ignore
        cli.save_semantic_pngs(pred, base, args.save_dir, color_map)
        print(f"pseudo_densepose {base}", flush=True)

    with _AsyncSink() as sink:
        for _, base, image, sem, inst in cli.iterate_test_images(
                config, args.data_dir, args.data_list):
            sink.submit(tail, _densepose_scores(config, emb_model, image,
                                                sem, inst, capacity),
                        image, sem, base)

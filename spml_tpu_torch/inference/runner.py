"""Entry points of the single-scale KNN pipeline: memory bank,
prediction PNGs, mIoU.

Port of spml_tpu/inference/runner.py (run_prototype:187,
run_knn_inference:237, run_benchmark:536; reference in twke18/SPML:
pyscripts/inference/prototype.py, inference.py and
pyscripts/benchmark/benchmark_by_mIoU.py /
benchmark_by_instance.py). Predictions are resized back to the original
image size with nearest interpolation (inference.py:236-240). The
multi-scale and CRF branches and batched prediction (tpu.infer_batch >
1) are not ported yet and raise.

`args` carries the reference's flags as attributes: snapshot_dir,
save_dir, data_dir, data_list, semantic_memory_dir.
"""

from __future__ import annotations

import os

import numpy as np

from spml_tpu_torch import cli
from spml_tpu_torch.data import transforms
from spml_tpu_torch.inference import engine as engine_lib
from spml_tpu_torch.utils import vis


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


def run_knn_inference(args, config, msc=False, crf=False, device="cuda"):
    """Single-scale KNN prediction of a list against
    args.semantic_memory_dir: save_dir/semantic_gray/ and
    semantic_color/ PNGs at each image's original size."""
    if msc or crf:
        raise NotImplementedError(
            "run_knn_inference: msc and crf are not ported yet")
    if config.tpu.infer_batch > 1:
        raise NotImplementedError(
            "run_knn_inference: tpu.infer_batch > 1 (batched prediction) "
            "is not ported yet")
    eng = engine_lib.InferenceEngine(
        config, cli.build_eval_models(config, args.snapshot_dir, device),
        device)
    memory = _load_memory(args, config, eng)
    color_map = vis.load_color_map(config.dataset.color_map_path)
    for _, base, image0, _, _ in cli.iterate_test_images(
            config, args.data_dir, args.data_list):
        oh, ow = image0.shape[:2]
        image, _, _ = _maybe_resize_input(config, image0)
        pred = _resize_pred_to(eng.predict_semantic(image, *memory), oh, ow)
        cli.save_semantic_pngs(pred, base, args.save_dir, color_map)
        print(f"inference {base}", flush=True)


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

"""Shared plumbing of the entry points: arguments and configuration, the
models of a snapshot, the test-image iterator and the prediction PNGs.

Port of spml_tpu/cli.py (reference: spml/config/parse_args.py:8-53 in
twke18/SPML). parse_args has the reference's flags, the six DenseCRF
ones with their defaults among them, plus --device, the port's counterpart
of the JAX package's SPML_TPU_PLATFORM: the training entry points (and
batched KNN inference) run one rank on each card of 'cuda', N ranks on
the CPU for 'cpu:N' (SPML_TPU_PLATFORM=cpu:N), or join a torchrun group
(parallel/mesh.py::launch); the others run on the one device named.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os

import numpy as np
import torch

from spml_tpu_torch.config import Config, load_config
from spml_tpu_torch.utils.device import float32_matmuls, resolve_device


def parse_args(description: str = "") -> tuple[argparse.Namespace, Config]:
    """(args, config) from sys.argv: the YAML at --cfg_path with
    --kmeans_num_clusters, --label_divisor and --data_dir applied."""
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--snapshot_dir", required=True, type=str)
    parser.add_argument("--save_dir", type=str)
    parser.add_argument("--cfg_path", required=True, type=str)
    parser.add_argument("--semantic_memory_dir", type=str, default=None)
    parser.add_argument("--cam_dir", type=str, default=None)
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--data_list", type=str, default=None)
    parser.add_argument("--kmeans_num_clusters", type=str, default=None,
                        help="H,W")
    parser.add_argument("--label_divisor", type=int, default=None)
    parser.add_argument("--crf_iter_max", type=int, default=10)
    parser.add_argument("--crf_pos_xy_std", type=int, default=1)
    parser.add_argument("--crf_pos_w", type=int, default=3)
    parser.add_argument("--crf_bi_xy_std", type=int, default=67)
    parser.add_argument("--crf_bi_w", type=int, default=4)
    parser.add_argument("--crf_bi_rgb_std", type=int, default=3)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cpu for the plain "
                        "versions of the kernels); training: cuda = one "
                        "rank a visible card, cpu:N = N ranks on the CPU")
    args = parser.parse_args()

    config = load_config(args.cfg_path)
    if args.kmeans_num_clusters:
        config.network.kmeans_num_clusters = tuple(
            int(x) for x in args.kmeans_num_clusters.split(","))
    if args.label_divisor:
        config.network.label_divisor = args.label_divisor
    if args.data_dir:
        config.dataset.data_dir = args.data_dir
    return args, config


def crf_from_args(args):
    """The DenseCRF of the --crf_* flags."""
    from spml_tpu_torch.crf import DenseCRF
    return DenseCRF(iter_max=args.crf_iter_max, pos_w=args.crf_pos_w,
                    pos_xy_std=args.crf_pos_xy_std, bi_w=args.crf_bi_w,
                    bi_xy_std=args.crf_bi_xy_std,
                    bi_rgb_std=args.crf_bi_rgb_std)


def build_eval_models(config, snapshot_dir: str, device="cuda",
                      with_classifier=False):
    """The embedding model (and, with_classifier, the classifier head) of a
    snapshot, in eval mode on `device`; utils/checkpoint.py::
    restore_models says what is read. With nothing to read the weights
    are random, drawn from a torch.Generator of seed 0: not the values
    the JAX package draws from PRNGKey(0). Turns TF32 off
    (utils/device.py::float32_matmuls) for every inference path, the
    forwards of the pseudo-label paths without an engine too."""
    from spml_tpu_torch.models.embeddings import (build_classifier_head,
                                                  build_embedding_model)
    from spml_tpu_torch.utils import checkpoint as ckpt

    device = resolve_device(device)
    float32_matmuls()
    dtype = (torch.bfloat16 if config.tpu.compute_dtype == "bfloat16"
             else torch.float32)
    model = build_embedding_model(
        config.network.backbone_types, config.network.embedding_dim,
        compute_dtype=dtype, bn_momentum=config.network.bn_momentum,
        generator=torch.Generator().manual_seed(0))
    head = build_classifier_head(
        config.dataset.num_classes, config.network.embedding_dim,
        compute_dtype=dtype, generator=torch.Generator().manual_seed(0))
    ckpt.restore_models(config, snapshot_dir, model, head)
    fmt = torch.channels_last
    model = model.to(device, memory_format=fmt).eval()
    if with_classifier:
        return model, head.to(device, memory_format=fmt).eval()
    return model


def save_semantic_pngs(pred: np.ndarray, base_name: str, save_dir: str,
                       color_map=None) -> None:
    """Gray and colour PNGs in the reference's layout (semantic_gray/,
    semantic_color/)."""
    import PIL.Image

    from spml_tpu_torch.utils import vis
    gray_dir = os.path.join(save_dir, "semantic_gray")
    rgb_dir = os.path.join(save_dir, "semantic_color")
    os.makedirs(gray_dir, exist_ok=True)
    os.makedirs(rgb_dir, exist_ok=True)
    PIL.Image.fromarray(pred.astype(np.uint8), mode="L").save(
        os.path.join(gray_dir, base_name))
    if color_map is None:
        color_map = vis.voc_colormap()
    PIL.Image.fromarray(vis.label_to_color(pred, color_map),
                        mode="RGB").save(os.path.join(rgb_dir, base_name))


def iterate_test_images(config, data_dir, data_list):
    """Yields (index, base name .png, image [H, W, 3] normalized, semantic
    label or None, instance label or None) in list order, the next item
    decoded on a background thread."""
    from spml_tpu_torch.data import datasets
    ds = datasets.ListDataset(
        data_dir, data_list, img_mean=config.network.pixel_means,
        img_std=config.network.pixel_stds)

    def _load(i):
        item = ds[i]
        base = os.path.basename(ds.image_paths[i])
        base = os.path.splitext(base)[0] + ".png"
        return (i, base, item["image"], item.get("semantic_label"),
                item.get("instance_label"))

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_load, 0) if len(ds) else None
        for i in range(len(ds)):
            cur = fut.result()
            fut = pool.submit(_load, i + 1) if i + 1 < len(ds) else None
            yield cur


def denormalize_image(image: np.ndarray, config) -> np.ndarray:
    """A normalized image back to uint8 RGB (pseudo_camrw_crf.py:172-178)."""
    img = image * np.asarray(config.network.pixel_stds, np.float32)
    img = img + np.asarray(config.network.pixel_means, np.float32)
    return np.clip(img * 255.0, 0, 255).astype(np.uint8)

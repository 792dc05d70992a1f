"""Shared plumbing of the inference entry points: the evaluation model,
the test-image iterator and the prediction PNGs.

Port of spml_tpu/cli.py:150-235. The argument parser and the DenseCRF
flags (parse_args, crf_from_args) are not ported yet.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import torch

from spml_tpu_torch.utils.device import resolve_device


def build_eval_models(config, snapshot_dir: str, device="cuda"):
    """The embedding model of a snapshot, in eval mode on `device`.

    Reads the reference's snapshot layout (train.py:295-304):
    `model-{max_iteration - 1}.pth`, key "embedding_model", in the
    reference's names, which are the port's (load_state_dict strict) — the
    file the JAX package's utils/torch_export.py::save_torch_checkpoint
    writes. With no such file the weights are random, drawn from a
    torch.Generator of seed 0: not the values the JAX package draws from
    PRNGKey(0). A JAX (orbax) `checkpoints/` directory raises
    NotImplementedError.
    """
    from spml_tpu_torch.models.embeddings import build_embedding_model

    device = resolve_device(device)
    ck_dir = os.path.join(snapshot_dir, "checkpoints")
    if os.path.isdir(ck_dir) and os.listdir(ck_dir):
        raise NotImplementedError(
            f"{ck_dir}: orbax checkpoints are not ported yet; export a "
            "model-*.pth with spml_tpu.utils.torch_export")
    dtype = (torch.bfloat16 if config.tpu.compute_dtype == "bfloat16"
             else torch.float32)
    model = build_embedding_model(
        config.network.backbone_types, config.network.embedding_dim,
        compute_dtype=dtype, bn_momentum=config.network.bn_momentum,
        generator=torch.Generator().manual_seed(0))
    pth = os.path.join(snapshot_dir,
                       f"model-{config.train.max_iteration - 1}.pth")
    if os.path.isfile(pth):
        state = torch.load(pth, map_location="cpu")["embedding_model"]
        model.load_state_dict(state, strict=True)
    return model.to(device, memory_format=torch.channels_last).eval()


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

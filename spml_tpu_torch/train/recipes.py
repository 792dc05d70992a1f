"""The training recipes the tools run, by name.

Each recipe module holds its configuration (`OVERRIDES`) and its
synthetic batch (`make_batch(cfg, device)`); `setup` builds both.
"""

from __future__ import annotations

from spml_tpu_torch.config import load_config
from spml_tpu_torch.train import densepose_point, flagship, voc_tag

RECIPES = {"flagship": flagship, "densepose_point": densepose_point,
           "voc_tag": voc_tag}


def setup(name: str, device="cuda"):
    """(config, batch) of the recipe `name`, the batch made from seed 0."""
    recipe = RECIPES[name]
    cfg = load_config(overrides=recipe.OVERRIDES)
    return cfg, recipe.make_batch(cfg, device=device)

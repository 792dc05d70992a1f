"""Location features of the pixel embeddings.

Port of the location path of spml_tpu/models/local.py (reference:
spml/models/embeddings/local_model.py:88-93 in twke18/SPML): the
normalized (y, x) grid shifted to [-0.5, 0.5]. The colour channels of the
DensePose variant are not ported yet.
"""

from __future__ import annotations

import torch

from spml_tpu_torch.ops import common


def location_features(batch: int, size: tuple[int, int],
                      device=None) -> torch.Tensor:
    """[B, h, w, 2] location features."""
    h, w = size
    loc = common.generate_location_features(h, w, device=device) - 0.5
    return loc[None].expand(batch, h, w, 2)

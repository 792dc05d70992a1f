"""Load reference-format torch checkpoints into the port's models.

The port's own counterpart of spml_tpu/utils/torch_import.py. The port's
module names are the reference's (twke18/SPML) torch state-dict names, so
a reference snapshot needs no conversion; the CUHK torchvision-style
pretrained file (conv1.*, bn1.*, layer1..4) is renamed as the reference
does it (resnet_deeplab.py:222-232, name_mapping). As the JAX package's
merge_pretrained(strict_shapes=False, strict_names=False), entries with
no counterpart in the model or of another shape are skipped and
reported, the reference's warn-and-skip (base_model.py:26-52).
"""

from __future__ import annotations

import torch


def apply_reference_name_mapping(name: str) -> str:
    """CUHK torchvision naming -> reference module naming
    (resnet_deeplab.py:222-232)."""
    if name.startswith("module."):
        name = name[len("module."):]
    if name.startswith("conv1") or name.startswith("bn1"):
        return "resnet_backbone.conv1." + name
    return (name.replace("layer1", "resnet_backbone.res2")
                .replace("layer2", "resnet_backbone.res3")
                .replace("layer3", "resnet_backbone.res4")
                .replace("layer4", "resnet_backbone.res5"))


def read_state_dict(path: str, key: str | None = None) -> dict:
    """The tensors of a .pth on the CPU; `key` selects a sub-dict (e.g.
    'embedding_model' of the reference's snapshots) where the file has
    it."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if key is not None and key in sd:
        sd = sd[key]
    return sd


@torch.no_grad()
def load_pretrained(model: torch.nn.Module, path: str,
                    key: str | None = "embedding_model",
                    cuhk_names: bool = False) -> list[str]:
    """Copies every entry of the file at `path` whose (mapped) name and
    shape the model has into the model's parameter or buffer, in place;
    returns the names of the entries skipped."""
    own = model.state_dict()
    skipped = []
    for name, value in read_state_dict(path, key).items():
        if cuhk_names:
            name = apply_reference_name_mapping(name)
        if name not in own or own[name].shape != value.shape:
            skipped.append(name)
            continue
        own[name].copy_(value)
    return skipped

"""Carry the JAX package's model variables into the port's state dicts.

The naming logic of spml_tpu/utils/torch_export.py, kept as the port's own
copy: flax parameter / batch_stats trees (as numpy arrays) of an
EmbeddingModel or ClassifierHead become state dicts in the reference's
torch names, which are the port's module names, so they load with
load_state_dict(strict=True). HWIO conv kernels become OIHW; BN
scale/bias/mean/var become weight/bias/running_mean/running_var, with a
zero num_batches_tracked.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(value) -> torch.Tensor:
    return torch.from_numpy(np.array(value, dtype=np.float32))


def _conv(out: dict, name: str, leaves: dict) -> None:
    k = np.asarray(leaves["kernel"], dtype=np.float32)
    out[f"{name}.weight"] = _t(k.transpose(3, 2, 0, 1))
    if "bias" in leaves:
        out[f"{name}.bias"] = _t(leaves["bias"])


def _bn(out: dict, name: str, params: dict, stats: dict) -> None:
    out[f"{name}.weight"] = _t(params["scale"])
    out[f"{name}.bias"] = _t(params["bias"])
    out[f"{name}.running_mean"] = _t(stats["mean"])
    out[f"{name}.running_var"] = _t(stats["var"])
    out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)


_STEM_CONV_IDX = {"conv1_1": "0", "conv1_2": "3", "conv1_3": "6"}
_STEM_BN_NAME = {"conv1_1": "conv1.1", "conv1_2": "conv1.4",
                 "conv1_3": "bn1"}


def embedding_state_dict(params: dict, batch_stats: dict) -> dict:
    """EmbeddingModel (ASPP or PSPP head) flax params + batch_stats -> the
    port's EmbeddingModel state dict."""
    out: dict = {}
    bp, bs = params["resnet_backbone"], batch_stats["resnet_backbone"]
    for mod, idx in _STEM_CONV_IDX.items():
        _conv(out, f"resnet_backbone.conv1.conv1.{idx}",
              bp["stem"][mod]["conv"])
        _bn(out, f"resnet_backbone.conv1.{_STEM_BN_NAME[mod]}",
            bp["stem"][mod]["bn"], bs["stem"][mod]["bn"])
    for res in ("res2", "res3", "res4", "res5"):
        for block, blk in bp[res].items():
            st = bs[res][block]
            pre = f"resnet_backbone.{res}.{block[len('block'):]}"
            for conv in ("conv1", "conv2", "conv3"):
                _conv(out, f"{pre}.{conv}", blk[conv]["conv"])
                _bn(out, f"{pre}.bn{conv[-1]}", blk[conv]["bn"],
                    st[conv]["bn"])
            if "downsample" in blk:
                _conv(out, f"{pre}.downsample.0", blk["downsample"]["conv"])
                _bn(out, f"{pre}.downsample.1", blk["downsample"]["bn"],
                    st["downsample"]["bn"])
    for mod, leaves in params.get("aspp", {}).items():
        _conv(out, f"aspp.{mod}.0", leaves)
    if "pspp" in params:
        # pspp.0 the pyramid, pspp.1 the projection to the embedding width
        out.update(pspp_state_dict(params["pspp"], batch_stats["pspp"],
                                   prefix="pspp.0."))
        _conv(out, "pspp.1", params["pspp_proj"])
    return out


def pspp_state_dict(params: dict, batch_stats: dict,
                    prefix: str = "") -> dict:
    """PSPP flax params + batch_stats -> the port's PSPP state dict
    (pspp_{i}.{1 conv, 2 bn}, conv.{0 conv, 1 bn}), names under
    `prefix`."""
    out: dict = {}
    for i in "1234":
        _conv(out, f"{prefix}pspp_{i}.1", params[f"pspp_{i}_conv"])
        _bn(out, f"{prefix}pspp_{i}.2", params[f"pspp_{i}_bn"],
            batch_stats[f"pspp_{i}_bn"])
    _conv(out, f"{prefix}conv.0", params["fuse_conv"])
    _bn(out, f"{prefix}conv.1", params["fuse_bn"], batch_stats["fuse_bn"])
    return out


def classifier_state_dict(params: dict, batch_stats: dict) -> dict:
    """ClassifierHead flax params + batch_stats -> the port's
    ClassifierHead state dict (semantic_classifier.{0 conv, 1 bn,
    4 conv})."""
    out: dict = {}
    _conv(out, "semantic_classifier.0", params["conv1"])
    _bn(out, "semantic_classifier.1", params["bn"], batch_stats["bn"])
    _conv(out, "semantic_classifier.4", params["conv2"])
    return out

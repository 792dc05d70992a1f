"""Configuration schema.

The same sections and field names as the JAX package's schema
(spml_tpu/config/defaults.py), which mirrors the reference's YAML surface
(spml/config/default.py in twke18/SPML), so one overrides dict configures
both packages: keys this schema lacks are skipped, as in the JAX package.
The ``tpu`` section keeps its name for that reason; it holds the
static-shape knobs the port shares (segment capacity, label cap, compute
dtype, fused loss, loss reduction, lazy metrics, the inference window
buckets).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any


@dataclass
class NetworkConfig:
    pixel_means: tuple = (0.485, 0.456, 0.406)
    pixel_stds: tuple = (0.229, 0.224, 0.225)
    pretrained: str = ""
    use_syncbn: bool = True
    backbone_types: str = "panoptic_deeplab_101"
    prediction_types: str = "segsort"
    aspp_feature_dim: int = 512
    pspp_feature_dim: int = 512
    embedding_dim: int = 64
    label_divisor: int = 255
    # torch momentum (reference 3e-4); assumes pretrained BN statistics
    bn_momentum: float = 3e-4
    kmeans_iterations: int = 10
    kmeans_num_clusters: tuple = (6, 6)


@dataclass
class DatasetConfig:
    data_dir: str = ""
    train_data_list: str = ""
    test_data_list: str = ""
    color_map_path: str = ""
    num_classes: int = 21
    semantic_ignore_index: int = 255


@dataclass
class TrainConfig:
    lr_policy: str = "poly"
    seed: int = 0
    random_mirror: bool = True
    random_scale: bool = True
    random_crop: bool = True
    shuffle: bool = True
    resume: bool = False
    begin_iteration: int = 0
    max_iteration: int = 30000
    warmup_iteration: int = 0
    decay_iterations: tuple = ()
    snapshot_step: int = 10000
    tensorboard_step: int = 100
    base_lr: float = 3e-3
    weight_decay: float = 5e-4
    momentum: float = 0.9
    optimizer: str = "sgd"
    batch_size: int = 4           # per the reference: per-device batch
    crop_size: tuple = (512, 512)
    memory_bank_size: int = 2
    sem_ann_loss_types: str = "segsort"
    sem_occ_loss_types: str = "segsort"
    img_sim_loss_types: str = "segsort"
    feat_aff_loss_types: str = "none"
    sem_ann_concentration: float = 6.0
    sem_occ_concentration: float = 12.0
    img_sim_concentration: float = 16.0
    feat_aff_concentration: float = 0.0
    sem_ann_loss_weight: float = 1.0
    sem_occ_loss_weight: float = 0.5
    img_sim_loss_weight: float = 0.1
    feat_aff_loss_weight: float = 0.0


@dataclass
class TestConfig:
    scales: tuple = (1.0,)
    image_size: int = 512
    crop_size: tuple = (512, 512)
    stride: tuple = (512, 512)


@dataclass
class TpuConfig:
    """Static-shape knobs shared with the JAX package (the section name is
    kept so one overrides dict configures both). The JAX package's knobs
    for XLA and the TPU mesh have no counterpart here and are skipped."""
    # max distinct (cluster, semantic, instance) segments per image
    segment_capacity: int = 256
    # value bound used to pack labels into sort keys
    label_cap: int = 256
    # compute dtype of the convolutions ('bfloat16' | 'float32');
    # parameters stay float32
    compute_dtype: str = "bfloat16"
    # width of the dataset-level tag vector (reference uses 256)
    tag_width: int = 256
    # sem_ann + sem_occ through the fused joint SegSort kernels
    # (O(N + P) memory) instead of the dense [N, P] losses
    use_fused_loss: bool = False
    # operand dtype of the fused loss kernels ('' = float32, the only one
    # ported: make_train_step raises for any other)
    loss_operand_dtype: str = ""
    # 'per_device_mean': mean over each train.batch_size image group,
    # then over groups (the reference's per-GPU mean); 'global_mean'
    loss_reduction: str = "per_device_mean"
    # compute the top-5 retrieval accuracy only on logged steps
    lazy_metrics: bool = True
    # DensePose: the reference constructs the feat_aff loss but never
    # calls it; True adds it (the NN-propagated tag set loss at the
    # feat_aff concentration and weight)
    apply_feat_aff: bool = False
    # inference: round padded shapes up to crop + k*stride (False: pad
    # only up to the crop); changes the sliding-window grid
    pad_to_stride_buckets: bool = True
    # inference: images per prediction batch; only 1 is ported
    # (inference/runner.py raises for more)
    infer_batch: int = 1
    # training feed: labels and tags as uint8 and, under bf16
    # convolutions, the image as bf16 on the host (a quarter of the
    # host-to-device bytes; both casts are exact, train/driver.py)
    compact_feed: bool = True


@dataclass
class Config:
    network: NetworkConfig = field(default_factory=NetworkConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    test: TestConfig = field(default_factory=TestConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)
    gpus: str = ""
    num_threads: int = 4


def _merge(dc, values: dict[str, Any]):
    for k, v in values.items():
        if not hasattr(dc, k):
            continue
        cur = getattr(dc, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _merge(cur, v)
        else:
            if isinstance(cur, tuple) and isinstance(v, list):
                v = tuple(v)
            if isinstance(cur, float):
                v = float(v)
            elif isinstance(cur, int) and not isinstance(cur, bool):
                v = int(v) if not isinstance(v, bool) else v
            setattr(dc, k, v)


def load_config(path: str | None = None,
                overrides: dict[str, Any] | None = None) -> Config:
    """Build a Config, optionally merging a reference-format YAML and a
    nested override dict (update_config semantics, default.py:83-103)."""
    cfg = Config()
    if path:
        import yaml  # only needed for YAML files
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        _merge(cfg, data)
    if overrides:
        _merge(cfg, overrides)
    return cfg

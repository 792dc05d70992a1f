"""The VOC image-tag training configuration, tags-only arm.

The recipe of bashscripts/voc12/train_spml_tag.sh:12-41 with
configs/voc12_template.yaml (the reference's
bashscripts/voc12/train_spml_tag.sh in twke18/SPML), run with
SEM_ANN_LOSS_TYPES=none, the override its environment surface offers at
line 30: the "tags only" arm of the paper's loss ablation, where segments
are pulled together only by image-tag co-occurrence and low-level image
similarity. ResNet-101 DeepLab at output stride 8, 64-d embeddings, crop
512, batch 4, 6x6 k-means x10, memory bank 2, segment capacity 256, bf16
convolutions; losses sem_occ (SetSegSort, 8 / 0.3) and img_sim (16 / 0.1),
sem_ann off (its metric is the classifier head's cross-entropy alone),
feat_aff off. The fused loss is on: with sem_ann off the step takes the
tag-set SegSort kernels.

Its batch is flagship.blobby_batch: four discs per image on a background
class, a few ignore pixels, dataset-level tags.
"""

from __future__ import annotations

from spml_tpu_torch.train.flagship import make_batch  # noqa: F401

NUM_CLASSES = 21

OVERRIDES = {
    "network": {"backbone_types": "panoptic_deeplab_101",
                "embedding_dim": 64, "kmeans_num_clusters": [6, 6],
                "kmeans_iterations": 10, "bn_momentum": 3e-4,
                "prediction_types": "segsort"},
    "dataset": {"num_classes": NUM_CLASSES, "semantic_ignore_index": 255},
    "train": {"batch_size": 4, "crop_size": [512, 512],
              "memory_bank_size": 2, "lr_policy": "poly", "base_lr": 3e-3,
              "weight_decay": 5e-4, "warmup_iteration": 100,
              "max_iteration": 30000,
              "sem_ann_loss_types": "none",
              "sem_ann_concentration": 6.0, "sem_ann_loss_weight": 0.3,
              "sem_occ_loss_types": "segsort",
              "sem_occ_concentration": 8.0, "sem_occ_loss_weight": 0.3,
              "img_sim_loss_types": "segsort",
              "img_sim_concentration": 16.0, "img_sim_loss_weight": 0.1,
              "feat_aff_loss_types": "none",
              "feat_aff_concentration": 0.0, "feat_aff_loss_weight": 0.0},
    "tpu": {"segment_capacity": 256, "compute_dtype": "bfloat16",
            "use_fused_loss": True},
}

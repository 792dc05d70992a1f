"""SPML contrastive embedding training (DensePose) on the card.

The port's counterpart of pyscripts/train/train_densepose.py, with its
flags (the reference's, twke18/SPML) and --device:

    python -m spml_tpu_torch.tools.train_densepose \
        --cfg_path CONFIG.yaml --data_dir DATA --data_list LIST \
        --snapshot_dir SNAPSHOT
"""

from spml_tpu_torch import cli
from spml_tpu_torch.data import datasets
from spml_tpu_torch.train import driver


def main():
    args, config = cli.parse_args(
        "Training for pixel-wise embeddings (DensePose).")
    driver.train_spml(args, config, datasets.DenseposeTagDataset,
                      device=args.device)


if __name__ == "__main__":
    main()

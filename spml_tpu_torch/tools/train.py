"""SPML contrastive embedding training (VOC) on the card.

The port's counterpart of pyscripts/train/train.py, with its
flags (the reference's, twke18/SPML) and --device (cuda: every visible
card, one rank each; cpu:N: N ranks on the CPU; under torchrun each
process is one rank):

    python -m spml_tpu_torch.tools.train \
        --cfg_path CONFIG.yaml --data_dir DATA --data_list LIST \
        --snapshot_dir SNAPSHOT
"""

from spml_tpu_torch import cli
from spml_tpu_torch.data import datasets
from spml_tpu_torch.parallel import mesh
from spml_tpu_torch.train import driver


def main():
    args, config = cli.parse_args("Training for pixel-wise embeddings.")
    mesh.launch(driver.train_spml,
                (args, config, datasets.ListTagDataset), args.device)


if __name__ == "__main__":
    main()

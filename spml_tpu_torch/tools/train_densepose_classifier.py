"""Stage-2 softmax classifier training (DensePose) on the card.

The port's counterpart of pyscripts/train/train_densepose_classifier.py,
with its flags (the reference's, twke18/SPML) and --device:

    python -m spml_tpu_torch.tools.train_densepose_classifier \
        --cfg_path CONFIG.yaml --data_dir DATA --data_list LIST \
        --snapshot_dir SNAPSHOT
"""

from spml_tpu_torch import cli
from spml_tpu_torch.data import datasets
from spml_tpu_torch.train import driver


def main():
    args, config = cli.parse_args("Training softmax classifier (DensePose).")
    driver.train_classifier(args, config, datasets.DenseposeClassifierDataset,
                            device=args.device)


if __name__ == "__main__":
    main()

"""Stage-2 softmax classifier training over a frozen embedding model, on
the card.

The port's counterpart of pyscripts/train/train_classifier.py, with its
flags (the reference's, twke18/SPML) and --device (cuda: every visible
card, one rank each; cpu:N: N ranks on the CPU; under torchrun each
process is one rank):

    python -m spml_tpu_torch.tools.train_classifier \
        --cfg_path CONFIG.yaml --data_dir DATA --data_list LIST \
        --snapshot_dir SNAPSHOT
"""

from spml_tpu_torch import cli
from spml_tpu_torch.data import datasets
from spml_tpu_torch.parallel import mesh
from spml_tpu_torch.train import driver


def main():
    args, config = cli.parse_args("Training softmax classifier.")
    mesh.launch(driver.train_classifier,
                (args, config, datasets.ListTagClassifierDataset), args.device)


if __name__ == "__main__":
    main()

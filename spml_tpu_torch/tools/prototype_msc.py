"""Build multi-scale semantic prototype memory banks.

The port's counterpart of
pyscripts/inference/prototype_msc.py: the reference's flags
(twke18/SPML) and --device (default cuda):

    python -m spml_tpu_torch.tools.prototype_msc \
        --cfg_path CONFIG.yaml --data_dir DATA --data_list LIST \
        --snapshot_dir SNAPSHOT --save_dir OUT
"""

from spml_tpu_torch import cli
from spml_tpu_torch.inference import runner


def main():
    args, config = cli.parse_args(__doc__.splitlines()[0])
    runner.run_prototype(args, config, scales=[0.5, 1.0, 1.5],
                         device=args.device)


if __name__ == "__main__":
    main()

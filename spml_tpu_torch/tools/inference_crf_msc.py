"""Multi-scale segsort KNN inference with DenseCRF.

The port's counterpart of
pyscripts/inference/inference_crf_msc.py: the reference's flags
(twke18/SPML) and --device (default cuda):

    python -m spml_tpu_torch.tools.inference_crf_msc \
        --cfg_path CONFIG.yaml --data_dir DATA --data_list LIST \
        --snapshot_dir SNAPSHOT --save_dir OUT \
        --semantic_memory_dir BANK \
        [--crf_iter_max 10 --crf_pos_xy_std 1 --crf_pos_w 3 ...]
"""

from spml_tpu_torch import cli
from spml_tpu_torch.inference import runner


def main():
    args, config = cli.parse_args(__doc__.splitlines()[0])
    runner.run_knn_inference(args, config, msc=True, crf=True,
                             device=args.device)


if __name__ == "__main__":
    main()

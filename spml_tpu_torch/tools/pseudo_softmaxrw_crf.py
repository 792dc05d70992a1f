"""Pseudo labels from softmax probs via random walk + DenseCRF.

The port's counterpart of
pyscripts/inference/pseudo_softmaxrw_crf.py: the reference's flags
(twke18/SPML) and --device (default cuda):

    python -m spml_tpu_torch.tools.pseudo_softmaxrw_crf \
        --cfg_path CONFIG.yaml --data_dir DATA --data_list LIST \
        --snapshot_dir SNAPSHOT --save_dir OUT \
        [--crf_iter_max 10 --crf_pos_xy_std 1 --crf_pos_w 3 ...]
"""

from spml_tpu_torch import cli
from spml_tpu_torch.inference import runner


def main():
    args, config = cli.parse_args(__doc__.splitlines()[0])
    # a single-scale (flip-only) pyramid, as the reference's
    # (pseudo_softmaxrw_crf.py:111-112); pseudo_softmax's is [0.75, 1]
    runner.run_pseudo_softmax(args, config, with_crf=True, with_walk=True,
                              scales=(1.0,), device=args.device)


if __name__ == "__main__":
    main()

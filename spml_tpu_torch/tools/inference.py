"""Single-scale segsort KNN inference.

The port's counterpart of
pyscripts/inference/inference.py: the reference's flags
(twke18/SPML) and --device (default cuda). With tpu.infer_batch > 1 the
groups of images are sharded over the ranks --device asks for (cuda:
every visible card; cpu:N: N ranks on the CPU; under torchrun each
process is one rank), as the JAX package shards them over its chips;
per image, one process runs on the device:

    python -m spml_tpu_torch.tools.inference \
        --cfg_path CONFIG.yaml --data_dir DATA --data_list LIST \
        --snapshot_dir SNAPSHOT --save_dir OUT \
        --semantic_memory_dir BANK
"""

from spml_tpu_torch import cli
from spml_tpu_torch.inference import runner
from spml_tpu_torch.parallel import mesh


def main():
    args, config = cli.parse_args(__doc__.splitlines()[0])
    if config.tpu.infer_batch > 1:
        mesh.launch(runner.run_knn_inference, (args, config), args.device)
    else:
        runner.run_knn_inference(args, config, device=args.device)


if __name__ == "__main__":
    main()

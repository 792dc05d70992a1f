"""Data-parallel training and sharded batched inference over
torch.distributed (spml_tpu_torch/parallel/mesh.py)."""

"""Training state: the models (which hold parameters and BN statistics),
the SGD momentum buffers, the dropout generator and the prototype memory
bank.

Port of spml_tpu/train/state.py (reference: pyscripts/train/train.py
:147-293 in twke18/SPML — prototypes FIFO'd over the last
memory_bank_size steps, batch indices shifted by the global batch each
step so they never collide with the current batch). The bank is a
fixed-shape [memory_bank_size, B*P, ...] set of tensors with validity
masks.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn


@dataclasses.dataclass
class MemoryBank:
    prototype: torch.Tensor           # [M, PG, D] float32
    prototype_with_loc: torch.Tensor  # [M, PG, D+L] float32
    semantic_label: torch.Tensor      # [M, PG] int64
    instance_label: torch.Tensor      # [M, PG] int64
    batch_index: torch.Tensor         # [M, PG] int64
    tag: torch.Tensor                 # [M, PG, tag_width] int64
    valid: torch.Tensor               # [M, PG] bool

    @classmethod
    def create(cls, size: int, num_protos: int, dim: int, loc_dim: int,
               tag_width: int, device) -> "MemoryBank":
        m, p = size, num_protos

        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return cls(prototype=z(m, p, dim),
                   prototype_with_loc=z(m, p, dim + loc_dim),
                   semantic_label=z(m, p, dtype=torch.int64),
                   instance_label=z(m, p, dtype=torch.int64),
                   batch_index=z(m, p, dtype=torch.int64),
                   tag=z(m, p, tag_width, dtype=torch.int64),
                   valid=z(m, p, dtype=torch.bool))

    def push(self, prototype, prototype_with_loc, semantic_label,
             instance_label, batch_index, tag, valid,
             global_batch: int) -> "MemoryBank":
        """FIFO insert of the current step's prototypes; existing entries'
        batch indices shift by `global_batch` (train.py:289-293)."""
        def rolled(old, new):
            return torch.cat([old[1:], new[None].to(old.dtype)], dim=0)

        return MemoryBank(
            prototype=rolled(self.prototype, prototype),
            prototype_with_loc=rolled(self.prototype_with_loc,
                                      prototype_with_loc),
            semantic_label=rolled(self.semantic_label, semantic_label),
            instance_label=rolled(self.instance_label, instance_label),
            batch_index=rolled(self.batch_index + global_batch,
                               batch_index + global_batch),
            tag=rolled(self.tag, tag),
            valid=rolled(self.valid, valid))


@dataclasses.dataclass
class TrainState:
    step: int
    emb_model: nn.Module
    cls_model: nn.Module
    momentum: dict          # parameter name -> SGD momentum buffer
    memory: MemoryBank
    generator: torch.Generator  # dropout draws

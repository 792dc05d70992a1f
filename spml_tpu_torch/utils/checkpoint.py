"""Train-state checkpoints: one torch.save file per step.

The port's counterpart of spml_tpu/utils/checkpoint.py (orbax; the
reference, twke18/SPML, saves torch state dicts every snapshot_step,
pyscripts/train/train.py:295-304). A file `ckpt-{step}.pt` holds the
whole TrainState: the models' state dicts (BN running statistics
included), the SGD momentum or the Adam moments and count, the memory
bank, the step and the dropout generator's state, so a resumed run
continues exactly. The name keeps a port checkpoint apart from an orbax
step, which is a directory named by the step alone.

A save writes a temporary file next to the target and moves it over the
target with os.replace: a step saved again is overwritten, and a crash
mid-save leaves the earlier file whole (the JAX package's staged
overwrite).

restore_models and load_embedding read a snapshot's weights for the
entry points: the inference models (cli.build_eval_models) and stage 2's
frozen embedding (train/driver.py::train_classifier).
"""

from __future__ import annotations

import dataclasses
import os
import re

import torch

from spml_tpu_torch.train.state import MemoryBank
from spml_tpu_torch.utils import torch_import

_NAME = re.compile(r"ckpt-(\d+)\.pt")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt-{step}.pt")


def steps(directory: str) -> list[int]:
    """The steps with a checkpoint file in `directory`, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.fullmatch,
                                               os.listdir(directory)) if m)


def latest_step(directory: str) -> int | None:
    found = steps(directory)
    return found[-1] if found else None


def _payload(state) -> dict:
    return {
        "step": state.step,
        "emb_model": (state.emb_model.state_dict()
                      if state.emb_model is not None else None),
        "cls_model": state.cls_model.state_dict(),
        "momentum": state.momentum,
        "adam_mu": state.adam_mu,
        "adam_nu": state.adam_nu,
        "adam_count": state.adam_count,
        "memory": (dataclasses.asdict(state.memory)
                   if state.memory is not None else None),
        "generator": state.generator.get_state(),
    }


def save(directory: str, step: int, state) -> str:
    """Writes `state` as step `step` (overwriting it); returns the path."""
    os.makedirs(directory, exist_ok=True)
    target = _path(directory, step)
    tmp = target + ".tmp"
    torch.save(_payload(state), tmp)
    os.replace(tmp, target)
    return target


def read(directory: str, step: int | None = None,
         device="cpu") -> dict:
    """The saved payload of `step` (the latest when None), its tensors on
    `device`."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    return torch.load(_path(directory, step), map_location=device,
                      weights_only=True)


def restore(directory: str, state, step: int | None = None):
    """`state` with the saved step (the latest when None) loaded: models
    in place (load_state_dict strict), buffers, memory bank and generator
    state replaced; the models' device is kept. The file is read into
    host memory, so a resume holds no second copy of the state on the
    card."""
    device = next(state.cls_model.parameters()).device
    saved = read(directory, step)
    if state.emb_model is not None:
        state.emb_model.load_state_dict(saved["emb_model"], strict=True)
    state.cls_model.load_state_dict(saved["cls_model"], strict=True)
    state.generator.set_state(saved["generator"])

    def to_device(tensors):
        return {k: v.to(device) for k, v in tensors.items()}

    memory = (MemoryBank(**to_device(saved["memory"]))
              if saved["memory"] is not None else None)
    return dataclasses.replace(
        state, step=saved["step"], momentum=to_device(saved["momentum"]),
        adam_mu=to_device(saved["adam_mu"]),
        adam_nu=to_device(saved["adam_nu"]),
        adam_count=saved["adam_count"], memory=memory)


def restore_models(config, snapshot_dir: str, emb_model,
                   cls_model=None) -> bool:
    """Loads a snapshot's weights into the models in place; False when the
    directory holds none. The port's form of the JAX package's _restore_any
    (cli.py:130-165):

    * the port's train checkpoints (snapshot_dir/checkpoints/ckpt-*.pt),
      the latest step, load_state_dict strict. A stage-2 checkpoint holds
      the classifier alone: the embedding then comes from
      network.pretrained (load_embedding), as in the reference's
      classifier inference (train_classifier.py:99-113);
    * else the reference's layout (train.py:295-304):
      `model-{max_iteration - 1}.pth`, key "embedding_model" strict, key
      "prediction_model" by the names it shares with the head — the file
      the JAX package's utils/torch_export.py::save_torch_checkpoint
      writes.

    A JAX (orbax) `checkpoints/` directory raises NotImplementedError.
    """
    ck_dir = os.path.join(snapshot_dir, "checkpoints")
    if latest_step(ck_dir) is not None:
        saved = read(ck_dir)
        if saved["emb_model"] is not None:
            emb_model.load_state_dict(saved["emb_model"], strict=True)
        else:
            load_embedding(config, config.network.pretrained, emb_model)
        if cls_model is not None:
            cls_model.load_state_dict(saved["cls_model"], strict=True)
        return True
    if os.path.isdir(ck_dir) and os.listdir(ck_dir):
        raise NotImplementedError(
            f"{ck_dir}: orbax checkpoints are not ported; export a "
            "model-*.pth with spml_tpu.utils.torch_export")
    pth = os.path.join(snapshot_dir,
                       f"model-{config.train.max_iteration - 1}.pth")
    if not os.path.isfile(pth):
        return False
    sd = torch.load(pth, map_location="cpu", weights_only=True)
    emb_model.load_state_dict(sd["embedding_model"], strict=True)
    if cls_model is not None and "prediction_model" in sd:
        cls_model.load_state_dict(sd["prediction_model"], strict=False)
    return True


def load_embedding(config, path: str, emb_model) -> None:
    """The frozen embedding of stage 2 (network.pretrained,
    train_classifier.py:99-113): a snapshot directory as restore_models
    reads it (the stage-1 snapshot), or a reference-format .pth, key
    "embedding_model", by the names and shapes it shares with the model.
    Raises when `path` gives no weights: a classifier over random
    embeddings is not trained by mistake."""
    if path and os.path.isdir(path):
        if restore_models(config, path, emb_model):
            return
    elif path and os.path.isfile(path):
        skipped = torch_import.load_pretrained(emb_model, path)
        if skipped:
            print(f"{path}: skipped {len(skipped)} entries without a "
                  f"counterpart: {skipped[:10]}")
        return
    raise FileNotFoundError(
        f"network.pretrained {path!r}: no embedding weights there")

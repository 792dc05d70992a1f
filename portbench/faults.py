"""Faults planted under the timed path, for the check's own tests and the
control runs (portbench/control.py): each a context manager that breaks
the program where the fault arises and mends it on exit.

* state_unchanged: the optimizer's update does nothing, so a step
  returns its parameters as it found them;
* window_unchanged: as state_unchanged, but only from the fourth call of
  the step on, so the steps set-up checks are sound and those of the
  window (and after it) leave the parameters and momentum as they were;
* half_batch: the train step sees the second half of each batch's
  images with every label ignored, so its losses are means over the
  first half alone;
* answer_altered: inference's vote gives one segment of each image the
  next class.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(owner, name, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def state_unchanged():
    from spml_tpu_torch.train import optim
    return _patched(optim, "sgd_step", lambda orig: lambda *a, **k: None)


def window_unchanged():
    from spml_tpu_torch.train import step as step_lib

    def make(orig):
        def make_train_step(config):
            train_step, calls = orig(config), [0]

            def broken(state, batch):
                calls[0] += 1
                if calls[0] <= 3:
                    return train_step(state, batch)
                with state_unchanged():
                    return train_step(state, batch)
            return broken
        return make_train_step
    return _patched(step_lib, "make_train_step", make)


def half_batch():
    from spml_tpu_torch.train import step as step_lib

    def make(orig):
        def make_train_step(config):
            train_step = orig(config)

            def broken(state, batch):
                batch = dict(batch)
                half = batch["image"].shape[0] // 2
                for key, fill in (("semantic_label", 255),
                                  ("instance_label", 0)):
                    lab = batch[key].clone()
                    lab[half:] = fill
                    batch[key] = lab
                return train_step(state, batch)
            return broken
        return make_train_step
    return _patched(step_lib, "make_train_step", make)


def answer_altered():
    from spml_tpu_torch.inference import engine

    def make(orig):
        def vote(self, topk, seg_ids, shape):
            pred = orig(self, topk, seg_ids, shape)
            first = seg_ids.reshape(shape) == seg_ids[0]
            c = self.config.dataset.num_classes
            return pred.masked_fill(first, 0) + first * ((pred + 1) % c)
        return vote
    return _patched(engine.InferenceEngine, "vote", make)


FAULTS = {"state_unchanged": state_unchanged,
          "window_unchanged": window_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered}

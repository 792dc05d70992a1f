"""Softmax-classifier inference of stage-2 models.

Port of spml_tpu/inference/softmax.py (reference: pyscripts/inference/
inference_softmax.py:115-170 in twke18/SPML): the padded image cut into
sliding windows, the classifier's logits over each window's L2-normalized
embeddings at the crop's size, the logits SUMMED over the windows with no
division by their count, then a softmax per pixel (the KNN engine's
overlap average does divide).

Buckets, upload, the windows' embeddings (one batched forward of a
padded image's windows) and the multi-scale members are the KNN
engine's (engine.WindowEngine). predict_probs runs the one path of the
JAX package's fused form; its eager twin (predict_logits,
predict_probs(fused=False), equal by the JAX package's tests) has no
counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from spml_tpu_torch.inference.engine import WindowEngine


class SoftmaxInferenceEngine(WindowEngine):
    """Stage-2 inference of one embedding model and classifier head on one
    device (WindowEngine's arguments and the head, moved to `device` and
    put in eval mode: BN's running averages, no dropout)."""

    def __init__(self, config, emb_model, cls_model, device="cuda"):
        super().__init__(config, emb_model, device)
        self.cls_model = cls_model.to(self.device).eval()

    @torch.no_grad()
    def window_probs(self, img: torch.Tensor) -> torch.Tensor:
        """Padded image(s) [..., Hb, Wb, 3] -> [..., Hb, Wb, C] softmax of
        the window logits summed at each pixel."""
        emb = self.embed_windows(img)
        logits = self.cls_model(emb.flatten(0, -4))
        logits = logits.reshape(*emb.shape[:-1], logits.shape[-1])
        return torch.softmax(self.sum_windows(logits, *img.shape[-3:-1]),
                             dim=-1)

    def predict_probs(self, image: np.ndarray) -> np.ndarray:
        """[H, W, C] float32 probabilities of one image."""
        h, w = image.shape[:2]
        probs = self.window_probs(self.upload_image(image))
        return probs[:h, :w].cpu().numpy()

    def member_probs(self, members: torch.Tensor,
                     member_hw) -> torch.Tensor:
        """Pyramid members [n, Hb, Wb, 3] through one window forward:
        [n, Hb, Wb, C] (the padding's probabilities are never read)."""
        del member_hw
        return self.window_probs(members)

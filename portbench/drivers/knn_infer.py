"""A KNN inference cell: the port's single-scale prediction
(spml_tpu_torch.inference.engine.InferenceEngine.predict_semantic), one
image at a time in a closed loop over a pool of distinct images, against
a memory bank made in set-up.

Set-up builds the eval model (spml_tpu_torch.cli.build_eval_models, the
benchmark's weights loaded, strict), the engine, the pool and the bank,
and predicts WARM_IMAGES images. The window predicts the pool in turn,
each image ending in its prediction on the host, until --seconds have
passed. The benchmark's own wrappers on the engine instance keep each
image's segment ids and top-20 labels for the check and, with --trace 1,
put record_function spans around its stitch, segment and retrieve calls
for the HOST_IMAGES images of the host profile.
"""

from __future__ import annotations

import contextlib
import gc
import tempfile
import time

import torch

from portbench import checks, flops, trace as trace_lib
from portbench import traffic as traffic_lib
from portbench.reference import infer as ref_infer
from portbench.reference import model as ref_model

WARM_IMAGES = 2
TRACE_AFTER = 4
TRACE_IMAGES = 8  # under the device-only profile
HOST_IMAGES = 4  # under the host-and-device profile, with the spans
SPANS = ("stitch", "segment", "retrieve")


def weights(over: dict, seed: int, device) -> dict:
    net = over["network"]
    gen = torch.Generator(device).manual_seed(traffic_lib.torch_seed(seed, 3))
    return ref_model.make_weights(ref_model.embedding_spec(
        net["backbone_types"], net["embedding_dim"]), gen, device)


class Wrapped:
    """The engine's stitch / segment / retrieve, each inside a span while
    `spans` is set, segment's and retrieve's outputs kept as `last`."""

    def __init__(self, eng):
        self.spans, self.last = False, {}
        self.classes = eng.config.dataset.num_classes
        self.failed = 0  # predictions with a class outside [0, classes)
        for name in SPANS:
            setattr(eng, name, self._wrap(name, getattr(eng, name)))

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            ctx = (torch.profiler.record_function(f"portbench.{name}")
                   if self.spans else contextlib.nullcontext())
            with ctx:
                out = fn(*args, **kwargs)
            if name != "stitch":
                self.last[name] = out
            return out
        return wrapped


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t0: float) -> dict:
    from spml_tpu_torch import cli
    from spml_tpu_torch.config import load_config
    from spml_tpu_torch.inference import engine as engine_lib

    over, traffic = cell["config"]["inference_overrides"], cell["traffic"]
    pcfg = load_config(overrides=over)
    c = pcfg.dataset.num_classes
    with tempfile.TemporaryDirectory() as empty:  # no snapshot to read
        model = cli.build_eval_models(pcfg, empty, device)
    w = weights(over, seed, device)
    model.load_state_dict(w, strict=True)
    del w
    eng = engine_lib.InferenceEngine(pcfg, model, device)
    hooks = Wrapped(eng)
    pool = traffic_lib.inference_images(traffic, seed, c,
                                        pcfg.network.pixel_means,
                                        pcfg.network.pixel_stds)
    bank = traffic_lib.make_bank(seed, traffic["bank_rows"],
                                 pcfg.network.embedding_dim, c, device)
    for j in range(WARM_IMAGES):
        eng.predict_semantic(pool[j % len(pool)], *bank)

    timing = device.type == "cuda"
    sync = torch.cuda.synchronize if timing else (lambda: None)
    sync()
    if timing:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0

    first, last, traced = {}, {}, None
    times = []
    start = time.perf_counter()
    j = 0
    while True:
        k = j % len(pool)
        if trace and j == TRACE_AFTER and traced is None:
            traced = _traced_images(eng, hooks, pool, bank, j, first, last,
                                    sync)
            j += TRACE_IMAGES + HOST_IMAGES
            continue
        t = time.perf_counter()
        pred = eng.predict_semantic(pool[k], *bank)
        times.append(time.perf_counter() - t)
        _keep(k, pred, hooks, first, last)
        j += 1
        if time.perf_counter() - start >= seconds and (
                not trace or traced is not None):
            break
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated() if timing else 0
    images = j
    repeat = sum(int((first[k] != last[k][0]).sum()) for k in last)

    # the check: the stitched maps again through the engine, then the
    # program freed and the reference run
    prog = []
    for k in sorted(last):
        pred, ids, topk = last[k]
        stitched = eng.stitch(eng.upload_image(pool[k])).cpu()
        prog.append({"stitched": stitched, "ids": ids.cpu(),
                     "topk": topk.cpu(), "pred": pred})
    del eng, model, last
    gc.collect()
    if timing:
        torch.cuda.empty_cache()
    net = ref_model.Net(weights(over, seed, device),
                        over["network"]["backbone_types"], train=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = [{k: v.cpu() for k, v in ref_infer.predict(
        net, pool[k], over, bank, device).items()} for k in sorted(first)]
    numbers = checks.infer_numbers(prog, ref)

    out = {"attempted": images, "failed": hooks.failed, "peak_bytes": peak,
           "numbers": numbers, "setup_s": setup_s, "window_s": window_s,
           # the same image's first and last predictions of the window
           "info": {"repeat_pixels_differ": repeat}}
    if timing:
        out["metrics"] = {"infer_images_per_s": len(times) / window_s}
    if traced is not None:
        h, w = over["test"]["crop_size"]
        untraced = sum(times)
        traced.update(flops_per_item=flops.forward_flops(
                          over["network"]["backbone_types"],
                          over["network"]["embedding_dim"], h, w),
                      untraced_items=len(times), untraced_s=untraced)
        out["trace"] = traced
    return out


def _keep(k, pred, hooks, first, last):
    """The first prediction of pool image k, and its latest with its
    segment ids and top-20 labels."""
    hooks.failed += int(pred.min() < 0 or pred.max() >= hooks.classes)
    first.setdefault(k, pred)
    last[k] = (pred, hooks.last["segment"][0], hooks.last["retrieve"])


def _traced_images(eng, hooks, pool, bank, j, first, last, sync):
    """TRACE_IMAGES predictions under the device-only profile, then
    HOST_IMAGES under the host one with the spans
    (portbench/trace.py::profile)."""
    held = {"j": j}

    def one():
        k = held["j"] % len(pool)
        _keep(k, eng.predict_semantic(pool[k], *bank), hooks, first, last)
        held["j"] += 1

    def spans(on):
        hooks.spans = on

    return trace_lib.profile(one, sync, TRACE_IMAGES, HOST_IMAGES, spans)

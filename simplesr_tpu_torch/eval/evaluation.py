"""Evaluation and inference operations, as simplesr_tpu.eval.evaluation:
turning a model into a predictor, the upscale that sends LR images over
1000 x 1000 through the overlap-tiled route (128 px patches, 32 px overlap,
batches of 8), and ``evaluate_on_validationdata``, the paired evaluation
(PSNR, PSNR on Y and SSIM per image with max_val 2.0 on [-1, 1], the
interpolated row, single images, half-splits and grids). The unpaired
``evaluate_on_testdata`` is not ported yet (ROADMAP.md, Queue 1).
"""

import logging
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn as nn

from simplesr_tpu_torch.core.device import resolve_device
from simplesr_tpu_torch.core.ranges import to_11_from_01
from simplesr_tpu_torch.eval import rendering
from simplesr_tpu_torch.ops import metrics as metrics_lib
from simplesr_tpu_torch.ops.resize import resize as _resize
from simplesr_tpu_torch.ops.tiling import tiled_apply
from simplesr_tpu_torch.utils import logger as logger_mod

log = logging.getLogger(logger_mod.RESULTS_LOGGER)

_TILE_MIN_HW = 1000
_TILE_PATCH = 128
_TILE_OVERLAP = 32
_TILE_BATCH = 8


def _as_predictor(model, fast=False, ensemble=False, paired=0, device="cuda"):
    """Normalise an SRModel, a Generator, a model path, a ``(module,
    state_dict)`` pair or a callable into ``fn(lr_nhwc) -> sr_nhwc``. An
    SRModel or a Generator serves its ``generate`` whatever ``fast`` says,
    as in the JAX package. The port serves the training form of a saved
    model: the polyphase rewrite (``fast`` on a path or a pair), the
    self-ensemble and the paired trunk are not ported yet."""
    from simplesr_tpu_torch.train.generator import Generator
    from simplesr_tpu_torch.train.serialization import load_model
    from simplesr_tpu_torch.train.sr_model import SRModel

    if ensemble:
        raise NotImplementedError(
            "the x8 self-ensemble is not ported yet: ROADMAP.md, Queue 1, "
            "large-image and serving inference")
    if paired:
        raise NotImplementedError(
            "the paired trunk is not ported yet: ROADMAP.md, Queue 1, "
            "exact serving rewrites")
    if isinstance(model, (SRModel, Generator)):
        return model.generate
    if fast and isinstance(model, (str, os.PathLike, tuple)):
        raise NotImplementedError(
            "fast=True (the polyphase serving rewrite) is not ported yet: "
            "ROADMAP.md, Queue 1, exact serving rewrites; pass fast=False")
    if isinstance(model, (str, os.PathLike)):
        module = load_model(str(model), device=device)
    elif isinstance(model, tuple) and len(model) == 2 and isinstance(model[0], nn.Module):
        module, state_dict = model
        module.load_state_dict(state_dict)
        module = module.to(resolve_device(device)).eval()
    elif callable(model):
        return model
    else:
        raise TypeError(f"cannot build a predictor from {type(model)}")

    def predict(x):
        with torch.inference_mode():
            return module(x)

    return predict


def _hw(tensor):
    if tensor.dim() == 4:
        return int(tensor.shape[1]), int(tensor.shape[2])
    if tensor.dim() == 3:
        return int(tensor.shape[0]), int(tensor.shape[1])
    raise ValueError(f"Received tensor with unexpected rank: {tensor.dim()}")


def _eligible_efficient_inference(tensor, min_width=_TILE_MIN_HW,
                                  min_height=_TILE_MIN_HW):
    if tensor.dim() not in (3, 4):
        return False
    if tensor.dim() == 4 and tensor.shape[0] != 1:
        return False
    h, w = _hw(tensor)
    return h > min_height and w > min_width


def _upscale(predict, lr_batch, scale):
    """SR a batch (tensor on the predictor's device); a single image over
    the tiling threshold goes through the overlap-tiled route."""
    x = lr_batch
    if _eligible_efficient_inference(x):
        img = x[0] if x.dim() == 4 else x
        out = tiled_apply(predict, img, (_TILE_PATCH, _TILE_PATCH),
                          overlap=_TILE_OVERLAP, scale=scale, batch_size=_TILE_BATCH)
        return out[None]
    if x.dim() == 3:
        x = x[None]
    return predict(x)


def _load_models(config, model, model_name, fast=True, ensemble=False, device="cuda"):
    if model is None:
        if getattr(config, "model_path", None) is None:
            raise ValueError("No model was supplied and config does not contain path to model")
        paths = config.model_path
        if not isinstance(paths, list):
            paths = [paths]
        return {Path(p).stem: _as_predictor(p, fast=fast, ensemble=ensemble, device=device)
                for p in paths}
    if isinstance(model, dict):
        return {k: _as_predictor(v, fast=fast, ensemble=ensemble, device=device)
                for k, v in model.items()}
    return {model_name: _as_predictor(model, fast=fast, ensemble=ensemble, device=device)}


def _numpy(x):
    return x.detach().to("cpu", torch.float32).numpy()


def evaluate_on_validationdata(config, model_name="", pipeline=None, model=None,
                               save_grid=False, combine_halfs=False,
                               save_single=False, save_prefix="",
                               calc_stats=False, fast=True, ensemble=None, device="cuda"):
    """Paired evaluation on the pipeline's validation set (the pipeline of
    ``config`` on ``device`` when none is given). Returns
    ``{model or interpolation name: {"psnr": [...], "psnr-y": [...],
    "ssim": [...]}}`` (one value per image) when ``calc_stats``, else {}."""
    from simplesr_tpu_torch.data import DataPipeline

    if pipeline is None:
        pipeline = DataPipeline.from_config(config, device=device)
    if ensemble is None:
        ensemble = bool(getattr(config, "self_ensemble", False))
    models = _load_models(config, model, model_name, fast=fast, ensemble=ensemble,
                          device=device)

    ground_truth_key = "GT"
    low_res_key = "LR"
    interpolated_key = str(pipeline.resize_filter)
    psnr_y_key = "psnr-y"

    metrics_res = {name: {"psnr": [], psnr_y_key: [], "ssim": []}
                   for name in list(models) + [interpolated_key]}
    scale = config.scale
    pic_dir = getattr(config, "pic_dir", ".")

    for idx, (lr_batch, hr_batch) in enumerate(pipeline.validation_batch_generator()):
        result_pics = {ground_truth_key: hr_batch, low_res_key: lr_batch}

        # LR is [0, 1]; compare its interpolation on [-1, 1]
        _lr11 = to_11_from_01(lr_batch)
        h, w = _hw(lr_batch)
        interpolated = _resize(_lr11, (h * scale, w * scale), method=pipeline.resize_filter)
        if _hw(hr_batch) != (h * scale, w * scale):  # integer-rounded sizes
            hr_batch = _resize(hr_batch, (h * scale, w * scale))
        result_pics[interpolated_key] = interpolated

        def _accumulate(name, sr):
            metrics_res[name]["psnr"].append(_numpy(metrics_lib.psnr(hr_batch, sr, max_val=2.0)))
            metrics_res[name][psnr_y_key].append(
                _numpy(metrics_lib.psnr_on_y(hr_batch, sr, max_val=2.0)))
            metrics_res[name]["ssim"].append(_numpy(metrics_lib.ssim(hr_batch, sr, max_val=2.0)))

        if calc_stats:
            _accumulate(interpolated_key, interpolated)
        if save_single:
            rendering.save_single(interpolated, os.path.join(pic_dir, "interpolated"),
                                  f"{save_prefix}{idx}")
            rendering.save_single(_lr11, os.path.join(pic_dir, "low_res"), f"{save_prefix}{idx}")

        for name, predict in models.items():
            sr_batch = _upscale(predict, lr_batch, scale)
            result_pics[name] = sr_batch
            if calc_stats:
                _accumulate(name, sr_batch)
            if save_single:
                rendering.save_single(sr_batch, os.path.join(pic_dir, name, "single"),
                                      f"{save_prefix}{idx}")
            if combine_halfs:
                rendering.combine_halfs(
                    left_tensor=sr_batch,
                    right_tensor=_resize(_lr11, _hw(sr_batch), method=pipeline.resize_filter),
                    left_label=name, right_label=interpolated_key,
                    save_dir=os.path.join(pic_dir, name, "half"), fname=f"{save_prefix}{idx}")

        if save_grid:
            n = int(hr_batch.shape[0]) if hr_batch.dim() == 4 else 1
            if calc_stats:
                batch_psnr = {name: metrics_res[name]["psnr"][-1] for name in metrics_res}
                batch_psnr[ground_truth_key] = np.full(n, float("inf"))
                batch_psnr[low_res_key] = np.full(n, -1.0)
                batch_ssim = {name: metrics_res[name]["ssim"][-1] for name in metrics_res}
                batch_ssim[ground_truth_key] = np.ones(n)
                batch_ssim[low_res_key] = np.full(n, -1.0)
            else:
                batch_psnr = batch_ssim = None
            rendering.prepare_image_grid(
                save_dir=os.path.join(pic_dir, "grids"), fname=f"{save_prefix}{idx}",
                low_res_key=low_res_key, psnr=batch_psnr, ssim=batch_ssim, **result_pics)

    results = {}
    if calc_stats:
        for name, res in metrics_res.items():
            results[name] = {k: np.concatenate(v) if v else np.array([]) for k, v in res.items()}
        for name, res in results.items():
            log.info(f"Average PSNR for {name}: {np.mean(res['psnr']):.4f}")
            log.info(f"Average PSNR on y-channel for {name}: {np.mean(res[psnr_y_key]):.4f}")
            log.info(f"Average SSIM for {name}: {np.mean(res['ssim']):.4f}")
    return results

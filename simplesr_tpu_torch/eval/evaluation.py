"""Evaluation and inference operations, as simplesr_tpu.eval.evaluation:
turning a model into a predictor in its serving form, the upscale that sends
LR images over 1000 x 1000 through the overlap-tiled route (128 px patches,
32 px overlap, batches of 8), ``evaluate_on_validationdata``, the paired
evaluation (PSNR, PSNR on Y and SSIM per image with max_val 2.0 on [-1, 1],
the interpolated row, single images, half-splits and grids), and
``evaluate_on_testdata``, the unpaired inference over test images (singles,
half-splits, nearest-interpolated and grids), which tiles every large image
together per model through ``tiled_apply_many``.
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
from simplesr_tpu_torch.ops.tiling import tiled_apply, tiled_apply_many
from simplesr_tpu_torch.utils import logger as logger_mod

log = logging.getLogger(logger_mod.RESULTS_LOGGER)

_TILE_MIN_HW = 1000
_TILE_PATCH = 128
_TILE_OVERLAP = 32
_TILE_BATCH = 8


def check_tile_threshold(tile_threshold):
    """Refuse a tile threshold other than the route's own, for entry points
    that go through ``_upscale`` alone (``upscale_files``): it tiles over
    ``_TILE_MIN_HW`` whatever the argument says. ``SREngine`` routes by its
    threshold itself."""
    if tile_threshold != _TILE_MIN_HW:
        raise ValueError(f"tile_threshold must be {_TILE_MIN_HW}, the tiled route's fixed "
                         f"threshold; got {tile_threshold}")


def _pad_to_multiple(fn, ways):
    """``fn`` made safe for any batch when it needs one divisible by
    ``ways``: pad with repeats of the first item up to the next multiple
    (batch entries are independent through the convs) and slice the padding
    back off."""
    def padded(x):
        b = x.shape[0]
        r = (-b) % ways
        if r:
            x = torch.cat([x, x[:1].expand(r, *x.shape[1:])], dim=0)
        return fn(x)[:b]

    return padded


def _as_predictor(model, fast=True, ensemble=False, paired=0, device="cuda"):
    """Normalise an SRModel, a Generator, a model path, a ``(module,
    state_dict)`` pair or a callable into ``fn(lr_nhwc) -> sr_nhwc`` on
    ``device``.

    ``fast=True`` (the default) serves a path or a pair in the exact serving
    form where one exists (``models.polyphase.fast_inference``: the
    polyphase tail for SRResNet); ``fast=False`` serves the training form.
    ``ensemble=True`` wraps the predictor in the x8 geometric self-ensemble
    (``ops/ensemble.py``; on the tiled route per tile). ``paired=w`` serves
    a saved SRResNet or RRDB through the paired trunk (``models/paired.py``),
    padding batches that ``w`` does not divide. An SRModel or a Generator
    serves its ``generate`` whatever ``fast`` says, as in the JAX package."""
    from simplesr_tpu_torch.models.polyphase import fast_inference
    from simplesr_tpu_torch.ops.ensemble import ensemble_predictor
    from simplesr_tpu_torch.train.generator import Generator
    from simplesr_tpu_torch.train.serialization import load_model
    from simplesr_tpu_torch.train.sr_model import SRModel

    wrap = ensemble_predictor if ensemble else (lambda fn: fn)
    if paired:
        inner_wrap, wrap = wrap, (lambda fn: inner_wrap(_pad_to_multiple(fn, paired)))

    if isinstance(model, (SRModel, Generator)):
        return wrap(model.generate)
    if isinstance(model, (str, os.PathLike)):
        device = resolve_device(device)
        module = load_model(str(model), device="cpu")
        state = module.state_dict()
    elif isinstance(model, tuple) and len(model) == 2 and isinstance(model[0], nn.Module):
        device = resolve_device(device)
        module, state = model
    elif callable(model):
        return wrap(model)
    else:
        raise TypeError(f"cannot build a predictor from {type(model)}")
    if fast or paired:
        # paired with fast=False keeps the training-form tail; RRDB keeps
        # its training-form tail either way
        module, state = fast_inference(module, state, paired_ways=paired, polyphase=fast)
    module.load_state_dict(state)
    module = module.to(device).eval()

    def predict(x):
        with torch.inference_mode():
            return module(x)

    return wrap(predict)


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


def evaluate_on_testdata(config, model_name="", pipeline=None, model=None,
                         save_single=True, combine_halfs=False, interpolate=True, grid=True,
                         with_original=False, save_prefix="", fast=True, ensemble=None,
                         device="cuda"):
    """Unpaired inference over the pipeline's test images (the inference
    pipeline of ``config`` on ``device`` when none is given). Returns one
    ``{model or "interpolated": SR batch}`` per test batch."""
    from simplesr_tpu_torch.data import DataPipeline

    if pipeline is None:
        pipeline = DataPipeline.inference_pipeline(config, device=device)
    if ensemble is None:
        ensemble = bool(getattr(config, "self_ensemble", False))
    models = _load_models(config, model, model_name, fast=fast, ensemble=ensemble,
                          device=device)
    scale = config.scale
    pic_dir = getattr(config, "pic_dir", ".")
    batch_size = getattr(config, "batch_size", 1)

    # Two passes: the batches first, so that the images over 1000 x 1000 are
    # tiled together per model (tiled_apply_many pools their patches into
    # shared chunks: one ragged chunk in all instead of one per image).
    batches = list(pipeline.test_batch_generator(batch_size))
    tiled_idx = [i for i, (lr, _) in enumerate(batches) if _eligible_efficient_inference(lr)]
    tiled_sr = {}
    for name, predict in models.items():
        if not tiled_idx:
            break
        imgs = [batches[i][0] for i in tiled_idx]
        imgs = [x[0] if x.dim() == 4 else x for x in imgs]
        outs = tiled_apply_many(predict, imgs, (_TILE_PATCH, _TILE_PATCH),
                                overlap=_TILE_OVERLAP, scale=scale, batch_size=_TILE_BATCH)
        tiled_sr[name] = dict(zip(tiled_idx, outs))

    outputs = []
    for idx, (lr_batch, file_paths) in enumerate(batches):
        original_name = Path(str(file_paths[0])).parent.stem
        results = {}
        for name, predict in models.items():
            if idx in tiled_sr.get(name, {}):
                sr_batch = tiled_sr[name][idx][None]
            else:
                sr_batch = _upscale(predict, lr_batch, scale)
            results[name] = sr_batch
            if save_single:
                rendering.save_single(sr_batch, os.path.join(pic_dir, original_name, "single"),
                                      f"{save_prefix}{idx}_{original_name}_{name}")
            if combine_halfs:
                rendering.combine_halfs(
                    left_tensor=sr_batch, right_tensor=_resize(lr_batch, _hw(sr_batch)),
                    left_label=name, right_label="interpolated",
                    save_dir=os.path.join(pic_dir, original_name, "half"),
                    fname=f"{save_prefix}{idx}_{original_name}_{name}")

        if interpolate and results:
            some_sr = next(iter(results.values()))
            results["interpolated"] = _resize(lr_batch, _hw(some_sr), method="nearest")
            if save_single:
                rendering.save_single(results["interpolated"],
                                      os.path.join(pic_dir, "interpolated"),
                                      f"{save_prefix}{idx}")

        original = None
        if with_original:
            original = getattr(config, "test_originals", {}).get(original_name)

        if grid:
            rendering.prepare_image_grid(
                save_dir=os.path.join(pic_dir, "grids"), fname=f"{save_prefix}{idx}_{original_name}",
                low_res_key=None, psnr=None, original=original, **results)
        outputs.append(results)
    return outputs

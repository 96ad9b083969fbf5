#!/usr/bin/env python3
"""Smoke run of simplesr_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

It serves the committed SRResNet x4 flagship (16 blocks, 64 filters, BN-free,
bf16) through the port's entry points and holds every CUDA kernel against its
plain PyTorch version, in one process, with no arguments:

  0. the card's name and power limit;
  1. build the CUDA kernels from simplesr_tpu_torch/csrc (one nvcc call);
  2. trunk kernel vs its plain version at (8, 192, 192, 64) on the flagship's
     16 blocks, the tiled route's shape: each block on the same input (max
     relative error < 1e-2), and the 16-block chain against float64 sums;
     then each block at the shapes that the persistent loop and the edges
     exercise (fewer tiles than SMs, ragged on both axes, more tiles than
     CTAs times stages), to the same bound;
  3. patch-extraction kernel vs its plain version, bit-exact, at the tiled
     route's 1100 x 1040 x 3 image (128 px patches, 32 px overlap) and at an
     unaligned size;
  4. the main path, ``tools.upscale.upscale_files``: a gallery PNG (untiled)
     and a 1100 x 1040 LR PNG (the tiled route), each with the launch counts
     set to 0 just before and read just after; outputs checked for shape,
     finiteness and range, against the same routes on the plain versions,
     and against the CPU path on a small input;
  5. four requests of two shapes through ``tools.serve.SREngine``, with the
     launch counts set to 0 just before and read just after, checked against
     the one-shot path;
  6. timings with CUDA events: each kernel, its plain version and one
     PyTorch library call for the same function, as one call from Python
     between two events (``ms``, median of 25 runs) and also as device time
     (``device_ms``: many calls captured in one CUDA graph and replayed
     between two events, so that no host time between launches counts;
     median of 10 replays); the tiled upscale end to end (median of 20
     runs); each kernel's registers, spills and shared memory as
     ``cudaFuncGetAttributes`` reads them;
  7. training at full width through ``train.SRModel``: the production
     recipe's generator (x4, 16 blocks, 64 filters, BN-free, bf16 compute,
     float32 parameters, seeded), Adam on the recipe's piecewise schedule
     with the NaN guard, batches of 16 HR crops of 96 x 96 from the gallery
     PNGs (flips and 90 degree turns) and their 24 x 24 LR from the port's
     bicubic resize. Checks: the gradients through ``TrunkFunction`` (kernel
     forward) against autograd straight through the plain trunk; 30 steps
     with finite losses that fall; one trunk launch per ``train_step`` and
     ``validation_step`` and none in the backward; ``generate`` bit-equal to
     a module loaded from ``save_model``'s file; the flagship with grad
     enabled bit-equal to ``inference_mode``; a 128-wide model on CUDA
     against the CPU, with no trunk launch. Printed, not gated: the step's
     time (median of 30, CUDA events) and its forward, backward and
     optimizer parts, HR MPix/s, peak memory, and the same step with the
     trunk in plain autograd (cuDNN, activations stored); for each, a
     ``torch.profiler`` trace of 3 steps (device busy time, idle share, the
     kernels that take the most device time), taken after phase 8's timings;
  8. training from a YAML file: the production recipe
     (examples/training/srresnet_x4_paired_production.yaml), read by the
     port's YAML reader and written with these cuts, each printed in
     ``reduced``: the gallery PNGs as data, a temporary results directory,
     2 epochs, seed 0 (``paired_train: 2`` kept); run in-process through
     ``tools.train.main`` (ConfigUtil.from_yaml, DataPipeline, SRModel.init,
     run_training), with the launch counts set to 0 just before and read
     just after. Checks: exit 0; the save-dir tree and file names of the
     JAX package's run; finite histories and a lower epoch-mean loss in
     epoch 2; the ``_best`` file's output on a gallery crop bit-equal to
     the trained module's; one trunk launch per ``train_step``,
     ``validation_step`` and ``generate`` call (counted by the phase);
     ``--resume`` with 3 epochs starts at epoch 2 with the first run's
     histories and early-stopping state and runs one epoch; a run that gets
     SIGTERM after 55 steps exits 75 and leaves a resume point, and its
     ``--resume`` finishes it; the TensorBoard event files, through the
     port's own writer (``utils/tensorboard.py``) and read back with
     ``read_scalars``: an events file in each of the four log directories,
     the epoch scalars equal to the JSON epoch histories at float32 at steps
     1..epochs, and after each resume (of the finished run and of the
     preempted one) the epoch and batch steps running on across the
     processes' files with no gap and no repeat; the
     pipeline on the card against the CPU for the same config and seed (3
     training batches: HR bit-equal, LR max abs < 1e-4). Printed, not
     gated: the scalars in each log directory and the writer's time in the
     run, seconds per epoch (from ``before_epoch`` to ``after_epoch``,
     validation and plots included), train steps per second, HR MPix/s end
     to end (pipeline included), the share of each epoch spent waiting on
     the pipeline's generators, the time to decode the 16 PNGs, peak
     memory, one epoch of the pipeline alone and of the bare steps on its
     batches, and a ``torch.profiler`` trace of 10 steps of the loop, taken
     last (a profiler session slows the launches after it, so phase 7's
     traces wait until phase 8's timings are done);
  9. the SRGAN stage from its YAML file (examples/training/srgan_x4.yaml),
     its two-stage pipeline: ``pretrained_model_path`` set to the flagship,
     so the generator is the BN-free 16 x 64 bf16 SRResNet of that file
     (the YAML's ``batch_norm: true`` yields to the file's architecture, as
     in the JAX package) and its trunk is the trunk kernel; all else of the
     recipe kept (VGG54 post-activation / 12.75 + adversarial 1e-3, the
     standard critic at 96 x 96 with label smoothing 0.2, Adam 1e-4 for both,
     batch 16 of 96 x 96, 16 crops per image, flips and turns, split 0.05),
     cut to the gallery PNGs, 2 epochs, seed 0, a temporary results
     directory and VGG from its seeded init (no ImageNet weights are in the
     repo), each cut printed in ``reduced``; run through ``tools.train.main``.
     Checks: exit 0, the JAX package's save-dir tree with ``gan_gen_*``
     files, finite histories with the critic's metrics, one trunk launch per
     ``train_step``, ``validation_step`` and ``generate``; the ``_best``
     file's output bit-equal to ``generate``; on the stage's first GAN
     step from the flagship, over 3 batches, the step through
     ``TrunkFunction`` (one trunk launch) against the same step with the
     plain trunk in autograd: the trunk's output, sr and the losses at
     phase 7's bounds; the trunk's output and the generator's gradients
     given one gradient at sr no further from a trunk summed in float64
     than the plain trunk's (the step's own gradients' distances and the
     per-tensor differences printed); the wiring of
     ``TrunkFunction``'s gradients against the plain trunk given the
     kernel's forward values (bounds argued at GAN_RATIO_BATCHES and
     GAN_WIRING_TOL); the critic's running statistics after one step equal
     to a copy's after the same two training-mode calls (the generator
     branch moves them no further); ``--resume`` with
     3 epochs continues at epoch 3. Printed: the step's time (CUDA-event
     median of 20) and its parts (generator forward, critic forwards, the
     VGG loss's forward, the other losses, the gradient passes, the two
     optimizers), HR MPix/s, epoch seconds, peak memory;
 10. ESRGAN from its YAML file (examples/training/esrgan_x4.yaml): 16 RRDB
     blocks x 64 filters, 3 dense blocks x 4 convs, batch 16 of 128 x 128,
     EMA 0.999, L1 1e-2 + relativistic adversarial 5e-3 + VGG54
     pre-activation, the relativistic critic at 128 x 128, Adam on the
     recipe's schedules, with phase 9's cuts. Checks as phase 9's run (no
     kernel launch: RRDB runs cuDNN convolutions, as the JAX package runs
     it outside Pallas); then its ``_best`` and ``_best_ema`` files through
     ``tools.upscale.upscale_files``, each untiled on a gallery PNG (no
     launch), and ``_best_ema``, the file ESRGAN serves, tiled on phase 3's
     1100 x 1040 LR PNG (one patch-kernel launch, counted); both files
     finite, the EMA one different; the card against
     the CPU on a 32 x 40 crop (max abs and the mean against the float32
     model, bounds at RRDB_ROUTE_MAX_ABS_TOL). Printed as phase 9's.
     The ``torch.profiler`` traces of phases 7 to 10 run last, in order.
 11. the serving surface on the flagship, each path with the launch counts
     set to 0 just before and read just after: ``upscale_files`` with
     ``fast=True`` (the polyphase tail, now the default) untiled and tiled
     (trunk 1 / 11, patches 0 / 1), both forms' outputs against each other
     at POLY_*_TOL, the tiled route's time in both forms (CUDA-event medians
     of 20, in turns) and the two tails' stages on one batch of 8 tiles;
     the x8 self-ensemble on a gallery crop and on the tiled route (2 trunk
     launches per predictor call), against the mean of its 8 dihedral
     outputs one by one; the paired trunk (``paired=2``, 128 wide, no trunk
     launch) on 8 tiles of 192 and tiled, against the unpaired form, and
     RRDB's paired and polyphase ("up") forms of RRDB_SERVED on the card
     against the CPU; the socket daemon (``tools.serve.serve``, warm
     shapes) with one ``SRClient`` session of 8 gallery PNGs, a JPEG body
     and a garbage body (each output within a level of ``upscale_files``,
     status 1 for both bad bodies, the session going on), then requests/s
     and p50 / p99 latency at 1, 4 and 8 clients on 128 x 128 PNGs, from a
     load generator in a process of its own, LOAD_REQUESTS requests at each
     level; the
     HTTP gateway (200 with the daemon's bytes, 400, ``/healthz``);
     ``tools.run_example`` on an ``inference`` YAML (4 gallery PNGs and
     phase 3's LR PNG: one patch launch, one trunk launch per model call)
     and an ``evaluation`` YAML of the flagship (its default serving form
     runs; PSNR / SSIM against the training form's); ``zoo.load`` of the
     name ``srresnet_x4``, resolved to ZOO_SRRESNET_X4, and the
     network interpolation of INTERP_PAIR at alpha 0.5 served, alpha 0
     bit-equal to the PSNR file. Each cut is printed in ``reduced``.
 12. the training surface: (a) the production generator at full width (16
     blocks, 64 filters, BN-free, bf16, batch 16 of 96 x 96 gallery crops)
     in the paired mode (``paired_ways=2``), which trains the standard
     layout through the trunk kernel: a batch of 15 trimmed to 14 (one
     launch), a batch of 1 skipped (none); ``train_step`` (10 warm-up, 20
     timed, CUDA events) with each step's trunk launches (30 in 30 steps),
     peak memory, and a ``torch.profiler`` trace of 3 steps, run last;
     (b) the production recipe as written (``paired_train: 2``) under
     ``tools.supervise`` with the gallery, 2 epochs, seed 0 and a temporary
     results directory, its first child SIGKILLed once epoch 1's resume
     point exists: restarted with ``--resume``, exit 0, one run directory,
     ``completed_epochs == 2``, its ``_best`` file served on a gallery crop
     (one trunk launch); (c) the distillation recipe for 1 epoch with the
     gallery, seed 0 and the 8 RRDB x 64 teacher RRDB_SERVED in place of
     the one the chip copy leaves out: finite distillation terms in the
     training and validation histories, a frozen teacher, one trunk launch
     per student call, and the step against the same step without the
     teacher (alternating, medians of 20); (d) the native loader, which the
     phase names as ported (phase 14 checks it).
 13. the parallel layer (``simplesr_tpu_torch.parallel``). The card is one:
     NCCL refuses two ranks on one device, so two rank processes
     (``chip_smoke.py --parallel-rank ...``, started by the phase, waited
     for with a timeout, killed on failure) share cuda:0 over gloo, the
     port's collectives staging CUDA tensors through host memory. Which form
     runs at 2 ranks and which at 1 is fixed in PARALLEL_FORMS and printed.
     (a) which c10d operations gloo itself takes with CUDA tensors, each
     in two processes of its own (gloo can abort a process handed device
     memory); (b) data
     parallel on the production generator (x4, 16 x 64, BN-free, bf16,
     float32 parameters), a global batch of 16 gallery crops of 96 x 96, 8 a
     rank: 3 SGD steps against one process (PARALLEL_UPDATE_REL_TOL), one
     trunk launch a rank a step, then 10 Adam steps with finite falling
     losses; FSDP's 3 SGD steps against DP's, its state sharded and no
     packed trunk copy kept; (c) examples/training/rrdb_deep_scaled_x4.yaml
     (23 RRDB blocks x 64, remat, EMA, accumulation, data_parallel and fsdp)
     through ``tools.train.main`` at world size 1, cut to the gallery, 1
     epoch, 1 crop an image and seed 0 (printed in ``reduced``): exit 0, the
     fsdp warning, replicated state; (d) the flagship on phase 3's 1100 x
     1040 LR image in row strips over 2 ranks (one trunk launch a rank)
     against the whole-image forward (PARALLEL_SPATIAL_REL_TOL); (e) tensor
     and pipeline parallelism over 2 ranks: PP's forward against the
     kernel's (ROUTE_*), TP's against float64 sums as the model's ResBlock
     route on the card is (PARALLEL_TP_FLOAT64_RATIO), and one SGD step of
     each against one process's
     (PARALLEL_MP_UPDATE_REL_TOL), PP with two trunk launches a rank (one a
     microbatch), TP none (its split convs are PyTorch's); (f) SREngine over
     a one-device mesh, bit-equal to no mesh on 4 requests (the same call,
     a check of the wiring), over a mesh of two cuda:0 entries (each
     request padded to 2 and split across the replicas on the card) within
     ENGINE_MAX_ABS_TOL of no mesh, and ``--mesh-dp 2`` refused with the
     device count. Every rank's launch counts join the
     kernels line. Timings at 2 ranks on one card are printed, labelled, and
     no speed figure.
 14. image input: the port's host loader (``csrc/host/loader.cpp``: its own
     PNG and JPEG decoders, a thread pool and an LRU cache; no CUDA). (a) its
     build with g++ and zlib into a directory of its own, timed, with the
     compiler's version; (b) the 16 gallery PNGs through ``NativeLoader``
     bit-equal to the plain Python decoder (``data/png.py``), each one's
     decode time (median of DECODE_RUNS) and MPix/s beside Python's; every
     committed PNG and JPEG fixture (data/corpus/image_modes, the gallery's
     JPEG copy) equal to its manifest's SHA-256 of PIL's decode, in both
     16-bit-grey modes; (c) the gallery's JPEG copy decoded with one thread
     and through the pool (MPix/s), ``load_crops`` equal to slices of
     ``load_image_u8``, a truncated copy refused; (d) the production recipe,
     cut as in phase 8, 1 epoch on data/corpus/gallery_jpeg through the
     native loader: exit 0, a finite loss, a trunk launch a step at least,
     its pipeline wait share beside phase 8's; (e) the daemon and the
     gateway each answer SERVE_JPEGS gallery JPEG bodies bit-equal to
     ``upscale_files`` of the same file (one trunk launch each), and refuse
     a malformed JPEG (status 1, HTTP 400). The loader is no TPU kernel, so
     its numbers stay out of the kernels line.
 15. the Keras exporter (``tools/export_keras.py`` over the port's own HDF5
     writer, ``train/_hdf5_write.py``; a GPU machine without h5py or
     TensorFlow has no other reader or writer of the format): (a) the
     flagship and RRDB_SERVED written as legacy-Keras ``.h5`` files, each
     export's seconds and file size; (b) each file read back through the
     port's ``tools/import_keras.py``, every array bit-equal to the source
     model file's and the config the same; (c) the re-imported flagship
     through ``upscale_files`` on the gallery PNG and on phase 3's LR PNG,
     bit-equal to the flagship's output, with phase 4's launch counts (one
     trunk launch untiled); (d) a wide-growth RRDB refused with
     ``ValueError``, no file written.
 16. the quality tooling (``tools/{quality_campaign,quality_check,gan_smoke,
     standard_benchmarks}.py``), each path with the launch counts set to 0
     just before and read just after: (a) the flagship and the quality_r5
     SRResNet x4 re-scored through the campaign's ``evaluate`` on the four
     held-out gallery tiles (gt_1, gt_10, gt_13, gt_6), each campaign's LP
     extractor its own srresnet, every PSNR, PSNR-Y, SSIM and LP of model and
     bicubic against its row of the campaign's RESULTS.json (the JAX
     package's TPU campaigns) within RESCORE_*_TOL; (b) the quality gate,
     ``quality_check.main(GATE_STEPS, 2)``: SRResNet x2 (16 x 64, BN-free,
     bf16) from scratch on the 12 training gallery tiles through the trunk
     kernel, its PSNR gap to bicubic on the train member gt_11 and on the
     mean of the four held-out tiles no more than GATE_PARITY_TOL below the
     JAX package's run of the same recipe on the same pairs
     (JAX_GATE_GAPS, from quality_gate_reference.py), whether it beats
     bicubic printed beside it; (c) ``gan_smoke.main(GAN_SMOKE_STEPS)`` prints
     GAN_STABLE (a BatchNorm generator: no trunk launch, checked); (d)
     ``standard_benchmarks`` on a stand-in Set5 in a temporary
     ``$SIMPLESR_BENCHMARK_DATA`` (gt_1, gt_10, gt_13 as PNG, gt_6 as the
     committed BMP, bit-equal to its PNG) with the tile threshold lowered to
     STANDIN_TILE_THRESHOLD (gt_1 tiles: a patch launch), its per-image
     scores against the untiled route's within STANDIN_*_TOL, and its
     scores beside the Set5 anchors, labelled a stand-in.
 17. the denoising path, each path with the launch counts set to 0 just
     before and read just after: (a) the port's JPEG encoder
     (``csrc/host/jpeg_encode.cpp`` in the host loader's library) writes
     every committed fixture of data/corpus/jpeg_encode byte for byte (its
     manifest's SHA-256 of PIL's file), and its MPix/s on one thread and the
     decoder's on the same file; (b) the three committed denoising models
     (round 4's noise-trained model and its clean control, round 3's
     fixed-quality model; SRResNet x2, 16 x 64, BN-free, bf16, through the
     trunk kernel) scored through ``tools/jpg_noise_campaign.evaluate`` on
     the four held-out gallery tiles, clean and at real-JPEG qualities 30,
     50, 75 and 90 (the port's encoder and decoder, PIL's bytes), every
     PSNR, PSNR-Y and SSIM within RESCORE_*_TOL of the JAX package's rows
     (JAX_JPG_ROWS, from jpg_noise_reference.py); (c) ``domain_gap`` on the
     card: the DCT degrade's input PSNR against real JPEG per tile and
     quality within DOMAIN_GAP_TOL of the JAX package's (JAX_JPG_GAP), the
     model's outputs on each within RESCORE_PSNR_TOL; (d)
     examples/training/srresnet_denoise_x2.yaml through ``tools.train.main``
     (the DCT degrade on the device), cut to the gallery PNGs, 1 epoch,
     seed 0 and a temporary results directory (printed in ``reduced``),
     once with the file's ``jpg_noise_level: 50`` and once with the range
     ``[5, 70]``: exit 0, a finite loss, a trunk launch a step at least, a
     degrade a batch at the fixed quality 50 or at qualities spread over
     [30, 95); printed: the step's ms end to end, the pipeline's wait share
     and the degrade's device ms a batch (CUDA events); (e)
     ``jpg_noise_campaign.main(fast=True)`` with ``FAST_SIZE = {}``: the
     campaign's --fast schedule at full width (16 x 64) on 4 training
     tiles into a temporary directory, its RESULTS_jpg.json read back by the port's
     ``zoo``; (f) ``tools/ensemble_study`` over its five committed models on
     the held-out tiles with the cost line (plain against x8, CUDA events,
     batch 8 of 128 x 128 LR), each plain PSNR within NEAR_BICUBIC_DB of
     bicubic's or above (but for PRE_TRUNK_FIX_MODELS), and each model's
     rows on ENSEMBLE_CROP within RESCORE_*_TOL of the JAX package's
     (JAX_ENSEMBLE_ROWS, from ensemble_reference.py); and
     ``tools/ema_study`` for 1 epoch on the same 4 training tiles. A
     missing committed model fails the phase;
 18. the image formats the JAX package opens through PIL beside PNG and
     JPEG, and the JPEG processes beside baseline: (a) every fixture of
     data/corpus/image_formats (WebP, GIF, TIFF with its JPEG-compressed,
     YCbCr, CMYK, CIELab, 32-bit, float and BigTIFF variants, netpbm, RLE BMP, and
     arithmetic-coded, lossless and block-smoothed JPEG) decodes on the
     card's host to its manifest's digest of PIL's decode, each refused
     variant refused naming it, and each decoder's one-thread MPix/s on the
     same 96 x 128 gallery tile (median of DECODE_RUNS), beside the PNG and
     JPEG decoders' on that tile (the port's encoders write them) and a
     baseline JPEG that PIL wrote; (b) the daemon and the gateway serve the
     tile as lossy and lossless WebP, GIF, LZW TIFF, PPM, RLE8 BMP,
     arithmetic-coded JPEG, lossless JPEG and JPEG-compressed TIFF bodies,
     each with the launch counts set to 0 just before and read just after:
     every reply bit-equal to ``upscale_files`` of the same file, one trunk
     launch a body; (c) a truncated WebP body gets status 1 and HTTP 400,
     naming WebP. Slice 15 adds the texture and icon formats: (a) every
     fixture of data/corpus/texture_formats (DDS with its BC1-BC7 blocks,
     TGA, ICO, CUR, QOI, PCX, DCX, SGI) against its manifest's digest, the
     refusals named, and each format's one-thread MPix/s on its 96 x 128
     timing tile; (b) the tile as a BC7 DDS, an RLE TGA and an ICO with a
     PNG frame, served as above; (d) a 1024 x 1024 BC1 DDS made here from
     a seed (a header over blocks whose end colours follow a seeded coarse
     field) through ``upscale_files``: over the 1000-pixel threshold, it
     takes the tiled route (one patch launch), and away from the seams
     and edges where the flagship's receptive field passes the route's
     overlap (LARGE_*_BAND) it equals the untiled upscale of the same
     decoded array within ROUTE_*_TOL; the bands' differences are
     printed. Slice 17 adds animated WebP (the first frame on its canvas),
     PSD (the merged image) and DIB: (a) every fixture of
     data/corpus/psd_dib_anim against its manifest's digest, PSB, 16-bit
     and ZIP-compressed PSDs refused by name, and one-thread MPix/s on the
     96 x 128 tile as an animated WebP, PackBits RGB, raw CMYK and
     PackBits Lab PSDs and a DIB; (b) the animated WebP, the PackBits RGB
     PSD and the DIB served as above;
 19. the measurement and study tools (``simplesr_tpu_torch/tools``) at cut
     sizes, each with the launch counts set to 0 just before and read just
     after: ``bench_trunk_kernel`` (kernel, cuDNN and plain trunk at batch 4
     x 64^2, 16 blocks), the SRResNet and RRDB tail forms of
     ``bench_upsample_tail`` and ``bench_rrdb_tail`` (each held to the
     model's own tail on the card within POLY_*_TOL, then timed at batch 2
     x 64^2), ``remat_study`` (SRResNet 16 with BatchNorm and RRDB 8 at
     batch 4 x 96^2: remat must lower the step's peak memory and the bytes
     saved for the backward; untimed), ``train_roofline --fast``,
     ``bf16_grad_study`` (3 timed steps, a 1-epoch x2 run on 64 crops),
     ``host_assembly_profile`` (8 crops a tile) and ``bench_serve`` on the
     flagship (1 s a stage, 4 engine clients, 2 daemon clients, 64 x 64
     requests, batches of up to 4; no request may fail); every row
     finite and with its keys, and the tools whose path runs the trunk
     kernel launched it.

Torch's global TF32 flags are left as they are: the model sets the precision
of its one float32 conv itself (``core.dtypes.OUTPUT_CONV_TF32``).
Prints one JSON object per phase, then the host loader's line (phase 14's
and phase 18's summaries; they are no TPU kernels), the kernels' JSON line, and last
``{"ok": true, "device": {...}}``. Any failure prints its traceback and exits
non-zero without that line; without a CUDA device it exits 2 at once.
"""

import contextlib
import copy
import faulthandler
import json
import logging
import os
import signal
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from simplesr_tpu_torch.tools import bench_serve
from simplesr_tpu_torch.tools.bench_timing import (PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, TIMING_RUNS,
                                                   alternating_ms, cuda_ms, graph_ms)
from simplesr_tpu_torch.tools.bench_trunk_kernel import library_trunk, library_trunk_weights
from simplesr_tpu_torch.tools.bench_upsample_tail import tail_stage_ms

ROOT = Path(__file__).resolve().parent
FLAGSHIP = ROOT / "results/quality_fastrecipe/models/resnet_gen_srresnet_x4_best.msgpack"
GALLERY_PNG = ROOT / "data/corpus/gallery/gt_3.png"
TILED_HW = (1100, 1040)   # an LR image over the 1000 x 1000 tiling threshold
TRUNK_SHAPE = (8, 192, 192)  # the trunk's input on the tiled route: batch 8 of 128 + 2 * 32 px
# Shapes for the trunk kernel's persistent loop and edges (tiles of 4 x 64 px,
# one CTA per SM, 3 stages): 1 tile; ragged rows and columns; 3,315 tiles.
TRUNK_EDGE_SHAPES = ((1, 1, 1), (2, 13, 37), (3, 200, 260))
CROP_HW = (96, 128)       # the engine's second request shape
SEED = 0
WATCHDOG_S = 1100

# Trunk kernel vs plain version, max |diff| / max |plain|, each residual block
# on the same input: bf16 storage, f32 sums in another order.
TRUNK_REL_TOL = 1e-2
# The 16-block chain is not held to that bound: a rounding to bf16 that flips
# in one block spreads through the later ones, so any two f32 summation orders
# part by about 1.1e-2 after 16 blocks (the plain version with float64 sums
# does too). The chain is held to be as accurate as the plain version, against
# float64 sums, up to this factor on the relative Frobenius error:
TRUNK_CHAIN_FRO_RATIO = 1.5
# Phase 7: the production recipe (examples/training/srresnet_x4_paired_production.yaml)
# at its batch of 16 crops of 96 x 96. Its paired_train: 2 trains this same
# forward in the port (phase 12 (a) runs it).
TRAIN_BATCH = 16
TRAIN_HR = 96
TRAIN_STEPS = 30
TRAIN_SCHEDULE = {"piecewise_constant_decay": {"boundaries": [100000], "values": [1e-4, 1e-5]}}
# Gradients through TrunkFunction (kernel forward) vs autograd straight
# through the plain trunk, per parameter tensor, relative Frobenius error.
# Both backwards are the same recomputed plain version; they differ only
# through the forward, where kernel and plain version round the 32 bf16
# activations apart (phase 2: per block max rel ~5e-3, the 16-block chain
# ~9e-3 in Frobenius norm). That difference reaches every gradient through
# the tail and the trunk's incoming gradient, so 3e-2 is about 3x the chain's.
TRAIN_GRAD_FRO_TOL = 3e-2
# The loss is a mean of 442,368 squared errors: the same rounding
# differences average out; 1e-2 is far above them and far below a wrong trunk.
TRAIN_LOSS_REL_TOL = 1e-2
WIDE_FILTERS = 128  # fault check: widths other than 64 run ResBlocks on CUDA
# The 128-wide model on CUDA against the CPU: max abs under ROUTE_MAX_ABS_TOL,
# and its mean abs error against float64 sums (the same bf16 rounding points)
# at most this factor of the CPU's. Its mean abs difference from the CPU is
# printed and not gated: on this seeded model any two summation orders part
# by about 3.5e-3 after 16 blocks (float32 against float64 sums, on the CPU),
# above the 2e-3 of the route's bound.
WIDE_MEAN_RATIO = 1.5
ROUTE_MAX_ABS_TOL = 5e-2  # whole upscale on [-1, 1]: bf16 trunk differences through the tail
ROUTE_MEAN_ABS_TOL = 2e-3
ENGINE_MAX_ABS_TOL = 5e-2  # batched vs one-shot: cuDNN may pick other algorithms per batch
PNG_MAX_LEVELS = 1  # a written PNG vs the route's output, truncated to uint8
# Phase 8: the production recipe from its YAML file, cut to the gallery.
RECIPE = ROOT / "examples/training/srresnet_x4_paired_production.yaml"
YAML_EPOCHS = 2
PREEMPT_AFTER_STEPS = 55  # past the first batch scalar (every 50 steps), inside epoch 1
TB_BATCH_INTERVAL = 50  # SRModel's default, which the YAML path keeps
LOG_DIRS = ("train/batch", "train/epoch", "val/batch", "val/epoch")
PIPELINE_LR_TOL = 1e-4  # LR on [0, 1], card vs CPU: the resize's float32 sums
EXIT_PREEMPTED = 75
# The save-dir tree of the JAX package's run_training for 2 epochs, without
# the checkpoints' contents (orbax there, torch.save here), a TensorBoard
# event file under its name without the time and host
# (tests/test_torch_training_loop.py holds the two trees equal on the CPU).
JAX_RUN_TREE = {
    ".", "checkpoints", "checkpoints/resnet_resume_meta.json", "config_logfile",
    "json_dump", "json_dump/resnet_train_batch_history.json",
    "json_dump/resnet_train_epoch_history.json", "json_dump/resnet_valid_batch_history.json",
    "json_dump/resnet_valid_epoch_history.json", "log", "logs", "logs/train",
    "logs/train/batch", "logs/train/epoch", "logs/val", "logs/val/batch", "logs/val/epoch",
    "logs/train/batch/events.out.tfevents", "logs/train/epoch/events.out.tfevents",
    "logs/val/batch/events.out.tfevents", "logs/val/epoch/events.out.tfevents",
    "models", "models/resnet_gen_1.msgpack", "models/resnet_gen_2.msgpack",
    "models/resnet_gen_best.msgpack", "perf_logfile", "pics", "pics/test", "pics/train",
    "pics/train/resnet", "pics/train/resnet/00002_000.png", "pics/val", "pics/val/resnet",
    "pics/val/resnet/00002_000.png", "results_logfile"}


# Phases 9 and 10: the GAN family from its example YAML files, cut to the
# gallery, 2 epochs and seed 0 (VGG from its seeded init: no ImageNet
# weights are in the repo).
SRGAN_RECIPE = ROOT / "examples/training/srgan_x4.yaml"
ESRGAN_RECIPE = ROOT / "examples/training/esrgan_x4.yaml"
GAN_EPOCHS = 2
GAN_STEP_RUNS = 20
# Phase 9 holds the trunk kernel against the plain trunk on the SRGAN
# stage's first step from the flagship (after the two epochs of the recipe
# with random-init VGG the generator's tanh can be saturated and every
# gradient 0, measured), on GAN_RATIO_BATCHES batches, with cuDNN's
# deterministic algorithms (without them the backward-data convolutions
# differ run to run by float32 noise, which TF32's rounding of the backward
# convs' operands turns into about a percent, measured on the H100):
# - per batch, the trunk's output on the step's input and sr at phase 7's
#   TRAIN_GRAD_FRO_TOL (3x the 16-block chain's rounding difference), and
#   the two losses at TRAIN_LOSS_REL_TOL;
# - over the batches, the kernel's trunk output, and the generator's
#   gradients given one gradient at sr (the float64 trunk's), no further
#   from a trunk summed in float64 than the plain trunk's are, up to
#   TRUNK_CHAIN_FRO_RATIO (phase 2's chain bound).
# The gradients are held by that ratio and not, as in phase 7, kernel
# against plain per tensor: the GAN losses make them sensitive to rounding.
# The generator's gradient at sr is carried by VGG(sr) - VGG(hr), a
# difference of near-equal features at the pretrained flagship, and the
# critic's by its gradients at sr and at hr, nearly equal inputs: sr's
# rounding (0.09-0.3 % from float64 sums) becomes 2-22 % in the gradient at
# sr, and which trunk lands nearer float64 is chance (one batch read the
# kernel's generator gradients 3.2x further from float64 than the plain
# trunk's, and 1.01x given one gradient at sr). Even given one gradient at
# sr, a weight's gradient sums that oscillating field against the
# activations, so the forward's rounding moves it by up to 8 %: the kernel
# against the plain trunk read 8.4e-2 on upsample.0.conv.weight, the plain
# trunk against float64 sums 8 % over all (measured on the H100; PERF.md §7).
# The per-tensor and own-gradient distances are printed.
GAN_RATIO_BATCHES = 3
GAN_RATIO_GATED = ("trunk", "G_same_grad_at_sr")
# The wiring: TrunkFunction against the plain trunk under autograd given the
# kernel's forward values exactly (kernel + (plain - plain)), in one step.
# TrunkFunction's backward is that plain trunk's, so the two routes compute
# the same arithmetic (sr bit-equal); a gradient missing, of another tensor
# or scaled differs by order 1. Held per generator tensor and over all the
# critic's gradients.
GAN_WIRING_TOL = 1e-5
# The critic's running statistics after one train step against a copy of
# the critic given the same SR and HR batches in training mode: the same
# convolutions on the same inputs, up to cuDNN's choice of algorithm.
D_STATS_REL_TOL = 1e-3
# The ESRGAN model file on the card against the CPU on a 32 x 40 gallery
# crop: max abs on [-1, 1], two summation orders of one bf16 model through
# 16 RRDB blocks (240 convs). The port and flax, two such orders on the CPU,
# part by 9.8e-5 on this crop for the recipe's generator at its seeded init
# (tests/test_torch_rrdb.py holds them to this bound); and the card's mean
# abs error against the model in float32 at most this factor of the CPU's.
RRDB_ROUTE_MAX_ABS_TOL = 5e-4
RRDB_MEAN_RATIO = 1.5


def log(phase, **result):
    print(json.dumps({"phase": phase, **result}), flush=True)


_T0 = time.perf_counter()


def start(phase):
    print(f"--- phase {phase} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


@contextlib.contextmanager
def plain_kernels():
    """Run the serving route with the kernels' plain versions in place of the
    kernels, on the same device."""
    from simplesr_tpu_torch.ops import tiling
    from simplesr_tpu_torch.ops.kernels import (extract_overlapping_patches_reference,
                                                residual_trunk_reference, trunk)

    saved = trunk.residual_trunk, tiling.extract_overlapping_patches
    trunk.residual_trunk = residual_trunk_reference  # what TrunkFunction's forward runs
    tiling.extract_overlapping_patches = extract_overlapping_patches_reference
    try:
        yield
    finally:
        trunk.residual_trunk, tiling.extract_overlapping_patches = saved


def trunk_float64(x, weights):
    """The plain trunk with float64 sums, so that each rounding to bf16 is of
    the exact value."""
    from simplesr_tpu_torch.ops.kernels.trunk import _oihw

    h = x.permute(0, 3, 1, 2)
    for blk in range(weights.weight.shape[0]):
        w1, w2 = (_oihw(weights.weight[blk, j]).double() for j in (0, 1))
        t = F.conv2d(h.double(), w1, weights.b1[blk].double(), padding=1)
        alpha = weights.alpha[blk].double().view(1, -1, 1, 1)
        y = torch.where(t >= 0, t, alpha * t).to(torch.bfloat16)
        t = F.conv2d(y.double(), w2, weights.b2[blk].double(), padding=1)
        h = (h.double() + t).to(torch.bfloat16)
    return h.permute(0, 2, 3, 1)


def float64_sums(model, x):
    """``model`` (on the CPU) on ``x`` with every bf16 conv summed in float64
    and rounded to bf16 where the model rounds."""
    from simplesr_tpu_torch.models import blocks

    def conv2d(h, weight, bias, dtype, stride=1):
        (top, bottom), (left, right) = (blocks.same_padding(n, weight.shape[-1], stride)
                                        for n in h.shape[-2:])
        y = F.conv2d(F.pad(h.to(dtype).double(), (left, right, top, bottom)),
                     weight.to(dtype).double(), stride=stride).to(dtype)
        return y + bias.to(dtype).view(1, -1, 1, 1)

    saved, blocks.conv2d = blocks.conv2d, conv2d
    try:
        return model(x)
    finally:
        blocks.conv2d = saved


def rel_errors(got, ref):
    """max |diff| / max |ref| and ||diff|| / ||ref||, in float32."""
    got, ref = got.float(), ref.float()
    diff = got - ref
    return ((diff.abs().max() / ref.abs().max()).item(), (diff.norm() / ref.norm()).item(),
            diff.abs().max().item())


def stage_ms(model, lr_nhwc):
    """CUDA-event times of the forward's stages on one batch, each on the
    input the previous stage gives."""
    from simplesr_tpu_torch.models.srresnet import output_conv

    times = {}
    h = lr_nhwc.permute(0, 3, 1, 2).to(model.dtype)
    stages = [("head", lambda t: model.head_act(model.head(t))), ("trunk", model._trunk)]
    stages.append(("trunk_out+skip", lambda t: model.trunk_out(t) + skip))
    stages += [(f"upsample_{i}", block) for i, block in enumerate(model.upsample)]
    stages.append(("out_conv_f32+tanh", lambda t: torch.tanh(output_conv(t, model.out))))
    skip = None
    for name, fn in stages:
        times[name] = cuda_ms(lambda: fn(h), runs=10, warmup=2)
        h = fn(h)
        if name == "head":
            skip = h
    return times


KERNEL_KEYS = {"residual_trunk": "trunk", "extract_overlapping_patches": "patches"}


def counted(run):
    """Run ``run()`` with every kernel's launch count set to 0 just before;
    return its result and the counts just after."""
    from simplesr_tpu_torch.ops.kernels import WRAPPERS

    for wrapper in WRAPPERS:
        wrapper.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {KERNEL_KEYS[w.__name__]: w.launches for w in WRAPPERS}


def training_batches(gen, images, count):
    """``count`` batches of TRAIN_BATCH (LR, HR) pairs, made on the card: a
    random TRAIN_HR crop of each gallery image (uint8 HWC on the card), each
    flipped up-down and left-right at random and turned by 90 or 180 degrees
    at random; HR in [-1, 1], LR the port's antialiased bicubic to a quarter
    of the side, in [0, 1]."""
    from simplesr_tpu_torch.core.ranges import normalize_01, normalize_11
    from simplesr_tpu_torch.ops.augment import flip_along_x, flip_along_y, rotate90
    from simplesr_tpu_torch.ops.crop import random_crops
    from simplesr_tpu_torch.ops.resize import resize

    batches = []
    for _ in range(count):
        crops = []
        for i in range(TRAIN_BATCH):
            crop = random_crops(gen, images[i % len(images)], 1, (TRAIN_HR, TRAIN_HR))[0]
            flips = torch.randint(0, 2, (2,), generator=gen)
            crop = flip_along_x(crop) if flips[0] else crop
            crop = flip_along_y(crop) if flips[1] else crop
            crops.append(rotate90(gen, crop))
        hr = torch.stack(crops).float()
        lr = resize(normalize_01(hr), (TRAIN_HR // 4, TRAIN_HR // 4), method="bicubic",
                    antialias=True)
        batches.append((lr.contiguous(), normalize_11(hr).contiguous()))
    return batches


def events_ms(parts, runs):
    """Median ms of each of a sequence of steps, timed as consecutive CUDA
    events around each, over ``runs`` runs of the whole sequence."""
    times = {name: [] for name, _ in parts}
    for _ in range(runs):
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record()
        for _, fn in parts:
            fn()
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        marks[-1].synchronize()
        for (name, _), a, b in zip(parts, marks, marks[1:]):
            times[name].append(a.elapsed_time(b))
    return {name: statistics.median(t) for name, t in times.items()}


def profile_steps(step, steps=3, top=8):
    """A ``torch.profiler`` trace of ``steps`` calls of ``step``: the
    device's busy time per step (the sum of the kernels' self device time),
    the wall time per step, the idle share, and the kernels that took the
    most device time (ms per step)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3 / steps

    def device_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # the kernels themselves (not the operators that launched them, which
    # would count the same device time twice)
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA") and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in events) / 1e3 / steps
    events.sort(key=device_us, reverse=True)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
            "top_kernels_ms": [[e.key[:80], device_us(e) / 1e3 / steps, e.count // steps]
                               for e in events[:top]]}


def train_phase(dev, work, gen, launches_by_path, card):
    """Phase 7: the training path through SRModel (see the docstring)."""
    from simplesr_tpu_torch.data.png import read_png
    from simplesr_tpu_torch.ops.kernels import WRAPPERS, residual_trunk, residual_trunk_reference
    from simplesr_tpu_torch.ops.kernels.trunk import pack_trunk_weights
    from simplesr_tpu_torch.train import Generator, SRModel, load_model

    start("7 training: SRModel, production recipe at full width")
    print("reduced: paired_train: 2 of the recipe -> not set here; the port trains it on "
          "this same forward, and phase 12 (a) runs it", flush=True)
    images = [torch.from_numpy(read_png(p)).to(dev)
              for p in sorted((ROOT / "data/corpus/gallery").glob("*.png"))]
    batches = training_batches(gen, images, 2 * TRAIN_STEPS + 1)

    class Dirs:
        model_dir = str(work / "train" / "models")
        checkpoint_dir = str(work / "train" / "checkpoints")

    generator = Generator.srresnet(4, num_blocks=16, num_filters=64, batch_norm=False,
                                   dtype="bfloat16", seed=SEED, device=dev)
    model = SRModel("resnet", generator, "Adam", {"learning_rate": TRAIN_SCHEDULE},
                    config=Dirs, device=dev)
    module = generator.model()
    params = list(module.parameters())

    def grads(lr, hr):
        module.train()
        loss, _ = generator.calculate_loss(module(lr).float(), hr, None, None)
        return loss, torch.autograd.grad(loss, params)

    # check 1: gradients through the kernel's forward vs straight through the plain trunk
    lr, hr = batches[-1]
    (loss_k, grads_k), counts_fwd_bwd = counted(lambda: grads(lr, hr))
    module._trunk = lambda h: residual_trunk_reference(
        h.permute(0, 2, 3, 1), pack_trunk_weights(module._block_parameters())).permute(0, 3, 1, 2)
    try:
        loss_p, grads_p = grads(lr, hr)
    finally:
        del module._trunk
    names = [n for n, _ in module.named_parameters()]
    grad_fro = {n: ((a - b).norm() / b.norm()).item() for n, a, b in zip(names, grads_k, grads_p)}
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    worst = max(grad_fro, key=grad_fro.get)
    log(7, check="gradients, TrunkFunction vs plain trunk in autograd", loss_rel=loss_rel,
        loss_rel_tol=TRAIN_LOSS_REL_TOL, max_grad_fro_rel=grad_fro[worst], worst=worst,
        trunk_grad_fro_rel_max=max(v for n, v in grad_fro.items() if n.startswith("blocks")),
        grad_fro_tol=TRAIN_GRAD_FRO_TOL, launches_forward_and_backward=counts_fwd_bwd)
    if not (loss_rel < TRAIN_LOSS_REL_TOL and grad_fro[worst] < TRAIN_GRAD_FRO_TOL):
        raise AssertionError(f"gradients through the trunk kernel disagree: loss {loss_rel}, "
                             f"{worst} {grad_fro[worst]}")
    if counts_fwd_bwd["trunk"] != 1:
        raise AssertionError(f"one forward and backward launched {counts_fwd_bwd}")

    # check 2 and 3: 30 steps through the lifecycle, one launch per step
    def train():
        model.before_epoch()
        per_step = []
        for lr, hr in batches[:TRAIN_STEPS]:
            before = residual_trunk.launches
            model.train_step(lr, hr)
            per_step.append(residual_trunk.launches - before)
            model.after_train_batch()
        return per_step

    per_step, train_counts = counted(train)
    launches_by_path["sr_model_train_step_x30"] = train_counts
    _, valid_counts = counted(lambda: (model.validation_step(*batches[-1]),
                                       model.after_validation_batch()))
    launches_by_path["sr_model_validation_step"] = valid_counts
    losses = [float(v) for v in model.histories()["train_batch"]["generator_loss"]]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(7, check="30 train steps", losses=losses, first5=first, last5=last,
        launches_per_step=sorted(set(per_step)), train_launches=train_counts,
        validation_launches=valid_counts, optimizer_count=model.optimizer.count)
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"training did not bring the loss down: {first} -> {last}")
    if per_step != [1] * TRAIN_STEPS or train_counts != {"trunk": TRAIN_STEPS, "patches": 0}:
        raise AssertionError(f"train_step launches {per_step}, {train_counts}")
    if valid_counts != {"trunk": 1, "patches": 0}:
        raise AssertionError(f"validation_step launches {valid_counts}")

    # check 4: generate vs the saved model file, bit for bit
    model.after_epoch()
    model.after_training()
    best = Path(Dirs.model_dir) / "resnet_gen_best.msgpack"
    x = batches[-1][0][:4]
    got = model.generate(x)
    with torch.inference_mode():
        ref = load_model(best, device=dev)(x)
    if not torch.equal(got, ref):
        raise AssertionError(f"generate vs the saved file: {(got - ref).abs().max().item()}")

    # check 5: the flagship with grad enabled equals inference_mode
    flagship = load_model(FLAGSHIP, device=dev)
    x = torch.rand((2, 40, 48, 3), generator=gen).to(dev)
    with_grad, grad_counts = counted(lambda: flagship(x))
    with torch.inference_mode():
        no_grad = flagship(x)
    if not (with_grad.requires_grad and torch.equal(with_grad.detach(), no_grad)
            and grad_counts["trunk"] == 1):
        raise AssertionError(f"flagship with grad enabled vs inference_mode: {grad_counts}")

    # check 6: a 128-wide model on CUDA runs its ResBlocks and matches the CPU
    wide_cpu = Generator.srresnet(4, num_blocks=16, num_filters=WIDE_FILTERS, batch_norm=False,
                                  dtype="bfloat16", seed=SEED, device="cpu").model()
    with torch.no_grad():
        for block in wide_cpu.blocks:
            block.act.alpha.uniform_(0.0, 0.3, generator=gen)
    wide_gpu = copy.deepcopy(wide_cpu).to(dev)
    x = torch.rand((1, 32, 32, 3), generator=gen)
    with torch.inference_mode():
        wide_out, wide_counts = counted(lambda: wide_gpu(x.to(dev)))
        wide_out, wide_ref = wide_out.cpu(), wide_cpu(x)
        exact = float64_sums(wide_cpu, x)
    wide = {"max_abs": (wide_out - wide_ref).abs().max().item(),
            "mean_abs": (wide_out - wide_ref).abs().mean().item(),
            "cuda_vs_float64_mean_abs": (wide_out - exact).abs().mean().item(),
            "cpu_vs_float64_mean_abs": (wide_ref - exact).abs().mean().item(),
            "launches": wide_counts}
    log(7, check="faults", generate_vs_saved_file_bit_equal=True,
        flagship_grad_vs_inference_mode_bit_equal=True, wide_128_cuda_vs_cpu=wide,
        tol_max_abs=ROUTE_MAX_ABS_TOL, mean_vs_float64_ratio_tol=WIDE_MEAN_RATIO)
    if not (wide["max_abs"] < ROUTE_MAX_ABS_TOL
            and wide["cuda_vs_float64_mean_abs"]
            <= WIDE_MEAN_RATIO * wide["cpu_vs_float64_mean_abs"]
            and wide_counts == {"trunk": 0, "patches": 0}):
        raise AssertionError(f"128-wide model on CUDA vs CPU: {wide}")

    # timings, printed and not gated
    timed = batches[TRAIN_STEPS:2 * TRAIN_STEPS]

    def step_times(label):
        it = iter(timed * 2)  # 3 warm-up steps and TRAIN_STEPS timed ones
        for _ in range(3):
            model.train_step(*next(it))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: model.train_step(*next(it)), runs=TRAIN_STEPS, warmup=0)
        return {f"{label}_step_ms": ms, f"{label}_hr_mpix_per_s":
                TRAIN_BATCH * TRAIN_HR ** 2 / 1e6 / (ms / 1e3),
                f"{label}_peak_mem_bytes": torch.cuda.max_memory_allocated()}

    result = step_times("trunk_function")
    state = {}  # the loss and gradients handed from one timed part to the next

    def forward():
        module.train()
        lr, hr = timed[0]
        state["loss"], _ = generator.calculate_loss(module(lr).float(), hr, None, None)

    def backward():
        before = residual_trunk.launches
        state["grads"] = torch.autograd.grad(state["loss"], params)
        state["backward_launches"] = residual_trunk.launches - before

    parts = events_ms([("forward", forward), ("backward", backward),
                       ("optimizer", lambda: model.optimizer.apply(params, state["grads"]))],
                      runs=10)
    if state["backward_launches"] != 0:
        raise AssertionError(f"the backward launched {state['backward_launches']} trunks")
    module.uses_trunk_kernel = False  # its ResBlocks: cuDNN bf16 convs, activations stored
    try:
        result.update(step_times("plain_autograd"))
    finally:
        module.uses_trunk_kernel = True
    log(7, **result, trunk_function_parts_ms=parts, backward_trunk_launches=0,
        batch=[TRAIN_BATCH, TRAIN_HR, TRAIN_HR, 3], runs=TRAIN_STEPS, card=card)

    def profile():
        """The profiler, run after every timing of the script: its hooks
        slow the launches that follow it."""
        traces = {}
        for label, kernel in (("trunk_function", True), ("plain_autograd", False)):
            module.uses_trunk_kernel = kernel
            try:
                it = iter(timed)
                traces[label] = profile_steps(lambda: model.train_step(*next(it)))
            finally:
                module.uses_trunk_kernel = True
        log(7, profiler_3_steps=traces, card=card)

    return profile


@contextlib.contextmanager
def patched(owner, name, make):
    """``owner.name`` replaced by ``make(original)`` inside the block."""
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def run_tree(root):
    """A run's relative paths, as JAX_RUN_TREE lists them."""
    out = set()
    for dirpath, _, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        if rel.startswith("checkpoints" + os.sep):
            continue
        out.add(rel)
        out.update(os.path.normpath(os.path.join(
            rel, "events.out.tfevents" if "tfevents" in f else f)) for f in filenames)
    return out


def run_scalars(save_path):
    """The run's TensorBoard scalars by log directory, as ``read_scalars``
    reads each directory's event files (oldest first), and the count of
    event files in each."""
    from simplesr_tpu_torch.utils.tensorboard import event_files, read_scalars

    logs = Path(save_path) / "logs"
    return ({d: read_scalars(logs / d) for d in LOG_DIRS},
            {d: len(event_files(logs / d)) for d in LOG_DIRS})


def scalar_steps(scalars):
    """{tag: sorted steps} of one log directory's scalars."""
    return {tag: sorted(step for step, _ in values) for tag, values in scalars.items()}


def check_scalar_steps(label, scalars, epochs, iterations):
    """Each epoch tag at steps 1..epochs and each train batch tag at every
    TB_BATCH_INTERVAL-th step up to ``iterations``, each once, across the
    run's event files: no gap and no repeat."""
    want = {"train/epoch": list(range(1, epochs + 1)), "val/epoch": list(range(1, epochs + 1)),
            "train/batch": list(range(TB_BATCH_INTERVAL, iterations + 1, TB_BATCH_INTERVAL))}
    got = {d: scalar_steps(scalars[d]) for d in want}
    bad = {d: steps for d, steps in got.items()
           if not steps or any(v != want[d] for v in steps.values())}
    if bad:
        raise AssertionError(f"{label}: TensorBoard steps {bad}, expected {want}")


def run_instruments():
    """Wrappers for a run of ``tools.train.main`` in this process: counts of
    ``SRModel``'s train_step, validation_step and generate, each epoch's
    host clock (from ``before_epoch`` to ``after_epoch``, synchronised),
    the pipeline's waits, and the run's config, pipeline and model. Returns
    (calls, seen, epochs, waits, instrumented), where ``instrumented(run)``
    calls ``run()`` with the wrappers in place."""
    import simplesr_tpu_torch.train as train_pkg
    from simplesr_tpu_torch.data import DataPipeline
    from simplesr_tpu_torch.train import SRModel

    calls = {"train_step": 0, "validation_step": 0, "generate": 0}
    seen = {}  # the run's objects and timings, filled by the wrappers
    epochs = []  # (start, end) of each epoch on the host clock
    waits = []  # (start, seconds) of each call into the pipeline's generators

    def counting(name):
        def make(original):
            def wrapper(self, *a, **k):
                calls[name] += 1
                return original(self, *a, **k)
            return wrapper
        return make

    def timed_generator(original):
        def wrapper(self, *a, **k):
            it = iter(original(self, *a, **k))

            def gen():
                while True:
                    t = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        waits.append((t, time.perf_counter() - t))
                        return
                    waits.append((t, time.perf_counter() - t))
                    yield item
            return gen()
        return wrapper

    def capture_run(original):
        def wrapper(conf, pipeline, sr_model, **k):
            seen.update(conf=conf, pipeline=pipeline, model=sr_model)
            return original(conf, pipeline, sr_model, **k)
        return wrapper

    def epoch_clock(which):
        def make(original):
            def wrapper(self, *a, **k):
                if which == "before":
                    epochs.append([time.perf_counter(), None])
                    return original(self, *a, **k)
                torch.cuda.synchronize()
                epochs[-1][1] = time.perf_counter()
                return original(self, *a, **k)
            return wrapper
        return make

    def resume_capture(original):
        def wrapper(self):
            seen["resumed_at"] = original(self)
            seen["resumed_histories"] = copy.deepcopy(self.histories()["train_epoch"])
            seen["resumed_early_stop"] = self._early_stopping_util.state_dict()
            return seen["resumed_at"]
        return wrapper

    instruments = [(SRModel, "train_step", counting("train_step")),
                   (SRModel, "validation_step", counting("validation_step")),
                   (SRModel, "generate", counting("generate")),
                   (SRModel, "before_epoch", epoch_clock("before")),
                   (SRModel, "after_epoch", epoch_clock("after")),
                   (SRModel, "resume_training", resume_capture),
                   (DataPipeline, "train_batch_generator", timed_generator),
                   (DataPipeline, "validation_batch_generator", timed_generator),
                   (train_pkg, "run_training", capture_run)]

    def instrumented(run):
        with contextlib.ExitStack() as stack:
            for owner, name, make in instruments:
                stack.enter_context(patched(owner, name, make))
            return run()
    return calls, seen, epochs, waits, instrumented


def yaml_phase(dev, work, launches_by_path, card, notes=None):
    """Phase 8: training from a YAML file (see the docstring); its wait
    share goes into ``notes``."""
    from simplesr_tpu_torch.config import _yaml
    from simplesr_tpu_torch.data import DataPipeline
    from simplesr_tpu_torch.data.image import read_rgb_u8
    from simplesr_tpu_torch.tools import train as train_tool
    from simplesr_tpu_torch.train import SRModel, load_model
    from simplesr_tpu_torch.utils.tensorboard import SummaryWriter

    start("8 training from a YAML file: the production recipe")
    t_phase = time.perf_counter()
    spec = _yaml.load(RECIPE)
    gallery = ROOT / "data/corpus/gallery"
    reduced = {"train_data_paths": f"{spec['general']['train_data_paths']} -> {gallery} "
                                   "(16 PNGs; the recipe's DIV2K is not in the repo)",
               "results_save_path": "a temporary directory",
               "num_epochs": f"{spec['general']['num_epochs']} -> {YAML_EPOCHS}",
               "random_seed": "unset -> 0"}
    spec["general"].update(train_data_paths=str(gallery), num_epochs=YAML_EPOCHS,
                           random_seed=0, results_save_path=str(work / "yaml_run"))
    kept = {k: spec["general"][k] for k in ("batch_size", "crop_size", "num_crops",
                                            "augmentations", "train_val_split", "scale",
                                            "paired_train")}
    log(8, recipe=str(RECIPE.relative_to(ROOT)), reduced=reduced, kept=kept,
        generator=spec["model"]["generator"], optimizer=spec["model"]["generator_optimizer"],
        optimizer_config=spec["model"]["generator_optimizer_config"])

    def write(name, **general):
        path = work / name
        run = copy.deepcopy(spec)
        run["general"].update(general)
        path.write_text(_yaml.dump(run))
        return path

    calls, seen, epochs, waits, instrumented = run_instruments()

    t = time.perf_counter()
    decoded = [read_rgb_u8(p, native=False) for p in sorted(gallery.glob("*.png"))]
    decode_s = time.perf_counter() - t

    # the run
    first_yaml = write("run.yaml")
    writer_s = [0.0, 0]  # seconds in SummaryWriter.add_scalar, calls

    def timed_scalar(original):
        def wrapper(self, *a, **k):
            t = time.perf_counter()
            original(self, *a, **k)
            writer_s[0] += time.perf_counter() - t
            writer_s[1] += 1
        return wrapper

    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with patched(SummaryWriter, "add_scalar", timed_scalar):
        code, launches = counted(lambda: instrumented(
            lambda: train_tool.main([str(first_yaml)])))
    run_s = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    launches_by_path["run_training_yaml_x2_epochs"] = launches
    conf, pipeline, model = seen["conf"], seen["pipeline"], seen["model"]
    first_calls, first_epochs, first_waits = dict(calls), list(epochs), list(waits)
    n_train = len(pipeline.train_imgs)
    per_epoch = -(-n_train * conf.num_crops * (1 + len(conf.augmentations)) // conf.batch_size)
    val_per_epoch = -(-len(pipeline.val_imgs) * conf.num_crops // conf.batch_size)
    # generate: test_and_plot of one train and one validation batch after
    # epoch 2, and the final evaluation's validation batches
    expected = {"train_step": YAML_EPOCHS * per_epoch,
                "validation_step": YAML_EPOCHS * val_per_epoch, "generate": 2 + val_per_epoch}
    tree = run_tree(conf.save_path)
    histories = model.histories()
    values = [float(v) for h in histories.values() for vs in h.values() for v in vs]
    epoch_loss = histories["train_epoch"]["generator_loss"]
    epoch_s = [b - a for a, b in first_epochs]
    steps_per_s = [per_epoch / s for s in epoch_s]
    epoch_wait_s = [sum(d for t, d in first_waits if a <= t < b) for a, b in first_epochs]
    result = {"exit": code, "launches": launches, "calls": first_calls, "expected": expected,
              "split": [n_train, len(pipeline.val_imgs)], "epoch_loss": epoch_loss,
              "run_s": run_s, "epoch_s": epoch_s, "train_steps_per_s": steps_per_s,
              "hr_mpix_per_s_end_to_end": [conf.batch_size * conf.crop_size[0]
                                           * conf.crop_size[1] * per_epoch / 1e6 / s
                                           for s in epoch_s],
              "pipeline_wait_share": sum(epoch_wait_s) / sum(epoch_s),
              "pipeline_wait_share_per_epoch": [w / s for w, s in zip(epoch_wait_s, epoch_s)],
              "decode_16_pngs_s": decode_s, "decoded_mpix": sum(d.size for d in decoded) / 3e6,
              "peak_mem_bytes": peak, "save_dir_tree_as_jax": tree == JAX_RUN_TREE}
    if notes is not None:
        notes["phase8_wait_share"] = result["pipeline_wait_share"]
    log(8, check="the run", **result, card=card)
    if code != 0:
        raise AssertionError(f"tools.train.main returned {code}")
    if tree != JAX_RUN_TREE:
        raise AssertionError(f"save-dir tree differs from the JAX package's: "
                             f"{sorted(tree ^ JAX_RUN_TREE)}")
    if not (all(np.isfinite(values)) and len(epoch_loss) == YAML_EPOCHS
            and epoch_loss[1] < epoch_loss[0]):
        raise AssertionError(f"histories: finite {all(np.isfinite(values))}, "
                             f"epoch losses {epoch_loss}")
    if first_calls != expected or launches["trunk"] != sum(expected.values()) \
            or launches["patches"] != 0:
        raise AssertionError(f"launches {launches} for calls {first_calls}, "
                             f"expected calls {expected}")

    # TensorBoard: the port's event files, read back
    scalars, files = run_scalars(conf.save_path)
    sizes = {d: sum(f.stat().st_size for f in (Path(conf.save_path) / "logs" / d).iterdir())
             for d in LOG_DIRS}
    matches = {}
    for d, key in (("train/epoch", "train_epoch"), ("val/epoch", "valid_epoch")):
        history = json.loads((Path(conf.save_path) / f"json_dump/resnet_{key}_history.json")
                             .read_text())
        matches[d] = sorted(scalars[d]) == sorted(history) and all(
            [s for s, _ in scalars[d][tag]] == list(range(1, YAML_EPOCHS + 1))
            and np.array_equal(np.float32([v for _, v in scalars[d][tag]]),
                               np.float32(history[tag])) for tag in history)
    log(8, check="TensorBoard event files of the run", event_files=files, bytes=sizes,
        scalars={d: sum(map(len, scalars[d].values())) for d in LOG_DIRS},
        tags={d: sorted(scalars[d]) for d in LOG_DIRS}, epoch_scalars_as_histories=matches,
        writer_calls=writer_s[1], writer_s=writer_s[0], writer_share_of_run=writer_s[0] / run_s,
        card=card)
    if any(n != 1 for n in files.values()) or not all(sizes.values()) \
            or not all(matches.values()):
        raise AssertionError(f"TensorBoard: files {files}, bytes {sizes}, "
                             f"epoch scalars as the histories {matches}")
    check_scalar_steps("the run", scalars, YAML_EPOCHS, model.iterations())

    # the _best file against the module that trained it
    crop = torch.from_numpy(decoded[2][:48, :64].astype(np.float32) / 255.0)[None].to(dev)
    best = Path(conf.model_dir) / "resnet_gen_best.msgpack"
    got = model.generate(crop)
    with torch.inference_mode():
        ref = load_model(best, device=dev)(crop)
    if not torch.equal(got, ref):
        raise AssertionError(f"_best file vs generate: {(got - ref).abs().max().item()}")

    # resume with a third epoch
    saved_history = copy.deepcopy(histories["train_epoch"])
    saved_early = model._early_stopping_util.state_dict()
    for key in calls:
        calls[key] = 0
    epochs.clear()
    resume_yaml = write("resume.yaml", num_epochs=YAML_EPOCHS + 1)
    code = instrumented(lambda: train_tool.main([str(resume_yaml), "--resume"]))
    resumed = seen["model"]
    log(8, check="--resume with 3 epochs", exit=code, resumed_at=seen["resumed_at"],
        epochs_run=len(epochs), calls=dict(calls),
        histories_as_first_run=seen["resumed_histories"] == saved_history,
        early_stop=seen["resumed_early_stop"], same_dir=seen["conf"].save_path == conf.save_path)
    if not (code == 0 and seen["resumed_at"] == YAML_EPOCHS and len(epochs) == 1
            and calls["train_step"] == per_epoch and seen["conf"].save_path == conf.save_path
            and seen["resumed_histories"] == saved_history
            and seen["resumed_early_stop"] == saved_early
            and len(resumed.histories()["train_epoch"]["generator_loss"]) == YAML_EPOCHS + 1):
        raise AssertionError("resume did not continue the run at its third epoch")
    scalars, files = run_scalars(conf.save_path)
    log(8, check="TensorBoard after --resume", event_files=files,
        steps={d: sorted({s for v in scalars[d].values() for s, _ in v}) for d in LOG_DIRS})
    if any(n != 2 for n in files.values()):
        raise AssertionError(f"--resume did not start a new events file: {files}")
    check_scalar_steps("--resume", scalars, YAML_EPOCHS + 1, resumed.iterations())

    # preemption: SIGTERM after PREEMPT_AFTER_STEPS steps of the first epoch, then --resume
    steps = [0]

    def preempting(original):
        def wrapper(self, *a, **k):
            out = original(self, *a, **k)
            steps[0] += 1
            if steps[0] == PREEMPT_AFTER_STEPS:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return wrapper

    preempt_yaml = write("preempt.yaml", results_save_path=str(work / "yaml_preempt"))
    handler = signal.getsignal(signal.SIGTERM)
    with patched(SRModel, "train_step", preempting):
        code = instrumented(lambda: train_tool.main([str(preempt_yaml)]))
    ckpt = Path(seen["conf"].checkpoint_dir)
    meta = json.loads((ckpt / "resnet_resume_meta.json").read_text())
    point = sorted(p.name for p in (ckpt / "resnet_resume").glob("step_*.pt"))
    log(8, check=f"SIGTERM after {PREEMPT_AFTER_STEPS} steps", exit=code, steps=steps[0],
        resume_point=point, completed_epochs=meta["completed_epochs"],
        handler_restored=signal.getsignal(signal.SIGTERM) == handler)
    if not (code == EXIT_PREEMPTED and point == [f"step_{PREEMPT_AFTER_STEPS}.pt"]
            and meta["completed_epochs"] == 0 and signal.getsignal(signal.SIGTERM) == handler):
        raise AssertionError("a preempted run did not exit 75 with a resume point")
    preempt_dir = seen["conf"].save_path
    code = instrumented(lambda: train_tool.main([str(preempt_yaml), "--resume"]))
    scalars, files = run_scalars(preempt_dir)
    log(8, check="--resume of the preempted run", exit=code,
        same_dir=seen["conf"].save_path == preempt_dir,
        iterations=seen["model"].iterations(), event_files=files,
        steps={d: sorted({s for v in scalars[d].values() for s, _ in v}) for d in LOG_DIRS})
    if not (code == 0 and seen["conf"].save_path == preempt_dir
            and all(n == 2 for n in files.values())):
        raise AssertionError(f"the preempted run's --resume: exit {code}, files {files}")
    check_scalar_steps("the preempted run's --resume", scalars, YAML_EPOCHS,
                       seen["model"].iterations())

    # the pipeline on the card against the CPU
    def fresh_pipeline(device):
        """A new pipeline of the run's config, given the run's decoded PNGs
        (the decode is timed above; a second one would only cost time)."""
        fresh = DataPipeline.from_config(conf, device=device)
        fresh._decode_cache.update(pipeline._decode_cache)
        return fresh

    batches = {}
    for label, device in (("cpu", "cpu"), ("card", dev)):
        it = fresh_pipeline(device).train_batch_generator()
        batches[label] = [next(it) for _ in range(3)]
        it.close()
    pairs = list(zip(batches["card"], batches["cpu"]))
    hr_equal = all(torch.equal(g[1].cpu(), c[1]) for g, c in pairs)
    lr_err = max((g[0].cpu() - c[0]).abs().max().item() for g, c in pairs)
    log(8, check="pipeline on the card vs the CPU, 3 batches", hr_bit_equal=hr_equal,
        lr_max_abs=lr_err, tol=PIPELINE_LR_TOL)
    if not (hr_equal and lr_err < PIPELINE_LR_TOL):
        raise AssertionError(f"pipeline on the card vs the CPU: HR equal {hr_equal}, "
                             f"LR {lr_err}")

    # the epoch's parts: the pipeline alone (its decode cache warm) and the
    # bare steps on its batches, each over one epoch of 60 batches
    torch.cuda.synchronize()
    t = time.perf_counter()
    loop_batches = list(pipeline.train_batch_generator())
    torch.cuda.synchronize()
    pipeline_alone_s = time.perf_counter() - t
    t = time.perf_counter()
    for lr, hr in loop_batches:
        resumed.train_step(lr, hr)
    torch.cuda.synchronize()
    steps_alone_s = time.perf_counter() - t
    log(8, check="one epoch's parts", phase_s=time.perf_counter() - t_phase,
        batches=len(loop_batches),
        pipeline_alone_s=pipeline_alone_s, pipeline_ms_per_batch=pipeline_alone_s * 1e3
        / len(loop_batches), train_steps_alone_s=steps_alone_s,
        train_step_ms=steps_alone_s * 1e3 / len(loop_batches), card=card)

    def profile():
        """The profiler on 10 steps of the loop (pipeline included), run
        after every timing of the script."""
        it = fresh_pipeline(dev).train_batch_generator()
        trace = profile_steps(lambda: resumed.train_step(*next(it)), steps=10)
        it.close()
        log(8, profiler_10_steps_of_the_loop=trace, card=card)

    return profile


def gan_tree(ema):
    """The save-dir tree of the JAX package's GAN run for 2 epochs
    (tests/test_torch_gan_yaml.py holds the port's equal to it on the CPU)."""
    tree = {p.replace("resnet", "gan") for p in JAX_RUN_TREE}
    return tree | {"models/gan_gen_best_ema.msgpack"} if ema else tree


def gan_yaml_run(phase, recipe, work, name, launches_by_path, card, pretrained=None):
    """Run a GAN example YAML through ``tools.train.main`` in this process,
    cut to the gallery, GAN_EPOCHS epochs, seed 0 and a temporary results
    directory (and, given, a pretrained generator file); gate its exit, its
    save-dir tree, its histories and its calls. Returns (model, pipeline,
    config, the run's record, resume(epochs) -> the resumed model)."""
    from simplesr_tpu_torch.config import _yaml
    from simplesr_tpu_torch.tools import train as train_tool

    spec = _yaml.load(recipe)
    gallery = ROOT / "data/corpus/gallery"
    reduced = {"train_data_paths": f"{spec['general']['train_data_paths']} -> {gallery} "
                                   "(16 PNGs; DIV2K is not in the repo)",
               "results_save_path": "a temporary directory",
               "num_epochs": f"{spec['general']['num_epochs']} -> {GAN_EPOCHS}",
               "random_seed": "unset -> 0",
               "VGGLoss weights": "ImageNet -> the seeded random init (no vgg19.npz in the repo)"}
    spec["general"].update(train_data_paths=str(gallery), num_epochs=GAN_EPOCHS, random_seed=0,
                           results_save_path=str(work / name))
    if pretrained is not None:
        reduced["pretrained_model_path"] = (f"unset -> {pretrained.relative_to(ROOT)} (the "
                                            "recipe's two-stage pipeline)")
        spec["model"]["generator"]["pretrained_model_path"] = str(pretrained)
    kept = {k: spec["general"].get(k) for k in ("batch_size", "crop_size", "num_crops",
                                                "augmentations", "train_val_split", "scale",
                                                "ema_decay")}
    log(phase, recipe=str(recipe.relative_to(ROOT)), reduced=reduced, kept=kept,
        generator=spec["model"]["generator"], discriminator=spec["model"]["discriminator"],
        optimizers=[spec["model"]["generator_optimizer_config"],
                    spec["model"]["discriminator_optimizer_config"]])
    calls, seen, epochs, waits, instrumented = run_instruments()

    def write(file, **general):
        run = copy.deepcopy(spec)
        run["general"].update(general)
        (work / file).write_text(_yaml.dump(run))
        return work / file

    path = write(f"{name}.yaml")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    code, launches = counted(lambda: instrumented(lambda: train_tool.main([str(path)])))
    run_s = time.perf_counter() - t
    launches_by_path[f"{name}_yaml_x{GAN_EPOCHS}_epochs"] = launches
    conf, pipeline, model = seen["conf"], seen["pipeline"], seen["model"]
    per_epoch = -(-len(pipeline.train_imgs) * conf.num_crops * (1 + len(conf.augmentations))
                  // conf.batch_size)
    val_per_epoch = -(-len(pipeline.val_imgs) * conf.num_crops // conf.batch_size)
    expected = {"train_step": GAN_EPOCHS * per_epoch,
                "validation_step": GAN_EPOCHS * val_per_epoch, "generate": 2 + val_per_epoch}
    ema = model.ema_parameters is not None
    tree = run_tree(conf.save_path)
    histories = model.histories()
    values = [float(v) for h in histories.values() for vs in h.values() for v in vs]
    epoch_s = [b - a for a, b in epochs]
    epoch_wait_s = [sum(d for t, d in waits if a <= t < b) for a, b in epochs]
    record = {"exit": code, "launches": launches, "calls": dict(calls), "expected": expected,
              "split": [len(pipeline.train_imgs), len(pipeline.val_imgs)],
              "epoch_generator_loss": histories["train_epoch"]["generator_loss"],
              "epoch_discriminator_accuracy": histories["train_epoch"]["discriminator_accuracy"],
              "run_s": run_s, "epoch_s": epoch_s,
              "train_steps_per_s": [per_epoch / s for s in epoch_s],
              "hr_mpix_per_s_end_to_end": [conf.batch_size * conf.crop_size[0]
                                           * conf.crop_size[1] * per_epoch / 1e6 / s
                                           for s in epoch_s],
              "pipeline_wait_share_per_epoch": [w / s for w, s in zip(epoch_wait_s, epoch_s)],
              "peak_mem_bytes": torch.cuda.max_memory_allocated(),
              "save_dir_tree_as_jax": tree == gan_tree(ema), "histories_finite":
              bool(np.all(np.isfinite(values)))}
    log(phase, check="the run", **record, card=card)
    if code != 0:
        raise AssertionError(f"tools.train.main returned {code}")
    if tree != gan_tree(ema):
        raise AssertionError(f"save-dir tree differs from the JAX package's: "
                             f"{sorted(tree ^ gan_tree(ema))}")
    if not (record["histories_finite"] and "discriminator_accuracy" in histories["train_epoch"]
            and len(histories["train_epoch"]["generator_loss"]) == GAN_EPOCHS):
        raise AssertionError(f"histories: finite {record['histories_finite']}, "
                             f"keys {sorted(histories['train_epoch'])}")
    if dict(calls) != expected:
        raise AssertionError(f"calls {dict(calls)}, expected {expected}")

    def resume(total_epochs):
        for key in calls:
            calls[key] = 0
        epochs.clear()
        code = instrumented(lambda: train_tool.main([str(write(f"{name}_resume.yaml",
                                                               num_epochs=total_epochs)),
                                                     "--resume"]))
        ok = (code == 0 and seen["resumed_at"] == GAN_EPOCHS and len(epochs) == 1
              and calls["train_step"] == per_epoch and seen["conf"].save_path == conf.save_path
              and len(seen["model"].histories()["train_epoch"]["generator_loss"])
              == total_epochs)
        log(phase, check=f"--resume with {total_epochs} epochs", exit=code,
            resumed_at=seen["resumed_at"], epochs_run=len(epochs), calls=dict(calls), ok=ok)
        if not ok:
            raise AssertionError("resume did not continue the GAN run at its next epoch")
        return seen["model"]

    return model, pipeline, conf, record, resume


def fresh_gan_model(yaml_path, dev):
    """The GAN ``SRModel`` of a YAML file as its run starts (no pipeline,
    no results directory)."""
    from simplesr_tpu_torch.config import yaml_helper
    from simplesr_tpu_torch.train import Discriminator, Generator, SRModel

    spec = yaml_helper.load_yaml(str(yaml_path))
    m = spec["model"]
    return SRModel("gan", Generator.from_yaml(spec, device=dev), m["generator_optimizer"],
                   m.get("generator_optimizer_config"), Discriminator.from_yaml(spec, device=dev),
                   m["discriminator_optimizer"], m.get("discriminator_optimizer_config"),
                   device=dev)


def gan_step_timing(phase, model, batches, card):
    """The GAN step's time (CUDA events, median of GAN_STEP_RUNS) and its
    parts, timed as consecutive events: the generator's forward, the two
    critic forwards, the VGG loss's forward, the other losses, the three
    gradient passes (critic; generator's losses to sr; sr to the generator,
    VGG's and the critic's backward inside) and the two optimizers."""
    from simplesr_tpu_torch.losses import VGGLoss

    gen, disc = model.generator_wrapper(), model.discriminator_wrapper()
    module, critic = gen.model(), disc.model()
    lr, hr = batches[0]
    it = iter(batches * (2 + GAN_STEP_RUNS // len(batches)))
    for _ in range(3):
        model.train_step(*next(it))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = cuda_ms(lambda: model.train_step(*next(it)), runs=GAN_STEP_RUNS, warmup=0)
    peak = torch.cuda.max_memory_allocated()
    st = {}

    def g_forward():
        module.train()
        st["sr"] = module(lr).float()

    def d_forwards():
        critic.train()
        st["sr_in"] = st["sr"].detach().requires_grad_(True)
        st["sr_c"], st["hr_c"] = critic(st["sr_in"]), critic(hr)

    def vgg():
        st["g_loss"] = 0.0
        for f in gen._loss_functions:
            if isinstance(f, VGGLoss):
                st["g_loss"] = st["g_loss"] + f(hr, st["sr"])[0]

    def other_losses():
        st["d_loss"], _ = disc.calculate_loss(st["sr_c"], st["hr_c"], model._rng)
        for f in gen._loss_functions:
            if not isinstance(f, VGGLoss):
                st["g_loss"] = st["g_loss"] + f(hr, st["sr"], st["hr_c"], st["sr_c"])[0]

    def backward():
        st["d_grads"] = torch.autograd.grad(st["d_loss"], model._d_params, retain_graph=True)
        direct, through_d = torch.autograd.grad(st["g_loss"], [st["sr"], st["sr_in"]])
        st["g_grads"] = torch.autograd.grad(st["sr"], model._params, direct + through_d)

    def optimizers():
        model.optimizer.apply(model._params, st["g_grads"])
        model.discriminator_optimizer.apply(model._d_params, st["d_grads"])

    parts = events_ms([("g_forward", g_forward), ("d_forwards", d_forwards), ("vgg_forward", vgg),
                       ("other_losses", other_losses), ("backward", backward),
                       ("optimizers", optimizers)], runs=10)
    batch, hr_h, hr_w = hr.shape[:3]
    result = {"step_ms": step_ms, "step_parts_ms": parts,
              "hr_mpix_per_s": batch * hr_h * hr_w / 1e6 / (step_ms / 1e3),
              "step_peak_mem_bytes": peak, "batch": list(hr.shape), "runs": GAN_STEP_RUNS}
    log(phase, check="the GAN step's time", **result, card=card)

    def profile():
        """The profiler on 3 steps, after every timing of the script."""
        log(phase, profiler_3_steps=profile_steps(lambda: model.train_step(*next(it))),
            card=card)

    return profile


def srgan_trunk_check(model, batches):
    """Phase 9's checks of the trunk kernel on ``model``'s GAN step, on each
    of ``batches`` (see GAN_WIRING_TOL and GAN_RATIO_BATCHES)."""
    from simplesr_tpu_torch.ops.kernels import residual_trunk, residual_trunk_reference
    from simplesr_tpu_torch.ops.kernels.trunk import pack_trunk_weights

    module, critic = model.generator(), model.discriminator_wrapper().model()

    def packed():
        return pack_trunk_weights(module._block_parameters())

    def plain_trunk(h):
        return residual_trunk_reference(h.permute(0, 2, 3, 1), packed()).permute(0, 3, 1, 2)

    def plain_on_kernel_forward(h):
        """The plain trunk under autograd with the kernel's output as its
        value, exactly: kernel + (plain - plain)."""
        plain = plain_trunk(h)
        with torch.no_grad():
            kernel = residual_trunk(h.detach().permute(0, 2, 3, 1), module.trunk_weights())
        return kernel.permute(0, 3, 1, 2) + (plain - plain.detach())

    def float64_trunk(h):
        return trunk_float64(h.permute(0, 2, 3, 1), packed()).permute(0, 3, 1, 2)

    def step(trunk, lr, hr):
        """One GAN step's sr (with its graph), gradient at sr, critic
        gradients and losses with ``trunk`` in the model (None: the model's
        own, TrunkFunction); the critic's statistics and the label stream
        left as they were."""
        rng, buffers = model._rng.get_state(), copy.deepcopy(critic.state_dict())
        if trunk is not None:
            module._trunk = trunk
        try:
            module.train()
            sr = module(lr).float()
            sr_in, d_loss, g_loss, _, _ = model._gan_losses(sr, hr, lr)
            d_grads = torch.autograd.grad(d_loss, model._d_params, retain_graph=True)
            direct, through_d = torch.autograd.grad(g_loss, [sr, sr_in])
        finally:
            if trunk is not None:
                del module._trunk
        model._rng.set_state(rng)
        critic.load_state_dict(buffers)
        return {"sr": sr, "grad_at_sr": direct + through_d, "D": d_grads,
                "losses": torch.stack([d_loss, g_loss]).detach()}

    def generator_grads(run, grad_at_sr):
        return torch.autograd.grad(run["sr"], model._params, grad_at_sr, retain_graph=True)

    def flat(tensors):
        return torch.cat([t.flatten().double() for t in tensors])

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    names = [n for n, _ in module.named_parameters()]
    sq = {k: {"kernel": 0.0, "plain": 0.0} for k in ("trunk", "G_same_grad_at_sr", "G", "D")}
    per_batch = []
    with patched(torch.backends.cudnn, "deterministic", lambda _: True):
        for b, (lr, hr) in enumerate(batches):
            # the trunk alone on this step's input
            with torch.no_grad():
                module.train()
                h = module.head_act(module.head(lr.permute(0, 3, 1, 2).to(module.dtype)))
                x = h.permute(0, 2, 3, 1).contiguous()
                trunk = {"kernel": residual_trunk(x, module.trunk_weights()),
                         "plain": residual_trunk_reference(x, packed())}
                trunk_64 = trunk_float64(x, packed())
            runs, launches = {}, {}
            for name, fn in (("kernel", None), ("plain", plain_trunk),
                             ("float64", float64_trunk)):
                runs[name], launches[name] = counted(lambda: step(fn, lr, hr))
            g_same = {name: generator_grads(r, runs["float64"]["grad_at_sr"])
                      for name, r in runs.items()}
            g_own = {name: generator_grads(r, r["grad_at_sr"]) for name, r in runs.items()}
            vs_float64 = {key: {} for key in sq}
            for name in ("kernel", "plain"):
                for key, got, ref in (
                        ("trunk", [trunk[name]], [trunk_64]),
                        ("G_same_grad_at_sr", g_same[name], g_same["float64"]),
                        ("G", g_own[name], g_own["float64"]),
                        ("D", runs[name]["D"], runs["float64"]["D"])):
                    vs_float64[key][name] = rel(flat(got), flat(ref))
                    sq[key][name] += vs_float64[key][name] ** 2
            k, p = runs["kernel"], runs["plain"]
            tensors = {n: rel(a, b) for n, a, b in zip(names, g_same["kernel"], g_same["plain"])}
            worst = max(tensors, key=tensors.get)
            reading = {
                "batch": b, "trunk_rel_fro": rel(trunk["kernel"].float(), trunk["plain"].float()),
                "sr_rel_fro": rel(k["sr"].detach(), p["sr"].detach()),
                "loss_rel": ((k["losses"] - p["losses"]).abs() / p["losses"].abs()).max().item(),
                "same_grad_worst_tensor": [worst, tensors[worst]],
                "grad_at_sr_rel_fro": rel(k["grad_at_sr"], p["grad_at_sr"]),
                "D_rel_fro": rel(flat(k["D"]), flat(p["D"])),
                "rel_fro_vs_float64": vs_float64, "launches": launches}
            per_batch.append(reading)
            if not (reading["trunk_rel_fro"] < TRAIN_GRAD_FRO_TOL
                    and reading["sr_rel_fro"] < TRAIN_GRAD_FRO_TOL
                    and reading["loss_rel"] < TRAIN_LOSS_REL_TOL
                    and launches["kernel"]["trunk"] == 1 and launches["plain"]["trunk"] == 0):
                raise AssertionError(f"the GAN step through the trunk kernel against the plain "
                                     f"trunk: {reading}")
            if b == 0:
                # the wiring: TrunkFunction against the plain trunk given the
                # kernel's forward values, in one step
                twin, twin_launches = counted(lambda: step(plain_on_kernel_forward, lr, hr))
                g_twin = generator_grads(twin, twin["grad_at_sr"])
                wiring = {n: rel(a, b) for n, a, b in zip(names, g_own["kernel"], g_twin)}
                wiring = {"G_worst_tensor": max(wiring.values()),
                          "D": rel(flat(k["D"]), flat(twin["D"]))}
                sr_equal = torch.equal(k["sr"], twin["sr"])
                log(9, check="the GAN step's wiring: TrunkFunction vs the plain trunk's autograd "
                    "on the kernel's forward values", sr_bit_equal=sr_equal, rel_fro=wiring,
                    tol=GAN_WIRING_TOL, launches=twin_launches)
                if not (sr_equal and max(wiring.values()) < GAN_WIRING_TOL):
                    raise AssertionError(f"GAN wiring through TrunkFunction: {wiring}, "
                                         f"sr equal {sr_equal}")
                del twin, g_twin
            del runs, g_same, g_own
    ratio = {key: (v["kernel"] / v["plain"]) ** 0.5 if v["plain"] > 0 else float("inf")
             for key, v in sq.items()}
    log(9, check="the GAN step: the trunk kernel vs the plain trunk", per_batch=per_batch,
        tol_rel_fro=TRAIN_GRAD_FRO_TOL, tol_loss_rel=TRAIN_LOSS_REL_TOL,
        kernel_over_plain_vs_float64=ratio, ratio_gated=list(GAN_RATIO_GATED),
        ratio_tol=TRUNK_CHAIN_FRO_RATIO,
        rel_fro_vs_float64={key: {n: (v[n] / len(batches)) ** 0.5 for n in v}
                            for key, v in sq.items()})
    if not all(ratio[key] <= TRUNK_CHAIN_FRO_RATIO for key in GAN_RATIO_GATED):
        raise AssertionError(f"the trunk kernel's GAN gradients further from float64 sums than "
                             f"the plain trunk's: {ratio}")


def srgan_phase(dev, work, launches_by_path, card):
    """Phase 9: the SRGAN stage from its YAML file (see the docstring)."""
    from simplesr_tpu_torch.train import load_model

    start("9 the SRGAN stage from its YAML file")
    t_phase = time.perf_counter()
    model, pipeline, conf, record, resume = gan_yaml_run(
        9, SRGAN_RECIPE, work, "srgan", launches_by_path, card, pretrained=FLAGSHIP)
    launches, calls = record["launches"], record["calls"]
    if not (model.generator().uses_trunk_kernel and launches["trunk"] == sum(calls.values())
            and launches["patches"] == 0):
        raise AssertionError(f"trunk launches {launches} for calls {calls}")

    it = pipeline.train_batch_generator()
    batches = [next(it) for _ in range(4)]
    it.close()
    lr, hr = batches[0]

    # the _best file against the module that trained it
    x = lr[:4]
    got = model.generate(x)
    with torch.inference_mode():
        ref = load_model(Path(conf.model_dir) / "gan_gen_best.msgpack", device=dev)(x)
    if not torch.equal(got, ref):
        raise AssertionError(f"gan_gen_best vs generate: {(got - ref).abs().max().item()}")

    # the stage's first step, from the flagship: two epochs of the recipe
    # with random-init VGG can saturate the generator's tanh, and every
    # gradient of the trained one is then 0
    srgan_trunk_check(fresh_gan_model(work / "srgan.yaml", dev), batches[:GAN_RATIO_BATCHES])

    # the critic's running statistics move in the discriminator branch only
    module, critic = model.generator(), model.discriminator_wrapper().model()
    twin = copy.deepcopy(critic).train()
    with torch.no_grad():
        module.train()
        twin(module(lr).float())
        twin(hr)
    (_, step_launches) = counted(lambda: model.train_step(lr, hr))
    stats = {n: ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
             for (n, a), b in zip(critic.named_buffers(), twin.buffers())
             if n.endswith(("running_mean", "running_var"))}
    log(9, check="critic statistics after one step vs two training-mode calls",
        max_rel=max(stats.values()), tol=D_STATS_REL_TOL, step_launches=step_launches)
    if not max(stats.values()) < D_STATS_REL_TOL or step_launches["trunk"] != 1:
        raise AssertionError(f"critic statistics {stats}, step launches {step_launches}")

    resumed = resume(GAN_EPOCHS + 1)
    profile = gan_step_timing(9, resumed, batches, card)
    log(9, phase_s=time.perf_counter() - t_phase)
    return profile


def esrgan_phase(dev, work, launches_by_path, card, tiled_png):
    """Phase 10: ESRGAN from its YAML file, and its model files served
    (see the docstring)."""
    from simplesr_tpu_torch.data.image import read_img
    from simplesr_tpu_torch.eval.evaluation import _as_predictor
    from simplesr_tpu_torch.models import build_generator_model
    from simplesr_tpu_torch.tools.upscale import upscale_files
    from simplesr_tpu_torch.train import load_payload
    from simplesr_tpu_torch.train.convert import from_flax_variables

    start("10 ESRGAN from its YAML file, its model files served")
    t_phase = time.perf_counter()
    model, pipeline, conf, record, _ = gan_yaml_run(10, ESRGAN_RECIPE, work, "esrgan",
                                                    launches_by_path, card)
    if record["launches"] != {"trunk": 0, "patches": 0}:
        raise AssertionError(f"the RRDB run launched {record['launches']}")

    files = {label: Path(conf.model_dir) / f"gan_gen_{label}.msgpack"
             for label in ("best", "best_ema")}
    out_dir = work / "esrgan_out"
    served = {}
    for label, route, png in (("best", "untiled", GALLERY_PNG),
                              ("best_ema", "untiled", GALLERY_PNG),
                              ("best_ema", "tiled", tiled_png)):
        path = files[label]
        key = f"esrgan_{label}_upscale_files_{route}"
        t = time.perf_counter()
        (written,), launches = counted(lambda: upscale_files(
            path, [png], out_dir / label, 4, device=dev))
        launches_by_path[key] = launches
        served[key] = {**launches, "seconds": time.perf_counter() - t}
        want = {"trunk": 0, "patches": int(route == "tiled")}
        if launches != want:
            raise AssertionError(f"{key}: launches {launches}, expected {want}")
    predictors = {label: _as_predictor(path, device=dev) for label, path in files.items()}
    small = torch.from_numpy(read_img(GALLERY_PNG)[:32, :40] / 255.0)[None].float()
    outs = {label: p(small.to(dev)).cpu() for label, p in predictors.items()}
    finite = all(torch.isfinite(o).all().item() for o in outs.values())
    ema_differs = files["best"].read_bytes() != files["best_ema"].read_bytes() and \
        not torch.equal(outs["best"], outs["best_ema"])
    config, variables = load_payload(files["best_ema"])
    f32 = build_generator_model(**dict(config, dtype="float32"), device="cpu")
    f32.load_state_dict(from_flax_variables(f32, variables))
    with torch.inference_mode():
        exact = f32(small)
    cpu = _as_predictor(files["best_ema"], device="cpu")(small)
    card_vs_cpu = {"max_abs": (outs["best_ema"] - cpu).abs().max().item(),
                   "card_vs_float32_mean_abs": (outs["best_ema"] - exact).abs().mean().item(),
                   "cpu_vs_float32_mean_abs": (cpu - exact).abs().mean().item()}
    log(10, check="serving the model files", launches=served, finite=finite,
        ema_file_differs=ema_differs, card_vs_cpu=card_vs_cpu,
        tol_max_abs=RRDB_ROUTE_MAX_ABS_TOL, mean_ratio_tol=RRDB_MEAN_RATIO)
    if not (finite and ema_differs):
        raise AssertionError(f"ESRGAN files: finite {finite}, EMA differs {ema_differs}")
    if not (card_vs_cpu["max_abs"] < RRDB_ROUTE_MAX_ABS_TOL
            and card_vs_cpu["card_vs_float32_mean_abs"]
            <= RRDB_MEAN_RATIO * card_vs_cpu["cpu_vs_float32_mean_abs"]):
        raise AssertionError(f"ESRGAN on the card vs the CPU: {card_vs_cpu}")

    it = pipeline.train_batch_generator()
    batches = [next(it) for _ in range(4)]
    it.close()
    profile = gan_step_timing(10, model, batches, card)
    log(10, phase_s=time.perf_counter() - t_phase)
    return profile


# Phase 11: the serving surface on the flagship.
SERVE_TIMING_RUNS = 20
# The polyphase form against the training form of the flagship at bf16 (CPU
# test, tests/test_torch_polyphase.py, 4 gallery crops): max 7.2e-5, mean
# 4.4e-7 on [-1, 1]. The head, the trunk and PolyUp_1 (at s = 1 the
# training form's first subpixel conv) compute the same sums; PolyUp_2 and
# PolyOut sum the same products in another order, so a bf16 rounding of
# PolyUp_2 flips now and then and the output moves by a fraction of a
# level. The card's convolution library picks another order for each of
# the two shapes, so the bounds leave 70x and 100x room; a wrong phase order
# moves the output by 0.1-1.
POLY_MAX_ABS_TOL = 5e-3
POLY_MEAN_ABS_TOL = 5e-5
# The same difference in the evaluation's metrics (CPU test: under 1e-4 dB
# and 1e-6 SSIM on the gallery crops).
POLY_PSNR_TOL = 1e-2
POLY_SSIM_TOL = 1e-4
# The ensemble against the mean of its 8 dihedral outputs computed one by
# one, each through the predictor at the group call's shapes (the input
# repeated 4 times, so that the convolution library runs the same shapes):
# the same values averaged in float32.
ENSEMBLE_TOL = 1e-5
# The paired trunk (128 wide, the ResBlock modules, flax's rounding points)
# against the trunk kernel's rounding points: two bf16 models through 16
# blocks, as the port against flax (tests/test_torch_srresnet.py: max 0.1,
# mean 0.01; the flagship measured 0.035 / 0.0036 there, and the paired
# trunk against the unpaired one on the CPU 0.032 / 0.0036,
# tests/test_torch_paired.py).
PAIRED_MAX_ABS_TOL = 0.1
PAIRED_MEAN_ABS_TOL = 0.01
# A committed, trained RRDB, served in its paired and polyphase ("up") forms
# on the card against the CPU. Trained weights spread summation orders wider
# than phase 10's two-epoch model: on this 32 x 40 crop its bf16 forms lie
# 0.0207 from their float32 forms on the CPU (mean 1.2e-3;
# tests/test_torch_polyphase.py). So each form is held to ROUTE_MAX_ABS_TOL
# against the CPU and, as phase 10, to at most RRDB_MEAN_RATIO of the CPU's
# mean error against the same form in float32.
RRDB_SERVED = ROOT / "results/quality_r4/models/resnet_gen_rrdb_x4_best.msgpack"
# A compatible committed pair for network interpolation (the same config:
# the SRGAN stage was warm-started from that PSNR model); the script checks
# the configs before it blends.
INTERP_PAIR = (ROOT / "results/quality_r4/models/resnet_gen_srresnet_x4_best.msgpack",
               ROOT / "results/quality_r4/models/gan_gen_srgan_x4_final.msgpack")
# What a user of the repo gets for the zoo name "srresnet_x4": the newest
# campaign that holds it (the zoo's rule); the chip copy must hold it too.
ZOO_SRRESNET_X4 = ROOT / "results/quality_r5/models/resnet_gen_srresnet_x4_best.msgpack"
DAEMON_PNGS = 8  # the smallest gallery PNGs, one session
LOAD_CLIENTS = (1, 4, 8)
# Requests at each concurrency, split over the clients: enough that p99 is
# the mean of the 3 or 4 slowest, not the one slowest. A warm-up level of
# LOAD_WARMUP (clients, requests) runs first and is not reported.
LOAD_REQUESTS = 320
LOAD_WARMUP = (2, 32)
LOAD_TIMEOUT_S = 300
LOAD_HW = (128, 128)
YAML_GALLERY_PNGS = 4


def _levels(a, b):
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def run_load(socket_path, bodies, work):
    """``tools.bench_serve.load_generator`` in a process of its own, as the
    daemon's users' clients are (no share of the server's interpreter lock),
    over LOAD_WARMUP and then LOAD_REQUESTS at each of LOAD_CLIENTS;
    requests/s and latency over all requests of each level."""
    body_paths = []
    for i, body in enumerate(bodies):
        body_paths.append(str(work / f"load_{i}.png"))
        Path(body_paths[-1]).write_bytes(body)
    levels = [LOAD_WARMUP] + [(n, LOAD_REQUESTS) for n in LOAD_CLIENTS]
    under_load = {}
    for clients, latencies, wall, failures in bench_serve.run_load(
            socket_path, body_paths, levels, timeout=LOAD_TIMEOUT_S)[1:]:
        if failures or len(latencies) != LOAD_REQUESTS:
            raise AssertionError(f"load with {clients} clients: {len(latencies)} requests, "
                                 f"failures {failures[:5]}")
        under_load[clients] = bench_serve.latency_summary(latencies, wall)
    return under_load


def serving_phase(dev, work, launches_by_path, card, tiled_png, tiled_lr, gallery_lr,
                  lr_batch, tiled_batches):
    """Phase 11: the serving surface (see the docstring)."""
    from simplesr_tpu_torch import zoo
    from simplesr_tpu_torch.config import ConfigUtil, _yaml
    from simplesr_tpu_torch.data.png import encode_png, read_png, read_png_size, write_png
    from simplesr_tpu_torch.eval.evaluation import (_as_predictor, _upscale,
                                                    evaluate_on_validationdata)
    from simplesr_tpu_torch.models import build_generator_model
    from simplesr_tpu_torch.models.paired import rrdb_paired_model
    from simplesr_tpu_torch.models.polyphase import (SRResNetPolyphase, polyphase_model,
                                                     rrdb_polyphase_model)
    from simplesr_tpu_torch.ops.ensemble import dihedral_inverse, dihedral_transform
    from simplesr_tpu_torch.tools import serve as serve_mod
    from simplesr_tpu_torch.tools.http_gateway import serve_http
    from simplesr_tpu_torch.tools.interpolate import interpolate_models
    from simplesr_tpu_torch.tools.run_example import main as run_example
    from simplesr_tpu_torch.tools.upscale import upscale_files
    from simplesr_tpu_torch.train import from_flax_variables, load_model, load_payload, save_model

    start("11 the serving surface: polyphase, ensemble, paired, daemon, gateway, YAML, zoo")
    t_phase = time.perf_counter()
    gallery = sorted((ROOT / "data/corpus/gallery").glob("*.png"),
                     key=lambda p: (np.prod(read_png_size(p)), p.name))  # smallest first
    log(11, reduced={
        "inference YAML": f"the {len(gallery)} gallery PNGs -> the {YAML_GALLERY_PNGS} "
                          "smallest and the 1100 x 1040 LR PNG, grid off (PNG encode time)",
        "evaluation YAML": f"{YAML_GALLERY_PNGS} gallery crops of 96 x 96",
        "daemon session": f"the {DAEMON_PNGS} smallest gallery PNGs"})

    # 1. the polyphase form, the new default
    out_dir = work / "serve_out"
    for label, png, want in (("polyphase_upscale_files_untiled", GALLERY_PNG,
                              {"trunk": 1, "patches": 0}),
                             ("polyphase_upscale_files_tiled", tiled_png,
                              {"trunk": tiled_batches, "patches": 1})):
        (written,), launches = counted(lambda: upscale_files(FLAGSHIP, [png], out_dir, 4,
                                                             fast=True, device=dev))
        launches_by_path[label] = launches
        if launches != want:
            raise AssertionError(f"{label}: launches {launches}, expected {want}")
    fast = _as_predictor(FLAGSHIP, device=dev)
    slow = _as_predictor(FLAGSHIP, fast=False, device=dev)
    with torch.inference_mode():
        sr_fast = {"gallery": _upscale(fast, gallery_lr[None], 4),
                   "tiled": _upscale(fast, tiled_lr[None], 4)}
        sr_slow = {"gallery": _upscale(slow, gallery_lr[None], 4),
                   "tiled": _upscale(slow, tiled_lr[None], 4)}
    poly_diff = {k: {"max_abs": (sr_fast[k] - sr_slow[k]).abs().max().item(),
                     "mean_abs": (sr_fast[k] - sr_slow[k]).abs().mean().item()}
                 for k in sr_fast}
    tiled_ms = alternating_ms({"fast": lambda: _upscale(fast, tiled_lr[None], 4),
                               "training_form": lambda: _upscale(slow, tiled_lr[None], 4)},
                              runs=SERVE_TIMING_RUNS)
    training = load_model(FLAGSHIP, device=dev)
    poly, _ = polyphase_model(training)
    stages = tail_stage_ms(training, poly, lr_batch)
    mpix = 16 * TILED_HW[0] * TILED_HW[1] / 1e6
    log(11, check="polyphase (fast=True) against the training form", diff=poly_diff,
        tol_max_abs=POLY_MAX_ABS_TOL, tol_mean_abs=POLY_MEAN_ABS_TOL,
        launches={k: launches_by_path[k] for k in ("polyphase_upscale_files_untiled",
                                                    "polyphase_upscale_files_tiled")},
        tiled_ms=tiled_ms, tiled_output_mpix_per_s={k: mpix / (v / 1e3)
                                                    for k, v in tiled_ms.items()},
        training_over_fast=tiled_ms["training_form"] / tiled_ms["fast"],
        tail_stage_ms_one_tiled_batch=stages, runs=SERVE_TIMING_RUNS, card=card)
    for k, d in poly_diff.items():
        if not (d["max_abs"] < POLY_MAX_ABS_TOL and d["mean_abs"] < POLY_MEAN_ABS_TOL):
            raise AssertionError(f"polyphase vs training form on {k}: {d}")
    if not isinstance(poly, SRResNetPolyphase) or not poly.uses_trunk_kernel:
        raise AssertionError("the polyphase form lost the trunk kernel")

    # 2. the x8 self-ensemble
    ens = _as_predictor(FLAGSHIP, ensemble=True, device=dev)
    crop = gallery_lr[:CROP_HW[0], :CROP_HW[1]][None].contiguous()
    with torch.inference_mode():
        sr_ens, crop_launches = counted(lambda: ens(crop))
        groups = [k for k in range(8) if k % 2 == 0] + [k for k in range(8) if k % 2 == 1]
        acc_group, acc_single = torch.zeros_like(sr_ens), torch.zeros_like(sr_ens)
        for k in groups:
            t = dihedral_transform(crop, k)
            acc_group += dihedral_inverse(fast(torch.cat([t] * 4))[:1], k).float()
            acc_single += dihedral_inverse(fast(t), k).float()
        ens_err = (sr_ens - acc_group / 8).abs().max().item()
        ens_single_err = (sr_ens - acc_single / 8).abs().max().item()
        sr_ens_tiled, tiled_launches = counted(lambda: _upscale(ens, tiled_lr[None], 4))
    launches_by_path["ensemble_crop"] = crop_launches
    launches_by_path["ensemble_tiled"] = tiled_launches
    ens_ms = {"crop": cuda_ms(lambda: ens(crop), runs=10, warmup=2),
              "crop_fast": cuda_ms(lambda: fast(crop), runs=10, warmup=2),
              "tiled": cuda_ms(lambda: _upscale(ens, tiled_lr[None], 4), runs=3, warmup=1)}
    log(11, check="x8 self-ensemble", crop=list(crop.shape), launches_crop=crop_launches,
        launches_tiled=tiled_launches, max_abs_vs_one_by_one_same_shapes=ens_err,
        tol=ENSEMBLE_TOL, max_abs_vs_one_by_one_batch_1=ens_single_err, ms=ens_ms,
        finite=bool(torch.isfinite(sr_ens_tiled).all()), card=card)
    if crop_launches != {"trunk": 2, "patches": 0} or \
            tiled_launches != {"trunk": 2 * tiled_batches, "patches": 1}:
        raise AssertionError(f"ensemble launches {crop_launches}, {tiled_launches}")
    if not ens_err < ENSEMBLE_TOL or not torch.isfinite(sr_ens_tiled).all():
        raise AssertionError(f"ensemble vs its 8 outputs one by one: {ens_err}")

    # 3. the paired trunk (128 wide, cuDNN), and RRDB's paired and polyphase forms
    paired = _as_predictor(FLAGSHIP, paired=2, device=dev)
    with torch.inference_mode():
        sr_paired, batch_launches = counted(lambda: paired(lr_batch))
        sr_unpaired = fast(lr_batch)
        sr_paired_tiled, paired_tiled_launches = counted(
            lambda: _upscale(paired, tiled_lr[None], 4))
    launches_by_path["paired_batch_of_8_tiles"] = batch_launches
    launches_by_path["paired_tiled"] = paired_tiled_launches
    paired_diff = {k: {"max_abs": (a - b).abs().max().item(),
                       "mean_abs": (a - b).abs().mean().item()}
                   for k, a, b in (("batch", sr_paired, sr_unpaired),
                                   ("tiled", sr_paired_tiled, sr_fast["tiled"]))}
    paired_ms = alternating_ms({"paired_batch": lambda: paired(lr_batch),
                                "unpaired_batch": lambda: fast(lr_batch)}, runs=10)
    paired_ms.update(alternating_ms(
        {"paired_tiled": lambda: _upscale(paired, tiled_lr[None], 4),
         "unpaired_tiled": lambda: _upscale(fast, tiled_lr[None], 4)}, runs=5, warmup=1))
    rrdb_x = torch.from_numpy(read_png(GALLERY_PNG)[:32, :40, :3] / 255.0).float()
    rrdb_x = torch.stack([rrdb_x, rrdb_x.flip(1)])
    rrdb_cpu = load_model(RRDB_SERVED, device="cpu")
    config, variables = load_payload(RRDB_SERVED)
    rrdb_f32 = build_generator_model(**dict(config, dtype="float32"), device="cpu")
    rrdb_f32.load_state_dict(from_flax_variables(rrdb_f32, variables))
    rrdb = {}
    with torch.inference_mode():
        for label, form in (("rrdb_paired", lambda m: rrdb_paired_model(m, ways=2)[0]),
                            ("rrdb_polyphase_up", lambda m: rrdb_polyphase_model(m, mode="up")[0])):
            cpu_fn, exact_fn = form(rrdb_cpu), form(rrdb_f32)
            card_fn = copy.deepcopy(cpu_fn).to(dev)
            out, launches = counted(lambda: card_fn(rrdb_x.to(dev)))
            launches_by_path[label] = launches
            out, cpu, exact = out.cpu(), cpu_fn(rrdb_x), exact_fn(rrdb_x)
            rrdb[label] = {"max_abs_card_vs_cpu": (out - cpu).abs().max().item(),
                           "card_vs_float32_mean_abs": (out - exact).abs().mean().item(),
                           "cpu_vs_float32_mean_abs": (cpu - exact).abs().mean().item(),
                           "launches": launches}
    log(11, check="paired trunk", diff_vs_unpaired=paired_diff, tol_max_abs=PAIRED_MAX_ABS_TOL,
        tol_mean_abs=PAIRED_MEAN_ABS_TOL, launches_batch=batch_launches,
        launches_tiled=paired_tiled_launches, ms=paired_ms, rrdb=rrdb,
        rrdb_file=str(RRDB_SERVED.relative_to(ROOT)), rrdb_tol_max_abs=ROUTE_MAX_ABS_TOL,
        rrdb_mean_ratio_tol=RRDB_MEAN_RATIO, card=card)
    for k, d in paired_diff.items():
        if not (d["max_abs"] < PAIRED_MAX_ABS_TOL and d["mean_abs"] < PAIRED_MEAN_ABS_TOL):
            raise AssertionError(f"paired vs unpaired on {k}: {d}")
    if batch_launches != {"trunk": 0, "patches": 0} or \
            paired_tiled_launches != {"trunk": 0, "patches": 1}:
        raise AssertionError(f"paired launches {batch_launches}, {paired_tiled_launches}")
    for label, r in rrdb.items():
        if not (r["max_abs_card_vs_cpu"] < ROUTE_MAX_ABS_TOL and r["card_vs_float32_mean_abs"]
                <= RRDB_MEAN_RATIO * r["cpu_vs_float32_mean_abs"]) or r["launches"]["trunk"]:
            raise AssertionError(f"{label} on the card vs the CPU: {r}")

    # 4. the daemon: one session of gallery PNGs and two bad bodies, then load
    daemon_dir = work / "daemon"
    daemon_dir.mkdir()
    pngs = gallery[:DAEMON_PNGS]
    refs = [read_png(p) for p in upscale_files(FLAGSHIP, pngs, daemon_dir / "ref", 4,
                                               device=dev)]
    rng = np.random.default_rng(SEED)
    load_pngs = []
    for p in pngs:
        img = read_png(p)[:, :, :3]
        y, x = (int(rng.integers(0, n - s + 1)) for n, s in zip(img.shape[:2], LOAD_HW))
        load_pngs.append(encode_png(np.ascontiguousarray(img[y:y + LOAD_HW[0], x:x + LOAD_HW[1]])))
    cwd = os.getcwd()
    os.chdir(daemon_dir)  # a short, relative socket path
    ready, stop = threading.Event(), threading.Event()
    server = threading.Thread(target=serve_mod.serve, args=(FLAGSHIP, 4), daemon=True, kwargs=dict(
        socket_path="sr.sock", ready_event=ready, stop_event=stop, warm_shapes=(LOAD_HW,),
        device=dev))
    t = time.perf_counter()
    server.start()
    try:
        if not ready.wait(300):
            raise AssertionError("the daemon did not become ready")
        start_s = time.perf_counter() - t
        bad = {}

        def session():
            levels = []
            with serve_mod.SRClient("sr.sock") as client:
                for i, (p, ref) in enumerate(zip(pngs, refs)):
                    levels.append(_levels(client.upscale_file(p), ref))
                    if i == 1:
                        for name, body in (("jpeg", b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(64)),
                                           ("garbage", b"not an image")):
                            try:
                                client.upscale_bytes(body)
                                bad[name] = "status 0"
                            except serve_mod.SRError as e:
                                bad[name] = str(e)
                serve_mod._send_blob(client._sock, load_pngs[0])
                bad["raw_reply"] = serve_mod._recv_reply(client._sock)
            return levels

        levels, session_launches = counted(session)
        launches_by_path["daemon_session"] = session_launches
        daemon_reply = bad.pop("raw_reply")
        t = time.perf_counter()
        under_load = run_load(str(daemon_dir / "sr.sock"), load_pngs, daemon_dir)
        load_s = time.perf_counter() - t
    finally:
        stop.set()
        server.join(timeout=60)
        os.chdir(cwd)
    log(11, check="daemon", start_s=start_s, pngs=[p.name for p in pngs],
        max_levels_vs_upscale_files=levels, bad_bodies=bad, launches_session=session_launches,
        load_hw=list(LOAD_HW), load_requests=LOAD_REQUESTS, load_warmup=list(LOAD_WARMUP),
        load_generator="a process of its own, one thread and connection per client",
        under_load=under_load, load_s=load_s, stopped=not server.is_alive(), card=card)
    if max(levels) > PNG_MAX_LEVELS or len(levels) != len(pngs):
        raise AssertionError(f"daemon outputs vs upscale_files: {levels}")
    if not ("JPEG" in bad["jpeg"] and "not a PNG" in bad["garbage"]):
        raise AssertionError(f"bad bodies: {bad}")
    if session_launches != {"trunk": len(pngs) + 1, "patches": 0} or server.is_alive():
        raise AssertionError(f"daemon session launches {session_launches}")

    # 5. the HTTP gateway
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # localhost only

    def http(url, data=None):
        try:
            with opener.open(urllib.request.Request(url, data=data), timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    ready, stop, box = threading.Event(), threading.Event(), {}
    gateway = threading.Thread(target=serve_http, args=(FLAGSHIP, 4, 0), daemon=True, kwargs=dict(
        ready_event=ready, stop_event=stop, on_server=lambda s: box.update(s=s), device=dev))
    gateway.start()
    try:
        if not ready.wait(300):
            raise AssertionError("the gateway did not become ready")
        url = f"http://127.0.0.1:{box['s'].server_address[1]}"
        (code, body), http_launches = counted(lambda: http(url + "/upscale", load_pngs[0]))
        garbage_code, _ = http(url + "/upscale", b"not an image")
        health_code, health = http(url + "/healthz")
    finally:
        stop.set()
        gateway.join(timeout=60)
    launches_by_path["http_gateway_post"] = http_launches
    gateway_result = {"post": code, "same_bytes_as_daemon": body == daemon_reply[1],
                      "garbage": garbage_code, "healthz": [health_code, json.loads(health)],
                      "launches": http_launches, "stopped": not gateway.is_alive()}
    log(11, check="HTTP gateway", **gateway_result)
    if not (code == 200 and daemon_reply[0] and body == daemon_reply[1] and garbage_code == 400
            and health_code == 200 and http_launches == {"trunk": 1, "patches": 0}):
        raise AssertionError(f"gateway: {gateway_result}")

    # 6. the YAML operations
    infer = work / "yaml_inference"
    data = infer / "data" / "lr"
    data.mkdir(parents=True)
    for p in gallery[:YAML_GALLERY_PNGS]:
        (data / p.name).write_bytes(p.read_bytes())
    (data / tiled_png.name).write_bytes(tiled_png.read_bytes())
    general = {"data_paths": str(infer / "data"), "test_originals_path": None,
               "model_paths": [str(FLAGSHIP)], "scale": 4, "batch_size": 1,
               "save_single": True, "grid": False}
    spec = {"general": {"operation": "inference", "results_save_path": str(infer / "results"),
                        "interpolate": True, **general}}
    (infer / "inference.yaml").write_text(_yaml.dump(spec))
    calls = {"model": 0}

    def counting(original):
        def wrapper(self, *a, **k):
            calls["model"] += 1
            return original(self, *a, **k)
        return wrapper

    t = time.perf_counter()
    with patched(SRResNetPolyphase, "forward", counting):
        code, yaml_launches = counted(lambda: run_example([str(infer / "inference.yaml"),
                                                               "--device", dev.type]))
    inference_s = time.perf_counter() - t
    launches_by_path["run_example_inference_yaml"] = yaml_launches
    singles = sorted(p.name for p in (infer / "results").rglob("single/*.png"))
    expected_calls = YAML_GALLERY_PNGS + tiled_batches
    evaluation = work / "yaml_evaluation"
    hr = evaluation / "hr" / "gallery"
    hr.mkdir(parents=True)
    for p in gallery[:YAML_GALLERY_PNGS]:
        write_png(hr / p.name, np.ascontiguousarray(read_png(p)[:96, :96, :3]))
    spec = {"general": {**general, "operation": "evaluation",
                        "data_paths": str(evaluation / "hr"),
                        "results_save_path": str(evaluation / "results"),
                        "resize_filter": "bicubic", "crop_imgs": False, "save_single": False}}
    (evaluation / "evaluation.yaml").write_text(_yaml.dump(spec))
    eval_code, eval_launches = counted(lambda: run_example([str(evaluation / "evaluation.yaml"),
                                                         "--device", dev.type]))
    launches_by_path["run_example_evaluation_yaml"] = eval_launches
    conf, pipeline = ConfigUtil.from_yaml(spec, device=dev)
    metrics = {form: evaluate_on_validationdata(conf, pipeline=pipeline, calc_stats=True,
                                                fast=form == "fast", device=dev)[FLAGSHIP.stem]
               for form in ("fast", "training_form")}
    metric_diff = {m: float(np.abs(metrics["fast"][m] - metrics["training_form"][m]).max())
                   for m in ("psnr", "psnr-y", "ssim")}
    log(11, check="YAML operations", inference_exit=code, inference_launches=yaml_launches,
        model_calls=calls["model"], expected_model_calls=expected_calls, singles=len(singles),
        inference_s=inference_s, evaluation_exit=eval_code, evaluation_launches=eval_launches,
        mean_psnr={k: float(np.mean(v["psnr"])) for k, v in metrics.items()},
        mean_ssim={k: float(np.mean(v["ssim"])) for k, v in metrics.items()},
        max_metric_diff_fast_vs_training_form=metric_diff, tol_psnr_db=POLY_PSNR_TOL,
        tol_ssim=POLY_SSIM_TOL)
    if code != 0 or yaml_launches != {"trunk": expected_calls, "patches": 1} or \
            calls["model"] != expected_calls or len(singles) != YAML_GALLERY_PNGS + 1:
        raise AssertionError(f"inference YAML: exit {code}, launches {yaml_launches}, "
                             f"calls {calls}, singles {singles}")
    if eval_code != 0 or eval_launches != {"trunk": YAML_GALLERY_PNGS, "patches": 0}:
        raise AssertionError(f"evaluation YAML: exit {eval_code}, launches {eval_launches}")
    if not (metric_diff["psnr"] < POLY_PSNR_TOL and metric_diff["psnr-y"] < POLY_PSNR_TOL
            and metric_diff["ssim"] < POLY_SSIM_TOL):
        raise AssertionError(f"evaluation metrics, fast vs training form: {metric_diff}")

    # 7. zoo: and network interpolation
    entry = zoo.describe("srresnet_x4")
    if Path(entry.path).resolve() != ZOO_SRRESNET_X4.resolve():
        raise AssertionError(f"zoo name srresnet_x4 resolves to {entry.path}, "
                             f"expected {ZOO_SRRESNET_X4}")
    zoo_predict = zoo.load("srresnet_x4", device=dev)
    with torch.inference_mode():
        zoo_out, zoo_launches = counted(lambda: zoo_predict(crop))
    launches_by_path["zoo_load_srresnet_x4"] = zoo_launches
    pair = INTERP_PAIR
    _, psnr_vars = load_payload(pair[0])
    if load_payload(pair[0])[0] != load_payload(pair[1])[0]:
        raise AssertionError(f"{pair}: the configs differ")
    cfg, blended = interpolate_models(*pair, 0.5)
    blend_path = work / "blend_a0.5.msgpack"
    save_model(cfg, blended, blend_path)
    with torch.inference_mode():
        blend_out, blend_launches = counted(lambda: _as_predictor(blend_path, device=dev)(crop))
    launches_by_path["interpolated_model_served"] = blend_launches
    _, alpha0 = interpolate_models(*pair, 0.0)

    def leaves(tree, prefix=()):
        for k, v in sorted(tree.items()):
            yield from leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]

    alpha0_equal = [p for p, _ in leaves(alpha0)] == [p for p, _ in leaves(psnr_vars)] and all(
        np.array_equal(a, b) for (_, a), (_, b) in zip(leaves(alpha0), leaves(psnr_vars)))
    log(11, check="zoo and interpolation", zoo_entry={
        "name": entry.name, "qualified": entry.qualified,
        "path": str(Path(entry.path).relative_to(ROOT)),
        "expected": str(ZOO_SRRESNET_X4.relative_to(ROOT))}, zoo_launches=zoo_launches,
        zoo_finite=bool(torch.isfinite(zoo_out).all()),
        pair=[str(p.relative_to(ROOT)) for p in pair], config=cfg,
        blend_launches=blend_launches, blend_finite=bool(torch.isfinite(blend_out).all()),
        alpha0_bit_equal_to_psnr_file=alpha0_equal)
    if not (zoo_launches == {"trunk": 1, "patches": 0} and torch.isfinite(zoo_out).all()
            and torch.isfinite(blend_out).all() and alpha0_equal
            and blend_launches["patches"] == 0):
        raise AssertionError("zoo or interpolation failed")
    log(11, phase_s=time.perf_counter() - t_phase)


# Phase 12, the training surface. The production recipe's paired mode
# (paired_train: 2) trains the standard layout through the trunk kernel, the
# same function as the JAX package's packed layout (tests/test_torch_paired_train.py
# holds the two to 1e-5 on the CPU); its own parts are the JAX package's
# trimming of a train batch to a multiple of the ways and skipping of one
# smaller than them.
PAIRED_WAYS = 2
PAIRED_GENERATOR = {"num_blocks": 16, "num_filters": 64}
SURFACE_WARMUP = 10  # steps before the timed ones: 30 steps in all
SURFACE_RUNS = 20
DISTILL_RECIPE = ROOT / "examples/training/srresnet_distill_x4.yaml"
DISTILL_EPOCHS = 1
SUPERVISE_TIMEOUT_S = 300
LOADER_FINDING = ("ported: the host loader (csrc/host/loader.cpp, built with g++ and "
                  "zlib) decodes the pipeline's PNG and JPEG; phase 14 checks it")
# A training child that SIGKILLs itself once, after the first epoch's resume
# point says so (the pattern of the JAX package's end-to-end supervisor test).
FLAKY_TRAIN = """
import glob, json, os, signal, sys, threading, time
sys.path.insert(0, {root!r})
marker = {marker!r}
if not os.path.exists(marker):
    def killer():
        while True:
            for p in glob.glob({results!r} + "/*/checkpoints/resnet_resume_meta.json"):
                try:
                    if json.load(open(p))["completed_epochs"] >= 1:
                        open(marker, "w").close()
                        os.kill(os.getpid(), signal.SIGKILL)
                except (OSError, ValueError, KeyError):
                    pass
            time.sleep(0.05)
    threading.Thread(target=killer, daemon=True).start()
from simplesr_tpu_torch.tools.train import main
sys.exit(main([{config!r}, "--device", {device!r}] + sys.argv[1:]))
"""


def paired_mode_step(dev, work, gen, launches_by_path, card):
    """Phase 12 (a): the paired mode's train step at full width. Returns
    the profiler closure."""
    from simplesr_tpu_torch.data.png import read_png
    from simplesr_tpu_torch.ops.kernels import residual_trunk
    from simplesr_tpu_torch.train import Generator, SRModel

    images = [torch.from_numpy(read_png(p)).to(dev)
              for p in sorted((ROOT / "data/corpus/gallery").glob("*.png"))]
    batches = training_batches(gen, images, SURFACE_WARMUP + SURFACE_RUNS)

    class Dirs:
        model_dir = str(work / "surface" / "models")
        checkpoint_dir = str(work / "surface" / "checkpoints")

    generator = Generator.srresnet(4, batch_norm=False, dtype="bfloat16", seed=SEED, device=dev,
                                   **PAIRED_GENERATOR)
    model = SRModel("resnet", generator, "Adam", {"learning_rate": TRAIN_SCHEDULE},
                    config=Dirs, device=dev, paired_ways=PAIRED_WAYS)
    if not model.generator().uses_trunk_kernel:
        raise AssertionError("the production generator lost the trunk kernel")

    # an uneven batch is trimmed to a multiple of the ways, a smaller one skipped
    lr, hr = batches[-1]
    uneven = {}
    for label, n in (("trimmed", TRAIN_BATCH - 1), ("skipped", PAIRED_WAYS - 1)):
        before = model.step
        _, uneven[label] = counted(lambda: model.train_step(lr[:n], hr[:n]))
        uneven[label] = {"batch": n, "steps": model.step - before, "launches": uneven[label]}
    log(12, check="(a) paired mode, uneven batches", **uneven)
    if uneven["trimmed"]["steps"] != 1 or uneven["trimmed"]["launches"]["trunk"] != 1 \
            or uneven["skipped"]["steps"] != 0 or uneven["skipped"]["launches"]["trunk"] != 0:
        raise AssertionError(f"uneven batches: {uneven}")

    # train_step, each step's trunk launches
    per_step = []
    it = iter(batches)

    def step():
        before = residual_trunk.launches
        model.train_step(*next(it))
        per_step.append(residual_trunk.launches - before)

    ms, counts = counted(lambda: cuda_ms(step, runs=SURFACE_RUNS, warmup=SURFACE_WARMUP))
    steps = SURFACE_WARMUP + SURFACE_RUNS
    launches_by_path[f"paired_train_step_x{steps}"] = counts
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model.train_step(*batches[0])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    mean_loss = model.generator_wrapper().epoch_metrics(True).results()["generator_loss"]
    log(12, check="(a) paired mode, train_step", paired_ways=PAIRED_WAYS, step_ms=ms,
        hr_mpix_per_s=TRAIN_BATCH * TRAIN_HR ** 2 / 1e6 / (ms / 1e3),
        trunk_launches=sum(per_step), steps=steps, launches_all=counts, peak_mem_bytes=peak,
        mean_loss=mean_loss, runs=SURFACE_RUNS, batch=[TRAIN_BATCH, TRAIN_HR, TRAIN_HR, 3],
        card=card)
    if per_step != [1] * steps or counts != {"trunk": steps, "patches": 0}:
        raise AssertionError(f"train_step launches {per_step}, {counts}")
    if not np.isfinite(mean_loss):
        raise AssertionError(f"a non-finite training loss: {mean_loss}")

    def profile():
        """The profiler on 3 steps, after every timing."""
        it = iter(batches)
        log(12, profiler_3_steps=profile_steps(lambda: model.train_step(*next(it))), card=card)

    return profile


def supervised_production_run(dev, work, launches_by_path):
    """Phase 12 (b): the production recipe as written, under the crash
    supervisor, its first child SIGKILLed after epoch 1."""
    from simplesr_tpu_torch.config import _yaml
    from simplesr_tpu_torch.data.image import read_img
    from simplesr_tpu_torch.train import load_model

    spec = _yaml.load(RECIPE)
    gallery = ROOT / "data/corpus/gallery"
    results = work / "supervised"
    reduced = {"train_data_paths": f"{spec['general']['train_data_paths']} -> {gallery} "
                                   "(16 PNGs; the recipe's DIV2K is not in the repo)",
               "results_save_path": "a temporary directory",
               "num_epochs": f"{spec['general']['num_epochs']} -> {YAML_EPOCHS}",
               "random_seed": "unset -> 0"}
    spec["general"].update(train_data_paths=str(gallery), num_epochs=YAML_EPOCHS,
                           random_seed=0, results_save_path=str(results))
    config = work / "supervised.yaml"
    config.write_text(_yaml.dump(spec))
    marker = work / "killed_once"
    wrapper = work / "flaky_train.py"
    wrapper.write_text(FLAKY_TRAIN.format(root=str(ROOT), marker=str(marker),
                                          results=str(results / "training"),
                                          config=str(config), device=dev.type))
    log(12, check="(b) the production recipe under the supervisor",
        recipe=str(RECIPE.relative_to(ROOT)), reduced=reduced,
        kept={k: spec["general"][k] for k in ("paired_train", "batch_size", "crop_size",
                                              "num_crops", "augmentations")})
    t = time.perf_counter()
    # a session of its own, so that a timeout ends the training child too
    proc = subprocess.Popen([sys.executable, "-m", "simplesr_tpu_torch.tools.supervise",
                             "--max-restarts", "2", "--backoff", "0", "--cmd", sys.executable,
                             str(wrapper)], cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=SUPERVISE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"the supervised run passed {SUPERVISE_TIMEOUT_S} s")
    run_s = time.perf_counter() - t
    said = [line for line in out.splitlines() if line.startswith("[supervise]")]
    if proc.returncode != 0:
        raise AssertionError(f"the supervisor exited {proc.returncode}: {said}\n"
                             f"{out[-3000:]}\n{err[-3000:]}")
    runs = [r for r in (results / "training").iterdir() if not r.is_symlink()]
    meta = json.loads((runs[0] / "checkpoints" / "resnet_resume_meta.json").read_text())
    best = runs[0] / "models" / "resnet_gen_best.msgpack"
    lr = torch.from_numpy(read_img(GALLERY_PNG)[:48, :64] / 255.0).float()[None].to(dev)
    with torch.inference_mode():
        sr, launches = counted(lambda: load_model(best, device=dev)(lr))
    launches_by_path["production_best_file_forward"] = launches
    record = {"exit": proc.returncode, "supervisor": said, "killed_once": marker.exists(),
              "run_dirs": len(runs), "completed_epochs": meta["completed_epochs"],
              "epoch_loss": meta["train_epoch_history"].get("generator_loss"), "run_s": run_s,
              "best_file_out": list(sr.shape), "best_file_finite": bool(torch.isfinite(sr).all()),
              "best_file_launches": launches, "loader": LOADER_FINDING}
    log(12, check="(b) the supervised run", **record)
    restarted = (len(said) >= 4 and said[1].startswith("[supervise] child crashed (rc=-9)")
                 and said[2].endswith("--resume") and said[-1] == "[supervise] training complete")
    if not (proc.returncode == 0 and restarted and marker.exists() and len(runs) == 1
            and meta["completed_epochs"] == YAML_EPOCHS and record["best_file_finite"]
            and tuple(sr.shape) == (1, 4 * 48, 4 * 64, 3) and launches["trunk"] == 1):
        raise AssertionError(f"the supervised production run: {record}\n"
                             f"{out[-3000:]}\n{err[-3000:]}")


def distill_run(dev, work, launches_by_path, card):
    """Phase 12 (c): the distillation recipe for one epoch, and its step
    against the same step without the teacher."""
    from simplesr_tpu_torch.config import _yaml
    from simplesr_tpu_torch.ops.kernels import residual_trunk
    from simplesr_tpu_torch.tools import train as train_tool

    spec = _yaml.load(DISTILL_RECIPE)
    gallery = ROOT / "data/corpus/gallery"
    reduced = {"train_data_paths": f"{spec['general']['train_data_paths']} -> {gallery} "
                                   "(16 PNGs; DIV2K is not in the repo)",
               "results_save_path": "a temporary directory",
               "num_epochs": f"{spec['general']['num_epochs']} -> {DISTILL_EPOCHS}",
               "random_seed": "unset -> 0",
               "distill.model": f"{spec['general']['distill']['model']} -> "
                                f"{RRDB_SERVED.relative_to(ROOT)} (8 RRDB x 64 as well; the "
                                "chip copy leaves quality_r2_x4 out)"}
    spec["general"].update(train_data_paths=str(gallery), num_epochs=DISTILL_EPOCHS,
                           random_seed=0, results_save_path=str(work / "distill"))
    spec["general"]["distill"]["model"] = str(RRDB_SERVED)
    path = work / "distill.yaml"
    path.write_text(_yaml.dump(spec))
    log(12, check="(c) distillation", recipe=str(DISTILL_RECIPE.relative_to(ROOT)),
        reduced=reduced, distill=spec["general"]["distill"])
    calls, seen, epochs, waits, instrumented = run_instruments()
    t = time.perf_counter()
    code, launches = counted(lambda: instrumented(
        lambda: train_tool.main([str(path), "--device", dev.type])))
    run_s = time.perf_counter() - t
    launches_by_path[f"distill_yaml_x{DISTILL_EPOCHS}_epoch"] = launches
    model, pipeline = seen["model"], seen["pipeline"]
    histories = model.histories()
    terms = {part: {k: histories[part].get(k) for k in ("distillation_loss",
                                                        "weighted_distillation_loss")}
             for part in ("train_epoch", "valid_epoch")}
    teacher = model._distill.teacher
    frozen = all(p.grad is None and not p.requires_grad for p in teacher.parameters())
    student_calls = sum(calls.values())
    log(12, check="(c) the run", exit=code, calls=dict(calls), launches=launches,
        distill_terms=terms, teacher=type(teacher).__name__, teacher_frozen=frozen,
        run_s=run_s, epoch_s=[b - a for a, b in epochs])
    values = [v for part in terms.values() for vs in part.values() for v in (vs or [None])]
    if not (code == 0 and all(v is not None and np.isfinite(float(v)) for v in values)):
        raise AssertionError(f"distillation run: exit {code}, terms {terms}")
    if not (frozen and launches == {"trunk": student_calls, "patches": 0}):
        raise AssertionError(f"teacher frozen {frozen}; launches {launches} for {dict(calls)}")

    # the step with and without the teacher's term, alternating
    it = pipeline.train_batch_generator()
    loop = [next(it) for _ in range(4)]
    it.close()
    distiller = model._distill
    per_step = []  # trunk launches of each distilled step

    def stepper(with_teacher):
        batches = iter(loop * (SURFACE_RUNS + 2))

        def step():
            model._distill = distiller if with_teacher else None
            before = residual_trunk.launches
            try:
                model.train_step(*next(batches))
            finally:
                model._distill = distiller
            if with_teacher:
                per_step.append(residual_trunk.launches - before)
        return step

    ms = alternating_ms({"distilled": stepper(True), "plain": stepper(False)},
                        runs=SURFACE_RUNS)
    teacher_ms = cuda_ms(lambda: distiller.apply_fn(loop[0][0]), runs=10)
    log(12, check="(c) the step with and without the teacher", step_ms=ms,
        teacher_forward_ms=teacher_ms,
        teacher_share=(ms["distilled"] - ms["plain"]) / ms["distilled"],
        trunk_launches_per_distilled_step=sorted(set(per_step)), runs=SURFACE_RUNS, card=card)
    if set(per_step) != {1}:
        raise AssertionError(f"distilled steps launched {per_step} trunks")


def training_surface_phase(dev, work, gen, launches_by_path, card):
    """Phase 12: the training surface (see the docstring). Returns the
    profiler closure of (a)."""
    start("12 the training surface: paired mode, supervisor, distillation")
    t_phase = time.perf_counter()
    profile = paired_mode_step(dev, work, gen, launches_by_path, card)
    t = time.perf_counter()
    supervised_production_run(dev, work, launches_by_path)
    supervised_s = time.perf_counter() - t
    t = time.perf_counter()
    distill_run(dev, work, launches_by_path, card)
    log(12, check="(d) the native loader", ported=True, finding=LOADER_FINDING)
    log(12, supervised_s=supervised_s, distill_s=time.perf_counter() - t,
        phase_s=time.perf_counter() - t_phase)
    return profile


# ------------------------------------------------------------------ phase 13
# The parallel layer on the one card. Two ranks (processes) share cuda:0
# over gloo: NCCL refuses two ranks on one device. The port's collectives
# stage CUDA tensors through host memory under gloo, always, so every form
# runs at 2 ranks whatever gloo itself accepts on CUDA (probe (a) prints
# that); the YAML run (c) and the engine (f) are one process by design.
# A step at 2 ranks sharing one card is no speed figure.
PARALLEL_WORLD = 2
PARALLEL_FORMS = {"dp": 2, "fsdp": 2, "spatial": 2, "tp": 2, "pp": 2, "yaml_fsdp": 1,
                  "engine_mesh": 1}
PARALLEL_TIMEOUT_S = 300
PARALLEL_SGD_LR = 0.05
PARALLEL_DP_STEPS = 3
PARALLEL_ADAM_STEPS = 10
# After 3 SGD steps, ||p_2 ranks - p_1 process|| over all parameters at most
# this share of ||p_1 process - p_init||: the ranks change only the order of
# float32 sums (each rank's 8 items, then their mean); FSDP against DP alike.
PARALLEL_UPDATE_REL_TOL = 1e-2
# TP and PP after one SGD step, against one process, the same ratio: TP's
# split convs round where flax's ResBlocks round, not where the trunk
# kernel does (bf16 through 16 blocks), PP stages the kernel itself.
PARALLEL_MP_UPDATE_REL_TOL = 5e-2
# PP's forward is held at ROUTE_* against the kernel's. TP's cannot be held
# to one process's route at ROUTE_*: its row-parallel convs sum 32 + 32
# input channels where one process sums 64, and two summation orders of a
# 16-block bf16 model part by about as much as ROUTE_MEAN_ABS_TOL allows
# and more (PERF.md §6). So TP's forward, like phase 7's
# wide model, is held against float64 sums (``float64_sums``): its mean abs
# error at most this factor of the model's own ResBlock route's on the card.
PARALLEL_TP_FLOAT64_RATIO = 1.5
# Spatial strips against the whole-image forward, max |diff| / max |ref| on
# the rows away from the image's top and bottom (the outer halo is zeros,
# as the tiled route pads): bf16 features through cuDNN's choice of
# algorithm per shape, about two bf16 ulps.
PARALLEL_SPATIAL_REL_TOL = 3e-2
PARALLEL_HALO = 32
DEEP_RECIPE = ROOT / "examples/training/rrdb_deep_scaled_x4.yaml"
FSDP_WARNING = "fsdp: true requested but only one device is visible"


GLOO_PROBE_OPS = ("all_reduce", "broadcast", "all_gather", "reduce_scatter", "send_recv")


def gloo_probe_rank(op, rank, port):
    """One of two ranks of probe (a): ``op`` over gloo with CUDA tensors on
    cuda:0, checked; exits 0 when gloo took it and the result is right. A
    refusal raises; gloo may also abort the process (a pointer to device
    memory handed to a socket), which is why each operation runs in
    processes of its own (``chip_smoke.py --gloo-probe OP RANK PORT``)."""
    import datetime

    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=60))
    x = torch.full((4,), float(rank + 1), device=dev)
    if op == "all_reduce":
        dist.all_reduce(x)
        want = torch.full((4,), 3.0)
    elif op == "broadcast":
        dist.broadcast(x, 0)
        want = torch.full((4,), 1.0)
    elif op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        x, want = torch.cat(parts), torch.cat([torch.full((4,), 1.0), torch.full((4,), 2.0)])
    elif op == "reduce_scatter":
        out = torch.empty_like(x)
        dist.reduce_scatter(out, [x, 2 * x])
        x, want = out, torch.full((4,), 3.0 * (rank + 1))
    else:
        got = torch.empty_like(x)
        for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1 - rank),
                                            dist.P2POp(dist.irecv, got, 1 - rank)]):
            work.wait()
        x, want = got, torch.full((4,), float(2 - rank))
    torch.cuda.synchronize(dev)
    if not torch.equal(x.cpu(), want):
        raise AssertionError(f"{op}: {x.cpu().tolist()} != {want.tolist()}")
    dist.destroy_process_group()
    return 0


def gloo_cuda_probe(timeout=120):
    """Probe (a): which c10d operations gloo takes with CUDA tensors on this
    torch, each in two processes of its own, all at once: {op: True, or how
    it failed}."""
    runs = {}
    for op in GLOO_PROBE_OPS:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        runs[op] = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--gloo-probe",
                                      op, str(r), str(port)], cwd=str(ROOT),
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                    for r in range(2)]
    deadline = time.monotonic() + timeout
    accepted = {}
    for op, procs in runs.items():
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + " (timed out)")
        codes = [p.returncode for p in procs]
        if not any(codes):
            accepted[op] = True
        else:
            lines = [ln for o in outs for ln in o.strip().splitlines()[-1:]]
            accepted[op] = f"exit {codes}: {lines[0][:160] if lines else ''}"
    return accepted


def update_ratio(params, ref, init):
    """||params - ref|| / ||ref - init|| over all tensors."""
    num = sum(((a.float() - b.float()) ** 2).sum().item() for a, b in zip(params, ref))
    den = sum(((b.float() - c.float()) ** 2).sum().item() for b, c in zip(ref, init))
    return (num / den) ** 0.5


def parallel_rank(rank, world, port, work, dev=None):
    """One rank of phase 13 (``chip_smoke.py --parallel-rank RANK WORLD PORT
    DIR``): every 2-rank form in turn on ``dev`` (cuda:0); writes
    DIR/rank<RANK>.json."""
    import datetime

    import torch.distributed as dist

    from simplesr_tpu_torch.data.image import read_img
    from simplesr_tpu_torch.data.png import read_png
    from simplesr_tpu_torch.parallel import (MODEL_AXIS, SPATIAL_AXIS, STAGE_AXIS, make_mesh,
                                             pipeline_apply, spatial_sharded_apply, tp_apply)
    from simplesr_tpu_torch.train import Generator, SRModel, load_model

    dev = torch.device("cuda", 0) if dev is None else torch.device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    out = {"rank": rank, "launches": {}}

    images = [torch.from_numpy(read_png(p)).to(dev)
              for p in sorted((ROOT / "data/corpus/gallery").glob("*.png"))]
    (lr, hr), = training_batches(torch.Generator().manual_seed(SEED), images, 1)

    class Dirs:
        model_dir = str(work / f"r{rank}" / "models")
        checkpoint_dir = str(work / f"r{rank}" / "checkpoints")

    def build(mesh=None, optimizer="SGD", lr_=PARALLEL_SGD_LR, **kw):
        gen = Generator.srresnet(4, num_blocks=16, num_filters=64, batch_norm=False,
                                 dtype="bfloat16", seed=SEED, device=dev)
        return SRModel("resnet", gen, optimizer, {"learning_rate": lr_}, config=Dirs,
                       mesh=mesh, device=dev, **kw)

    def steps(model, n, x=lr, y=hr):
        for _ in range(n):
            model.train_step(x, y)
        torch.cuda.synchronize(dev)

    def whole(model):
        with model._whole():
            return [p.detach().clone() for p in model._params]

    def timed_step(model, x=lr, y=hr):
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        model.train_step(x, y)
        end.record()
        end.synchronize()
        return begin.elapsed_time(end)

    # (b) data parallel: 8 of the 16 crops a rank
    mesh = make_mesh()
    dp = build(mesh)
    init = whole(dp)
    _, out["launches"]["dp_sgd_x3"] = counted(lambda: steps(dp, PARALLEL_DP_STEPS))
    dp_params = whole(dp)
    single = None
    if rank == 0:
        single = build()
        steps(single, PARALLEL_DP_STEPS)
        out["dp_vs_one_process"] = update_ratio(dp_params, whole(single), init)
    adam = build(mesh, "Adam", 1e-4)
    adam.before_epoch()

    def adam_steps():
        for _ in range(PARALLEL_ADAM_STEPS):
            adam.train_step(lr, hr)
            adam.after_train_batch()
        torch.cuda.synchronize(dev)

    _, out["launches"]["dp_adam_x10"] = counted(adam_steps)
    out["adam_losses"] = [float(v) for v in adam.histories()["train_batch"]["generator_loss"]]
    out["dp_step_ms_2_ranks_one_card"] = timed_step(dp)

    # FSDP: the same 3 SGD steps on the shards
    fs = build(mesh, fsdp=True)
    _, out["launches"]["fsdp_sgd_x3"] = counted(lambda: steps(fs, PARALLEL_DP_STEPS))
    out["fsdp_vs_dp"] = update_ratio(whole(fs), dp_params, init)
    shards = dict(zip(fs._param_names, fs.parameter_shards))
    out["fsdp_held"] = {"sharded": sum(bool(s) for s in fs.state_shardings.values()),
                        "elements": sum(t.numel() for t in shards.values()),
                        "whole": sum(t.numel() for t in dp_params),
                        "packed_kept": fs.generator()._packed is not None}
    out["fsdp_step_ms_2_ranks_one_card"] = timed_step(fs)

    # (d) spatial: the flagship on phase 4's 1100 x 1040 LR image, in row strips
    model = load_model(FLAGSHIP, device=dev)
    img = torch.from_numpy(read_img(work / "tiled_lr.png") / 255.0).float().to(dev)
    sp = make_mesh({SPATIAL_AXIS: world})
    with torch.inference_mode():
        sr, out["launches"]["spatial_flagship"] = counted(
            lambda: spatial_sharded_apply(model, img, sp, 4, halo=PARALLEL_HALO))
        if rank == 0:
            ref = model(img[None])[0]
            m = PARALLEL_HALO * 4
            diff = (sr[m:-m] - ref[m:-m]).abs()
            out["spatial"] = {"shape": list(sr.shape), "finite": bool(torch.isfinite(sr).all()),
                              "interior_max_rel": (diff.max() / ref[m:-m].abs().max()).item(),
                              "interior_mean_abs": diff.mean().item(),
                              "border_max_abs": (sr[:m] - ref[:m]).abs().max().item()}

    # (e) tensor and pipeline parallel: forward and one SGD step each
    x, y = lr[:4], hr[:4]
    base = build()
    want = {}
    if rank == 0:
        with torch.no_grad():
            # PP stages the trunk kernel: against the kernel's forward. TP
            # rounds where flax's ResBlocks round (the JAX package's TP
            # forward), in another order of float32 sums: against float64
            # sums, beside the model's ResBlock route on the card.
            module = base.generator()
            want["pp"] = module(x)
            module.uses_trunk_kernel = False
            want["tp"] = module(x)
            module.uses_trunk_kernel = True
            exact = copy.deepcopy(module).cpu()
            exact.uses_trunk_kernel = False
            want["float64"] = float64_sums(exact, x.cpu()).to(dev)
    for form, axes, kw in (("tp", {MODEL_AXIS: world}, {"tensor_parallel": True}),
                           ("pp", {STAGE_AXIS: world}, {"pipeline_parallel": True,
                                                        "pipeline_microbatches": 2})):
        mm = make_mesh(axes)
        module = base.generator()
        f = tp_apply(module, mm) if form == "tp" else pipeline_apply(module, mm, 2)
        with torch.no_grad():
            got, out["launches"][f"{form}_forward"] = counted(lambda: f(x))
        trained = build(mm, **kw)
        start_params = whole(trained)
        _, out["launches"][f"{form}_sgd_x1"] = counted(lambda: steps(trained, 1, x, y))
        if rank == 0:
            one = build()
            steps(one, 1, x, y)
            d = (got - want[form]).abs()
            out[form] = {"forward_max_abs": d.max().item(), "forward_mean_abs": d.mean().item(),
                         "vs": "the kernel's forward" if form == "pp" else "the ResBlock route",
                         "kernel_forward_max_abs": (got - want["pp"]).abs().max().item(),
                         "float64_mean_abs": (got - want["float64"]).abs().mean().item(),
                         "resblock_route_float64_mean_abs":
                             (want["tp"] - want["float64"]).abs().mean().item(),
                         "step_vs_one_process": update_ratio(whole(trained), whole(one),
                                                             start_params)}
        out[f"{form}_step_ms_2_ranks_one_card"] = timed_step(trained, x, y)
    dist.barrier()
    (work / f"rank{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()
    return 0


def parallel_phase(dev, work, launches_by_path, card):
    """Phase 13: the parallel layer (see the docstring)."""
    from simplesr_tpu_torch.config import _yaml
    from simplesr_tpu_torch.data.image import read_img
    from simplesr_tpu_torch.parallel import make_mesh
    from simplesr_tpu_torch.tools import serve as serve_tool
    from simplesr_tpu_torch.tools import train as train_tool
    from simplesr_tpu_torch.tools.serve import SREngine
    from simplesr_tpu_torch.train import SRModel

    start("13 the parallel layer")
    t_phase = time.perf_counter()
    log(13, forms_by_ranks=PARALLEL_FORMS, backend="gloo on cuda:0 (host-staged collectives)",
        note="a step at 2 ranks sharing one card is no speed figure")
    pdir = work / "parallel"
    pdir.mkdir()
    (pdir / "tiled_lr.png").write_bytes((work / "tiled_lr.png").read_bytes())
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    probe = gloo_cuda_probe()
    log(13, check="(a) gloo with CUDA tensors, each operation in two processes of its own",
        accepted=probe)
    logs = [open(pdir / f"rank{r}.log", "w+") for r in range(PARALLEL_WORLD)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--parallel-rank",
                               str(r), str(PARALLEL_WORLD), str(port), str(pdir)],
                              cwd=str(ROOT), stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(PARALLEL_WORLD)]
    try:
        # (c) the repo's deep-scaled YAML at world size 1, meanwhile
        spec = _yaml.load(DEEP_RECIPE)
        gallery = ROOT / "data/corpus/gallery"
        reduced = {"train_data_paths": f"{spec['general']['train_data_paths']} -> {gallery}",
                   "results_save_path": "a temporary directory",
                   "num_epochs": f"{spec['general']['num_epochs']} -> 1",
                   "num_crops": f"{spec['general']['num_crops']} -> 1",
                   "random_seed": "unset -> 0"}
        spec["general"].update(train_data_paths=str(gallery), num_epochs=1, num_crops=1,
                               random_seed=0, results_save_path=str(pdir / "deep"))
        path = pdir / "deep.yaml"
        path.write_text(_yaml.dump(spec))
        seen, messages = {}, []
        init = SRModel.init

        def capture(*a, **k):
            seen["model"] = init(*a, **k)
            return seen["model"]

        def catch(record):  # a filter: the run's logger setup replaces the handlers
            messages.append(record.getMessage())
            return True

        logging.getLogger("simple_sr").addFilter(catch)
        SRModel.init = staticmethod(capture)
        t = time.perf_counter()
        try:
            code, launches = counted(lambda: train_tool.main([str(path)]))
        finally:
            SRModel.init = staticmethod(init)
            logging.getLogger("simple_sr").removeFilter(catch)
        launches_by_path["parallel_yaml_deep_rrdb_world1"] = launches
        model = seen["model"]
        warned = any(FSDP_WARNING in m for m in messages)
        gen = spec["model"]["generator"]
        log(13, check="(c) rrdb_deep_scaled_x4.yaml at world size 1", reduced=reduced,
            generator={k: gen[k] for k in ("architecture", "num_blocks", "num_filters",
                                           "remat")},
            exit=code, fsdp_warned=warned, replicated=model._zero is None and model._mesh is None,
            step=model.step, launches=launches, run_s=time.perf_counter() - t, card=card)
        if code != 0 or not warned or model._zero is not None or model._mesh is not None:
            raise AssertionError("the deep-scaled YAML did not train replicated with the fsdp "
                                 "warning")

        # (f) the engine over a one-device mesh (the same call as no mesh,
        # so bit-equal by construction: a check of the wiring), over a mesh
        # of two cuda:0 entries (each request padded to the minimum batch of
        # 2 and split, one image a replica, on the card), and --mesh-dp 2 on
        # one card
        gallery_lr = read_img(GALLERY_PNG) / 255.0
        requests = [gallery_lr[:64, :80], gallery_lr[:96, :128], gallery_lr[32:96, 16:96],
                    gallery_lr[:64, :80]]
        outs, calls = {}, []
        for label, mesh in (("none", None), ("one_device", make_mesh(devices=[dev])),
                            ("two_entries", make_mesh(devices=[dev, dev]))):
            engine = SREngine(FLAGSHIP, 4, max_batch=4, mesh=mesh, device=dev)
            if label == "two_entries":
                for i, (d, predict) in enumerate(engine._replicas):
                    engine._replicas[i] = (d, lambda x, i=i, p=predict: (
                        calls.append((i, int(x.shape[0]))), p(x))[1])
            try:
                outs[label], launches = counted(
                    lambda: [engine.upscale(r.astype(np.float32)) for r in requests])
            finally:
                engine.close()
            launches_by_path[f"parallel_engine_mesh_{label}"] = launches
        equal = all(np.array_equal(a, b) for a, b in zip(outs["none"], outs["one_device"]))
        split = sorted({i for i, _ in calls}) == [0, 1] and all(n == 1 for _, n in calls) \
            and len(calls) == 2 * len(requests)
        two_err = max(float(np.abs(a - b).max()) for a, b in zip(outs["none"],
                                                                 outs["two_entries"]))
        err = io_stderr(lambda: serve_tool.main(["--model", str(FLAGSHIP), "--scale", "4",
                                                 "--socket", str(pdir / "s"),
                                                 "--mesh-dp", "2"]))
        refused = "--mesh-dp 2 but only 1 devices are available" in err
        log(13, check="(f) SREngine over a mesh", requests=len(requests),
            one_device_bit_equal_to_no_mesh=equal,
            two_entries_split=split, two_entries_replica_calls=calls,
            two_entries_max_abs_vs_no_mesh=two_err, bound=ENGINE_MAX_ABS_TOL,
            mesh_dp_2_refused=refused,
            launches={k: launches_by_path[f"parallel_engine_mesh_{k}"]
                      for k in ("one_device", "two_entries")})
        if not (equal and split and two_err <= ENGINE_MAX_ABS_TOL and refused):
            raise AssertionError(f"engine mesh: bit-equal {equal}, split {split}, two entries "
                                 f"{two_err} (bound {ENGINE_MAX_ABS_TOL}), --mesh-dp 2 "
                                 f"refused {refused}")

        deadline = time.monotonic() + PARALLEL_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    tails = []
    for f in logs:
        f.seek(0)
        tails.append(f.read()[-3000:])
        f.close()
    if any(codes):
        raise AssertionError(f"parallel ranks exited {codes}:\n" + "\n".join(tails))
    ranks = [json.loads((pdir / f"rank{r}.json").read_text()) for r in range(PARALLEL_WORLD)]
    for r, res in enumerate(ranks):
        for path_, counts in res["launches"].items():
            launches_by_path[f"parallel_{path_}_rank{r}"] = counts
    r0 = ranks[0]
    expected = {"dp_sgd_x3": PARALLEL_DP_STEPS, "dp_adam_x10": PARALLEL_ADAM_STEPS,
                "fsdp_sgd_x3": PARALLEL_DP_STEPS, "spatial_flagship": 1, "tp_forward": 0,
                "tp_sgd_x1": 0, "pp_forward": 2, "pp_sgd_x1": 2}
    launches = [{k: res["launches"][k]["trunk"] for k in expected} for res in ranks]
    losses = r0["adam_losses"]
    log(13, check="(b) data parallel, 2 ranks x 8 of 16 crops of 96^2, production generator",
        dp_vs_one_process_update_ratio=r0["dp_vs_one_process"],
        fsdp_vs_dp_update_ratio=r0["fsdp_vs_dp"], tol=PARALLEL_UPDATE_REL_TOL,
        fsdp_held=[res["fsdp_held"] for res in ranks], adam_losses=losses,
        trunk_launches_by_rank=launches, expected=expected,
        step_ms_2_ranks_one_card={k: [res[f"{k}_step_ms_2_ranks_one_card"] for res in ranks]
                                  for k in ("dp", "fsdp", "tp", "pp")},
        card=card)
    log(13, check="(d) spatial, 2 ranks on the card", ranks=PARALLEL_WORLD, halo=PARALLEL_HALO,
        **r0["spatial"], tol=PARALLEL_SPATIAL_REL_TOL)
    log(13, check="(e) tensor and pipeline parallel, 2 ranks on the card", tp=r0["tp"],
        pp=r0["pp"], pp_forward_tol=[ROUTE_MAX_ABS_TOL, ROUTE_MEAN_ABS_TOL],
        tp_float64_ratio_tol=PARALLEL_TP_FLOAT64_RATIO, step_tol=PARALLEL_MP_UPDATE_REL_TOL)
    log(13, phase_s=time.perf_counter() - t_phase)
    failures = []
    if any(got != expected for got in launches):
        failures.append(f"trunk launches {launches}, expected {expected}")
    if not r0["dp_vs_one_process"] < PARALLEL_UPDATE_REL_TOL:
        failures.append(f"DP vs one process {r0['dp_vs_one_process']}")
    if not r0["fsdp_vs_dp"] < PARALLEL_UPDATE_REL_TOL:
        failures.append(f"FSDP vs DP {r0['fsdp_vs_dp']}")
    if any(res["fsdp_held"]["packed_kept"] or res["fsdp_held"]["elements"]
           >= res["fsdp_held"]["whole"] for res in ranks):
        failures.append("FSDP state not sharded")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        failures.append(f"Adam losses {losses}")
    sp = r0["spatial"]
    if not (sp["finite"] and sp["interior_max_rel"] < PARALLEL_SPATIAL_REL_TOL):
        failures.append(f"spatial {sp}")
    tp, pp = r0["tp"], r0["pp"]
    if not (tp["float64_mean_abs"]
            <= PARALLEL_TP_FLOAT64_RATIO * tp["resblock_route_float64_mean_abs"]
            and tp["step_vs_one_process"] < PARALLEL_MP_UPDATE_REL_TOL):
        failures.append(f"tp {tp}")
    if not (pp["forward_max_abs"] < ROUTE_MAX_ABS_TOL
            and pp["forward_mean_abs"] < ROUTE_MEAN_ABS_TOL
            and pp["step_vs_one_process"] < PARALLEL_MP_UPDATE_REL_TOL):
        failures.append(f"pp {pp}")
    if failures:
        raise AssertionError("parallel layer: " + "; ".join(failures))


# ------------------------------------------------------------------ phase 14
# Image input: the port's host loader (csrc/host/loader.cpp, g++ and zlib),
# its PNG and JPEG decoders against the committed fixtures' digests of PIL's
# decode (data/corpus/image_modes/MANIFEST.json: there is no PIL here) and
# against the plain Python PNG decoder, then training and serving from JPEG.
GALLERY_JPEG = ROOT / "data/corpus/gallery_jpeg"
IMAGE_MANIFEST = ROOT / "data/corpus/image_modes/MANIFEST.json"
DECODE_RUNS = 5  # each decode timing is a median of this many
IMAGE_EPOCHS = 1
SERVE_JPEGS = 2  # the smallest gallery JPEGs, through the daemon and the gateway
JPEG_STUB = b"\xff\xd8\xff\xe0\x00\x10JFIF\x00" + bytes(64)  # a malformed JPEG body


def median_ms(fn, runs=DECODE_RUNS):
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return statistics.median(times) * 1e3


def image_input_phase(dev, work, launches_by_path, card, notes):
    """Phase 14: image input (see the docstring). ``notes`` holds what
    earlier phases measured (phase 8's wait share). Returns the host
    loader's summary, which ``main`` prints on a line of its own."""
    import hashlib

    from simplesr_tpu_torch.config import _yaml
    from simplesr_tpu_torch.data import native_loader
    from simplesr_tpu_torch.data.image import decode_image
    from simplesr_tpu_torch.data.png import as_rgb, decode_png, read_png
    from simplesr_tpu_torch.tools import serve as serve_mod
    from simplesr_tpu_torch.tools import train as train_tool
    from simplesr_tpu_torch.tools.http_gateway import serve_http
    from simplesr_tpu_torch.tools.upscale import upscale_files

    start("14 image input: the host loader, every PNG mode, JPEG, training and serving "
          "from JPEG")
    t_phase = time.perf_counter()

    def digest(img):
        return hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()

    # (a) the build, from the source, into a directory of its own
    t = time.perf_counter()
    with patched(native_loader, "BUILD_DIR", lambda _: work / "host_build"):
        built = native_loader.build()
    build_s = time.perf_counter() - t
    log(14, check="(a) the host loader's build", build_s=build_s,
        compiler=native_loader.compiler_version(), cxx=native_loader.find_cxx(),
        flags=list(native_loader.CXX_FLAGS + native_loader.LIBS), library=built.name)

    # (b) PNG: the gallery natively and in Python, then every mode's fixture
    loader = native_loader.NativeLoader(num_threads=1)
    rows = []
    for p in sorted((ROOT / "data/corpus/gallery").glob("*.png")):
        data = p.read_bytes()
        t = time.perf_counter()
        plain = as_rgb(decode_png(data, str(p), grey16="loader"))
        python_s = time.perf_counter() - t
        native = loader.load_image_u8(p)
        if not np.array_equal(native, plain):
            raise AssertionError(f"{p.name}: the native and Python PNG decoders differ")
        ms = median_ms(lambda: native_loader.decode_bytes(data, grey16="loader"))
        mpix = native.shape[0] * native.shape[1] / 1e6
        rows.append({"file": p.name, "mpix": mpix, "ms": ms, "mpix_per_s": mpix / ms * 1e3,
                     "python_s": python_s})
    native_s = sum(r["ms"] for r in rows) / 1e3
    python_s = sum(r["python_s"] for r in rows)
    mpix = sum(r["mpix"] for r in rows)
    log(14, check="(b) the 16 gallery PNGs, native (bytes entry, median of "
        f"{DECODE_RUNS}) and Python, bit-equal", files=rows, native_s=native_s,
        python_s=python_s, native_mpix_per_s=mpix / native_s, python_mpix_per_s=mpix / python_s,
        python_over_native=python_s / native_s, card=card)

    manifest = json.loads(IMAGE_MANIFEST.read_text())
    wrong, counts = [], {"png": 0, "jpeg": 0}
    for entry in manifest["files"]:
        data = (ROOT / entry["file"]).read_bytes()
        want = {"pil": entry["sha256_pil_rgb"],
                "loader": entry.get("sha256_loader_rgb", entry["sha256_pil_rgb"])}
        for mode, sha in want.items():
            got = [digest(decode_image(data, entry["file"], grey16=mode))]
            if entry["format"] == "png":
                got.append(digest(as_rgb(decode_png(data, entry["file"], grey16=mode))))
            if any(g != sha for g in got):
                wrong.append([entry["file"], mode])
        counts[entry["format"]] += 1
    log(14, check="(b, c) the committed fixtures against their manifest's digests of PIL's "
        "decode", files=counts, pil=manifest["pil"], libjpeg_turbo=manifest["libjpeg_turbo"],
        wrong=wrong)
    if wrong:
        raise AssertionError(f"fixtures decoded unlike PIL: {wrong}")

    # (c) JPEG: the gallery's copy, one thread and the pool, crops, truncation
    jpegs = sorted(GALLERY_JPEG.glob("*.jpg"))
    bodies = [p.read_bytes() for p in jpegs]
    jpeg_mpix = sum(np.prod(loader.image_size(p)) for p in jpegs) / 1e6
    one_ms = median_ms(lambda: [native_loader.decode_bytes(b) for b in bodies])
    threads = os.cpu_count() or 1
    zeros = np.zeros(len(jpegs), np.int32)
    pool_ms = median_ms(lambda: native_loader.NativeLoader(num_threads=threads).load_crops(
        jpegs, zeros, zeros, 64, 64, dtype=np.uint8))
    rng = np.random.default_rng(SEED)
    picks = [jpegs[i % len(jpegs)] for i in range(48)]
    sizes = [loader.image_size(p) for p in picks]
    tops = [int(rng.integers(0, h - 96 + 1)) for h, _ in sizes]
    lefts = [int(rng.integers(0, w - 96 + 1)) for _, w in sizes]
    crops = native_loader.NativeLoader(num_threads=threads).load_crops(
        picks, tops, lefts, 96, 96, dtype=np.uint8)
    crops_equal = all(np.array_equal(c, loader.load_image_u8(p)[y:y + 96, x:x + 96])
                      for c, p, y, x in zip(crops, picks, tops, lefts))
    truncated = work / "truncated.jpg"
    truncated.write_bytes(bodies[0][:len(bodies[0]) // 2])
    refused = {}
    for label, fn in (("bytes", lambda: native_loader.decode_bytes(truncated.read_bytes())),
                      ("loader", lambda: native_loader.NativeLoader(1).load_image_u8(truncated))):
        try:
            fn()
            refused[label] = False
        except ValueError as e:
            refused[label] = str(e)
    log(14, check="(c) the gallery's JPEG copy", files=len(jpegs), mpix=jpeg_mpix,
        one_thread_ms=one_ms, one_thread_mpix_per_s=jpeg_mpix / one_ms * 1e3,
        pool_threads=threads, pool_ms=pool_ms, pool_mpix_per_s=jpeg_mpix / pool_ms * 1e3,
        crops=len(crops), crops_equal_slices=crops_equal, truncated_refused=refused, card=card)
    if not (crops_equal and all(refused.values())):
        raise AssertionError(f"crops equal {crops_equal}, truncated refused {refused}")

    # (d) training from the JPEG gallery: the production recipe, cut as in phase 8
    spec = _yaml.load(RECIPE)
    spec["general"].update(train_data_paths=str(GALLERY_JPEG), num_epochs=IMAGE_EPOCHS,
                           random_seed=0, results_save_path=str(work / "jpeg_run"))
    recipe = work / "jpeg_run.yaml"
    recipe.write_text(_yaml.dump(spec))
    calls, seen, epochs, waits, instrumented = run_instruments()
    t = time.perf_counter()
    code, launches = counted(lambda: instrumented(lambda: train_tool.main([str(recipe)])))
    run_s = time.perf_counter() - t
    launches_by_path["run_training_yaml_jpeg_x1_epoch"] = launches
    losses = seen["model"].histories()["train_epoch"]["generator_loss"]
    epoch_s = [b - a for a, b in epochs]
    wait_s = [sum(d for t0, d in waits if a <= t0 < b) for a, b in epochs]
    share = sum(wait_s) / sum(epoch_s)
    log(14, check="(d) training from the JPEG gallery", exit=code, calls=dict(calls),
        launches=launches, epoch_loss=losses, run_s=run_s, epoch_s=epoch_s,
        native_loader=seen["pipeline"]._native is not None, pipeline_wait_share=share,
        phase8_wait_share=notes.get("phase8_wait_share"), card=card)
    if not (code == 0 and len(losses) == IMAGE_EPOCHS and all(np.isfinite(losses))
            and seen["pipeline"]._native is not None and calls["train_step"] > 0
            and launches["trunk"] >= calls["train_step"]):
        raise AssertionError(f"JPEG training: exit {code}, losses {losses}, calls {calls}, "
                             f"launches {launches}")

    # (e) serving JPEG bodies: the daemon and the gateway against upscale_files
    serve_dir = work / "jpeg_serve"
    serve_dir.mkdir()
    picks = sorted(jpegs, key=lambda p: (np.prod(loader.image_size(p)), p.name))[:SERVE_JPEGS]
    refs = [read_png(p) for p in upscale_files(FLAGSHIP, picks, serve_dir / "ref", 4, device=dev)]
    cwd = os.getcwd()
    os.chdir(serve_dir)  # a short, relative socket path
    ready, stop = threading.Event(), threading.Event()
    server = threading.Thread(target=serve_mod.serve, args=(FLAGSHIP, 4), daemon=True,
                              kwargs=dict(socket_path="sr.sock", ready_event=ready,
                                          stop_event=stop, device=dev))
    server.start()
    try:
        if not ready.wait(300):
            raise AssertionError("the daemon did not become ready")

        def session():
            with serve_mod.SRClient("sr.sock") as client:
                outs = [client.upscale_file(p) for p in picks]
                try:
                    client.upscale_bytes(JPEG_STUB)
                    stub = "status 0"
                except serve_mod.SRError as e:
                    stub = str(e)
            return outs, stub

        (daemon_outs, daemon_stub), daemon_launches = counted(session)
    finally:
        stop.set()
        server.join(timeout=60)
        os.chdir(cwd)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # localhost only

    def post(url, body):
        try:
            with opener.open(urllib.request.Request(url, data=body), timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    ready, stop, box = threading.Event(), threading.Event(), {}
    gateway = threading.Thread(target=serve_http, args=(FLAGSHIP, 4, 0), daemon=True, kwargs=dict(
        ready_event=ready, stop_event=stop, on_server=lambda srv: box.update(s=srv), device=dev))
    gateway.start()
    try:
        if not ready.wait(300):
            raise AssertionError("the gateway did not become ready")
        url = f"http://127.0.0.1:{box['s'].server_address[1]}/upscale"
        replies, http_launches = counted(lambda: [post(url, p.read_bytes()) for p in picks])
        stub_code, stub_body = post(url, JPEG_STUB)
    finally:
        stop.set()
        gateway.join(timeout=60)
    launches_by_path["daemon_jpeg_session"] = daemon_launches
    launches_by_path["http_gateway_jpeg_posts"] = http_launches
    gateway_outs = [decode_png(body) if code == 200 else None for code, body in replies]
    result = {
        "files": [p.name for p in picks],
        "daemon_bit_equal": [np.array_equal(o, r) for o, r in zip(daemon_outs, refs)],
        "daemon_max_levels": [_levels(o, r) for o, r in zip(daemon_outs, refs)],
        "gateway_status": [code for code, _ in replies],
        "gateway_bit_equal": [o is not None and np.array_equal(o, r)
                              for o, r in zip(gateway_outs, refs)],
        "daemon_stub": daemon_stub, "gateway_stub": [stub_code, stub_body.decode()[:120]],
        "launches": {"daemon": daemon_launches, "gateway": http_launches},
        "stopped": not (server.is_alive() or gateway.is_alive())}
    log(14, check="(e) serving JPEG bodies", **result, phase_s=time.perf_counter() - t_phase,
        card=card)
    want = {"trunk": SERVE_JPEGS, "patches": 0}
    if not (all(result["daemon_bit_equal"]) and all(result["gateway_bit_equal"])
            and "JPEG" in daemon_stub and stub_code == 400 and result["stopped"]
            and daemon_launches == want and http_launches == want):
        raise AssertionError(f"serving JPEG bodies: {result}")
    return {"name": "host image loader", "route": "host C++ (g++, zlib)",
            "source": "simplesr_tpu_torch/csrc/host/loader.cpp",
            "replaces": "simplesr_tpu/data/_native/loader.cpp (libpng, libjpeg)",
            "build_s": build_s, "png_native_s": native_s, "png_python_s": python_s,
            "png_native_mpix_per_s": mpix / native_s,
            "jpeg_one_thread_mpix_per_s": jpeg_mpix / one_ms * 1e3,
            "jpeg_pool_mpix_per_s": jpeg_mpix / pool_ms * 1e3, "fixtures": counts,
            "jpeg_training_wait_share": share,
            "png_training_wait_share": notes.get("phase8_wait_share")}


# ------------------------------------------------------------------ phase 15
# The Keras exporter: legacy-Keras .h5 files written by the port's own HDF5
# writer, read back by the port's importer (without h5py and TensorFlow
# these are the only reader and writer of the format there is) and served.
WIDE_GROWTH = dict(upsample_factor=2, architecture="rrdb", num_blocks=1, num_dense_blocks=2,
                   num_convs=2, num_filters=8, growth_channels=8, residual_scaling=0.2,
                   batch_norm=False)


def flat_arrays(tree, prefix=""):
    """{"collection/path": array} of a variables tree."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flat_arrays(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value)
    return out


def keras_export_phase(dev, work, launches_by_path, card, tiled_png):
    """Phase 15: the Keras exporter (see the docstring)."""
    from simplesr_tpu_torch.data.png import read_png
    from simplesr_tpu_torch.models import build_generator_model
    from simplesr_tpu_torch.tools.export_keras import export_keras_model
    from simplesr_tpu_torch.tools.import_keras import import_keras_model
    from simplesr_tpu_torch.tools.upscale import upscale_files
    from simplesr_tpu_torch.train.convert import to_flax_variables
    from simplesr_tpu_torch.train.serialization import load_payload, save_model

    start("15 the Keras exporter: export, re-import, serve, refuse")
    t_phase = time.perf_counter()
    out = work / "keras"
    out.mkdir()
    # (a) export and (b) read back through the port's importer
    for label, path in (("flagship", FLAGSHIP), ("rrdb_served", RRDB_SERVED)):
        config, variables = load_payload(path)
        h5, msgpack = out / f"{label}.h5", out / f"{label}.msgpack"
        t = time.perf_counter()
        layers, _ = export_keras_model(path, h5)
        export_s = time.perf_counter() - t
        rrdb = {k: config[k] for k in ("num_dense_blocks", "num_convs", "residual_scaling")} \
            if config["architecture"] == "rrdb" else {}
        t = time.perf_counter()
        config2, variables2 = import_keras_model(h5, msgpack, **rrdb)
        import_s = time.perf_counter() - t
        want, got = flat_arrays(variables), flat_arrays(variables2)
        equal = sorted(want) == sorted(got) and all(
            got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)
        config_equal = all(config2[k] == config[k] for k in config2)
        log(15, check="(a) export, (b) the port's importer", model=label,
            config={k: config[k] for k in ("architecture", "num_blocks", "num_filters")},
            layers=len(layers), weight_layers=sum(1 for _, _, w in layers if w),
            arrays=len(want), h5_bytes=h5.stat().st_size, export_s=export_s,
            import_s=import_s, bit_equal=equal, config_equal=config_equal, card=card)
        if not (equal and config_equal):
            raise AssertionError(f"{label}: the re-imported model differs from its source "
                                 f"(arrays equal {equal}, config {config2} vs {config})")

    # (c) the re-imported flagship served as the flagship is
    served = {}
    for label, png in (("untiled", GALLERY_PNG), ("tiled", tiled_png)):
        (ref,) = upscale_files(FLAGSHIP, [png], out / f"orig_{label}", 4, device=dev)
        (new,), launches = counted(lambda: upscale_files(
            out / "flagship.msgpack", [png], out / f"keras_{label}", 4, device=dev))
        launches_by_path[f"upscale_files_keras_{label}"] = launches
        served[label] = {"launches": launches, "phase4_launches":
                         launches_by_path[f"upscale_files_{label}"],
                         "bit_equal": np.array_equal(read_png(new), read_png(ref))}
    log(15, check="(c) the re-imported flagship through upscale_files", **served, card=card)
    if not all(s["bit_equal"] and s["launches"] == s["phase4_launches"]
               for s in served.values()):
        raise AssertionError(f"serving the re-imported flagship: {served}")

    # (d) a wide-growth RRDB has no reference form and is refused
    wide = out / "rrdb_wide.msgpack"
    torch.manual_seed(SEED)
    save_model(WIDE_GROWTH, to_flax_variables(
        build_generator_model(**WIDE_GROWTH, device="cpu").state_dict()), wide)
    try:
        export_keras_model(wide, out / "rrdb_wide.h5")
        refusal = None
    except ValueError as e:
        refusal = str(e)
    log(15, check="(d) a wide-growth RRDB refused", refusal=refusal,
        written=(out / "rrdb_wide.h5").exists(), phase_s=time.perf_counter() - t_phase)
    if refusal is None or "growth_channels" not in refusal or (out / "rrdb_wide.h5").exists():
        raise AssertionError(f"the wide-growth RRDB was not refused: {refusal}")


# ------------------------------------------------------------------ phase 16
# The quality tooling: the committed models re-scored through the port's
# quality campaign against their RESULTS.json rows (quality figures of the
# JAX package's TPU campaigns, bf16), the quality gate trained from scratch,
# the GAN smoke and the standard-benchmark protocol on a stand-in set.
RESCORED = {"quality_fastrecipe": FLAGSHIP,
            "quality_r5": ROOT / "results/quality_r5/models/resnet_gen_srresnet_x4_best.msgpack"}
# Re-scored rows against RESULTS.json, |port - row| per metric, both rounded
# to 3 / 3 / 4 / 5 digits. On the CPU the port re-scores both campaigns' 4
# held-out tiles (4 metrics x model and bicubic x 8, 64 numbers) within
# 0.007 dB of PSNR and PSNR-Y, 2e-4 of SSIM and 0.22 % of LP (this phase's
# CPU rehearsal). The card's bf16 sums run in another order than the CPU's
# and the TPU's; the bounds allow 7x, 5x and 4.5x the CPU's worst.
RESCORE_PSNR_TOL = 0.05   # dB, psnr and psnr_y
RESCORE_SSIM_TOL = 1e-3
RESCORE_LP_REL_TOL = 1e-2
GATE_SCALE = 2
# The quality gate's steps: the JAX script's 4000. No count up to 4000 beats
# bicubic on this corpus (probes on the card at 500, 1000, 2000 and 4000 steps,
# PERF.md §6), and neither does the JAX package's run of the same
# recipe, so the gate holds the port to that run (JAX_GATE_GAPS) and
# prints the comparison with bicubic beside it.
GATE_STEPS = 4000
# quality_gate_reference.py (the JAX package's SRModel on the same staged
# pairs, float32 on the CPU; PERF.md §6): PSNR gap to bicubic in dB after
# 4000 steps, of the train member and of the mean over the held-out tiles
JAX_GATE_GAPS = {"train_member": -1.459686279296875, "heldout_mean": -1.0693769454956055}
# The port's 4000-step runs on the card spread over 0.39 dB of held-out
# mean gap and 0.33 dB of train-member gap across two seeds, the JAX
# package's initial weights, float32 and the plain trunk (-0.91 to -1.30 and
# -1.37 to -1.70 dB; PERF.md §6); the JAX run differs from the card's
# in precision and initial draw as those do. The port may fall short of
# the JAX run by at most this much:
GATE_PARITY_TOL = 0.5
GAN_SMOKE_STEPS = 300
BMP_STANDIN = ROOT / "data/corpus/bmp/gt_6.bmp"  # gt_6.png as PIL writes it, 24-bit
# LR long side above which the stand-in set tiles: at x4 only gt_1's LR
# (180 x 128) both exceeds it and holds a 128 px tile
STANDIN_TILE_THRESHOLD = 100
# Tiled against untiled per-image scores of the stand-in set: the tiled
# route's 32 px overlap is less than the SRResNet's receptive field, so the
# seams differ a little (gt_1 on the CPU: 0.019 dB of PSNR-Y, one step of
# the report's 3-digit SSIM-Y).
STANDIN_PSNR_TOL = 0.05
STANDIN_SSIM_TOL = 3e-3


def quality_phase(dev, work, launches_by_path, card):
    """Phase 16: the quality tooling (see the docstring)."""
    from simplesr_tpu_torch.data.image import read_rgb_u8
    from simplesr_tpu_torch.eval.evaluation import _as_predictor
    from simplesr_tpu_torch.tools import gan_smoke, quality_check
    from simplesr_tpu_torch.tools import quality_campaign as qc
    from simplesr_tpu_torch.tools import standard_benchmarks as sb
    from simplesr_tpu_torch.train import Generator

    start("16 quality: re-score, quality gate, GAN smoke, standard-benchmark stand-in")
    t_phase = time.perf_counter()

    # (a) the committed models re-scored through the campaign's evaluate
    heldout = {k: qc.HELDOUT_IMGS[k] for k in qc.HELDOUT_GALLERY}
    saved = qc.SCALE, qc.OUT_DIR, qc.DEVICE, qc.EVAL_TRAIN_IMGS, qc.HELDOUT_IMGS
    worst = {"psnr": 0.0, "psnr_y": 0.0, "ssim": 0.0, "lp_rel": 0.0}
    try:
        qc.SCALE, qc.DEVICE, qc.EVAL_TRAIN_IMGS, qc.HELDOUT_IMGS = 4, str(dev), {}, heldout
        for campaign, path in RESCORED.items():
            qc.OUT_DIR = str(ROOT / "results" / campaign)  # read only: its LP extractor
            rows = json.loads((ROOT / "results" / campaign / "RESULTS.json")
                              .read_text())["srresnet"]
            gen = Generator.srresnet(4, pretrained_model_path=path, device=dev)
            t = time.perf_counter()
            got, launches = counted(lambda: qc.evaluate(gen, "srresnet", {}))
            launches_by_path[f"quality_rescore_{campaign}"] = launches
            diffs = {}
            for name, row in got["srresnet"].items():
                for tag in ("model", "bicubic"):
                    want = rows[name][tag]
                    d = {k: abs(row[tag][k] - want[k]) for k in ("psnr", "psnr_y", "ssim")}
                    d["lp_rel"] = abs(row[tag]["lp"] - want["lp"]) / want["lp"]
                    diffs[f"{name}/{tag}"] = d
                    for k, v in d.items():
                        worst[k] = max(worst[k], v)
            log(16, check="(a) re-scored against RESULTS.json", campaign=campaign,
                rows={n: {t: r[t] for t in ("model", "bicubic")}
                      for n, r in got["srresnet"].items()},
                results_json={n: {t: rows[n][t] for t in ("model", "bicubic")}
                              for n in got["srresnet"]},
                max_diff={k: max(d[k] for d in diffs.values()) for k in worst},
                launches=launches, seconds=time.perf_counter() - t, card=card)
    finally:
        qc.SCALE, qc.OUT_DIR, qc.DEVICE, qc.EVAL_TRAIN_IMGS, qc.HELDOUT_IMGS = saved
    tol = {"psnr": RESCORE_PSNR_TOL, "psnr_y": RESCORE_PSNR_TOL, "ssim": RESCORE_SSIM_TOL,
           "lp_rel": RESCORE_LP_REL_TOL}
    log(16, check="(a) worst over both campaigns", worst=worst, tol=tol)
    if any(worst[k] > tol[k] for k in tol):
        raise AssertionError(f"re-scored rows differ from RESULTS.json: {worst} (bounds {tol})")
    for campaign in RESCORED:
        if launches_by_path[f"quality_rescore_{campaign}"]["trunk"] < 5 * len(heldout):
            raise AssertionError(f"{campaign}: the re-score ran no trunk kernel for each "
                                 f"forward and LP feature pass")

    # (b) the quality gate, from scratch through the trunk kernel
    t = time.perf_counter()
    gate, launches = counted(lambda: quality_check.main(GATE_STEPS, GATE_SCALE, device=dev))
    launches_by_path["quality_gate"] = launches
    member = [v for v in gate["images"].values() if not v["heldout"]]
    held = [v for v in gate["images"].values() if v["heldout"]]
    gaps = {"train_member": member[0]["model_psnr"] - member[0]["bicubic_psnr"],
            "heldout_mean": statistics.mean(v["model_psnr"] - v["bicubic_psnr"] for v in held)}
    log(16, check="(b) quality gate", scale=GATE_SCALE, steps=gate["steps"],
        step_ms=gate["train_s"] / gate["steps"] * 1e3, train_s=gate["train_s"],
        seconds=time.perf_counter() - t,
        psnr={k: {"model": v["model_psnr"], "bicubic": v["bicubic_psnr"]}
              for k, v in gate["images"].items()},
        gap_to_bicubic=gaps, beats_bicubic={k: v > 0 for k, v in gaps.items()},
        jax_package_gap=JAX_GATE_GAPS, parity_tol=GATE_PARITY_TOL, launches=launches,
        card=card)
    if not (len(member) == 1 and len(held) == len(heldout) and all(
            gaps[k] >= JAX_GATE_GAPS[k] - GATE_PARITY_TOL for k in gaps)):
        raise AssertionError(f"the quality gate learned less than the JAX package's run "
                             f"({gaps} against {JAX_GATE_GAPS}): {gate['images']}")
    if launches["trunk"] < GATE_STEPS:
        raise AssertionError(f"quality gate: {launches} launches for {GATE_STEPS} steps")

    # (c) the GAN smoke: srgan_generator's default is BatchNorm, which the
    # BN-free trunk kernel does not compute, so this path launches no trunk
    t = time.perf_counter()
    gan, launches = counted(lambda: gan_smoke.main(GAN_SMOKE_STEPS, device=dev))
    launches_by_path["gan_smoke"] = launches
    log(16, check="(c) GAN smoke", steps=GAN_SMOKE_STEPS, stable=gan["stable"],
        generator=gan["generator"], discriminator=gan["discriminator"],
        step_ms=gan["train_s"] / GAN_SMOKE_STEPS * 1e3, seconds=time.perf_counter() - t,
        launches=launches, trunk_note="BatchNorm generator: no trunk kernel", card=card)
    if not gan["stable"] or launches["trunk"] != 0:
        raise AssertionError(f"GAN smoke: stable {gan['stable']}, launches {launches}")

    # (d) the standard-benchmark protocol on a stand-in set, one image a BMP
    bmp_equal = np.array_equal(read_rgb_u8(BMP_STANDIN), read_rgb_u8(heldout["gt_6"]))
    sets = work / "benchmarks"
    (sets / "Set5").mkdir(parents=True)
    for name in ("gt_1", "gt_10", "gt_13"):
        (sets / "Set5" / f"{name}.png").write_bytes(Path(heldout[name]).read_bytes())
    (sets / "Set5" / "gt_6.bmp").write_bytes(BMP_STANDIN.read_bytes())
    before = os.environ.get("SIMPLESR_BENCHMARK_DATA")
    os.environ["SIMPLESR_BENCHMARK_DATA"] = str(sets)
    try:
        code, launches = counted(lambda: sb.main(
            ["--scale", "4", "--models", str(FLAGSHIP), "--out", str(work / "standard"),
             "--tile-threshold", str(STANDIN_TILE_THRESHOLD)]))
    finally:
        if before is None:
            os.environ.pop("SIMPLESR_BENCHMARK_DATA")
        else:
            os.environ["SIMPLESR_BENCHMARK_DATA"] = before
    launches_by_path["standard_benchmarks_standin"] = launches
    report = json.loads((work / "standard" / "STANDARD.json").read_text())["sets"]["Set5"]
    untiled = sb.evaluate_set(sorted((sets / "Set5").iterdir()),
                              {"m": _as_predictor(FLAGSHIP, device=dev)}, 4,
                              tile_threshold=10 ** 9, device=dev)["m"]["per_image"]
    tiled = report[str(FLAGSHIP)]["per_image"]
    vs_untiled = {a["image"]: {"psnr_y": abs(a["psnr_y"] - b["psnr_y"]),
                               "ssim_y": abs(a["ssim_y"] - b["ssim_y"])}
                  for a, b in zip(tiled, untiled)}
    anchors = {label: {"psnr_y": row["psnr_y"], "ssim_y": row["ssim_y"],
                       "anchor": sb._anchor_for("bicubic" if label == "bicubic" else
                                                "srresnet", "Set5", 4)}
               for label, row in report.items()}
    log(16, check="(d) standard-benchmark protocol on a stand-in set",
        images=[p.name for p in sorted((sets / "Set5").iterdir())], exit_code=code,
        bmp_bit_equal_to_png=bmp_equal, launches=launches, tiled_per_image=tiled,
        tiled_vs_untiled=vs_untiled, tol={"psnr_y": STANDIN_PSNR_TOL,
                                          "ssim_y": STANDIN_SSIM_TOL},
        stand_in_scores_beside_the_set5_anchors=anchors,
        note="four held-out gallery tiles stand in for Set5: the deltas to the "
             "anchors are no finding", card=card)
    if not (code == 0 and bmp_equal and launches["patches"] >= 1 and len(tiled) == 4
            and all(d["psnr_y"] <= STANDIN_PSNR_TOL and d["ssim_y"] <= STANDIN_SSIM_TOL
                    for d in vs_untiled.values())):
        raise AssertionError(f"the standard-benchmark stand-in failed: exit {code}, BMP "
                             f"equal {bmp_equal}, launches {launches}, {vs_untiled}")
    log(16, phase_s=time.perf_counter() - t_phase)


# ------------------------------------------------------------------ phase 17
# The denoising path: the port's JPEG encoder against PIL's bytes, the three
# committed denoising models scored on real-JPEG inputs against the JAX
# package's rows, the DCT-vs-libjpeg gap, the denoising YAML recipe with a
# fixed and a ranged noise level, the JPEG-noise campaign and both studies.
JPEG_ENCODE_MANIFEST = ROOT / "data/corpus/jpeg_encode/MANIFEST.json"
ENCODE_TIMING_IMAGE = ROOT / "data/corpus/gallery/gt_10.png"  # 768 x 448, q 75
DENOISE_MODELS = {
    "round4_noise": ROOT / "results/quality_r4/models/resnet_gen_srresnet_jpg_rq_x2_best.msgpack",
    "round4_control": ROOT / "results/quality_r4/models/resnet_gen_srresnet_ctl_x2_best.msgpack",
    "round3_noise": ROOT / "results/quality_r3/models/resnet_gen_srresnet_jpg_x2_best.msgpack",
}
DENOISE_RECIPE = ROOT / "examples/training/srresnet_denoise_x2.yaml"
DENOISE_LEVELS = {"fixed": 50, "range": [5, 70]}  # the file's level, the campaign's range
DENOISE_EPOCHS = 1
# the campaign's cut: its --fast schedule (3 epochs, 12 crops a megapixel, 8
# validation crops an image) at full width, on 4 of the 12 training tiles
CAMPAIGN_TRAIN_TILES = ("gt_11", "gt_14", "gt_2", "gt_8")
# the EMA study's cut: 1 epoch on the same 4 tiles (48 GAN steps)
EMA_EPOCHS = 1
# ensemble_reference.py (scripts/ensemble_study.py's eval_model, the five
# committed models in bf16 on the CPU; PERF.md §6): each model's row on a 64
# px crop of the held-out tile gt_6 (rows 100-163, columns 150-213), as
# (psnr_plain, psnr_y_plain, ssim_plain, psnr_ens, psnr_y_ens, ssim_ens),
# rounded to 1e-4.
# The same script scores the port on the CPU within 0.0104 dB and 3.2e-4 of
# these (bf16 sums in another order); the card is held to RESCORE_*_TOL.
ENSEMBLE_CROP = ("gt_6", (100, 164), (150, 214))
JAX_ENSEMBLE_ROWS = {
    "srresnet_x2": (27.6353, 29.0821, 0.8443,
                   28.0027, 29.5034, 0.8536),
    "srresnet128_x2": (27.9751, 29.3384, 0.8533,
                      28.4172, 29.9644, 0.8635),
    "rrdb_wide_x2": (29.8164, 30.4337, 0.8977,
                    30.2499, 30.9425, 0.9035),
    "srresnet128_x4": (22.6533, 23.1888, 0.5755,
                      23.3382, 23.8915, 0.6095),
    "rrdb_x4": (16.3783, 15.9821, 0.4012,
               17.0173, 16.5808, 0.4348),
}
# A committed model served right scores a held-out tile at or near bicubic
# (phase 17 (f) prints each plain PSNR beside bicubic's; the JAX package's
# held-out rows on baboon and comic were -0.14 and +0.17 dB from bicubic for
# results/quality_r2_x4_deep); a fault in loading or serving lands many dB
# lower. Each plain PSNR of a model not in PRE_TRUNK_FIX_MODELS must reach
# bicubic's less NEAR_BICUBIC_DB.
NEAR_BICUBIC_DB = 1.5
# rrdb_x4's file (results/quality_r2_x4_deep) was trained before the RRDB
# trunk gained its scaled inner skip, which both packages' RRDBNet apply
# today: both serve it about 10 dB under bicubic (ensemble_reference.py's
# rrdb_x4_pre_fix_trunk; tests/test_torch_studies.py). Only its crop rows
# against the JAX package's hold it.
PRE_TRUNK_FIX_MODELS = ("rrdb_x4",)
# jpg_noise_reference.py (scripts/jpg_noise_campaign.py's evaluate and
# domain_gap, the committed models in bf16 on the CPU; PERF.md §6): on the 4
# held-out tiles at each real-JPEG quality and clean. The same script scores
# the port's campaign on the CPU: all 240 numbers within 0.003 dB of PSNR,
# 0.004 dB of PSNR-Y and 1e-4 of SSIM of the JAX package's (the inputs are
# byte-equal: only the convolutions' sums differ). The card is held to
# RESCORE_*_TOL (phase 16's bounds: 12x and 10x the CPU's worst).
# tile: quality: (noise r4, control r4, bicubic, noise r3), each (psnr, psnr_y, ssim)
JAX_JPG_ROWS = {
    "gt_1": {
        "30": ((24.656, 25.43, 0.6723), (23.741, 24.649, 0.6237), (23.868, 24.806, 0.6274),
              (23.543, 24.35, 0.6277)),
        "50": ((25.443, 26.23, 0.7176), (24.523, 25.459, 0.6735), (24.463, 25.376, 0.6699),
              (23.945, 24.732, 0.6567)),
        "75": ((26.443, 27.312, 0.7742), (25.714, 26.718, 0.7426), (25.109, 25.954, 0.7172),
              (24.241, 25.014, 0.6778)),
        "90": ((27.128, 28.063, 0.8082), (27.461, 28.611, 0.8143), (25.633, 26.331, 0.7572),
              (24.392, 25.142, 0.6893)),
        "clean": ((27.341, 28.23, 0.818), (29.548, 29.99, 0.8979), (26.289, 26.473, 0.8153),
              (24.483, 25.185, 0.6943)),
    },
    "gt_10": {
        "30": ((29.038, 30.661, 0.8565), (25.863, 27.362, 0.7816), (26.207, 27.831, 0.7972),
              (26.644, 28.699, 0.8113)),
        "50": ((30.406, 32.132, 0.8838), (27.097, 28.68, 0.8169), (27.231, 28.825, 0.8302),
              (27.379, 29.629, 0.8326)),
        "75": ((31.653, 33.434, 0.9054), (28.937, 30.775, 0.8586), (28.439, 29.946, 0.866),
              (27.934, 30.391, 0.8476)),
        "90": ((32.537, 34.292, 0.92), (31.814, 34.019, 0.9056), (29.712, 30.788, 0.9014),
              (28.216, 30.778, 0.8559)),
        "clean": ((32.851, 34.406, 0.9273), (36.758, 37.307, 0.9707), (31.063, 31.11, 0.9483),
              (28.248, 30.773, 0.8598)),
    },
    "gt_13": {
        "30": ((26.774, 27.702, 0.7516), (24.818, 25.649, 0.7033), (25.014, 25.846, 0.7139),
              (24.558, 25.628, 0.7014)),
        "50": ((27.923, 28.923, 0.7922), (26.092, 27.011, 0.7548), (25.983, 26.825, 0.7598),
              (25.176, 26.254, 0.7303)),
        "75": ((28.981, 30.061, 0.8286), (27.721, 28.798, 0.8105), (27.023, 27.851, 0.8072),
              (25.579, 26.669, 0.7525)),
        "90": ((29.747, 30.893, 0.8594), (29.869, 31.075, 0.8738), (28.052, 28.724, 0.8576),
              (25.884, 26.968, 0.7681)),
        "clean": ((30.055, 31.116, 0.8727), (33.266, 33.534, 0.9474), (29.146, 29.163, 0.9086),
              (25.973, 26.993, 0.7754)),
    },
    "gt_6": {
        "30": ((24.848, 26.564, 0.6956), (22.542, 25.015, 0.5889), (22.814, 25.466, 0.6033),
              (22.975, 25.519, 0.6092)),
        "50": ((25.82, 27.685, 0.7395), (23.371, 26.087, 0.633), (23.526, 26.323, 0.6445),
              (23.48, 26.219, 0.6398)),
        "75": ((26.826, 28.848, 0.7795), (24.569, 27.629, 0.689), (24.525, 27.419, 0.6942),
              (23.933, 26.85, 0.6646)),
        "90": ((27.574, 29.776, 0.8091), (26.412, 29.994, 0.7676), (25.73, 28.408, 0.7564),
              (24.234, 27.243, 0.6798)),
        "clean": ((27.66, 29.738, 0.8171), (31.175, 32.362, 0.915), (28.205, 28.79, 0.878),
              (24.364, 27.041, 0.6851)),
    },
}
# tile: quality: (input DCT vs libjpeg, r4 noise model's output on libjpeg, on DCT)
JAX_JPG_GAP = {
    "gt_1": {"30": (42.71, 24.656, 24.648), "50": (43.32, 25.443, 25.449),
              "75": (43.75, 26.443, 26.464), "90": (44.52, 27.128, 27.131)},
    "gt_10": {"30": (41.57, 29.038, 29.037), "50": (43.04, 30.406, 30.405),
              "75": (43.88, 31.653, 31.654), "90": (44.64, 32.537, 32.548)},
    "gt_13": {"30": (40.76, 26.774, 26.778), "50": (42.56, 27.923, 27.93),
              "75": (42.96, 28.981, 28.983), "90": (43.65, 29.747, 29.745)},
    "gt_6": {"30": (41.05, 24.848, 24.843), "50": (41.6, 25.82, 25.82),
              "75": (42.06, 26.826, 26.825), "90": (42.44, 27.574, 27.575)},
}
# The DCT-vs-libjpeg input PSNR, rounded to 2 digits by the campaign: the
# libjpeg side is byte-equal by (a); the DCT degrade on the card stays within
# a level of the JAX package's at under 1e-3 of the values
# (tests/test_torch_pipeline.py). At the gap's 40-45 dB (MSE 1.4e-4 to
# 3.4e-4 on [-1, 1]) a level (2 / 255) at 1e-3 of the values, on errors of
# up to 5 levels, moves the MSE by at most 6.8e-7: 0.02 dB; with both
# roundings, 0.03. The port on the CPU equals every JAX figure
# (jpg_noise_reference.py).
DOMAIN_GAP_TOL = 0.05
ROWS_COLUMNS = ("noise_trained", "clean_control", "bicubic")


def _encode_fixtures_phase(card):
    """(a): every committed fixture's digest from the port's encoder, and
    its speed on one thread."""
    import hashlib

    from simplesr_tpu_torch.data import native_loader
    from simplesr_tpu_torch.data.image import read_rgb_u8

    manifest = json.loads(JPEG_ENCODE_MANIFEST.read_text())
    t = time.perf_counter()
    native_loader.library()
    build_s = time.perf_counter() - t
    sources, wrong = {}, []
    for entry in manifest["files"]:
        if entry["source"] not in sources:
            sources[entry["source"]] = read_rgb_u8(ROOT / entry["source"])
        top, left, h, w = entry["crop"]
        crop = np.ascontiguousarray(sources[entry["source"]][top:top + h, left:left + w])
        got = native_loader.encode_jpeg(crop, entry["quality"])
        if hashlib.sha256(got).hexdigest() != entry["sha256"] or len(got) != entry["bytes"]:
            wrong.append(Path(entry["file"]).name)
    img = read_rgb_u8(ENCODE_TIMING_IMAGE)
    encode_ms = median_ms(lambda: native_loader.encode_jpeg(img, 75))
    body = native_loader.encode_jpeg(img, 75)
    decode_ms = median_ms(lambda: native_loader.decode_bytes(body))
    mpix = img.shape[0] * img.shape[1] / 1e6
    log(17, check="(a) the JPEG encoder against PIL's bytes", fixtures=len(manifest["files"]),
        digests_equal=len(manifest["files"]) - len(wrong), wrong=wrong,
        pil_reference=f"Pillow {manifest['pil']}, libjpeg-turbo {manifest['libjpeg_turbo']}",
        library_ready_s=build_s, timing_image=ENCODE_TIMING_IMAGE.name, quality=75,
        encode_ms=encode_ms, encode_mpix_per_s_one_thread=mpix / (encode_ms / 1e3),
        decode_ms=decode_ms, decode_mpix_per_s_one_thread=mpix / (decode_ms / 1e3),
        jpeg_bytes=len(body), runs=DECODE_RUNS, card=card)
    if wrong:
        raise AssertionError(f"the JPEG encoder's bytes differ from PIL's: {wrong}")


def _rows_against_jax(r4, r3):
    """The worst |port - JAX| of PSNR, PSNR-Y and SSIM over every row."""
    worst = {"psnr": 0.0, "psnr_y": 0.0, "ssim": 0.0}
    for tile, per_q in JAX_JPG_ROWS.items():
        for q, (noise, control, bicubic, noise3) in per_q.items():
            pairs = [(r4[tile][q]["noise_trained"], noise),
                     (r4[tile][q]["clean_control"], control),
                     (r4[tile][q]["bicubic"], bicubic),
                     (r3[tile][q]["noise_trained"], noise3)]
            for got, want in pairs:
                for k, v in zip(("psnr", "psnr_y", "ssim"), want):
                    worst[k] = max(worst[k], abs(got[k] - v))
    return worst


def _ensemble_crop_rows(ensemble_study, dev, work):
    """Each committed model's ensemble-study row on ENSEMBLE_CROP, and its
    worst |card - JAX| of the PSNR and of the SSIM figures."""
    from simplesr_tpu_torch.data.image import read_rgb_u8
    from simplesr_tpu_torch.data.png import write_png

    tile, rows, cols = ENSEMBLE_CROP
    img = read_rgb_u8(str(ROOT / "data/corpus/gallery" / f"{tile}.png"))
    crop = work / "ensemble_crop.png"
    write_png(crop, np.ascontiguousarray(img[slice(*rows), slice(*cols)]))
    keys = ("psnr_plain", "psnr_y_plain", "ssim_plain", "psnr_ens", "psnr_y_ens", "ssim_ens")
    saved = ensemble_study.HELDOUT
    got, worst = {}, {}
    try:
        ensemble_study.HELDOUT = [str(crop)]
        for name, (path, scale) in ensemble_study.MODELS.items():
            (row,) = ensemble_study.eval_model(ROOT / path, scale, device=str(dev))
            got[name] = [row[k] for k in keys]
            want = JAX_ENSEMBLE_ROWS[name]
            diffs = [abs(a - b) for a, b in zip(got[name], want)]
            worst[name] = {"psnr": max(d for k, d in zip(keys, diffs) if "ssim" not in k),
                           "ssim": max(d for k, d in zip(keys, diffs) if "ssim" in k)}
    finally:
        ensemble_study.HELDOUT = saved
    return got, worst


def _bicubic_psnr(ensemble_study, probe, scale, dev):
    """Bicubic's PSNR on ``probe`` as the ensemble study makes its LR."""
    from simplesr_tpu_torch.data.image import read_img
    from simplesr_tpu_torch.ops.metrics import psnr
    from simplesr_tpu_torch.ops.resize import resize

    hr = torch.as_tensor(ensemble_study._even_crop(read_img(probe) / 255.0, scale),
                         dtype=torch.float32).to(dev)
    h, w = hr.shape[:2]
    lr = resize(hr[None], (h // scale, w // scale), method="bicubic", antialias=True)
    up = torch.clamp(resize(lr, (h, w), method="bicubic") * 2.0 - 1.0, -1.0, 1.0)
    return float(psnr((hr * 2.0 - 1.0)[None], up, max_val=2.0)[0])


def _denoise_yaml_runs(work, launches_by_path, card):
    """(d): the denoising recipe from its YAML file, cut to the gallery and
    1 epoch, with the file's fixed level and with the campaign's range."""
    import simplesr_tpu_torch.data.pipeline as pipeline_mod
    from simplesr_tpu_torch.config import _yaml
    from simplesr_tpu_torch.tools import train as train_tool

    gallery = ROOT / "data/corpus/gallery"
    spec = _yaml.load(DENOISE_RECIPE)
    reduced = {"train_data_paths": f"{spec['general']['train_data_paths']} -> {gallery} "
                                   "(16 PNGs; the recipe's DIV2K is not in the repo)",
               "results_save_path": "a temporary directory",
               "num_epochs": f"{spec['general']['num_epochs']} -> {DENOISE_EPOCHS}",
               "random_seed": "unset -> 0"}
    kept = {k: spec["general"][k] for k in ("batch_size", "crop_size", "num_crops", "scale",
                                            "augmentations", "train_val_split", "jpg_noise")}
    log(17, check="(d) the denoising recipe", recipe=str(DENOISE_RECIPE.relative_to(ROOT)),
        reduced=reduced, kept=kept, generator=spec["model"]["generator"],
        levels=DENOISE_LEVELS)
    results = {}
    for label, level in DENOISE_LEVELS.items():
        run = copy.deepcopy(spec)
        run["general"].update(train_data_paths=str(gallery), num_epochs=DENOISE_EPOCHS,
                              random_seed=0, jpg_noise_level=level,
                              results_save_path=str(work / f"denoise_{label}"))
        path = work / f"denoise_{label}.yaml"
        path.write_text(_yaml.dump(run))
        degrades = []  # (start event, end event, quality) of each call

        def timed(original):
            def wrapper(lr, quality, *a, **k):
                start_ev = torch.cuda.Event(enable_timing=True)
                end_ev = torch.cuda.Event(enable_timing=True)
                start_ev.record()
                out = original(lr, quality, *a, **k)
                end_ev.record()
                degrades.append((start_ev, end_ev, quality))
                return out
            return wrapper

        calls, seen, epochs, waits, instrumented = run_instruments()
        t = time.perf_counter()
        with patched(pipeline_mod, "jpeg_degrade", timed):
            code, launches = counted(lambda: instrumented(
                lambda: train_tool.main([str(path)])))
        run_s = time.perf_counter() - t
        launches_by_path[f"denoise_yaml_{label}"] = launches
        torch.cuda.synchronize()
        degrade_ms = [a.elapsed_time(b) for a, b, _ in degrades]
        ranged = [q for _, _, q in degrades if isinstance(q, torch.Tensor)]
        qualities = torch.cat([q.float().cpu() for q in ranged]) if ranged else None
        losses = seen["model"].histories()["train_epoch"]["generator_loss"]
        epoch_s = [b - a for a, b in epochs]
        wait_s = [sum(d for t0, d in waits if a <= t0 < b) for a, b in epochs]
        steps = calls["train_step"]
        result = {
            "exit": code, "level": level, "calls": dict(calls), "launches": launches,
            "epoch_loss": losses, "run_s": run_s, "epoch_s": epoch_s,
            "step_ms_end_to_end": sum(epoch_s) / max(steps, 1) * 1e3,
            "pipeline_wait_share": sum(wait_s) / sum(epoch_s),
            "degrade_calls": len(degrades),
            "degrade_device_ms_per_batch": {
                "median": statistics.median(degrade_ms) if degrade_ms else None,
                "max": max(degrade_ms, default=None)},
            "qualities": ({"min": qualities.min().item(), "max": qualities.max().item(),
                           "distinct": int(qualities.unique().numel())}
                          if qualities is not None else
                          sorted({float(q) for _, _, q in degrades}))}
        results[label] = result
        log(17, check=f"(d) denoising YAML run, {label} level", **result, card=card)
        fixed_ok = label != "fixed" or result["qualities"] == [100.0 - level]
        range_ok = label != "range" or (
            qualities is not None and 100 - level[1] <= qualities.min().item()
            and qualities.max().item() < 100 - level[0] and qualities.unique().numel() > 1)
        if not (code == 0 and len(losses) == DENOISE_EPOCHS and all(np.isfinite(losses))
                and steps > 0 and launches["trunk"] >= steps and len(degrades) >= steps
                and fixed_ok and range_ok):
            raise AssertionError(f"denoising YAML run ({label}): exit {code}, losses {losses}, "
                                 f"calls {calls}, launches {launches}, "
                                 f"{len(degrades)} degrades, qualities {result['qualities']}")
    return results


def denoising_phase(dev, work, launches_by_path, card):
    """Phase 17: the denoising path (see the docstring)."""
    from simplesr_tpu_torch import zoo
    from simplesr_tpu_torch.tools import ema_study, ensemble_study
    from simplesr_tpu_torch.tools import jpg_noise_campaign as jc
    from simplesr_tpu_torch.tools import quality_campaign as qc
    from simplesr_tpu_torch.train import Generator

    start("17 denoising: the JPEG encoder, the committed denoising models, the DCT gap, "
          "the denoising YAML, the JPEG-noise campaign, the ensemble and EMA studies")
    t_phase = time.perf_counter()
    seconds = {}

    # (a) the encoder
    t = time.perf_counter()
    _encode_fixtures_phase(card)
    seconds["a"] = time.perf_counter() - t

    # (b) the committed denoising models through the campaign's evaluate
    t = time.perf_counter()
    missing = [str(p.relative_to(ROOT)) for p in DENOISE_MODELS.values() if not p.exists()]
    if missing:
        raise AssertionError(f"committed denoising models missing: {missing}")
    models = {k: Generator.srresnet(2, pretrained_model_path=p, device=dev)
              for k, p in DENOISE_MODELS.items()}
    saved = jc.DEVICE, jc.EVAL_TRAIN_IMGS, jc.HELDOUT_IMGS, jc.OUT_DIR
    try:
        jc.DEVICE, jc.EVAL_TRAIN_IMGS = str(dev), {}
        jc.HELDOUT_IMGS = {k: str(ROOT / "data/corpus/gallery" / f"{k}.png")
                           for k in JAX_JPG_ROWS}
        r4, launches_r4 = counted(lambda: jc.evaluate(
            models["round4_noise"], models["round4_control"], {})["images"])
        r3, launches_r3 = counted(lambda: jc.evaluate(
            models["round3_noise"], models["round4_control"], {})["images"])
        launches_by_path["denoise_rescore_round4"] = launches_r4
        launches_by_path["denoise_rescore_round3"] = launches_r3
        worst = _rows_against_jax(r4, r3)
        tol = {"psnr": RESCORE_PSNR_TOL, "psnr_y": RESCORE_PSNR_TOL, "ssim": RESCORE_SSIM_TOL}
        log(17, check="(b) committed denoising models against the JAX package's rows",
            models={k: str(p.relative_to(ROOT)) for k, p in DENOISE_MODELS.items()},
            round4={n: {q: {c: r[q][c]["psnr"] for c in ROWS_COLUMNS} for q in r
                        if q != "heldout"} for n, r in r4.items()},
            round3_noise_psnr={n: {q: r[q]["noise_trained"]["psnr"] for q in r
                                   if q != "heldout"} for n, r in r3.items()},
            worst=worst, tol=tol, launches={"round4": launches_r4, "round3": launches_r3},
            seconds=time.perf_counter() - t, card=card)
        forwards = len(JAX_JPG_ROWS) * 5 * 2  # tiles x qualities x 2 models
        if not (sorted(r4) == sorted(r3) == sorted(JAX_JPG_ROWS)
                and all(worst[k] <= tol[k] for k in tol)):
            raise AssertionError(f"denoising rows differ from the JAX package's: {worst} "
                                 f"(bounds {tol})")
        if min(launches_r4["trunk"], launches_r3["trunk"]) < forwards:
            raise AssertionError(f"the re-score ran the trunk kernel less than once a forward: "
                                 f"{launches_r4}, {launches_r3}")
        seconds["b"] = time.perf_counter() - t

        # (c) the DCT degrade against real JPEG on the card
        t = time.perf_counter()
        gap, launches = counted(lambda: jc.domain_gap(models["round4_noise"], {})["domain_gap"])
        launches_by_path["denoise_domain_gap"] = launches
        diffs = {k: 0.0 for k in ("input", "out_on_libjpeg", "out_on_dct")}
        for tile, per_q in JAX_JPG_GAP.items():
            for q, want in per_q.items():
                row = gap[tile][q]
                got = (row["input_dct_vs_libjpeg_psnr"], row["out_psnr_on_libjpeg"],
                       row["out_psnr_on_dct"])
                for k, a, b in zip(diffs, got, want):
                    diffs[k] = max(diffs[k], abs(a - b))
        log(17, check="(c) DCT degrade vs libjpeg on the card",
            input_psnr={n: {q: r["input_dct_vs_libjpeg_psnr"] for q, r in g.items()}
                        for n, g in gap.items()},
            worst_vs_jax=diffs, tol={"input": DOMAIN_GAP_TOL, "outputs": RESCORE_PSNR_TOL},
            launches=launches, seconds=time.perf_counter() - t, card=card)
        if not (sorted(gap) == sorted(JAX_JPG_GAP) and diffs["input"] <= DOMAIN_GAP_TOL
                and max(diffs["out_on_libjpeg"], diffs["out_on_dct"]) <= RESCORE_PSNR_TOL):
            raise AssertionError(f"the domain gap differs from the JAX package's: {diffs}")
        seconds["c"] = time.perf_counter() - t
    finally:
        jc.DEVICE, jc.EVAL_TRAIN_IMGS, jc.HELDOUT_IMGS, jc.OUT_DIR = saved

    # (d) the denoising recipe from YAML, fixed level and range
    t = time.perf_counter()
    _denoise_yaml_runs(work, launches_by_path, card)
    seconds["d"] = time.perf_counter() - t

    # (e) the campaign at full width on a cut
    t = time.perf_counter()
    out = work / "jpg_campaign"
    saved = jc.DEVICE, jc.OUT_DIR, jc.TRAIN_IMGS, jc.EVAL_TRAIN_IMGS, jc.HELDOUT_IMGS
    saved_size = jc.FAST_SIZE
    try:
        jc.DEVICE, jc.OUT_DIR = str(dev), str(out)
        jc.TRAIN_IMGS = {k: saved[2][k] for k in CAMPAIGN_TRAIN_TILES}
        jc.EVAL_TRAIN_IMGS = {k: saved[2][k] for k in qc.corpus_split()[2]}
        jc.FAST_SIZE = {}  # the --fast schedule at the production width
        results, launches = counted(lambda: jc.main(fast=True))
    finally:
        jc.DEVICE, jc.OUT_DIR, jc.TRAIN_IMGS, jc.EVAL_TRAIN_IMGS, jc.HELDOUT_IMGS = saved
        jc.FAST_SIZE = saved_size
    launches_by_path["jpg_noise_campaign"] = launches
    read_back = {r: zoo._heldout_metrics(out, r) for r in ("srresnet_jpg_rq", "srresnet_ctl")}
    on_disk = json.loads((out / "RESULTS_jpg.json").read_text())
    held = [k for k, v in on_disk["images"].items() if v["heldout"]]
    log(17, check="(e) the JPEG-noise campaign",
        cut={"train_tiles": list(CAMPAIGN_TRAIN_TILES), "schedule": "--fast (3 epochs, "
             "12 crops a megapixel, 8 validation crops an image)", "width": "16 x 64"},
        heldout_psnr={n: {q: {c: r[q][c]["psnr"] for c in ROWS_COLUMNS} for q in r
                          if q != "heldout"} for n, r in on_disk["images"].items()},
        zoo_read_back=read_back, launches=launches, seconds=time.perf_counter() - t,
        card=card)
    if not (on_disk == json.loads(json.dumps(results)) and len(held) == len(jc.HELDOUT_IMGS)
            and all(v.get("heldout_images") == len(held) for v in read_back.values())
            and read_back["srresnet_jpg_rq"].get("degraded_inputs") is True
            and launches["trunk"] > 0):
        raise AssertionError(f"the JPEG-noise campaign: held-out {held}, zoo {read_back}, "
                             f"launches {launches}")
    seconds["e"] = time.perf_counter() - t

    # (f) the ensemble study over the committed models, and the EMA study
    t = time.perf_counter()
    report, launches = counted(lambda: ensemble_study.main(
        ["--out", str(work / "ensemble"), "--device", str(dev)]))
    launches_by_path["ensemble_study"] = launches
    crop_rows, crop_worst = _ensemble_crop_rows(ensemble_study, dev, work)
    bicubic = {(Path(probe).name, scale): _bicubic_psnr(ensemble_study, probe, scale, dev)
               for probe in ensemble_study.HELDOUT for scale in (2, 4)}
    to_bicubic = {
        k: {r["probe"]: r["psnr_plain"] - bicubic[r["probe"], ensemble_study.MODELS[k][1]]
            for r in rows} for k, rows in report["models"].items()}
    log(17, check="(f) the ensemble study", models={
        k: [{key: r[key] for key in ("probe", "psnr_plain", "psnr_ens", "dpsnr", "ssim_plain",
                                     "ssim_ens")} for r in rows]
        for k, rows in report["models"].items()}, cost=report["cost"],
        plain_minus_bicubic_db=to_bicubic, near_bicubic_db=NEAR_BICUBIC_DB,
        pre_trunk_fix_models=list(PRE_TRUNK_FIX_MODELS),
        crop_rows_vs_jax={"crop": ENSEMBLE_CROP, "worst": crop_worst,
                          "tol": {"psnr": RESCORE_PSNR_TOL, "ssim": RESCORE_SSIM_TOL}},
        launches=launches, seconds=time.perf_counter() - t, card=card)
    if not (sorted(report["models"]) == sorted(ensemble_study.MODELS)
            and all(len(rows) == len(ensemble_study.HELDOUT) for rows in report["models"].values())
            and report["cost"].get("timer") == "cuda_events" and launches["trunk"] > 0):
        raise AssertionError(f"the ensemble study: {sorted(report['models'])}, cost "
                             f"{report['cost']}, launches {launches}")
    far = {k: d for k, d in to_bicubic.items()
           if k not in PRE_TRUNK_FIX_MODELS and min(d.values()) < -NEAR_BICUBIC_DB}
    if far:
        raise AssertionError(f"the ensemble study: models more than {NEAR_BICUBIC_DB} dB under "
                             f"bicubic on a held-out tile: {far}")
    if not (sorted(crop_rows) == sorted(JAX_ENSEMBLE_ROWS)
            and all(crop_worst[k]["psnr"] <= RESCORE_PSNR_TOL
                    and crop_worst[k]["ssim"] <= RESCORE_SSIM_TOL for k in crop_worst)):
        raise AssertionError(f"the ensemble study's crop rows differ from the JAX package's: "
                             f"{crop_worst}")
    seconds["f_ensemble"] = time.perf_counter() - t
    t = time.perf_counter()
    saved_train = qc.TRAIN_IMGS
    try:
        qc.TRAIN_IMGS = {k: saved_train[k] for k in CAMPAIGN_TRAIN_TILES}
        ema, launches = counted(lambda: ema_study.main(
            ["--epochs", str(EMA_EPOCHS), "--out", str(work / "ema"), "--device", str(dev)]))
    finally:
        qc.TRAIN_IMGS = saved_train
    launches_by_path["ema_study"] = launches
    log(17, check="(f) the EMA study", cut={"train_tiles": list(CAMPAIGN_TRAIN_TILES),
                                            "epochs": EMA_EPOCHS},
        history=ema["history"], summary=ema["summary"], launches=launches,
        seconds=time.perf_counter() - t, card=card)
    last = ema["history"][-1]
    if not (len(ema["history"]) == EMA_EPOCHS
            and sorted(last["raw"]) == sorted(qc.HELDOUT_GALLERY)
            and all(np.isfinite(last[w][n]["psnr"]) for w in ("raw", "ema") for n in last["raw"])
            and launches["trunk"] > 0):
        raise AssertionError(f"the EMA study: {last}, launches {launches}")
    seconds["f_ema"] = time.perf_counter() - t
    log(17, parts_s=seconds, phase_s=time.perf_counter() - t_phase)


# ------------------------------------------------------------------ phase 18
# The formats PIL opens for the JAX package beside PNG and JPEG, and the
# JPEG processes beside baseline: host decoders of the port's own
# (csrc/host/loader.cpp, webp.cpp, gif.cpp, tiff.cpp, psd.cpp and the
# texture formats'; data/pnm.py, data/bmp.py, data/ico.py), held to the
# digests of PIL's decodes that the corpora's manifests keep (there is no
# PIL on the card's machine), timed, and served.

FORMATS_MANIFEST = ROOT / "data/corpus/image_formats/MANIFEST.json"
TEXTURES_MANIFEST = ROOT / "data/corpus/texture_formats/MANIFEST.json"
LAYERED_MANIFEST = ROOT / "data/corpus/psd_dib_anim/MANIFEST.json"
FORMAT_BODIES = {"webp_lossy": "timing_webp_lossy.webp",
                 "webp_lossless": "timing_webp_lossless.webp", "gif": "timing_gif.gif",
                 "tiff_lzw": "timing_tiff_lzw.tif", "ppm": "timing_ppm.ppm",
                 "bmp_rle8": "timing_bmp_rle8.bmp", "jpeg_arith": "timing_jpeg_arith.jpg",
                 "jpeg_lossless": "timing_jpeg_lossless.jpg", "tiff_jpeg": "timing_tiff_jpeg.tif"}
# timed beside the served bodies: the same tile as a baseline JPEG that PIL
# wrote, a progressive JPEG that libjpeg smooths, and the other TIFF variants
TIMED_BODIES = {"jpeg_baseline_pil": "timing_jpeg_baseline.jpg",
                "jpeg_smoothed": "timing_jpeg_smooth.jpg", "tiff_ycbcr": "timing_tiff_ycbcr.tif",
                "tiff_cmyk": "timing_tiff_cmyk.tif", "tiff_float32": "timing_tiff_float32.tif",
                "tiff_cielab": "timing_tiff_cielab.tif", "bigtiff": "timing_tiff_bigtiff.tif"}
# slice 15's formats, the tile in data/corpus/texture_formats: served, then timed only
TEXTURE_BODIES = {"dds_bc7": "timing_dds_bc7.dds", "tga_rle": "timing_tga_rle.tga",
                  "ico_png": "timing_ico_png.ico"}
TEXTURE_TIMED = {"dds_bc1": "timing_dds_bc1.dds", "cur_dib8": "timing_cur_dib8.cur",
                 "qoi": "timing_qoi.qoi", "pcx_rgb": "timing_pcx_rgb.pcx",
                 "dcx_p": "timing_dcx_p.dcx", "sgi_rle": "timing_sgi_rle.sgi"}
# slice 17's formats, the tile in data/corpus/psd_dib_anim: served, then timed only
LAYERED_BODIES = {"webp_animated": "timing_webp_anim.webp",
                  "psd_rgb_packbits": "timing_psd_rgb_packbits.psd", "dib": "timing_dib_rgb24.dib"}
LAYERED_TIMED = {"psd_cmyk_raw": "timing_psd_cmyk_raw.psd",
                 "psd_lab_packbits": "timing_psd_lab_packbits.psd"}
LARGE_TEXTURE = 1024  # the (d) texture's side: over upscale_files' 1000-pixel threshold
LARGE_TEXTURE_SEED = 15
# The flagship's receptive field reaches 39.5 LR px from a pixel (the 9 x 9
# head 4, 32 trunk convs 32, the trunk conv 1, the tail's convs 2.5), past
# the tiled route's 32 px overlap by 7.5: within that of a seam between
# tiles a pixel's output sees other context tiled than untiled, and within
# 39.5 of the image's edge the route's zero padding of the image differs
# from each conv's own (test_torch_rrdb.py states the route's equality away
# from both for a model inside the overlap). (d) holds the rest to the
# route's bounds (ROUTE_*_TOL) and reports the bands.
LARGE_SEAM_BAND = 32   # HR px each side of a seam (7.5 LR px, rounded up)
LARGE_EDGE_BAND = 160  # HR px at the image's edges (39.5 LR px, rounded up)


def seeded_bc1_texture(side, seed):
    """A ``side`` x ``side`` DDS of BC1 blocks (DXT1): each block's two
    colours from a seeded coarse field of colours, bilinearly spread over
    the blocks, with seeded offsets and indices. The (d) texture of phase
    18; no committed file."""
    rng = np.random.default_rng(seed)
    blocks = side // 4
    coarse = rng.integers(0, 256, (9, 9, 3)).astype(np.float64)
    t = np.linspace(0, 8, blocks)
    i0 = np.minimum(t.astype(int), 7)
    f = (t - i0)[:, None, None]
    rows = coarse[i0] * (1 - f) + coarse[i0 + 1] * f  # (blocks, 9, 3)
    f = (t - i0)[None, :, None]
    field = rows[:, i0] * (1 - f) + rows[:, i0 + 1] * f  # (blocks, blocks, 3)

    def rgb565(c):
        c = np.clip(c, 0, 255).astype(np.int64)
        return (c[..., 0] >> 3 << 11) | (c[..., 1] >> 2 << 5) | (c[..., 2] >> 3)

    c0 = rgb565(field + rng.integers(0, 24, field.shape))
    c1 = rgb565(field - rng.integers(0, 24, field.shape))
    out = np.zeros((blocks, blocks, 8), np.uint8)
    out[..., 0:2] = np.maximum(c0, c1).astype("<u2")[..., None].view(np.uint8)
    out[..., 2:4] = np.minimum(c0, c1).astype("<u2")[..., None].view(np.uint8)
    out[..., 4:8] = rng.integers(0, 256, (blocks, blocks, 4), dtype=np.uint8)
    head = b"DDS " + struct.pack("<7I", 124, 0x1007, side, side, 0, 0, 0) + bytes(44)
    head += struct.pack("<4I", 32, 0x4, struct.unpack("<I", b"DXT1")[0], 0) + bytes(16)
    head += struct.pack("<5I", 0x1000, 0, 0, 0, 0)
    return head + out.tobytes()


def image_formats_phase(dev, work, launches_by_path, card):
    """Phase 18: the image formats (see the docstring). Returns the
    decoders' summary, which ``main`` prints with the host loader's."""
    import hashlib

    from simplesr_tpu_torch.data.image import decode_image
    from simplesr_tpu_torch.data.native_loader import encode_jpeg
    from simplesr_tpu_torch.data.png import decode_png, encode_png, read_png
    from simplesr_tpu_torch.tools import serve as serve_mod
    from simplesr_tpu_torch.tools.http_gateway import serve_http
    from simplesr_tpu_torch.eval.evaluation import _as_predictor
    from simplesr_tpu_torch.tools.upscale import upscale_files

    start("18 image formats: WebP (still and animated), GIF, TIFF, netpbm, RLE BMP, DIB, the "
          "JPEG processes, PSD, DDS, TGA, ICO, CUR, QOI, PCX, DCX and SGI decoded, timed and "
          "served")
    t_phase = time.perf_counter()

    # (a) every fixture against its digest of PIL's decode, the refusals
    manifest = json.loads(FORMATS_MANIFEST.read_text())
    textures = json.loads(TEXTURES_MANIFEST.read_text())
    layered = json.loads(LAYERED_MANIFEST.read_text())
    wrong, counts, refusals = [], {}, {}
    for entry in manifest["files"] + textures["files"] + layered["files"]:
        data = (ROOT / entry["file"]).read_bytes()
        try:
            got = hashlib.sha256(decode_image(data, entry["file"]).tobytes()).hexdigest()
            ok = "refused" not in entry and got == entry["sha256_pil_rgb"]
        except ValueError as e:
            ok = "refused" in entry and entry["refused"] in str(e)
            refusals[Path(entry["file"]).name] = str(e)
        if not ok:
            wrong.append(entry["file"])
        kind = "refused" if "refused" in entry else entry["format"]
        counts[kind] = counts.get(kind, 0) + 1
    folder = FORMATS_MANIFEST.parent
    tile = decode_image((folder / FORMAT_BODIES["ppm"]).read_bytes())
    bodies = {"png": encode_png(tile), "jpeg_q90": encode_jpeg(tile, 90)}
    bodies.update({k: (folder / f).read_bytes()
                   for k, f in {**FORMAT_BODIES, **TIMED_BODIES}.items()})
    bodies.update({k: (TEXTURES_MANIFEST.parent / f).read_bytes()
                   for k, f in {**TEXTURE_BODIES, **TEXTURE_TIMED}.items()})
    bodies.update({k: (LAYERED_MANIFEST.parent / f).read_bytes()
                   for k, f in {**LAYERED_BODIES, **LAYERED_TIMED}.items()})
    mpix = tile.shape[0] * tile.shape[1] / 1e6
    rates = {}
    for kind, body in bodies.items():
        ms = median_ms(lambda: decode_image(body, kind))
        rates[kind] = {"ms": ms, "mpix_per_s": mpix / ms * 1e3, "bytes": len(body)}
    log(18, check="(a) the corpus against its manifest's digests of PIL's decode, and each "
        f"decoder on one thread (median of {DECODE_RUNS}) on a {tile.shape[0]} x "
        f"{tile.shape[1]} gallery tile", files=counts,
        pil=[manifest["pil"], textures["pil"], layered["pil"]],
        wrong=wrong,
        refusals=refusals, decode=rates, card=card)
    if wrong:
        raise AssertionError(f"fixtures decoded unlike PIL: {wrong}")

    # (b) the daemon and the gateway against upscale_files, (c) a truncated WebP
    serve_dir = work / "formats_serve"
    serve_dir.mkdir()
    paths = []
    for kind, name in {**FORMAT_BODIES, **TEXTURE_BODIES, **LAYERED_BODIES}.items():
        path = serve_dir / f"{kind}{Path(name).suffix}"
        path.write_bytes(bodies[kind])
        paths.append(path)
    refs = [read_png(p) for p in upscale_files(FLAGSHIP, paths, serve_dir / "ref", 4,
                                               device=dev)]
    broken = bodies["webp_lossy"][:len(bodies["webp_lossy"]) // 2]
    cwd = os.getcwd()
    os.chdir(serve_dir)  # a short, relative socket path
    ready, stop = threading.Event(), threading.Event()
    server = threading.Thread(target=serve_mod.serve, args=(FLAGSHIP, 4), daemon=True,
                              kwargs=dict(socket_path="sr.sock", ready_event=ready,
                                          stop_event=stop, device=dev))
    server.start()
    try:
        if not ready.wait(300):
            raise AssertionError("the daemon did not become ready")

        def session():
            with serve_mod.SRClient("sr.sock") as client:
                outs = [client.upscale_file(p) for p in paths]
                try:
                    client.upscale_bytes(broken)
                    stub = "status 0"
                except serve_mod.SRError as e:
                    stub = str(e)
            return outs, stub

        (daemon_outs, daemon_stub), daemon_launches = counted(session)
    finally:
        stop.set()
        server.join(timeout=60)
        os.chdir(cwd)
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))  # localhost only

    def post(url, body):
        try:
            with opener.open(urllib.request.Request(url, data=body), timeout=120) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    ready, stop, box = threading.Event(), threading.Event(), {}
    gateway = threading.Thread(target=serve_http, args=(FLAGSHIP, 4, 0), daemon=True, kwargs=dict(
        ready_event=ready, stop_event=stop, on_server=lambda srv: box.update(s=srv), device=dev))
    gateway.start()
    try:
        if not ready.wait(300):
            raise AssertionError("the gateway did not become ready")
        url = f"http://127.0.0.1:{box['s'].server_address[1]}/upscale"
        replies, http_launches = counted(lambda: [post(url, p.read_bytes()) for p in paths])
        broken_code, broken_body = post(url, broken)
    finally:
        stop.set()
        gateway.join(timeout=60)
    launches_by_path["daemon_image_formats_session"] = daemon_launches
    launches_by_path["http_gateway_image_formats_posts"] = http_launches
    gateway_outs = [decode_png(body) if code == 200 else None for code, body in replies]
    result = {
        "bodies": list(FORMAT_BODIES) + list(TEXTURE_BODIES) + list(LAYERED_BODIES),
        "daemon_bit_equal": [np.array_equal(o, r) for o, r in zip(daemon_outs, refs)],
        "gateway_status": [code for code, _ in replies],
        "gateway_bit_equal": [o is not None and np.array_equal(o, r)
                              for o, r in zip(gateway_outs, refs)],
        "truncated_webp": {"daemon": daemon_stub,
                           "gateway": [broken_code, broken_body.decode()[:120]]},
        "launches": {"daemon": daemon_launches, "gateway": http_launches},
        "stopped": not (server.is_alive() or gateway.is_alive())}
    log(18, check="(b, c) serving each format's body, and a truncated WebP", **result,
        phase_s=time.perf_counter() - t_phase, card=card)
    want = {"trunk": len(paths), "patches": 0}
    if not (all(result["daemon_bit_equal"]) and all(result["gateway_bit_equal"])
            and "WebP" in daemon_stub and broken_code == 400 and b"WebP" in broken_body
            and result["stopped"] and daemon_launches == want and http_launches == want):
        raise AssertionError(f"serving the image formats: {result}")

    # (d) a large texture through the tiled route, against the untiled upscale
    large = serve_dir / "large_bc1.dds"
    large.write_bytes(seeded_bc1_texture(LARGE_TEXTURE, LARGE_TEXTURE_SEED))
    t = time.perf_counter()
    (written,), tiled_launches = counted(
        lambda: upscale_files(FLAGSHIP, [large], serve_dir / "large", 4, device=dev))
    tiled_s = time.perf_counter() - t
    launches_by_path["upscale_files_large_dds_tiled"] = tiled_launches
    lr = torch.from_numpy(decode_image(large.read_bytes()).astype(np.float32) / 255.0).to(dev)
    predict = _as_predictor(FLAGSHIP, device=dev)
    with torch.no_grad():
        untiled, untiled_launches = counted(lambda: (predict(lr[None])[0] + 1.0) / 2.0)
    tiled = torch.from_numpy(read_png(written).astype(np.float32) / 255.0).to(dev)
    untiled = (untiled * 255.0).clamp(0, 255).floor() / 255.0  # as upscale_files writes it
    side = 4 * LARGE_TEXTURE
    pos = torch.arange(side, device=dev)
    edge = (pos >= LARGE_EDGE_BAND) & (pos < side - LARGE_EDGE_BAND)
    core = 4 * 128  # the route's tile, in HR px
    away = edge & (pos % core >= LARGE_SEAM_BAND) & (pos % core < core - LARGE_SEAM_BAND)
    keep = away[:, None] & away[None, :]
    diff = ((tiled - untiled) * 2.0).abs().amax(-1)  # on the route's [-1, 1] scale
    large_result = {
        "texture": [LARGE_TEXTURE, LARGE_TEXTURE], "format": "DDS BC1 (DXT1)",
        "seed": LARGE_TEXTURE_SEED, "out": list(tiled.shape),
        "launches": {"tiled": tiled_launches, "untiled": untiled_launches},
        "seconds_tiled": tiled_s,
        "away_from_bands": {"share": keep.float().mean().item(),
                            "max_abs": diff[keep].max().item(),
                            "mean_abs": diff[keep].mean().item()},
        "bands": {"max_abs": diff[~keep].max().item(), "mean_abs": diff[~keep].mean().item()},
        "tol": {"max_abs": ROUTE_MAX_ABS_TOL, "mean_abs": ROUTE_MEAN_ABS_TOL}}
    log(18, check="(d) a seeded 1024 x 1024 BC1 texture through upscale_files: the tiled "
        "route against the untiled upscale of the same decoded array", **large_result,
        card=card)
    del lr, untiled, tiled, diff
    away_from = large_result["away_from_bands"]
    if not (tiled_launches["patches"] == 1 and tiled_launches["trunk"] >= 1
            and untiled_launches == {"trunk": 1, "patches": 0}
            and away_from["max_abs"] < ROUTE_MAX_ABS_TOL
            and away_from["mean_abs"] < ROUTE_MEAN_ABS_TOL):
        raise AssertionError(f"the large texture's tiled route: {large_result}")
    return {"name": "host image-format decoders", "route": "host C++ (g++, zlib) and numpy",
            "source": ["simplesr_tpu_torch/csrc/host/loader.cpp",
                       "simplesr_tpu_torch/csrc/host/webp.cpp",
                       "simplesr_tpu_torch/csrc/host/gif.cpp",
                       "simplesr_tpu_torch/csrc/host/tiff.cpp",
                       "simplesr_tpu_torch/csrc/host/dds.cpp",
                       "simplesr_tpu_torch/csrc/host/psd.cpp",
                       "simplesr_tpu_torch/csrc/host/tga.cpp",
                       "simplesr_tpu_torch/csrc/host/qoi.cpp",
                       "simplesr_tpu_torch/csrc/host/pcx.cpp",
                       "simplesr_tpu_torch/csrc/host/sgi.cpp",
                       "simplesr_tpu_torch/data/pnm.py", "simplesr_tpu_torch/data/bmp.py",
                       "simplesr_tpu_torch/data/ico.py"],
            "replaces": "PIL's convert('RGB') (simplesr_tpu/data/pipeline.py:57-72, "
                        "simplesr_tpu/tools/serve.py:319, simplesr_tpu/tools/http_gateway.py:90)",
            "fixtures": counts, "tile": list(tile.shape),
            "one_thread_mpix_per_s": {k: v["mpix_per_s"] for k, v in rates.items()},
            "phase_s": time.perf_counter() - t_phase}


MEASURE_TAIL_SHAPE = (2, 64)   # batch, LR side of the tail forms' check and timing
MEASURE_TRUNK = ("4", "64", "5")  # batch, side, runs: 16 blocks x 64 filters
# remat must lower the step's peak: batch 4 of 96^2 crops, where the
# trunk's stored activations, not the HR tail's, dominate what the step holds
MEASURE_REMAT = ["--configs", "srresnet:16,rrdb:8", "--batch", "4", "--crop", "96"]
MEASURE_BF16_QUALITY = {"n_train": 64, "n_val": 16}
MEASURE_HOST_CROPS = 8
MEASURE_SERVE = ["4", "1", "--daemon-clients", "2"]
MEASURE_SERVE_CUTS = {"MAX_BATCH": 4, "LR_HW": 64}  # fewer, smaller buckets to warm


def _finite_rows(tool, rows, keys):
    """Each row has ``keys`` and every number in it is finite."""
    if not rows:
        raise AssertionError(f"{tool}: no rows")
    for row in rows:
        missing = [k for k in keys if k not in row]
        bad = {k: v for k, v in row.items() if isinstance(v, float) and not np.isfinite(v)}
        if missing or bad:
            raise AssertionError(f"{tool}: row {row} lacks {missing} or has {bad}")


def measurement_phase(dev, work, launches_by_path, card):
    """Phase 19: the measurement and study tools at cut sizes (see the
    docstring); returns each tool's launches and seconds."""
    from simplesr_tpu_torch.models import RRDBNet, SRResNet
    from simplesr_tpu_torch.tools import (bench_rrdb_tail, bench_trunk_kernel,
                                          bench_upsample_tail, bf16_grad_study,
                                          host_assembly_profile, remat_study, train_roofline)

    start("19 measurement and study tools")
    summary = {}

    def tool(name, run, keys):
        t = time.perf_counter()
        rows, launches = counted(run)
        launches_by_path[f"tool_{name}"] = launches
        summary[name] = {"launches": launches, "seconds": time.perf_counter() - t}
        _finite_rows(name, rows, keys)
        return rows

    rows = tool("bench_trunk_kernel", lambda: bench_trunk_kernel.main(list(MEASURE_TRUNK)),
                ("kernel", "ms_per_fwd", "device_ms", "tflops_per_s", "bound_ms", "card"))
    if [r["kernel"] for r in rows] != ["trunk_cuda", "cudnn_channels_last", "plain"]:
        raise AssertionError(f"bench_trunk_kernel rows {rows}")
    log(19, tool="bench_trunk_kernel", rows=rows)

    # (b) the tail forms: each equal to the model's own tail on the card
    batch, side = MEASURE_TAIL_SHAPE
    torch.manual_seed(SEED)
    form_err = {}
    for model, build in ((SRResNet(4, batch_norm=False), bench_upsample_tail.srresnet_tail_forms),
                         (RRDBNet(4, num_rrdb_blocks=1), bench_rrdb_tail.rrdb_tail_forms)):
        model = model.to(dev).eval()
        forms, _, _ = build(model)
        x = bench_upsample_tail.features(batch, side, model.dtype, dev)
        with torch.inference_mode():
            ref = model.tail(x)
            for name, fn in forms.items():
                diff = (fn(x) - ref).abs()
                form_err[name] = {"max_abs": diff.max().item(), "mean_abs": diff.mean().item()}
    log(19, check="tail forms vs the model's tail", shape=[batch, 64, side, side],
        errors=form_err, tol_max_abs=POLY_MAX_ABS_TOL, tol_mean_abs=POLY_MEAN_ABS_TOL)
    for name, d in form_err.items():
        if not (d["max_abs"] < POLY_MAX_ABS_TOL and d["mean_abs"] < POLY_MEAN_ABS_TOL):
            raise AssertionError(f"tail form {name} differs from the model's tail: {d}")
    shape = [str(batch), str(side), "5"]
    for name, module in (("bench_upsample_tail", bench_upsample_tail),
                         ("bench_rrdb_tail", bench_rrdb_tail)):
        rows = tool(name, lambda: module.main(shape), ("stage", "ms", "card"))
        log(19, tool=name, rows=rows)

    # (d) remat: lower peak memory and fewer saved bytes
    rows = tool("remat_study", lambda: remat_study.main(MEASURE_REMAT),
                ("arch", "remat", "peak_bytes", "peak_excess_bytes", "saved_bytes"))
    log(19, tool="remat_study", rows=rows)
    for plain, remat in zip(rows[::2], rows[1::2]):
        if not (remat["peak_bytes"] < plain["peak_bytes"]
                and remat["saved_bytes"] < plain["saved_bytes"]):
            raise AssertionError(f"remat does not lower {plain['arch']}'s memory: {plain}, "
                                 f"{remat}")

    rows = tool("train_roofline", lambda: train_roofline.main(
        ["--fast", "--out", str(work / "train_roofline")]),
        ("step_ms", "fwd_ms", "step_tflops", "step_tc_util", "fwd_tflops"))
    log(19, tool="train_roofline", rows=rows)

    with patched(bf16_grad_study, "QUALITY", lambda q: {**q, **MEASURE_BF16_QUALITY}):
        result = tool("bf16_grad_study", lambda: [bf16_grad_study.main(
            ["--steps", "3", "--epochs", "1", "--out", str(work / "bf16")])], ("variants",))
    variants = result[0]["variants"]
    _finite_rows("bf16_grad_study", list(variants.values()),
                 ("final_val_psnr_x2", "val_psnr_curve_x2"))
    log(19, tool="bf16_grad_study", variants=variants)

    with patched(host_assembly_profile, "NUM_CROPS", lambda n: MEASURE_HOST_CROPS):
        rows = tool("host_assembly_profile", lambda: [host_assembly_profile.main(
            ["--out", str(work / "host_assembly")])],
            ("decode_cold_s", "crop_bank_mpix_s", "stack_mpix_s", "prepare_mpix_s",
             "workers=1 (host path)", "device-resident pool"))
    log(19, tool="host_assembly_profile", result=rows[0])

    with contextlib.ExitStack() as cuts:
        for name, value in MEASURE_SERVE_CUTS.items():
            cuts.enter_context(patched(bench_serve, name, lambda _, v=value: v))
        rows = tool("bench_serve", lambda: bench_serve.main(MEASURE_SERVE + ["--model",
                                                                             str(FLAGSHIP)]),
                    ("stage", "clients", "requests_per_s", "latency_ms_p50", "latency_ms_p95"))
    log(19, tool="bench_serve", rows=rows)
    stages = {r["stage"] for r in rows}
    if any(r["failed"] for r in rows):
        raise AssertionError(f"bench_serve: failed requests {rows}")
    if stages != {"engine_f32", "engine_u8", "engine_u8_paired2", "socket_png_persistent",
                  "socket_png_reconnect", "http_png_keepalive"}:
        raise AssertionError(f"bench_serve stages {stages}")
    log(19, summary=summary, card=card)
    for name in ("bench_trunk_kernel", "train_roofline", "bf16_grad_study", "bench_serve"):
        if not summary[name]["launches"]["trunk"]:
            raise AssertionError(f"{name} launched no trunk kernel: {summary[name]}")
    return summary


def io_stderr(run):
    """What ``run()`` writes to stderr before it exits (argparse's error)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stderr(buf):
        try:
            run()
        except SystemExit:
            pass
    return buf.getvalue()


def main(work):
    from simplesr_tpu_torch.data.image import read_img
    from simplesr_tpu_torch.data.png import read_png, write_png
    from simplesr_tpu_torch.eval.evaluation import (_TILE_BATCH, _TILE_OVERLAP, _TILE_PATCH,
                                                    _as_predictor, _upscale)
    from simplesr_tpu_torch.ops.kernels import (_build, extract_overlapping_patches,
                                                extract_overlapping_patches_reference,
                                                residual_trunk, residual_trunk_reference)
    from simplesr_tpu_torch.ops.kernels.trunk import (TrunkWeights, pack_trunk_weights,
                                                      swizzle_trunk_weights)
    from simplesr_tpu_torch.ops.tiling import _pad_amounts
    from simplesr_tpu_torch.tools.serve import SREngine
    from simplesr_tpu_torch.tools.upscale import upscale_files
    from simplesr_tpu_torch.train.serialization import load_model

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    t_all = time.perf_counter()

    start("0 device")
    card_name = torch.cuda.get_device_name(0)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = [f"{card_name}, power limit not read ({type(e).__name__})"]
    smi_line = smi[0] if smi else f"{card_name}, power limit not read (nvidia-smi gave nothing)"
    print(smi_line, flush=True)
    log(0, device=card_name, count=torch.cuda.device_count(), nvidia_smi=smi_line,
        torch=torch.__version__, cuda=torch.version.cuda,
        cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)

    start("1 build")
    t = time.perf_counter()
    built = not _build.library_path().exists()
    _build.library()
    log(1, build_s=round(time.perf_counter() - t, 2), built_now=built,
        library=_build.library_path().name)

    start("2 trunk kernel vs plain")
    model = load_model(FLAGSHIP, device=dev)
    weights = model.trunk_weights()
    lr_batch = torch.rand(TRUNK_SHAPE + (3,), generator=gen).to(dev)
    with torch.inference_mode():
        h = lr_batch.permute(0, 3, 1, 2).to(torch.bfloat16)
        trunk_in = model.head_act(model.head(h)).permute(0, 2, 3, 1).contiguous()
        block_rel, trunk_err, block_in = [], 0.0, trunk_in
        for blk in range(len(model.blocks)):
            one = TrunkWeights(*(t[blk:blk + 1] for t in weights))
            got = residual_trunk(block_in, one)
            torch.cuda.synchronize()
            block_in = residual_trunk_reference(block_in, one)
            rel, _, err = rel_errors(got, block_in)
            block_rel.append(rel)
            trunk_err = max(trunk_err, err)
        chain = residual_trunk(trunk_in, weights)
        torch.cuda.synchronize()
        exact = trunk_float64(trunk_in, weights)
        chain_vs_plain = rel_errors(chain, block_in)
        chain_vs_exact = rel_errors(chain, exact)
        plain_vs_exact = rel_errors(block_in, exact)
    log(2, shape=list(trunk_in.shape), blocks=len(model.blocks),
        per_block_max_rel=max(block_rel), per_block_max_abs=trunk_err, tol=TRUNK_REL_TOL,
        chain_max_rel_fro_rel={"kernel_vs_plain": chain_vs_plain[:2],
                               "kernel_vs_float64": chain_vs_exact[:2],
                               "plain_vs_float64": plain_vs_exact[:2]},
        chain_fro_ratio_tol=TRUNK_CHAIN_FRO_RATIO)
    if not max(block_rel) < TRUNK_REL_TOL:
        raise AssertionError(f"trunk kernel disagrees with its plain version: {block_rel}")
    if not chain_vs_exact[1] <= TRUNK_CHAIN_FRO_RATIO * plain_vs_exact[1]:
        raise AssertionError(f"trunk kernel chain less accurate than the plain version: "
                             f"{chain_vs_exact} vs {plain_vs_exact}")
    for shape in TRUNK_EDGE_SHAPES:
        edge_rel = []
        with torch.inference_mode():
            lr = torch.rand(shape + (3,), generator=gen).to(dev)
            x = model.head_act(model.head(lr.permute(0, 3, 1, 2).to(torch.bfloat16)))
            x = x.permute(0, 2, 3, 1).contiguous()
            for blk in range(len(model.blocks)):
                one = TrunkWeights(*(t[blk:blk + 1] for t in weights))
                got = residual_trunk(x, one)
                torch.cuda.synchronize()
                x = residual_trunk_reference(x, one)
                edge_rel.append(rel_errors(got, x)[0])
        log(2, shape=list(shape) + [trunk_in.shape[-1]], blocks=len(model.blocks),
            per_block_max_rel=max(edge_rel), tol=TRUNK_REL_TOL)
        if not max(edge_rel) < TRUNK_REL_TOL:
            raise AssertionError(f"trunk kernel disagrees with its plain version at {shape}: "
                                 f"{edge_rel}")

    start("3 patch kernel vs plain")
    # A 1100 x 1040 LR PNG from a gallery picture, resized and with seeded
    # noise; the main path reads it back as upscale_files does.
    tiled_img = F.interpolate(
        torch.from_numpy(read_png(ROOT / "data/corpus/gallery/gt_1.png")).permute(2, 0, 1)
        [None].float(), size=TILED_HW, mode="bilinear", align_corners=False)[0]
    tiled_img = (tiled_img.permute(1, 2, 0)
                 + 5.0 * torch.randn(tiled_img.shape[1:] + (3,), generator=gen)).clamp(0, 255)
    tiled_png = work / "tiled_lr.png"
    write_png(tiled_png, tiled_img.to(torch.uint8).numpy())
    tiled_lr = torch.from_numpy(read_img(tiled_png) / 255.0).to(dev)
    patch_err = 0.0
    unaligned = torch.rand((517, 389, 3), generator=gen).to(dev)
    for img, p, o in ((tiled_lr, _TILE_PATCH, _TILE_OVERLAP), (unaligned, 50, 8)):
        h_, w_, c_ = img.shape
        (top, bottom), (left, right) = _pad_amounts(h_, w_, p, p, o)
        padded = F.pad(img, (0, 0, left, right, top, bottom))
        if img is tiled_lr:
            padded_main = padded
        got = extract_overlapping_patches(padded, p, p, o)
        torch.cuda.synchronize()
        ref = extract_overlapping_patches_reference(padded, p, p, o)
        if got.shape != ref.shape or not torch.equal(got, ref):
            raise AssertionError(f"patch kernel is not bit-exact at {(h_, w_, c_)}, {p}/{o}")
        patch_err = max(patch_err, (got - ref).abs().max().item())
        if img is tiled_lr:
            n_tiles = got.shape[0]
        log(3, image=[h_, w_, c_], patch=p, overlap=o, patches=list(got.shape),
            bit_exact=True)

    start("4 main path: upscale_files, untiled gallery PNG and tiled LR PNG")
    launches_by_path = {}
    out_dir = work / "out"
    for label, png in (("upscale_files_untiled", GALLERY_PNG),
                       ("upscale_files_tiled", tiled_png)):
        t = time.perf_counter()
        (written,), launches = counted(lambda: upscale_files(FLAGSHIP, [png], out_dir, 4,
                                                             device=dev))
        launches_by_path[label] = launches
        log(4, path=label, launches=launches, seconds=round(time.perf_counter() - t, 3),
            written=Path(written).name)
    tiled_batches = -(-n_tiles // _TILE_BATCH)
    expected = {"upscale_files_untiled": {"trunk": 1, "patches": 0},
                "upscale_files_tiled": {"trunk": tiled_batches, "patches": 1}}
    for label, want in expected.items():
        if launches_by_path[label] != want:
            raise AssertionError(f"{label}: kernel launches {launches_by_path[label]}, "
                                 f"expected {want}")

    predict = _as_predictor(FLAGSHIP, device=dev)
    gallery_lr = torch.from_numpy(read_img(GALLERY_PNG) / 255.0).to(dev)
    sr_gallery = _upscale(predict, gallery_lr[None], 4)
    sr_tiled = _upscale(predict, tiled_lr[None], 4)
    h_g, w_g = gallery_lr.shape[:2]
    checks = [("gallery", sr_gallery, (1, 4 * h_g, 4 * w_g, 3), GALLERY_PNG),
              ("tiled", sr_tiled, (1, 4 * TILED_HW[0], 4 * TILED_HW[1], 3), tiled_png)]
    png_levels = {}
    for label, sr, shape, src in checks:
        if tuple(sr.shape) != shape or not torch.isfinite(sr).all() or sr.abs().max() > 1:
            raise AssertionError(f"{label}: bad output {tuple(sr.shape)} "
                                 f"max |x| {sr.abs().max().item()}")
        png = torch.from_numpy(read_png(out_dir / f"{src.stem}_x4.png")).int()
        u8 = ((sr[0] + 1.0) * 127.5).clamp(0, 255).to(torch.uint8).int().cpu()
        if png.shape != u8.shape:
            raise AssertionError(f"{label}: written PNG has shape {tuple(png.shape)}")
        png_levels[label] = (png - u8).abs().max().item()
        if png_levels[label] > PNG_MAX_LEVELS:
            raise AssertionError(f"{label}: written PNG differs from the route's output by "
                                 f"{png_levels[label]} levels")
    with plain_kernels():
        plain_gallery = _upscale(predict, gallery_lr[None], 4)
        plain_tiled = _upscale(predict, tiled_lr[None], 4)
    route = {}
    for label, sr, plain in (("gallery", sr_gallery, plain_gallery),
                             ("tiled", sr_tiled, plain_tiled)):
        diff = (sr - plain).abs()
        route[label] = {"max_abs": diff.max().item(), "mean_abs": diff.mean().item()}
        if not (route[label]["max_abs"] < ROUTE_MAX_ABS_TOL
                and route[label]["mean_abs"] < ROUTE_MEAN_ABS_TOL):
            raise AssertionError(f"{label} route: kernels vs plain versions {route[label]}")
    small = gallery_lr[:32, :40][None]
    cpu_predict = _as_predictor(FLAGSHIP, device="cpu")
    cpu_diff = (predict(small).cpu() - cpu_predict(small.cpu())).abs().max().item()
    if not cpu_diff < ROUTE_MAX_ABS_TOL:
        raise AssertionError(f"GPU vs CPU path on a 32x40 input: {cpu_diff}")
    log(4, gallery_out=list(sr_gallery.shape), tiled_out=list(sr_tiled.shape),
        png_vs_route_max_levels=png_levels, kernels_vs_plain=route,
        gpu_vs_cpu_small_max_abs=cpu_diff, tol_max_abs=ROUTE_MAX_ABS_TOL,
        tol_mean_abs=ROUTE_MEAN_ABS_TOL)

    start("5 SREngine")
    crop = gallery_lr[:CROP_HW[0], :CROP_HW[1]].contiguous()
    one_shot = {tuple(gallery_lr.shape): sr_gallery[0], tuple(crop.shape): predict(crop[None])[0]}
    engine = SREngine(FLAGSHIP, 4, max_batch=4, max_wait_ms=50, device=dev)
    requests = [gallery_lr, crop, gallery_lr, crop]
    results = [None] * len(requests)
    errors = []

    def send(i):
        try:
            results[i] = engine.upscale(requests[i].cpu().numpy(), timeout=120)
        except Exception as e:  # reported below
            errors.append(repr(e))

    def serve():
        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(requests))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=150)
        if errors or any(th.is_alive() for th in threads):
            raise AssertionError(f"engine requests failed: {errors}")
        return engine.upscale_u8((crop.cpu().numpy() * 255).astype(np.uint8), timeout=120)

    try:
        u8, launches = counted(serve)
    finally:
        closed = engine.close()
    launches_by_path["sr_engine"] = launches
    engine_err = max((torch.from_numpy(r).to(dev) - one_shot[tuple(q.shape)]).abs().max().item()
                     for r, q in zip(results, requests))
    log(5, requests=[list(r.shape) for r in results], u8=[list(u8.shape), str(u8.dtype)],
        launches=launches, max_abs_vs_one_shot=engine_err, tol=ENGINE_MAX_ABS_TOL,
        closed=closed)
    # Two request shapes and the uint8 request need three batches at least.
    if launches["trunk"] < 3 or launches["patches"] != 0:
        raise AssertionError(f"sr_engine: kernel launches {launches}")
    if not engine_err < ENGINE_MAX_ABS_TOL or u8.dtype != np.uint8:
        raise AssertionError("engine results disagree with the one-shot path")

    start("6 timings")
    with torch.inference_mode():
        x_cl = trunk_in.permute(0, 3, 1, 2)  # channels_last NCHW view
        lib_params = library_trunk_weights(model)
        p, o = _TILE_PATCH, _TILE_OVERLAP
        win = p + 2 * o
        gh, gw = (padded_main.shape[0] - 2 * o) // p, (padded_main.shape[1] - 2 * o) // p
        rows = torch.arange(gh, device=dev)[:, None] * p + torch.arange(win, device=dev)
        cols = torch.arange(gw, device=dev)[:, None] * p + torch.arange(win, device=dev)
        rr, cc = rows[:, None, :, None], cols[None, :, None, :]
        # name: (one call, calls per CUDA graph)
        timed = {
            "trunk": (lambda: residual_trunk(trunk_in, weights), 5),
            "trunk_plain": (lambda: residual_trunk_reference(trunk_in, weights), 3),
            "trunk_library": (lambda: library_trunk(x_cl, lib_params), 5),
            "patches": (lambda: extract_overlapping_patches(padded_main, p, p, o), 50),
            "patches_plain": (
                lambda: extract_overlapping_patches_reference(padded_main, p, p, o), 20),
            "patches_library": (lambda: padded_main[rr, cc], 20),
        }
        call_ms = {name: cuda_ms(fn) for name, (fn, _) in timed.items()}
        device_ms = {name: graph_ms(fn, calls) for name, (fn, calls) in timed.items()}
        tiled_ms = cuda_ms(lambda: _upscale(predict, tiled_lr[None], 4), runs=20, warmup=2)
        stages = stage_ms(model, lr_batch)
        # the model's trunk (TrunkFunction under inference_mode: its packed
        # weights kept while the parameters stay as they are, then the
        # kernel), and packing and swizzling the weights alone
        for key, fn, calls in (
                ("trunk_model_path", lambda: model._trunk(x_cl), 5),
                ("trunk_packing", lambda: swizzle_trunk_weights(
                    pack_trunk_weights(model._block_parameters()).weight), 20)):
            call_ms[key], device_ms[key] = cuda_ms(fn), graph_ms(fn, calls)
    b, hh, ww, c = trunk_in.shape
    nb = len(model.blocks)
    trunk_flops = 2 * b * hh * ww * 9 * c * c * 2 * nb
    trunk_bytes = 2 * trunk_in.numel() * 2 + sum(t.numel() * t.element_size() for t in weights)
    patch_bytes = padded_main.numel() * 4 + gh * gw * win * win * 3 * 4
    trunk_bound = max(trunk_flops / PEAK_BF16_FLOPS, trunk_bytes / PEAK_BYTES_PER_S) * 1e3
    patch_bound = patch_bytes / PEAK_BYTES_PER_S * 1e3
    mpix = 16 * TILED_HW[0] * TILED_HW[1] / 1e6
    trunk_ms, patch_ms = call_ms["trunk"], call_ms["patches"]
    log(6, trunk_ms=trunk_ms, trunk_tflops=trunk_flops / trunk_ms / 1e9,
        trunk_bound_share=trunk_bound / trunk_ms, trunk_library_ms=call_ms["trunk_library"],
        patches_ms=patch_ms, patches_gb_s=patch_bytes / patch_ms / 1e6,
        patches_bound_share=patch_bound / patch_ms,
        patches_library_ms=call_ms["patches_library"], device_ms=device_ms,
        trunk_device_tflops=trunk_flops / device_ms["trunk"] / 1e9,
        patches_device_gb_s=patch_bytes / device_ms["patches"] / 1e6,
        trunk_model_path_ms=call_ms["trunk_model_path"],
        trunk_packing_ms=call_ms["trunk_packing"],
        tiled_upscale_ms=tiled_ms, tiled_output_mpix_per_s=mpix / (tiled_ms / 1e3),
        forward_stage_ms_one_tiled_batch=stages, runs=TIMING_RUNS, card=smi_line)

    profile_training = train_phase(dev, work, gen, launches_by_path, smi_line)
    notes = {}
    profile_yaml_run = yaml_phase(dev, work, launches_by_path, smi_line, notes)
    profile_srgan = srgan_phase(dev, work, launches_by_path, smi_line)
    profile_esrgan = esrgan_phase(dev, work, launches_by_path, smi_line, tiled_png)
    serving_phase(dev, work, launches_by_path, smi_line, tiled_png, tiled_lr, gallery_lr,
                  lr_batch, tiled_batches)
    profile_surface = training_surface_phase(dev, work, gen, launches_by_path, smi_line)
    parallel_phase(dev, work, launches_by_path, smi_line)
    host_loader = image_input_phase(dev, work, launches_by_path, smi_line, notes)
    keras_export_phase(dev, work, launches_by_path, smi_line, tiled_png)
    quality_phase(dev, work, launches_by_path, smi_line)
    denoising_phase(dev, work, launches_by_path, smi_line)
    image_formats = image_formats_phase(dev, work, launches_by_path, smi_line)
    measurement_phase(dev, work, launches_by_path, smi_line)
    # the profilers of phases 7 to 10 and 12 last, after every timing
    for profile in (profile_training, profile_yaml_run, profile_srgan, profile_esrgan,
                    profile_surface):
        profile()

    def total(key):
        return sum(counts[key] for counts in launches_by_path.values())

    def by_path(key):
        return {label: counts[key] for label, counts in launches_by_path.items()}

    def times(key):
        """One call from Python (ms), and device time over a CUDA graph."""
        return {"ms": call_ms[key], "plain_ms": call_ms[f"{key}_plain"],
                "library_ms": call_ms[f"{key}_library"], "device_ms": device_ms[key],
                "device_plain_ms": device_ms[f"{key}_plain"],
                "device_library_ms": device_ms[f"{key}_library"]}

    kernels = [
        {"name": "residual_trunk", "route": "cuda",
         "source": "simplesr_tpu_torch/csrc/trunk.cu",
         "replaces": "simplesr_tpu/ops/pallas/trunk_kernel.py:161",
         "launches": total("trunk"), "launches_by_path": by_path("trunk"),
         "max_abs_err": trunk_err, **times("trunk"), "bound_ms": trunk_bound,
         "bound_by": "operations" if trunk_flops / PEAK_BF16_FLOPS
         >= trunk_bytes / PEAK_BYTES_PER_S else "bytes",
         "bound_share": trunk_bound / trunk_ms,
         "resources": {"conv1": _build.kernel_attributes("ssr_trunk_attributes", 0),
                       "conv2": _build.kernel_attributes("ssr_trunk_attributes", 1)}},
        {"name": "extract_overlapping_patches", "route": "cuda",
         "source": "simplesr_tpu_torch/csrc/patches.cu",
         "replaces": "simplesr_tpu/ops/pallas/tiling_kernel.py:73",
         "launches": total("patches"), "launches_by_path": by_path("patches"),
         "max_abs_err": patch_err, **times("patches"), "bound_ms": patch_bound,
         "bound_by": "bytes", "bound_share": patch_bound / patch_ms,
         "resources": _build.kernel_attributes("ssr_patches_attributes")},
    ]
    print(json.dumps({"host_loader": host_loader, "image_formats": image_formats}), flush=True)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card_name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


def run():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True)
    with tempfile.TemporaryDirectory() as work:
        return main(Path(work))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:  # a rank of phase 13, started by the phase
        r_, n_, port_, dir_ = sys.argv[2:6]
        sys.exit(parallel_rank(int(r_), int(n_), int(port_), Path(dir_)))
    if sys.argv[1:2] == ["--gloo-probe"]:  # probe (a) of phase 13, started by the phase
        op_, r_, port_ = sys.argv[2:5]
        sys.exit(gloo_probe_rank(op_, int(r_), int(port_)))
    try:
        code = run()
    except Exception:  # report any failure, never the ok line
        traceback.print_exc()
        code = 1
    sys.exit(code)

#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It exits non-zero, printing no result, when no CUDA device is visible or
when the port's package is not next to this file. Otherwise it prints one
JSON line per phase and fails on the first failing phase:

1. ``device``: the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions, whether ``datasets``, ``pyarrow``, scipy, PIL and
   matplotlib (which the port does not use) can be imported, the time to build the CUDA kernels from ``csrc/`` and
   ``gpu_state`` (SM clock, power draw, temperature, throttle reasons,
   sampled again in ``mlp_checks``, every ``forward`` and ``done``).
2. ``kernel_checks``: the fused-qkv attention kernel (K1) against its plain
   PyTorch twin at the main path's shape (B=64, N=1201, H=12, d=64) in
   bfloat16 and in float32 (TF32 off for matmuls and cuDNN), with
   NaN-poisoned padded rows (N=1280, n_valid=1201), at the surface-normal
   path's launch (B=8, N=901: NYU's 480x480 center crop) and at test_tiny's
   shape; each with its error, its tolerance (bf16: min(1.6e-2, 2^-6 *
   max|ref|); f32: 1e-5) and, at the main shape and
   the surface-normal one, the kernel's, the twin's and
   ``F.scaled_dot_product_attention``'s times (the last as a yardstick
   only; the port never calls it).
3. ``knn2_checks``: the exact 2-NN kernel (K4) against its plain twin
   (f32, TF32 off) at the ScanNet path's launch (B=4, N=M=19200, d=768),
   the NAVI path's (B=4, N=M=16384, d=768) with 30% of the targets
   displaced to the path's far constant, the NAVI render path's (the same
   at B=1), a ragged, a wide (d=2048), a
   tiny, an odd-d, a 990-magnitude and an exact-tie case; at both path
   shapes with the kernel's, the twin's and ``torch.cdist(...).topk(2)``'s
   times (the last as a yardstick only; the port never calls it).
4. ``attention_checks``: the (B, H, N, d) attention kernel (K2, and K3,
   its long-sequence route through ``multi_head_attention(use_flash=True)``)
   against its plain version on strided views of a (B, N, 3, H, d)
   projection: RADIO-v2's launch (B=64, H=16, N=1201, d=80) in bf16 and
   f32, CroCo-v2's (B=64, H=12, N=196, d=64), every head dim at N=77, and
   the long sequences (B=2, H=16, N=4097, d=80 f32; B=2, H=12, N=8192,
   d=64 bf16); then K1 on the (B, N, 3, H, d) projection itself at the
   plain-ViT paths' launches: DINO ViT-B/8 at 480x640 (B=64, N=4801, H=12,
   d=64, bf16), CLIP ViT-L/14 at 480x640 (B=64, N=1531, H=16, d=64, bf16),
   the objectness path's (B=16, N=901, H=12, d=64, bf16), the 2AFC path's
   f32 triplet batch (B=48, N=197, H=12, d=64), the SPair path's f32
   launch (B=16, N=2501: 800x800, a ragged last key tile of 69) and the
   Taskonomy path's bf16 one (B=16, N=1025: 512x512), the DINOv2
   B/14-reg forward's (B=64, N=1535: cls, 4 registers and 34x45 patches at
   480x640, unpadded) and the DeiT-III B/16 forward's (B=64, N=577 at
   384x384), the MaskCut path's f32 one (B=1, N=901) and Zero123's f32
   conditioning launch (CLIP ViT-L/14: B=8, N=257, H=16), K1's bf16 cases
   held to min(1.6e-2, 2^-6 * max|ref|) and its plain version run in
   chunks of images; timed
   cases with SDPA's time as the yardstick, the f32 ones with the bound of
   the ``tf32x3`` design (``bound_ms``) and of f32 FMA (``bound_simt_ms``).
5. ``rope_checks``: the 2D RoPE kernel (K5) against its plain version:
   CroCo-v2's q launch (B=64, H=12, 14x14 grid, dim 64, a strided view),
   f32, a non-square grid, a one-token prefix slice and dim 16.
5a. ``variant_checks``: the attention bench's kernels against their plain
   versions at the bench shape (B=64, N=1280, n_valid=1201, H=12, d=64,
   bf16): the clamped exp2 attention K7 (``wide4``, ``stagger4``,
   ``wide12``), its int8 form K8 (both on the wgmma route at d = 64), and
   K9 (exact softmax over the valid keys on K2's kernel); a case where
   min(s, 110) clamps, n_valid = N, rows whose exponentials all underflow,
   and K7 and K8 at head dim 16 (16 heads, the mma_sync routes); each with
   the largest plain output beside its error; timed cases with SDPA on the
   valid keys as the yardstick (K8: none; SDPA's bf16 time beside it), K8
   split into its prologue, its attention kernel and both. Then K8's
   prologue (``quantize_qk_heads``) bit for bit against ``quantize_qk`` at
   the bench shape, also with rows past n_valid at +-3e4. The attention
   bounds count tensor-core operations, one exp2 per score on the MUFU (16
   a clock per SM, at the card's SM count and maximum clock) and bytes.
5b. ``mlp_checks``: the fused MLP (K6) at DINO ViT-B/16's MLP (M = 64*1201,
   C=768, H=3072) and RADIO-v2's (C=1280, H=5120) in bf16 and in f32 (the
   ``bf16x6`` route) with gelu_tanh (timed, with ``F.linear`` -> GELU ->
   ``F.linear`` as the yardstick; f32 with the bound of three TF32 products
   per product and of f32 FMA), every activation in bf16 and f32 at M=300,
   f32 at ViT-S's and ViT-g's widths (C = 384, 1536) and at one row of
   DINO's. bf16 is held to its plain version, f32 to an exact oracle
   (float64 products and sums) and to the plain version's own distance
   from it.
6. ``path``: the depth trainer (``midvision_probe_torch.train_depth``)
   through its ``entry`` on full-width dino_b16 (random weights),
   synthetic 480x640 data, the DPT depth probe, a bf16 backbone: per-step
   losses, the CSV row, launch counts (K1 12 per backbone forward, K2, K3
   and K5 none), wall time and peak memory.
7. ``path_navi`` and ``path_scannet``: the NAVI and ScanNet correspondence
   drivers through their ``entry`` on full-width dino_b16 (bf16, random
   weights), 8 synthetic hard pairs in batches of 4 at 512x512 and 480x640
   (16384 and 19200 points per view at scale 0.25), num_corr=1000: the CSV
   row, K4 launches (one per pair batch), K1 launches (12 per backbone
   forward; K2, K3, K5 none), wall time, peak memory and K4's share of the
   wall time; then a profiled run for the device's busy share and its top
   kernels.
8. ``path_navi_crocov2``: the NAVI driver as ``path_navi`` on full-width
   CroCo-v2 (every view resized to 224x224): K2 12 and K5 24 per backbone
   forward, K1 none, K4 once per pair batch.
9. ``path_depth_radio``: the depth trainer as ``path`` on full-width
   RADIO-v2 (ViT-H/16, 32 blocks, head dim 80): K2 32 per backbone forward,
   K1 none.
9a. ``path_snorm_nyu``: the surface-normal trainer
   (``midvision_probe_torch.train_snorm``) through its ``entry`` as the
   paper runs it, ``backbone=dino_b16 dataset=nyu probe=snorm_dpt`` (center
   crop, augmentation and the uncertainty-aware head as the configs have
   them), on a fabricated NYU tree (16 GeoNet train frames, 8 test frames,
   480x640) with DINO ViT-B/16's weights loaded in bf16 from a full-size
   fabricated ``dino_vitb16.pth`` under a temporary
   ``$MVP_CHECKPOINT_DIR``: the build time with the file (the load) and
   without it (random init), the loaded tensors against the file's, no
   random init with the file, the losses, the CSV row, K1 12 per backbone
   forward on wgmma, wall time, the init draw's time and reader calls, and
   peak memory.
9b. ``path_objectness_voc``: the objectness trainer
   (``midvision_probe_torch.train_generic_objectness``) through its
   ``entry``, ``backbone=dino_b16 dataset=voc probe=binaryhead`` (480x480,
   so K1 at N = 901), batch 16, bf16 backbone, on a fabricated VOC2007 tree
   of 40 trainval frames (500x375 JPEGs, palette SegmentationObject PNGs
   with 1-3 objects inside 255 boundaries, Annotations XML; the 80/20 split
   trains 2 steps on 32 and validates on 8) with DINO ViT-B/16 loaded from
   the full-size fabricated ``dino_vitb16.pth``: no random init, finite
   losses, F-measure, IoU, accuracy and CorLoc in [0, 1], one CSV row, K1
   12 per backbone forward on wgmma, wall time, the init draw's time and
   reader calls, and peak memory.
9c. ``path_2afc_nights``: the 2AFC evaluator
   (``midvision_probe_torch.evaluate_model_percepture``) through its
   ``entry``, ``backbone=clip_b16 dataset=twoafcdataset``, on a fabricated
   NIGHTS tree (``data.csv`` in the reference's columns, 32 test triplets
   of 768x768 PNGs that pass the vote filter and rows that do not) with CLIP
   ViT-B/16 loaded from a full-size fabricated OpenAI-layout
   ``clip_vitb16_openai.pt`` (``visual.*`` and text-tower tensors) through
   the OpenCLIP converter: every trunk tensor equal to the file's, no random
   init, accuracy, F1, precision and recall in [0, 1], one CSV row, K1 12
   per backbone forward (float32, tf32x3), wall time and peak memory.
9d. ``path_spair``: the SPair-71k evaluator
   (``midvision_probe_torch.evaluate_spair_correspondence``) through its
   ``entry`` with the config's defaults (800x800, batch 8 pairs, every
   class and viewpoint difference, no bbox crop, one tap), ``dino_b16`` in
   float32 with seeded random weights, on a fabricated SPair-71k tree (2
   classes x 8 test pairs over viewpoint differences 0, 1 and 2; 500x375
   JPEGs, class-id segmentations, 30 keypoint slots with some ``null``):
   the recall table in [0, 100] (-1 for the 16 classes without pairs), one
   CSV row, K1 12 per backbone forward on tf32x3, wall time and peak
   memory; then one class with ``mask_feats`` and ``return_heatmaps``: the
   heat maps, (pairs, 30, 50, 50) per viewpoint difference.
9e. ``path_taskonomy``: the Taskonomy trainer
   (``midvision_probe_torch.train_taskonomy``) through its ``entry``,
   ``backbone=dino_b16 dataset=taskonomy probe=taskonomy_dpt``, principal
   curvature, batch 16, bf16 backbone with seeded random weights, on the
   synthetic fallback at 512x512 (32 train and 32 test items): finite
   losses, AbsRel >= 0 and the ratio thresholds in [0, 1], one CSV row, K1
   12 per backbone forward on wgmma, wall time, the init draw's time and
   reader calls, and peak memory.
9f. ``path_depth_resnet50``: the depth trainer through its ``entry``,
   ``backbone=simclr_resnet50 dataset=nyu probe=depth_dpt`` with
   ``render_images`` at its default (on), batch 8, bf16, on the fabricated
   NYU tree of ``path_snorm_nyu`` (16 + 8 frames at 480x640) with SimCLR's
   trunk loaded from a full-size fabricated VISSL ``simclr_resnet50.torch``
   (``data_processing/torch_replicas.py``): every loaded tensor equal to
   the file's, no random init, the taps (256 channels at 1/4 of the input
   to 2048 at 1/32), finite losses, one CSV row, the artifacts by count
   (2 x min(8, B) first-batch PNGs, 4 files per test image of the first 6
   batches, one scatter PNG), no hand-written kernel launched (cuDNN's
   convolutions), wall time and peak memory.
9g. ``path_depth_dinov2_reg``: the depth trainer as ``path`` on DINOv2
   B/14 with 4 registers (34x45 grid, N = 1535) with ``render_images`` on:
   K1 12 per backbone forward on wgmma, the artifacts by count.
9h. ``path_render_navi``: the NAVI render driver
   (``midvision_probe_torch.render_navi_correspondence``) on dino_b16
   (bf16), ``synthetic_navi_hard`` at 512x512, num_corr=1000, 8 pairs of
   batch 1: ``errors.json`` per pair and ``matches.png`` where it has
   matches, K1 24 and K4 one a pair.
9i. ``path_scannet_render``: the ScanNet driver as ``path_scannet`` with
   ``+render_every=4``: instances 0 and 4 rendered (three PNGs and
   ``correspondence_metrics.json`` each), wall time.
10. ``forward``: the frozen forward in images per second per card (CUDA
   events), peak memory and a profiler breakdown by kernel, with the launch
   counts per forward: dino_vitb16 (the bench protocol: 480x640, batch 64,
   bf16, 4 taps), dino_vitb8 and clip_vitl14 (480x640, batch 64, bf16; a
   60x80 and a 34x45 grid, K1 12 and 24 per forward), crocov2_vitb16
   (224x224, batch 64, bf16), radio_v2 (480x640, batch 64, bf16) and
   radio_v2 in float32 at 1024x1024 (batch 2, N=4097: the shape that takes
   the long-sequence route, K3); dinov2_vitb14_reg and dinov2_vitl14 at
   480x640 (K1 12 and 24 per forward), deit3_vitb16 at 384x384 (K1 12),
   beitv2_vitb16 at 224x224 and midas_l16 at 384x384 (the biased einsum
   route: no kernel) and simclr_resnet50 at 480x640 (cuDNN: no kernel), all
   batch 64, bf16; sam_vit_b and sam_vit_l at 480x640 (windows padded to
   42x42, the global blocks' tables resized from 127 rows) and sam_vit_b at
   its native 1024x1024 (batch 8, N = 4096 in the global blocks), and
   cnxt_b_in22k and cnxt_b_fcmae (GRN) at 480x640 (every stage resized to
   the 30x40 grid): einsum, f32 softmax and cuDNN, no hand-written kernel.
10a. ``path_depth_sam`` and ``path_depth_convnext_laion``: the depth
   trainer as ``path`` on ``sam_base`` and ``clip_convnext`` (renders off),
   each trunk loaded in bf16 from a full-size fabricated file in its
   source's naming (segment_anything's ``sam_vit_b_01ec64.pth`` with the
   neck and prompt-encoder/mask-decoder keys; open_clip's
   ``convnext_base_w_laion2b.pt`` under ``visual.trunk.`` with its head and
   text-tower keys): every loaded tensor equal to the file's (the pos-embed
   kept f32), only those keys left out, no random init, the taps, the
   spec's mean and std (OpenAI's for the open_clip file), finite losses,
   the metrics in range, one CSV row, no hand-written kernel.
10b. ``path_maskcut_voc``: the MaskCut evaluator
   (``midvision_probe_torch.evaluate_generic_objectness``) through its
   ``entry``, ``backbone=dino_b16`` in float32 at ``maskcut.fixed_size=480``
   on 4 fabricated VOC2007 frames with the fabricated ``dino_vitb16.pth``:
   ``Num Errors`` 0, ``Num Images`` 4, the metrics in [0, 1], one CSV row,
   the DenseCRF library built from ``native/densecrf/`` into
   ``build/densecrf`` (its path and build seconds), K1 12 per image on
   ``tf32x3`` (B = 1, N = 901), and the host seconds split into features,
   affinity + 2-means, ``eigh``, CRF and the rest.
10c. ``forward_dift`` and ``forward_zero123``: the SD featurizers from
   their configs at full widths on 480x640 images, batch 8, float32 with
   TF32 off, random weights drawn on the card: DIFT with a fabricated
   tokenizer (the 23-layer text tower encodes the empty prompt), Zero123
   with a full-size fabricated CLIP ViT-L/14 conditioning state dict; the
   four taps' shapes, wall and device time, images per second, peak
   memory, the FLOPs from the configs with their bound at the float32
   peak, launches (DIFT none; Zero123 K1 24 on ``tf32x3``, with K1's check
   at that launch beside them) and one image again in float64.
10d. ``path_depth_cached``: the depth trainer on dino_b16 (bf16, 480x640,
   32 items in batches of 8, three epochs) with ``system.cache_features``
   under the default budgets, the host tier alone and none: backbone
   forwards, wall time, the tiers' bytes and peak memory per epoch, K1 12
   per backbone forward.
10e. ``path_depth_ddp``: the depth trainer on dino_b16 (480x640, the DPT
   probe, 32 items in batches of 8, three epochs) with the sweep's three
   bf16 settings (the feature cache, a bf16 backbone, a bf16 probe), cuDNN
   deterministic, run plainly and as a one-rank NCCL process group (a
   ``python -m torch.distributed.run --nproc_per_node=1`` subprocess of
   this script, ``--ddp-worker``): the backend, world size and rank, the
   all-reduces per step, each run's wall and K1's launches by route; the
   two CSV rows within 1e-4 relative.
10f. ``profiling``: ``utils/profiling.py`` on the dino_vitb16 forward
   (bf16, batch 8, 480x640): ``time_fn``, ``device_memory_stats()`` and a
   ``trace()`` around one forward (the Chrome trace's kernel events, and
   the port's spans: one ``mvp.backbone`` holding 12
   ``mvp.backbone.attention`` and 12 ``mvp.backbone.mlp``, every one a
   host ``cpu_op`` and none mirrored onto the card's timeline).
10g. ``extract_kqv``: ``FeatureExtractor.extract_kqv`` on dino_vitb16 at
   480x640, bf16, batch 8, ``k`` and ``kqv`` against a plain recompute of
   block 11's projection, K1 12 a call on ``wgmma``.
10h. ``path_suite``: the port's full-suite runner
   (``midvision_probe_torch.launch.suite_run``) on dino_b16 over five of
   the six default tasks (snorm left to ``path_snorm_nyu``) at the plan's
   own sizes, 5 driver processes sharing a fresh synthetic-set disk tier,
   then ``launch.aggregate_results`` over the CSV archive: every cell's rc
   and wall, each task's total, one CSV row a cell, a ranking table a task,
   the disk tier's files read back by the depth replay (none rewritten)
   and its saving; the depth and NAVI cells replayed in this process with
   the launch counts reset (K1 on ``wgmma`` and on ``tf32x3``, K4), each
   replay's CSV row equal to its cell's.
10i. ``instance_masks``: ``midvision_probe_torch.data_processing.
   extract_instance_masks`` over 4 fabricated VOC frames with the
   fabricated ``dino_vitb16.pth`` at ``--fixed-size 480 --num-masks 3``:
   one npz an image with 1-3 masks at the image's size, ``index.csv``, K1
   12 an image on ``tf32x3``, the host seconds by stage and the CRF's
   share.
10j. ``checkpoint_drill``: the weights-landing drill
   (``midvision_probe_torch.data_processing.convert_checkpoints --all``)
   over fabricated full-size DINO B/16, CLIP B/16, SAM-B and ConvNeXt-B
   files: 4 present and none failed, each golden held at 2e-3 to its
   independent CPU replica (``data_processing/torch_replicas.py``; SAM's is
   ``transformers``' model, reported as having no oracle on a host without
   it), dino_vitb16's reading, K1 12 a forward of the ViTs on ``tf32x3``.
10k. ``suite_timing``: ``launch.time_suite``'s ``main`` in a process of its
   own (``chip_smoke.py --counted OUT MODULE:FUNCTION``, which also writes
   the launch counts and the return value to OUT) at its defaults (batch
   32 at 480², dino_vitb16 and simclr_resnet50, the DPT probe in f32 and
   bf16 and the linear one in bf16): each row's three times and losses,
   the suite projection (held to ``project_suite`` recomputed from the
   rows), K1 on ``wgmma``; the timed probe steps are CUDA-graph replays,
   each held to the eager step (same ``capturable`` AdamW) on the same
   features.
10l. ``bench_matrix``: ``python -m midvision_probe_torch.launch.bench_matrix``
   as a process of its own (``chip_smoke.py --counted OUT MODULE`` runs it
   as ``-m`` does), in its check mode against the committed
   ``launch/bench_matrix_expected.json``: rc 0, the six rows with their
   expectations and ratios, the B/16 extraction within 10% of ``forward``
   and both step rows within 10% of ``suite_timing``'s, K1 12 a ViT
   forward on ``wgmma``.
10m. ``preset_ab``: ``launch.fast_preset_ab`` on dino_b16, 64 instances,
   arms ``protocol-dpt``, ``dpt-192-hd256`` (its row read from the
   ``_eval480`` directory) and ``fast-linear`` at ``--size 480``.
10n. ``shuffle_ab``: ``launch.shuffle_ab`` at its defaults on seeds 0 and 1.
10o. ``graft_entry``: ``graft_entry.entry()`` (K1 12 on ``wgmma``, four
   finite maps), then ``dryrun_multichip(4, preset="vitb")``: four gloo
   ranks sharing this card as a 2 x 2 (data, model) grid, each rank's loss
   against the same step unsharded in this process (1e-4 relative), the
   sharded K4 against the unsharded launch, the pipeline, K1 12 a rank at
   6 heads on ``tf32x3``.
10p. ``bench``: ``python -m midvision_probe_torch.bench`` the same way:
   exactly one JSON line with the four keys and the headline metric, its
   value within 10% of the ``forward`` phase's DINO B/16 images/s, K1 12 a
   forward on ``wgmma``. Each of 10k-10p prints its wall on a
   ``phase_wall`` line.
11. ``bench_attn``: the attention bench through its entry point
   (``midvision_probe_torch.bench_attn.main``) with every variant (``base``
   K1, ``wide4``/``stagger4``/``wide12`` K7, ``int8`` K8, ``splash`` K9):
   its per-variant times and errors against the f32 oracle, and the launch
   counts.
12. ``path_fused_mlp``: K6 as a library op, a 12-block residual MLP stack at
   DINO's width over a 64-image batch: wall time and launch counts.
13. ``backward_checks``: the attention backward (``csrc/attention_bwd.cu``:
   K10, the backward of K3, and K11, of K9) against the plain versions'
   autograd at RADIO-v2's K3 launch in f32 (B=2, H=16, N=4097, d=80), K3's
   bf16 one (B=2, H=12, N=8192, d=64) and the bench's K9 shape (B=64,
   N=1280, n_valid=1201, H=12, d=64, bf16; keys and values past n_valid
   NaN), and at B=1 against a float64 oracle; each of dq, dk and dv within
   1e-4 * max|ref| (f32) or max(2^-6 * max|ref|, twice the plain bf16
   version's own error against f64) (bf16); each case on the route it must
   take (``wgmma`` in bf16, ``tf32x3`` in f32, as its launch reports); the
   backward's, the plain version's and SDPA's backward times with the
   bound; K2's and K3's forward times with and without the lse residual.
14. ``grad_paths``: input gradients through frozen backbones built by the
   zoo at full width: RADIO-v2 in f32 at 1024x1024 (batch 2, K3 and K10 32
   launches each, the gradient along a seeded direction within 1e-2 of a
   central difference of two forwards) and DINO ViT-B/16 in bf16 at 480x640
   (batch 8, K1 12 launches with its recomputed backward, a finite gradient
   whose cosine to the f32 path's is at least 0.98), and the bench's splash
   attention at the bench shape (one K9 and one K11 launch, the gradient 0
   at the keys and values past n_valid); walls, peak memory.

Then a ``kernels`` summary line, the ``nvidia-smi`` name/power-limit line
and, last, ``{"ok": true, "device": {...}}``. Every launch count is set to
0 just before a path is driven and read just after it, with the attention
launches by the route the kernel reports (``wgmma`` for bf16 at d 64 and
80, ``mma_sync`` for the other bf16 head dims, ``tf32x3`` for f32; K7's
``wgmma`` at d 64 and 80, ``mma_sync`` at its other head dims; K8's
``wgmma`` at d 64, ``mma_sync`` at 8, 16, 32 and 128); every
attention check records the route that ran and fails if it is not the one
``ops/vit_attention.py::attention_route`` names.
"""

from __future__ import annotations

import contextlib
import glob
import io
import importlib.util
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# published dense peaks of one H100 SXM at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_FP32_FLOPS = 67e12  # SIMT, outside the tensor cores
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# exp2 per clock per SM on the multi-function unit (MUFU), the attention
# kernels' third bound beside tensor-core operations and bytes
MUFU_EXP2_PER_CLOCK = 16
CARD = {}  # "sms" and "sm_clock_hz", read from the card by read_card()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def gpu_state() -> str:
    """The card's SM clock (now and its maximum), power draw, temperature
    and active throttle reasons, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu,"
         "clocks_throttle_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, iters: int = 15, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``iters`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def read_card(torch) -> dict:
    """The card's SM count and maximum SM clock (``nvidia-smi``), which the
    exp2 bound needs; kept in ``CARD``."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
    CARD.update(sms=torch.cuda.get_device_properties(0).multi_processor_count,
                sm_clock_hz=float(mhz) * 1e6)
    return dict(CARD)


def exp2_ms(B, H, N, n_valid) -> float:
    """The MUFU's time for one exp2 per score (B*H*N*n_valid) at 16 per
    clock per SM on this card."""
    rate = MUFU_EXP2_PER_CLOCK * CARD["sms"] * CARD["sm_clock_hz"]
    return B * H * N * n_valid / rate * 1e3


def bounds(tensor_ms: float, bytes_ms: float, mufu_ms: float = 0.0) -> dict:
    """The least time as the largest of its terms: tensor-core (or FMA)
    operations, exp2 on the MUFU and bytes at the memory rate.
    ``bound_by`` is ``operations`` for either of the first two, ``bytes``
    for the last; ``bound_term`` names the term; ``bound_without_exp2_ms``
    is the bound without the MUFU term."""
    terms = {"tensor": tensor_ms, "mufu": mufu_ms, "bytes": bytes_ms}
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term], "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "bound_without_exp2_ms": max(tensor_ms, bytes_ms)}


def attention_bounds(B, N, n_valid, H, d, itemsize, peak_flops) -> dict:
    """Least time for one call: QK^T and PV over the valid keys at the
    dtype's peak, one exp2 per score on the MUFU, or the qkv read plus
    output write at the memory rate."""
    flops = 4.0 * B * H * N * n_valid * d
    nbytes = (B * N * 3 * H * d + B * N * H * d) * itemsize
    return bounds(flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3,
                  exp2_ms(B, H, N, n_valid))


def f32_attention_bounds(B, N, n_valid, H, d) -> dict:
    """The least time of an f32 attention call for both designs: ``tf32x3``
    (the kernel's: three TF32 products per product, 3*4*B*H*N*n_valid*d FLOP
    at the TF32 peak) as ``bound_ms``, and f32 FMA outside the tensor cores
    (the SIMT kernel's that it replaced) as ``bound_simt_ms``; each with the
    exp2 and bytes terms."""
    simt = attention_bounds(B, N, n_valid, H, d, 4, PEAK_FP32_FLOPS)["bound_ms"]
    return {**attention_bounds(B, N, n_valid, H, d, 4, PEAK_TF32_FLOPS / 3),
            "bound_simt_ms": simt}


def route_ran(fn):
    """``fn()`` and the attention route whose launch count moved during it
    (None when no route of ``csrc/vit_attention.cu`` launched; raises if
    more than one did)."""
    from midvision_probe_torch.ops.vit_attention import route_launches

    before = dict(route_launches)
    out = fn()
    moved = [r for r, n in route_launches.items() if n != before[r]]
    if len(moved) > 1:
        raise SystemExit(f"more than one attention route ran: {moved}")
    return out, (moved[0] if moved else None)


def phase_kernel_checks(torch):
    import torch.nn.functional as F

    from midvision_probe_torch.ops.vit_attention import (
        _fused_qkv_attention_plain,
        attention_route,
        fused_qkv_attention,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    # bf16: kernel and twin both round P and the output to bf16 but sum in
    # other orders -> a few bf16 ulps of the largest output, so the gate is
    # min(1.6e-2, 2^-6 * max|ref|) (two to four such ulps); fp32: FMA order
    # only
    tol = {torch.bfloat16: 1.6e-2, torch.float32: 1e-5}
    cases = [
        ("main_bf16", 64, 1201, 12, 64, None, torch.bfloat16, True),
        ("main_fp32", 64, 1201, 12, 64, None, torch.float32, True),
        ("main_bf16_nan_padded", 64, 1280, 12, 64, 1201, torch.bfloat16, False),
        # path_snorm_nyu's launch: NYU's 480x480 center crop, N = 30*30 + 1
        ("nyu_snorm_bf16", 8, 901, 12, 64, None, torch.bfloat16, True),
        ("test_tiny_bf16", 8, 65, 2, 16, None, torch.bfloat16, False),
        ("test_tiny_fp32", 8, 65, 2, 16, None, torch.float32, False),
    ]
    results = []
    for name, B, N, H, d, nv, dtype, timed in cases:
        qkv = torch.randn(B, N, 3, H, d, device="cuda", generator=gen).to(dtype)
        if nv is not None:
            qkv[:, nv:] = float("nan")  # padded rows: the kernel must not read them
        scale = d**-0.5
        with torch.no_grad():
            out, ran = route_ran(lambda: fused_qkv_attention(qkv, scale, nv))
            ref = _fused_qkv_attention_plain(qkv, scale, nv)
        torch.cuda.synchronize()
        rows = nv or N
        o, r = out[:, :rows].float(), ref[:, :rows].float()
        err = (o - r).abs().max().item()
        max_ref = r.abs().max().item()
        rel = err / max(max_ref, 1e-30)
        gate = tol[dtype] if dtype == torch.float32 else min(tol[dtype], 2.0**-6 * max_ref)
        finite = bool(torch.isfinite(o).all())
        route = attention_route(d, dtype)
        res = {"case": name, "shape": [B, N, H, d], "n_valid": nv, "dtype": str(dtype),
               "route": route, "route_ran": ran, "max_abs_err": err, "max_rel_err": rel,
               "tol": gate, "finite": finite, "ok": finite and err <= gate and ran == route}
        if timed:
            with torch.no_grad():
                res["kernel_ms"] = cuda_ms(torch, lambda: fused_qkv_attention(qkv, scale))
                res["plain_ms"] = cuda_ms(
                    torch, lambda: _fused_qkv_attention_plain(qkv, scale), iters=10)
                q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, H, N, d)
                res["library_ms"] = cuda_ms(
                    torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
            if dtype == torch.bfloat16:
                res.update(attention_bounds(B, N, N, H, d, 2, PEAK_BF16_FLOPS))
            else:
                res.update(f32_attention_bounds(B, N, N, H, d))
        results.append(res)
        del qkv, out, ref, o, r
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True  # the path runs with torch's defaults
    emit({"phase": "kernel_checks", "cases": results})
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"kernel check failed: {bad}")
    return {r["case"]: r for r in results}


def knn2_bound_ms(B, N, M, d) -> tuple[float, str]:
    """Least time for one K4 call: the TPU kernel's three bf16 products
    (hi.hi + hi.lo + lo.hi, 2*B*N*M*d FLOP each) at the bf16 peak, or q and
    t read once in f32 plus the (dist, idx) pairs written, at the memory
    rate."""
    flops = 3 * 2.0 * B * N * M * d
    nbytes = 4.0 * B * d * (N + M) + 16.0 * B * N
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


FAR = 1.0e3  # the displacement of masked targets on the correspondence path


def knn2_inputs(torch, gen, B, N, M, d, kind):
    """q (B, N, d), t (B, M, d) f32 on the card. ``unit``: L2-normalised
    features, as the path feeds K4; ``masked``: 30% of the targets at FAR;
    ``large_magnitude``: 990-constant queries against N(0, 1) targets;
    ``ties``: quarter-integer features (every distance exact in any
    summation order) with each target row duplicated M/2 rows later."""
    if kind == "ties":
        q = torch.randint(-3, 4, (B, N, d), device="cuda", generator=gen).float() / 4
        base = torch.randint(-3, 4, (B, M // 2, d), device="cuda", generator=gen).float() / 4
        return q, torch.cat([base, base], dim=1)
    t = torch.randn(B, M, d, device="cuda", generator=gen)
    if kind == "large_magnitude":
        return torch.full((B, N, d), 990.0, device="cuda"), t
    q = torch.randn(B, N, d, device="cuda", generator=gen)
    q = q / q.norm(dim=-1, keepdim=True)
    t = t / t.norm(dim=-1, keepdim=True)
    if kind == "masked":
        t[torch.rand(B, M, device="cuda", generator=gen) < 0.3] = FAR
    return q, t


def phase_knn2_checks(torch):
    """K4 against its plain twin (f32, TF32 off). Pass: no index >= M;
    indices equal on >= 99.9% of rows (100% on ``ties``); on every row the
    chosen neighbours' true squared distances, recomputed in f64, within
    1e-5 (+1e-5 relative, for the 990-magnitude case) of the twin's; the
    kernel's distances within the same tolerance of the twin's (exactly
    equal on ``ties``)."""
    from midvision_probe_torch.ops.matching import _knn2_plain, _knn2_sq

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = [
        ("scannet_main", 4, 19200, 19200, 768, "unit", True),
        ("navi_main_masked", 4, 16384, 16384, 768, "masked", True),
        # the NAVI render driver's launch: one pair a batch
        ("navi_render_masked", 1, 16384, 16384, 768, "masked", True),
        ("ragged", 2, 1000, 777, 768, "unit", False),
        ("wide", 1, 2048, 3000, 2048, "unit", False),
        ("large_magnitude", 1, 64, 100, 128, "large_magnitude", False),
        ("tiny", 2, 256, 256, 32, "unit", False),
        ("odd_dim", 2, 300, 301, 19, "unit", False),
        ("ties", 2, 512, 600, 64, "ties", False),
    ]
    results = []
    for name, B, N, M, d, kind, timed in cases:
        q, t = knn2_inputs(torch, gen, B, N, M, d, kind)
        dist, idx = _knn2_sq(q, t)
        ref_d, ref_i = _knn2_plain(q, t)
        torch.cuda.synchronize()
        in_range = bool((idx >= 0).all() and (idx < M).all())
        same = (idx == ref_i).all(-1)
        agree = same.float().mean().item()
        # true distances of the chosen neighbours where the choices differ
        rows = (~same).nonzero(as_tuple=True)
        true_gap, true_ok = 0.0, in_range
        if rows[0].numel() and in_range:
            q64 = q[rows].double()[:, None]  # (R, 1, d)
            tk = t[rows[0][:, None], idx[rows].long()].double()
            tr = t[rows[0][:, None], ref_i[rows].long()].double()
            dk, dr = ((q64 - tk) ** 2).sum(-1), ((q64 - tr) ** 2).sum(-1)
            true_gap = (dk - dr).abs().max().item()
            true_ok = bool(((dk - dr).abs() <= 1e-5 + 1e-5 * dr.abs()).all())
        err = (dist - ref_d).abs()
        max_abs = err.max().item()
        dist_ok = bool((err <= 1e-5 + 1e-5 * ref_d.abs()).all())
        if kind == "ties":
            ok = in_range and agree == 1.0 and max_abs == 0.0
        else:
            ok = in_range and agree >= 0.999 and true_ok and dist_ok
        res = {"case": name, "shape": [B, N, M, d], "inputs": kind,
               "indices_in_range": in_range, "rows_agree": agree,
               "rows_differ": int((~same).sum()), "true_dist_max_gap": true_gap,
               "true_dist_within_tol": true_ok, "max_abs_err": max_abs,
               "dist_within_tol": dist_ok, "ok": ok}
        if timed:
            res["kernel_ms"] = cuda_ms(torch, lambda: _knn2_sq(q, t), iters=10)
            res["plain_ms"] = cuda_ms(torch, lambda: _knn2_plain(q, t), iters=5, warmup=1)
            res["library_ms"] = cuda_ms(
                torch, lambda: torch.cdist(q, t).topk(2, dim=-1, largest=False),
                iters=5, warmup=1)
            res["bound_ms"], res["bound_by"] = knn2_bound_ms(B, N, M, d)
        results.append(res)
        del q, t, dist, idx, ref_d, ref_i, same, err
        torch.cuda.empty_cache()
    emit({"phase": "knn2_checks", "cases": results})
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"knn2 check failed: {bad}")
    return {r["case"]: r for r in results}


def phase_attention_checks(torch):
    """K2 (``vit_attention``) and K3 (``multi_head_attention(use_flash=True)``,
    the same kernel on the long-sequence route) against the plain version on
    strided (B, H, N, d) views of a (B, N, 3, H, d) projection, and K1
    (``fused_qkv_attention``) on the projection itself at the launches of the
    plain-ViT paths. Tolerances: f32 1e-5 with TF32 off; bf16 1.6e-2 for
    K2 and K3, and for K1 min(1.6e-2, 2^-6 * max|ref|), as the bench
    kernels' (``phase_variant_checks``): at N = 4801 the outputs' RMS is
    near sqrt(e/N) = 0.024, so a fixed 1.6e-2 would let a kernel that drops
    the ragged last key tile pass. K1's plain version runs in chunks of
    images whose f32 scores stay under 4 GiB, so that it is held at the
    whole batch the path launches."""
    import torch.nn.functional as F

    from midvision_probe_torch.ops.attention import multi_head_attention
    from midvision_probe_torch.ops.vit_attention import (
        _fused_qkv_attention_plain,
        _vit_attention_plain,
        attention_route,
        fused_qkv_attention,
        vit_attention,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(2)
    tol = {torch.bfloat16: 1.6e-2, torch.float32: 1e-5}
    k2 = lambda q, k, v, sc: vit_attention(q, k, v, sc)  # noqa: E731
    k3 = lambda q, k, v, sc: multi_head_attention(q, k, v, scale=sc, use_flash=True)  # noqa: E731
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("radio_main_bf16", "K2", 64, 16, 1201, 80, bf16, True),
        ("crocov2_bf16", "K2", 64, 12, 196, 64, bf16, True),
        ("radio_fp32", "K2", 64, 16, 1201, 80, f32, True),
        *[(f"d{d}_n77_{str(dt)[6:]}", "K2", 2, 3, 77, d, dt, False)
          for d in (16, 32, 64, 80, 128) for dt in (bf16, f32)],
        ("k3_radio1024_fp32", "K3", 2, 16, 4097, 80, f32, True),
        ("k3_long_bf16", "K3", 2, 12, 8192, 64, bf16, True),
        # K1 at the plain-ViT paths' launches: the forward rows' DINO
        # ViT-B/8 and CLIP ViT-L/14 at 480x640 (60x80 and 34x45 grids, batch
        # 64), the objectness path's DINO ViT-B/16 at 480x480 (batch 16) and
        # the 2AFC path's f32 triplet batch (3 x 16 at 224x224)
        ("dino_vitb8_k1_bf16", "K1", 64, 12, 4801, 64, bf16, True),
        ("clip_vitl14_k1_bf16", "K1", 64, 16, 1531, 64, bf16, True),
        ("objectness_dino_k1_bf16", "K1", 16, 12, 901, 64, bf16, True),
        ("twoafc_clip_k1_fp32", "K1", 48, 12, 197, 64, f32, True),
        # the SPair path's f32 launch (8 pairs at 800x800: a 50x50 grid, the
        # last key tile 69 of 128) and the Taskonomy path's bf16 one (batch
        # 16 at 512x512)
        ("spair_dino_k1_fp32", "K1", 16, 12, 2501, 64, f32, True),
        ("taskonomy_dino_k1_bf16", "K1", 16, 12, 1025, 64, bf16, True),
        # the new ViT forwards' launches (batch 64): DINOv2 B/14-reg at
        # 480x640 (cls + 4 registers + 34x45 patches, unpadded: the port's
        # ViT does not pad to 128) and DeiT-III B/16 at 384x384
        ("dinov2_reg_k1_bf16", "K1", 64, 12, 1535, 64, bf16, True),
        ("deit3_k1_bf16", "K1", 64, 12, 577, 64, bf16, True),
        # the MaskCut path's f32 launch: one image at 480x480 (cls + 30x30)
        ("maskcut_dino_k1_fp32", "K1", 1, 12, 901, 64, f32, True),
        # Zero123's conditioning: CLIP ViT-L/14 in f32 on a batch of 8 at
        # 224x224 (cls + 16x16)
        ("zero123_clip_k1_fp32", "K1", 8, 16, 257, 64, f32, True),
        # the suite-timing tool's launch (batch 32 at 480x480: cls + 30x30)
        # and a rank of the ViT-B dry run (one image at 480x480, its 6 of 12
        # heads, f32)
        ("suite_timing_k1_bf16", "K1", 32, 12, 901, 64, bf16, True),
        ("dryrun_rank_k1_fp32", "K1", 1, 6, 901, 64, f32, True),
    ]
    results = []
    for name, kernel, B, H, N, d, dtype, timed in cases:
        qkv = torch.randn(B, N, 3, H, d, device="cuda", generator=gen).to(dtype)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # strided (B, H, N, d) views
        scale = d**-0.5
        if kernel == "K1":  # the fused (B, N, 3, H, d) launch, output (B, N, H*d)
            step = max(1, 2**32 // (4 * H * N * N))  # images whose f32 scores fit 4 GiB
            fn = lambda q, k, v, sc: fused_qkv_attention(qkv, sc)  # noqa: E731
            plain = lambda q, k, v, sc: torch.cat(  # noqa: E731
                [_fused_qkv_attention_plain(qkv[i:i + step], sc) for i in range(0, B, step)])
        else:
            fn, plain = (k2 if kernel == "K2" else k3), _vit_attention_plain
        with torch.no_grad():
            out, ran = route_ran(lambda: fn(q, k, v, scale))
            ref = plain(q, k, v, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        max_ref = ref.float().abs().max().item()
        gate = tol[dtype]
        if kernel == "K1" and dtype == bf16:
            gate = min(gate, 2.0**-6 * max_ref)
        finite = bool(torch.isfinite(out).all())
        route = attention_route(d, dtype)
        res = {"case": name, "kernel": kernel, "shape": [B, H, N, d], "dtype": str(dtype),
               "route": route, "route_ran": ran, "max_abs_err": err, "max_abs_ref": max_ref,
               "tol": gate, "finite": finite, "ok": finite and err <= gate and ran == route}
        if timed:
            with torch.no_grad():
                res["kernel_ms"] = cuda_ms(torch, lambda: fn(q, k, v, scale))
                res["plain_ms"] = cuda_ms(
                    torch, lambda: plain(q, k, v, scale), iters=5, warmup=1)
                res["library_ms"] = cuda_ms(
                    torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
            if dtype == bf16:
                res.update(attention_bounds(B, N, N, H, d, 2, PEAK_BF16_FLOPS))
            else:
                res.update(f32_attention_bounds(B, N, N, H, d))
        results.append(res)
        del qkv, q, k, v, out, ref
        torch.cuda.empty_cache()
    emit({"phase": "attention_checks", "cases": results})
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"attention check failed: {bad}")
    return {r["case"]: r for r in results}


def phase_rope_checks(torch):
    """K5 against its plain version. Pass: f32 max abs error <= 1e-5 (|t| up
    to ~4); bf16 every element within one bf16 ulp of the plain output
    (|err| <= 2**-7 |ref| + 1e-6)."""
    from midvision_probe_torch.ops.rope2d import _rope_2d_plain, rope_2d

    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    # (name, B, H, gh, gw, dim, prefix, dtype, timed)
    cases = [
        ("crocov2_q_bf16", 64, 12, 14, 14, 64, 0, bf16, True),
        ("crocov2_q_fp32", 8, 12, 14, 14, 64, 0, f32, False),
        ("nonsquare_4x3_bf16", 2, 2, 4, 3, 64, 0, bf16, False),
        ("prefix1_bf16", 4, 12, 14, 14, 64, 1, bf16, False),
        ("dim16_bf16", 2, 4, 8, 8, 16, 0, bf16, False),
    ]
    results = []
    for name, B, H, gh, gw, dim, prefix, dtype, timed in cases:
        N = gh * gw
        qkv = torch.randn(B, prefix + N, 3, H, dim, device="cuda", generator=gen).to(dtype)
        q = qkv.permute(2, 0, 3, 1, 4)[0][:, :, prefix:]  # strided (B, H, N, dim)
        yy, xx = torch.meshgrid(torch.arange(gh, device="cuda", dtype=torch.int32),
                                torch.arange(gw, device="cuda", dtype=torch.int32),
                                indexing="ij")
        pos = torch.stack([yy.reshape(-1), xx.reshape(-1)], -1)[None].expand(B, N, 2)
        with torch.no_grad():
            out = rope_2d(q, pos)
            ref = _rope_2d_plain(q, pos)
        torch.cuda.synchronize()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        if dtype == f32:
            ok = err <= 1e-5
        else:
            ok = bool((diff <= 2.0**-7 * ref.float().abs() + 1e-6).all())
        finite = bool(torch.isfinite(out).all())
        res = {"case": name, "shape": [B, H, N, dim], "prefix": prefix, "dtype": str(dtype),
               "max_abs_err": err, "finite": finite, "ok": finite and ok}
        if timed:
            with torch.no_grad():
                res["kernel_ms"] = cuda_ms(torch, lambda: rope_2d(q, pos), iters=20)
                res["plain_ms"] = cuda_ms(torch, lambda: _rope_2d_plain(q, pos), iters=10)
            # q read and the output written once, the positions read once;
            # ~6 f32 operations per pair and head (outside the tensor cores)
            nbytes = 2.0 * B * H * N * dim * q.element_size() + 4.0 * B * N * 2
            t_ops = 3.0 * B * H * N * dim / PEAK_FP32_FLOPS
            t_bytes = nbytes / PEAK_BYTES
            res["bound_ms"] = max(t_ops, t_bytes) * 1e3
            res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
            res["library_ms"] = None  # no single PyTorch call computes it
        results.append(res)
        del qkv, q, out, ref, diff
        torch.cuda.empty_cache()
    emit({"phase": "rope_checks", "cases": results})
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"rope check failed: {bad}")
    return {r["case"]: r for r in results}


# the attention bench's shape: ViT-B/16 at 480x640, 1201 tokens padded to
# 1280, 12 heads of 64, batch 64; and the same tokens in 16 heads of 16 (the
# JAX bench's --hd 16 at that width), which K7 and K8 run on mma_sync
BENCH_SHAPE = (64, 1280, 12, 64)
BENCH_SHAPE_D16 = (64, 1280, 16, 16)
BENCH_N_VALID = 1201


def bench_inputs(torch, gen, kind, shape=BENCH_SHAPE):
    """bf16 qkv (B, N, 3, H, d) on the card. ``bench``: randn * 0.6 (the
    bench's); ``clamp``: q and k at std 5 (base-2 scores far above 110), v
    at std 0.25 (|o| near 1); ``underflow``: the bench's, with positive keys
    and the first 64 query rows at -64, so that every exp2 of those rows
    underflows (scores below -2^8) and l takes the 1e-30 floor;
    ``poisoned``: the bench's, with q and k at +-3e4 in the rows >=
    BENCH_N_VALID (K8's per-head scales must not see them)."""
    B, N, H, d = shape
    std = torch.tensor([5.0, 5.0, 0.25] if kind == "clamp" else [0.6] * 3, device="cuda")
    qkv = (torch.randn(B, N, 3, H, d, device="cuda", generator=gen)
           * std[:, None, None]).to(torch.bfloat16)
    if kind == "underflow":
        qkv[:, :, 1] = qkv[:, :, 1].abs()
        qkv[:, :64, 0] = -64.0
    if kind == "poisoned":
        qkv[:, BENCH_N_VALID:, :2] = 3e4
        qkv[:, BENCH_N_VALID:, :2, :, ::2] = -3e4
    return qkv


def int8_bounds(B, N, n_valid, H, d) -> dict:
    """Least time for K8's attention kernel: QK^T at the int8 peak plus PV at
    the bf16 peak, one exp2 per score on the MUFU, or q8 and k8 (rows of
    d_pad bytes), v and the output (2 bytes an element) moved once."""
    half = 2.0 * B * H * N * n_valid * d
    dp = -(-d // 32) * 32
    nbytes = 2.0 * B * N * H * dp + 4.0 * B * N * H * d
    return bounds((half / PEAK_INT8_OPS + half / PEAK_BF16_FLOPS) * 1e3,
                  nbytes / PEAK_BYTES * 1e3, exp2_ms(B, H, N, n_valid))


def int8_prologue_bounds(B, N, n_valid, H, d) -> dict:
    """Least time for K8's prologue, two passes over q and k in bf16: the
    amax pass reads the valid rows, the quantize pass reads every row and
    writes q8 and k8 (rows of d_pad bytes)."""
    dp = -(-d // 32) * 32
    nbytes = 4.0 * B * n_valid * H * d + 4.0 * B * N * H * d + 2.0 * B * N * H * dp
    return bounds(0.0, nbytes / PEAK_BYTES * 1e3)


def phase_variant_checks(torch):
    """K7 (``wide4``, ``stagger4``, ``wide12``), K8 (``int8``) and K9
    (``splash``) against their plain versions at the bench shape (B=64,
    N=1280, n_valid=1201, H=12, d=64, bf16): the bench's inputs (timed), a
    case where min(s, 110) clamps (its count of clamped scores, on the plain
    side, must be > 0), n_valid = N, rows whose exponentials all underflow
    (the plain side's unfloored l must be < 1e-30 there), and K7 and K8 at
    head dim 16 (16 heads). Pass: finite, the route that ``wide_route`` /
    ``int8_route`` names (K9 wgmma), max abs error <= min(1.6e-2, 2^-6 *
    max|ref|): both sides round p and the output to bf16 and sum in other
    orders, a few bf16 ulps of the largest output (2^-6 of it is two to four
    such ulps; the cap binds only where |o| nears 1, in the clamp case).
    K8's timed case splits its time into the prologue, the attention kernel
    alone and both, each with its bound. Then K8's prologue
    (``quantize_qk_heads``) against ``quantize_qk`` at the bench shape, on
    the bench's inputs (timed) and with rows past n_valid at +-3e4: q8 and
    k8 equal bit for bit, the pad zero, c within two f32 ulps."""
    import torch.nn.functional as F

    from midvision_probe_torch import bench_attn as ba

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(4)
    variants = {  # name: (kernel, wrapper (qkv, scale, n_valid), plain version)
        "wide4": ("K7", lambda x, sc, n: ba.wide_attention(x, sc, n, width=4 * x.shape[-1]),
                  ba._wide_attention_plain),
        "stagger4": ("K7", lambda x, sc, n: ba.wide_attention(
            x, sc, n, width=4 * x.shape[-1], stagger=True), ba._wide_attention_plain),
        "wide12": ("K7", lambda x, sc, n: ba.wide_attention(x, sc, n, width=12 * x.shape[-1]),
                   ba._wide_attention_plain),
        "int8": ("K8", ba.int8_attention, ba._int8_attention_plain),
        "splash": ("K9", ba.splash_attention, ba._splash_attention_plain),
    }
    nv = BENCH_N_VALID
    N = BENCH_SHAPE[1]
    cases = ([(v, "bench", nv, BENCH_SHAPE, True) for v in variants]
             + [(v, kind, n, BENCH_SHAPE, False) for kind, n in (("clamp", nv), ("bench", N))
                for v in ("wide4", "int8", "splash")]
             + [(v, "underflow", nv, BENCH_SHAPE, False) for v in ("wide4", "int8")]
             + [(v, "bench", nv, BENCH_SHAPE_D16, False) for v in ("wide4", "int8")])
    results = []
    for variant, kind, n_valid, shape, timed in cases:
        kernel, fn, plain = variants[variant]
        B, N, H, d = shape
        scale = d**-0.5
        qkv = bench_inputs(torch, gen, kind, shape)
        with torch.no_grad():
            out, ran = route_ran(lambda: fn(qkv, scale, n_valid))
            ref = plain(qkv, scale, n_valid)
        route = {"K7": ba.wide_route, "K8": ba.int8_route, "K9": lambda _: "wgmma"}[kernel](d)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        max_ref = ref.float().abs().max().item()
        tol = min(1.6e-2, 2.0**-6 * max_ref)
        finite = bool(torch.isfinite(out).all())
        name = variant if kind == "bench" and n_valid == nv else (
            f"{variant}_{kind}" if n_valid == nv else f"{variant}_n_valid_{n_valid}")
        if shape != BENCH_SHAPE:
            name = f"{variant}_d{d}"
        res = {"case": name, "kernel": kernel, "shape": [B, N, H, d], "n_valid": n_valid,
               "inputs": kind, "route": route, "route_ran": ran, "max_abs_err": err,
               "max_abs_ref": max_ref, "tol": tol, "finite": finite}
        ok = finite and err <= tol and ran == route
        if kind in ("clamp", "underflow") and kernel != "K9":  # the plain side's scores
            scores = ba.int8_scores if kernel == "K8" else ba.wide_scores
            s2 = scores(qkv, scale, n_valid)
            if kind == "clamp":
                res["clamped_scores"] = int((s2 > 110).sum())
                ok = ok and res["clamped_scores"] > 0
            else:
                res["max_unfloored_l"] = (
                    torch.exp2(s2[:, :, :64].clamp(max=110.0)).sum(-1).max().item())
                res["max_abs_out_underflow_rows"] = ref[:, :64].float().abs().max().item()
                ok = ok and res["max_unfloored_l"] < 1e-30
            del s2
        res["ok"] = ok
        if timed:
            q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)  # (B, H, N, d) views
            with torch.no_grad():
                sdpa_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    q, k[:, :, :n_valid], v[:, :, :n_valid], scale=scale))
                if kernel == "K8":
                    q8, k8, c = ba.quantize_qk_heads(qkv, scale, n_valid)
                    res["kernel_ms"] = cuda_ms(
                        torch, lambda: ba._launch_int8(q8, k8, c, qkv, n_valid, 128))
                    res["prologue_ms"] = cuda_ms(
                        torch, lambda: ba.quantize_qk_heads(qkv, scale, n_valid))
                    res["with_prologue_ms"] = cuda_ms(torch, lambda: fn(qkv, scale, n_valid))
                    res.update(int8_bounds(B, N, n_valid, H, d))
                    pro = int8_prologue_bounds(B, N, n_valid, H, d)
                    res["prologue_bound_ms"], res["prologue_bound_by"] = (
                        pro["bound_ms"], pro["bound_by"])
                    # the two run one after the other: the scales need every
                    # valid row before the first score
                    res["with_prologue_bound_ms"] = res["bound_ms"] + pro["bound_ms"]
                    res["with_prologue_bound_by"] = f"{pro['bound_by']} + {res['bound_by']}"
                    # no single PyTorch call computes int8 attention; SDPA in
                    # bf16 on the same keys is a comparison only
                    res["library_ms"] = None
                    res["sdpa_bf16_ms"] = sdpa_ms
                    del q8, k8, c
                else:
                    res["kernel_ms"] = cuda_ms(torch, lambda: fn(qkv, scale, n_valid))
                    res.update(attention_bounds(B, N, n_valid, H, d, 2, PEAK_BF16_FLOPS))
                    res["library_ms"] = sdpa_ms
                res["plain_ms"] = cuda_ms(torch, lambda: plain(qkv, scale, n_valid), iters=3,
                                          warmup=1)
            del q, k, v
        results.append(res)
        del qkv, out, ref
        torch.cuda.empty_cache()

    B, N, H, d = BENCH_SHAPE
    scale = d**-0.5
    for kind in ("bench", "poisoned"):
        qkv = bench_inputs(torch, gen, kind)
        with torch.no_grad():
            q8, k8, c = ba.quantize_qk_heads(qkv, scale, nv)
            rq, rk, rc = ba.quantize_qk(qkv, scale, nv)
        torch.cuda.synchronize()
        diff = max((q8[..., :d] - rq.transpose(1, 2)).abs().max().item(),
                   (k8[..., :d] - rk.transpose(1, 2)).abs().max().item())
        res = {"case": f"int8_prologue_{kind}", "kernel": "K8 prologue", "shape": [B, N, H, d],
               "n_valid": nv, "inputs": kind,
               "q8_equal": torch.equal(q8[..., :d], rq.transpose(1, 2)),
               "k8_equal": torch.equal(k8[..., :d], rk.transpose(1, 2)),
               "pad_zero": bool((q8[..., d:] == 0).all() and (k8[..., d:] == 0).all()),
               "c_max_ulps": (c.view(torch.int32) - rc.view(torch.int32)).abs().max().item(),
               "max_abs_err": float(diff)}
        res["ok"] = (res["q8_equal"] and res["k8_equal"] and res["pad_zero"]
                     and res["c_max_ulps"] <= 2)
        if kind == "bench":
            with torch.no_grad():
                res["kernel_ms"] = cuda_ms(torch, lambda: ba.quantize_qk_heads(qkv, scale, nv))
                res["plain_ms"] = cuda_ms(torch, lambda: ba.quantize_qk(qkv, scale, nv))
            res.update(int8_prologue_bounds(B, N, nv, H, d))
            res["library_ms"] = None  # no single PyTorch call computes it
        results.append(res)
        del qkv, q8, k8, c, rq, rk, rc
        torch.cuda.empty_cache()
    emit({"phase": "variant_checks", "cases": results})
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"variant check failed: {bad}")
    return {r["case"]: r for r in results}


def mlp_inputs(torch, gen, M, C, H, dtype):
    """x (M, C) ~ N(0, 1), w1 (C, H) and w2 (H, C) at std fan_in^-1/2,
    biases at std 0.1, so that the hidden and output values are O(1)."""
    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen) * std).to(dtype)

    return [rnd(M, C), rnd(C, H, std=C**-0.5), rnd(H, std=0.1), rnd(H, C, std=H**-0.5),
            rnd(C, std=0.1)]


def mlp_bound_ms(M, C, H, itemsize, peak) -> tuple[float, str]:
    """Least time for one K6 call: the two products (4*M*C*H) at the
    dtype's peak, or x, the weights and biases read once and the output
    written once, at the memory rate."""
    t_ops = 4.0 * M * C * H / peak
    t_bytes = (2.0 * M * C + 2.0 * C * H + H + C) * itemsize / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


MLP_ROWS = 64 * 1201  # a 64-image batch of ViT-B/16 or ViT-H/16 tokens at 480x640


def f32_mlp_bounds(M, C, H) -> dict:
    """The least time of an f32 K6 call: three TF32 products per product at
    the TF32 peak as ``bound_ms`` (six bf16 products at the bf16 peak, the
    kernel's, take the same to 0.1%), and f32 FMA outside the tensor cores
    as ``bound_simt_ms``."""
    tf32, by = mlp_bound_ms(M, C, H, 4, PEAK_TF32_FLOPS / 3)
    simt, _ = mlp_bound_ms(M, C, H, 4, PEAK_FP32_FLOPS)
    return {"bound_ms": tf32, "bound_by": by, "bound_simt_ms": simt}


def phase_mlp_checks(torch):
    """K6 (``fused_mlp``) at DINO ViT-B/16's MLP (M = 76,864, C = 768, H =
    3072) and RADIO-v2 ViT-H/16's (C = 1280, H = 5120) in bf16 and f32 with
    gelu_tanh (the ViT's bf16 GELU), timed; every activation in bf16 and f32
    at M = 300; f32 at ViT-S's (C = 384) and ViT-g's (C = 1536) widths, H =
    4C, M = 300, and at one row of DINO's. Pass: bf16 every element within
    one bf16 ulp of its ``_fused_mlp_plain`` value plus one bf16 ulp of the
    largest plain output (the hidden activations round to bf16 on both
    sides; a different f32 summation order can flip one of those roundings,
    which moves a whole output row by a hidden ulp times a W2 entry). f32
    (TF32 off): the kernel within 1e-5 abs of ``_fused_mlp_exact`` (float64
    products and sums, rounded where the kernel rounds) and no farther from
    it than ``_fused_mlp_plain`` is (cuBLAS's f32 chain is itself ~1e-5 off
    at the timed shapes); each f32 case prints ``err_vs_exact``,
    ``plain_err_vs_exact`` and ``err_vs_plain``."""
    import torch.nn.functional as F

    from midvision_probe_torch.ops.fused_mlp import (
        ACTIVATIONS,
        _fused_mlp_exact,
        _fused_mlp_plain,
        fused_mlp,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("dino_bf16", MLP_ROWS, 768, 3072, bf16, "gelu_tanh", True),
             ("dino_fp32", MLP_ROWS, 768, 3072, f32, "gelu_tanh", True),
             ("radio_bf16", MLP_ROWS, 1280, 5120, bf16, "gelu_tanh", True),
             ("radio_fp32", MLP_ROWS, 1280, 5120, f32, "gelu_tanh", True),
             *[(f"{act}_{str(dt)[6:]}", 300, 768, 3072, dt, act, False)
               for act in ACTIVATIONS for dt in (bf16, f32)],
             ("vit_s_fp32", 300, 384, 1536, f32, "gelu", False),
             ("vit_g_fp32", 300, 1536, 6144, f32, "gelu_tanh", False),
             ("one_row_fp32", 1, 768, 3072, f32, "quickgelu", False)]
    results = []
    for name, M, C, H, dtype, act, timed in cases:
        args = mlp_inputs(torch, gen, M, C, H, dtype)
        with torch.no_grad():
            out = fused_mlp(*args, act=act)
            ref = _fused_mlp_plain(*args, act=act)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(out).all())
        res = {"case": name, "shape": [M, C, H], "dtype": str(dtype), "act": act,
               "finite": finite}
        if dtype == f32:
            exact = _fused_mlp_exact(*args, act=act)
            res.update(err_vs_exact=(out - exact).abs().max().item(),
                       plain_err_vs_exact=(ref - exact).abs().max().item(),
                       err_vs_plain=(out - ref).abs().max().item())
            res["max_abs_err"] = res["err_vs_exact"]
            ok = res["err_vs_exact"] <= 1e-5 and res["err_vs_exact"] <= res["plain_err_vs_exact"]
            del exact
        else:
            diff = (out.float() - ref.float()).abs()
            mag = ref.float().abs()
            res["max_abs_err"] = diff.max().item()
            ok = bool((diff <= 2.0**-7 * (mag + mag.max())).all())
            del diff, mag
        res["ok"] = finite and ok
        if timed:
            x, w1, b1, w2, b2 = args
            approximate = "tanh" if act == "gelu_tanh" else "none"
            with torch.no_grad():
                res["kernel_ms"] = cuda_ms(torch, lambda: fused_mlp(*args, act=act), iters=10)
                res["plain_ms"] = cuda_ms(torch, lambda: _fused_mlp_plain(*args, act=act),
                                          iters=3, warmup=1)
                res["library_ms"] = cuda_ms(torch, lambda: F.linear(
                    F.gelu(F.linear(x, w1.t(), b1), approximate=approximate), w2.t(), b2),
                    iters=10)
            if dtype == bf16:
                res["bound_ms"], res["bound_by"] = mlp_bound_ms(M, C, H, 2, PEAK_BF16_FLOPS)
            else:
                res.update(f32_mlp_bounds(M, C, H))
        results.append(res)
        del args, out, ref
        torch.cuda.empty_cache()

    emit({"phase": "mlp_checks", "cases": results, "gpu_state": gpu_state()})
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"mlp check failed: {bad}")
    return {r["case"]: r for r in results}


# the launch counts read after every path: K1 fused_qkv_attention, K2
# vit_attention, K3 the long-sequence route, K4 knn2, K5 rope_2d, K6
# fused_mlp, K7 wide_attention, K8 int8_attention and its prologue
# quantize_qk_heads (k8p), K9 splash_attention, and the backwards K10 (of
# K3) and K11 (of K9)
KERNELS = ("k1", "k2", "k3", "k4", "k5", "k6", "k7", "k8", "k8p", "k9", "k10", "k11")


def _counters():
    """Each kernel's count as (wrapper, attribute): ``launches``, and
    ``backward_launches`` for K10 and K11 beside their forwards'."""
    from midvision_probe_torch import bench_attn
    from midvision_probe_torch.ops.attention import _flash_attention
    from midvision_probe_torch.ops.fused_mlp import fused_mlp
    from midvision_probe_torch.ops.matching import knn2
    from midvision_probe_torch.ops.rope2d import rope_2d
    from midvision_probe_torch.ops.vit_attention import fused_qkv_attention, vit_attention

    forwards = (fused_qkv_attention, vit_attention, _flash_attention, knn2, rope_2d,
                fused_mlp, bench_attn.wide_attention, bench_attn.int8_attention,
                bench_attn.quantize_qk_heads, bench_attn.splash_attention)
    counters = {k: (fn, "launches") for k, fn in zip(KERNELS, forwards)}
    counters.update(k10=(_flash_attention, "backward_launches"),
                    k11=(bench_attn.splash_attention, "backward_launches"))
    return counters


# the attention kernel's launches by route (``route_launches``): K1, K2, K3,
# K7, K8 and K9 together
ROUTE_KEYS = ("route_wgmma", "route_mma_sync", "route_tf32x3")


def reset_counts() -> None:
    """Zero every kernel's launch count, the attention routes' counts and
    the backbone's forward count, just before a path is driven."""
    from midvision_probe_torch.models.feature_extractor import FeatureExtractor
    from midvision_probe_torch.ops.vit_attention import route_launches

    for fn, attr in _counters().values():
        setattr(fn, attr, 0)
    for route in route_launches:
        route_launches[route] = 0
    FeatureExtractor.forward_count = 0


def read_counts() -> dict:
    """Every kernel's launch count, the attention launches by route and the
    backbone forwards since the last ``reset_counts``."""
    from midvision_probe_torch.models.feature_extractor import FeatureExtractor
    from midvision_probe_torch.ops.vit_attention import route_launches

    counts = {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}
    counts.update({f"route_{r}": n for r, n in route_launches.items()})
    counts["forwards"] = FeatureExtractor.forward_count
    return counts


def per_forward_ok(counts: dict, per_forward: dict) -> bool:
    """Each attention kernel and route launched exactly its count per
    backbone forward (and at least one forward ran)."""
    return counts["forwards"] > 0 and all(
        counts[k] == n * counts["forwards"] for k, n in per_forward.items())


# launches per backbone forward of the three backbones (no backbone
# reaches K6-K9, and a frozen forward runs no backward, K10 or K11), and the
# attention route each takes: bf16 at d = 64 (DINO, CroCo-v2) and d = 80
# (RADIO-v2) on wgmma, f32 on tf32x3
NO_BENCH_KERNELS = {"k6": 0, "k7": 0, "k8": 0, "k8p": 0, "k9": 0, "k10": 0, "k11": 0}


def on_route(route: str, n: int) -> dict:
    return {key: n if key == f"route_{route}" else 0 for key in ROUTE_KEYS}


DINO_PER_FORWARD = {"k1": 12, "k2": 0, "k3": 0, "k5": 0, **NO_BENCH_KERNELS,
                    **on_route("wgmma", 12)}
CROCOV2_PER_FORWARD = {"k1": 0, "k2": 12, "k3": 0, "k5": 24, **NO_BENCH_KERNELS,
                       **on_route("wgmma", 12)}
RADIO_PER_FORWARD = {"k1": 0, "k2": 32, "k3": 0, "k5": 0, **NO_BENCH_KERNELS,
                     **on_route("wgmma", 32)}


# launches per backbone forward of the plain-ViT paths' backbones: CLIP
# ViT-L/14 in bf16 (24 blocks, 16 heads of 64), and a ViT-B in float32 (CLIP
# ViT-B/16 on the 2AFC path, DINO ViT-B/16 on the SPair path), all on K1
CLIP_L_PER_FORWARD = {"k1": 24, "k2": 0, "k3": 0, "k5": 0, **NO_BENCH_KERNELS,
                      **on_route("wgmma", 24)}
VIT_B_F32_PER_FORWARD = {"k1": 12, "k2": 0, "k3": 0, "k5": 0, **NO_BENCH_KERNELS,
                         **on_route("tf32x3", 12)}


# launches per backbone forward of the backbones that reach no hand-written
# kernel: the relative-position-bias ViTs (BEiT-v2, MiDaS; the biased
# einsum route, as in the JAX package) and ResNet-50 (cuDNN convolutions)
NO_KERNEL_PER_FORWARD = {"k1": 0, "k2": 0, "k3": 0, "k4": 0, "k5": 0, **NO_BENCH_KERNELS,
                         **on_route("wgmma", 0)}


BENCH_VARIANTS = ("base", "wide4", "stagger4", "wide12", "int8", "splash")
# every bench variant's max abs error against the f32 oracle: a few bf16
# ulps at the output's largest magnitude (~0.25), plus int8's quantization
BENCH_ORACLE_BOUND = 5e-3


def phase_bench_attn(torch, iters: int = 20):
    """The attention bench through its entry point
    (``midvision_probe_torch.bench_attn.main``) at its defaults with every
    variant: its lines and numbers, the launch counts (each variant: one
    warm-up, ``iters`` timed and one checked call; K1 for ``base``, K7 for
    the three wide variants, K8 and its prologue, K9; every other count 0;
    all six on the wgmma route), and each
    variant's max abs error against the f32 oracle within
    ``BENCH_ORACLE_BOUND``. Returns the launch counts."""
    from midvision_probe_torch import bench_attn

    reset_counts()
    t0 = time.perf_counter()
    results = bench_attn.main(["--iters", str(iters), "--variants", *BENCH_VARIANTS])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    calls = iters + 2
    expected = dict.fromkeys(KERNELS + ROUTE_KEYS, 0)
    # base (K1), the three wide variants (K7 at d = 64), int8 (K8 at d = 64)
    # and splash (K9) on wgmma
    expected.update(k1=calls, k7=3 * calls, k8=calls, k8p=calls, k9=calls,
                    route_wgmma=6 * calls, forwards=0)
    emit({"phase": "bench_attn", "results": results, "launches": counts,
          "oracle_bound": BENCH_ORACLE_BOUND, "wall_s": wall})
    checks = {
        "every_variant": [r["variant"] for r in results] == list(BENCH_VARIANTS),
        "within_oracle_bound": all(r["max_abs_err"] <= BENCH_ORACLE_BOUND for r in results),
        "launches": counts == expected,
    }
    if not all(checks.values()):
        raise SystemExit(f"bench_attn check failed: {checks}")
    return counts


def phase_path_fused_mlp(torch, blocks: int = 12):
    """The fused MLP as a library op (no model dispatches it): a residual
    stack ``x = x + fused_mlp(x, ...)`` of ``blocks`` blocks at DINO
    ViT-B/16's MLP width over a 64-image batch at 480x640 (M = 76,864, C =
    768, H = 3072, bf16, gelu_tanh, seeded random weights per block): wall
    time, a finite output, launch counts (K6 once per block, every other
    count 0). Returns the launch counts."""
    from midvision_probe_torch.ops.fused_mlp import fused_mlp

    gen = torch.Generator(device="cuda").manual_seed(6)
    x = mlp_inputs(torch, gen, MLP_ROWS, 768, 3072, torch.bfloat16)[0]
    weights = [mlp_inputs(torch, gen, 1, 768, 3072, torch.bfloat16)[1:]
               for _ in range(blocks)]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        for w1, b1, w2, b2 in weights:
            x = x + fused_mlp(x, w1, b1, w2, b2, act="gelu_tanh")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    expected = dict.fromkeys(KERNELS + ROUTE_KEYS, 0)
    expected.update(k6=blocks, forwards=0)
    finite = bool(torch.isfinite(x).all())
    emit({"phase": "path_fused_mlp", "shape": [MLP_ROWS, 768, 3072], "blocks": blocks,
          "launches": counts, "finite": finite, "wall_s": wall,
          "ms_per_block": wall * 1e3 / blocks})
    if not finite or counts != expected:
        raise SystemExit(f"path_fused_mlp check failed: finite {finite}, launches {counts}")
    del x, weights
    torch.cuda.empty_cache()
    return counts


def profile_entry(torch, module, argv) -> dict:
    """One more run of a driver under ``torch.profiler``: its wall time
    there, the device time summed over kernels, the device's busy share of
    the wall time and the top kernels by device time."""
    out_dir = tempfile.mkdtemp(prefix="mvp_chip_smoke_")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            module.entry(argv + [f"output_dir={out_dir}"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    by_kernel = sorted(
        ((e.key, e.device_time_total / 1e3) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA), key=lambda kv: -kv[1])
    device_ms = sum(t for _, t in by_kernel)
    return {"profiled_wall_s": wall, "profile_device_ms": device_ms,
            "device_busy_share": device_ms / (wall * 1e3),
            "profile_top": [[k[:80], t] for k, t in by_kernel[:8]]}


def phase_correspondence(torch, phase, module, argv, n_pairs, batch_pairs, k4_ms,
                         per_forward, artifacts=None, profile=True):
    """One correspondence driver through its ``entry`` on the card: the
    CSV row, the launch counts (K4 once per pair batch; the attention
    kernels ``per_forward`` times per backbone forward, two forwards per
    batch), wall time, peak memory and K4's share of the wall time
    (launches x ``k4_ms``, K4's time at this path's shape in
    ``knn2_checks``); then, with ``profile``, a profiled run for the
    device's busy share and its top kernels. ``artifacts(out_dir)`` reads
    the run's files: ``(report, checks)``. Returns the launch counts of the
    first run."""
    out_dir = tempfile.mkdtemp(prefix="mvp_chip_smoke_")
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = module.entry(argv + [f"output_dir={out_dir}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
        files, file_checks = artifacts(out_dir) if artifacts else ({}, {})
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    row = {k: float(v) for k, v in out["row"].items()}
    batches = -(-n_pairs // batch_pairs)
    res = {"phase": phase, "argv": argv, "csv_files": csvs, "csv_row": row,
           "launches": counts, "pair_batches": batches,
           "backbone_forwards": counts["forwards"],
           "valid_matches": int(out["valid"].sum()),
           "errors_shape": list(out["err_3d"].shape), "wall_s": wall,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "k4_ms_per_launch": k4_ms,
           "k4_share_of_wall": counts["k4"] * k4_ms / (wall * 1e3)}
    if artifacts:
        res["artifacts"] = files
    if profile:
        res.update(profile_entry(torch, module, argv))
    emit(res)
    recalls = [v for k, v in row.items() if not k.startswith("Bin")]
    bins = [v for k, v in row.items() if k.startswith("Bin")]
    checks = {
        "csv_written": len(csvs) == 1,
        "recalls_in_range": bool(recalls) and all(0.0 <= v <= 100.0 for v in recalls),
        # a rotation bin without pairs is NaN by the protocol's definition
        "bins_in_range": any(math.isfinite(v) for v in bins)
        and all(0.0 <= v <= 100.0 for v in bins if not math.isnan(v)),
        "valid_has_mass": res["valid_matches"] > 0,
        "errors_shape": res["errors_shape"] == [n_pairs, int(dict(
            a.split("=", 1) for a in argv if "=" in a)["num_corr"])],
        "k4_once_per_batch": counts["k4"] == batches,
        "two_forwards_per_batch": counts["forwards"] == 2 * batches,
        "attention_per_forward": per_forward_ok(counts, per_forward),
        **file_checks,
    }
    if not all(checks.values()):
        raise SystemExit(f"{phase} check failed: {checks}")
    return counts


def scannet_render_artifacts(n_pairs: int, render_every: int):
    """``artifacts`` of the ScanNet driver's renders: under its render
    directory, ``instance_{i}`` for every ``render_every``-th pair, each with
    the three PNGs and ``correspondence_metrics.json``."""
    expected = {f"instance_{i}" for i in range(0, n_pairs, render_every)}
    names = {"original_views.png", "correspondences.png", "correspondences_sparse200.png",
             "correspondence_metrics.json"}

    def read(out_dir):
        found = {}
        for dirpath, _, files in os.walk(out_dir):
            if os.path.basename(dirpath).startswith("instance_"):
                found[os.path.basename(dirpath)] = sorted(files)
        return ({"instances": found},
                {"instances_rendered": set(found) == expected,
                 "three_pngs_and_json_each": all(set(f) == names for f in found.values())})

    return read


def depth_artifacts(out_dir: str, n_test: int, batch: int) -> tuple[dict, dict]:
    """The depth trainer's ``render_images`` files in a run's output
    directory: ``2 * min(8, B)`` first-batch PNGs and 4 files (pred and
    target PNG, metrics JSON and TXT) per test image of the first 6 batches
    under ``val_images/``, and one scatter PNG under ``plots/``."""
    val, plots = [], []
    for dirpath, _, files in os.walk(out_dir):
        if os.path.basename(dirpath) == "val_images":
            val += files
        elif os.path.basename(dirpath) == "plots":
            plots += [f for f in files if f.endswith(".png")]
    first = [f for f in val if f.startswith("firstbatch_")]
    dumped = min(n_test, 6 * batch)
    per_image = {kind: len([f for f in val if f.startswith(kind)])
                 for kind in ("pred_depth_", "target_depth_")}
    per_image.update({ext: len([f for f in val if f.startswith("metrics_depth_")
                                and f.endswith(ext)]) for ext in (".json", ".txt")})
    report = {"firstbatch_pngs": len(first), "per_image_files": per_image,
              "scatter_pngs": len(plots)}
    return report, {"firstbatch_pngs": len(first) == 2 * min(8, batch, n_test),
                    "four_files_per_dumped_image":
                        all(n == dumped for n in per_image.values())
                        and len(val) == len(first) + 4 * dumped,
                    "one_scatter_png": len(plots) == 1}


# the depth paths' synthetic set and batch (its test split as large)
DEPTH_ITEMS, DEPTH_BATCH = 16, 8


def phase_path(torch, phase, backbone, per_forward, render=False):
    """The depth trainer through its ``entry`` on ``backbone`` (480x640
    synthetic data, 16 instances, DPT probe, bf16 backbone): losses, the
    CSV row, the launch counts (``per_forward`` per backbone forward), wall
    time and peak memory; with ``render``, ``render_images`` at its default
    (on) and its files counted (``depth_artifacts``). Returns the launch
    counts."""
    from midvision_probe_torch import train_depth

    out_dir = tempfile.mkdtemp(prefix="mvp_chip_smoke_")
    try:
        argv = [f"backbone={backbone}", "dataset=synthetic",
                "dataset.image_size=[480,640]", f"dataset.num_instances={DEPTH_ITEMS}",
                "probe=depth_dpt", f"batch_size={DEPTH_BATCH}", "optimizer=one_epoch",
                "+system.backbone_dtype=bfloat16"]
        if not render:
            argv.append("+render_images=False")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        row = train_depth.entry(argv + [f"output_dir={out_dir}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
        files, file_checks = (depth_artifacts(out_dir, DEPTH_ITEMS, DEPTH_BATCH) if render
                              else ({}, {}))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses = row.pop("train_losses")
    res = {"phase": phase, "argv": argv, "train_losses": losses,
           "csv_files": csvs, "csv_row": row, "launches": counts,
           "backbone_forwards": counts["forwards"], "wall_s": wall,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    if render:
        res["artifacts"] = files
    emit(res)
    checks = {
        "losses_finite": bool(losses) and all(math.isfinite(x) for x in losses),
        "csv_written": len(csvs) == 1,
        "sa_rmse_finite": math.isfinite(row["sa_rmse"]),
        "sa_d1_in_unit": 0.0 <= row["sa_d1"] <= 1.0,
        "attention_per_forward": per_forward_ok(counts, per_forward),
        **file_checks,
    }
    if not all(checks.values()):
        raise SystemExit(f"{phase} check failed: {checks}")
    return counts


@contextlib.contextmanager
def checkpoints_in(ckpt_dir: str):
    """``$MVP_CHECKPOINT_DIR`` set to ``ckpt_dir`` and the zoo's
    ``random_init`` counted (the list of its calls is yielded); both are
    restored on exit, so the other phases keep their random init."""
    from midvision_probe_torch.models import zoo

    saved_dir = os.environ.get("MVP_CHECKPOINT_DIR")
    calls = []
    random_init = zoo.random_init

    def counted_random_init(module, seed=0):
        calls.append(seed)
        return random_init(module, seed)

    zoo.random_init = counted_random_init
    os.environ["MVP_CHECKPOINT_DIR"] = ckpt_dir
    try:
        yield calls
    finally:
        zoo.random_init = random_init
        if saved_dir is None:
            os.environ.pop("MVP_CHECKPOINT_DIR", None)
        else:
            os.environ["MVP_CHECKPOINT_DIR"] = saved_dir


@contextlib.contextmanager
def init_draws_timed():
    """``fit``'s init draw (``driver_common.init_from_loader``) timed, with
    the reader calls it made (the abandoned iterator's producer reads until
    it stops); one ``{"s", "reads", "items"}`` per draw is yielded."""
    from midvision_probe_torch.engine import driver_common

    draws = []
    init_from_loader = driver_common.init_from_loader

    class Counted:
        def __init__(self, dataset):
            self.dataset, self.reads = dataset, 0

        def __len__(self):
            return len(self.dataset)

        def __getitem__(self, i):
            self.reads += 1
            return self.dataset[i]

    def timed(trainer, loader):
        dataset = loader.dataset
        loader.dataset = counted = Counted(dataset)
        t0 = time.perf_counter()
        try:
            init_from_loader(trainer, loader)
        finally:
            loader.dataset = dataset
        draws.append({"s": time.perf_counter() - t0, "reads": counted.reads,
                      "items": len(dataset)})

    driver_common.init_from_loader = timed
    try:
        yield draws
    finally:
        driver_common.init_from_loader = init_from_loader


# the NYU tree of path_snorm_nyu: GeoNet-layout train frames and test-layout
# frames at NYU's 480x640
SNORM_TRAIN_FRAMES, SNORM_TEST_FRAMES = 16, 8


def make_nyu_tree(root: str, stems, seed: int) -> None:
    """One frame per stem in the reference's NYU layout: a uint8 RGB PNG,
    float32 depth in 0-12 m (some past the reader's 10 m), channel-first
    float32 normals (5% all-zero, invalid) and an npz ``panoptic_map`` with
    ids from STUFF, THINGS and neither."""
    import numpy as np
    from PIL import Image

    from midvision_probe_torch.utils.metrics import STUFF, THINGS

    rng = np.random.RandomState(seed)
    ids = np.array(STUFF[:6] + THINGS[:6] + (11, 40), np.int64)
    for sub in ("images", "depths", "normals", "segmentations"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for stem in stems:
        img = rng.randint(0, 256, (480, 640, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, "images", f"{stem}_image.png"))
        np.save(os.path.join(root, "depths", f"{stem}_depth.npy"),
                rng.rand(480, 640).astype(np.float32) * 12)
        snorm = rng.randn(3, 480, 640).astype(np.float32)
        snorm[:, rng.rand(480, 640) < 0.05] = 0.0
        np.save(os.path.join(root, "normals", f"{stem}_norm.npy"), snorm)
        np.savez(os.path.join(root, "segmentations", f"{stem}_image.npz"),
                 panoptic_map=ids[rng.randint(0, len(ids), (480, 640))])


def dino_vitb16_container(torch, seed: int = 10) -> dict:
    """A full-size raw DINO ViT-B/16 state dict in timm/DINO naming, as
    ``dino_vitb16.pth`` holds it (85,798,656 float32 parameters, the final
    ``norm`` included): every tensor N(0, 0.02) from a seeded generator,
    LayerNorm weights 1."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen) * 0.02

    C, F = 768, 3072
    sd = {"cls_token": normal(1, 1, C), "pos_embed": normal(1, 197, C),
          "patch_embed.proj.weight": normal(C, 3, 16, 16),
          "patch_embed.proj.bias": normal(C)}
    shapes = {"attn.qkv": (3 * C, C), "attn.proj": (C, C), "mlp.fc1": (F, C),
              "mlp.fc2": (C, F)}
    for i in range(12):
        for norm in ("norm1", "norm2"):
            sd[f"blocks.{i}.{norm}.weight"] = torch.ones(C)
            sd[f"blocks.{i}.{norm}.bias"] = normal(C)
        for name, shape in shapes.items():
            sd[f"blocks.{i}.{name}.weight"] = normal(*shape)
            sd[f"blocks.{i}.{name}.bias"] = normal(shape[0])
    sd["norm.weight"], sd["norm.bias"] = torch.ones(C), normal(C)
    return sd


def phase_path_snorm_nyu(torch, smi: str):
    """The surface-normal trainer (``midvision_probe_torch.train_snorm``)
    through its ``entry`` as the paper runs it: ``dataset=nyu`` (center
    crop and augmentation on, as the config has them) on a fabricated tree
    of 16 GeoNet train frames and 8 test frames, ``probe=snorm_dpt``
    (uncertainty-aware DPT), ``backbone=dino_b16`` in bf16 with its weights
    loaded from a full-size fabricated ``dino_vitb16.pth`` under a temporary
    ``$MVP_CHECKPOINT_DIR`` (restored afterwards, so the other phases keep
    their random init). First the zoo builds the backbone without the file
    (random init) and with it (the load; every loaded tensor must equal the
    container's cast to bf16, and ``random_init`` must not run); then the
    trainer: finite losses, one ``snorm_results_NYUv2_final.csv``, d1 <= d2
    <= d3 in [0, 1], rmse in [0, 180] degrees, K1 12 per backbone forward on
    the wgmma route, wall time, the init draw's time and reader calls
    (``init_draws_timed``) and peak memory. Returns the launch counts."""
    from midvision_probe_torch import train_snorm
    from midvision_probe_torch.models import zoo

    root = tempfile.mkdtemp(prefix="mvp_chip_smoke_nyu_")
    try:
        t0 = time.perf_counter()
        make_nyu_tree(os.path.join(root, "train"),
                      [f"scene_{i:04d}_{i * 7}" for i in range(SNORM_TRAIN_FRAMES)], seed=20)
        make_nyu_tree(os.path.join(root, "test"),
                      [f"nyuv2_test_{i}" for i in range(SNORM_TEST_FRAMES)], seed=21)
        tree_s = time.perf_counter() - t0
        ckpt_dir = os.path.join(root, "checkpoints")
        os.makedirs(ckpt_dir)
        container = dino_vitb16_container(torch)
        path = os.path.join(ckpt_dir, zoo.ZOO["dino_vitb16"].filename)
        torch.save(container, path)
        n_params = sum(t.numel() for t in container.values())

        def build():
            t0 = time.perf_counter()
            ext = zoo.build_vit_extractor("dino_vitb16", return_multilayer=True,
                                          dtype="bfloat16", device="cuda")
            torch.cuda.synchronize()
            return ext, time.perf_counter() - t0

        with checkpoints_in(os.path.join(root, "empty")) as inits_without_file:
            ext, random_init_s = build()
        del ext
        with checkpoints_in(ckpt_dir) as random_inits:
            ext, load_s = build()
            inits_with_file = len(random_inits)
            loaded = ext.module.state_dict()
            mismatched = [k for k, v in loaded.items()
                          if not torch.equal(v.cpu(), container[k].to(torch.bfloat16))]
            not_loaded = sorted(set(container) - set(loaded))
            del ext, loaded
            torch.cuda.empty_cache()

            out_dir = os.path.join(root, "out")
            argv = ["backbone=dino_b16", "dataset=nyu",
                    f"dataset.train_path={os.path.join(root, 'train')}",
                    f"dataset.test_path={os.path.join(root, 'test')}", "probe=snorm_dpt",
                    "batch_size=8", "optimizer=one_epoch", "+system.backbone_dtype=bfloat16",
                    "+render_images=False", f"output_dir={out_dir}"]
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            with init_draws_timed() as draws:
                row = train_snorm.entry(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            inits_in_run = len(random_inits) - inits_with_file
        csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = row.pop("train_losses")
    res = {"phase": "path_snorm_nyu", "argv": [a for a in argv if root not in a],
           "frames": {"train": SNORM_TRAIN_FRAMES, "test": SNORM_TEST_FRAMES},
           "tree_s": tree_s, "container_params": n_params,
           "random_init_build_s": random_init_s, "checkpoint_load_build_s": load_s,
           "container_keys_not_loaded": not_loaded, "mismatched_tensors": mismatched,
           "random_init_calls": {"without_file": len(inits_without_file),
                                 "with_file": inits_with_file, "in_run": inits_in_run},
           "train_losses": losses, "csv_files": csvs, "csv_row": row, "launches": counts,
           "backbone_forwards": counts["forwards"], "wall_s": wall, "init_draws": draws,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "nvidia_smi": smi, "gpu_state": gpu_state()}
    emit(res)
    checks = {
        "weights_loaded": not mismatched,
        # DINO's taps are raw block outputs: its final norm is not part of
        # the probing trunk, and the converter drops it as the JAX one does
        "only_final_norm_dropped": not_loaded == ["norm.bias", "norm.weight"],
        "random_init_only_without_file": res["random_init_calls"] == {
            "without_file": 1, "with_file": 0, "in_run": 0},
        "losses_finite": bool(losses) and all(math.isfinite(x) for x in losses),
        "csv_written": csvs == ["snorm_results_NYUv2_final.csv"],
        "recalls_ordered": 0.0 <= row["d1"] <= row["d2"] <= row["d3"] <= 1.0,
        "rmse_in_degrees": 0.0 <= row["rmse"] <= 180.0,
        "attention_per_forward": per_forward_ok(counts, DINO_PER_FORWARD),
    }
    if not all(checks.values()):
        raise SystemExit(f"path_snorm_nyu check failed: {checks}")
    return counts


def phase_path_depth_resnet50(torch, smi: str):
    """The depth trainer through its ``entry`` on ``backbone=simclr_resnet50
    dataset=nyu probe=depth_dpt`` with ``render_images`` at its default
    (on), batch 8, one epoch, bf16, on a fabricated NYU tree (16 GeoNet
    train and 8 test frames at 480x640) with SimCLR's trunk loaded from a
    full-size fabricated VISSL ``simclr_resnet50.torch``
    (``data_processing/torch_replicas.py``'s ``wrap_vissl`` around its
    torchvision-layout ``TorchResNet50``) under a temporary
    ``$MVP_CHECKPOINT_DIR``. Checks: every trunk tensor the zoo loads equal
    to the file's (in bf16; only BatchNorm's ``num_batches_tracked`` left
    out), no random init, the four taps' shapes at 480x640, finite losses,
    one CSV row, the artifacts by count (``depth_artifacts``) and no
    hand-written kernel launched (cuDNN's convolutions); wall time and
    peak memory. Returns the launch counts."""
    from midvision_probe_torch import train_depth
    from midvision_probe_torch.models import zoo

    sys.path.insert(0, os.path.join(HERE, "data_processing"))
    from torch_replicas import TorchResNet50, wrap_vissl

    root = tempfile.mkdtemp(prefix="mvp_chip_smoke_r50_")
    try:
        make_nyu_tree(os.path.join(root, "train"),
                      [f"scene_{i:04d}_{i * 7}" for i in range(SNORM_TRAIN_FRAMES)], seed=30)
        make_nyu_tree(os.path.join(root, "test"),
                      [f"nyuv2_test_{i}" for i in range(SNORM_TEST_FRAMES)], seed=31)
        ckpt_dir = os.path.join(root, "checkpoints")
        os.makedirs(ckpt_dir)
        trunk = TorchResNet50(seed=7).state_dict()
        torch.save(wrap_vissl(trunk), os.path.join(ckpt_dir,
                                                   zoo.ZOO["simclr_resnet50"].filename))
        with checkpoints_in(ckpt_dir) as random_inits:
            t0 = time.perf_counter()
            ext = zoo.SIMCLR(return_layers=[1, 2, 3, 4], return_multilayer=True,
                             dtype="bfloat16", device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            loaded = ext.module.state_dict()
            mismatched = [k for k, v in loaded.items()
                          if not torch.equal(v.cpu(), trunk[k].to(torch.bfloat16))]
            not_loaded = sorted(set(trunk) - set(loaded))
            with torch.no_grad():
                taps = [tuple(t.shape[1:]) for t in
                        ext.features(torch.randn(1, 480, 640, 3, device="cuda"))]
            del ext, loaded
            torch.cuda.empty_cache()

            out_dir = os.path.join(root, "out")
            argv = ["backbone=simclr_resnet50", "dataset=nyu",
                    f"dataset.train_path={os.path.join(root, 'train')}",
                    f"dataset.test_path={os.path.join(root, 'test')}", "probe=depth_dpt",
                    "batch_size=8", "optimizer=one_epoch", "+system.backbone_dtype=bfloat16",
                    f"output_dir={out_dir}"]
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            row = train_depth.entry(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
        files, file_checks = depth_artifacts(out_dir, SNORM_TEST_FRAMES, 8)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = row.pop("train_losses")
    res = {"phase": "path_depth_resnet50", "argv": [a for a in argv if root not in a],
           "frames": {"train": SNORM_TRAIN_FRAMES, "test": SNORM_TEST_FRAMES},
           "checkpoint_load_build_s": load_s, "trunk_tensors": len(trunk),
           "trunk_keys_not_loaded": len(not_loaded), "mismatched_tensors": mismatched,
           "random_init_calls": len(random_inits), "taps_at_480x640": taps,
           "train_losses": losses, "csv_files": csvs, "csv_row": row, "launches": counts,
           "backbone_forwards": counts["forwards"], "artifacts": files, "wall_s": wall,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "nvidia_smi": smi, "gpu_state": gpu_state()}
    emit(res)
    checks = {
        "weights_loaded": not mismatched,
        "only_num_batches_tracked_dropped": bool(not_loaded) and all(
            k.endswith(".num_batches_tracked") for k in not_loaded),
        "no_random_init": not random_inits,
        "taps": taps == [(120, 160, 256), (60, 80, 512), (30, 40, 1024), (15, 20, 2048)],
        "losses_finite": bool(losses) and all(math.isfinite(x) for x in losses),
        "csv_written": csvs == ["depth_results_NYUv2_final.csv"],
        "sa_d1_in_unit": 0.0 <= row["sa_d1"] <= 1.0,
        "no_kernel": per_forward_ok(counts, NO_KERNEL_PER_FORWARD),
        **file_checks,
    }
    if not all(checks.values()):
        raise SystemExit(f"path_depth_resnet50 check failed: {checks}")
    return counts


# the NAVI render path's pairs (``render_navi_correspondence.run``'s max_pairs)
NAVI_RENDER_PAIRS = 8


def phase_path_render_navi(torch, smi: str):
    """The NAVI render driver (``midvision_probe_torch.render_navi_
    correspondence``) through its ``entry`` on ``dino_b16`` (bf16, random
    weights), ``synthetic_navi_hard`` at 512x512, num_corr=1000, scale
    0.25, 8 pairs of batch 1: ``pair_{i}/errors.json`` for each pair and
    ``matches.png`` where it has matches, K1 24 a pair (two forwards of 12)
    on wgmma, K4 once a pair, wall time and peak memory. Returns the launch
    counts."""
    from midvision_probe_torch import render_navi_correspondence

    argv = ["backbone=dino_b16", "dataset=synthetic_navi_hard", "dataset.image_size=512",
            "num_corr=1000", "scale_factor=0.25", "+system.backbone_dtype=bfloat16"]
    out_dir = tempfile.mkdtemp(prefix="mvp_chip_smoke_")
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        render_dir = render_navi_correspondence.entry(argv + [f"output_dir={out_dir}"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        pairs = {}
        for name in sorted(os.listdir(render_dir)):
            with open(os.path.join(render_dir, name, "errors.json")) as f:
                errors = json.load(f)
            pairs[name] = {"num_matches": errors["num_matches"],
                           "err3d_mean": errors["err3d_mean"],
                           "files": sorted(os.listdir(os.path.join(render_dir, name)))}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    res = {"phase": "path_render_navi", "argv": argv, "pairs": pairs, "launches": counts,
           "backbone_forwards": counts["forwards"], "wall_s": wall,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "nvidia_smi": smi, "gpu_state": gpu_state()}
    emit(res)
    checks = {
        "every_pair": sorted(pairs) == [f"pair_{i}" for i in range(NAVI_RENDER_PAIRS)],
        "png_where_matches": all(
            p["files"] == (["errors.json", "matches.png"] if p["num_matches"] else
                           ["errors.json"]) for p in pairs.values()),
        "some_matches": any(p["num_matches"] for p in pairs.values()),
        "errors_finite": all(p["err3d_mean"] is None or math.isfinite(p["err3d_mean"])
                             for p in pairs.values()),
        "k4_once_per_pair": counts["k4"] == NAVI_RENDER_PAIRS,
        "two_forwards_per_pair": counts["forwards"] == 2 * NAVI_RENDER_PAIRS,
        "attention_per_forward": per_forward_ok(counts, DINO_PER_FORWARD),
    }
    if not all(checks.values()):
        raise SystemExit(f"path_render_navi check failed: {checks}")
    return counts


# the VOC2007 tree of path_objectness_voc: trainval frames at VOC's sizes
VOC_FRAMES = 40


def make_voc_tree(root: str, n: int, seed: int) -> None:
    """``n`` frames in the VOC2007 layout: ``JPEGImages/<stem>.jpg`` (500x375
    or 375x500), ``SegmentationObject/<stem>.png`` (a palette PNG with 1-3
    objects, ids 1..3, each inside a 255 boundary) and
    ``Annotations/<stem>.xml`` with one ``<object>`` per object."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    for sub in ("JPEGImages", "SegmentationObject", "Annotations"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    palette = [c for i in range(256) for c in ((i * 67) % 256, (i * 131) % 256, i)]
    for i in range(n):
        stem = f"2007_{i:06d}"
        h, w = (375, 500) if i % 3 else (500, 375)
        coarse = rng.randint(0, 256, (h // 25, w // 25, 3), dtype=np.uint8)
        img = Image.fromarray(coarse).resize((w, h), Image.BICUBIC)
        noise = rng.randint(-12, 13, (h, w, 3))
        img = Image.fromarray(np.clip(np.asarray(img, np.int32) + noise, 0, 255).astype(np.uint8))
        img.save(os.path.join(root, "JPEGImages", f"{stem}.jpg"), quality=90)
        seg = np.zeros((h, w), np.uint8)
        n_obj = 1 + i % 3
        for k in range(n_obj):
            bh, bw = rng.randint(h // 6, h // 2), rng.randint(w // 6, w // 2)
            y, x = rng.randint(0, h - bh), rng.randint(0, w - bw)
            seg[y:y + bh, x:x + bw] = 255
            seg[y + 3:y + bh - 3, x + 3:x + bw - 3] = k + 1
        png = Image.fromarray(seg, mode="L").convert("P")
        png.putpalette(palette)
        png.save(os.path.join(root, "SegmentationObject", f"{stem}.png"))
        objects = "".join(f"<object><name>obj{k}</name></object>" for k in range(n_obj))
        with open(os.path.join(root, "Annotations", f"{stem}.xml"), "w") as f:
            f.write(f"<annotation><filename>{stem}.jpg</filename>{objects}</annotation>")


def phase_path_objectness_voc(torch, smi: str):
    """The objectness trainer (``midvision_probe_torch.train_generic_objectness``)
    through its ``entry`` as the paper runs it, ``backbone=dino_b16
    dataset=voc probe=binaryhead`` (fixed size 480, so K1 at N = 901), batch
    16, bf16 backbone, on a fabricated VOC2007 tree of 40 trainval frames
    (the 80/20 split: 32 train frames, 2 steps, and 8 validation frames) with
    DINO ViT-B/16's weights loaded from a full-size fabricated
    ``dino_vitb16.pth``: finite losses, F-measure, IoU, accuracy and CorLoc
    in [0, 1], one ``final_results_summary_voc.csv``, no random init, K1 12
    per backbone forward on the wgmma route, wall time, the init draw's time
    and reader calls and peak memory. Returns the launch counts."""
    from midvision_probe_torch import train_generic_objectness
    from midvision_probe_torch.models import zoo

    root = tempfile.mkdtemp(prefix="mvp_chip_smoke_voc_")
    try:
        t0 = time.perf_counter()
        voc = os.path.join(root, "VOC2007")
        make_voc_tree(voc, VOC_FRAMES, seed=30)
        tree_s = time.perf_counter() - t0
        ckpt_dir = os.path.join(root, "checkpoints")
        os.makedirs(ckpt_dir)
        torch.save(dino_vitb16_container(torch),
                   os.path.join(ckpt_dir, zoo.ZOO["dino_vitb16"].filename))
        out_dir = os.path.join(root, "out")
        argv = ["backbone=dino_b16", "dataset=voc",
                f"dataset.trainval_path={os.path.join(voc, 'SegmentationObject')}",
                f"dataset.trainval_jpeg_dir={os.path.join(voc, 'JPEGImages')}",
                f"dataset.trainval_xml_dir={os.path.join(voc, 'Annotations')}",
                "probe=binaryhead", "optimizer=one_epoch", "batch_size=16",
                "+system.backbone_dtype=bfloat16", f"output_dir={out_dir}"]
        with checkpoints_in(ckpt_dir) as random_inits:
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            with init_draws_timed() as draws:
                row = train_generic_objectness.entry(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
        with open(os.path.join(out_dir, csvs[0])) as f:
            csv_rows = len(f.read().strip().splitlines()) - 1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = row.pop("train_losses")
    res = {"phase": "path_objectness_voc", "argv": [a for a in argv if root not in a],
           "frames": VOC_FRAMES, "tree_s": tree_s, "random_init_calls": len(random_inits),
           "train_losses": losses, "csv_files": csvs, "csv_rows": csv_rows, "csv_row": row,
           "launches": counts, "backbone_forwards": counts["forwards"], "wall_s": wall,
           "init_draws": draws, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "nvidia_smi": smi, "gpu_state": gpu_state()}
    emit(res)
    checks = {
        "weights_loaded": not random_inits,
        "two_steps": len(losses) == 2,
        "losses_finite": all(math.isfinite(x) for x in losses),
        "csv_written": csvs == ["final_results_summary_voc.csv"] and csv_rows == 1,
        "metrics_in_unit": all(0.0 <= row[k] <= 1.0
                               for k in ("F-measure", "IoU", "Accuracy", "CorLoc")),
        "three_forwards": counts["forwards"] == 3,  # 2 train steps, 1 validation batch
        "attention_per_forward": per_forward_ok(counts, DINO_PER_FORWARD),
    }
    if not all(checks.values()):
        raise SystemExit(f"path_objectness_voc check failed: {checks}")
    return counts


def clip_vitb16_container(torch, seed: int = 11) -> dict:
    """A full-size OpenAI CLIP ViT-B/16 ``.pt`` state dict as
    ``clip_vitb16_openai.pt`` lays it out (``data_processing/
    make_source_layout_checkpoints.py``): the visual tower under ``visual.``
    in open_clip naming (bias-free ``conv1``, ``class_embedding``, a 197-row
    ``positional_embedding``, ``ln_pre``, 12 ``resblocks`` with a fused
    ``attn.in_proj``, ``ln_post`` and ``proj``) and text-tower tensors the
    converter must skip; every tensor N(0, 0.02) from a seeded generator,
    LayerNorm weights near 1."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape, std=0.02):
        return torch.randn(*shape, generator=gen) * std

    C, F = 768, 3072
    sd = {"visual.conv1.weight": normal(C, 3, 16, 16), "visual.class_embedding": normal(C),
          "visual.positional_embedding": normal(197, C)}
    ln = {"ln_pre": "visual.ln_pre", "ln_post": "visual.ln_post"}
    for i in range(12):
        b = f"visual.transformer.resblocks.{i}"
        ln.update({f"ln_1_{i}": f"{b}.ln_1", f"ln_2_{i}": f"{b}.ln_2"})
        sd.update({f"{b}.attn.in_proj_weight": normal(3 * C, C),
                   f"{b}.attn.in_proj_bias": normal(3 * C),
                   f"{b}.attn.out_proj.weight": normal(C, C),
                   f"{b}.attn.out_proj.bias": normal(C),
                   f"{b}.mlp.c_fc.weight": normal(F, C), f"{b}.mlp.c_fc.bias": normal(F),
                   f"{b}.mlp.c_proj.weight": normal(C, F), f"{b}.mlp.c_proj.bias": normal(C)})
    for prefix in ln.values():
        sd[f"{prefix}.weight"] = 1.0 + normal(C, std=0.1)
        sd[f"{prefix}.bias"] = normal(C)
    sd["visual.proj"] = normal(C, 512)
    sd.update({"token_embedding.weight": normal(49408, 512), "positional_embedding":
               normal(77, 512), "text_projection": normal(512, 512),
               "transformer.resblocks.0.ln_1.weight": torch.ones(512),
               "ln_final.weight": torch.ones(512), "logit_scale": torch.tensor(4.6052)})
    return sd


def clip_port_name(key: str) -> str | None:
    """The port ``ViT``'s parameter that a ``visual.*`` key of the OpenAI
    CLIP file loads into (None: not part of the probing trunk)."""
    rename = {"conv1.weight": "patch_embed.proj.weight", "class_embedding": "cls_token",
              "positional_embedding": "pos_embed", "ln_pre.weight": "norm_pre.weight",
              "ln_pre.bias": "norm_pre.bias"}
    block = {"ln_1": "norm1", "ln_2": "norm2", "attn.in_proj_weight": "attn.qkv.weight",
             "attn.in_proj_bias": "attn.qkv.bias", "attn.out_proj": "attn.proj",
             "mlp.c_fc": "mlp.fc1", "mlp.c_proj": "mlp.fc2"}
    if not key.startswith("visual."):
        return None
    key = key[len("visual."):]
    if key in rename:
        return rename[key]
    if key.startswith("transformer.resblocks."):
        i, rest = key[len("transformer.resblocks."):].split(".", 1)
        for src, dst in block.items():
            if rest.startswith(src):
                return f"blocks.{i}.{dst}{rest[len(src):]}"
    return None


# the NIGHTS tree of path_2afc_nights: test triplets that pass the vote filter
TWOAFC_TRIPLETS = 32


def make_nights_tree(root: str, n: int, seed: int) -> None:
    """A NIGHTS tree: ``data.csv`` with the reference's columns (id, prompt,
    p, votes_extra, ref_path, left_path, right_path, votes, split,
    is_imagenet), ``n`` test triplets of 768x768 PNGs with six or more
    votes (a smooth reference, a photometric shift of it and another
    texture), and rows the reader must drop (test rows under six votes,
    train and val rows)."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "distort"), exist_ok=True)

    def texture():
        coarse = rng.randint(0, 256, (12, 12, 3), dtype=np.uint8)
        return np.asarray(Image.fromarray(coarse).resize((768, 768), Image.BICUBIC),
                          np.float32)

    rows = ["id,prompt,p,votes_extra,ref_path,left_path,right_path,votes,split,is_imagenet"]
    for i in range(n):
        ref, far = texture(), texture()
        near = np.clip(ref * rng.uniform(0.9, 1.1, 3) + rng.uniform(-8, 8, 3), 0, 255)
        sides = (near, far) if i % 2 == 0 else (far, near)
        for part, arr in zip(("ref", "left", "right"), (ref, *sides)):
            Image.fromarray(arr.astype(np.uint8)).save(
                os.path.join(root, "distort", f"{i:03d}_{part}.png"), compress_level=0)
        paths = ",".join(f"distort/{i:03d}_{part}.png" for part in ("ref", "left", "right"))
        p = "0.0" if i % 2 == 0 else "1.0"
        rows.append(f"{i},a prompt,{p},0,{paths},{6 + i % 4},test,{'True' if i % 3 else 'False'}")
        if i % 4 == 0:  # rows the reader drops: too few votes, or another split
            rows.append(f"{1000 + i},a prompt,{p},0,{paths},{i % 6},test,False")
            rows.append(f"{2000 + i},a prompt,{p},0,{paths},7,{('train', 'val')[i % 8 // 4]},False")
    with open(os.path.join(root, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


def phase_path_2afc_nights(torch, smi: str):
    """The 2AFC evaluator (``midvision_probe_torch.evaluate_model_percepture``)
    through its ``entry``, ``backbone=clip_b16 dataset=twoafcdataset``, on a
    fabricated NIGHTS tree (32 test triplets at 768x768 that pass the vote
    filter, resized to 224x224; batch 16, so 2 forwards of 48 images in
    float32, K1 on the tf32x3 route) with CLIP ViT-B/16's weights loaded from
    a full-size fabricated OpenAI-layout ``clip_vitb16_openai.pt`` through
    the OpenCLIP converter: every trunk tensor the zoo loaded equal to the
    file's, nothing else of the file loaded, no random init, accuracy, F1,
    precision and recall in [0, 1], one ``final_results_summary.csv`` row,
    K1 12 per backbone forward, wall time and peak memory. Returns the
    launch counts."""
    from midvision_probe_torch import evaluate_model_percepture
    from midvision_probe_torch.models import zoo

    root = tempfile.mkdtemp(prefix="mvp_chip_smoke_nights_")
    try:
        t0 = time.perf_counter()
        nights = os.path.join(root, "nights")
        make_nights_tree(nights, TWOAFC_TRIPLETS, seed=31)
        tree_s = time.perf_counter() - t0
        ckpt_dir = os.path.join(root, "checkpoints")
        os.makedirs(ckpt_dir)
        container = clip_vitb16_container(torch)
        torch.save(container, os.path.join(ckpt_dir, zoo.ZOO["clip_vitb16"].filename))
        out_dir = os.path.join(root, "out")
        argv = ["backbone=clip_b16", "dataset=twoafcdataset",
                f"dataset.root_dir={nights}", f"output_dir={out_dir}"]
        with checkpoints_in(ckpt_dir) as random_inits:
            t0 = time.perf_counter()
            ext = zoo.build_vit_extractor("clip_vitb16", device="cuda")
            load_s = time.perf_counter() - t0
            loaded = ext.module.state_dict()
            expected = {clip_port_name(k): v for k, v in container.items()
                        if clip_port_name(k) is not None}
            mismatched = [k for k, v in expected.items()
                          if not torch.equal(loaded[k].cpu(), v.reshape(loaded[k].shape))]
            unexpected = sorted(set(loaded) - set(expected))
            del ext, loaded
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            metrics = evaluate_model_percepture.entry(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
        with open(os.path.join(out_dir, csvs[0])) as f:
            csv_rows = len(f.read().strip().splitlines()) - 1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    res = {"phase": "path_2afc_nights", "argv": [a for a in argv if root not in a],
           "triplets": TWOAFC_TRIPLETS, "tree_s": tree_s,
           "container_params": sum(t.numel() for t in container.values()),
           "checkpoint_load_build_s": load_s, "trunk_tensors": len(expected),
           "mismatched_tensors": mismatched, "not_from_file": unexpected,
           "random_init_calls": len(random_inits), "metrics": metrics,
           "csv_files": csvs, "csv_rows": csv_rows, "launches": counts,
           "backbone_forwards": counts["forwards"], "wall_s": wall,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "nvidia_smi": smi, "gpu_state": gpu_state()}
    emit(res)
    checks = {
        # 12 blocks x 12 tensors, the patch conv, cls, table and ln_pre
        "weights_loaded": not mismatched and not unexpected and len(expected) == 149,
        "random_init_never": not random_inits,
        "metrics_in_unit": all(0.0 <= metrics[k] <= 1.0
                               for k in ("accuracy", "f1_score", "precision", "recall")),
        "csv_written": csvs == ["final_results_summary.csv"] and csv_rows == 1,
        "two_forwards": counts["forwards"] == 2,  # 32 triplets in batches of 16
        "attention_per_forward": per_forward_ok(counts, VIT_B_F32_PER_FORWARD),
    }
    if not all(checks.values()):
        raise SystemExit(f"path_2afc_nights check failed: {checks}")
    return counts


@contextlib.contextmanager
def reader_timed(cls):
    """``cls.__getitem__`` timed: the dict yielded holds the calls
    (``reads``) and the seconds they took (``s``), summed."""
    total = {"reads": 0, "s": 0.0}
    getitem = cls.__getitem__

    def timed(self, index):
        t0 = time.perf_counter()
        try:
            return getitem(self, index)
        finally:
            total["reads"] += 1
            total["s"] += time.perf_counter() - t0

    cls.__getitem__ = timed
    try:
        yield total
    finally:
        cls.__getitem__ = getitem


# the SPair-71k tree of path_spair: test pairs per class, over viewpoint
# differences 0, 1 and 2, of PASCAL-sized views
SPAIR_CLASSES, SPAIR_PAIRS = ("aeroplane", "cat"), 8


def make_spair_tree(root: str, classes, pairs: int, seed: int) -> None:
    """A SPair-71k tree in the reference layout: per class ``2 * pairs``
    views (``JPEGImages/<class>/<view>.jpg`` at 500x375 or 375x500,
    ``Segmentation/<class>/<view>.png`` with the class id inside the
    object's box and 255 on its border, ``ImageAnnotation/<class>/<view>.json``
    with 30 keypoint slots, some ``null``, the rest on the object) and
    ``PairAnnotation/test/<n>.json`` per pair with its viewpoint difference
    (0, 1, 2 in turn), ``src_bndbox``, ``trg_bndbox`` and ``trg_imsize``."""
    import json

    import numpy as np
    from PIL import Image

    from midvision_probe_torch.datasets.spair import CLASS_IDS, MAX_KPS

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "PairAnnotation", "test"), exist_ok=True)
    n_pair = 0
    for cls in classes:
        for sub in ("JPEGImages", "Segmentation", "ImageAnnotation"):
            os.makedirs(os.path.join(root, sub, cls), exist_ok=True)
        boxes, sizes = {}, {}
        for v in range(2 * pairs):
            view = f"2008_{n_pair:04d}{v:02d}"
            h, w = (375, 500) if v % 3 else (500, 375)
            bh, bw = rng.randint(h // 3, h - 20), rng.randint(w // 3, w - 20)
            y0, x0 = rng.randint(5, h - bh - 5), rng.randint(5, w - bw - 5)
            boxes[view], sizes[view] = [x0, y0, x0 + bw, y0 + bh], [w, h, 3]
            coarse = rng.randint(0, 256, (h // 25, w // 25, 3), dtype=np.uint8)
            img = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BICUBIC), np.int32)
            img = np.clip(img + rng.randint(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(root, "JPEGImages", cls, f"{view}.jpg"),
                                      quality=90)
            seg = np.zeros((h, w), np.uint8)
            seg[y0:y0 + bh, x0:x0 + bw] = 255
            seg[y0 + 3:y0 + bh - 3, x0 + 3:x0 + bw - 3] = CLASS_IDS[cls]
            Image.fromarray(seg).save(os.path.join(root, "Segmentation", cls, f"{view}.png"))
            kps = {str(k): (None if rng.rand() < 0.3 else
                            [int(rng.randint(x0, x0 + bw)), int(rng.randint(y0, y0 + bh))])
                   for k in range(MAX_KPS)}
            with open(os.path.join(root, "ImageAnnotation", cls, f"{view}.json"), "w") as f:
                json.dump({"filename": f"{view}.jpg", "kps": kps}, f)
        views = sorted(boxes)
        for p in range(pairs):
            src, trg = views[2 * p], views[2 * p + 1]
            pair = {"filename": f"{n_pair:06d}-{src}-{trg}:{cls}", "category": cls,
                    "viewpoint_variation": p % 3, "src_bndbox": boxes[src],
                    "trg_bndbox": boxes[trg], "trg_imsize": sizes[trg]}
            with open(os.path.join(root, "PairAnnotation", "test", f"{n_pair:06d}.json"),
                      "w") as f:
                json.dump(pair, f)
            n_pair += 1


def phase_path_spair(torch, smi: str):
    """The SPair-71k evaluator (``midvision_probe_torch.evaluate_spair_correspondence``)
    through its ``entry`` with the config's defaults (800x800, batch 8
    pairs, every class, no bbox crop, one tap) on ``backbone=dino_b16`` in
    float32 as the config and the JAX driver run it (K1 on the tf32x3 route
    at N = 2501), seeded random weights (no checkpoint in the repository),
    on a fabricated tree of 2 classes x 8 test pairs (``make_spair_tree``;
    SPair-71k's test split has 12,234): the recall table (each entry in
    [0, 100], or -1 for a class without pairs), one CSV row, K1 12 per
    backbone forward, wall time and peak memory. Then a second run on one
    class with ``mask_feats`` and ``return_heatmaps``: the heat maps of each
    viewpoint difference, (pairs, 30, 50, 50). Returns the first run's
    launch counts."""
    import numpy as np

    from midvision_probe_torch import evaluate_spair_correspondence as spair
    from midvision_probe_torch.datasets.spair import SPairDataset

    root = tempfile.mkdtemp(prefix="mvp_chip_smoke_spair_")
    try:
        t0 = time.perf_counter()
        tree = os.path.join(root, "SPair-71k")
        make_spair_tree(tree, SPAIR_CLASSES, SPAIR_PAIRS, seed=32)
        tree_s = time.perf_counter() - t0
        out_dir = os.path.join(root, "out")
        argv = ["backbone=dino_b16", f"data_root={tree}", f"output_dir={out_dir}"]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with reader_timed(SPairDataset) as reads:
            row = spair.entry(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        csvs = sorted(os.listdir(out_dir))
        with open(os.path.join(out_dir, "spair_correspondence_final.csv")) as f:
            csv_rows = len(f.read().strip().splitlines()) - 1

        heat_dir = os.path.join(root, "heat")
        heat_argv = ["backbone=dino_b16", f"data_root={tree}", f"eval_class={SPAIR_CLASSES[1]}",
                     "mask_feats=true", "return_heatmaps=true", f"output_dir={heat_dir}"]
        reset_counts()
        t0 = time.perf_counter()
        heat_row = spair.entry(heat_argv)
        torch.cuda.synchronize()
        heat_wall = time.perf_counter() - t0
        heat_counts = read_counts()
        heat_shapes = {}
        for name in sorted(os.listdir(os.path.join(heat_dir, "spair_heatmaps"))):
            with np.load(os.path.join(heat_dir, "spair_heatmaps", name)) as z:
                heat_shapes[name] = list(z["heatmaps"].shape)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    table = row.pop("class_recalls")
    heat_table = heat_row.pop("class_recalls")
    # pairs per viewpoint difference 0, 1, 2 (pair p has difference p % 3)
    vp_pairs = [len(range(v, SPAIR_PAIRS, 3)) for v in range(3)] + [SPAIR_PAIRS]
    forwards = len(SPAIR_CLASSES) * sum(-(-n // 8) for n in vp_pairs)
    res = {"phase": "path_spair", "argv": [a for a in argv if root not in a],
           "classes": list(SPAIR_CLASSES), "pairs_per_class": SPAIR_PAIRS, "tree_s": tree_s,
           "recalls": row, "class_recalls": {c: table[c] for c in SPAIR_CLASSES},
           "csv_files": csvs, "csv_rows": csv_rows, "launches": counts,
           "backbone_forwards": counts["forwards"], "wall_s": wall, "peak_mem_gib": peak,
           # the host's share: the reader (JPEG and PNG decode, the 800x800
           # bicubic resizes on the CPU)
           "reader": {**reads, "share_of_wall": reads["s"] / wall},
           "heatmap_run": {"argv": [a for a in heat_argv if root not in a],
                           "recalls": heat_row, "shapes": heat_shapes, "wall_s": heat_wall,
                           "launches": heat_counts},
           "nvidia_smi": smi, "gpu_state": gpu_state()}
    emit(res)
    expected_shapes = {f"heatmaps_{SPAIR_CLASSES[1]}_{tag}.npz": [n, 30, 50, 50]
                       for tag, n in zip(("0", "1", "2", "all"), vp_pairs)}
    checks = {
        "recalls_in_range": all(
            (0.0 <= r <= 100.0) if cls in SPAIR_CLASSES else r == -1.0
            for cls, rs in table.items() for r in rs) and len(table) == 18,
        "averages_in_range": all(0.0 <= v <= 100.0 for v in row.values()),
        "csv_written": csvs == ["spair_correspondence_final.csv"] and csv_rows == 1,
        "forwards": counts["forwards"] == forwards,
        "every_pair_read": reads["reads"] == 2 * len(SPAIR_CLASSES) * SPAIR_PAIRS,
        "attention_per_forward": per_forward_ok(counts, VIT_B_F32_PER_FORWARD),
        "heatmaps": heat_shapes == expected_shapes,
        "heatmap_run_recalls": all(0.0 <= r <= 100.0 for r in heat_table[SPAIR_CLASSES[1]]),
        "heatmap_run_per_forward": per_forward_ok(heat_counts, VIT_B_F32_PER_FORWARD),
    }
    if not all(checks.values()):
        raise SystemExit(f"path_spair check failed: {checks}")
    return counts


TASKONOMY_INSTANCES = 32


def phase_path_taskonomy(torch, smi: str):
    """The Taskonomy trainer (``midvision_probe_torch.train_taskonomy``)
    through its ``entry`` as the config runs it, ``backbone=dino_b16
    dataset=taskonomy probe=taskonomy_dpt``, principal curvature (the
    config's task, 2 channels), batch 16, bf16 backbone with seeded random
    weights (no checkpoint in the repository), on the synthetic fallback at
    Taskonomy's native 512x512 (32 train and 32 test items; no HF shards in
    the repository): 2 steps and 2 validation batches, K1 at B = 16, N =
    1025 on the wgmma route, 12 per backbone forward, finite losses, AbsRel
    >= 0 and every ratio threshold in [0, 1], one
    ``taskonomy_results_principal_curvature_final.csv`` row, wall time, the
    init draw's time and reader calls, and peak memory. Returns the launch
    counts."""
    from midvision_probe_torch import train_taskonomy

    root = tempfile.mkdtemp(prefix="mvp_chip_smoke_taskonomy_")
    try:
        out_dir = os.path.join(root, "out")
        argv = ["backbone=dino_b16", "dataset=taskonomy", "probe=taskonomy_dpt",
                "dataset.task=principal_curvature", "batch_size=16", "optimizer=one_epoch",
                "+system.backbone_dtype=bfloat16", "+dataset.image_size=[512,512]",
                f"+dataset.num_instances={TASKONOMY_INSTANCES}",
                # no HF directory there: the synthetic fallback
                f"dataset.other_path={os.path.join(root, 'absent')}", f"output_dir={out_dir}"]
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with init_draws_timed() as draws:
            row = train_taskonomy.entry(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
        with open(os.path.join(out_dir, csvs[0])) as f:
            csv_rows = len(f.read().strip().splitlines()) - 1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = row.pop("train_losses")
    res = {"phase": "path_taskonomy", "argv": [a for a in argv if root not in a],
           "instances": TASKONOMY_INSTANCES, "train_losses": losses, "csv_files": csvs,
           "csv_rows": csv_rows, "csv_row": row, "launches": counts,
           "backbone_forwards": counts["forwards"], "wall_s": wall, "init_draws": draws,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "nvidia_smi": smi, "gpu_state": gpu_state()}
    emit(res)
    deltas = [v for k, v in row.items() if k.startswith("δ")]
    checks = {
        "two_steps": len(losses) == 2,
        "losses_finite": all(math.isfinite(x) for x in losses),
        "absrel": math.isfinite(row["AbsRel"]) and row["AbsRel"] >= 0.0,
        "deltas_in_unit": len(deltas) == 9 and all(0.0 <= v <= 1.0 for v in deltas),
        "csv_written": csvs == ["taskonomy_results_principal_curvature_final.csv"]
        and csv_rows == 1,
        "four_forwards": counts["forwards"] == 4,  # 2 train steps, 2 validation batches
        "attention_per_forward": per_forward_ok(counts, DINO_PER_FORWARD),
    }
    if not all(checks.values()):
        raise SystemExit(f"path_taskonomy check failed: {checks}")
    return counts



def sam_vitb_container(torch, seed: int = 12) -> dict:
    """A full-size segment_anything ``sam_vit_b_01ec64.pth`` in its own
    naming: the image encoder under ``image_encoder.`` (64x64 pos-embed,
    windowed blocks with 27-row relative-position tables and global blocks
    2, 5, 8, 11 with 127-row ones, the neck) and some prompt-encoder and
    mask-decoder keys the converter skips; N(0, 0.02) from a seeded
    generator, LayerNorm weights 1."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen) * 0.02

    C, F, hd = 768, 3072, 64
    enc = "image_encoder"
    sd = {f"{enc}.pos_embed": normal(1, 64, 64, C),
          f"{enc}.patch_embed.proj.weight": normal(C, 3, 16, 16),
          f"{enc}.patch_embed.proj.bias": normal(C)}
    for i in range(12):
        b = f"{enc}.blocks.{i}"
        table = 127 if i in (2, 5, 8, 11) else 27
        for norm in ("norm1", "norm2"):
            sd[f"{b}.{norm}.weight"], sd[f"{b}.{norm}.bias"] = torch.ones(C), normal(C)
        sd[f"{b}.attn.rel_pos_h"], sd[f"{b}.attn.rel_pos_w"] = normal(table, hd), normal(table, hd)
        for name, shape in {"attn.qkv": (3 * C, C), "attn.proj": (C, C),
                            "mlp.lin1": (F, C), "mlp.lin2": (C, F)}.items():
            sd[f"{b}.{name}.weight"], sd[f"{b}.{name}.bias"] = normal(*shape), normal(shape[0])
    sd.update({f"{enc}.neck.0.weight": normal(256, C, 1, 1),
               f"{enc}.neck.1.weight": torch.ones(256), f"{enc}.neck.1.bias": normal(256),
               f"{enc}.neck.2.weight": normal(256, 256, 3, 3),
               f"{enc}.neck.3.weight": torch.ones(256), f"{enc}.neck.3.bias": normal(256),
               "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix": normal(2, 128),
               "prompt_encoder.not_a_point_embed.weight": normal(1, 256),
               "mask_decoder.iou_token.weight": normal(1, 256),
               "mask_decoder.mask_tokens.weight": normal(4, 256),
               "mask_decoder.transformer.layers.0.self_attn.q_proj.weight": normal(256, 256)})
    return sd


def sam_file_name(key: str) -> str:
    """The ``sam_vit_b_01ec64.pth`` key that a port ``SAMViT`` parameter
    loads from."""
    key = key.replace("mlp_lin1", "mlp.lin1").replace("mlp_lin2", "mlp.lin2")
    if key.startswith("patch_embed."):
        key = "patch_embed.proj." + key[len("patch_embed."):]
    return f"image_encoder.{key}"


CONVNEXT_DEPTHS, CONVNEXT_DIMS = (3, 3, 27, 3), (128, 256, 512, 1024)


def convnext_laion_container(torch, seed: int = 13) -> dict:
    """A full-size open_clip ``convnext_base_w_laion2b.pt`` state dict: the
    ConvNeXt-B trunk in timm naming (layer-scale ``gamma``) under
    ``visual.trunk.``, its head norm and the projection, and some text-tower
    keys the converter skips; N(0, 0.02) from a seeded generator, LayerNorm
    weights 1, ``gamma`` 1e-6 + N(0, 0.02)."""
    gen = torch.Generator().manual_seed(seed)

    def normal(*shape):
        return torch.randn(*shape, generator=gen) * 0.02

    t = "visual.trunk"
    d0 = CONVNEXT_DIMS[0]
    sd = {f"{t}.stem.0.weight": normal(d0, 3, 4, 4), f"{t}.stem.0.bias": normal(d0),
          f"{t}.stem.1.weight": torch.ones(d0), f"{t}.stem.1.bias": normal(d0)}
    for s, (depth, d) in enumerate(zip(CONVNEXT_DEPTHS, CONVNEXT_DIMS)):
        if s > 0:
            prev = CONVNEXT_DIMS[s - 1]
            sd[f"{t}.stages.{s}.downsample.0.weight"] = torch.ones(prev)
            sd[f"{t}.stages.{s}.downsample.0.bias"] = normal(prev)
            sd[f"{t}.stages.{s}.downsample.1.weight"] = normal(d, prev, 2, 2)
            sd[f"{t}.stages.{s}.downsample.1.bias"] = normal(d)
        for b in range(depth):
            p = f"{t}.stages.{s}.blocks.{b}"
            sd.update({f"{p}.conv_dw.weight": normal(d, 1, 7, 7), f"{p}.conv_dw.bias": normal(d),
                       f"{p}.norm.weight": torch.ones(d), f"{p}.norm.bias": normal(d),
                       f"{p}.mlp.fc1.weight": normal(4 * d, d), f"{p}.mlp.fc1.bias": normal(4 * d),
                       f"{p}.mlp.fc2.weight": normal(d, 4 * d), f"{p}.mlp.fc2.bias": normal(d),
                       f"{p}.gamma": 1e-6 + normal(d)})
    sd.update({f"{t}.head.norm.weight": torch.ones(1024), f"{t}.head.norm.bias": normal(1024),
               "visual.head.proj.weight": normal(640, 1024),
               "positional_embedding": normal(77, 640), "text_projection": normal(640, 640),
               "ln_final.weight": torch.ones(640), "ln_final.bias": normal(640),
               "transformer.resblocks.0.attn.in_proj_weight": normal(1920, 640),
               "logit_scale": torch.tensor(4.6052)})
    return sd


def convnext_file_name(key: str) -> str:
    """The ``convnext_base_w_laion2b.pt`` key that a port ``ConvNeXt``
    parameter loads from."""
    parts = key.split(".")
    if parts[0] in ("stem_conv", "stem_norm"):
        name = f"stem.{0 if parts[0] == 'stem_conv' else 1}.{parts[1]}"
    elif parts[0] in ("downsample_norm", "downsample_conv"):
        name = (f"stages.{int(parts[1]) + 1}.downsample."
                f"{0 if parts[0] == 'downsample_norm' else 1}.{parts[2]}")
    else:  # stages.{s}.{b}.<layer>.<param>
        layer = {"dwconv": "conv_dw", "pwconv1": "mlp.fc1", "pwconv2": "mlp.fc2"}.get(
            parts[3], parts[3])
        name = ".".join([f"stages.{parts[1]}.blocks.{parts[2]}", layer, *parts[4:]])
    return f"visual.trunk.{name}"


def phase_path_depth_loaded(torch, smi: str, phase: str, backbone: str, entry: str,
                            container, file_name, taps, image_mean):
    """The depth trainer through its ``entry`` as ``path`` runs it
    (``backbone``, synthetic 480x640, 16 items, DPT, batch 8, one epoch,
    bf16 backbone), the trunk loaded from a full-size fabricated file in the
    source's own naming (``container``) under a temporary
    ``$MVP_CHECKPOINT_DIR``. Checks: every tensor the zoo loads equal to the
    file's at the dtype it holds it in (``file_name`` maps a parameter to
    its key), the file's keys left out only the ones the converter skips,
    no random init, the taps at 480x640, the spec's mean and std, finite
    losses, the depth metrics in range, one CSV row and no hand-written
    kernel launched; wall time and peak memory. Returns the launch
    counts."""
    from midvision_probe_torch import train_depth
    from midvision_probe_torch.config import compose, instantiate
    from midvision_probe_torch.models import zoo

    root = tempfile.mkdtemp(prefix=f"mvp_chip_smoke_{phase}_")
    try:
        ckpt_dir = os.path.join(root, "checkpoints")
        os.makedirs(ckpt_dir)
        t0 = time.perf_counter()
        sd = container(torch)
        torch.save(sd, os.path.join(ckpt_dir, zoo.ZOO[entry].filename))
        file_s = time.perf_counter() - t0
        file_bytes = os.path.getsize(os.path.join(ckpt_dir, zoo.ZOO[entry].filename))
        with checkpoints_in(ckpt_dir) as random_inits:
            t0 = time.perf_counter()
            ext = instantiate(compose("depth_training", [f"backbone={backbone}"]).backbone,
                              return_multilayer=True, dtype="bfloat16", device="cuda")
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            loaded = ext.module.state_dict()
            mismatched = [k for k, v in loaded.items()
                          if not torch.equal(v.cpu(), sd[file_name(k)].to(v.dtype))]
            kept_f32 = sorted(k for k, v in loaded.items() if v.dtype == torch.float32)
            not_loaded = sorted(set(sd) - {file_name(k) for k in loaded})
            with torch.no_grad():
                tap_shapes = [tuple(t.shape[1:]) for t in
                              ext.features(torch.randn(1, 480, 640, 3, device="cuda"))]
            spec_mean = tuple(ext.spec.image_mean)
            del ext, loaded
            torch.cuda.empty_cache()

            out_dir = os.path.join(root, "out")
            argv = [f"backbone={backbone}", "dataset=synthetic",
                    "dataset.image_size=[480,640]", f"dataset.num_instances={DEPTH_ITEMS}",
                    "probe=depth_dpt", f"batch_size={DEPTH_BATCH}", "optimizer=one_epoch",
                    "+system.backbone_dtype=bfloat16", "+render_images=False",
                    f"output_dir={out_dir}"]
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            row = train_depth.entry(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
        with open(os.path.join(out_dir, csvs[0])) as f:
            csv_rows = len(f.read().strip().splitlines()) - 1
    finally:
        shutil.rmtree(root, ignore_errors=True)
    losses = row.pop("train_losses")
    emit({"phase": phase, "argv": [a for a in argv if root not in a],
          "file": zoo.ZOO[entry].filename, "file_bytes": file_bytes, "file_write_s": file_s,
          "checkpoint_load_build_s": load_s, "file_tensors": len(sd),
          "trunk_tensors_loaded": len(sd) - len(not_loaded), "keys_not_loaded": not_loaded,
          "mismatched_tensors": mismatched, "kept_float32": kept_f32,
          "random_init_calls": len(random_inits), "taps_at_480x640": tap_shapes,
          "image_mean": spec_mean, "train_losses": losses, "csv_files": csvs,
          "csv_rows": csv_rows, "csv_row": row, "launches": counts,
          "backbone_forwards": counts["forwards"], "wall_s": wall,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "nvidia_smi": smi, "gpu_state": gpu_state()})
    checks = {
        "weights_loaded": not mismatched,
        "only_skipped_keys_left": all(
            k.startswith(("image_encoder.neck.", "prompt_encoder.", "mask_decoder.",
                          "visual.trunk.head.", "visual.head.")) or not k.startswith(
                ("image_encoder.", "visual.")) for k in not_loaded),
        "no_random_init": not random_inits,
        "taps": tap_shapes == taps,
        "image_mean": spec_mean == tuple(image_mean),
        "two_steps": len(losses) == DEPTH_ITEMS // DEPTH_BATCH,
        "losses_finite": all(math.isfinite(x) for x in losses),
        "csv_written": len(csvs) == 1 and csv_rows == 1,
        "sa_rmse_finite": math.isfinite(row["sa_rmse"]),
        "sa_d1_in_unit": 0.0 <= row["sa_d1"] <= 1.0,
        "si_d1_in_unit": 0.0 <= row["si_d1"] <= 1.0,
        "no_kernel": per_forward_ok(counts, NO_KERNEL_PER_FORWARD),
    }
    if not all(checks.values()):
        raise SystemExit(f"{phase} check failed: {checks}")
    return counts


MASKCUT_IMAGES = 4


@contextlib.contextmanager
def maskcut_stages_timed():
    """The host seconds of MaskCut's stages, summed over a run: the backbone
    features (the forward and the copy to the host), the affinity with its
    2-means, the generalized ``eigh`` and the DenseCRF; one dict is
    yielded."""
    from midvision_probe_torch.models import maskcut

    seconds = {"features": 0.0, "affinity_kmeans": 0.0, "eigh": 0.0, "crf": 0.0}
    cls = maskcut.MaskCutProcessor
    saved = {"_default_features": cls.__dict__["_default_features"],
             "get_affinity_matrix": cls.__dict__["get_affinity_matrix"],
             "second_smallest_eigenvector": cls.__dict__["second_smallest_eigenvector"]}
    densecrf = maskcut.densecrf

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[key] += time.perf_counter() - t0
        return wrapper

    cls._default_features = timed(saved["_default_features"], "features")
    cls.get_affinity_matrix = timed(saved["get_affinity_matrix"], "affinity_kmeans")
    cls.second_smallest_eigenvector = staticmethod(
        timed(saved["second_smallest_eigenvector"].__func__, "eigh"))
    maskcut.densecrf = timed(densecrf, "crf")
    try:
        yield seconds
    finally:
        for name, attr in saved.items():
            setattr(cls, name, attr)
        maskcut.densecrf = densecrf


def phase_path_maskcut_voc(torch, smi: str):
    """The MaskCut evaluator (``midvision_probe_torch.evaluate_generic_
    objectness``) through its ``entry`` as the paper runs it,
    ``backbone=dino_b16`` (float32, the config's default) at
    ``maskcut.fixed_size=480`` (K1 at B = 1, N = 901 on ``tf32x3``), on a
    fabricated VOC2007 tree of 4 trainval frames (1-3 objects each, so 1-3
    masks an image) with DINO ViT-B/16 loaded from the full-size fabricated
    ``dino_vitb16.pth``. Checks: ``Num Errors`` 0 (the per-image catch must
    not hide a failure on the card), ``Num Images`` 4, the metrics in [0, 1],
    one CSV row, no random init, the DenseCRF library built from the
    repository's sources into ``build/densecrf`` (its path and build
    seconds), K1 12 per image on ``tf32x3``; the host seconds split into
    features, affinity + 2-means, ``eigh``, CRF and the rest. Returns the
    launch counts."""
    import csv

    from midvision_probe_torch import evaluate_generic_objectness
    from midvision_probe_torch.models import crf, zoo

    root = tempfile.mkdtemp(prefix="mvp_chip_smoke_maskcut_")
    try:
        voc = os.path.join(root, "VOC2007")
        make_voc_tree(voc, MASKCUT_IMAGES, seed=31)
        ckpt_dir = os.path.join(root, "checkpoints")
        os.makedirs(ckpt_dir)
        torch.save(dino_vitb16_container(torch),
                   os.path.join(ckpt_dir, zoo.ZOO["dino_vitb16"].filename))
        out_dir = os.path.join(root, "out")
        argv = ["backbone=dino_b16", "dataset=voc",
                f"dataset.trainval_path={os.path.join(voc, 'SegmentationObject')}",
                f"dataset.trainval_jpeg_dir={os.path.join(voc, 'JPEGImages')}",
                f"dataset.trainval_xml_dir={os.path.join(voc, 'Annotations')}",
                "maskcut.fixed_size=480", f"output_dir={out_dir}"]
        with checkpoints_in(ckpt_dir) as random_inits, maskcut_stages_timed() as stages:
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            metrics = evaluate_generic_objectness.entry(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
        with open(os.path.join(out_dir, csvs[0]), newline="") as f:
            rows = list(csv.DictReader(f))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    stages["rest"] = wall - sum(stages.values())
    row = rows[0] if rows else {}
    emit({"phase": "path_maskcut_voc", "argv": [a for a in argv if root not in a],
          "images": MASKCUT_IMAGES, "metrics": metrics, "csv_files": csvs,
          "csv_rows": len(rows), "csv_row": row, "crf_library": crf.BUILD_INFO,
          "random_init_calls": len(random_inits), "launches": counts,
          "backbone_forwards": counts["forwards"], "wall_s": wall, "host_s": stages,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "nvidia_smi": smi, "gpu_state": gpu_state()})
    checks = {
        "no_errors": row.get("Num Errors") == "0",
        "all_images": row.get("Num Images") == str(MASKCUT_IMAGES),
        "metrics_in_unit": len(metrics) == 4 and all(0.0 <= v <= 1.0 for v in metrics.values()),
        "csv_written": csvs == ["final_results_summary_voc.csv"] and len(rows) == 1,
        "weights_loaded": not random_inits,
        "crf_built_from_sources": str(crf.BUILD_INFO.get("path", "")).startswith(
            str(crf.BUILD_DIR)),
        "one_forward_an_image": counts["forwards"] == MASKCUT_IMAGES,
        "attention_per_forward": per_forward_ok(counts, VIT_B_F32_PER_FORWARD),
    }
    if not all(checks.values()):
        raise SystemExit(f"path_maskcut_voc check failed: {checks}")
    return counts


def phase_extract_kqv(torch):
    """``FeatureExtractor.extract_kqv`` on dino_vitb16 at 480x640, bf16,
    batch 8: ``mode="k"`` and ``mode="kqv"`` against a plain recompute of
    the last tapped block's projection (block 11's ``norm1`` and ``qkv``
    applied to block 10's output), each within 2^-8 * max|ref|, and K1 12
    launches a call on ``wgmma`` (the projection is the one the fused
    branch hands its kernel). Returns the launch counts."""
    from midvision_probe_torch.models.zoo import build_vit_extractor

    ext = build_vit_extractor("dino_vitb16", dtype="bfloat16", device="cuda")
    images = torch.randn(8, 480, 640, 3, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(4))
    reset_counts()
    k_map = ext.extract_kqv(images, "k")
    kqv = ext.extract_kqv(images, "kqv")
    torch.cuda.synchronize()
    counts = read_counts()
    module = ext.module
    with torch.no_grad():
        x = module(images, taps=(10,))["tokens"][0]
        blk = module.blocks[11]
        qkv = blk.attn.qkv(blk.norm1(x)).reshape(8, 1201, 3, 12, 64)
        plain = qkv[:, 1:].reshape(8, 30, 40, 3, 768)
        ref_kqv = torch.cat([plain[..., 1, :], plain[..., 0, :], plain[..., 2, :]], dim=-1)
    errs = {"k": (k_map.float() - plain[..., 1, :].float()).abs().max().item(),
            "kqv": (kqv.float() - ref_kqv.float()).abs().max().item()}
    max_ref = ref_kqv.float().abs().max().item()
    res = {"phase": "extract_kqv", "model": "dino_vitb16", "batch": 8, "image_hw": [480, 640],
           "dtype": "torch.bfloat16", "shapes": {"k": list(k_map.shape), "kqv": list(kqv.shape)},
           "max_abs_err": errs, "max_abs_ref": max_ref, "tol": 2.0**-8 * max_ref,
           "launches": counts}
    emit(res)
    ok = (tuple(k_map.shape) == (8, 30, 40, 768) and tuple(kqv.shape) == (8, 30, 40, 2304)
          and all(e <= res["tol"] for e in errs.values())
          and per_forward_ok(counts, DINO_PER_FORWARD) and counts["forwards"] == 2)
    del ext, images, k_map, kqv, x, qkv, plain, ref_kqv
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit(f"extract_kqv check failed: {res}")
    return counts


@contextlib.contextmanager
def env_vars(**values):
    """The environment variables set (a value) or unset (None), restored on
    exit."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


SD_HW, SD_BATCH = (480, 640), 8


def write_sd_tokenizer(d: str) -> None:
    """A CLIP BPE ``vocab.json`` + ``merges.txt`` in the HF layout SD
    checkpoints ship: the byte alphabet, a few merges and the specials."""
    from midvision_probe_torch.models.sd.tokenizer import bytes_to_unicode

    os.makedirs(d, exist_ok=True)
    byte_vocab = list(bytes_to_unicode().values())
    merges = [("a", "</w>"), ("p", "h"), ("o", "t"), ("ph", "ot"), ("phot", "o</w>")]
    tokens = byte_vocab + [v + "</w>" for v in byte_vocab] + ["".join(m) for m in merges]
    tokens += ["<|startoftext|>", "<|endoftext|>"]
    with open(os.path.join(d, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f)
    with open(os.path.join(d, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))


def sd_flops(torch, batch: int, hw, unet_cfg, unet_passes: int, ctx_shape, text_cfg=None) -> float:
    """FLOPs (two per multiply-add) of one featurizer call derived from the
    configs: ``torch.utils.flop_counter`` over the VAE encoder on ``batch``
    images, ``unet_passes`` UNet passes and (``text_cfg``) one text-tower
    pass over 77 tokens, built and run on the meta device (shapes only,
    nothing computed)."""
    from torch.utils.flop_counter import FlopCounterMode

    from midvision_probe_torch.models.sd.text_encoder import CLIPTextEncoder
    from midvision_probe_torch.models.sd.unet import UNet2DCondition
    from midvision_probe_torch.models.sd.vae import VAEEncoder, VAEEncoderConfig

    with torch.device("meta"), FlopCounterMode(display=False) as counter:
        latents = VAEEncoder(VAEEncoderConfig())(torch.empty(batch, *hw, 3))
        unet = UNet2DCondition(unet_cfg)
        x = torch.empty(batch, *latents.shape[1:3], unet_cfg.in_channels)
        for _ in range(unet_passes):
            unet(x, torch.zeros(batch, dtype=torch.long), torch.empty(batch, *ctx_shape))
        if text_cfg is not None:
            CLIPTextEncoder(text_cfg)(torch.zeros(1, 77, dtype=torch.long))
    return float(counter.get_total_flops())


def vit_flops(batch: int, tokens: int, patches: int, patch: int, width: int, depth: int) -> float:
    """A pre-norm ViT's FLOPs: the patch projection, then per block the qkv
    and output projections, the 4x MLP and QK^T and PV over ``tokens``."""
    per_block = (2 * tokens * width * 3 * width + 2 * tokens * width * width
                 + 2 * 2 * tokens * width * 4 * width + 4 * tokens * tokens * width)
    return batch * (2.0 * patches * 3 * patch * patch * width + depth * per_block)


def f64_errors(taps32, taps64) -> dict:
    """The float32 taps' largest errors against the float64 run's, each
    beside the float64 taps' largest magnitude."""
    errs = [float((a.double() - b.double()).abs().max()) for a, b in zip(taps32, taps64)]
    refs = [float(b.double().abs().max()) for b in taps64]
    return {"max_abs_err": errs, "max_abs_ref": refs,
            "max_rel_err": max(e / r for e, r in zip(errs, refs))}


# the float32 SD forward against its float64 run, relative to the largest
# float64 magnitude: TF32 (10-bit mantissa) would miss it by far
SD_F64_REL_BOUND = 1e-3


def sd_phase_end(torch, res: dict, ok: bool, what: str) -> None:
    emit(res)
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit(f"{what} check failed: {res}")


def phase_forward_dift(torch, smi: str) -> dict:
    """DIFT (``configs/backbone/dift.yaml``: t = 1, the empty prompt) at
    SD-2.1's widths on 480x640 images, batch 8, random weights drawn on the
    card, with a fabricated tokenizer under a temporary
    ``$MVP_CHECKPOINT_DIR`` so that the 23-layer text tower encodes the
    prompt, ``return_multilayer``: the four taps' shapes (1280, 1280, 640
    and 320 channels on the 30x40 grid), the build, the wall time of a call
    and its device time (CUDA events), images per second, peak memory, the
    FLOPs derived from the config with their bound at the float32 peak, no
    hand-written kernel, and one image again in float64 (a float64 copy of
    the three modules, the same noise): the float32 taps' largest error
    beside the largest magnitude. Returns the launch counts."""
    import copy

    from midvision_probe_torch.models.sd.featurizer import FEAT_DIMS
    from midvision_probe_torch.models.sd.text_encoder import CLIPTextConfig
    from midvision_probe_torch.models.sd.unet import UNetConfig
    from midvision_probe_torch.models.zoo import DIFT

    ckpt = tempfile.mkdtemp(prefix="mvp_chip_smoke_sd_")
    try:
        write_sd_tokenizer(os.path.join(ckpt, "sd21", "tokenizer"))
        with env_vars(MVP_CHECKPOINT_DIR=ckpt):
            t0 = time.perf_counter()
            dift = DIFT(return_multilayer=True, device="cuda")
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            gen = torch.Generator(device="cuda").manual_seed(6)
            B, (H, W) = SD_BATCH, SD_HW
            images = torch.rand(B, H, W, 3, device="cuda", generator=gen) * 2 - 1
            noise = torch.randn(B, H // 8, W // 8, 4, device="cuda", generator=gen)
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            feats = dift(images, noise=noise)  # the first call encodes the empty prompt
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            counts = read_counts()
            t0 = time.perf_counter()
            dift(images, noise=noise)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            ms = cuda_ms(torch, lambda: dift(images, noise=noise), iters=3, warmup=1)
            peak = torch.cuda.max_memory_allocated() / 2**30
            shapes = [tuple(f.shape) for f in feats]
            finite = all(bool(torch.isfinite(f).all()) for f in feats)
            emb = dift._empty_embed
            text_ran = tuple(emb.shape) == (1, 77, 1024) and float(emb.abs().max()) > 0
            del feats
            f32 = dift.featurizer
            taps32 = f32(images[:1], emb, t=dift.time_step, noise=noise[:1])
            f64 = copy.deepcopy(f32)
            for m in (f64.unet, f64.vae, f64.text):
                m.double()
            taps64 = f64(images[:1].double(), f64.encode_prompt([""]), t=dift.time_step,
                         noise=noise[:1].double())
            check64 = f64_errors(taps32, taps64)
            del f64, taps32, taps64, dift
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    flops = sd_flops(torch, B, SD_HW, UNetConfig(), 1, (77, 1024), CLIPTextConfig())
    res = {"phase": "forward_dift", "model": "dift_sd21", "batch": B, "image_hw": list(SD_HW),
           "dtype": "torch.float32", "tf32": False, "tap_shapes": shapes, "text_tower_ran": text_ran,
           "build_s": build_s, "first_call_s": first_s, "wall_s": wall_s, "forward_ms": ms,
           "imgs_per_s_per_card": B / (ms / 1e3), "peak_mem_gib": peak, "launches": counts,
           "flops": flops, "bound_ms": flops / PEAK_FP32_FLOPS * 1e3, "bound_by": "operations",
           "float64_check": {"images": 1, **check64, "bound": SD_F64_REL_BOUND},
           "nvidia_smi": smi, "gpu_state": gpu_state()}
    ok = (shapes == [(B, 30, 40, c) for c in FEAT_DIMS] and finite and text_ran
          and all(counts[k] == 0 for k in KERNELS)
          and check64["max_rel_err"] <= SD_F64_REL_BOUND)
    sd_phase_end(torch, res, ok, "forward_dift")
    return counts


def clip_l14_conditioning(torch, seed: int = 14) -> dict:
    """Zero123's conditioning in its lightning checkpoint's naming, made on
    the card from a seeded generator: OpenAI CLIP ViT-L/14's image tower in
    open_clip naming under ``cond_stage_model.model.visual.`` (24 blocks of
    width 1024, patch 14, a 16x16 table at 224), its ``proj`` to 768 and
    ``cc_projection`` (772 -> 768)."""
    W, L, P, E = 1024, 24, 14, 768
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, mean=0.0):
        return mean + 0.02 * torch.randn(*shape, device="cuda", generator=gen)

    pre = "cond_stage_model.model.visual."
    sd = {pre + "conv1.weight": r(W, 3, P, P), pre + "class_embedding": r(W),
          pre + "positional_embedding": r(257, W), pre + "ln_pre.weight": r(W, mean=1.0),
          pre + "ln_pre.bias": r(W), pre + "ln_post.weight": r(W, mean=1.0),
          pre + "ln_post.bias": r(W), pre + "proj": r(W, E),
          "cc_projection.weight": r(E, E + 4), "cc_projection.bias": r(E)}
    for i in range(L):
        b = f"{pre}transformer.resblocks.{i}."
        sd.update({b + "ln_1.weight": r(W, mean=1.0), b + "ln_1.bias": r(W),
                   b + "attn.in_proj_weight": r(3 * W, W), b + "attn.in_proj_bias": r(3 * W),
                   b + "attn.out_proj.weight": r(W, W), b + "attn.out_proj.bias": r(W),
                   b + "ln_2.weight": r(W, mean=1.0), b + "ln_2.bias": r(W),
                   b + "mlp.c_fc.weight": r(4 * W, W), b + "mlp.c_fc.bias": r(4 * W),
                   b + "mlp.c_proj.weight": r(W, 4 * W), b + "mlp.c_proj.bias": r(W)})
    return sd


# K1's launches in one Zero123 call: the CLIP ViT-L/14 conditioning tower
# in float32 (24 blocks, 16 heads of 64, 257 tokens at 224x224)
ZERO123_LAUNCHES = {"k1": 24, "k2": 0, "k3": 0, "k4": 0, "k5": 0, **NO_BENCH_KERNELS,
                    **on_route("tf32x3", 24)}


def phase_forward_zero123(torch, smi: str, k1_case: dict) -> dict:
    """Zero123 (``configs/backbone/zero123.yaml``) at full widths on
    480x640 images, batch 8: the LDM UNet and VAE encoder random-initialised
    on the card (no checkpoint), a full-size CLIP ViT-L/14 conditioning
    state dict fabricated on the card and loaded by ``_load_conditioning``,
    ``return_multilayer``: K1's launches in one call (24, all on
    ``tf32x3``), the taps' shapes, the wall and device time, images per
    second, peak memory, the FLOPs (the VAE, two UNet passes and the CLIP
    tower) with their bound at the float32 peak, and one image again in
    float64 (a float64 copy of the UNet and the VAE, the float32 context and
    the same noise); beside them ``k1_case``, K1 held against its plain
    version at this launch (``attention_checks``' ``zero123_clip_k1_fp32``:
    the error, the kernel's, the plain version's and SDPA's times and the
    bound). Returns the launch counts of the call."""
    import copy

    from midvision_probe_torch.models.sd.featurizer import FEAT_DIMS
    from midvision_probe_torch.models.zoo import Zero123

    ckpt = tempfile.mkdtemp(prefix="mvp_chip_smoke_sd_")
    try:
        with env_vars(MVP_CHECKPOINT_DIR=ckpt):
            t0 = time.perf_counter()
            z = Zero123(return_multilayer=True, device="cuda")
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            unet_cfg = z.unet_cfg
            sd = clip_l14_conditioning(torch)
            t0 = time.perf_counter()
            z._load_conditioning(sd)
            torch.cuda.synchronize()
            conditioning_s = time.perf_counter() - t0
            del sd
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    B, (H, W) = SD_BATCH, SD_HW
    images = torch.rand(B, H, W, 3, device="cuda", generator=gen) * 2 - 1
    noise = torch.randn(B, H // 8, W // 8, 4, device="cuda", generator=gen)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    feats = z(images, noise=noise)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    ms = cuda_ms(torch, lambda: z(images, noise=noise), iters=3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    shapes = [tuple(f.shape) for f in feats]
    finite = all(bool(torch.isfinite(f).all()) for f in feats)
    del feats
    ctx = z.cond_embedding(images[:1])
    taps32 = z(images[:1], cond_embeds=ctx, noise=noise[:1])
    z64 = copy.deepcopy(z)
    z64.unet.double()
    z64.vae.double()
    # the dense taps leave the featurizer as float32: the float64 run's are
    # rounded once (2^-24 relative), far below the float32 run's error
    taps64 = z64(images[:1].double(), cond_embeds=ctx.double(), noise=noise[:1].double())
    check64 = f64_errors(taps32, taps64)
    del z, z64, taps32, taps64
    flops = (sd_flops(torch, B, SD_HW, unet_cfg, 2, (1, 768))
             + vit_flops(B, 257, 256, 14, 1024, 24))
    res = {"phase": "forward_zero123", "model": "zero123", "batch": B, "image_hw": list(SD_HW),
           "dtype": "torch.float32", "tf32": False, "tap_shapes": shapes, "build_s": build_s,
           "k1_at_this_launch": {"shape": k1_case["shape"], "route": k1_case["route_ran"],
                                 **case_numbers(k1_case)},
           "conditioning_load_s": conditioning_s, "wall_s": wall_s, "forward_ms": ms,
           "imgs_per_s_per_card": B / (ms / 1e3), "peak_mem_gib": peak, "launches": counts,
           "flops": flops, "bound_ms": flops / PEAK_FP32_FLOPS * 1e3, "bound_by": "operations",
           "float64_check": {"images": 1, "context": "float32", **check64,
                             "bound": SD_F64_REL_BOUND},
           "nvidia_smi": smi, "gpu_state": gpu_state()}
    ok = (shapes == [(B, 30, 40, c) for c in FEAT_DIMS] and finite
          and all(counts[k] == n for k, n in ZERO123_LAUNCHES.items())
          and check64["max_rel_err"] <= SD_F64_REL_BOUND)
    sd_phase_end(torch, res, ok, "forward_zero123")
    return counts


CACHED_ITEMS, CACHED_BATCH, CACHED_EPOCHS = 32, 8, 3


def phase_path_depth_cached(torch, smi: str) -> dict:
    """The depth trainer through its ``entry`` on dino_b16 (bf16, random
    weights) at 480x640 with ``system.cache_features=true``: 32 synthetic
    items in batches of 8, three epochs, the DPT probe, renders off; run
    under the default budgets, with ``MVP_FEATURE_CACHE_DEVICE_GB=0`` (the
    host tier serves) and with both budgets 0 (every epoch recomputes). Per
    run and epoch: the backbone forwards, the wall time, the device tier's
    and the host tier's bytes and peak memory; per run: K1 12 per backbone
    forward on wgmma, finite losses, one CSV row. Returns the launch counts
    of the three runs together."""
    from midvision_probe_torch import train_depth
    from midvision_probe_torch.engine import probe_fit
    from midvision_probe_torch.models.feature_extractor import FeatureExtractor

    n_batches = CACHED_ITEMS // CACHED_BATCH
    epochs = []
    train_epoch = probe_fit.ProbeTrainer.train_epoch

    def timed_epoch(self, loader, *args, **kwargs):
        before, t0 = FeatureExtractor.forward_count, time.perf_counter()
        out = train_epoch(self, loader, *args, **kwargs)
        torch.cuda.synchronize()
        epochs.append({"backbone_forwards": FeatureExtractor.forward_count - before,
                       "wall_s": time.perf_counter() - t0,
                       "device_tier_bytes": self._dev_cache_bytes,
                       "host_tier_bytes": self._cache_bytes,
                       "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
        return out

    runs, total = [], {}
    probe_fit.ProbeTrainer.train_epoch = timed_epoch
    try:
        for label, dev_gb, host_gb, want in (
                ("default", None, None, [n_batches, 0, 0]),
                ("host_tier", "0", None, [n_batches, 0, 0]),
                ("no_budget", "0", "0", [n_batches] * CACHED_EPOCHS)):
            out_dir = tempfile.mkdtemp(prefix="mvp_chip_smoke_")
            argv = ["backbone=dino_b16", "dataset=synthetic", "dataset.image_size=[480,640]",
                    f"dataset.num_instances={CACHED_ITEMS}", "probe=depth_dpt",
                    f"batch_size={CACHED_BATCH}", "optimizer=one_epoch",
                    f"optimizer.n_epochs={CACHED_EPOCHS}", "+system.backbone_dtype=bfloat16",
                    "system.cache_features=true", "+render_images=False"]
            del epochs[:]
            try:
                with env_vars(MVP_FEATURE_CACHE_DEVICE_GB=dev_gb, MVP_FEATURE_CACHE_GB=host_gb):
                    torch.cuda.reset_peak_memory_stats()
                    reset_counts()
                    t0 = time.perf_counter()
                    row = train_depth.entry(argv + [f"output_dir={out_dir}"])
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    counts = read_counts()
                csvs = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
            finally:
                shutil.rmtree(out_dir, ignore_errors=True)
            losses = row.pop("train_losses")
            forwards = [e["backbone_forwards"] for e in epochs]
            run = {"budgets": label, "MVP_FEATURE_CACHE_DEVICE_GB": dev_gb,
                   "MVP_FEATURE_CACHE_GB": host_gb, "epochs": list(epochs), "wall_s": wall,
                   "train_losses": losses, "sa_rmse": row["sa_rmse"], "launches": counts,
                   "checks": {"forwards_per_epoch": forwards == want,
                              "tier": (epochs[-1]["device_tier_bytes"] > 0) == (dev_gb is None)
                              and (epochs[-1]["host_tier_bytes"] > 0) == (label == "host_tier"),
                              "losses_finite": len(losses) == n_batches * CACHED_EPOCHS
                              and all(math.isfinite(x) for x in losses),
                              "csv_written": len(csvs) == 1,
                              "attention_per_forward": per_forward_ok(counts, DINO_PER_FORWARD)}}
            runs.append(run)
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
    finally:
        probe_fit.ProbeTrainer.train_epoch = train_epoch
    res = {"phase": "path_depth_cached", "argv": argv, "runs": runs, "nvidia_smi": smi,
           "gpu_state": gpu_state()}
    emit(res)
    torch.cuda.empty_cache()
    if not all(all(r["checks"].values()) for r in runs):
        raise SystemExit(f"path_depth_cached check failed: {[r['checks'] for r in runs]}")
    return total


# the sweep's fast-suite settings (launch_script/sweep.py): the feature
# cache, a bf16 backbone and a bf16 probe
DDP_ARGV = ["backbone=dino_b16", "dataset=synthetic", "dataset.image_size=[480,640]",
            f"dataset.num_instances={CACHED_ITEMS}", "probe=depth_dpt",
            f"batch_size={CACHED_BATCH}", "optimizer=one_epoch",
            f"optimizer.n_epochs={CACHED_EPOCHS}", "+system.backbone_dtype=bfloat16",
            "system.cache_features=true", "system.probe_dtype=bfloat16",
            "+render_images=False"]


def deterministic_cudnn(torch) -> None:
    """cuDNN's deterministic algorithms, so the plain and the group run of
    ``path_depth_ddp`` can agree to the last bit."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def depth_run(torch, out_dir: str) -> dict:
    """``train_depth`` through its ``entry`` with ``DDP_ARGV``: its row,
    losses, wall, launch counts and the all-reduces it made."""
    from midvision_probe_torch import train_depth
    from midvision_probe_torch.parallel import multihost

    before = multihost.counts["all_reduce"]
    reset_counts()
    t0 = time.perf_counter()
    row = train_depth.entry(DDP_ARGV + [f"output_dir={out_dir}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = row.pop("train_losses")
    return {"wall_s": wall, "launches": read_counts(), "train_losses": losses,
            "steps": len(losses), "all_reduces": multihost.counts["all_reduce"] - before,
            "row": row}


def ddp_worker(out_json: str, out_dir: str) -> int:
    """``--ddp-worker``: one rank under ``torch.distributed.run``, whose
    environment the driver reads to join the NCCL group: the run of
    ``depth_run`` and the group's backend, world size and rank, written to
    ``out_json``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    deterministic_cudnn(torch)
    res = depth_run(torch, out_dir)
    res.update(backend=dist.get_backend(), world_size=dist.get_world_size(),
               rank=dist.get_rank(), local_rank=int(os.environ["LOCAL_RANK"]),
               device=str(torch.device("cuda", torch.cuda.current_device())))
    with open(out_json, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def csv_row(out_dir: str) -> dict:
    import csv

    (name,) = [f for f in os.listdir(out_dir) if f.endswith(".csv")]
    with open(os.path.join(out_dir, name), newline="") as f:
        (row,) = list(csv.DictReader(f))
    return row


def phase_path_depth_ddp(torch, smi: str) -> dict:
    """``train_depth`` on dino_b16 at 480x640 with the DPT probe and the
    sweep's three bf16 settings (``DDP_ARGV``; the items, batch and epochs
    of ``path_depth_cached``), run twice with cuDNN deterministic: plainly
    in this process, and as a one-rank NCCL process group, a subprocess
    started by ``python -m torch.distributed.run --nproc_per_node=1``. Per
    run: the wall, K1's launches by route, the all-reduces per step; the
    group run's backend, world size and rank. Gates: the two CSV rows
    within 1e-4 relative, finite losses, the group's backend ``nccl``, its
    world size 1, all-reduces in its steps, K1 12 per backbone forward on
    wgmma in both. Returns the two runs' launch counts together."""
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    deterministic_cudnn(torch)
    tmp = tempfile.mkdtemp(prefix="mvp_chip_smoke_ddp_")
    try:
        plain_dir, group_dir = os.path.join(tmp, "plain"), os.path.join(tmp, "group")
        plain = depth_run(torch, plain_dir)
        plain_row = csv_row(plain_dir)
        torch.cuda.empty_cache()
        out_json = os.path.join(tmp, "group.json")
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes=1",
               "--nproc_per_node=1", "--master_addr=127.0.0.1", f"--master_port={free_port()}",
               os.path.join(HERE, "chip_smoke.py"), "--ddp-worker", out_json, group_dir]
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, start_new_session=True)
        try:
            log = proc.communicate(timeout=600)[0]
        finally:
            if proc.poll() is None:  # timed out: stop torchrun and its worker
                os.killpg(proc.pid, 9)
                proc.wait()
        launcher_wall = time.perf_counter() - t0
        if proc.returncode != 0:
            print(log[-6000:], file=sys.stderr, flush=True)
            raise SystemExit(f"path_depth_ddp: the torch.distributed.run group run failed "
                             f"(exit {proc.returncode})")
        with open(out_json) as f:
            group = json.load(f)
        group_row = csv_row(group_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    rel = {}
    for k, v in plain_row.items():
        try:
            a, b = float(v), float(group_row[k])
        except ValueError:
            continue
        rel[k] = abs(a - b) / max(abs(a), abs(b), 1e-30)
    max_rel_key = max(rel, key=rel.get)
    runs = {"plain": plain, "group": group}
    for run in runs.values():
        run.pop("row")
        run["all_reduces_per_step"] = run["all_reduces"] / max(run["steps"], 1)
    checks = {"csv_within_1e-4": rel[max_rel_key] <= 1e-4,
              "csv_columns_equal": set(plain_row) == set(group_row),
              "losses_finite": all(math.isfinite(x) for r in runs.values()
                                   for x in r["train_losses"])
              and plain["steps"] == group["steps"] == (CACHED_ITEMS // CACHED_BATCH)
              * CACHED_EPOCHS,
              "group_backend_nccl": group["backend"] == "nccl",
              "group_world_size_1": group["world_size"] == 1 and group["rank"] == 0,
              "group_all_reduces": group["all_reduces_per_step"] > 0,
              "plain_no_all_reduces": plain["all_reduces"] == 0,
              "attention_per_forward": all(per_forward_ok(r["launches"], DINO_PER_FORWARD)
                                           for r in runs.values())}
    res = {"phase": "path_depth_ddp", "argv": DDP_ARGV, "runs": runs,
           "launcher_wall_s": launcher_wall, "csv_max_rel_diff": rel[max_rel_key],
           "csv_max_rel_diff_column": max_rel_key, "checks": checks, "nvidia_smi": smi,
           "gpu_state": gpu_state()}
    emit(res)
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise SystemExit(f"path_depth_ddp check failed: {checks}")
    return {k: plain["launches"][k] + group["launches"][k] for k in plain["launches"]}


def phase_profiling(torch, smi: str) -> dict:
    """``utils/profiling.py`` on the dino_b16 forward (bf16, 4 taps, batch 8
    at 480x640): ``time_fn``, ``device_memory_stats()`` and a ``trace()``
    around one forward. Gates: the Chrome trace file exists and holds
    kernel events, the memory stats are non-empty, K1 12 per forward; the
    trace holds the forward's spans (one ``mvp.backbone``, 12
    ``mvp.backbone.attention``, 12 ``mvp.backbone.mlp``), each a host
    ``cpu_op``, so no device event is named like a span. Returns the
    launch counts."""
    from midvision_probe_torch.models.zoo import build_vit_extractor
    from midvision_probe_torch.utils import profiling

    backbone = build_vit_extractor("dino_vitb16", return_multilayer=True,
                                   dtype=torch.bfloat16, device="cuda")
    images = torch.randn(8, 480, 640, 3, device="cuda")
    trace_dir = tempfile.mkdtemp(prefix="mvp_chip_smoke_trace_")
    try:
        reset_counts()
        with torch.no_grad():
            timing = profiling.time_fn(backbone.features, images, warmup=2, iters=10)
            with profiling.trace(trace_dir) as log_dir:
                backbone.features(images)
                torch.cuda.synchronize()
        counts = read_counts()
        stats = profiling.device_memory_stats()
        trace_file = os.path.join(log_dir, "trace.json")
        exists = os.path.isfile(trace_file)
        events = []
        if exists:
            with open(trace_file) as f:
                events = json.load(f).get("traceEvents", [])
        kernels = [e for e in events if e.get("cat") == "kernel"]
        spans = [e for e in events if str(e.get("name", "")).startswith("mvp.")]
        trace = {"file_bytes": os.path.getsize(trace_file) if exists else 0,
                 "events": len(events), "kernel_events": len(kernels),
                 "kernel_ms": sum(e.get("dur", 0) for e in kernels) / 1e3,
                 "spans": {name: sum(e["name"] == name for e in spans)
                           for name in sorted({e["name"] for e in spans})},
                 "span_categories": sorted({str(e.get("cat")) for e in spans})}
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    card = stats.get("cuda:0") or {}
    checks = {"trace_written": exists and trace["kernel_events"] > 0,
              "memory_stats": bool(card) and card.get("bytes_in_use", 0) > 0
              and card.get("peak_bytes_in_use", 0) >= card.get("bytes_in_use", 0),
              "attention_per_forward": per_forward_ok(counts, DINO_PER_FORWARD),
              "spans": trace["spans"] == {"mvp.backbone": 1, "mvp.backbone.attention": 12,
                                          "mvp.backbone.mlp": 12},
              "no_span_on_the_device": trace["span_categories"] == ["cpu_op"]}
    emit({"phase": "profiling", "model": "dino_vitb16", "batch": 8, "image_hw": [480, 640],
          "dtype": "bfloat16", "time_fn": timing, "device_memory_stats": stats,
          "trace": trace, "launches": counts, "checks": checks, "nvidia_smi": smi,
          "gpu_state": gpu_state()})
    del backbone, images
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise SystemExit(f"profiling check failed: {checks}")
    return counts


# ---------------------------------------------------------------- the suite
# simclr_resnet50 beside it took the new phases to ~420 s on the card (PR
# 17's first call), over the ~300 s they may add: the suite runs every
# task on one backbone
SUITE_MODELS = ("dino_b16",)
# the cells the suite runs: its six default tasks but snorm (the
# surface-normal trainer runs on a NYU tree in path_snorm_nyu), and not the
# depth_dpt192 preset cell (preset_ab's dpt-192-hd256 arm): both cut to
# keep the script's time
SUITE_TASKS = ("depth", "navi", "scannet", "spair", "percepture")
# the two cells replayed in this process with the launch counts reset
SUITE_REPLAYS = (("depth", "dino_b16", "train_depth"),
                 ("navi", "dino_b16", "evaluate_navi_correspondence"))


@contextlib.contextmanager
def fresh_process_flags(torch):
    """torch's default backend flags (those of a fresh driver process) for
    an in-process replay of a suite cell, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = (False, True,
                                                                           False, False)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) = saved


def disk_tier_state(root: str) -> dict:
    """Each file of the synthetic sets' disk tier by (inode, mtime): a miss
    stores its item again through ``os.replace``, a new inode."""
    if not os.path.isdir(root):
        return {}
    return {f: (os.stat(os.path.join(root, f)).st_ino,
                os.stat(os.path.join(root, f)).st_mtime_ns) for f in os.listdir(root)}


def task_csv_rows(out_root: str, task: str) -> list:
    """The rows of the task's CSVs in the suite's output tree (SPair: its
    ``all`` rows, one a cell)."""
    import csv

    rows = []
    for path in sorted(glob.glob(os.path.join(out_root, task, "*.csv"))):
        with open(path, newline="") as f:
            rows += list(csv.DictReader(f))
    if rows and "Class" in rows[0]:
        rows = [r for r in rows if r["Class"] == "all"]
    return rows


def row_of(rows: list, model_key: str) -> dict | None:
    """The row whose checkpoint column names the suite's ``model_key``
    (``dino_b16`` -> ``dino_vitb16``)."""
    from midvision_probe_torch.launch.aggregate_results import _model_of, _names_match

    found = [r for r in rows if _names_match(_model_of(r) or "", model_key)]
    return found[-1] if found else None


def table_backbones(markdown: str, task: str) -> list:
    """The backbone column of the ranking table ``## <task> (...)``."""
    lines = markdown.splitlines()
    start = next((i for i, ln in enumerate(lines) if ln.startswith(f"## {task} (")), None)
    if start is None:
        return []
    names = []
    for ln in lines[start + 4:]:
        if not ln.startswith("| "):
            break
        names.append(ln.split("|")[1].strip())
    return names


def phase_path_suite(torch, smi: str) -> dict:
    """The port's full-suite runner (``launch/suite_run.py``) on the card:
    ``--models dino_b16`` x ``SUITE_TASKS`` (five of the six default tasks)
    at the plan's own sizes (first ``--tasks depth``, then the other four),
    5 driver processes with a fresh ``$MVP_SYNTH_DISK_CACHE``; then
    ``launch/aggregate_results.py`` over the CSV archive. The depth and NAVI
    cells are replayed in this process with the launch counts reset, and
    each replay's CSV row is held to its cell's. Gates: every cell rc 0, one
    CSV row a cell, a ranking table for each task listing the backbone, the
    depth replay reading items the depth cell wrote to the disk tier (none
    rewritten by the later cells or the replays), the NAVI replay's row
    equal to its cell's to the last digit (every column but the time
    stamp), the depth replay's within 1e-3 relative (its bit equality
    reported: the cause of a difference is at the gate) and K1 (and K4 for
    NAVI) launched. Returns the replays' launch counts by path."""
    from midvision_probe_torch import evaluate_navi_correspondence, train_depth
    from midvision_probe_torch.datasets.synthetic import SyntheticDepth
    from midvision_probe_torch.launch import aggregate_results, suite_run

    root = tempfile.mkdtemp(prefix="mvp_chip_smoke_suite_")
    synth = os.path.join(root, "synth_cache")
    log_dir, out_root = os.path.join(root, "logs"), os.path.join(root, "out")
    common = ["--log-dir", log_dir, "--out", os.path.join(log_dir, "suite_run.md"),
              "--suite-out", out_root]
    runs, tier = [], {}
    counts_by_path, replays = {}, {}
    try:
        with env_vars(MVP_SYNTH_DISK_CACHE=synth, MVP_CHECKPOINT_DIR=None):
            for argv in (["--tasks", "depth", "--models", *SUITE_MODELS],
                         ["--tasks", *SUITE_TASKS[1:], "--models", *SUITE_MODELS]):
                before = disk_tier_state(synth)
                t0 = time.perf_counter()
                rc = suite_run.main(argv + common)
                runs.append({"argv": argv, "rc": rc, "wall_s": time.perf_counter() - t0})
                after = disk_tier_state(synth)
                tier[" ".join(argv)] = {
                    "files_before": len(before), "files_after": len(after),
                    "unchanged": sum(1 for f, v in before.items() if after.get(f) == v),
                    "rewritten": sum(1 for f, v in before.items()
                                     if f in after and after[f] != v)}
            with open(os.path.join(log_dir, "suite_rows.json")) as f:
                rows = json.load(f)
            agg_md = os.path.join(root, "results_tables.md")
            agg_rc = aggregate_results.main(["--csv-dir", os.path.join(log_dir, "csv"),
                                             "--out", agg_md])
            with open(agg_md) as f:
                tables = f.read()
            csv_rows = {t: task_csv_rows(out_root, t) for t in SUITE_TASKS}
            # the disk tier's saving: generating one 480x480 item against
            # reading it back (this host's CPU)
            items = SyntheticDepth(64, (480, 480), seed=0)
            t0 = time.perf_counter()
            for i in range(4):
                items._generate(i)
            gen_s = (time.perf_counter() - t0) / 4
            t0 = time.perf_counter()
            for i in range(4):
                items._disk_load(i)
            load_s = (time.perf_counter() - t0) / 4
            # the replays: the same driver, overrides and device in this process
            plan = suite_run.task_plan(os.path.join(out_root, "spair_tree"))
            drivers = {"train_depth": train_depth,
                       "evaluate_navi_correspondence": evaluate_navi_correspondence}
            # the replays read the disk tier the depth cell wrote: count its hits
            disk_load, hits = SyntheticDepth._disk_load, []

            def counted_load(self, index):
                item = disk_load(self, index)
                hits.append(item is not None)
                return item

            SyntheticDepth._disk_load = counted_load
            before_replays = disk_tier_state(synth)
            for task, model, driver in SUITE_REPLAYS:
                out_dir = os.path.join(root, f"replay_{task}")
                argv = ([f"backbone={model}", f"output_dir={out_dir}"] + plan[task][1]
                        + ["+system.device=cuda"])
                with fresh_process_flags(torch):
                    reset_counts()
                    t0 = time.perf_counter()
                    drivers[driver].entry(argv)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                    counts = read_counts()
                replay_row = csv_row(out_dir)
                cell_row = row_of(csv_rows[task], model) or {}
                differ = {k: [v, cell_row.get(k)] for k, v in replay_row.items()
                          if k != "Time" and cell_row.get(k) != v}
                rel = {k: abs(float(a) - float(b)) / max(abs(float(a)), abs(float(b)), 1e-30)
                       for k, (a, b) in differ.items() if b is not None and a.strip()
                       and b.strip() and a.strip() != "nan"}
                worst = max(rel, key=rel.get, default=None)
                counts_by_path[f"path_suite_{task}_{model}"] = counts
                replays[f"{task}/{model}"] = {
                    "wall_s": wall, "launches": counts, "columns": len(replay_row),
                    "bit_equal": not differ, "columns_differing": len(differ),
                    "max_rel_diff": rel.get(worst, 0.0) if len(rel) == len(differ)
                    else float("inf"), "max_rel_column": worst}
            after = disk_tier_state(synth)
            tier["replays"] = {
                "files_before": len(before_replays), "files_after": len(after),
                "unchanged": sum(1 for f, v in before_replays.items() if after.get(f) == v),
                "rewritten": sum(1 for f, v in before_replays.items()
                                 if f in after and after[f] != v),
                "hits": sum(hits), "misses": len(hits) - sum(hits)}
    finally:
        SyntheticDepth._disk_load = disk_load
        shutil.rmtree(root, ignore_errors=True)
    cells = {f"{r['task']}/{r['model']}": {"rc": r["rc"], "wall_s": r["wall_s"]} for r in rows}
    task_totals = {}
    for r in rows:
        task_totals[r["task"]] = task_totals.get(r["task"], 0.0) + r["wall_s"]
    second = tier[" ".join(["--tasks", *SUITE_TASKS[1:], "--models", *SUITE_MODELS])]
    replayed = tier["replays"]
    listed = {t: table_backbones(tables, t) for t in SUITE_TASKS}

    def lists(task, models):
        from midvision_probe_torch.launch.aggregate_results import _names_match

        return all(any(_names_match(n, m) for n in listed[task]) for m in models)

    k1 = {p: c["k1"] for p, c in counts_by_path.items()}
    checks = {
        "runs_rc_0": all(r["rc"] == 0 for r in runs) and agg_rc == 0,
        "cells_green": len(rows) == len(SUITE_MODELS) * len(SUITE_TASKS)
        and all(r["rc"] == 0 for r in rows),
        "one_csv_row_a_cell": all(len(csv_rows[t]) == len(SUITE_MODELS) for t in SUITE_TASKS),
        "tables_list_the_backbones": all(lists(t, SUITE_MODELS) for t in SUITE_TASKS),
        "disk_tier_read_back": second["files_before"] > 0 and second["rewritten"] == 0
        and second["unchanged"] == second["files_before"] and replayed["hits"] > 0
        and replayed["misses"] == 0 and replayed["rewritten"] == 0,
        # NAVI evaluates only: the replay gives the cell's row to the last
        # digit. The depth cell trains its bf16 probe for 20 steps, and
        # cuDNN's plan for the probe's convolutions is picked among those
        # whose workspace fits the largest free block of the caching
        # allocator at the call, so another process state can take another
        # algorithm: ~1e-4 relative in the metrics (PR 17's chip calls: a
        # cell, and the replay after a 30 GB block was freed, equal to the
        # last digit; after empty_cache 1.1e-4 apart)
        "navi_replay_bit_equal": replays[f"navi/{SUITE_REPLAYS[1][1]}"]["bit_equal"],
        "depth_replay_within_1e-3": replays[f"depth/{SUITE_REPLAYS[0][1]}"]["max_rel_diff"]
        <= 1e-3,
        "replays_launch_k1": all(n > 0 for n in k1.values()),
        "navi_replay_launches_k4": counts_by_path[
            f"path_suite_navi_{SUITE_REPLAYS[1][1]}"]["k4"] > 0,
    }
    res = {"phase": "path_suite", "models": list(SUITE_MODELS), "tasks": list(SUITE_TASKS),
           "runs": runs, "cells": cells, "task_totals_s": task_totals,
           "suite_wall_s": sum(r["wall_s"] for r in runs),
           "disk_tier": {"by_run": tier, "hits_after_depth": replayed["hits"],
                         "generate_s_per_item": gen_s, "load_s_per_item": load_s,
                         "saving_s_after_depth": replayed["hits"] * (gen_s - load_s)},
           "csv_rows": {t: len(v) for t, v in csv_rows.items()},
           "tables": listed, "replays": replays, "checks": checks,
           "nvidia_smi": smi, "gpu_state": gpu_state()}
    emit(res)
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise SystemExit(f"path_suite check failed: {checks}")
    return counts_by_path


# --------------------------------------------------- instance-mask extraction
INSTANCE_MASK_IMAGES = 4


def phase_instance_masks(torch, smi: str) -> dict:
    """The port's ``data_processing/extract_instance_masks.py`` through its
    ``main`` over 4 fabricated VOC frames (``make_voc_tree``) with
    dino_vitb16 loaded from the full-size fabricated ``dino_vitb16.pth``,
    ``--fixed-size 480 --num-masks 3`` (float32: K1 at B = 1, N = 901 on
    ``tf32x3``). Gates: rc 0, one npz an image with 1-3 bool masks at the
    image's size and its ``combined`` map, ``index.csv`` with one row an
    image whose counts match the npz, no random init, K1 12 an image on
    ``tf32x3``. Reports the host seconds by stage and the CRF's share of
    the wall. Returns the launch counts."""
    import csv

    import numpy as np
    from PIL import Image

    from midvision_probe_torch.data_processing import extract_instance_masks
    from midvision_probe_torch.models import zoo

    root = tempfile.mkdtemp(prefix="mvp_chip_smoke_masks_")
    try:
        voc = os.path.join(root, "VOC2007")
        make_voc_tree(voc, INSTANCE_MASK_IMAGES, seed=37)
        ckpt_dir = os.path.join(root, "checkpoints")
        os.makedirs(ckpt_dir)
        torch.save(dino_vitb16_container(torch),
                   os.path.join(ckpt_dir, zoo.ZOO["dino_vitb16"].filename))
        images, out = os.path.join(voc, "JPEGImages"), os.path.join(root, "masks")
        argv = ["--images", images, "--out", out, "--backbone", "dino_vitb16",
                "--fixed-size", "480", "--num-masks", "3"]
        with checkpoints_in(ckpt_dir) as random_inits, maskcut_stages_timed() as stages:
            reset_counts()
            t0 = time.perf_counter()
            rc = extract_instance_masks.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        with open(os.path.join(out, "index.csv"), newline="") as f:
            index = list(csv.DictReader(f))
        per_image = []
        for row in index:
            with np.load(row["npz"]) as z:
                masks, combined = z["masks"], z["combined"]
            h, w = Image.open(row["image"]).size[::-1]
            per_image.append({"image": os.path.basename(row["image"]),
                              "masks": int(masks.shape[0]), "dtype": str(masks.dtype),
                              "shape_ok": masks.shape[1:] == (h, w) and combined.shape == (h, w),
                              "index_agrees": int(row["num_masks"]) == masks.shape[0]
                              and int(row["mask_area_px"]) == int(masks.sum())})
        npz = [f for f in os.listdir(out) if f.endswith(".npz")]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    stages["rest"] = wall - sum(stages.values())
    checks = {
        "rc_0": rc == 0,
        "one_npz_an_image": len(npz) == INSTANCE_MASK_IMAGES,
        "index_rows": len(index) == INSTANCE_MASK_IMAGES,
        "masks_per_image": all(1 <= p["masks"] <= 3 and p["dtype"] == "bool"
                               and p["shape_ok"] and p["index_agrees"] for p in per_image),
        "weights_loaded": not random_inits,
        "one_forward_an_image": counts["forwards"] == INSTANCE_MASK_IMAGES,
        "attention_per_forward": per_forward_ok(counts, VIT_B_F32_PER_FORWARD),
    }
    emit({"phase": "instance_masks", "argv": [a for a in argv if root not in a],
          "images": INSTANCE_MASK_IMAGES, "per_image": per_image, "launches": counts,
          "wall_s": wall, "host_s": stages, "crf_share": stages["crf"] / wall,
          "checks": checks, "nvidia_smi": smi, "gpu_state": gpu_state()})
    if not all(checks.values()):
        raise SystemExit(f"instance_masks check failed: {checks}")
    return counts


# ------------------------------------------------------ weights-landing drill
DRILL_GOLDEN_ATOL = 2e-3  # the JAX drill's (export_golden.verify)


def phase_checkpoint_drill(torch, smi: str) -> dict:
    """The port's weights-landing drill (``data_processing/
    convert_checkpoints.py --all``) over four full-size fabricated files in
    a temporary ``$MVP_CHECKPOINT_DIR``: DINO ViT-B/16 (raw timm naming),
    OpenAI CLIP ViT-B/16 (open_clip), SAM ViT-B (segment_anything) and
    ConvNeXt-B (the open_clip container's trunk in timm naming, as
    ``convnext_base_in22k.pth`` holds it, the layout the JAX drill keeps a
    golden for). Each is converted, smoke-tested on the card and
    golden-verified against its independent torch replica on the CPU
    (``data_processing/export_golden.py``) at the JAX drill's atol, 2e-3;
    SAM's oracle is a ``transformers`` model, reported as having none on a
    host without it. Gates: 4 present, none failed (OK, or OK-SMOKE for a
    model without an oracle here), dino_vitb16 golden-verified within 2e-3
    on every tap, K1 12 a forward of the two ViTs (one smoke and one verify
    forward each) on ``tf32x3``. Returns the launch counts."""
    from midvision_probe_torch.data_processing import convert_checkpoints
    from midvision_probe_torch.models import zoo

    root = tempfile.mkdtemp(prefix="mvp_chip_smoke_drill_")
    try:
        laion = convnext_laion_container(torch)
        trunk = "visual.trunk."
        files = {"dino_vitb16": dino_vitb16_container(torch),
                 "clip_vitb16": clip_vitb16_container(torch),
                 "sam_vit_b": sam_vitb_container(torch),
                 "cnxt_b_in22k": {k[len(trunk):]: v for k, v in laion.items()
                                  if k.startswith(trunk)}}
        del laion
        t0 = time.perf_counter()
        for name, sd in files.items():
            torch.save(sd, os.path.join(root, zoo.ZOO[name].filename))
        write_s = time.perf_counter() - t0
        del files
        with checkpoints_in(root) as random_inits:
            reset_counts()
            t0 = time.perf_counter()
            res = convert_checkpoints.drill_rows()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    status = {name: (s, d) for name, s, d in res["rows"] if s != "MISSING"}
    readings = res["readings"]
    dino = readings.get("dino_vitb16", [])
    vit_forwards = 4  # dino and clip: one smoke and one verify forward each
    checks = {
        "four_present": sorted(status) == sorted(["dino_vitb16", "clip_vitb16", "sam_vit_b",
                                                  "cnxt_b_in22k"]),
        "none_failed": res["rc"] == 0 and all(s.startswith("OK") for s, _ in status.values()),
        "dino_golden_within_atol": len(dino) == 4 and max(dino) <= DRILL_GOLDEN_ATOL,
        "goldens_verified": {"dino_vitb16", "clip_vitb16", "cnxt_b_in22k"} <= set(readings),
        "no_random_init": not random_inits,
        "k1_per_vit_forward": counts["k1"] == 12 * vit_forwards
        and counts["route_tf32x3"] == 12 * vit_forwards,
    }
    emit({"phase": "checkpoint_drill", "status": status, "golden_readings": readings,
          "golden_atol": DRILL_GOLDEN_ATOL, "dino_max_err": max(dino) if dino else None,
          "launches": counts, "write_s": write_s, "wall_s": wall, "checks": checks,
          "nvidia_smi": smi, "gpu_state": gpu_state()})
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise SystemExit(f"checkpoint_drill check failed: {checks}")
    return counts


# ------------------------------------------------ commands in processes of their own
# readings of earlier phases that the two commands are held to:
# "forward" {model: images/s per card}, "suite_timing" [rows]
READINGS = {"forward": {}}


def counted_run(out_json: str, target: str, *argv: str) -> int:
    """``--counted OUT_JSON MODULE [ARGS...]``: ``python -m MODULE ARGS`` in
    this process, run as ``-m`` runs it; ``--counted OUT_JSON
    MODULE:FUNCTION [ARGS...]``: ``FUNCTION([ARGS...])`` of MODULE, its
    return value kept as ``result``. Every launch count is set to 0 first;
    the counts and the exit code are written to ``out_json`` when it ends
    (stdout is the command's alone)."""
    import runpy

    sys.path.insert(0, HERE)
    reset_counts()
    module, _, function = target.partition(":")
    sys.argv = [module, *argv]
    rc, result = 1, None
    try:
        if function:
            result = getattr(importlib.import_module(module), function)(list(argv))
        else:
            runpy.run_module(module, run_name="__main__", alter_sys=True)
        rc = 0
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else int(e.code is not None)
    finally:
        with open(out_json, "w") as f:
            json.dump({"rc": rc, "launches": read_counts(), "result": result}, f)
    return rc


def run_command(target: str, argv, timeout_s: int, **env) -> dict:
    """``python -m target argv`` (or ``target``'s ``module:function``) in a
    process of its own from the checkout's root, as a user runs it, through
    ``--counted``: its exit code, stdout, the tail of its stderr, its wall,
    the launch counts it made and the function's return value."""
    fd, out_json = tempfile.mkstemp(suffix=".json", prefix="mvp_chip_smoke_counts_")
    os.close(fd)
    cmd = [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--counted", out_json,
           target, *argv]
    try:
        with env_vars(**env):
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                                  timeout=timeout_s)
            wall = time.perf_counter() - t0
        with open(out_json) as f:
            counted = json.load(f)
    finally:
        os.remove(out_json)
    return {"rc": proc.returncode, "stdout": proc.stdout, "stderr_tail": proc.stderr[-2000:],
            "wall_s": wall, "launches": counted["launches"], "result": counted["result"]}


def within(x: float, ref: float, frac: float) -> bool:
    return math.isfinite(x) and abs(x / ref - 1) <= frac


# ------------------------------------------- suite timing, the A/Bs, the driver entry
def k1_on_route(counts: dict, route: str) -> bool:
    """K1 launched, every attention launch of the phase on ``route``."""
    return counts["k1"] > 0 and counts[f"route_{route}"] == counts["k1"] and all(
        counts[k] == 0 for k in ROUTE_KEYS if k != f"route_{route}")


def phase_suite_timing(torch, smi: str) -> dict:
    """The port's suite-timing tool (``launch/time_suite.py``) through its
    ``main`` in a process of its own (``run_command``) at the JAX script's
    defaults: batch 32 at 480², dino_vitb16
    and simclr_resnet50, the DPT probe in f32 and bf16 and the linear probe
    in bf16 (ResNet-50 without the f32 probe), the backbone in bf16. Prints
    each row's extraction, probe-step and full-step times and losses, the
    projection and the launches. Gates: the five rows, finite losses, every
    time positive, the projection equal to ``project_suite`` recomputed
    from the rows, the report naming the card, K1 12 a ViT forward, all on
    ``wgmma``. Then three probe steps of dino_vitb16's bf16 DPT probe under
    ``torch.profiler``: device ms a step by kernel and the busy share; and
    the timed steps' CUDA-graph replay against the eager step with the same
    ``capturable`` AdamW (``replay_against_eager``, the DPT and linear bf16
    probes): the losses within 1e-6 relative and the parameters'
    99.9th-percentile difference within 0.01 of the learning rate (the
    order of cuBLAS's and cuDNN's sums is all that may differ:
    ``launch/replay_spread.py`` measures that spread). Returns the launch
    counts."""
    from midvision_probe_torch.launch import time_suite

    root = tempfile.mkdtemp(prefix="mvp_chip_smoke_timing_")
    try:
        # a process of its own, as the command runs: this process's state
        # (a profiler session ran) slows host-bound work (PERF.md §6)
        run = run_command("midvision_probe_torch.launch.time_suite:main",
                          ["--out", os.path.join(root, "suite_timing.md")], 600)
        if run["rc"] != 0:
            raise SystemExit(f"suite_timing failed: {run['stderr_tail']}")
        res, wall, counts = run["result"], run["wall_s"], run["launches"]
        with open(res["report"]) as f:
            report = f.read()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # where the probe step's time goes: three steps of dino_vitb16's bf16
    # DPT probe on cached features under the profiler (after the counts)
    steps = time_suite.build_steps("dino_vitb16", 32, (480, 480), "dpt", "bfloat16")
    feats = steps.extract(steps.images)
    steps.probe_step(feats, steps.depth)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            steps.probe_step(feats, steps.depth)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    by_kernel = sorted(
        ((e.key, e.device_time_total / 1e3 / 3) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA), key=lambda kv: -kv[1])
    step_ms = sum(t for _, t in by_kernel)
    probe_profile = {"step_wall_ms": prof_wall * 1e3 / 3, "step_device_ms": step_ms,
                     "device_busy_share": step_ms * 3 / (prof_wall * 1e3),
                     "top_ms_per_step": [[k[:80], t] for k, t in by_kernel[:10]]}
    # the timed probe steps are CUDA-graph replays: each against the eager
    # step from the same seeded probe on these features
    replay = {"dpt-bf16": replay_against_eager(torch, time_suite, steps.backbone.feat_dim,
                                               "dpt", feats, steps.depth),
              "linear-bf16": replay_against_eager(torch, time_suite, feats[-1].shape[-1],
                                                  "linear", feats[-1:], steps.depth)}
    del steps, feats
    rows = READINGS["suite_timing"] = res["rows"]
    recomputed = time_suite.project_suite(
        [(r["tag"], r["extract_s"], r["probe_s"], r["full_s"]) for r in rows], 32)
    tags = [f"{m}/{h}" for m in ("dino_vitb16", "simclr_resnet50")
            for h in ("dpt-f32", "dpt-bf16", "linear-bf16")
            if not (m == "simclr_resnet50" and h == "dpt-f32")]
    checks = {
        "five_rows": [r["tag"] for r in rows] == tags,
        "finite_losses": all(math.isfinite(r["probe_loss"]) and math.isfinite(r["full_loss"])
                             for r in rows),
        "times_positive": all(r[k] > 0 for r in rows for k in ("extract_s", "probe_s", "full_s")),
        "projection_recomputed": recomputed == res["projection"],
        "report_names_the_card": smi.splitlines()[0].split(",")[0] in report,
        "k1_12_a_vit_forward_on_wgmma": k1_on_route(counts, "wgmma")
        and counts["k1"] % 12 == 0 and counts["k2"] == counts["k3"] == 0,
        **{f"{h}_replay_matches_capturable_eager":
           r["replayed_vs_capturable"]["loss_rel"] <= 1e-6
           and r["replayed_vs_capturable"]["q0.999_lr"] <= 0.01 for h, r in replay.items()},
    }
    proj = res["projection"]
    emit({"phase": "suite_timing", "wall_s": wall, "rows": rows,
          "projection_h": {k: proj[k] / 3600 for k in ("suite_cached", "suite_uncached",
                                                       "suite_linear")},
          "projection_s": proj, "cards": 4, "launches": counts,
          "dpt_bf16_probe_step_profile": probe_profile, "replay_against_eager": replay,
          "checks": checks,
          "nvidia_smi": smi, "gpu_state": gpu_state()})
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise SystemExit(f"suite_timing check failed: {checks}")
    return counts


def replay_against_eager(torch, time_suite, feat_dim, head: str, feats, depth,
                         n: int = 3) -> dict:
    """``Steps.graphed_probe_step`` (two eager warm-up steps, then ``n``
    replays) against ``n + 2`` eager ``probe_step`` calls with the same
    ``capturable`` AdamW, and against the eager step with the default
    AdamW (whose bias corrections are host floats), each from a fresh bf16
    probe of ``time_suite.build_probe``'s seed on ``feats``. The last
    ``n`` losses, and quantiles of the parameters' differences after, in
    units of the learning rate: AdamW's first updates are lr·sign(g), so a
    replay that did not update them would be ~1 lr off at the median."""
    runs = {}
    for arm in ("eager", "capturable", "replayed"):
        modules, optimizer = time_suite.build_probe(feat_dim, head, probe_dtype="bfloat16",
                                                    device="cuda")
        steps = time_suite.Steps(None, modules, optimizer, None, depth)
        if arm == "replayed":
            step = steps.graphed_probe_step(feats, depth)
        else:
            for group in optimizer.param_groups:
                group["capturable"] = arm == "capturable"
            for _ in range(2):
                steps.probe_step(feats, depth)
            step = steps.probe_step
        losses = [float(step(feats, depth)) for _ in range(n)]
        runs[arm] = (losses, torch.cat([p.detach().reshape(-1) for p in modules.parameters()]))
        del steps, step, modules, optimizer
    torch.cuda.empty_cache()

    def compare(a, b):
        (la, pa), (lb, pb) = runs[a], runs[b]
        diff = (pa - pb).abs().sort().values / time_suite.ADAMW_LR
        return {"loss_rel": max(abs(x - y) / abs(y) for x, y in zip(la, lb)),
                **{f"q{q}_lr": float(diff[int(q * (diff.numel() - 1))])
                   for q in (0.5, 0.99, 0.999, 1.0)}}

    return {"losses": {arm: r[0] for arm, r in runs.items()},
            "replayed_vs_capturable": compare("replayed", "capturable"),
            "replayed_vs_eager": compare("replayed", "eager")}


PRESET_AB_ARMS = ("protocol-dpt", "dpt-192-hd256", "fast-linear")


def phase_preset_ab(torch, smi: str) -> dict:
    """The port's suite-preset A/B (``launch/fast_preset_ab.py``) through
    its ``main`` on dino_b16, 64 synthetic instances, ``--size 480``, arms
    ``protocol-dpt``, ``dpt-192-hd256`` (trained at 192², its newest
    checkpoint reloaded and evaluated at 480²) and ``fast-linear``, with
    the sweep's cache and bf16 settings and each arm's step time from
    ``time_suite.measure_backbone``. Gates: three rows with finite sa_d1,
    si_d1 and sa_rmse and a positive step time; the reduced arm's row read
    from its ``_eval480`` directory (the CSV row there equal to it); the
    report written with the three rows; K1 on ``wgmma`` only. Returns the
    launch counts."""
    from midvision_probe_torch.launch import fast_preset_ab

    root = tempfile.mkdtemp(prefix="mvp_chip_smoke_preset_ab_")
    try:
        with env_vars(MVP_SYNTH_DISK_CACHE=os.path.join(root, "synth"),
                      MVP_CHECKPOINT_DIR=None):
            reset_counts()
            t0 = time.perf_counter()
            rows = fast_preset_ab.main([
                "--backbone", "dino_b16", "--instances", "64", "--size", "480",
                "--arms", *PRESET_AB_ARMS, "--out", os.path.join(root, "ab.md"),
                "--work-dir", root, "--rerun"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        reduced = next((r for r in rows if r["preset"] == "dpt-192-hd256"), {})
        eval_dir = os.path.join(root, "fast_ab_dpt-192-hd256_eval480")
        eval_csv = csv_row(eval_dir) if os.path.isdir(eval_dir) else {}
        with open(os.path.join(root, "ab.md")) as f:
            report = f.read()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    keys = ("sa_d1", "si_d1", "sa_rmse")
    checks = {
        "three_rows": [r["preset"] for r in rows] == list(PRESET_AB_ARMS),
        "finite_metrics": all(math.isfinite(r["metrics"][k]) for r in rows for k in keys),
        "step_times_positive": all(r["step_s"] > 0 and r["extract_s"] > 0 for r in rows),
        "reduced_arm_read_at_480": reduced.get("eval_dir") == eval_dir
        and reduced.get("train_size") == 192 and bool(eval_csv)
        and all(abs(float(eval_csv[k]) - reduced["metrics"][k])
                <= 1e-6 * max(1.0, abs(reduced["metrics"][k])) for k in keys),
        "report_rows": all(f"| {a} |" in report for a in PRESET_AB_ARMS),
        "k1_on_wgmma": k1_on_route(counts, "wgmma"),
    }
    emit({"phase": "preset_ab", "wall_s": wall,
          "rows": [{k: r[k] for k in ("preset", "train_size", "wall_s", "step_s", "extract_s",
                                      "suite_h", "eval_dir")}
                   | {k: r["metrics"][k] for k in ("sa_d1", "si_d1", "sa_rmse", "si_rmse")}
                   for r in rows],
          "launches": counts, "checks": checks, "nvidia_smi": smi, "gpu_state": gpu_state()})
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise SystemExit(f"preset_ab check failed: {checks}")
    return counts


def phase_shuffle_ab(torch, smi: str) -> dict:
    """The port's cache-shuffle A/B (``launch/shuffle_ab.py``) through its
    ``main`` at its own defaults (test_tiny, 256 synthetic instances at
    224², the linear probe, ``ten_epoch``, batch 32) on seeds 0 and 1.
    Gates: two finite rows per arm, the table written with both arms and
    the mean deltas; K1 on ``tf32x3`` (test_tiny runs in f32, head dim
    16). Returns the launch counts."""
    from midvision_probe_torch.launch import shuffle_ab

    root = tempfile.mkdtemp(prefix="mvp_chip_smoke_shuffle_ab_")
    try:
        with env_vars(MVP_CHECKPOINT_DIR=None):
            reset_counts()
            t0 = time.perf_counter()
            rows = shuffle_ab.main(["--seeds", "0", "1", "--out", os.path.join(root, "s.md"),
                                    "--work-dir", root])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
        with open(os.path.join(root, "s.md")) as f:
            table = f.read()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    checks = {
        "four_finite_rows": sorted(rows) == sorted(shuffle_ab.ARMS)
        and all(len(v) == 2 for v in rows.values())
        and all(math.isfinite(r[k]) for v in rows.values() for r in v
                for k in ("sa_d1", "si_d1")),
        "table_written": all(f"| {a} |" in table for a in shuffle_ab.ARMS)
        and "mean delta (cache − full-shuffle)" in table,
        "k1_on_tf32x3": k1_on_route(counts, "tf32x3"),
    }
    emit({"phase": "shuffle_ab", "wall_s": wall,
          "rows": {a: [{k: r[k] for k in ("sa_d1", "si_d1", "sa_rmse")} for r in v]
                   for a, v in rows.items()},
          "table_tail": table.strip().splitlines()[-3], "launches": counts,
          "checks": checks, "nvidia_smi": smi, "gpu_state": gpu_state()})
    if not all(checks.values()):
        raise SystemExit(f"shuffle_ab check failed: {checks}")
    return counts


def phase_graft_entry(torch, smi: str) -> dict:
    """The port's driver entry (``graft_entry.py``): ``entry()`` on the card
    (DINO B/16's dense 4-tap forward in bf16 at 480x640, batch 4; K1 12 on
    ``wgmma``, four finite (4, 30, 40, 768) float32 maps), then
    ``dryrun_multichip(4, preset="vitb")``: four ranks sharing this card
    (gloo, every collective staged through the host) as a 2 x 2 (data,
    model) grid, one step of dino_vitb16 in float32 at 480² with its heads
    split over the model groups, and the same step unsharded in this
    process on the same weights and global batch. Gates: the backend and
    world size as printed; every rank's loss finite and equal; that loss
    within 1e-4 relative of the unsharded one; every rank's gradients and
    updated parameters held to the unsharded step's by
    ``dryrun_update_errors``; the sharded K4 indices equal
    to the unsharded launch and its distances within 1e-6; the pipeline
    within 1e-4; K1 12 a rank on ``tf32x3`` at (1, 901, 3, 6, 64) and K4
    launched on every rank. Returns the launch counts: the entry's and
    the unsharded step's in this process, and the ranks' own."""
    from midvision_probe_torch import graft_entry

    reset_counts()
    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    build_s = time.perf_counter() - t0
    with torch.no_grad():
        maps = fn(*args)
    torch.cuda.synchronize()
    entry_counts = read_counts()
    entry_res = {"build_s": build_s, "shapes": [list(m.shape) for m in maps],
                 "dtypes": sorted({str(m.dtype) for m in maps}),
                 "finite": all(bool(torch.isfinite(m).all()) for m in maps),
                 "ms": cuda_ms(torch, lambda: fn(*args), iters=5, warmup=1),
                 "launches": entry_counts}
    del fn, args, maps
    torch.cuda.empty_cache()

    with env_vars(MVP_CHECKPOINT_DIR=None):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            dry = graft_entry.dryrun_multichip(4, preset="vitb")
        summary = buf.getvalue().strip()
        print(summary, flush=True)
        reset_counts()
        ref = graft_entry.reference_step("vitb", 4)
        torch.cuda.synchronize()
        ref_counts = read_counts()
    ranks = dry["ranks"]
    param_diff = max(float((ranks[0]["params"][k] - v).abs().max())
                     for k, v in ref["params"].items())
    update = [dryrun_update_errors(r, ref, graft_entry.ADAMW_LR) for r in ranks]
    rank_counts = {k: 0 for k in entry_counts}
    for r in ranks:
        rank_counts["k1"] += r["k1"]
        rank_counts["k4"] += r["matching"]["launches_sharded"]
        for route, n in r["routes"].items():
            rank_counts[f"route_{route}"] += n
    checks = {
        "entry_four_finite_maps": entry_res["shapes"] == [[4, 30, 40, 768]] * 4
        and entry_res["dtypes"] == ["torch.float32"] and entry_res["finite"],
        "entry_k1_12_on_wgmma": entry_counts["k1"] == 12 and k1_on_route(entry_counts, "wgmma"),
        "backend_and_world_size": dry["backend"] == "gloo" and dry["world_size"] == 4
        and dry["mesh"] == {"data": 2, "model": 2}
        and "backend=gloo world_size=4" in summary and "sharing 1 card" in summary,
        "losses_finite_and_equal": all(math.isfinite(r["loss"]) for r in ranks)
        and len({r["loss"] for r in ranks}) == 1,
        "loss_within_1e-4_of_unsharded": abs(dry["loss"] - ref["loss"])
        <= 1e-4 * abs(ref["loss"]),
        "grads_and_update_match_unsharded": all(u["ok"] for u in update),
        "sharded_knn2_equal": all(r["matching"]["idx_equal"]
                                  and r["matching"]["max_dist_err"] <= 1e-6
                                  and r["matching"]["launches_sharded"] == 1 for r in ranks),
        "pipeline_within_1e-4": all(r["pipeline"]["max_err"] <= 1e-4 for r in ranks),
        "k1_12_a_rank_at_6_heads_on_tf32x3": all(
            r["k1"] == 12 and r["routes"]["tf32x3"] == 12
            and tuple(r["k1_qkv_shape"]) == (1, 901, 3, 6, 64) for r in ranks),
        "unsharded_k1_on_tf32x3": ref_counts["k1"] == 12 and k1_on_route(ref_counts, "tf32x3"),
    }
    emit({"phase": "graft_entry", "entry": entry_res, "summary": summary,
          "dryrun": {"backend": dry["backend"], "world_size": dry["world_size"],
                     "mesh": dry["mesh"], "mode": dry["mode"], "wall_s": dry["wall_s"],
                     "loss": dry["loss"], "unsharded_loss": ref["loss"],
                     "loss_rel_diff": abs(dry["loss"] - ref["loss"]) / abs(ref["loss"]),
                     "params_max_abs_diff": param_diff,
                     "update_vs_unsharded": [{k: v for k, v in u.items() if k != "ok"}
                                             for u in update],
                     "ranks": [{k: r[k] for k in ("rank", "loss", "k1", "routes",
                                                  "k1_qkv_shape", "matching", "pipeline",
                                                  "all_reduce")} for r in ranks]},
          "checks": checks, "nvidia_smi": smi, "gpu_state": gpu_state()})
    torch.cuda.empty_cache()
    if not all(checks.values()):
        raise SystemExit(f"graft_entry check failed: {checks}")
    return {"graft_entry": entry_counts, "graft_dryrun_unsharded": ref_counts,
            "graft_dryrun_ranks": rank_counts}


DRY_SURE_GRAD = 0.05  # of a tensor's max|g|: above the step's rounding noise


def dryrun_update_errors(rank: dict, ref: dict, lr: float) -> dict:
    """A dry-run rank's gradients and updated parameters against the
    unsharded step's (``tests/test_torch_graft_entry.py``'s rule): every
    gradient within 5% of its tensor's max|g|, every parameter within
    1e-5 where the unsharded |g| exceeds 5% of that max (AdamW's first
    update is lr·sign(g) there), within a sign flip (2·lr + 1e-5)
    elsewhere, and the BatchNorm statistics within 1e-5·max|ref|."""
    grad_err = sure_err = other_err = stats_err = 0.0
    flips, ok = 0, rank["grads"].keys() == ref["grads"].keys()
    for name, want in ref["params"].items():
        err = (rank["params"][name] - want).abs()
        g = ref["grads"].get(name)
        if g is None:
            e = float(err.max())
            stats_err = max(stats_err, e)
            ok &= e <= 1e-5 * max(float(want.abs().max()), 1.0)
            continue
        gmax = float(g.abs().max())
        ge = float((rank["grads"][name] - g).abs().max())
        grad_err = max(grad_err, ge / max(gmax, 1e-30))
        sure = g.abs() > DRY_SURE_GRAD * gmax
        se = float(err[sure].max()) if bool(sure.any()) else 0.0
        oe = float(err.max())
        sure_err, other_err = max(sure_err, se), max(other_err, oe)
        flips += int((err > 1e-5).sum())
        ok &= gmax > 0 and ge <= DRY_SURE_GRAD * gmax and se <= 1e-5 and oe <= 2 * lr + 1e-5
    return {"ok": bool(ok), "grad_err_of_max": grad_err, "sure_param_err": sure_err,
            "param_err": other_err, "stats_err": stats_err, "flipped": flips}


# ------------------------------------------------- the headline bench, the matrix
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}


def phase_bench(torch, smi: str) -> dict:
    """The port's headline bench (``python -m midvision_probe_torch.bench``)
    as a process of its own at its defaults: DINO ViT-B/16, batch 64 at
    480x640, 4 taps, bf16, after its one-launch card probe. Gates: rc 0;
    exactly one line on stdout, a JSON object with the four keys, the
    headline metric, ``imgs/sec/chip`` and ``vs_baseline`` = value/250;
    the value finite and within 10% of the ``forward`` phase's DINO B/16
    images/s in this run (the bench also casts the four maps to f32); K1 12
    a forward on ``wgmma`` over its 21 forwards. Returns the launch counts."""
    from midvision_probe_torch import bench

    res = run_command("midvision_probe_torch.bench", [], 300,
                      MVP_BENCH_BACKBONE=None, MVP_BENCH_BATCH=None)
    lines = [ln for ln in res["stdout"].splitlines() if ln.strip()]
    try:
        line = json.loads(lines[0]) if len(lines) == 1 else None
    except json.JSONDecodeError:
        line = None
    counts = res["launches"]
    forward_rate = READINGS["forward"]["dino_vitb16"]
    value = float(line["value"]) if isinstance(line, dict) and "value" in line else math.nan
    checks = {
        "rc_0": res["rc"] == 0,
        "one_json_line": isinstance(line, dict) and set(line) == BENCH_KEYS,
        "headline_metric": isinstance(line, dict) and line.get("metric") == bench.metric_name(
            bench.HEADLINE) == "vitb16_dense_multilayer_imgs_per_sec_per_chip"
        and line.get("unit") == "imgs/sec/chip",
        "vs_baseline": isinstance(line, dict)
        and line.get("vs_baseline") == round(value / bench.BASELINE_IMGS_PER_SEC, 3),
        "within_10pct_of_forward": within(value, forward_rate, 0.10),
        "k1_12_a_forward_on_wgmma": counts["forwards"] == 1 + bench.N_ITERS
        and per_forward_ok(counts, DINO_PER_FORWARD),
    }
    emit({"phase": "bench", "line": line, "stdout_lines": len(lines),
          "forward_imgs_per_s": forward_rate,
          "ratio_to_forward": value / forward_rate, "wall_s": res["wall_s"],
          "launches": counts, "stderr_tail": res["stderr_tail"][-500:], "checks": checks,
          "nvidia_smi": smi, "gpu_state": gpu_state()})
    if not all(checks.values()):
        raise SystemExit(f"bench check failed: {checks}\n{res['stderr_tail']}")
    return counts


def suite_row(tag: str) -> dict:
    return next(r for r in READINGS["suite_timing"] if r["tag"] == tag)


def phase_bench_matrix(torch, smi: str) -> dict:
    """The port's regression matrix (``python -m
    midvision_probe_torch.launch.bench_matrix``) as a process of its own in
    its check mode against the committed
    ``launch/bench_matrix_expected.json``: the six rows, each printed with
    its value, its expectation and their ratio. Gates: the expectations
    file present with its ``_meta`` naming a card; rc 0 (no row regressed
    beyond 15%); all six rows measured; ``vitb16_extract`` within 10% of
    the ``forward`` phase's DINO B/16 images/s, ``vitb16_dpt_step`` and
    ``vitb16_linear_step`` within 10% of ``suite_timing``'s dino_vitb16
    ``dpt-bf16`` full step and ``linear-bf16`` probe step; K1 12 a ViT
    forward, all on ``wgmma``, and no other kernel (SAM, ConvNeXt and
    ResNet-50 run library ops). Returns the launch counts."""
    from midvision_probe_torch.launch import bench_matrix

    with open(bench_matrix.EXPECTED_PATH) as f:
        expected = json.load(f)
    root = tempfile.mkdtemp(prefix="mvp_chip_smoke_matrix_")
    try:
        out = os.path.join(root, "bench_matrix.json")
        res = run_command("midvision_probe_torch.launch.bench_matrix", ["--out", out], 600)
        with open(out) as f:
            measured = json.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    keys = [*bench_matrix.EXTRACT_ROWS, *bench_matrix.STEP_ROWS]
    rows = {k: {"value": measured[k]["value"], "unit": measured[k]["unit"],
                "expected": expected[k]["value"],
                "ratio": measured[k]["value"] / expected[k]["value"]}
            for k in keys if k in measured and k in expected}
    counts = res["launches"]
    # the extraction rows of ResNet-50, SAM-B and ConvNeXt-B run no ViT forward
    non_vit = 3 * (1 + bench_matrix.EXTRACT_ITERS)
    refs = {"vitb16_extract": READINGS["forward"]["dino_vitb16"],
            "vitb16_dpt_step": suite_row("dino_vitb16/dpt-bf16")["full_s"] * 1e3,
            "vitb16_linear_step": suite_row("dino_vitb16/linear-bf16")["probe_s"] * 1e3}
    checks = {
        "expectations_from_a_card": "card" in expected.get("_meta", {})
        and "CPU" not in expected["_meta"]["card"],
        "rc_0": res["rc"] == 0 and "all rows within tolerance" in res["stdout"],
        "six_rows": sorted(rows) == sorted(keys),
        **{f"{k}_within_10pct": k in rows and within(rows[k]["value"], ref, 0.10)
           for k, ref in refs.items()},
        "k1_12_a_vit_forward_on_wgmma": k1_on_route(counts, "wgmma")
        and counts["k1"] == 12 * (counts["forwards"] - non_vit)
        and all(counts[k] == 0 for k in KERNELS if k != "k1"),
    }
    emit({"phase": "bench_matrix", "rows": rows, "cross_check_refs": refs,
          "meta": measured.get("_meta"), "expected_meta": expected.get("_meta"),
          "wall_s": res["wall_s"], "launches": counts, "stdout": res["stdout"][-1500:],
          "stderr_tail": res["stderr_tail"][-500:], "checks": checks,
          "nvidia_smi": smi, "gpu_state": gpu_state()})
    if not all(checks.values()):
        raise SystemExit(f"bench_matrix check failed: {checks}\n{res['stderr_tail']}")
    return counts


# ------------------------------------------ the attention backward K10, K11
def attention_backward_bounds(B, N, n_valid, H, d, itemsize, peak_flops) -> dict:
    """Least time of one attention backward: its five products (S, dP, dV,
    dK, dQ) over the valid keys, 10*B*H*N*n_valid*d FLOP at the dtype's peak
    (bf16 989 TFLOP/s, f32 ``tf32x3`` 495/3), one exp2 per score on the
    MUFU, or q, k, v, the output and its gradient read and dq, dk, dv
    written once (with lse and di) at the memory rate."""
    flops = 10.0 * B * H * N * n_valid * d
    nbytes = 8.0 * B * H * N * d * itemsize + 8.0 * B * H * N
    return bounds(flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3,
                  exp2_ms(B, H, N, n_valid))


def exact_attention_grads(torch, q, k, v, dout, scale, n_valid):
    """dq, dk, dv of exact softmax attention in float64 over the keys <
    n_valid (dk, dv 0 past it); q is the q the scores see."""
    leaves = [t.detach().double().requires_grad_() for t in (q, k[:, :, :n_valid],
                                                              v[:, :, :n_valid])]
    p = torch.softmax(torch.einsum("bhqd,bhkd->bhqk", leaves[0] * scale, leaves[1]), -1)
    dq, dk, dv = torch.autograd.grad(torch.einsum("bhqk,bhkd->bhqd", p, leaves[2]), leaves,
                                     dout.double())
    pad = (0, 0, 0, q.shape[2] - n_valid)
    return dq, torch.nn.functional.pad(dk, pad), torch.nn.functional.pad(dv, pad)


def phase_backward_checks(torch) -> dict:
    """The attention backward K10 (``_flash_attention``'s, the jax library's
    dq and dkv kernels in the JAX package) and K11 (``splash_attention``'s)
    against the plain versions' autograd (``_vit_attention_plain``,
    ``_splash_attention_plain``; TF32 off) at RADIO-v2's K3 launch in f32
    (B=2, H=16, N=4097, d=80), K3's bf16 one (B=2, H=12, N=8192, d=64) and
    the bench's K9 shape (B=64, N=1280, n_valid=1201, H=12, d=64, bf16),
    and at B=1 against a float64 oracle. Gates, each of dq, dk and dv: f32
    within 1e-4 * max|ref| of the plain version (at full B) and of f64 (at
    B=1); bf16 within max(2^-6 * max|ref|, twice the plain bf16 version's
    own error against f64 at B=1) of either. Times (CUDA events, medians):
    the backward's launch (``launch_attention_backward``: di, the two
    kernels), the plain version's backward and SDPA's backward on the same
    operands (K11: k and v sliced to n_valid, q the rounded q * scale), with
    the bound. Each case names the route its backward launch reported
    (``backward_route_launches``) and must take: ``tf32x3`` in f32,
    ``wgmma`` in bf16. Also K2's and K3's forward time with and without the
    lse output."""
    import torch.nn.functional as F

    from midvision_probe_torch import bench_attn
    from midvision_probe_torch.ops.attention import _flash_attention
    from midvision_probe_torch.ops.vit_attention import (
        _vit_attention_plain,
        backward_route_launches,
        launch_attention,
        launch_attention_backward,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(20)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("k10_radio1024_fp32", "K10", 2, 16, 4097, 4097, 80, f32),
             ("k10_long_bf16", "K10", 2, 12, 8192, 8192, 64, bf16),
             ("k11_bench_bf16", "K11", 64, 12, 1280, 1201, 64, bf16)]
    results = []
    for name, kernel, B, H, N, nv, d, dtype in cases:
        scale = d**-0.5
        qkv = torch.randn(B, N, 3, H, d, device="cuda", generator=gen).to(dtype)
        dout = torch.randn(B, H, N, d, device="cuda", generator=gen).to(dtype)
        if kernel == "K10":
            q_scale, sm_scale = 1.0, scale
            wrapper = lambda x: _flash_attention(  # noqa: E731
                *x.permute(2, 0, 3, 1, 4).unbind(0), scale)
            plain = lambda x: _vit_attention_plain(  # noqa: E731
                *x.permute(2, 0, 3, 1, 4).unbind(0), scale)
            g_out = dout
        else:
            q_scale, sm_scale = scale, 1.0
            qkv[:, nv:, 1:] = float("nan")  # never read
            wrapper = lambda x: bench_attn.splash_attention(x, scale, nv)  # noqa: E731
            plain = lambda x: bench_attn._splash_attention_plain(x, scale, nv)  # noqa: E731
            g_out = dout.transpose(1, 2).reshape(B, N, H * d)

        def grads(fn, x, b=B):
            x = x[:b].detach().requires_grad_()
            (g,) = torch.autograd.grad(fn(x), x, g_out[:b])
            return g

        def errors(got, ref):
            return [(got[:, :, r].double() - ref[:, :, r].double()).abs().max().item()
                    for r in range(3)]

        routes = dict(backward_route_launches)
        got = grads(wrapper, qkv)
        ran = [r for r, n in backward_route_launches.items() if n != routes[r]]
        ref = grads(plain, qkv)
        torch.cuda.synchronize()
        err = errors(got, ref)
        max_ref = [ref[:, :, r].double().abs().max().item() for r in range(3)]
        finite = bool(torch.isfinite(got).all())
        padded_zero = kernel == "K10" or not got[:, nv:, 1:].any().item()
        del got, ref
        torch.cuda.empty_cache()
        # B = 1 against float64
        q1, k1, v1 = qkv[:1].permute(2, 0, 3, 1, 4).unbind(0)
        q1 = (q1.float() * q_scale).to(dtype)
        exact = exact_attention_grads(torch, q1, k1, v1, dout[:1], sm_scale, nv)
        # (1, H, 3, N, d) -> (1, N, 3, H, d), the layout of qkv's gradient
        exact = torch.stack([exact[0] * q_scale, exact[1], exact[2]], 2).transpose(1, 3)
        got1, ref1 = grads(wrapper, qkv, 1), grads(plain, qkv, 1)
        err64, plain_err64 = errors(got1, exact), errors(ref1, exact)
        max64 = [exact[:, :, r].abs().max().item() for r in range(3)]
        del exact, got1, ref1
        torch.cuda.empty_cache()
        if dtype == f32:
            gates = [1e-4 * m for m in max_ref]
            gates64 = [1e-4 * m for m in max64]
        else:
            gates = [max(2.0**-6 * m, 2 * pe) for m, pe in zip(max_ref, plain_err64)]
            gates64 = [max(2.0**-6 * m, 2 * pe) for m, pe in zip(max64, plain_err64)]
        route = "tf32x3" if dtype == f32 else "wgmma"  # the route each case must take
        ok = (finite and padded_zero and ran == [route]
              and all(e <= g for e, g in zip(err, gates))
              and all(e <= g for e, g in zip(err64, gates64)))
        res = {"case": name, "kernel": kernel, "shape": [B, H, N, d], "n_valid": nv,
               "dtype": str(dtype), "design": route, "route_ran": ran,
               "max_abs_err": max(err), "max_abs_err_dq_dk_dv": err, "max_abs_ref": max_ref,
               "tol": gates, "max_abs_err_vs_f64_b1": err64,
               "plain_err_vs_f64_b1": plain_err64, "tol_vs_f64_b1": gates64,
               "finite": finite, "padded_grads_zero": padded_zero, "ok": ok}
        # times: the backward's launch; the plain version's and SDPA's backward
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        qk = (q.float() * q_scale).to(dtype)
        with torch.no_grad():
            out, lse = launch_attention(q, k, v, sm_scale, nv, q_scale=q_scale,
                                        return_lse=True)
        res["kernel_ms"] = cuda_ms(torch, lambda: launch_attention_backward(
            q, k, v, out, lse, dout, sm_scale, nv, q_scale=q_scale), iters=5, warmup=1)
        leaves = [t.detach().requires_grad_() for t in (qk, k[:, :, :nv], v[:, :, :nv])]
        o_plain = _vit_attention_plain(*leaves, sm_scale)
        res["plain_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
            o_plain, leaves, dout, retain_graph=True), iters=3, warmup=1)
        del o_plain
        o_lib = F.scaled_dot_product_attention(*leaves, scale=sm_scale)
        res["library_ms"] = cuda_ms(torch, lambda: torch.autograd.grad(
            o_lib, leaves, dout, retain_graph=True), iters=5, warmup=1)
        del o_lib, leaves, out, lse
        res.update(attention_backward_bounds(B, N, nv, H, d, qkv.element_size(),
                                             PEAK_BF16_FLOPS if dtype == bf16
                                             else PEAK_TF32_FLOPS / 3))
        results.append(res)
        del qkv, dout, q, k, v, qk
        torch.cuda.empty_cache()
    # K2's and K3's forward launches with the residual asked and not
    forward_lse = {}
    for name, B, H, N, d, dtype in (("k2_radio_bf16", 64, 16, 1201, 80, bf16),
                                    ("k3_radio1024_fp32", 2, 16, 4097, 80, f32)):
        qkv = torch.randn(B, N, 3, H, d, device="cuda", generator=gen).to(dtype)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        with torch.no_grad():
            forward_lse[name] = {
                "ms_without_lse": cuda_ms(torch, lambda: launch_attention(q, k, v, d**-0.5)),
                "ms_with_lse": cuda_ms(torch, lambda: launch_attention(
                    q, k, v, d**-0.5, return_lse=True))}
        del qkv, q, k, v
        torch.cuda.empty_cache()
    emit({"phase": "backward_checks", "cases": results, "forward_lse": forward_lse})
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"backward check failed: {bad}")
    return {r["case"]: r for r in results}


def central_difference(torch, loss_fn, images, grad, eps: float, seed: int) -> dict:
    """The gradient along a seeded unit-RMS direction u, ``<grad, u>``,
    against ``(loss(x + eps u) - loss(x - eps u)) / (2 eps)`` from two
    forwards (no gradient recorded)."""
    u = torch.randn(images.shape, device=images.device,
                    generator=torch.Generator(device=images.device).manual_seed(seed))
    with torch.no_grad():
        fd = (loss_fn(images + eps * u) - loss_fn(images - eps * u)).item() / (2 * eps)
    along = (grad.double() * u.double()).sum().item()
    return {"eps": eps, "grad_along_u": along, "central_difference": fd,
            "rel_err": abs(along - fd) / max(abs(fd), 1e-30)}


GRAD_RADIO_BATCH = 2  # RADIO-v2's batch in grad_paths (peak <= 40 GiB)
RADIO_CHANNEL_SEED = 24  # its loss's channel weights


def phase_grad_paths(torch, smi: str) -> dict:
    """Input gradients through frozen backbones on the card, the
    counterpart of ``jax.grad`` over the JAX ``FeatureExtractor``, through
    the zoo's extractors at full width (seeded random weights), the loss the
    sum of squares of the four tapped maps:

    * RADIO-v2 in float32 at 1024x1024 (N = 4097, H = 16, d = 80: K+V over
      2 MB, so every block takes K3), batch ``GRAD_RADIO_BATCH``, TF32 off:
      one forward and one backward, K3 and K10 32 launches each (one a
      block), then the gradient along a seeded direction against a central
      difference of two more forwards (eps 1e-2 on unit-RMS images and
      direction), within 1e-2 relative. RADIO taps every map through its
      final LayerNorm, whose initial gain is 1 and bias 0, so each token's
      sum of squares is its width (1280) whatever the image: the plain sum
      of squares is a constant (its gradient only the LayerNorm's epsilon,
      ~1e-5 a pixel, which no central difference of f32 forwards resolves).
      The loss here scales the maps' channels by seeded weights in [0, 2)
      first (``RADIO_CHANNEL_SEED``);
    * DINO ViT-B/16 in bf16 at 480x640, batch 8: K1 12 launches on wgmma
      and the plain recompute as its backward (F12), a finite gradient whose
      cosine to the same path's float32 gradient (K1 on tf32x3, TF32 off)
      is at least 0.98;
    * the attention bench's splash variant (K9) under autograd at the bench
      shape (B=64, N=1280, n_valid=1201, H=12, d=64, bf16, the bench's
      ``randn * 0.6``): one K9 and one K11 launch, a finite gradient that is
      0 at the keys and values past n_valid.

    Each with its wall, peak memory and launch counts."""
    from midvision_probe_torch.models.zoo import build_vit_extractor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"phase": "grad_paths", "nvidia_smi": smi}

    def sq_loss(maps):
        return sum((m.double() ** 2).sum() for m in maps)

    # RADIO-v2, f32, 1024^2
    t0 = time.perf_counter()
    radio = build_vit_extractor("radio_v2", return_multilayer=True, dtype=torch.float32,
                                device="cuda")
    build_s = time.perf_counter() - t0
    images = torch.randn(GRAD_RADIO_BATCH, 1024, 1024, 3, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(21))
    weights = 2 * torch.rand(1280, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(RADIO_CHANNEL_SEED))

    def radio_loss(maps):
        return sq_loss([m * weights for m in maps])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    x = images.clone().requires_grad_()
    (grad,) = torch.autograd.grad(radio_loss(radio(x)), x)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del x
    t0 = time.perf_counter()
    cd = central_difference(torch, lambda im: radio_loss(radio(im)), images, grad, 1e-2, 22)
    cd_s = time.perf_counter() - t0
    counts_all = read_counts()
    finite = bool(torch.isfinite(grad).all())
    radio_ok = {
        "launches": counts["forwards"] == 1 and counts["k3"] == 32 and counts["k10"] == 32
        and counts["route_tf32x3"] == 32 and all(
            counts[k] == 0 for k in KERNELS if k not in ("k3", "k10")),
        "central_difference_within_1e-2": cd["rel_err"] <= 1e-2,
        "finite": finite, "peak_within_40_gib": peak <= 40.0}
    res["radio_v2_fp32_1024"] = {
        "batch": GRAD_RADIO_BATCH, "build_s": build_s, "grad_s": grad_s,
        "central_difference_s": cd_s, "wall_s": grad_s + cd_s, "peak_mem_gib": peak,
        "launches": counts, "launches_with_central_difference": counts_all,
        "grad_abs_max": grad.abs().max().item(), **cd, "checks": radio_ok}
    del radio, images, grad
    torch.cuda.empty_cache()

    # DINO ViT-B/16, bf16 against f32, 480x640, batch 8
    images = torch.randn(8, 480, 640, 3, device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(23))
    dino, grads, counts, walls, peaks = {}, {}, {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        bb = build_vit_extractor("dino_vitb16", return_multilayer=True, dtype=dtype,
                                 device="cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        x = images.clone().requires_grad_()
        (grads[dtype],) = torch.autograd.grad(sq_loss(bb(x)), x)
        torch.cuda.synchronize()
        walls[dtype] = time.perf_counter() - t0
        counts[dtype] = read_counts()
        peaks[dtype] = torch.cuda.max_memory_allocated() / 2**30
        del bb, x
        torch.cuda.empty_cache()
    g16, g32 = grads[torch.bfloat16].double(), grads[torch.float32].double()
    cosine = (g16 * g32).sum().item() / (g16.norm() * g32.norm()).item()
    dino_ok = {
        "launches_bf16": counts[torch.bfloat16]["forwards"] == 1
        and counts[torch.bfloat16]["k1"] == 12 and counts[torch.bfloat16]["route_wgmma"] == 12
        and all(counts[torch.bfloat16][k] == 0 for k in KERNELS if k != "k1"),
        "launches_fp32": counts[torch.float32]["k1"] == 12
        and counts[torch.float32]["route_tf32x3"] == 12,
        "finite": bool(torch.isfinite(g16).all()), "cosine_to_fp32_at_least_0.98": cosine >= 0.98}
    res["dino_vitb16_bf16"] = {
        "batch": 8, "wall_s": walls[torch.bfloat16], "wall_fp32_s": walls[torch.float32],
        "peak_mem_gib": peaks[torch.bfloat16], "peak_mem_fp32_gib": peaks[torch.float32],
        "launches": counts[torch.bfloat16], "launches_fp32": counts[torch.float32],
        "cosine_to_fp32": cosine, "checks": dino_ok}
    del images, grads, g16, g32
    torch.cuda.empty_cache()

    # the bench's splash attention (K9) and its backward (K11)
    from midvision_probe_torch import bench_attn

    (B, N, H, d), nv = BENCH_SHAPE, BENCH_N_VALID
    gen = torch.Generator(device="cuda").manual_seed(26)
    qkv = bench_inputs(torch, gen, "bench")
    g_out = torch.randn(B, N, H * d, device="cuda", generator=gen).to(torch.bfloat16)
    qkv.requires_grad_()
    reset_counts()
    t0 = time.perf_counter()
    (g,) = torch.autograd.grad(bench_attn.splash_attention(qkv, d**-0.5, nv), qkv, g_out)
    torch.cuda.synchronize()
    splash_wall = time.perf_counter() - t0
    splash_counts = read_counts()
    splash_ok = {
        "launches": splash_counts["k9"] == 1 and splash_counts["k11"] == 1
        and splash_counts["route_wgmma"] == 1
        and all(splash_counts[k] == 0 for k in KERNELS if k not in ("k9", "k11")),
        "finite": bool(torch.isfinite(g).all()), "padded_keys_zero": not g[:, nv:, 1:].any().item()}
    res["bench_splash_bf16"] = {"shape": [B, N, H, d], "n_valid": nv, "wall_s": splash_wall,
                                "launches": splash_counts, "checks": splash_ok}
    del qkv, g_out, g
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True  # the later phases run with torch's defaults
    res["gpu_state"] = gpu_state()
    emit(res)
    checks = {**{f"radio_{k}": v for k, v in radio_ok.items()},
              **{f"dino_{k}": v for k, v in dino_ok.items()},
              **{f"splash_{k}": v for k, v in splash_ok.items()}}
    if not all(checks.values()):
        raise SystemExit(f"grad_paths check failed: {checks}")
    return {"grad_radio_v2_fp32_1024": counts_all, "grad_dino_vitb16_bf16":
            counts[torch.bfloat16], "grad_dino_vitb16_fp32": counts[torch.float32],
            "grad_bench_splash": splash_counts}


def vit_taps(grid, width) -> list:
    """The four (h, w, C) tap shapes of a ViT forward."""
    return [(*grid, width)] * 4


def phase_forward(torch, smi: str, model, batch, hw, dtype, per_forward, tap_shapes,
                  iters=10, build=None):
    """The frozen forward of ``model`` (4 taps; ``build`` makes its
    extractor, default ``zoo.build_vit_extractor``) on a batch made on the card:
    images per second per card (CUDA events), peak memory, a profiler
    breakdown of one forward by kernel, the taps against ``tap_shapes``,
    and the launch counts (``per_forward`` per forward, counted over every
    forward of the phase). Returns the launch counts."""
    from midvision_probe_torch.models.zoo import build_vit_extractor

    t0 = time.perf_counter()
    if build is None:
        backbone = build_vit_extractor(model, return_multilayer=True, dtype=dtype,
                                       device="cuda")
    else:
        backbone = build(dtype)
    build_s = time.perf_counter() - t0
    images = torch.randn(batch, *hw, 3, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ms = cuda_ms(torch, lambda: backbone.features(images), iters=iters, warmup=2)
    feats = backbone.features(images)
    shapes_ok = [tuple(f.shape) for f in feats] == [(batch, *t) for t in tap_shapes] and all(
        bool(torch.isfinite(f).all()) for f in feats)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        backbone.features(images)
        torch.cuda.synchronize()
    counts = read_counts()
    # device-side events only (the kernels): the aten ops that launch them
    # report the same time again
    by_kernel = sorted(
        ((e.key, e.device_time_total / 1e3) for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA), key=lambda kv: -kv[1])
    device_ms = sum(t for _, t in by_kernel)
    READINGS["forward"].setdefault(model, batch / (ms / 1e3))
    emit({"phase": "forward", "model": model, "batch": batch, "image_hw": hw,
          "dtype": str(dtype), "taps": backbone.multilayers, "build_s": build_s,
          "forward_ms": ms, "imgs_per_s_per_card": batch / (ms / 1e3),
          "feature_shapes_ok": shapes_ok, "launches": counts,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "profile_device_ms": device_ms,
          "profile_top": [[k[:80], t] for k, t in by_kernel[:8]],
          "nvidia_smi": smi, "gpu_state": gpu_state()})
    if not shapes_ok or not per_forward_ok(counts, per_forward):
        raise SystemExit(f"forward check failed for {model}: shapes {shapes_ok}, "
                         f"launches {counts}")
    del backbone, images, feats
    torch.cuda.empty_cache()
    return counts


def case_numbers(case) -> dict:
    """A timed check's error and times, under the ``kernels`` line's keys
    (and the bound's term and its value without the exp2 term, where the
    check has them)."""
    extra = {k: case[k] for k in ("bound_term", "bound_without_exp2_ms") if k in case}
    return {"max_abs_err": case["max_abs_err"], "ms": case["kernel_ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"], **extra}


def kernel_entry(name, source, replaces, kernel, by_path, case, design,
                 route="cuda", **extra) -> dict:
    """One entry of the closing ``kernels`` line: its launches on every
    path and its numbers at the main path's shape (``case``). ``replaces``:
    the TPU kernel's file:line in the repository; ``design``: the kernel
    that ran ``case`` (for the attention kernels, the route); ``extra``:
    more keys (K6: its design by dtype and its f32 numbers)."""
    launches = {path: counts[kernel] for path, counts in by_path.items()}
    return {"name": name, "route": route, "source": f"midvision_probe_torch/csrc/{source}",
            "replaces": replaces, "design": design, "launches": sum(launches.values()),
            "launches_by_path": launches, **case_numbers(case), **extra}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "midvision_probe_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(midvision_probe_torch/ not found next to this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from midvision_probe_torch.ops import cuda_build

    t_start = time.perf_counter()
    smi = nvidia_smi()
    card = read_card(torch)
    t0 = time.perf_counter()
    cuda_build.build_all()
    ptxas = [ln.strip() for info in cuda_build.BUILD_INFO.values()
             for ln in info["log"].splitlines() if "registers" in ln]
    emit({"phase": "device", "nvidia_smi": smi, "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "device_name": torch.cuda.get_device_name(0),
          # the Taskonomy reader's HF directories need `datasets` (and pyarrow)
          "packages": {m: importlib.util.find_spec(m) is not None
                       for m in ("datasets", "pyarrow", "scipy", "PIL", "matplotlib")},
          "sources": list(cuda_build.KERNEL_SOURCES),
          "build_s": time.perf_counter() - t0, "ptxas": ptxas, "gpu_state": gpu_state()})

    checks = phase_kernel_checks(torch)
    knn2_checks = phase_knn2_checks(torch)
    attn_checks = phase_attention_checks(torch)
    rope_checks = phase_rope_checks(torch)
    variant_checks = phase_variant_checks(torch)
    mlp_checks = phase_mlp_checks(torch)
    by_path = {"path": phase_path(torch, "path", "dino_b16", DINO_PER_FORWARD)}
    torch.cuda.empty_cache()
    from midvision_probe_torch import evaluate_navi_correspondence, render_scannet_correspondence

    common = ["num_corr=1000", "scale_factor=0.25", "batch_pairs=4",
              "+system.backbone_dtype=bfloat16"]
    navi = ["dataset=synthetic_navi_hard", "dataset.image_size=512"]
    navi_k4_ms = knn2_checks["navi_main_masked"]["kernel_ms"]
    by_path["path_navi"] = phase_correspondence(
        torch, "path_navi", evaluate_navi_correspondence,
        ["backbone=dino_b16"] + common + navi, 8, 4, navi_k4_ms, DINO_PER_FORWARD)
    by_path["path_scannet"] = phase_correspondence(
        torch, "path_scannet", render_scannet_correspondence,
        ["backbone=dino_b16"] + common + ["dataset=synthetic_scannet_hard",
                                          "dataset.image_hw=[480,640]", "+render_every=0"],
        8, 4, knn2_checks["scannet_main"]["kernel_ms"], DINO_PER_FORWARD)
    by_path["path_navi_crocov2"] = phase_correspondence(
        torch, "path_navi_crocov2", evaluate_navi_correspondence,
        ["backbone=crocov2_b16"] + common + navi, 8, 4, navi_k4_ms, CROCOV2_PER_FORWARD)
    torch.cuda.empty_cache()
    by_path["path_depth_radio"] = phase_path(torch, "path_depth_radio", "radio",
                                             RADIO_PER_FORWARD)
    torch.cuda.empty_cache()
    by_path["path_snorm_nyu"] = phase_path_snorm_nyu(torch, smi)
    torch.cuda.empty_cache()
    by_path["path_objectness_voc"] = phase_path_objectness_voc(torch, smi)
    torch.cuda.empty_cache()
    by_path["path_2afc_nights"] = phase_path_2afc_nights(torch, smi)
    torch.cuda.empty_cache()
    by_path["path_spair"] = phase_path_spair(torch, smi)
    torch.cuda.empty_cache()
    by_path["path_taskonomy"] = phase_path_taskonomy(torch, smi)
    torch.cuda.empty_cache()
    by_path["path_depth_resnet50"] = phase_path_depth_resnet50(torch, smi)
    torch.cuda.empty_cache()
    by_path["path_depth_dinov2_reg"] = phase_path(
        torch, "path_depth_dinov2_reg", "dinov2_b14_reg", DINO_PER_FORWARD, render=True)
    torch.cuda.empty_cache()
    by_path["path_render_navi"] = phase_path_render_navi(torch, smi)
    torch.cuda.empty_cache()
    # path_scannet's run with the pair renders of every 4th pair (0 and 4)
    by_path["path_scannet_render"] = phase_correspondence(
        torch, "path_scannet_render", render_scannet_correspondence,
        ["backbone=dino_b16"] + common + ["dataset=synthetic_scannet_hard",
                                          "dataset.image_hw=[480,640]", "+render_every=4"],
        8, 4, knn2_checks["scannet_main"]["kernel_ms"], DINO_PER_FORWARD,
        artifacts=scannet_render_artifacts(8, 4), profile=False)
    torch.cuda.empty_cache()

    bf16 = torch.bfloat16
    by_path["forward_dino_vitb16"] = phase_forward(
        torch, smi, "dino_vitb16", 64, (480, 640), bf16, DINO_PER_FORWARD,
        vit_taps((30, 40), 768))
    by_path["forward_dino_vitb8"] = phase_forward(
        torch, smi, "dino_vitb8", 64, (480, 640), bf16, DINO_PER_FORWARD,
        vit_taps((60, 80), 768))
    # patch 14 leaves 4 rows and 10 columns of pixels, which the patch conv
    # drops (the top-left is kept)
    by_path["forward_clip_vitl14"] = phase_forward(
        torch, smi, "clip_vitl14", 64, (480, 640), bf16, CLIP_L_PER_FORWARD,
        vit_taps((34, 45), 1024))
    by_path["forward_crocov2_vitb16"] = phase_forward(
        torch, smi, "crocov2_vitb16", 64, (224, 224), bf16, CROCOV2_PER_FORWARD,
        vit_taps((14, 14), 768))
    by_path["forward_radio_v2"] = phase_forward(
        torch, smi, "radio_v2", 64, (480, 640), bf16, RADIO_PER_FORWARD,
        vit_taps((30, 40), 1280))
    # f32 at 1024x1024: K+V of 4097 tokens at d=80 exceed 2 MB, the JAX
    # package's split to its flash kernel (K3)
    by_path["forward_radio_v2_fp32_1024"] = phase_forward(
        torch, smi, "radio_v2", 2, (1024, 1024), torch.float32,
        {"k1": 0, "k2": 0, "k3": 32, "k5": 0, **NO_BENCH_KERNELS, **on_route("tf32x3", 32)},
        vit_taps((64, 64), 1280), iters=3)
    # the LayerScale, register and relative-position-bias ViTs and ResNet-50
    by_path["forward_dinov2_vitb14_reg"] = phase_forward(
        torch, smi, "dinov2_vitb14_reg", 64, (480, 640), bf16, DINO_PER_FORWARD,
        vit_taps((34, 45), 768))
    by_path["forward_dinov2_vitl14"] = phase_forward(
        torch, smi, "dinov2_vitl14", 64, (480, 640), bf16, CLIP_L_PER_FORWARD,
        vit_taps((34, 45), 1024))
    by_path["forward_deit3_vitb16"] = phase_forward(
        torch, smi, "deit3_vitb16", 64, (384, 384), bf16, DINO_PER_FORWARD,
        vit_taps((24, 24), 768))
    by_path["forward_beitv2_vitb16"] = phase_forward(
        torch, smi, "beitv2_vitb16", 64, (224, 224), bf16, NO_KERNEL_PER_FORWARD,
        vit_taps((14, 14), 768))
    by_path["forward_midas_l16"] = phase_forward(
        torch, smi, "midas_l16", 64, (384, 384), bf16, NO_KERNEL_PER_FORWARD,
        vit_taps((24, 24), 1024))
    from midvision_probe_torch.models.zoo import SIMCLR

    by_path["forward_resnet50"] = phase_forward(
        torch, smi, "simclr_resnet50", 64, (480, 640), bf16, NO_KERNEL_PER_FORWARD,
        [(120, 160, 256), (60, 80, 512), (30, 40, 1024), (15, 20, 2048)],
        build=lambda dtype: SIMCLR(return_layers=[1, 2, 3, 4], return_multilayer=True,
                                   dtype=dtype, device="cuda"))
    # SAM's windowed and global attention and ConvNeXt's convolutions are
    # einsum, softmax and library convolutions, as in the JAX package: no
    # hand-written kernel
    from midvision_probe_torch.models.zoo import SAM, ConvNext

    sam_b = lambda dtype: SAM(arch="vit_b", return_multilayer=True, dtype=dtype,  # noqa: E731
                              device="cuda")
    by_path["forward_sam_vitb"] = phase_forward(
        torch, smi, "sam_vit_b", 64, (480, 640), bf16, NO_KERNEL_PER_FORWARD,
        vit_taps((30, 40), 768), build=sam_b)
    by_path["forward_sam_vitl"] = phase_forward(
        torch, smi, "sam_vit_l", 64, (480, 640), bf16, NO_KERNEL_PER_FORWARD,
        vit_taps((30, 40), 1024), iters=5,
        build=lambda dtype: SAM(arch="vit_l", return_multilayer=True, dtype=dtype,
                                device="cuda"))
    # SAM's native 1024x1024: N = 4096 in the global blocks, no table resize
    by_path["forward_sam_vitb_1024"] = phase_forward(
        torch, smi, "sam_vit_b", 8, (1024, 1024), bf16, NO_KERNEL_PER_FORWARD,
        vit_taps((64, 64), 768), build=sam_b)
    convnext_taps = [(30, 40, d) for d in CONVNEXT_DIMS]
    by_path["forward_convnext_in22k"] = phase_forward(
        torch, smi, "cnxt_b_in22k", 64, (480, 640), bf16, NO_KERNEL_PER_FORWARD,
        convnext_taps, build=lambda dtype: ConvNext(checkpoint="in22k", return_multilayer=True,
                                                    dtype=dtype, device="cuda"))
    by_path["forward_convnext_fcmae"] = phase_forward(
        torch, smi, "cnxt_b_fcmae", 64, (480, 640), bf16, NO_KERNEL_PER_FORWARD,
        convnext_taps, build=lambda dtype: ConvNext(
            checkpoint="fcmae_ft_in22k_in1k_384", return_multilayer=True, dtype=dtype,
            device="cuda"))
    by_path["path_depth_sam"] = phase_path_depth_loaded(
        torch, smi, "path_depth_sam", "sam_base", "sam_vit_b", sam_vitb_container,
        sam_file_name, vit_taps((30, 40), 768), (0.485, 0.456, 0.406))
    torch.cuda.empty_cache()
    by_path["path_depth_convnext_laion"] = phase_path_depth_loaded(
        torch, smi, "path_depth_convnext_laion", "clip_convnext", "cnxt_b_w_laion2b",
        convnext_laion_container, convnext_file_name, convnext_taps,
        (0.48145466, 0.4578275, 0.40821073))
    torch.cuda.empty_cache()
    by_path["path_maskcut_voc"] = phase_path_maskcut_voc(torch, smi)
    torch.cuda.empty_cache()
    by_path["forward_dift"] = phase_forward_dift(torch, smi)
    by_path["forward_zero123"] = phase_forward_zero123(torch, smi,
                                                       attn_checks["zero123_clip_k1_fp32"])
    by_path["path_depth_cached"] = phase_path_depth_cached(torch, smi)
    by_path["path_depth_ddp"] = phase_path_depth_ddp(torch, smi)
    by_path["profiling"] = phase_profiling(torch, smi)
    by_path.update(phase_path_suite(torch, smi))
    by_path["instance_masks"] = phase_instance_masks(torch, smi)
    torch.cuda.empty_cache()
    by_path["checkpoint_drill"] = phase_checkpoint_drill(torch, smi)
    torch.cuda.empty_cache()
    # the matrix right after suite_timing: its step rows are held to that
    # phase's, and a host-bound extraction drifts with the host over minutes
    for phase in (phase_suite_timing, phase_bench_matrix, phase_preset_ab, phase_shuffle_ab):
        t0 = time.perf_counter()
        by_path[phase.__name__[len("phase_"):]] = phase(torch, smi)
        emit({"phase_wall": phase.__name__[len("phase_"):], "wall_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    by_path.update(phase_graft_entry(torch, smi))
    emit({"phase_wall": "graft_entry", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    by_path["bench"] = phase_bench(torch, smi)
    emit({"phase_wall": "bench", "wall_s": time.perf_counter() - t0})
    by_path["extract_kqv"] = phase_extract_kqv(torch)
    by_path["bench_attn"] = phase_bench_attn(torch)
    by_path["path_fused_mlp"] = phase_path_fused_mlp(torch)
    t0 = time.perf_counter()
    backward_checks = phase_backward_checks(torch)
    emit({"phase_wall": "backward_checks", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    by_path.update(phase_grad_paths(torch, smi))
    emit({"phase_wall": "grad_paths", "wall_s": time.perf_counter() - t0})
    emit({"phase": "done", "total_s": time.perf_counter() - t_start, "gpu_state": gpu_state()})

    from midvision_probe_torch.config.core import JAX_PACKAGE

    ops = f"{JAX_PACKAGE}/ops"  # the TPU kernels of the JAX package
    emit({"kernels": [
        kernel_entry("fused_qkv_attention", "vit_attention.cu", f"{ops}/vit_attention.py:85",
                     "k1", by_path, checks["main_bf16"], checks["main_bf16"]["route_ran"],
                     plain_vit_shapes={case: {**case_numbers(attn_checks[case]),
                                              "shape": attn_checks[case]["shape"],
                                              "route": attn_checks[case]["route_ran"]}
                                       for case in ("dino_vitb8_k1_bf16", "clip_vitl14_k1_bf16",
                                                    "objectness_dino_k1_bf16",
                                                    "twoafc_clip_k1_fp32", "spair_dino_k1_fp32",
                                                    "taskonomy_dino_k1_bf16",
                                                    "dinov2_reg_k1_bf16", "deit3_k1_bf16",
                                                    "maskcut_dino_k1_fp32",
                                                    "zero123_clip_k1_fp32",
                                                    "suite_timing_k1_bf16",
                                                    "dryrun_rank_k1_fp32")}),
        kernel_entry("knn2", "knn2.cu", f"{ops}/matching.py:64", "k4", by_path,
                     knn2_checks["scannet_main"], "wgmma",
                     navi_render_shape={**case_numbers(knn2_checks["navi_render_masked"]),
                                        "shape": [1, 16384, 16384, 768]}),
        kernel_entry("vit_attention", "vit_attention.cu", f"{ops}/vit_attention.py:129",
                     "k2", by_path, attn_checks["radio_main_bf16"],
                     attn_checks["radio_main_bf16"]["route_ran"]),
        kernel_entry("flash_attention", "vit_attention.cu", f"{ops}/attention.py:38",
                     "k3", by_path, attn_checks["k3_radio1024_fp32"],
                     attn_checks["k3_radio1024_fp32"]["route_ran"]),
        kernel_entry("rope_2d", "rope2d.cu", f"{ops}/rope2d.py:59", "k5", by_path,
                     rope_checks["crocov2_q_bf16"], "simt"),
        kernel_entry("fused_mlp", "fused_mlp.cu", f"{ops}/fused_mlp.py:63", "k6", by_path,
                     mlp_checks["dino_bf16"], "wgmma",
                     designs={"bfloat16": "wgmma", "float32": "bf16x6"},
                     float32={**case_numbers(mlp_checks["dino_fp32"]),
                              "bound_simt_ms": mlp_checks["dino_fp32"]["bound_simt_ms"],
                              "plain_err_vs_exact": mlp_checks["dino_fp32"]["plain_err_vs_exact"]}),
        kernel_entry("wide_attention", "bench_attn.cu", "launch_script/bench_attn.py:52",
                     "k7", by_path, variant_checks["wide4"],
                     variant_checks["wide4"]["route_ran"]),
        kernel_entry("int8_attention", "vit_attention.cu", "launch_script/bench_attn.py:133",
                     "k8", by_path, variant_checks["int8"], variant_checks["int8"]["route_ran"],
                     prologue_kernels=["amax_qk", "quantize_qk"],
                     prologue_source="midvision_probe_torch/csrc/bench_attn.cu",
                     mma_sync_source="midvision_probe_torch/csrc/bench_attn.cu",
                     **{k: variant_checks["int8"][k] for k in (
                         "prologue_ms", "prologue_bound_ms", "with_prologue_ms",
                         "with_prologue_bound_ms")}),
        kernel_entry("quantize_qk_heads", "bench_attn.cu", "launch_script/bench_attn.py:177",
                     "k8p", by_path, variant_checks["int8_prologue_bench"], "simt",
                     kernels=["amax_qk", "quantize_qk"]),
        kernel_entry("splash_attention", "vit_attention.cu", "launch_script/bench_attn.py:225",
                     "k9", by_path, variant_checks["splash"],
                     variant_checks["splash"]["route_ran"]),
        # the backwards: the jax library's Pallas dkv and dq kernels that
        # jax.grad runs through K3 and K9 (flash_attention.py pallas_call
        # :1121 and :1456; splash_attention_kernel.py :1857 and :1405)
        kernel_entry("flash_attention_backward", "attention_bwd.cu",
                     f"{ops}/attention.py:82", "k10", by_path,
                     backward_checks["k10_radio1024_fp32"],
                     backward_checks["k10_radio1024_fp32"]["design"],
                     library_kernels=["flash_attention.py:1121 _flash_attention_dkv_kernel",
                                      "flash_attention.py:1456 _flash_attention_dq_kernel"],
                     bf16={**case_numbers(backward_checks["k10_long_bf16"]),
                           "shape": backward_checks["k10_long_bf16"]["shape"],
                           "design": backward_checks["k10_long_bf16"]["design"]}),
        kernel_entry("splash_attention_backward", "attention_bwd.cu",
                     "launch_script/bench_attn.py:243", "k11", by_path,
                     backward_checks["k11_bench_bf16"],
                     backward_checks["k11_bench_bf16"]["design"],
                     library_kernels=[
                         "splash_attention_kernel.py:1857 _splash_attention_bwd_dkv",
                         "splash_attention_kernel.py:1405 _splash_attention_bwd_dq"]),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddp-worker"]:
        sys.exit(ddp_worker(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--counted"]:
        sys.exit(counted_run(*sys.argv[2:]))
    sys.exit(main())

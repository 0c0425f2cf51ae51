"""Batch instance-mask extraction (counterpart of the repository's
``data_processing/extract_instance_masks.py``; the scripted replacement for
the reference's PointRend notebook,
``data_processing/PointRend_preprocess/pointrend_pipeline.ipynb``).

Per image under ``--images`` (recursive): MaskCut over a frozen zoo
backbone (``models/maskcut.py``: the backbone on the card, the spectral
steps and the DenseCRF built from ``native/densecrf/`` on the host), then
one npz per image with ``masks`` (N, H, W) bool, ``bboxes``, ``combined``
and ``source_image``, and an ``index.csv`` over all of them: the JAX
tool's artifacts. The CRF never falls back to an approximation; an image
that fails is reported and counted, and the run fails when no image
succeeded.

Usage::

    python -m midvision_probe_torch.data_processing.extract_instance_masks \\
        --images data/taskonomy/rgb --out data/taskonomy/instance_masks \\
        --backbone dino_vitb16 --num-masks 3 [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import glob
import os

import numpy as np

IMG_EXTS = (".png", ".jpg", ".jpeg")


def iter_images(root: str):
    for path in sorted(glob.glob(os.path.join(root, "**", "*"), recursive=True)):
        if path.lower().endswith(IMG_EXTS):
            yield path


def build_processor(backbone_name: str, tau: float, fixed_size: int, device=None):
    """MaskCut over the port's dense extractor for zoo entry
    ``backbone_name`` (float32) on ``device`` (default: the card)."""
    from midvision_probe_torch.models import zoo
    from midvision_probe_torch.models.maskcut import MaskCutProcessor

    if zoo.ZOO[backbone_name].arch == "resnet":
        backbone = zoo.build_resnet_extractor(backbone_name, output="dense", device=device)
    else:
        backbone = zoo.build_vit_extractor(backbone_name, output="dense", device=device)
    return MaskCutProcessor(backbone=backbone, patch_size=backbone.patch_size or 16,
                            tau=tau, fixed_size=fixed_size)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", required=True, help="image dir (recursive)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--backbone", default="dino_vitb16")
    ap.add_argument("--num-masks", type=int, default=3,
                    help="pseudo-masks per image (notebook kept all "
                         "detections >= 0.5 score)")
    ap.add_argument("--tau", type=float, default=0.15)
    ap.add_argument("--fixed-size", type=int, default=480)
    ap.add_argument("--limit", type=int, default=-1)
    ap.add_argument("--device", default=None,
                    help="device of the backbone (default: the card)")
    args = ap.parse_args(argv)

    processor = build_processor(args.backbone, args.tau, args.fixed_size, args.device)

    os.makedirs(args.out, exist_ok=True)
    index_rows, n_ok, n_err = [], 0, 0
    for i, path in enumerate(iter_images(args.images)):
        if 0 <= args.limit <= i:
            break
        stem = os.path.splitext(os.path.relpath(path, args.images))[0]
        stem = stem.replace(os.sep, "__")
        try:
            bboxes, masks, combined = processor.process_image(path, args.num_masks)
            masks = np.asarray(masks, np.uint8) >= 128  # 0/255 -> bool
            out_path = os.path.join(args.out, f"{stem}.npz")
            np.savez_compressed(
                out_path,
                masks=masks,
                bboxes=np.asarray(bboxes, np.float32),
                combined=np.asarray(combined, bool),
                source_image=path,
            )
            index_rows.append({
                "image": path, "npz": out_path,
                "num_masks": int(masks.shape[0]),
                "mask_area_px": int(masks.sum()),
            })
            n_ok += 1
            print(f"[mask] {stem}: {masks.shape[0]} instances")
        except Exception as e:  # noqa: BLE001 — per-image resilience, as the
            # evaluator's (evaluate_generic_objectness.py:37-62); counted
            n_err += 1
            print(f"[skip] {stem}: {type(e).__name__}: {e}")

    with open(os.path.join(args.out, "index.csv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["image", "npz", "num_masks",
                                          "mask_area_px"])
        w.writeheader()
        w.writerows(index_rows)
    print(f"extracted masks for {n_ok} images ({n_err} failed) -> {args.out}")
    return 0 if n_ok or not n_err else 1


if __name__ == "__main__":
    raise SystemExit(main())

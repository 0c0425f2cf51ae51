"""Golden activations for the converters (counterpart of the repository's
``data_processing/export_golden.py``).

For each checkpoint present under ``$MVP_CHECKPOINT_DIR``, ``export`` loads
the raw on-disk file, unwraps the trunk, runs it through an independent
torch forward on a fixed input (the full-size replicas of
``torch_replicas.py`` on the CPU in float32, or ``transformers``' SAM and
ViT models for the HF layouts) and saves the input and the taps as an npz.
``verify`` then runs the port's converted extractor (the zoo, on the card
unless ``--device`` says otherwise) on the stored input in float32, with
TF32 off in cuBLAS and cuDNN (torch's default lets cuDNN's convolutions
round their inputs to TF32), and compares each tap at ``atol`` (2e-3).

The HF-layout goldens (``sam_vit_b``, ``mae_vitb16``) need
``transformers``. Where it is not installed they are reported as having no
oracle on this host (``[golden-NO-ORACLE]``), neither failed nor skipped
silently.

Usage::

    python -m midvision_probe_torch.data_processing.export_golden export --out goldens/
    python -m midvision_probe_torch.data_processing.export_golden verify --goldens goldens/
"""

from __future__ import annotations

import argparse
import importlib.util
import os

import numpy as np

# families with a full-size independent torch forward.
# grid/size: golden forward resolution (grid*patch); taps: ViT-B multilayers.
VIT_GOLDENS = {
    "dino_vitb16": dict(kind="timm"),
    "ibot_vitb16": dict(kind="timm"),
    "eva_vitb16": dict(kind="timm"),
    "milan_vitb16": dict(kind="timm"),
    "mocov3_vitb16": dict(kind="timm"),
    "croco_vitb16": dict(kind="timm", class_token=False, sincos=True),
    "dinov2_vitb14": dict(kind="timm", size=518, grid=37,
                          replica=dict(patch=14, grid=37, layerscale=True,
                                       ls_naming="ls")),
    "deit3_vitb16": dict(kind="timm", size=384, grid=24,
                         replica=dict(grid=24, layerscale=True)),
    "siglip_vitb16": dict(kind="timm", size=384, grid=24,
                          class_token=False,
                          replica=dict(grid=24, class_token=False,
                                       act="gelu_tanh")),
    "beitv2_vitb16": dict(kind="beit"),
    "midas_l16": dict(kind="beit", size=384, grid=24,
                      taps=(5, 11, 17, 23), strip="pretrained.model.",
                      replica=dict(dim=1024, heads=16, depth=24)),
    "sam_vit_b": dict(kind="sam", size=1024, grid=64,
                      taps=(2, 5, 8, 11)),
    "cnxt_b_in22k": dict(kind="convnext", size=224,
                         taps=(0, 1, 2, 3)),
    "clip_vitb16": dict(kind="clip"),
    "mae_vitb16": dict(kind="hf"),
    "radio_v2": dict(kind="radio", size=256, grid=16,
                     taps=(7, 15, 23, 31)),
}
VIT_TAPS = (2, 5, 8, 11)  # default_vit_multilayers(12), dino.py:51-57


class NoOracle(Exception):
    """The golden's oracle cannot run on this host."""


def has_oracle(name: str, arch: str) -> bool:
    """Whether the drill verifies ``name`` against an independent forward
    (on a host with ``transformers`` for the HF layouts)."""
    return name in VIT_GOLDENS or arch == "resnet"


def _fixed_input(size: int) -> np.ndarray:
    rng = np.random.RandomState(1234)
    return rng.randn(1, 3, size, size).astype(np.float32)


def _tokens_to_dense(tokens: np.ndarray, n_prefix: int, grid: int) -> np.ndarray:
    """(B, n_prefix+g*g, C) tokens -> (B, C, g, g) dense map."""
    b, _, c = tokens.shape
    return (tokens[:, n_prefix:]
            .reshape(b, grid, grid, c).transpose(0, 3, 1, 2))


def _transformers():
    if importlib.util.find_spec("transformers") is None:
        raise NoOracle("its oracle needs transformers, which this host does not have")
    import transformers

    return transformers


def _torch_vit_taps(name, spec, trunk_sd, x):
    """Independent torch forward at the tapped blocks; returns dense maps."""
    import torch

    from midvision_probe_torch.data_processing.torch_replicas import (
        BEiT,
        CLIPVisual,
        RadioViT,
        TimmViT,
        TorchConvNeXt,
        sincos2d_pos_embed,
    )

    taps_idx = spec.get("taps", VIT_TAPS)
    grid = spec.get("grid", 14)

    if spec["kind"] == "beit":
        rep_kw = dict(dim=768, heads=12, depth=12)
        rep_kw.update(spec.get("replica", {}))
        t = BEiT(patch=16, img=16 * grid, mlp_ratio=4.0, **rep_kw).eval()
        strip = spec.get("strip", "")
        sub = {k[len(strip):]: v for k, v in trunk_sd.items()
               if k.startswith(strip)} if strip else trunk_sd
        t.load_state_dict(sub)
        with torch.no_grad():
            taps = t(torch.from_numpy(x))
        return [_tokens_to_dense(taps[i].numpy(), 1, grid) for i in taps_idx]

    if spec["kind"] == "sam":
        transformers = _transformers()
        hf_cfg = transformers.SamVisionConfig(
            hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
            image_size=1024, patch_size=16, window_size=14,
            global_attn_indexes=[2, 5, 8, 11], mlp_dim=3072,
        )
        hf = transformers.SamVisionModel(hf_cfg).eval()
        sub = {}
        for k, v in trunk_sd.items():
            if not k.startswith("image_encoder."):
                continue
            k = k.replace("image_encoder.", "vision_encoder.")
            k = k.replace("blocks.", "layers.")
            k = k.replace("norm1", "layer_norm1").replace(
                "norm2", "layer_norm2")
            k = k.replace("patch_embed.proj", "patch_embed.projection")
            sub[k] = v
        missing, _ = hf.load_state_dict(sub, strict=False)
        if not all("neck" in k for k in missing):
            raise ValueError(f"{name}: missing {missing}")
        with torch.no_grad():
            out = hf(torch.from_numpy(x), output_hidden_states=True)
        # SAM hidden states are already (B, H, W, C) maps
        return [out.hidden_states[i + 1].numpy().transpose(0, 3, 1, 2)
                for i in taps_idx]

    if spec["kind"] == "convnext":
        t = TorchConvNeXt(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)).eval()
        sub = {k.replace("stem.1", "stem_norm"): v
               for k, v in trunk_sd.items() if not k.startswith("head.")}
        t.load_state_dict(sub)
        with torch.no_grad():
            taps = t(torch.from_numpy(x))
        return [taps[i].numpy() for i in taps_idx]

    if spec["kind"] == "clip":
        t = CLIPVisual(d=768, heads=12, depth=12, patch=16, img=16 * grid).eval()
        sub = {k[len("visual."):]: v for k, v in trunk_sd.items()
               if k.startswith("visual.")}
        missing, unexpected = t.load_state_dict(sub, strict=False)
        if missing or not all(k.startswith(("ln_post.", "proj")) for k in unexpected):
            raise ValueError(f"{name}: missing {missing}, unexpected {unexpected}")
        with torch.no_grad():
            taps = t(torch.from_numpy(x))
        return [_tokens_to_dense(taps[i].numpy(), 1, grid) for i in taps_idx]

    if spec["kind"] == "radio":
        t = RadioViT(dim=1280, depth=32, heads=16, patch=16, grid=grid).eval()
        sub = {k[len("base_model.model."):]: v for k, v in trunk_sd.items()
               if k.startswith("base_model.model.")}
        t.load_state_dict(sub)
        with torch.no_grad():
            taps = t(torch.from_numpy(x))
        return [_tokens_to_dense(taps[i].numpy(), 1, grid) for i in taps_idx]

    if spec["kind"] == "hf":
        transformers = _transformers()
        cfg = transformers.ViTConfig(
            hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
            intermediate_size=3072, image_size=224, patch_size=16,
            layer_norm_eps=1e-12, hidden_act="gelu",
        )
        hf = transformers.ViTModel(cfg, add_pooling_layer=False).eval()
        # the 'vit.' prefix lives in the raw file (ViTMAEForPreTraining
        # layout); the zoo strips it converter-side via entry.prefix
        hf.load_state_dict({k[len("vit."):]: v for k, v in trunk_sd.items()
                            if k.startswith("vit.")})
        with torch.no_grad():
            out = hf(torch.from_numpy(x), output_hidden_states=True)
        return [_tokens_to_dense(out.hidden_states[i + 1].numpy(), 1, grid)
                for i in taps_idx]

    cls = spec.get("class_token", True)
    rep_kw = dict(dim=768, depth=12, heads=12, patch=16, grid=14,
                  class_token=cls)
    rep_kw.update(spec.get("replica", {}))
    t = TimmViT(**rep_kw).eval()
    missing, unexpected = t.load_state_dict(trunk_sd, strict=False)
    allowed_missing = {"pos_embed"} if spec.get("sincos") else set()
    if not set(missing) <= allowed_missing:
        raise ValueError(f"{name}: missing {missing}")
    if not all(k.startswith(("head.",)) for k in unexpected):
        raise ValueError(f"{name}: unexpected {unexpected}")
    if spec.get("sincos"):
        t.pos_embed.data = sincos2d_pos_embed(768, rep_kw["grid"], cls_row=cls)
    with torch.no_grad():
        taps = t(torch.from_numpy(x))
    return [_tokens_to_dense(taps[i].numpy(), 1 if cls else 0, grid)
            for i in taps_idx]


def export(out_dir: str) -> int:
    return export_detailed(out_dir)[0]


def export_detailed(out_dir: str):
    """Export goldens for every present checkpoint, each model on its own:
    one corrupt or mismatched file does not abort the drill. Returns
    ``(rc, failed_model_names, no_oracle_model_names)``; a model without an
    oracle on this host is not a failure."""
    import torch

    from midvision_probe_torch.data_processing.torch_replicas import TorchResNet50
    from midvision_probe_torch.models import zoo
    from midvision_probe_torch.models.convert.remap import unwrap_checkpoint

    os.makedirs(out_dir, exist_ok=True)
    n = 0
    failed: set[str] = set()
    no_oracle: set[str] = set()
    for name, entry in sorted(zoo.ZOO.items()):
        if name.startswith("test_"):
            continue
        if entry.arch != "resnet" and name not in VIT_GOLDENS:
            continue
        path = os.path.join(zoo.checkpoint_dir(), entry.filename)
        if not os.path.exists(path):
            continue
        try:
            sd = unwrap_checkpoint(
                torch.load(path, map_location="cpu", weights_only=False),
                entry.source,
            )
            x = _fixed_input(VIT_GOLDENS.get(name, {}).get("size", 224))
            if entry.arch == "resnet":
                t = TorchResNet50()
                t.load_state_dict(sd)
                t.eval()
                with torch.no_grad():
                    taps = [o.numpy() for o in t(torch.from_numpy(x))]
            else:
                taps = _torch_vit_taps(name, VIT_GOLDENS[name], sd, x)
            np.savez_compressed(
                os.path.join(out_dir, f"{name}.npz"),
                input=x, **{f"tap_{i}": o for i, o in enumerate(taps)},
            )
            print(f"[golden] {name}: {len(taps)} taps from {entry.filename}")
            n += 1
        except NoOracle as e:
            no_oracle.add(name)
            print(f"[golden-NO-ORACLE] {name}: {e}")
        except Exception as e:  # noqa: BLE001 — per-model report tool
            failed.add(name)
            print(f"[golden-FAIL] {name}: {type(e).__name__}: {e}")
    print(f"exported {n} goldens to {out_dir}"
          + (f" | {len(failed)} failed" if failed else "")
          + (f" | {len(no_oracle)} without an oracle on this host" if no_oracle else ""))
    return (1 if failed else 0), failed, no_oracle


def build_extractor(name: str, device=None, init_size: int | None = None):
    """The port's multilayer extractor for zoo entry ``name``, as the goldens
    tap it (ConvNeXt: the raw stage maps, before any resize)."""
    from midvision_probe_torch.models import zoo

    arch = zoo.ZOO[name].arch
    if arch == "resnet":
        return zoo.build_resnet_extractor(name, return_multilayer=True, device=device)
    if arch == "sam":
        return zoo.build_sam_extractor(name, return_multilayer=True, device=device)
    if arch == "convnext":
        return zoo.build_convnext_extractor(name, return_multilayer=True, output="raw",
                                            device=device)
    return zoo.build_vit_extractor(name, return_multilayer=True, init_size=init_size,
                                   device=device)


def verify(golden_dir: str, atol: float = 2e-3, device=None) -> int:
    return verify_detailed(golden_dir, atol, device)[0]


def verify_detailed(golden_dir: str, atol: float = 2e-3, device=None):
    """Compare the port's forward with every golden in ``golden_dir``.
    Returns ``(rc, failed_model_names, readings)``: ``readings`` maps each
    model to its taps' max abs errors, so the drill attributes failures per
    model."""
    import torch

    failures = []
    readings: dict[str, list[float]] = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    for f in sorted(os.listdir(golden_dir)):
        if not f.endswith(".npz"):
            continue
        name = f[:-4]
        data = np.load(os.path.join(golden_dir, f))
        m = build_extractor(name, device, init_size=data["input"].shape[-1])
        x = torch.from_numpy(data["input"].transpose(0, 2, 3, 1).copy())
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                outs = m(x.to(m.device))
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        readings[name] = []
        for i, out in enumerate(outs):
            ref = data[f"tap_{i}"]
            err = float(np.abs(out.float().cpu().numpy().transpose(0, 3, 1, 2) - ref).max())
            readings[name].append(err)
            status = "ok" if err <= atol else "FAIL"
            print(f"[{status}] {name} tap {i}: max err {err:.2e}")
            if err > atol:
                failures.append((name, i, err))
    if failures:
        print(f"{len(failures)} FAILURES")
    return (1 if failures else 0), {name for name, _, _ in failures}, readings


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["export", "verify"])
    ap.add_argument("--out", default="goldens")
    ap.add_argument("--goldens", default="goldens")
    ap.add_argument("--device", default=None,
                    help="device of the port's forward in verify (default: the card)")
    args = ap.parse_args(argv)
    if args.mode == "export":
        return export(args.out)
    return verify(args.goldens, device=args.device)


if __name__ == "__main__":
    raise SystemExit(main())

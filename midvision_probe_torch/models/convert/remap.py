"""Source-specific state_dict normalization (VISSL / MMSelfSup / MoCo / ...),
copy of the JAX package's ``models/convert/remap.py``.

Each checkpoint source wraps the trunk weights differently; the reference
undoes this per-wrapper (``evals/models/util.py:106-120`` plus wrapper-local
tables). Collected here as data:

* ``prepare_state_dict`` — prefix strip + head deletion
  (``util.py:106-120``),
* ``MMSELFSUP_VIT_RENAME`` — mmselfsup ViT naming → timm naming, used by
  EVA and PixMIM (``eva.py:15-24``, same dict in ``pixmlm.py``),
* ``unwrap_checkpoint`` — digs the trunk out of known container layouts
  (VISSL classy_state_dict ``simclr.py:17-24``, torch ``state_dict``
  containers, MoCo encoder_q / base_encoder prefixes).
"""

from __future__ import annotations

from typing import Any, Mapping

MMSELFSUP_VIT_RENAME = {
    "layers.": "blocks.",
    "patch_embed.projection": "patch_embed.proj",
    ".ln1": ".norm1",
    ".ln2": ".norm2",
    "ln1.weight": "norm.weight",
    "ln1.bias": "norm.bias",
    "ffn.blocks.0.0.": "mlp.fc1.",
    "ffn.blocks.1.": "mlp.fc2.",
}


def prepare_state_dict(
    state_dict: dict,
    remove_prefix: str | None = None,
    delete_prefixes=("head.", "fc."),
    rename: Mapping[str, str] | None = None,
) -> dict:
    out = dict(state_dict)
    if remove_prefix:
        for k in list(out.keys()):
            if k.startswith(remove_prefix):
                out[k[len(remove_prefix):]] = out.pop(k)
            else:
                out.pop(k, None)
    if delete_prefixes:
        for k in list(out.keys()):
            if any(k.startswith(p) for p in delete_prefixes):
                del out[k]
    if rename:
        renamed = {}
        for k, v in out.items():
            nk = k
            for old, new in rename.items():
                nk = nk.replace(old, new)
            renamed[nk] = v
        out = renamed
    return out


def unwrap_checkpoint(ckpt: Any, source: str) -> dict:
    """Extract the trunk state_dict from a raw ``torch.load`` result.

    ``source`` names the packaging convention:
      vissl        — ``classy_state_dict.base_model.model.trunk`` with
                     ``_feature_blocks.`` prefix (``simclr.py:17-24``)
      mocov2       — ``state_dict`` with ``module.encoder_q.`` prefix
      mocov3       — ``state_dict`` with ``module.base_encoder.`` or
                     ``module.momentum_encoder.`` prefix
      mmselfsup    — ``state_dict`` with ``backbone.`` prefix + ViT rename
      state_dict   — plain ``{"state_dict": trunk}`` container
      raw          — already a flat trunk state_dict
    """
    if source == "raw":
        return dict(ckpt)
    if source == "state_dict":
        # covers the common single-key containers: iBOT/MILAN-style
        # {'state_dict': ...} and DeiT/BEiT-v2/MiDaS hub {'model': ...}
        # (deit_utils.py:511, beit_v2.py:83, milan.py:67, ibot.py:55);
        # iBOT teacher weights additionally carry 'module.' prefixes
        sd = ckpt
        for key in ("state_dict", "model"):
            if isinstance(sd, Mapping) and key in sd:
                sd = sd[key]
                break
        out = dict(sd)
        if any(k.startswith("module.") for k in out):
            out = {k[len("module."):] if k.startswith("module.") else k: v
                   for k, v in out.items()}
        return out
    if source == "vissl":
        trunk = ckpt["classy_state_dict"]["base_model"]["model"]["trunk"]
        return prepare_state_dict(
            trunk,
            remove_prefix="_feature_blocks.",
            delete_prefixes=("projection_head.", "prototypes."),
        )
    if source == "mocov2":
        return prepare_state_dict(
            ckpt["state_dict"], remove_prefix="module.encoder_q."
        )
    if source == "mocov3":
        sd = ckpt["state_dict"]
        out = prepare_state_dict(
            sd, remove_prefix="module.base_encoder.",
            delete_prefixes=("module.predictor.", "head."),
        )
        if not out:
            out = prepare_state_dict(sd, remove_prefix="module.momentum_encoder.")
        return out
    if source == "mmselfsup":
        sd = ckpt.get("state_dict", ckpt)
        return prepare_state_dict(
            sd, remove_prefix="backbone.", rename=MMSELFSUP_VIT_RENAME
        )
    if source == "croco":
        # NAVER CroCo ckpt: {'model': {enc_blocks.N..., patch_embed.proj,
        # enc_norm, dec_*...}} — keep the encoder in timm naming
        sd = ckpt.get("model", ckpt.get("state_dict", ckpt))
        return prepare_state_dict(
            sd,
            delete_prefixes=("dec_", "decoder_embed", "prediction_head",
                             "mask_token", "head."),
            rename={"enc_blocks.": "blocks.", "enc_norm.": "norm."},
        )
    if source == "openclip":
        return dict(ckpt.get("state_dict", ckpt))
    raise ValueError(f"unknown checkpoint source {source!r}")

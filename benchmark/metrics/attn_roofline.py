"""attn_roofline (%): the attention's share of its roofline. The least
time of each call, max(4 B H N^2 d FLOP at the bf16 peak, q, k and v read
once and the output written once at the HBM peak), summed over the
window's calls (steps x blocks run), over the device time of the kernels
that ``PATTERN`` matches: kernel K1's routes (``csrc/vit_attention.cu``:
``attention_wgmma``, ``attention_bf16``, ``attention_tf32x3`` with its
``split_pairs`` pre-pass) and PyTorch's fused attention kernels, so that a
change of route still reads. On a card without published peaks it reads
nothing; where no kernel of the window matches, it raises, so that the
traced run fails rather than the metric going silent."""

import re

PATTERN = re.compile(r"attention_(wgmma|bf16|tf32x3)|split_pairs|flash|fmha|"
                     r"efficient_attention|cudnn.*attention", re.I)
EXCLUDE = re.compile(r"bwd|backward", re.I)
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(cfg: dict, batch: int, peak_flops: float, peak_bytes: float) -> float:
    """The least time of one attention call of ``cfg`` on ``batch`` images."""
    gh, gw = (s // cfg["patch_size"] for s in cfg["image_hw"])
    n, h = 1 + gh * gw, cfg["num_heads"]
    d = cfg["width"] // h
    flops = 4.0 * batch * h * n * n * d
    moved = 4.0 * batch * n * h * d * ELEMENT_BYTES[cfg["dtype"]]
    return max(flops / peak_flops, moved / peak_bytes)


def read(ctx):
    flops, hbm = ctx.peak("bf16_flops"), ctx.peak("hbm_bytes")
    if flops is None or hbm is None:
        return None
    busy = ctx.trace.device_ns(PATTERN, EXCLUDE) / 1e9
    if busy <= 0:  # the cell runs its attentions: a kernel under a name PATTERN misses
        raise LookupError("attn_roofline: no device kernel matches " + PATTERN.pattern)
    calls = ctx.steps * (max(ctx.cfg["taps"]) + 1)
    return 100.0 * calls * bound_s(ctx.cfg, ctx.mix["batch"], flops, hbm) / busy

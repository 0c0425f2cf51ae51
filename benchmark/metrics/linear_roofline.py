"""linear_roofline (%): the backbone's linears' share of their roofline.
Each block's qkv, proj, fc1 and fc2 take 24 N D^2 FLOP an image at an MLP
ratio of 4 (2 (3 + 1 + 2 r) N D^2); the least time per block is the larger
of those FLOP at the bf16 peak and their weights read once plus their
inputs read and outputs written once at the HBM peak. Summed over the
window's blocks, over the device time of the GEMM kernels that ``PATTERN``
matches (cuBLAS's and CUTLASS's; convolutions and attention excluded).
On a card without published peaks it reads nothing; where no kernel of
the window matches, it raises."""

import re

PATTERN = re.compile(r"gemm|nvjet|cutlass|xmma|s16816|s1688", re.I)
EXCLUDE = re.compile(r"fprop|dgrad|wgrad|conv|attention|flash|fmha", re.I)
ELEMENT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def block_bound_s(cfg: dict, batch: int, peak_flops: float, peak_bytes: float) -> float:
    gh, gw = (s // cfg["patch_size"] for s in cfg["image_hw"])
    n, d, r = 1 + gh * gw, cfg["width"], cfg["mlp_ratio"]
    flops = 2.0 * (4 + 2 * r) * n * d * d * batch
    elems = (4 + 2 * r) * d * d + batch * n * d * (1 + 3 + 1 + 1 + 1 + r + r + 1)
    return max(flops / peak_flops, elems * ELEMENT_BYTES[cfg["dtype"]] / peak_bytes)


def read(ctx):
    flops, hbm = ctx.peak("bf16_flops"), ctx.peak("hbm_bytes")
    if flops is None or hbm is None:
        return None
    busy = ctx.trace.device_ns(PATTERN, EXCLUDE) / 1e9
    if busy <= 0:  # the cell runs its GEMMs: a kernel under a name PATTERN misses
        raise LookupError("linear_roofline: no device kernel matches " + PATTERN.pattern)
    blocks = ctx.steps * (max(ctx.cfg["taps"]) + 1)
    return 100.0 * blocks * block_bound_s(ctx.cfg, ctx.mix["batch"], flops, hbm) / busy

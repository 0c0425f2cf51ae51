"""Published peaks of the cards the benchmark reads rooflines against
(NVIDIA's data sheet, SXM part, dense rates without sparsity, at the full
700 W power limit), by the name ``torch.cuda.get_device_name()`` gives. A
card not in the table has no roofline: its metrics are left out."""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,  # also the peak every FLOP of ``mfu`` is held to
        "hbm_bytes": 3.35e12,  # bytes/s
    },
}


def peak(kind: str, name: str) -> float | None:
    """The card ``kind``'s peak ``name``, or None for a card not listed."""
    return PEAKS.get(kind, {}).get(name)

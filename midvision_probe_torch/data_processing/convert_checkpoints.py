"""Batch-verify and convert zoo checkpoints (counterpart of the repository's
``data_processing/convert_checkpoints.py``; replaces the reference's manual
per-model porting notebooks, ``evals/models/models_jupyter_notebook/``).

For every zoo entry whose checkpoint exists under ``$MVP_CHECKPOINT_DIR``,
build the port's extractor (which runs the converter), run a forward smoke
test on the card (or ``--device``) and report success or failure.

Usage::

    python -m midvision_probe_torch.data_processing.convert_checkpoints            # all present
    python -m midvision_probe_torch.data_processing.convert_checkpoints dino_vitb16 mae_vitb16
    python -m midvision_probe_torch.data_processing.convert_checkpoints --all      # landing drill

``--all`` is the weights-landing drill: scan ``$MVP_CHECKPOINT_DIR``
against the entire zoo, convert every file that is present, golden-verify
each converted model against its independent torch replica
(``export_golden.py``) where one exists, and print one
PRESENT/MISSING/OK/FAIL report in the JAX drill's format. A model whose
oracle cannot run on this host (the HF layouts without ``transformers``)
is reported ``OK-SMOKE`` with that reason.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def drill_rows(device=None) -> dict:
    """Scan + convert + golden-verify: ``rows`` (``(name, status, detail)``
    for every zoo entry), ``rc``, the golden step's ``rc_verify``, the
    models whose smoke failed and ``readings`` (each golden-verified
    model's taps' max abs errors)."""
    from midvision_probe_torch.data_processing import export_golden
    from midvision_probe_torch.models import zoo
    from midvision_probe_torch.utils.device import resolve_device

    device = resolve_device(device)  # no card and no device: raise once, here
    rows = []
    present = []
    for name, entry in sorted(zoo.ZOO.items()):
        if name.startswith("test_"):
            continue
        path = os.path.join(zoo.checkpoint_dir(), entry.filename)
        if os.path.exists(path):
            present.append(name)
        else:
            rows.append((name, "MISSING", entry.filename))

    rc_verify, smoke_failed, readings = 0, set(), {}
    if present:
        # convert + forward smoke every present file
        _, _, failed = _convert_smoke(present, device)
        smoke_failed = {n for n, _ in failed}
        # golden round trip for the families with an independent oracle;
        # an export failure counts as a golden failure of its model (one
        # corrupt file must not abort or mislabel the other rows)
        with tempfile.TemporaryDirectory() as td:
            rc_export, export_failed, no_oracle = export_golden.export_detailed(td)
            rc_verify, golden_failed, readings = export_golden.verify_detailed(
                td, device=device)
            golden_failed |= export_failed
            rc_verify = rc_verify or rc_export
        for name in present:
            oracle = export_golden.has_oracle(name, zoo.ZOO[name].arch)
            # status is attributed per model: one family's failure must not
            # mislabel the others (or mask its own smoke failure)
            if name in smoke_failed:
                rows.append((name, "FAIL", "conversion/forward smoke failed"))
            elif oracle and name in golden_failed:
                rows.append((name, "FAIL", "golden parity vs torch replica"))
            elif oracle and name in no_oracle:
                rows.append((name, "OK-SMOKE",
                             "converted + finite-forward smoke (torch oracle needs "
                             "transformers, not installed on this host)"))
            elif oracle:
                rows.append((name, "OK",
                             "converted + golden-verified vs torch replica"))
            else:
                rows.append((name, "OK-SMOKE",
                             "converted + finite-forward smoke "
                             "(no torch oracle)"))
    rc = 0 if (rc_verify == 0 and not smoke_failed) else 1
    return {"rc": rc, "rows": rows, "rc_verify": rc_verify, "smoke_failed": smoke_failed,
            "readings": readings, "present": present}


def drill(device=None) -> int:
    """Scan + convert + golden-verify + report (one command)."""
    from midvision_probe_torch.models import zoo

    res = drill_rows(device)
    rows = res["rows"]
    print("\n=== weights-landing drill report "
          f"($MVP_CHECKPOINT_DIR={zoo.checkpoint_dir()}) ===")
    for name, status, detail in sorted(rows):
        print(f"{name:28s} {status:10s} {detail}")
    n_missing = sum(1 for _, s, _ in rows if s == "MISSING")
    n_fail = sum(1 for _, s, _ in rows if s == "FAIL")
    print(f"\npresent {len(res['present'])} | missing {n_missing} | "
          f"failed {n_fail} | golden rc={res['rc_verify']} | "
          f"smoke ok={not res['smoke_failed']}")
    return res["rc"]


def _convert_smoke(names=None, device=None):
    """Convert + finite-forward-smoke every (selected) zoo entry whose
    checkpoint exists. Returns ``(ok, missing, failed)`` name lists
    (``failed`` as ``(name, error)`` pairs)."""
    import torch

    from midvision_probe_torch.models import zoo
    from midvision_probe_torch.utils.device import resolve_device

    device = resolve_device(device)  # no card and no device: raise once, here
    ok, missing, failed = [], [], []
    for name, entry in sorted(zoo.ZOO.items()):
        if names and name not in names:
            continue
        if name.startswith("test_"):
            continue
        path = os.path.join(zoo.checkpoint_dir(), entry.filename)
        if not os.path.exists(path):
            missing.append(name)
            continue
        try:
            if entry.arch == "resnet":
                m = zoo.build_resnet_extractor(name, return_multilayer=True, device=device)
            elif entry.arch == "convnext":
                m = zoo.build_convnext_extractor(name, return_multilayer=True, device=device)
            elif entry.arch == "sam":
                m = zoo.build_sam_extractor(name, return_multilayer=True, device=device)
            else:
                m = zoo.build_vit_extractor(name, return_multilayer=True, device=device)
            size = min(entry.default_size, 224)
            size -= size % max(m.patch_size, 1) if m.patch_size else 0
            x = torch.zeros((1, size or 224, size or 224, 3), device=m.device)
            out = m(x)
            first = out[0] if isinstance(out, list) else out
            if not np.isfinite(first.float().cpu().numpy()).all():
                raise ValueError("non-finite features")
            ok.append(name)
            print(f"[ok]      {name}: {tuple(first.shape)}")
        except Exception as e:  # noqa: BLE001 — report-and-continue tool
            failed.append((name, str(e)))
            print(f"[FAILED]  {name}: {e}")
    return ok, missing, failed


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("names", nargs="*", help="zoo entries (default: every present one)")
    ap.add_argument("--all", action="store_true", help="the weights-landing drill")
    ap.add_argument("--device", default=None,
                    help="device of the port's forwards (default: the card)")
    args = ap.parse_args(argv)
    if args.all:
        return drill(args.device)
    ok, missing, failed = _convert_smoke(args.names or None, args.device)
    print(f"\nconverted {len(ok)} | missing weights {len(missing)} | "
          f"failed {len(failed)}")
    if missing:
        print("missing:", ", ".join(missing))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())

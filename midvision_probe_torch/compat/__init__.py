"""The reference's ``evals.*`` import paths (counterpart of the JAX
package's ``compat/``).

The original hydra configs name torch classes like
``evals.models.dino.DINO``. ``config.instantiate`` rewrites ``evals.X`` to
``midvision_probe_torch.compat.X``, and this package makes those module
paths, each holding the port's class, so the reference's YAML files
instantiate against the port. The table is the JAX package's.
"""

from __future__ import annotations

import sys
import types

from midvision_probe_torch.datasets import navi as _navi
from midvision_probe_torch.datasets import nyu as _nyu
from midvision_probe_torch.datasets import scannet_pairs as _scannet
from midvision_probe_torch.datasets import spair as _spair
from midvision_probe_torch.datasets import taskonomy as _taskonomy
from midvision_probe_torch.datasets import twoafc as _twoafc
from midvision_probe_torch.datasets import voc as _voc
from midvision_probe_torch.models import probes as _probes
from midvision_probe_torch.models import zoo as _zoo
from midvision_probe_torch.models.maskcut import MaskCutProcessor as _MaskCut

_MODULES = {
    "models.dino": {"DINO": _zoo.DINO},
    "models.dino_res50": {"DINO_RESNET": _zoo.DINO_RESNET},
    "models.mae": {"MAE": _zoo.MAE},
    "models.ibot": {"iBOT": _zoo.iBOT},
    "models.mocov3": {"MoCoV3": _zoo.MoCoV3},
    "models.mocov3_res50": {"MoCoV3_RES": _zoo.MoCoV3_RES},
    "models.maskfeat": {"MASKFEAT": _zoo.MASKFEAT},
    "models.milan": {"MILAN": _zoo.MILAN},
    "models.eva": {"EVA": _zoo.EVA},
    "models.pixmlm": {"PIXMLM": _zoo.PIXMLM},
    "models.beit_v2": {"BEiTV2": _zoo.BEiTV2},
    "models.deit": {"DeIT": _zoo.DeIT},
    "models.clip": {"CLIP": _zoo.CLIP},
    "models.siglip": {"SigLIP": _zoo.SigLIP},
    "models.sam": {"SAM": _zoo.SAM},
    "models.convnext": {"ConvNext": _zoo.ConvNext},
    "models.croco": {"CROCO": _zoo.CROCO},
    "models.midas_final": {"make_beit_backbone": _zoo.make_beit_backbone},
    "models.radio": {"RADIO": _zoo.RADIO},
    "models.stablediffusion": {"DIFT": _zoo.DIFT},
    "models.zero123": {"Zero123": _zoo.Zero123},
    "models.crocov2": {"CROCOV2": _zoo.CROCOV2},
    "models.simclr": {"SIMCLR": _zoo.SIMCLR},
    "models.mocov2": {"MOCOV2": _zoo.MOCOV2},
    "models.simsiam": {"SIMSIAM": _zoo.SIMSIAM},
    "models.byol": {"BYOL": _zoo.BYOL},
    "models.barlowtwins": {"BARLOWTWINS": _zoo.BARLOWTWINS},
    "models.densecl": {"DENSECL": _zoo.DENSECL},
    "models.swav": {"SWAV": _zoo.SWAV},
    "models.selav2": {"SELAV2": _zoo.SELAV2},
    "models.deepclusterv2": {"DEEPCLUSTERV2": _zoo.DEEPCLUSTERV2},
    "models.clusterfit": {"CLUSTERFIT": _zoo.CLUSTERFIT},
    "models.npid": {"NPID": _zoo.NPID},
    "models.npid-plusplus": {"NPID_PLUSPLUS": _zoo.NPID_PLUSPLUS},
    "models.pirl": {"PIRL": _zoo.PIRL},
    "models.jigsaw": {"JIGSAW": _zoo.JIGSAW},
    "models.rotnet": {"ROTNET": _zoo.ROTNET},
    "models.probes": {
        "DepthHead": _probes.DepthHead,
        "SurfaceNormalHead": _probes.SurfaceNormalHead,
        "BinaryHead": _probes.BinaryHead,
        "TaskonomyHead": _probes.TaskonomyHead,
    },
    "models.maskcut_processor": {"MaskCutProcessor": _MaskCut},
    "datasets.nyu": {"NYU": _nyu.NYU},
    "datasets.navi": {"NAVI": _navi.NAVI},
    "datasets.spair": {"SPairDataset": _spair.SPairDataset},
    "datasets.scannet_pairs": {
        "ScanNetPairsDataset": _scannet.ScanNetPairsDataset
    },
    "datasets.taskonomy": {"Taskonomy": _taskonomy.Taskonomy},
    "datasets.twoafcdataset": {"TwoAFCDataset": _twoafc.TwoAFCDataset},
    "datasets.voc": {"VOC": _voc.VOC},
}

_PKG = __name__
for _path, _attrs in _MODULES.items():
    _parts = _path.split(".")
    for _depth in range(1, len(_parts)):  # the intermediate packages
        sys.modules.setdefault(f"{_PKG}." + ".".join(_parts[:_depth]),
                               types.ModuleType(f"{_PKG}." + ".".join(_parts[:_depth])))
    _mod = types.ModuleType(f"{_PKG}.{_path}")
    for _attr, _obj in _attrs.items():
        setattr(_mod, _attr, _obj)
    sys.modules[f"{_PKG}.{_path}"] = _mod

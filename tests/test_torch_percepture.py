"""The 2AFC slice: the port's NIGHTS reader, synthetic triplets, choice
rule, metrics and ``evaluate_model_percepture`` driver against the JAX
package's.

* ``TwoAFCDataset`` (read with the standard ``csv`` module, no pandas) on
  a fabricated NIGHTS tree in the layout of
  ``tests/test_dataset_layouts.py::test_twoafc_layout``: lengths on every
  split and every item (images within 1e-5: JAX's bicubic resize runs under
  ``jax.default_matmul_precision("float32")``);
* ``SyntheticTwoAFC`` easy and hard items, bit for bit;
* ``choose_2afc`` and ``compute_metrics`` on the same inputs, ties and zero
  vectors included;
* the driver on ``synthetic_twoafc_hard`` with the JAX-initialised
  ``test_tiny`` weights carried across: the same choice for every triplet
  whose two similarities differ by more than 1e-5, the accuracy within
  1/n of the JAX driver's, the same CSV row but its time."""

import csv
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import evaluate_model_percepture as j_driver
from midvision_probe_torch import evaluate_model_percepture as t_driver
from midvision_probe_torch.convert.from_jax import vit_state_dict
from midvision_probe_torch.datasets import synthetic as t_synthetic
from midvision_probe_torch.datasets.twoafc import TwoAFCDataset as TTwoAFC
from midvision_probe_torch.models import zoo as t_zoo
from midvision_probe_tpu.config import compose as j_compose
from midvision_probe_tpu.datasets import synthetic as j_synthetic
from midvision_probe_tpu.datasets.twoafc import TwoAFCDataset as JTwoAFC
from midvision_probe_tpu.models import zoo as j_zoo

F32 = jax.default_matmul_precision("float32")
SPLITS = ("train", "val", "test", "test_imagenet", "test_no_imagenet")


def make_nights_tree(root, seed=9):
    """``data.csv`` with the reference's column order (id, prompt, p,
    votes_extra, ref, left, right, votes, split, is_imagenet) and 32x40 PNG
    triplets: rows on every split, some under the vote filter, ``p`` of 0,
    1 and a fraction, ``is_imagenet`` in three spellings pandas reads."""
    rng = np.random.RandomState(seed)
    rows = ["id,prompt,p,votes_extra,ref_path,left_path,right_path,votes,split,is_imagenet"]
    spec = [(7, "train", "False"), (5, "train", "False"), (6, "val", "TRUE"),
            (6, "test", "False"), (6, "test", "True"), (9, "test", "true"),
            (3, "test", "True"), (8, "test", "false"), (6, "train", "True")]
    for i, (votes, split, is_in) in enumerate(spec):
        for part in ("ref", "left", "right"):
            path = os.path.join(root, "distort", f"{i}_{part}.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(rng.randint(0, 255, (32, 40, 3), dtype=np.uint8)).save(path)
        p = ("0.0", "1.0", "0.3333333333")[i % 3]
        rows.append(f"{10 + i},x,{p},0,distort/{i}_ref.png,distort/{i}_left.png,"
                    f"distort/{i}_right.png,{votes},{split},{is_in}")
    with open(os.path.join(root, "data.csv"), "w") as f:
        f.write("\n".join(rows) + "\n")


@pytest.mark.parametrize("preprocess", ["DEFAULT", "LPIPS"])
def test_twoafc_reader_matches_jax_on_every_split(tmp_path, preprocess):
    root = str(tmp_path / "nights")
    make_nights_tree(root)
    lengths = {}
    for split in SPLITS:
        got = TTwoAFC(root, split=split, load_size=24, preprocess=preprocess)
        ref = JTwoAFC(root, split=split, load_size=24, preprocess=preprocess)
        assert len(got) == len(ref), split
        lengths[split] = len(got)
        assert got.name == ref.name == "nights_2afc"
        for i in range(len(ref)):
            with F32:
                r = ref[i]
            g = got[i]
            assert list(g) == list(r)
            for k in r:
                assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, (split, k)
                if k in ("id", "p"):
                    assert g[k] == r[k], (split, k)
                else:
                    np.testing.assert_allclose(g[k], r[k], atol=1e-5, rtol=0,
                                               err_msg=f"{split} {k}")
    assert lengths == {"train": 2, "val": 1, "test": 4, "test_imagenet": 2,
                       "test_no_imagenet": 2}
    with pytest.raises(ValueError, match="Invalid split"):
        TTwoAFC(root, split="nope")


@pytest.mark.parametrize("hard", [False, True])
def test_synthetic_twoafc_items_equal_jax(hard):
    got = t_synthetic.SyntheticTwoAFC(num_instances=7, image_size=(24, 40), hard=hard)
    ref = j_synthetic.SyntheticTwoAFC(num_instances=7, image_size=(24, 40), hard=hard)
    assert len(got) == len(ref) == 7
    for i in range(7):
        g, r = got[i], ref[i]
        assert list(g) == list(r)
        for k in r:
            assert np.asarray(g[k]).dtype == np.asarray(r[k]).dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def test_choose_2afc_and_metrics_match_jax():
    rng = np.random.RandomState(4)
    ref, left, right = (rng.randn(12, 16).astype(np.float32) for _ in range(3))
    left[0] = right[0]  # a tie goes to the right
    ref[1] = 0.0  # zero norms: the 1e-8 clamp, both similarities 0
    left[2], right[2] = 2.0 * ref[2], ref[2]  # equal cosine, a tie again
    got = t_driver.choose_2afc(*(torch.from_numpy(a) for a in (ref, left, right)))
    want = j_driver.choose_2afc(ref, left, right)
    np.testing.assert_array_equal(got, want)
    assert got[0] == got[1] == 1
    for gt, pred in [(rng.randint(0, 2, 40), rng.randint(0, 2, 40)),
                     ([0, 0, 0], [0, 0, 0]), ([1, 1], [0, 0]), ([], [])]:
        assert t_driver.compute_metrics(gt, pred) == j_driver.compute_metrics(gt, pred)


def _capturing(module, sims):
    """Wrap ``module.choose_2afc`` to record each triplet's two cosine
    similarities (float64 of the embeddings it was given) and its choice."""
    choose = module.choose_2afc

    def wrapped(ref, left, right):
        out = choose(ref, left, right)
        r, lf, rt = (np.asarray(a, np.float64) for a in (ref, left, right))
        cos = lambda a, b: (a * b).sum(-1) / np.maximum(  # noqa: E731
            np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-8)
        sims.extend(zip(cos(r, lf), cos(r, rt), np.asarray(out)))
        return out

    return wrapped


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    return rows[0]


def test_percepture_driver_matches_jax_on_the_hard_set(tmp_path, monkeypatch):
    argv = ["backbone=test_tiny", "dataset=synthetic_twoafc_hard", "batch_size=8",
            "dataset.num_instances=20"]
    jsims, tsims = [], []
    monkeypatch.setattr(j_driver, "choose_2afc", _capturing(j_driver, jsims))
    monkeypatch.setattr(t_driver, "choose_2afc", _capturing(t_driver, tsims))
    with F32:
        jm = j_driver.run(j_compose("model_percepture",
                                    argv + [f"output_dir={tmp_path / 'jax'}"]))

    jvars = jax.tree_util.tree_map(np.asarray, j_zoo.build_vit_extractor(
        "test_tiny_vit", return_cls=True).variables)

    def load_jax_vit(module, seed=0):
        module.load_state_dict(vit_state_dict(jvars))
        return module

    monkeypatch.setattr(t_zoo, "random_init", load_jax_vit)
    tm = t_driver.entry(argv + ["+system.device=cpu", f"output_dir={tmp_path / 'torch'}"])

    n = len(jsims)
    assert n == len(tsims) == 20
    decided = 0
    for (jl, jr, jc), (tl, tr, tc) in zip(jsims, tsims):
        np.testing.assert_allclose([tl, tr], [jl, jr], atol=1e-5, rtol=0)
        if abs(jl - jr) > 1e-5:
            decided += 1
            assert tc == jc
    assert decided >= n // 2
    assert list(tm) == list(jm)
    assert abs(tm["accuracy"] - jm["accuracy"]) <= 1 / n
    assert 0.3 < tm["accuracy"] < 0.95  # the hard set does not saturate
    jcsv = _read_csv(tmp_path / "jax" / "final_results_summary.csv")
    tcsv = _read_csv(tmp_path / "torch" / "final_results_summary.csv")
    assert list(tcsv) == list(jcsv)
    for k in jcsv:
        if k != "Time":
            assert tcsv[k] == jcsv[k], k

"""The port's reporting artifacts (``utils/reporting.py``,
``utils/colormaps.py``) against the JAX package's and matplotlib:

* the colormap tables and ``colormaps.apply`` give matplotlib's RGBA
  exactly (10^5 random values, every k/256 boundary, 0, 1, values outside
  [0, 1], NaN and infinities; float32 and float64 input);
* ``visualize_depth``, ``visualize_depth_navi`` and ``visualize_snorm``
  equal the JAX functions' output;
* ``save_images_to_png`` and ``log_first_batch_images`` write the same
  file names as the JAX functions, PNG pixels equal, JSON values within
  1e-5 and TXT lines equal but for numbers within 1e-4;
  ``save_correspondence_json`` writes the same JSON;
* the drawn files (the JAX package draws them with matplotlib, the port
  with PIL on its own canvas) hold what they should: the match dots'
  colours by threshold, the sparse file's first n matches, the scatter's
  size and a dot at each row's position."""

import json
import os

import numpy as np
import pytest
import torch
from matplotlib import colormaps as mpl_colormaps
from PIL import Image

from midvision_probe_torch.utils import colormaps, reporting
from midvision_probe_tpu.utils import reporting as j_reporting


def _png(path):
    return np.asarray(Image.open(path))


# -------------------------------------------------------------- colormaps
@pytest.mark.parametrize("name", ["inferno", "RdYlGn_r"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_colormap_equals_matplotlib(name, dtype):
    table = {"inferno": colormaps.INFERNO, "RdYlGn_r": colormaps.RDYLGN_R}[name]
    rng = np.random.default_rng(3)
    k = np.arange(257) / 256.0
    x = np.concatenate([
        rng.random(100_000), k, np.nextafter(k, -1), np.nextafter(k, 2),
        [0.0, 1.0, -1e-9, -0.5, -7.0, 1.0 + 1e-7, 1.5, 300.0, np.nan, np.inf, -np.inf],
    ]).astype(dtype)
    got = colormaps.apply(table, x)
    ref = mpl_colormaps[name](x)
    assert got.dtype == ref.dtype and got.shape == ref.shape == (x.size, 4)
    np.testing.assert_array_equal(got, ref)
    # NaN is the bad colour, transparent black
    np.testing.assert_array_equal(colormaps.apply(table, np.array([np.nan], dtype))[0],
                                  [0, 0, 0, 0])


def test_colormap_keeps_a_2d_input_shape():
    x = np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4)
    np.testing.assert_array_equal(colormaps.apply(colormaps.INFERNO, x),
                                  mpl_colormaps["inferno"](x))


# ---------------------------------------------------------- visualisation
@pytest.mark.parametrize("kind", ["depth", "depth_navi", "snorm_last", "snorm_first"])
def test_visualizations_equal_jax(kind, rng):
    pred = rng.rand(24, 32, 1).astype(np.float32) * 5
    target = rng.rand(24, 32, 1).astype(np.float32) * 5
    target[:5] = 0.0  # invalid rows: white in the NAVI form
    if kind == "depth":
        got = reporting.visualize_depth(pred, target)
        ref = j_reporting.visualize_depth(pred, target)
    elif kind == "depth_navi":
        got = reporting.visualize_depth_navi(pred, target)
        ref = j_reporting.visualize_depth_navi(pred, target)
        assert (got[1][:5] == 1.0).all()
    else:
        s = rng.randn(24, 32, 3).astype(np.float32)
        if kind == "snorm_first":
            s = np.moveaxis(s, -1, 0)
        got, ref = [reporting.visualize_snorm(s)], [j_reporting.visualize_snorm(s)]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def _split_numbers(line):
    """A TXT line -> (text without its number, the number or None)."""
    head, sep, tail = line.rpartition(": ")
    try:
        return head + sep, float(tail)
    except ValueError:
        return line, None


@pytest.mark.parametrize("is_navi", [False, True])
def test_save_images_to_png_matches_jax(tmp_path, rng, is_navi):
    B, H, W = 3, 40, 56
    pred = rng.rand(B, H, W, 1).astype(np.float32) * 5 + 0.1
    target = rng.rand(B, H, W, 1).astype(np.float32) * 5
    target[:, :6] = 0.0  # invalid pixels
    seg = rng.randint(0, 150, (B, H, W)).astype(np.int32)
    for pkg, d in ((reporting, "torch"), (j_reporting, "jax")):
        pkg.save_images_to_png(pred, target, None if is_navi else seg, batch_idx=2,
                               task="depth", save_dir=str(tmp_path / d), is_navi=is_navi)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == names
    assert len(names) == 4 * B and "pred_depth_2_0.png" in names
    for name in names:
        got, ref = tmp_path / "torch" / name, tmp_path / "jax" / name
        if name.endswith(".png"):
            np.testing.assert_array_equal(_png(got), _png(ref), err_msg=name)
        elif name.endswith(".json"):
            g, r = json.load(open(got)), json.load(open(ref))
            assert list(g) == list(r) == ["global_metrics", "level_metrics"]
            assert list(g["global_metrics"]) == list(r["global_metrics"])
            np.testing.assert_allclose(list(g["global_metrics"].values()),
                                       list(r["global_metrics"].values()),
                                       rtol=1e-5, atol=1e-5, err_msg=name)
            for lvl, kv in r["level_metrics"].items():
                assert list(g["level_metrics"][lvl]) == list(kv)
                np.testing.assert_allclose(list(g["level_metrics"][lvl].values()),
                                           list(kv.values()), rtol=1e-5, atol=1e-5)
        else:
            g, r = open(got).read().splitlines(), open(ref).read().splitlines()
            assert len(g) == len(r)
            for gl, rl in zip(g, r):
                (gt, gv), (rt, rv) = _split_numbers(gl), _split_numbers(rl)
                assert gt == rt
                assert (gv is None) == (rv is None)
                if gv is not None:
                    assert abs(gv - rv) <= 1e-4 + 1e-4 * abs(rv), (name, gl, rl)


class _Wandb:
    """A wandb stand-in that records what is logged."""

    class run:  # noqa: N801
        pass

    def __init__(self):
        self.logged = []

    def Image(self, x):  # noqa: N802
        return ("image", x.shape)

    def log(self, d):
        self.logged.append(d)


@pytest.mark.parametrize("task", ["depth", "snorm"])
def test_log_first_batch_images_matches_jax(tmp_path, rng, task):
    B, H, W = 10, 16, 20
    key, C = ("depth", 1) if task == "depth" else ("snorm", 3)
    batch = {key: rng.rand(B, H, W, C).astype(np.float32) + 0.2}
    pred = rng.rand(B, H, W, C).astype(np.float32) + 0.2
    wandbs = {}
    for pkg, d in ((reporting, "torch"), (j_reporting, "jax")):
        wandbs[d] = _Wandb()
        fn = (lambda b: torch.from_numpy(pred)) if d == "torch" else (lambda b: pred)
        pkg.log_first_batch_images(fn, [batch], wandbs[d], save_dir=str(tmp_path / d),
                                   task=task)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "torch")) == names
    assert len(names) == 16 and "firstbatch_target_7.png" in names  # at most 8
    for name in names:
        np.testing.assert_array_equal(_png(tmp_path / "torch" / name),
                                      _png(tmp_path / "jax" / name), err_msg=name)
    assert wandbs["torch"].logged == wandbs["jax"].logged
    assert len(wandbs["torch"].logged[0]["predictions"]) == 8


def test_save_correspondence_json_matches_jax(tmp_path, rng):
    err2d = rng.rand(300) * 60
    err3d = rng.rand(300) * 0.6
    for pkg, d in ((reporting, "torch"), (j_reporting, "jax")):
        pkg.save_correspondence_json(err2d, err3d, np.array([33.5]), str(tmp_path / d))
    got = open(tmp_path / "torch" / "correspondence_metrics.json").read()
    assert got == open(tmp_path / "jax" / "correspondence_metrics.json").read()
    assert json.loads(got)["relative_angle_deg"] == 33.5


# ------------------------------------------------------------- the figures
def test_correspondence_renders_draw_each_match(tmp_path, rng):
    H, W, N = 60, 80, 12
    img0 = np.full((H, W, 3), -1.0, np.float32)  # black after (x + 1) / 2
    img1 = np.full((H, W, 3), -1.0, np.float32)
    # well-spaced points on a 4x3 lattice, so no dot or line hides another dot
    xs, ys = np.meshgrid(np.arange(4) * 18 + 8, np.arange(3) * 20 + 10)
    uv0 = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float32)
    uv1 = uv0[::-1].copy()
    err2d = np.where(np.arange(N) % 3 == 0, 9.0, 1.0)  # every third an outlier
    reporting.visualize_and_save_correspondences(img0, img1, uv0, uv1, err2d,
                                                 str(tmp_path), sparse_n=5)
    assert sorted(os.listdir(tmp_path)) == ["correspondences.png",
                                            "correspondences_sparse5.png",
                                            "original_views.png"]
    views = _png(tmp_path / "original_views.png")
    assert views.shape == (H, 2 * W, 3) and (views == 0).all()
    full = _png(tmp_path / "correspondences.png")
    sparse = _png(tmp_path / "correspondences_sparse5.png")
    for i in range(N):
        color = reporting.MATCH_GREEN if err2d[i] < 5.0 else reporting.MATCH_RED
        for img, drawn in ((full, True), (sparse, i < 5)):
            for x, y in ((uv0[i, 0], uv0[i, 1]), (uv1[i, 0] + W, uv1[i, 1])):
                # a dot fills the 5x5 window around its point; a 1-pixel
                # line through the window of a point not drawn fills < half
                win = img[int(y) - 2:int(y) + 3, int(x) - 2:int(x) + 3].reshape(-1, 3)
                if drawn:
                    assert (win == color).all(), (i, win)
                else:
                    assert (win != 0).any(-1).sum() < 13, (i, win)


def test_segment_scatter_draws_a_dot_per_row(tmp_path):
    rows = [{"area": a, "d1_ratio": d} for a, d in
            ((10.0, 0.1), (500.0, 0.9), (1000.0, 0.5), (250.0, 0.3))]
    path = reporting.plot_segment_area_vs_d1(rows, output_dir=str(tmp_path))
    name = os.path.basename(path)
    assert name.startswith("segment_area_vs_d1_") and name.endswith(".png")
    img = _png(path)
    assert img.shape == (600, 1000, 3)
    # the data limits pad the range by 5%; the axes box is matplotlib's
    x0, y0, x1, y1 = 125, 72, 900, 534
    lo_a, hi_a, lo_d, hi_d = 10.0, 1000.0, 0.1, 0.9
    pa, pd = 0.05 * (hi_a - lo_a), 0.05 * (hi_d - lo_d)
    blue = 0.4 * 255 + 0.6 * np.array([0x1F, 0x77, 0xB4])  # alpha 0.6 on white
    for r in rows:
        px = x0 + (r["area"] - lo_a + pa) / (hi_a - lo_a + 2 * pa) * (x1 - x0)
        py = y1 - (r["d1_ratio"] - lo_d + pd) / (hi_d - lo_d + 2 * pd) * (y1 - y0)
        np.testing.assert_allclose(img[int(round(py)), int(round(px))], blue, atol=1)
    assert reporting.plot_segment_area_vs_d1([], output_dir=str(tmp_path)) is None

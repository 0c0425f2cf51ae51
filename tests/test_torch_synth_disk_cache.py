"""The synthetic depth set's cross-process disk tier in the port
(``$MVP_SYNTH_DISK_CACHE``), held to the JAX package's contract
(``tests/test_r4_fixes.py::test_synthetic_memo_and_disk_cache``): the
stored item round-trips bit for bit into a fresh instance without
regeneration, the store commits to the keyed path and leaves no temporary
file, a different generation signature misses, a damaged file is
regenerated. And across the packages: the same file name, items equal bit
for bit, and a file written by either package read by the other."""

import os

import numpy as np
import pytest

from midvision_probe_torch.datasets.synthetic import SyntheticDepth as TSynth
from midvision_probe_tpu.datasets.synthetic import SyntheticDepth as JSynth


def _no_regeneration(monkeypatch, cls):
    monkeypatch.setattr(cls, "_generate", lambda self, i: (_ for _ in ()).throw(
        AssertionError("disk tier missed: item regenerated")))


def test_round_trip_commits_and_leaves_no_temporary(tmp_path, monkeypatch):
    monkeypatch.setenv("MVP_SYNTH_DISK_CACHE", str(tmp_path))
    first = TSynth(4, (32, 24), seed=5)
    item = first[2]
    popped = first[2]
    popped.pop("image")
    assert "image" in first[2]  # a consumer's pop does not reach the memo
    key = os.path.basename(first._disk_key(2))
    assert key == "SyntheticDepth_v1_s5_32x24_md10_i2.npz"
    assert os.listdir(tmp_path) == [key]  # committed, no temporary left
    _no_regeneration(monkeypatch, TSynth)
    again = TSynth(4, (32, 24), seed=5)[2]  # a fresh instance: a disk hit
    assert list(again) == list(item)
    for k, v in item.items():
        assert again[k].dtype == v.dtype
        np.testing.assert_array_equal(again[k], v)


@pytest.mark.parametrize("change", [{"seed": 6}, {"image_size": (24, 32)},
                                    {"max_depth": 8.0}])
def test_another_signature_has_another_key(tmp_path, monkeypatch, change):
    monkeypatch.setenv("MVP_SYNTH_DISK_CACHE", str(tmp_path))
    base = dict(num_instances=4, image_size=(32, 24), seed=5)
    a = TSynth(**base)
    b = TSynth(**{**base, **change})
    assert a._disk_key(1) != b._disk_key(1)
    a[1], b[1]
    assert len(os.listdir(tmp_path)) == 2


def test_a_damaged_file_is_regenerated(tmp_path, monkeypatch):
    monkeypatch.setenv("MVP_SYNTH_DISK_CACHE", str(tmp_path))
    want = TSynth(2, (16, 16), seed=3)[0]
    with open(TSynth(2, (16, 16), seed=3)._disk_key(0), "wb") as f:
        f.write(b"not an npz")
    got = TSynth(2, (16, 16), seed=3)[0]
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)


def test_without_the_variable_nothing_is_written(tmp_path, monkeypatch):
    monkeypatch.delenv("MVP_SYNTH_DISK_CACHE", raising=False)
    monkeypatch.chdir(tmp_path)
    ds = TSynth(2, (16, 16))
    assert ds._disk_key(0) is None
    ds[0]
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("writer,reader", [(JSynth, TSynth), (TSynth, JSynth)])
def test_a_file_of_one_package_is_read_by_the_other(tmp_path, monkeypatch, writer, reader):
    monkeypatch.setenv("MVP_SYNTH_DISK_CACHE", str(tmp_path))
    written = writer(4, (40, 32), seed=7)[3]
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(
        reader(4, (40, 32), seed=7)._disk_key(3))]
    _no_regeneration(monkeypatch, reader)
    read = reader(4, (40, 32), seed=7)[3]
    assert list(read) == list(written)
    for k, v in written.items():
        assert read[k].dtype == v.dtype
        np.testing.assert_array_equal(read[k], v)


def test_stored_items_equal_the_jax_items_bit_for_bit(tmp_path, monkeypatch):
    monkeypatch.setenv("MVP_SYNTH_DISK_CACHE", str(tmp_path / "torch"))
    t_items = [TSynth(3, (48, 40), seed=1)[i] for i in range(3)]
    monkeypatch.setenv("MVP_SYNTH_DISK_CACHE", str(tmp_path / "jax"))
    j_items = [JSynth(3, (48, 40), seed=1)[i] for i in range(3)]
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    for name in os.listdir(tmp_path / "torch"):
        with np.load(tmp_path / "torch" / name) as t, np.load(tmp_path / "jax" / name) as j:
            assert t.files == j.files
            for k in t.files:
                assert t[k].dtype == j[k].dtype
                np.testing.assert_array_equal(t[k], j[k])
    for t, j in zip(t_items, j_items):
        for k in j:
            np.testing.assert_array_equal(t[k], j[k])

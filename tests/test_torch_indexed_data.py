"""The port's indexed dataset and offline data analyzer
(``deepspeed_tpu_torch.runtime.indexed_dataset`` / ``data_analyzer``)
held against the JAX package's: files written by one package read by the
other, byte for byte, and the analyzer's index files equal.  Exact
comparisons throughout (host numpy code on both sides)."""

import os

import numpy as np
import pytest

from deepspeed_tpu.runtime import data_analyzer as jda
from deepspeed_tpu.runtime import indexed_dataset as jid
from deepspeed_tpu_torch.runtime import data_analyzer as tda
from deepspeed_tpu_torch.runtime import indexed_dataset as tid
from tests.test_torch_train import one_thread  # noqa: F401 (autouse)

PACKAGES = {"jax": (jid, jda), "port": (tid, tda)}


def _samples(dtype):
    r = np.random.RandomState(0)
    return [r.randint(0, 100, r.randint(1, 20)).astype(dtype)
            for _ in range(17)]


def _build(mod, prefix, samples, dtype):
    b = mod.MMapIndexedDatasetBuilder(prefix, dtype=dtype)
    for s in samples:
        b.add_item(s)
    b.finalize()


@pytest.mark.parametrize("dtype", [np.int32, np.uint16, np.int64,
                                   np.float32])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_files_cross_both_ways(tmp_path, dtype, writer, reader):
    samples = _samples(dtype)
    _build(PACKAGES[writer][0], str(tmp_path / "w"), samples, dtype)
    _build(PACKAGES[reader][0], str(tmp_path / "r"), samples, dtype)
    for ext in (".bin", ".idx"):
        assert (tmp_path / f"w{ext}").read_bytes() == \
            (tmp_path / f"r{ext}").read_bytes()
    ds = PACKAGES[reader][0].MMapIndexedDataset(str(tmp_path / "w"))
    assert len(ds) == len(samples) and ds.dtype == np.dtype(dtype)
    for got, want in zip(ds, samples):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ds[-1], samples[-1])
    assert [x.tolist() for x in ds[2:5]] == [x.tolist()
                                             for x in samples[2:5]]
    np.testing.assert_array_equal(
        ds.batch([0, 3, 5], 8, pad_id=7),
        PACKAGES[writer][0].MMapIndexedDataset(
            str(tmp_path / "r")).batch([0, 3, 5], 8, pad_id=7))
    assert ds.total_tokens == sum(len(s) for s in samples)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_merge_and_bad_magic(tmp_path, pkg):
    mod = PACKAGES[pkg][0]
    samples = _samples(np.int32)
    _build(mod, str(tmp_path / "a"), samples[:9], np.int32)
    _build(mod, str(tmp_path / "b"), samples[9:], np.int32)
    m = mod.MMapIndexedDatasetBuilder(str(tmp_path / "m"), dtype=np.int32)
    m.merge_file(str(tmp_path / "a"))
    m.merge_file(str(tmp_path / "b"))
    m.finalize()
    _build(jid, str(tmp_path / "whole"), samples, np.int32)
    for ext in (".bin", ".idx"):
        assert (tmp_path / f"m{ext}").read_bytes() == \
            (tmp_path / f"whole{ext}").read_bytes()
    (tmp_path / "bad.idx").write_bytes(b"NOTMAGIC!" + bytes(16))
    (tmp_path / "bad.bin").write_bytes(b"")
    with pytest.raises(ValueError, match="magic"):
        mod.MMapIndexedDataset(str(tmp_path / "bad"))


def _metric_files(mod, path, n, workers):
    data = [np.arange(i % 7 + 1) * (i % 3) for i in range(n)]
    fns = {"len": lambda s: float(len(s)),
           "total": lambda s: float(np.sum(s))}
    for w in range(workers):
        mod.DataAnalyzer(data, fns, str(path), num_workers=workers,
                         worker_id=w).run_map()
    mod.DataAnalyzer(data, fns, str(path), num_workers=workers).run_reduce()


@pytest.mark.parametrize("workers", [1, 3, 40])
def test_analyzer_outputs_equal(tmp_path, workers):
    """map/reduce over 1, 3 and more workers than samples: every index
    file equal to the JAX analyzer's, and the consumers' answers too."""
    _metric_files(jda, tmp_path / "jax", 25, workers)
    _metric_files(tda, tmp_path / "port", 25, workers)
    for metric in ("len", "total"):
        jdir, tdir = tmp_path / "jax" / metric, tmp_path / "port" / metric
        assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
        for f in os.listdir(jdir):
            assert (jdir / f).read_bytes() == (tdir / f).read_bytes(), f
        for bound in (0.0, 2.0, 5.5, 100.0):
            np.testing.assert_array_equal(
                tda.samples_up_to_difficulty(str(tmp_path / "port"), metric,
                                             bound),
                jda.samples_up_to_difficulty(str(tmp_path / "jax"), metric,
                                             bound))
        for got, want in zip(
                tda.difficulty_buckets(str(tmp_path / "port"), metric, 4),
                jda.difficulty_buckets(str(tmp_path / "jax"), metric, 4)):
            np.testing.assert_array_equal(got, want)
        lm = tda.load_metric(str(tmp_path / "jax"), metric)
        np.testing.assert_array_equal(
            lm["sorted_values"],
            jda.load_metric(str(tmp_path / "port"), metric)["sorted_values"])


def test_analyzer_run_is_single_worker(tmp_path):
    with pytest.raises(ValueError, match="single-worker"):
        tda.DataAnalyzer([1, 2], {"m": float}, str(tmp_path), num_workers=2,
                         worker_id=1).run()

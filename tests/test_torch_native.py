"""The port's native ``.npy`` reader (``cfdbench_tpu_torch/native``) and the
data layer's prefetch through it (``data/fast_io.py``, the chunk
prefetcher of ``data/datasets.py``).

The reader against ``np.load`` and against the JAX package's reader
(``cfdbench_tpu.native``), bit for bit: float32 files, float64 files
converted as they are read, batches, shapes, npy format 2.0. A dtype or a
layout it does not take (``UnsupportedNpy``) leaves its batch to
``np.load``, as the JAX package's does; any other fault raises. A build
that fails raises with the compiler's output: no loader falls back to
``np.load`` for a reader that did not build. The port's ``AutoDataset``
and ``FrameDataset`` built through the prefetcher, at a chunk of 2 cases
so that chunk boundaries are crossed, equal the JAX package's bit for bit,
every case file read by the native reader; a build that fails mid-pack
leaves nothing in the cache.
"""

import shutil

import numpy as np
import pytest

from cfdbench_tpu import data as jax_data
from cfdbench_tpu import native as jax_native
from cfdbench_tpu_torch import data, native
from cfdbench_tpu_torch.data import datasets, fast_io


@pytest.fixture()
def files(tmp_path, rng):
    """float32, float64 and format-2.0 files of a few shapes."""
    out = {}
    for name, shape, dtype in (("f32", (5, 16, 16), np.float32), ("f64", (3, 7, 9), np.float64),
                               ("flat", (11,), np.float32), ("scalar", (), np.float64)):
        out[name] = tmp_path / f"{name}.npy"
        np.save(out[name], (rng.standard_normal(shape) * 1e3).astype(dtype))
    out["v2"] = tmp_path / "v2.npy"
    with open(out["v2"], "wb") as f:
        np.lib.format.write_array(f, rng.standard_normal((4, 6)), version=(2, 0))
    return out


def want(path):
    return np.load(path).astype(np.float32)


def test_reader_equals_np_load_and_the_jax_reader(files):
    for path in files.values():
        got = native.read_npy_f32(path)
        assert got.dtype == np.float32 and got.shape == np.load(path).shape
        assert native.npy_shape(path) == np.load(path).shape
        np.testing.assert_array_equal(got, want(path))
        np.testing.assert_array_equal(got, jax_native.read_npy_f32(path))
    paths = list(files.values()) * 3
    for got, path, theirs in zip(native.read_npy_f32_batch(paths, n_threads=4), paths,
                                 jax_native.read_npy_f32_batch(paths, n_threads=4)):
        np.testing.assert_array_equal(got, want(path))
        np.testing.assert_array_equal(got, theirs)
    assert native.read_npy_f32_batch([]) == []


def test_prefetch_serves_each_file_once(files):
    fast_io.clear_cache()
    paths = [files["f32"], files["f64"], files["f32"].with_name("missing.npy")]
    assert fast_io.prefetch_npy(paths) == 2
    assert fast_io.prefetch_npy(paths) == 0  # cached already
    for path in paths[:2]:
        np.testing.assert_array_equal(fast_io.load_npy(path), want(path))
        assert str(path) not in fast_io._CACHE
    np.testing.assert_array_equal(fast_io.load_npy(files["f32"]), want(files["f32"]))
    with pytest.raises(FileNotFoundError):
        fast_io.load_npy(paths[2])


@pytest.mark.parametrize("kind", ["int32", "float16", "big-endian", "fortran"])
def test_a_file_the_reader_does_not_take_leaves_its_batch_to_np_load(tmp_path, files, rng, kind):
    a = rng.standard_normal((4, 5))
    a = {"int32": (a * 100).astype(np.int32), "float16": a.astype(np.float16),
         "big-endian": a.astype(">f4"), "fortran": np.asfortranarray(a)}[kind]
    path = tmp_path / f"{kind}.npy"
    np.save(path, a)
    with pytest.raises(native.UnsupportedNpy):
        native.read_npy_f32(path)
    with pytest.raises(native.UnsupportedNpy):
        native.read_npy_f32_batch([files["f32"], path])
    with pytest.raises(ValueError):
        jax_native.read_npy_f32(path)
    fast_io.clear_cache()
    assert fast_io.prefetch_npy([files["f32"], path]) == 0
    assert not fast_io._CACHE
    np.testing.assert_array_equal(fast_io.load_npy(path), want(path))


def test_other_faults_raise(tmp_path, files):
    short = tmp_path / "short.npy"
    short.write_bytes(files["f32"].read_bytes()[:-8])
    garbage = tmp_path / "garbage.npy"
    garbage.write_bytes(b"not an npy file at all")
    for path, what in ((short, "shorter"), (garbage, "magic")):
        with pytest.raises(ValueError, match=what) as e:
            fast_io.prefetch_npy([files["f32"], path])
        assert not isinstance(e.value, native.UnsupportedNpy)


def test_a_build_that_fails_raises_with_the_compiler_output(tmp_path, monkeypatch, files):
    monkeypatch.setattr(native, "LIBRARY", tmp_path / "build" / "libcfdbench_npy.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("CXX", "/bin/false")
    with pytest.raises(RuntimeError, match="/bin/false failed"):
        native.load()
    assert not native.available()
    with pytest.raises(RuntimeError, match="/bin/false"):
        fast_io.prefetch_npy([files["f32"]])
    assert (tmp_path / "build" / "npy_reader.log").exists()
    assert not native.LIBRARY.exists()


@pytest.fixture()
def mixed_root(synth_root, tmp_path):
    """The session's synthetic cavity tree with every other case's files
    in float64, as the real dataset holds them."""
    root = tmp_path / "data"
    shutil.copytree(synth_root / "cavity", root / "cavity")
    for i, f in enumerate(sorted((root / "cavity").rglob("*.npy"))):
        if i % 4 < 2:
            np.save(f, np.load(f).astype(np.float64))
    return root


def count_native_reads(monkeypatch):
    read = []
    batch = native.read_npy_f32_batch

    def counted(paths, n_threads=16):
        read.extend(map(str, paths))
        return batch(paths, n_threads)

    monkeypatch.setattr(native, "read_npy_f32_batch", counted)
    return read


def test_datasets_through_the_prefetcher_equal_jax(mixed_root, monkeypatch):
    monkeypatch.setattr(datasets, "PREFETCH_CHUNK", 2)
    read = count_native_reads(monkeypatch)
    kw = dict(data_dir=mixed_root, data_name="cavity_prop_bc_geo", norm_props=True,
              norm_bc=True, seed=0)
    got = data.get_auto_dataset(delta_time=0.1, **kw)
    wanted = jax_data.get_auto_dataset(delta_time=0.1, **kw)
    n_files = sum(len(g.all_features) for g in got) * 2
    assert len(read) == len(set(read)) == n_files
    assert all(p.endswith(("u.npy", "v.npy")) for p in read)
    for g, w in zip(got, wanted):
        for name in ("inputs", "labels", "masks", "case_params", "case_ids"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
        for fg, fw in zip(g.all_features, w.all_features):
            np.testing.assert_array_equal(fg, fw)
    read.clear()
    got, wanted = data.get_dataset(**kw), jax_data.get_dataset(**kw)
    assert len(read) == n_files
    for g, w in zip(got, wanted):
        for name in ("frames", "frame_t", "case_params", "case_ids"):
            np.testing.assert_array_equal(getattr(g, name), getattr(w, name))
    assert not fast_io._CACHE


def test_a_failed_build_leaves_no_cache(mixed_root, monkeypatch):
    monkeypatch.setattr(datasets, "PREFETCH_CHUNK", 2)
    read = count_native_reads(monkeypatch)
    cases = sorted(p for p in (mixed_root / "cavity" / "prop").iterdir() if p.is_dir())
    u = np.load(cases[0] / "u.npy")
    u[1, 2, 3] = np.nan
    np.save(cases[0] / "u.npy", u)
    held = []

    def clear():
        held.append(len(fast_io._CACHE))
        fast_io.clear_cache()

    monkeypatch.setattr(datasets, "clear_cache", clear)
    with pytest.raises(ValueError, match="NaN in case"):
        datasets.build_auto_dataset("cavity", cases, True, True)
    assert len(read) >= 4  # the first chunk, and the second read ahead
    assert held[0] >= 2  # the second case's files, read and never packed
    assert not fast_io._CACHE

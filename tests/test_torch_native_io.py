"""The port's native threaded batch reader (``pydrobert_tpu_torch.native``,
its own copy of ``io.cpp``, built with g++ into ``pydrobert_tpu_torch/_build``)
against the JAX package's reader and against item-by-item reads: the bytes
it reads equal both, and every dataset's ``native_batch_fetch`` and every
loader's native batches equal per-item reads bit for bit (MVN and deltas
included: the same function runs on the same tensors)."""

import os
import threading

import numpy as np
import pytest
import torch

from pydrobert_tpu import native as jnative
from pydrobert_tpu.utils import serial as jserial
from pydrobert_tpu_torch import native
from pydrobert_tpu_torch import data as pdata
from pydrobert_tpu_torch.data import datasets as pdatasets
from pydrobert_tpu_torch.utils.serial import load_tensor, save_tensor, tensor_entry

pytestmark = pytest.mark.skipif(
    not native.available(), reason="the native reader did not build (no g++?)"
)


def _equal_items(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or isinstance(x, (str, tuple)):
            assert x == y
        else:
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y)


def test_built_into_the_package_build_dir():
    """The library is the port's own build of its own source."""
    assert os.path.dirname(native._SRC) != os.path.dirname(jnative._SRC)
    lib = native._load()
    assert lib is not None
    built = [f for f in os.listdir(native._BUILD_DIR) if f.startswith("pdt_io_")]
    assert built
    assert 1 <= native.native_threads() <= max(16, os.cpu_count() or 1)


@pytest.mark.parametrize(
    "shape,dtype",
    [((13, 7), np.float32), ((9,), np.int64), ((4, 3), np.int64), ((), np.float32),
     ((0, 5), np.float32), ((6, 2), np.float16)],
)
def test_read_batch_equals_jax_and_load_tensor(tmp_path, shape, dtype):
    """One file read by the port's reader into a tensor and into a numpy
    array, by the JAX reader, and by load_tensor: the same bits."""
    rng = np.random.RandomState(0)
    arr = np.asarray(rng.randn(*shape) * 10).astype(dtype).reshape(shape)
    pth = str(tmp_path / "x.pt")
    save_tensor(torch.from_numpy(arr), pth)
    entry = tensor_entry(pth)
    assert entry is not None and entry.shape == shape and entry.dtype == np.dtype(dtype)
    out_t = torch.from_numpy(np.empty(entry.shape, entry.dtype))
    out_n = np.empty(entry.shape, entry.dtype)
    out_j = np.empty(entry.shape, entry.dtype)
    native.read_batch([(pth, entry.payload_offset, out_t), (pth, entry.payload_offset, out_n)])
    jnative.read_batch([(pth, entry.payload_offset, out_j)])
    assert torch.equal(out_t, load_tensor(pth))
    np.testing.assert_array_equal(out_n, out_j)
    np.testing.assert_array_equal(out_n, arr)


def test_read_batch_many_files_many_threads_equal_jax(tmp_path):
    rng = np.random.RandomState(1)
    tasks_p, tasks_j, arrs = [], [], []
    for i in range(40):
        arr = rng.randn(int(rng.randint(1, 50)), 3).astype(np.float32)
        pth = str(tmp_path / f"{i}.pt")
        jserial.save_tensor(arr, pth)
        e = tensor_entry(pth)
        tasks_p.append((pth, e.payload_offset, torch.empty(e.shape)))
        tasks_j.append((pth, e.payload_offset, np.empty(e.shape, np.float32)))
        arrs.append(arr)
    native.read_batch(tasks_p, nthreads=7)
    jnative.read_batch(tasks_j, nthreads=7)
    for (_, _, t), (_, _, j), a in zip(tasks_p, tasks_j, arrs):
        np.testing.assert_array_equal(t.numpy(), j)
        np.testing.assert_array_equal(j, a)


def test_read_batch_rejects_bad_buffers_and_files(tmp_path):
    out = np.empty((3,), np.float32)
    with pytest.raises(OSError, match="nope"):
        native.read_batch([(str(tmp_path / "nope.pt"), 0, out)])
    pth = str(tmp_path / "x.pt")
    save_tensor(torch.arange(4.0), pth)
    with pytest.raises(OSError):  # a short read past the end of the file
        native.read_batch([(pth, 0, np.empty((100000,), np.float32))])
    with pytest.raises(ValueError):
        native.read_batch([(pth, 0, torch.empty(4, 2).t())])
    with pytest.raises(ValueError):
        native.read_batch([(pth, 0, np.empty((4, 2), np.float32).T)])


def test_environment_switch_turns_the_reader_off(populate_data_dir, monkeypatch):
    root, *_ = populate_data_dir(num_utts=3)
    ds = pdata.SpectDataSet(root)
    assert ds.native_batch_fetch([0, 1]) is not None
    monkeypatch.setenv("PYDROBERT_TPU_NATIVE_IO", "0")
    assert not native.available() and not jnative.available()
    assert ds.native_batch_fetch([0, 1]) is None
    loader = pdata.SpectDataLoader(root, device="cpu")
    list(loader)
    assert loader.reads == {"native": 0, "per_item": len(loader)}


def test_strided_file_read_per_item_inside_the_batch(tmp_path):
    """A file whose payload is not one byte range (torch.save of a
    transposed view) is read with load_tensor inside the native batch."""
    t = torch.randn(6, 4).t()
    strided, plain = str(tmp_path / "strided.pt"), str(tmp_path / "plain.pt")
    torch.save(t, strided)
    save_tensor(torch.arange(5), plain)
    assert tensor_entry(strided) is None
    got = pdatasets._native_load_many([strided, plain])
    assert torch.equal(got[0], t) and torch.equal(got[1], torch.arange(5))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_spect_loader_native_batches_equal_per_item_and_jax(populate_data_dir, monkeypatch,
                                                            prefetch):
    """Shuffled batches with alis and uttids: native equal to per-item reads
    and to the JAX loader's (its native path)."""
    from pydrobert_tpu import data as jdata

    root, *_ = populate_data_dir(num_utts=12)
    kw = dict(seed=7, suppress_alis=False, suppress_uttids=False)

    def batches(use_native):
        monkeypatch.setenv("PYDROBERT_TPU_NATIVE_IO", "1" if use_native else "0")
        loader = pdata.SpectDataLoader(
            root, pdata.SpectDataLoaderParams(batch_size=5), device="cpu", prefetch=prefetch, **kw
        )
        out = list(loader)
        assert loader.reads["native" if use_native else "per_item"] == len(out) == 3
        return out

    nat, per_item = batches(True), batches(False)
    monkeypatch.setenv("PYDROBERT_TPU_NATIVE_IO", "1")
    jb = list(jdata.SpectDataLoader(root, jdata.SpectDataLoaderParams(batch_size=5), **kw))
    for bn, bp, bj in zip(nat, per_item, jb):
        _equal_items(bn, bp)
        for x, y in zip(bn, bj):
            if isinstance(x, torch.Tensor):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            else:
                assert x == y


def test_spect_native_fetch_with_transforms_equals_items(populate_data_dir):
    root, *_ = populate_data_dir(num_utts=6)
    params = pdata.SpectDataParams(do_mvn=True, delta_order=2, sos=20, eos=21)
    ds = pdata.SpectDataSet(root, params=params, suppress_alis=False, tokens_only=False)
    fetched = ds.native_batch_fetch(range(len(ds)))
    for j in range(len(ds)):
        _equal_items(ds[j], fetched[j])


def test_lang_native_fetch_equals_items_and_jax(populate_data_dir):
    from pydrobert_tpu import data as jdata

    root, *_ = populate_data_dir(num_utts=8, include_frame_shift=False)
    kw = dict(suppress_uttids=False)
    ds = pdata.LangDataSet(os.path.join(root, "ref"), params=pdata.LangDataParams(sos=100, eos=101),
                           **kw)
    jds = jdata.LangDataSet(os.path.join(root, "ref"),
                            params=jdata.LangDataParams(sos=100, eos=101), **kw)
    fetched = ds.native_batch_fetch(range(len(ds)))
    jfetched = jds.native_batch_fetch(range(len(ds)))
    for j in range(len(ds)):
        (e_ref, e_id), (a_ref, a_id), (j_ref, j_id) = ds[j], fetched[j], jfetched[j]
        assert e_id == a_id == j_id
        assert torch.equal(e_ref, a_ref)
        np.testing.assert_array_equal(a_ref.numpy(), j_ref)


def test_context_window_native_fetch_equals_items(populate_data_dir):
    root, *_ = populate_data_dir(num_utts=5)
    ds = pdata.ContextWindowDataSet(root, left=2, right=1, reverse=True)
    fetched = ds.native_batch_fetch(range(len(ds)))
    for j in range(len(ds)):
        _equal_items(ds[j], fetched[j])


def test_index_cache_invalidates_on_rewrite(tmp_path):
    pth = str(tmp_path / "x.pt")
    save_tensor(torch.arange(4), pth)
    (first,) = pdatasets._native_load_many([pth])
    assert torch.equal(first, torch.arange(4))
    save_tensor(torch.arange(9) * 2, pth)
    (second,) = pdatasets._native_load_many([pth])
    assert torch.equal(second, torch.arange(9) * 2)


def test_loader_respects_subclass_item_override(populate_data_dir):
    """An override of item access below the class with the fetch wins: the
    loader reads item by item (the fetch would bypass it)."""
    root, *_ = populate_data_dir(num_utts=6)

    class Doubled(pdata.SpectDataSet):
        def get_utterance_tuple(self, idx):
            feat, ref = super().get_utterance_tuple(idx)
            return feat * 2, ref

    params = pdata.SpectDataLoaderParams(batch_size=3)
    loader = pdata.SpectDataLoader(Doubled(root), params, shuffle=False, device="cpu")
    base = pdata.SpectDataLoader(pdata.SpectDataSet(root), params, shuffle=False, device="cpu")
    assert loader._native_fetch() is None and base._native_fetch() is not None
    for (f2, *_), (f1, *_) in zip(loader, base):
        assert torch.equal(f2, 2 * f1)
    assert loader.reads == {"native": 0, "per_item": 2}
    assert base.reads == {"native": 2, "per_item": 0}


def test_loader_prefetch_early_break_stops_worker(populate_data_dir):
    root, *_ = populate_data_dir(num_utts=12)
    loader = pdata.SpectDataLoader(root, pdata.SpectDataLoaderParams(batch_size=2),
                                   device="cpu", prefetch=1)
    before = threading.active_count()
    for i, _ in enumerate(loader):
        if i == 1:
            break
    assert threading.active_count() <= before + 1

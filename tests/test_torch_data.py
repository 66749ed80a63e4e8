"""The port's host data path against the JAX package's: ``.pt`` files read
across both ways, params files, SpectDataSet items (MVN and deltas),
validation, sampler streams, bucket batches and the three collates, the
data module's splits and the deprecated aliases. Arrays must be equal bit
for bit, except features after mean-variance normalization or deltas:
``ops.feats`` sums in another order than XLA and is held to rtol 1e-6 and
atol 1e-6 (tests/test_torch_feats.py), and so are they here (``FTOL``)."""

import os
import warnings

import numpy as np
import pytest
import torch

from pydrobert_tpu import data as jdata
from pydrobert_tpu import datamodule as jdm
from pydrobert_tpu.data import params as jparams
from pydrobert_tpu.utils import serial as jserial
from pydrobert_tpu_torch import data as pdata
from pydrobert_tpu_torch import datamodule as pdm
from pydrobert_tpu_torch.data import params as pparams
from pydrobert_tpu_torch.utils import serial as pserial


def _np(x):
    if x is None:
        return None
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


FTOL = 1e-6


def _assert_items_equal(a, b, ftol=0.0):
    """Equal items or batches; floating arrays within rtol = atol =
    ``ftol`` (0: bit for bit)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, (str, tuple)) or x is None:
            assert x == y or (_np(x) is None and _np(y) is None)
            continue
        x, y = _np(x), _np(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        if ftol and np.issubdtype(x.dtype, np.floating):
            np.testing.assert_allclose(x, y, rtol=ftol, atol=ftol)
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize(
    "arr",
    [
        np.arange(12, dtype=np.float32).reshape(3, 4),
        np.arange(5, dtype=np.int64),
        np.array(3.5, dtype=np.float64),
        np.zeros((0, 3), np.float32),
        np.array([[1, 0, 2], [4, -1, -1]], np.int32),
    ],
    ids=["f32", "i64", "scalar", "empty", "i32"],
)
def test_pt_files_cross_both_ways(tmp_path, arr):
    """A JAX save_tensor file loads in the port and a port file in JAX,
    equal in dtype, shape and values; both give a direct byte range."""
    jp, pp = str(tmp_path / "j.pt"), str(tmp_path / "p.pt")
    jserial.save_tensor(arr, jp)
    pserial.save_tensor(torch.from_numpy(arr), pp)
    got = pserial.load_tensor(jp)
    assert got.numpy().dtype == arr.dtype and tuple(got.shape) == arr.shape
    np.testing.assert_array_equal(got.numpy(), arr)
    back = jserial.load_tensor(pp)
    assert back.dtype == arr.dtype and back.shape == arr.shape
    np.testing.assert_array_equal(back, arr)
    for path in (jp, pp):
        for entry in (pserial.tensor_entry(path), jserial.tensor_entry(path)):
            assert entry is not None and entry.shape == arr.shape
            with open(path, "rb") as f:
                f.seek(entry.payload_offset)
                raw = np.frombuffer(f.read(entry.nbytes), entry.dtype).reshape(arr.shape)
            np.testing.assert_array_equal(raw, arr)


def test_save_tensor_writes_only_a_strided_views_elements(tmp_path):
    """A column of a (100, 50) tensor: torch.save writes the whole storage
    and no byte range; the port's save_tensor writes a fresh copy that
    both packages read, with a byte range, in a much smaller file."""
    base = torch.arange(5000, dtype=torch.float32).reshape(100, 50)
    col = base[:, 7]
    raw, ours = str(tmp_path / "raw.pt"), str(tmp_path / "ours.pt")
    torch.save(col, raw)
    pserial.save_tensor(col, ours)
    assert jserial.tensor_entry(raw) is None and pserial.tensor_entry(raw) is None
    for entry in (jserial.tensor_entry(ours), pserial.tensor_entry(ours)):
        assert entry is not None and entry.shape == (100,)
    assert os.path.getsize(ours) < os.path.getsize(raw) / 10
    np.testing.assert_array_equal(jserial.load_tensor(ours), col.numpy())
    np.testing.assert_array_equal(pserial.load_tensor(ours).numpy(), col.numpy())


@pytest.mark.parametrize("ext", [".ini", ".json", ".yaml"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_params_files_read_in_the_other_package(tmp_path, ext, writer):
    if ext == ".yaml":
        pytest.importorskip("yaml")
    path = str(tmp_path / f"p{ext}")
    kw = dict(subset_ids=["a", "b"], sos=3, eos=None, delta_order=1, do_mvn=True)
    src, dst = (jparams, pparams) if writer == "jax" else (pparams, jparams)
    src.serialize_params_to_file(path, src.SpectDataParams(**kw))
    got = dst.deserialize_params_from_file(path, dst.SpectDataParams)
    assert pparams.params_to_dict(got) == jparams.params_to_dict(jparams.SpectDataParams(**kw))
    # nested params of the data module, in dotted ini sections
    mpath = str(tmp_path / f"m{ext}")
    srcm, dstm = (jdm, pdm) if writer == "jax" else (pdm, jdm)
    mp = srcm.SpectDataModuleParams(train_dir="tr", info_path="i.txt")
    mp.initialize_missing()
    mp.train.batch_size = 3
    mp.to_file(mpath)
    back = dstm.SpectDataModuleParams.from_file(mpath)
    assert back.train.batch_size == 3 and back.train_dir == "tr"
    assert isinstance(back.val, dstm.SpectDataModuleParams.pclass)


def test_params_bounds_and_tunables_match():
    with pytest.raises(ValueError):
        pparams.SpectDataParams(delta_order=-1)
    for name in ("LangDataParams", "SpectDataParams", "ContextWindowDataParams"):
        assert getattr(pparams, name).get_tunable() == getattr(jparams, name).get_tunable()
        assert pparams.params_to_dict(getattr(pparams, name)()) == jparams.params_to_dict(
            getattr(jparams, name)()
        )


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"do_mvn": True},
        {"delta_order": 2},
        {"do_mvn": True, "delta_order": 1, "sos": 20, "eos": 21},
    ],
    ids=["plain", "mvn", "deltas", "mvn_deltas_sos_eos"],
)
def test_spect_data_set_items_equal_jax(populate_data_dir, seeded, kw):
    """Every item of a JAX-written directory: plain feats, alis and (R, 3)
    refs bit-equal; feats after MVN or deltas within FTOL."""
    root, *_ = populate_data_dir(num_utts=6, max_width=12)
    args = dict(suppress_alis=False, tokens_only=False, suppress_uttids=False)
    jds = jdata.SpectDataSet(root, params=jparams.SpectDataParams(**kw), **args)
    pds = pdata.SpectDataSet(root, params=pparams.SpectDataParams(**kw), **args)
    assert jds.utt_ids == pds.utt_ids
    ftol = FTOL if kw.get("do_mvn") or kw.get("delta_order") else 0.0
    for i in range(len(jds)):
        _assert_items_equal(pds[i], jds[i], ftol)
    mean, std = np.full(5, 0.25, np.float32), np.full(5, 2.0, np.float32)
    jg = jdata.SpectDataSet(root, params=jparams.SpectDataParams(do_mvn=True), feat_mean=mean, feat_std=std)
    pg = pdata.SpectDataSet(root, params=pparams.SpectDataParams(do_mvn=True), feat_mean=mean, feat_std=std)
    _assert_items_equal(pg[2], jg[2], FTOL)


def test_lang_and_context_window_data_sets_equal_jax(populate_data_dir, seeded):
    root, *_ = populate_data_dir(num_utts=5)
    ref_dir = os.path.join(root, "ref")
    for kw in ({}, {"sos": 30, "eos": 31}):
        jl = jdata.LangDataSet(ref_dir, params=jparams.LangDataParams(**kw))
        pl = pdata.LangDataSet(ref_dir, params=pparams.LangDataParams(**kw))
        for i in range(len(jl)):
            _assert_items_equal((pl[i],), (jl[i],))
    for reverse in (False, True):
        jc = jdata.ContextWindowDataSet(root, 2, 3, reverse=reverse)
        pc = pdata.ContextWindowDataSet(root, 2, 3, reverse=reverse)
        for i in range(len(jc)):
            _assert_items_equal(pc[i], jc[i])
        np.testing.assert_array_equal(
            pdata.extract_window(torch.from_numpy(jc[0][0][:, 2]), 1, 2, 2, reverse).numpy(),
            jdata.extract_window(jc[0][0][:, 2], 1, 2, 2, reverse),
        )


def test_write_hyp_and_pdf_read_in_jax(populate_data_dir, tmp_path, seeded):
    root, _, _, _, utt_ids = populate_data_dir(num_utts=3)
    ds = pdata.SpectDataSet(root, params=pparams.SpectDataParams(sos=50, eos=51))
    ds.write_hyp(0, torch.tensor([50, 3, 4, 5, 51, 9]))
    back = jserial.load_tensor(str(tmp_path / "hyp" / (utt_ids[0] + ".pt")))
    assert back.dtype == np.int64
    np.testing.assert_array_equal(back, [3, 4, 5])
    ds.write_pdf(1, torch.randn(7, 11, dtype=torch.float64))
    pdf = jserial.load_tensor(str(tmp_path / "pdfs" / (utt_ids[1] + ".pt")))
    assert pdf.shape == (7, 11) and pdf.dtype == np.float32


def test_info_and_validation_equal_jax(populate_data_dir, tmp_path, seeded):
    """The info dict equals JAX's; each broken file raises the same error
    in both packages, and each fix writes what JAX's fix writes."""
    from pydrobert_tpu.data.datasets import _info_and_validate as jinfo
    from pydrobert_tpu_torch.data.datasets import _info_and_validate as pinfo

    root, feats, alis, _, utt_ids = populate_data_dir(num_utts=5)
    args = dict(suppress_alis=False, tokens_only=False)
    jds, pds = jdata.SpectDataSet(root, **args), pdata.SpectDataSet(root, **args)
    assert pinfo(pds, True, True, None) == jinfo(jds, True, True, None)
    T = feats[2].shape[0]
    cases = [
        ("ali", 1, alis[1].astype(np.int32), "not a long"),
        ("ref", 2, np.asarray([[1, 0, T + 1]], np.int64), "exceeding"),
        ("ali", 3, np.concatenate([alis[3], [0]]).astype(np.int64), "first dimension"),
        ("feat", 4, np.zeros((3,), np.float32), "two dimensions"),
    ]
    for sub, i, bad, msg in cases:
        path = str(tmp_path / sub / (utt_ids[i] + ".pt"))
        good = jserial.load_tensor(path)
        fixed = []
        for pkg, ds, val in ((jdata, jds, None), (pdata, pds, None)):
            jserial.save_tensor(bad, path)
            with pytest.raises(ValueError, match=msg):
                pkg.validate_spect_data_set(ds)
            if sub != "feat":
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    pkg.validate_spect_data_set(ds, fix=1)
                fixed.append(jserial.load_tensor(path))
        if fixed:
            assert fixed[0].dtype == fixed[1].dtype
            np.testing.assert_array_equal(fixed[0], fixed[1])
        jserial.save_tensor(good, path)
    pdata.validate_spect_data_set(pds)
    jserial.save_tensor(np.asarray([-2, 1], np.int64), str(tmp_path / "ref" / (utt_ids[0] + ".pt")))
    with pytest.raises(ValueError, match="negative reference token"):
        pdata.validate_spect_data_set(pdata.SpectDataSet(root))


def test_sampler_streams_equal_jax_over_three_epochs():
    data = list(range(37))
    for seed in (0, 7, 2**31 - 1):
        js = jdata.EpochRandomSampler(data, base_seed=seed)
        ps = pdata.EpochRandomSampler(data, base_seed=seed)
        for _ in range(3):
            assert [int(i) for i in ps] == [int(i) for i in js]
    assert list(pdata.EpochSequentialSampler(data)) == list(jdata.EpochSequentialSampler(data))
    with pytest.raises(ValueError):
        pdata.EpochRandomSampler(data, base_seed=2**31)


def test_samplers_shard_by_torch_distributed_rank(monkeypatch):
    """Rank r of 3 takes every third sample from r, as in JAX; the union
    of the shards is the serial stream, and uneven sizes raise or drop."""
    data = list(range(12))
    serial = list(pdata.EpochRandomSampler(data, base_seed=5))
    dl = pdata.dataloaders
    shards = []
    for rank in range(3):
        monkeypatch.setattr(dl, "_dist_info", lambda r=rank: (r, 3))
        shards.append(list(pdata.EpochRandomSampler(data, base_seed=5)))
    assert [serial[r::3] for r in range(3)] == shards
    monkeypatch.setattr(dl, "_dist_info", lambda: (1, 5))
    with pytest.raises(ValueError, match="divisible"):
        pdata.EpochSequentialSampler(data)
    assert list(pdata.EpochSequentialSampler(data, on_uneven_distributed="drop")) == [1, 6]


def test_bucket_batches_equal_jax(populate_data_dir, seeded):
    root, *_ = populate_data_dir(num_utts=20, max_width=15)
    jds, pds = jdata.SpectDataSet(root), pdata.SpectDataSet(root)
    jdl = jdata.dataloaders
    pdl = pdata.dataloaders
    for dynamic in (False, True):
        jb = jdl._get_bucket_batch_sampler_params(jds, 3, 4, dynamic)
        pb = pdl._get_bucket_batch_sampler_params(pds, 3, 4, dynamic)
        assert jb == pb
        for drop in (False, True):
            js = jdata.BucketBatchSampler(jdata.EpochRandomSampler(jds, base_seed=3), *jb, drop)
            ps = pdata.BucketBatchSampler(pdata.EpochRandomSampler(pds, base_seed=3), *pb, drop)
            for _ in range(2):
                assert list(ps) == list(js)


@pytest.mark.parametrize("batch_first", [True, False])
def test_collates_equal_jax(batch_first):
    rng = np.random.RandomState(2)
    feats = [rng.randn(t, 3).astype(np.float32) for t in (5, 2, 7)]
    alis = [rng.randint(0, 9, (f.shape[0],)).astype(np.int64) for f in feats]
    refs = [rng.randint(0, 9, (r, 3)).astype(np.int64) for r in (2, 4, 1)]
    ids = ("a", "b", "c")
    for has_alis in (True, False):
        for has_uttids in (True, False):
            for pads in ({}, {"pad_to_multiple": 4}, {"feat_pad_to": 9, "ref_pad_to": 6}):
                seq = [
                    (f,) + ((a,) if has_alis else ()) + (r,) + ((u,) if has_uttids else ())
                    for f, a, r, u in zip(feats, alis, refs, ids)
                ]
                pseq = [tuple(torch.from_numpy(x) if isinstance(x, np.ndarray) else x for x in s) for s in seq]
                kw = dict(batch_first=batch_first, has_alis=has_alis, has_uttids=has_uttids, **pads)
                _assert_items_equal(
                    pdata.spect_seq_to_batch(pseq, **kw), jdata.spect_seq_to_batch(seq, **kw)
                )
    with pytest.raises(ValueError, match="exceeds"):
        pdata.spect_seq_to_batch([(torch.zeros(5, 1), None)], has_alis=False, feat_pad_to=3)
    lseq = [r[:, 0] for r in refs]
    for kw in ({}, {"ref_pad_to": 5}, {"pad_to_multiple": 3}):
        _assert_items_equal(
            pdata.lang_seq_to_batch([torch.from_numpy(r) for r in lseq], batch_first, **kw),
            jdata.lang_seq_to_batch(lseq, batch_first, **kw),
        )
    windows = [rng.randn(t, 3, 2).astype(np.float32) for t in (2, 4)]
    wseq = [(w, a[: w.shape[0]], u) for w, a, u in zip(windows, alis, ids)]
    _assert_items_equal(
        pdata.context_window_seq_to_batch(
            [(torch.from_numpy(w), torch.from_numpy(a), u) for w, a, u in wseq], has_uttids=True
        ),
        jdata.context_window_seq_to_batch(wseq, has_uttids=True),
    )


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loaders_yield_jax_batches(populate_data_dir, seeded, prefetch):
    """Two epochs of SpectDataLoader (shuffled, MVN, buckets), LangDataLoader
    and ContextWindowDataLoader on the CPU: every batch equal to JAX's (the
    MVN features within FTOL)."""
    root, *_ = populate_data_dir(num_utts=12, max_width=9)
    for p in (dict(batch_size=4, do_mvn=True), dict(batch_size=3, num_length_buckets=2)):
        for epoch in (0, 1):
            jl = jdata.SpectDataLoader(root, jdata.SpectDataLoaderParams(**p), seed=7, init_epoch=epoch)
            pl = pdata.SpectDataLoader(
                root, pdata.SpectDataLoaderParams(**p), seed=7, init_epoch=epoch,
                device="cpu", prefetch=prefetch,
            )
            jb, pb = list(jl), list(pl)
            assert len(pb) == len(jb) == len(pl)
            for a, b in zip(pb, jb):
                _assert_items_equal(a, b, FTOL if p.get("do_mvn") else 0.0)
    jl = jdata.LangDataLoader(os.path.join(root, "ref"), seed=1)
    pl = pdata.LangDataLoader(os.path.join(root, "ref"), seed=1, device="cpu", prefetch=prefetch)
    for a, b in zip(list(pl), list(jl)):
        _assert_items_equal(a, b)
    cp = dict(batch_size=5, context_left=1, context_right=2)
    jl = jdata.ContextWindowDataLoader(root, jdata.ContextWindowDataLoaderParams(**cp), seed=2)
    pl = pdata.ContextWindowDataLoader(
        root, pdata.ContextWindowDataLoaderParams(**cp), seed=2, device="cpu", prefetch=prefetch
    )
    for a, b in zip(list(pl), list(jl)):
        _assert_items_equal(a, b)


def test_loader_defaults_to_the_card(populate_data_dir, monkeypatch):
    root, *_ = populate_data_dir(num_utts=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pdata.SpectDataLoader(root)


def test_loader_prefetch_raises_the_workers_error(populate_data_dir):
    root, *_ = populate_data_dir(num_utts=4)

    class Broken(pdata.SpectDataSet):
        def __getitem__(self, idx):
            raise KeyError("broken item")

    loader = pdata.SpectDataLoader(Broken(root), device="cpu", prefetch=2)
    with pytest.raises(KeyError, match="broken item"):
        list(loader)


def test_data_module_splits_equal_jax(populate_data_dir, tmp_path, seeded):
    root, *_ = populate_data_dir(num_utts=6)
    info = str(tmp_path / "info.txt")
    with open(info, "w") as f:
        f.write("num_filts 5\nmax_ref_class 12\nmax_ali_class -1\n")
    for pkg in (jdm, pdm):
        with pytest.raises(ValueError):
            pkg.SpectDataModuleParams(common=pkg.SpectDataModuleParams.pclass(), train=pkg.SpectDataModuleParams.pclass()).params_for("train")
    mods = []
    for pkg, dkw in ((jdm, {}), (pdm, {"device": "cpu"})):
        mp = pkg.SpectDataModuleParams(train_dir=root, val_dir=root, test_dir=root, info_path=info)
        mp.initialize_missing()
        mp.train.batch_size = 2
        m = pkg.SpectDataModule(mp, batch_first=True, seed=4, **dkw)
        m.setup()
        mods.append(m)
    jm, pm = mods
    assert (pm.vocab_size, pm.num_filts, pm.max_ali_class) == (13, 5, None)
    assert (jm.vocab_size, jm.num_filts, jm.max_ali_class) == (13, 5, None)
    assert pm.batch_size == jm.batch_size == 2
    assert set(pm._datasets) == set(jm._datasets) == {"train", "val", "test", "predict"}
    assert pm.params.dir_for("predict") == root and pm.params.params_for("predict") is pm.params.test
    for stage in ("train", "val", "predict"):
        jb = list(getattr(jm, f"{stage}_dataloader")(1))
        pb = list(getattr(pm, f"{stage}_dataloader")(1))
        for a, b in zip(pb, jb):
            _assert_items_equal(a, b)
    import argparse

    parser = pdm.SpectDataModule.add_argparse_args(argparse.ArgumentParser())
    path = str(tmp_path / "dm.json")
    pdm.SpectDataModuleParams(val_dir="v").to_file(path)
    ns = parser.parse_args(["--read-data-json", path, "--train-dir", root])
    m = pdm.SpectDataModule.from_argparse_args(ns, device="cpu")
    assert m.params.train_dir == root and m.params.val_dir == "v"


def test_deprecated_aliases_warn_and_forward(populate_data_dir):
    root, *_ = populate_data_dir(num_utts=4)
    for name in ("DataSetParams", "SpectDataSetParams", "ContextWindowDataSetParams"):
        with pytest.warns(DeprecationWarning, match=name):
            p = getattr(pdata, name)()
        assert type(p).__name__ == type(getattr(jdata, name)()).__name__
    with pytest.warns(DeprecationWarning):
        loader = pdata.SpectEvaluationDataLoader(root, device="cpu")
    assert isinstance(loader, pdata.SpectDataLoader)
    assert len(next(iter(loader))) == 5  # with utterance ids
    with pytest.warns(DeprecationWarning):
        assert isinstance(pdata.SpectTrainingDataLoader(root, device="cpu"), pdata.SpectDataLoader)
    for name in ("ContextWindowTrainingDataLoader", "ContextWindowEvaluationDataLoader"):
        with pytest.warns(DeprecationWarning):
            assert isinstance(getattr(pdata, name)(root, device="cpu"), pdata.ContextWindowDataLoader)


def test_transcript_token_conversions_equal_jax():
    from pydrobert_tpu.data import parsing as jp
    from pydrobert_tpu_torch.data import parsing as pp

    tr = ["a", ("b", 0.1, 0.25), ("c", 0.3, 0.3), "zz"]
    t2i = {"a": 0, "b": 1, "c": 2, "<unk>": 9}
    for kw in ({"token2id": t2i, "unk": "<unk>", "frame_shift_ms": 10.0},
               {"token2id": t2i, "unk": "<unk>", "skip_frame_times": True}):
        got = pp.transcript_to_token(tr, **kw)
        np.testing.assert_array_equal(got.numpy(), jp.transcript_to_token(tr, **kw))
        i2t = {v: k for k, v in t2i.items()}
        assert pp.token_to_transcript(got, i2t, 10.0) == jp.token_to_transcript(got.numpy(), i2t, 10.0)

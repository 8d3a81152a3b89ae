"""PyTorch port, the image data pipeline: ``recordio`` (byte-compatible
with the JAX package both ways), ``image`` (decode, resize, crops, every
augmenter under a seed), ``image_detection``'s ``Det*Aug``,
``io.ImageRecordIter``/``ImageDetRecordIter`` (batches and labels,
mirroring included), ``ImageIter`` and ``gluon.data`` (samplers,
``DataLoader`` modes, datasets, the vision datasets and transforms), each
against its JAX twin on the same files and seeds.

Tolerances: bytes, labels, indices and uint8 images equal; float images
within 1e-5 of their largest entry (the same float32 arithmetic in
another order), resized float images within 1e-4 (``jax.image.resize``
against ``torch.nn.functional.interpolate``, both on the half-pixel grid,
antialiased alike when shrinking).
"""
import os
import random
import struct
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5
TOL_RESIZE = 1e-4


def _np(a):
    return a.asnumpy() if hasattr(a, "asnumpy") else np.asarray(a)


def _close(got, want, tol=TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want.astype("float64")).max()), 1e-30)
    err = float(np.abs(got.astype("float64") - want).max())
    assert err <= tol * scale, f"{err:.3e} of {scale:.3e}"


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _image(rs, h=20, w=28):
    img = rs.randint(0, 256, (h, w, 3)).astype("uint8")
    img[3:9, 5:15] = (200, 30, 90)
    return img


def _write(pkg, prefix, images, labels, fmt=".png"):
    rio = pkg.recordio
    rec = rio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    for i, (img, lab) in enumerate(zip(images, labels)):
        header = rio.IRHeader(0, lab, i, 0)
        rec.write_idx(i, rio.pack_img(header, img, quality=95, img_fmt=fmt))
    rec.close()
    return prefix + ".rec"


# ------------------------------------------------------------ recordio
def test_recordio_is_byte_compatible_both_ways(tmp_path, monkeypatch):
    _check_recordio(tmp_path)
    _check_image_codecs_need_pillow(monkeypatch)


def _check_recordio(tmp_path):
    """Records written by the port equal the JAX package's byte for byte
    (framing, header, label floats, padding, the .idx), and each package
    reads the other's: plain records, a record of odd length, a scalar and
    a vector label, a PNG image (lossless) and a JPEG."""
    rs = np.random.RandomState(0)
    imgs = [_image(rs) for _ in range(3)]
    for pkg, tag in ((jmx, "j"), (mx, "p")):
        rio = pkg.recordio
        w = rio.MXIndexedRecordIO(str(tmp_path / f"{tag}.idx"),
                                  str(tmp_path / f"{tag}.rec"), "w")
        w.write_idx(0, rio.pack(rio.IRHeader(0, 3.0, 7, 0), b"abcde"))
        w.write_idx(1, rio.pack(rio.IRHeader(0, [1.0, 2.5, -1.0], 8, 9),
                                b"xy"))
        w.write_idx(2, rio.pack_img(rio.IRHeader(0, 1.0, 9, 0), imgs[0],
                                    img_fmt=".png"))
        w.write_idx(3, rio.pack_img(rio.IRHeader(0, 2.0, 10, 0), imgs[1],
                                    quality=90))
        w.close()
    for ext in (".rec", ".idx"):
        assert (tmp_path / f"p{ext}").read_bytes() == \
            (tmp_path / f"j{ext}").read_bytes()
    for writer, reader in (("p", jmx), ("j", mx)):
        r = reader.recordio.MXIndexedRecordIO(str(tmp_path / f"{writer}.idx"),
                                              str(tmp_path / f"{writer}.rec"),
                                              "r")
        h, s = reader.recordio.unpack(r.read_idx(0))
        assert (h.flag, h.label, h.id, s) == (0, 3.0, 7, b"abcde")
        h, s = reader.recordio.unpack(r.read_idx(1))
        np.testing.assert_array_equal(h.label, [1.0, 2.5, -1.0])
        assert (h.flag, h.id, h.id2, s) == (3, 8, 9, b"xy")
        h, img = reader.recordio.unpack_img(r.read_idx(2))
        np.testing.assert_array_equal(img, imgs[0])
        _, jpg = reader.recordio.unpack_img(r.read_idx(3), iscolor=1)
        assert jpg.shape == imgs[1].shape
        r.close()
    seq = mx.recordio.MXRecordIO(str(tmp_path / "j.rec"), "r")
    assert [seq.read() is not None for _ in range(5)] == [True] * 4 + [False]


def _check_image_codecs_need_pillow(monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(mx.MXNetError, match="Pillow"):
        mx.recordio.pack_img(mx.recordio.IRHeader(0, 0.0, 0, 0),
                             np.zeros((2, 2, 3), "uint8"))
    with pytest.raises(mx.MXNetError, match="Pillow"):
        mx.image.imdecode(b"\x89PNG")


# ------------------------------------------------------------ image
def test_image_pipeline_matches_jax(tmp_path):
    """Decoding, resizing and the crops, every augmenter (plain and
    detection) under seeds, and the record iterators and ``ImageIter``."""
    _check_decode_resize_crops_and_normalize(tmp_path)
    _cases(_check_create_augmenter, AUGMENTER_CASES)
    _check_detection_augmenters()
    _cases(lambda cid, kw: _check_image_det_record_iter(tmp_path / cid, kw),
           [(cid, cid, kw) for cid, kw in DET_ITER_CASES])
    _check_image_record_iter_and_image_iter(tmp_path)


def _cases(check, cases):
    """``check`` on each case in turn; a failure names its case."""
    for cid, *args in cases:
        try:
            check(*args)
        except AssertionError as e:
            raise AssertionError(f"case {cid}: {e}") from e


def _check_decode_resize_crops_and_normalize(tmp_path):
    rs = np.random.RandomState(1)
    img = _image(rs, 24, 30)
    buf = mx.recordio.unpack(mx.recordio.pack_img(
        mx.recordio.IRHeader(0, 0.0, 0, 0), img, img_fmt=".png"))[1]
    (tmp_path / "a.png").write_bytes(buf)
    for flag, rgb in ((1, True), (1, False), (0, True)):
        got = mx.image.imdecode(buf, flag, rgb)
        assert got.context == mx.cpu() and got.dtype == np.uint8
        np.testing.assert_array_equal(_np(got),
                                      _np(jmx.image.imdecode(buf, flag, rgb)))
    p = mx.image.imread(str(tmp_path / "a.png"))
    j = jmx.image.imread(str(tmp_path / "a.png"))
    np.testing.assert_array_equal(_np(p), img)
    for interp in (0, 1, 2):                        # uint8: Pillow in both
        np.testing.assert_array_equal(_np(mx.image.imresize(p, 17, 11,
                                                            interp)),
                                      _np(jmx.image.imresize(j, 17, 11,
                                                             interp)))
    pf, jf = p.astype("float32"), j.astype("float32")
    for (w, h), interp in (((17, 11), 1), ((45, 40), 1), ((13, 30), 0),
                           ((60, 12), 1)):
        _close(mx.image.imresize(pf, w, h, interp),
               jmx.image.imresize(jf, w, h, interp), TOL_RESIZE)
    np.testing.assert_array_equal(_np(mx.image.resize_short(p, 16)),
                                  _np(jmx.image.resize_short(j, 16)))
    np.testing.assert_array_equal(
        _np(mx.image.fixed_crop(p, 3, 4, 10, 8, size=(6, 5))),
        _np(jmx.image.fixed_crop(j, 3, 4, 10, 8, size=(6, 5))))
    for fn in ("center_crop", "random_crop"):
        _seed(2)
        got, box = getattr(mx.image, fn)(p, (12, 9))
        _seed(2)
        want, jbox = getattr(jmx.image, fn)(j, (12, 9))
        assert box == jbox
        np.testing.assert_array_equal(_np(got), _np(want))
    _close(mx.image.color_normalize(p, np.array([120.0, 110.0, 100.0]),
                                    np.array([60.0, 50.0, 40.0])),
           jmx.image.color_normalize(j, jmx.nd.array([120.0, 110.0, 100.0]),
                                     jmx.nd.array([60.0, 50.0, 40.0])))


def _run_augs(augs, src, seed):
    _seed(seed)
    out = src
    for a in augs:
        out = a(out)
    return _np(out)


AUGMENTER_CASES = [
    ("every_augmenter", dict(resize=26, rand_crop=True, rand_mirror=True,
                             brightness=0.3, contrast=0.3, saturation=0.3,
                             hue=0.2, rand_gray=0.5, pca_noise=0.1,
                             mean=True, std=True)),
    ("center_crop", dict(rand_mirror=True,
                         mean=np.array([100.0, 90.0, 80.0]),
                         brightness=0.5)),
]


def _check_create_augmenter(kwargs):
    """``CreateAugmenter``'s list, run on the same image after the same
    seeds of ``random`` and ``np.random``, gives the JAX list's image in
    each of five draws (every augmenter; ``RandomOrderAug`` apart)."""
    img = _image(np.random.RandomState(3), 30, 34)
    shape = (3, 20, 22)
    paugs = mx.image.CreateAugmenter(shape, **kwargs)
    jaugs = jmx.image.CreateAugmenter(shape, **kwargs)
    assert [type(a).__name__ for a in paugs] == \
        [type(a).__name__ for a in jaugs]
    p = mx.nd.array(img, ctx=mx.cpu(), dtype="uint8")
    j = jmx.nd.array(img, dtype="uint8")
    for s in range(5):
        _close(_run_augs(paugs, p, s), _run_augs(jaugs, j, s))
    order = [mx.image.BrightnessJitterAug(0.4), mx.image.CastAug("float32"),
             mx.image.RandomGrayAug(1.0)]
    jorder = [jmx.image.BrightnessJitterAug(0.4),
              jmx.image.CastAug("float32"), jmx.image.RandomGrayAug(1.0)]
    _close(_run_augs([mx.image.RandomOrderAug(order)], p.astype("float32"),
                     9),
           _run_augs([jmx.image.RandomOrderAug(jorder)],
                     j.astype("float32"), 9))


def _check_detection_augmenters():
    """``CreateDetAugmenter`` (IoU-constrained crop, pad, mirror, resize,
    color) moves the boxes with the pixels as the JAX list does: images
    and −1 padded labels equal over six seeds."""
    img = _image(np.random.RandomState(4), 32, 40)
    label = np.full((4, 5), -1.0, "float32")
    label[0] = (1, 0.1, 0.2, 0.5, 0.6)
    label[1] = (0, 0.55, 0.3, 0.9, 0.95)
    kw = dict(rand_crop=1.0, rand_pad=0.5, rand_mirror=True,
              brightness=0.2, mean=True, std=True, area_range=(0.3, 2.0))
    paugs = mx.image.CreateDetAugmenter((3, 24, 24), **kw)
    jaugs = jmx.image.CreateDetAugmenter((3, 24, 24), **kw)
    p = mx.nd.array(img, ctx=mx.cpu(), dtype="uint8")
    j = jmx.nd.array(img, dtype="uint8")
    moved = 0
    for s in range(6):
        _seed(s)
        pi, pl = p, label
        for a in paugs:
            pi, pl = a(pi, pl)
        _seed(s)
        ji, jl = j, label
        for a in jaugs:
            ji, jl = a(ji, jl)
        _close(pi, ji)
        np.testing.assert_allclose(pl, jl, rtol=0, atol=1e-6)
        moved += not np.array_equal(pl, label)
    assert moved


# ------------------------------------------------------------ iterators
def _det_records(tmp_path, n=10):
    tmp_path.mkdir(exist_ok=True)
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                    "example", "ssd"))
    import dataset_torch
    return dataset_torch.write_records(str(tmp_path / "det"), num_images=n,
                                       size=32, seed=3)


DET_ITER_CASES = [
    ("mirror_shuffle", dict(rand_mirror=True, shuffle=True, seed=5)),
    ("normalize_max_objs", dict(mean_r=120.0, std_g=50.0, scale=0.5,
                                max_objs=2)),
]


def _check_image_det_record_iter(tmp_path, kw):
    """Batches of the records ``dataset_torch.py`` writes: data (B, 3, H,
    W) and labels (B, max_objs, 5) padded with −1, mirrored boxes
    included, equal to the JAX iterator's over two epochs (its last batch
    padded), on the iterator's context. One decode thread: the mirror
    draws from numpy's global stream, in the order the threads reach it
    (in both packages)."""
    rec = _det_records(tmp_path)
    kw = dict(kw)
    max_objs = kw.pop("max_objs", 4)
    args = dict(data_shape=(3, 24, 24), batch_size=4, max_objs=max_objs,
                preprocess_threads=1, **kw)
    pit = mx.io.ImageDetRecordIter(rec, ctx=mx.cpu(), **args)
    jit = jmx.io.ImageDetRecordIter(rec, **args)
    assert pit.provide_label[0].shape == (4, max_objs, 5)
    assert pit.provide_label[0].name == "label"
    epochs = []
    for epoch in range(2):
        _seed(epoch)
        pb = list(pit)
        _seed(epoch)
        jb = list(jit)
        assert [b.pad for b in pb] == [b.pad for b in jb] == [0, 0, 2]
        for a, b in zip(pb, jb):
            assert a.data[0].context == mx.cpu()
            _close(a.data[0], b.data[0])
            np.testing.assert_array_equal(_np(a.label[0]), _np(b.label[0]))
        pit.reset()
        jit.reset()
        epochs.append(pb)
    lab = _np(epochs[0][0].label[0])
    assert (lab[lab[:, :, 0] < 0] == -1).all()
    if args.get("rand_mirror"):     # the boxes of mirrored images moved
        plain = mx.io.ImageDetRecordIter(rec, ctx=mx.cpu(),
                                         **dict(args, rand_mirror=False))
        mirrored = 0
        for a, b in zip(epochs[0], plain):
            la, lb = _np(a.label[0]), _np(b.label[0])
            np.testing.assert_array_equal(la[..., [0, 2, 4]],
                                          lb[..., [0, 2, 4]])
            moved = (la[..., 1] != lb[..., 1]) & (lb[..., 0] >= 0)
            np.testing.assert_allclose(la[..., 1][moved],
                                       1 - lb[..., 3][moved], atol=1e-6)
            mirrored += int(moved.sum())
        assert mirrored > 0


def _check_image_record_iter_and_image_iter(tmp_path):
    """The classification iterator (resize, random crop, mirror, scalar
    labels, a sequential reader where there is no .idx) and ``ImageIter``
    over a .lst of image files and over the .rec, against the JAX ones;
    ``state``/``set_state`` resume mid-epoch."""
    rs = np.random.RandomState(6)
    images = [_image(rs, 22 + i, 30 - i) for i in range(6)]
    rec = _write(mx, str(tmp_path / "cls"), images,
                 [float(i % 3) for i in range(6)])
    args = dict(data_shape=(3, 16, 16), batch_size=4, resize=20,
                rand_crop=True, rand_mirror=True, shuffle=True, seed=2,
                preprocess_threads=1)
    pit = mx.io.ImageRecordIter(rec, ctx=mx.cpu(), **args)
    jit = jmx.io.ImageRecordIter(rec, **args)
    for _ in range(2):
        _seed(8)
        pb = list(pit)
        _seed(8)
        jb = list(jit)
        for a, b in zip(pb, jb):
            _close(a.data[0], b.data[0])
            np.testing.assert_array_equal(_np(a.label[0]), _np(b.label[0]))
        pit.reset()
        jit.reset()
    pit.next()
    state = pit.state()
    nxt = pit.next()
    again = mx.io.ImageRecordIter(rec, ctx=mx.cpu(), **args)
    again.set_state(state)
    assert again.state() == state
    np.testing.assert_array_equal(_np(again.next().label[0]),
                                  _np(nxt.label[0]))
    os.remove(str(tmp_path / "cls.idx"))
    seq = mx.io.ImageRecordIter(rec, data_shape=(3, 16, 16), batch_size=4,
                                ctx=mx.cpu())
    jseq = jmx.io.ImageRecordIter(rec, data_shape=(3, 16, 16), batch_size=4)
    for a, b in zip(seq, jseq):
        _close(a.data[0], b.data[0])

    lst = tmp_path / "imgs.lst"
    with open(lst, "w") as f:
        for i, img in enumerate(images):
            name = f"im{i}.png"
            (tmp_path / name).write_bytes(mx.recordio.unpack(
                mx.recordio.pack_img(mx.recordio.IRHeader(0, 0.0, 0, 0), img,
                                     img_fmt=".png"))[1])
            f.write(f"{i}\t{i % 2}\t{name}\n")
    for kw in (dict(path_imglist=str(lst), path_root=str(tmp_path),
                    rand_crop=True, rand_mirror=True),
               dict(path_imgrec=rec)):
        _seed(1)
        pb = list(mx.image.ImageIter(4, (3, 16, 16), ctx=mx.cpu(), **kw))
        _seed(1)
        jb = list(jmx.image.ImageIter(4, (3, 16, 16), **kw))
        assert len(pb) == len(jb) == 2 and pb[-1].pad == jb[-1].pad
        for a, b in zip(pb, jb):
            _close(a.data[0], b.data[0])
            np.testing.assert_array_equal(_np(a.label[0]), _np(b.label[0]))


# ------------------------------------------------------------ gluon.data
def test_gluon_data_matches_jax(tmp_path):
    """Samplers and ``DataLoader`` in each ``last_batch`` mode, datasets
    and ``pin_memory``, the vision datasets and the transforms."""
    _cases(_check_samplers_and_dataloader,
           [(m, m) for m in ("keep", "discard", "rollover")])
    (tmp_path / "datasets").mkdir()
    _check_datasets_and_pin_memory(tmp_path / "datasets")
    _cases(lambda name, make: _check_vision_dataset(
        tmp_path / f"{name}-{make}", name, make), VISION_CASES)
    _check_vision_transforms()


def _check_samplers_and_dataloader(last_batch):
    """``BatchSampler`` over a sequential and a seeded random sampler
    (two passes, rollover carrying its tail), and ``DataLoader`` over an
    ``ArrayDataset`` with each ``last_batch`` mode, shuffled, threaded
    (``num_workers=2``) and with a custom ``batchify_fn``."""
    gd, jgd = mx.gluon.data, jmx.gluon.data
    for samp, jsamp in ((gd.SequentialSampler(10), jgd.SequentialSampler(10)),
                        (gd.RandomSampler(10), jgd.RandomSampler(10))):
        bs = gd.BatchSampler(samp, 3, last_batch)
        jbs = jgd.BatchSampler(jsamp, 3, last_batch)
        for s in range(2):
            np.random.seed(s)
            got = list(bs)
            np.random.seed(s)
            assert got == list(jbs)
            assert len(bs) == len(jbs)
    x = np.arange(22, dtype="float32").reshape(11, 2)
    y = np.arange(11) % 3
    pds, jds = gd.ArrayDataset(x, y), jgd.ArrayDataset(x, y)
    assert len(pds) == 11
    for kw in (dict(), dict(shuffle=True), dict(num_workers=2, prefetch=1),
               dict(batchify_fn=lambda b: [s[1] for s in b])):
        np.random.seed(4)
        got = list(gd.DataLoader(pds, batch_size=4, last_batch=last_batch,
                                 **kw))
        np.random.seed(4)
        want = list(jgd.DataLoader(jds, batch_size=4, last_batch=last_batch,
                                   **kw))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if isinstance(a, list):
                assert [int(_np(v)) for v in a] == [int(_np(v)) for v in b]
                continue
            assert a[0].context == mx.cpu()
            np.testing.assert_array_equal(_np(a[0]), _np(b[0]))
            np.testing.assert_array_equal(_np(a[1]), _np(b[1]))


def _check_datasets_and_pin_memory(tmp_path):
    """``SimpleDataset``, ``transform``/``transform_first`` (lazy and not),
    ``filter``, ``take`` and ``RecordFileDataset`` against the JAX ones;
    ``pin_memory=True`` asks for page-locked memory, which needs CUDA."""
    gd, jgd = mx.gluon.data, jmx.gluon.data
    pairs = [(i, i * 10) for i in range(6)]
    for lazy in (True, False):
        p = gd.SimpleDataset(pairs).transform_first(lambda a: a + 1, lazy)
        j = jgd.SimpleDataset(pairs).transform_first(lambda a: a + 1, lazy)
        assert [p[i] for i in range(6)] == [j[i] for i in range(6)]
        p = gd.SimpleDataset(pairs).transform(lambda a, b: a * b, lazy)
        assert [p[i] for i in range(6)] == [a * b for a, b in pairs]
    odd = gd.SimpleDataset(list(range(7))).filter(lambda v: v % 2)
    assert [odd[i] for i in range(len(odd))] == [1, 3, 5]
    assert len(gd.SimpleDataset(list(range(7))).take(3)) == 3
    rec = _write(jmx, str(tmp_path / "r"), [_image(np.random.RandomState(0),
                                                   8, 8)] * 3, [0.0, 1.0, 2.0])
    prd, jrd = gd.RecordFileDataset(rec), jgd.RecordFileDataset(rec)
    assert len(prd) == 3 and [prd[i] for i in range(3)] == \
        [jrd[i] for i in range(3)]
    if torch.cuda.is_available():
        batch = next(iter(gd.DataLoader(gd.ArrayDataset(np.ones((4, 2))),
                                        batch_size=2, pin_memory=True)))
        assert batch._data.is_pinned()
    else:
        with pytest.raises(mx.MXNetError, match="CUDA"):
            gd.DataLoader(gd.ArrayDataset(np.ones((4, 2))), batch_size=2,
                          pin_memory=True)


def _write_mnist(root, n=5):
    rs = np.random.RandomState(9)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "train-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28))
        f.write(rs.randint(0, 256, (n, 28, 28)).astype("uint8").tobytes())
    with open(os.path.join(root, "train-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(rs.randint(0, 10, n).astype("uint8").tobytes())


def _write_cifar(root, names, row, n=4):
    rs = np.random.RandomState(10)
    os.makedirs(root, exist_ok=True)
    for name in names:
        rs.randint(0, 100, (n, row)).astype("uint8").tofile(
            os.path.join(root, name))


VISION_CASES = [
    ("mnist_synth", "MNIST", None), ("fashion_synth", "FashionMNIST", None),
    ("cifar10_synth", "CIFAR10", None), ("cifar100_synth", "CIFAR100", None),
    ("mnist_files", "MNIST", "mnist"), ("cifar10_files", "CIFAR10", "cifar10"),
    ("cifar100_files", "CIFAR100", "cifar100"),
]


def _check_vision_dataset(tmp_path, name, make):
    """The synthetic stand-in where the files are missing (the JAX
    package's seeds, so the same images and labels), and files in the
    reference's formats where they are there; ``synthetic=False`` without
    files raises in both. ``CIFAR100`` reads its files with CIFAR-10's row
    width (its class count is set after the read), so its own 3,074-byte
    rows fail to load in the JAX package; the port follows (ROADMAP C)."""
    root = str(tmp_path / name)
    if make == "mnist":
        _write_mnist(root)
    elif make == "cifar10":
        _write_cifar(root, [f"data_batch_{i}.bin" for i in range(1, 6)],
                     3073)
    elif make == "cifar100":
        _write_cifar(root, ["train.bin"], 3074)
        for pkg in (mx, jmx):
            with pytest.raises(ValueError, match="reshape"):
                pkg.gluon.data.vision.CIFAR100(root=root)
        return
    kw = {} if make else dict(synthetic_size=6)
    p = getattr(mx.gluon.data.vision, name)(root=root, **kw)
    j = getattr(jmx.gluon.data.vision, name)(root=root, **kw)
    assert len(p) == len(j)
    for i in (0, len(p) - 1):
        (pi, pl), (ji, jl) = p[i], j[i]
        assert pi.dtype == np.uint8 and pi.context == mx.cpu()
        np.testing.assert_array_equal(_np(pi), _np(ji))
        assert int(pl) == int(jl)
    if not make:
        for pkg in (mx, jmx):
            with pytest.raises(FileNotFoundError):
                getattr(pkg.gluon.data.vision, name)(
                    root=str(tmp_path / "none"), synthetic=False)


def _check_vision_transforms():
    """Each transform on the same HWC image after the same numpy seed:
    ``Compose`` of ``Cast``, ``ToTensor`` and ``Normalize``; ``Resize``
    down and up (uint8 and float); ``CenterCrop``; ``RandomResizedCrop``;
    the flips and the color jitters. A resized uint8 image is its float
    result truncated, so a value within rounding of an integer may land one
    level apart (``TRUNC``)."""
    T, JT = mx.gluon.data.vision.transforms, jmx.gluon.data.vision.transforms
    img = _image(np.random.RandomState(12), 26, 30)
    p = mx.nd.array(img, ctx=mx.cpu(), dtype="uint8")
    j = jmx.nd.array(img, dtype="uint8")
    cases = [
        (lambda t: t.Compose([t.Cast("float32"), t.ToTensor(),
                              t.Normalize((0.4, 0.5, 0.6), (0.2, 0.3, 0.25))]),
         TOL, "uint8"),
        (lambda t: t.Compose([t.ToTensor(), t.Normalize(0.5, 0.25)]),
         TOL, "uint8"),
        (lambda t: t.Resize(12), "TRUNC", "uint8"),
        (lambda t: t.Resize((40, 33)), "TRUNC", "uint8"),
        (lambda t: t.Resize((17, 11)), TOL_RESIZE, "float32"),
        (lambda t: t.Resize((40, 33)), TOL_RESIZE, "float32"),
        (lambda t: t.CenterCrop((12, 14)), None, "uint8"),
        (lambda t: t.RandomResizedCrop(10), "TRUNC", "uint8"),
        (lambda t: t.RandomFlipLeftRight(), None, "uint8"),
        (lambda t: t.RandomFlipTopBottom(), None, "uint8"),
        (lambda t: t.RandomBrightness(0.4), TOL, "float32"),
        (lambda t: t.RandomContrast(0.4), TOL, "float32"),
        (lambda t: t.RandomSaturation(0.4), TOL, "float32"),
    ]
    for make, tol, dtype in cases:
        for s in range(2):
            np.random.seed(s)
            got = make(T)(p.astype(dtype))
            np.random.seed(s)
            want = make(JT)(j.astype(dtype))
            if tol is None:
                np.testing.assert_array_equal(_np(got), _np(want))
            elif tol == "TRUNC":
                diff = np.abs(_np(got).astype(int) - _np(want).astype(int))
                assert diff.max() <= 1
            else:
                _close(got, want, tol)

"""The port's data pipeline against the JAX package's, on the CPU.

- ``data/native.py`` (Python chunk parse + zlib, ``csrc/stereo_decode.cc``
  built by g++): ``decode_resize_batch`` equals the JAX native backend
  (libpng, ``native/stereo_loader.cc``) bit for bit, and PIL's
  ``Image.BILINEAR`` within its rounding (1/255 + 1e-6); every row filter
  type and colour type (gray 1-16 bit, palette 1-8 bit, RGB, gray +
  alpha, RGBA, 16-bit RGB) decodes to what libpng, PIL and a numpy model
  of the expansion give, and transparency (tRNS) is dropped; missing,
  interlaced, truncated and corrupt files (a bad chunk CRC, damaged image
  data) raise ``IOError`` naming the file.
- ``data/datasets.py``: the same pairs as the JAX datasets, with and
  without ``parity_quirks``, on trees with unmatched names.
- ``data/transforms.py``: the same generator gives the same outputs as the
  JAX transforms.
- ``data/loader.py``: the same batches as the JAX ``DataLoader`` on its
  native backend for the same seed, epoch, shuffle, shards, ``drop_last``
  and augmentation (bit for bit; the bound asked is 1e-6), and a worker's
  error raised in the consumer.

PNG trees are written to temporary directories by the port's own writer
(``utils/viz.py::save_image``), by PIL, and by a writer here that sets
each row's filter type.
"""

import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from uncertainty_model_tpu import data as jdata
from uncertainty_model_tpu.data import native as jnative
from uncertainty_model_tpu_torch import data as tdata
from uncertainty_model_tpu_torch.data import native as tnative
from uncertainty_model_tpu_torch.utils.viz import save_image

PIL_TOL = 1.0 / 255.0 + 1e-6     # PIL rounds to uint8 between its passes
LOADER_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def jax_native_built():
    if not jnative.native_available():
        pytest.fail("the JAX native loader (make -C native) did not build")


# ---------------------------------------------------------------------------
# a PNG writer that chooses each row's filter type
# ---------------------------------------------------------------------------


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """``rows`` (H, rowbytes) uint8, filtered row y by ``filters[y % 5]``."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        f = filters[y % len(filters)]
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = [0, left, prev, (left + prev) // 2,
                _paeth(left, prev, upleft)][f]
        out.append(bytes([f]) + ((row - pred) % 256).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def write_png(path, samples: np.ndarray, bit_depth: int, colour: int,
              filters=(0, 1, 2, 3, 4), palette=None, trns=None,
              interlace=0, idat_pieces=3) -> str:
    """``samples`` (H, W, channels) of ints < 2**bit_depth, written with
    the given row filters, the IDAT stream cut into ``idat_pieces``
    chunks."""
    h, w, ch = samples.shape
    if bit_depth == 16:
        rows = samples.astype(">u2").reshape(h, w * ch).view(np.uint8)
    elif bit_depth == 8:
        rows = samples.astype(np.uint8).reshape(h, w * ch)
    else:
        rows = np.packbits(np.unpackbits(
            samples.astype(np.uint8).reshape(h, w, 1), axis=2)[..., -bit_depth:]
            .reshape(h, w * bit_depth), axis=1)
    bpp = max(1, ch * bit_depth // 8)
    stream = zlib.compress(_filter_rows(rows, bpp, filters))
    cut = np.linspace(0, len(stream), idat_pieces + 1).astype(int)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bit_depth, colour,
                                       0, 0, interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        body += _chunk(b"tRNS", trns)
    body += _chunk(b"tEXt", b"Comment\x00an ancillary chunk")
    for a, b in zip(cut[:-1], cut[1:]):
        body += _chunk(b"IDAT", stream[a:b])
    with open(path, "wb") as f:
        f.write(tnative.PNG_SIGNATURE + body + _chunk(b"IEND", b""))
    return str(path)


def _expand(samples, bit_depth, colour, palette=None):
    """numpy model of libpng's expansion to 8-bit RGB."""
    s = samples.astype(np.int64)
    if colour == 3:
        return palette[s[..., 0]].astype(np.uint8)
    if bit_depth == 16:
        s = s >> 8
    elif bit_depth < 8:
        s = s * (255 // (2 ** bit_depth - 1))
    if colour in (0, 4):
        s = np.repeat(s[..., :1], 3, axis=2)
    return s[..., :3].astype(np.uint8)


# (name, bit depth, colour type, channels)
COLOUR_CASES = [
    ("gray1", 1, 0, 1), ("gray2", 2, 0, 1), ("gray4", 4, 0, 1),
    ("gray8", 8, 0, 1), ("gray16", 16, 0, 1),
    ("rgb8", 8, 2, 3), ("rgb16", 16, 2, 3),
    ("palette1", 1, 3, 1), ("palette2", 2, 3, 1), ("palette4", 4, 3, 1),
    ("palette8", 8, 3, 1),
    ("gray_alpha8", 8, 4, 2), ("gray_alpha16", 16, 4, 2),
    ("rgba8", 8, 6, 4), ("rgba16", 16, 6, 4),
]


def _colour_file(path, case, rng, trns=False):
    """(path, expected RGB8) of a 23x37 file of ``case`` (odd widths leave
    partial bytes at 1-4 bits), every filter type; ``trns``: with a tRNS
    chunk (transparency, which the RGB output drops)."""
    _, depth, colour, ch = case
    samples = rng.integers(0, 2 ** depth, (23, 37, ch))
    palette = full = chunk = None
    if colour == 3:
        n = min(2 ** depth, 200)
        palette = rng.integers(0, 256, (n, 3))
        samples = rng.integers(0, n, (23, 37, 1))
        full = np.zeros((256, 3), np.int64)
        full[:n] = palette
        chunk = bytes(rng.integers(0, 256, min(n, 3)).astype(np.uint8))
    elif colour in (0, 2):
        chunk = struct.pack(">" + "H" * ch, *rng.integers(0, 2 ** depth, ch))
    want = _expand(samples, depth, colour, full)
    return write_png(path, samples, depth, colour, palette=palette,
                     trns=chunk if trns else None), want


@pytest.fixture(scope="module")
def colour_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("colour")
    rng = np.random.default_rng(3)
    return {case[0]: _colour_file(d / f"{case[0]}.png", case, rng)
            for case in COLOUR_CASES}


@pytest.fixture(scope="module")
def rgb_files(tmp_path_factory):
    """96x192 RGB noise: 3 files by the port's writer, 3 by PIL."""
    d = tmp_path_factory.mktemp("rgb")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(6):
        arr = rng.integers(0, 256, (96, 192, 3), np.uint8)
        p = str(d / f"{i}.png")
        if i % 2:
            Image.fromarray(arr).save(p)
        else:
            save_image(arr / 255.0, p)
        paths.append(p)
    return paths


# ---------------------------------------------------------------------------
# decode and resize
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [(48, 96), (96, 192), (64, 100), (200, 300),
                                  (7, 13)])
def test_decode_resize_equals_jax_native(rgb_files, size):
    """Bit for bit: the same triangle coefficients and double sums."""
    got = tnative.decode_resize_batch(rgb_files, *size, num_threads=3)
    want = jnative.decode_resize_batch(rgb_files, *size, num_threads=3)
    assert got.dtype == np.float32 and got.shape == (6, *size, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", [(48, 96), (96, 192), (64, 100)])
def test_decode_resize_near_pil_bilinear(rgb_files, size):
    h, w = size
    got = tnative.decode_resize_batch(rgb_files, h, w, num_threads=2)
    want = np.stack([
        np.asarray(Image.open(p).convert("RGB").resize((w, h), Image.BILINEAR),
                   np.float32) / 255.0 for p in rgb_files])
    assert np.abs(got - want).max() <= PIL_TOL


def test_decode_png_equals_pil(rgb_files):
    for p in rgb_files:
        np.testing.assert_array_equal(tnative.decode_png(p),
                                      np.asarray(Image.open(p).convert("RGB")))


@pytest.mark.parametrize("case", [c[0] for c in COLOUR_CASES])
def test_colour_types(colour_files, case):
    """Each colour type and bit depth: the pixels equal the numpy model of
    libpng's expansion, and at their own size (where the resize is the
    identity, v / 255) and at a downscale the floats equal the JAX native
    backend's; 8-bit types also equal PIL's ``convert("RGB")``."""
    path, want = colour_files[case]
    got = tnative.decode_png(path)
    np.testing.assert_array_equal(got, want)
    for size in [want.shape[:2], (11, 17)]:
        np.testing.assert_array_equal(
            tnative.decode_resize_batch([path], *size),
            jnative.decode_resize_batch([path], *size))
    if "16" not in case:
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("case", [c for c in COLOUR_CASES if c[2] in (0, 2, 3)],
                         ids=lambda c: c[0])
def test_transparency_is_dropped(tmp_path, case):
    """Gray, RGB and palette files with a tRNS chunk: the RGB pixels, as
    PIL's ``convert("RGB")`` gives them.  (The JAX native backend is not
    asked: it expands tRNS to an alpha channel that it then does not strip,
    and writes 4 channels into its 3-channel rows.)"""
    path, want = _colour_file(tmp_path / "t.png", case,
                              np.random.default_rng(6), trns=True)
    got = tnative.decode_png(path)
    np.testing.assert_array_equal(got, want)
    if case[1] != 16:
        np.testing.assert_array_equal(
            got, np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,)])
def test_each_filter_type(tmp_path, filters):
    rng = np.random.default_rng(4)
    samples = rng.integers(0, 256, (9, 13, 3))
    path = write_png(tmp_path / "f.png", samples, 8, 2, filters=filters)
    np.testing.assert_array_equal(tnative.decode_png(path),
                                  samples.astype(np.uint8))


def test_resize_rgb8_equals_fused_path(rgb_files):
    for p in rgb_files[:2]:
        np.testing.assert_array_equal(
            tnative.resize_rgb8(tnative.decode_png(p), 40, 70),
            tnative.decode_resize_batch([p], 40, 70)[0])


def _bad_files(tmp_path, good):
    blob = open(good, "rb").read()
    files = {}
    # interlace byte of IHDR (offset 8 + 8 + 12), with its CRC fixed
    ihdr = bytearray(blob[8:33])
    ihdr[20] = 1
    ihdr[21:25] = struct.pack(">I", zlib.crc32(bytes(ihdr[4:21])) & 0xFFFFFFFF)
    files["interlaced"] = blob[:8] + bytes(ihdr) + blob[33:]
    files["truncated"] = blob[:len(blob) // 2]
    corrupt = bytearray(blob)
    corrupt[30] ^= 0xFF  # IHDR's CRC
    files["CRC error"] = bytes(corrupt)
    corrupt = bytearray(blob)
    corrupt[60] ^= 0xFF  # inside the first IDAT: zlib's checks catch it
    files["corrupt image data"] = bytes(corrupt)
    files["not a PNG"] = b"GIF89a" + blob[6:]
    out = {}
    for reason, data in files.items():
        path = str(tmp_path / f"{reason.replace(' ', '_')}.png")
        with open(path, "wb") as f:
            f.write(data)
        out[reason] = path
    return out


def test_missing_file_raises(rgb_files):
    with pytest.raises(IOError, match="/nonexistent.png"):
        tnative.decode_resize_batch([rgb_files[0], "/nonexistent.png"], 16, 16)


def test_bad_files_raise_naming_them(tmp_path, rgb_files):
    bad = _bad_files(tmp_path, rgb_files[0])
    for reason, path in bad.items():
        with pytest.raises(IOError) as info:
            tnative.decode_resize_batch([rgb_files[1], path], 16, 16)
        assert path in str(info.value)
        assert reason.split()[0].lower() in str(info.value).lower(), reason
    # the first failing file in the order given
    paths = [rgb_files[0], bad["truncated"], bad["interlaced"]]
    with pytest.raises(IOError, match=bad["truncated"]):
        tnative.decode_resize_batch(paths, 16, 16, num_threads=3)


def test_short_image_data_raises(tmp_path):
    """A stream that inflates to fewer bytes than the rows need."""
    rng = np.random.default_rng(5)
    path = write_png(tmp_path / "short.png", rng.integers(0, 256, (8, 8, 3)),
                     8, 2)
    blob = open(path, "rb").read()
    stream = zlib.compress(b"\x00" * 10)
    start = blob.index(b"IHDR") + 4 + 13 + 4
    ihdr_part = blob[:start]
    data = ihdr_part + _chunk(b"IDAT", stream) + _chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(IOError, match="fewer image bytes"):
        tnative.decode_png(path)


def test_oversized_header_raises_before_allocating(tmp_path):
    """A header of 1e6 x 1e6 pixels over a few bytes of image data raises
    ``IOError`` naming the file, without allocating the header's size."""
    rng = np.random.default_rng(6)
    path = write_png(tmp_path / "huge.png", rng.integers(0, 256, (8, 8, 3)),
                     8, 2)
    blob = open(path, "rb").read()
    start = blob.index(b"IHDR") - 4
    end = start + 12 + 13
    header = struct.pack(">IIBBBBB", 1_000_000, 1_000_000, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(blob[:start] + _chunk(b"IHDR", header) + blob[end:])
    for call in (lambda: tnative.decode_png(path),
                 lambda: tnative.decode_resize_batch([path], 16, 16)):
        with pytest.raises(IOError, match="fewer image bytes") as info:
            call()
        assert str(path) in str(info.value)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


def _noise_png(path, rng, shape=(24, 40)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save_image(rng.uniform(size=(*shape, 3)), path)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """da Vinci (names out of glob order, unmatched on both sides), SCARED
    and CityScapes trees."""
    root = tmp_path_factory.mktemp("trees")
    rng = np.random.default_rng(1)
    dv = root / "davinci"
    for split, names in (("train", ["010", "003", "007", "001", "005"]),
                         ("test", ["002", "000"])):
        for side in ("image_0", "image_1"):
            for n in names:
                _noise_png(str(dv / split / side / f"{n}.png"), rng)
    _noise_png(str(dv / "train" / "image_0" / "999.png"), rng)
    _noise_png(str(dv / "train" / "image_1" / "998.png"), rng)
    sc = root / "scared"
    for split in ("train", "test"):
        for ds in ("dataset_1", "dataset_2"):
            for kf in ("keyframe_1", "keyframe_2"):
                for side in ("left", "right"):
                    for i in range(2):
                        _noise_png(str(sc / split / ds / kf / side / f"{i}.png"),
                                   rng)
    _noise_png(str(sc / "train" / "dataset_1" / "keyframe_1" / "left"
                   / "9.png"), rng)
    cs = root / "cityscapes"
    for split in ("train", "val"):
        for city in ("aachen", "bonn"):
            for i in range(2):
                stem = f"{city}_{i:06}_000019"
                _noise_png(str(cs / "leftImg8bit" / split / city
                               / f"{stem}_leftImg8bit.png"), rng)
                _noise_png(str(cs / "rightImg8bit" / split / city
                               / f"{stem}_rightImg8bit.png"), rng)
    _noise_png(str(cs / "leftImg8bit" / "train" / "bonn"
                   / "bonn_000099_000019_leftImg8bit.png"), rng)
    return {"davinci": str(dv), "scared": str(sc), "cityscapes": str(cs)}


DATASETS = [("DaVinciDataset", "davinci", "train"),
            ("DaVinciDataset", "davinci", "test"),
            ("SCAREDDataset", "scared", "train"),
            ("CityScapesDataset", "cityscapes", "train"),
            ("CityScapesDataset", "cityscapes", "val")]


@pytest.mark.parametrize("limit", [None, 3])
@pytest.mark.parametrize("parity_quirks", [False, True])
@pytest.mark.parametrize("cls,tree,split", DATASETS)
def test_dataset_pairing_equals_jax(trees, cls, tree, split, parity_quirks,
                                    limit, capsys):
    want = getattr(jdata, cls)(trees[tree], split, limit=limit,
                               parity_quirks=parity_quirks)
    printed = capsys.readouterr().out
    got = getattr(tdata, cls)(trees[tree], split, limit=limit,
                              parity_quirks=parity_quirks)
    assert got.lefts == want.lefts and got.rights == want.rights
    assert len(got) == len(want) > 0
    assert capsys.readouterr().out == printed


def test_unmatched_names_are_dropped(trees):
    ds = tdata.DaVinciDataset(trees["davinci"], "train")
    names = [os.path.basename(p) for p in ds.lefts]
    assert names == ["001.png", "003.png", "005.png", "007.png", "010.png"]
    assert [os.path.basename(p) for p in ds.rights] == names


@pytest.mark.parametrize("cls,split", [("DaVinciDataset", "val"),
                                       ("SCAREDDataset", "val"),
                                       ("CityScapesDataset", "test2")])
def test_invalid_split_raises(trees, cls, split):
    with pytest.raises(ValueError):
        getattr(tdata, cls)(trees["davinci"], split)


def test_getitem_decodes_and_transforms(trees):
    ds = tdata.DaVinciDataset(trees["davinci"], "train",
                              tdata.default_eval_transform((16, 32)))
    pair = ds[0]
    want = tnative.decode_resize_batch([ds.lefts[0], ds.rights[0]], 16, 32)
    np.testing.assert_array_equal(pair["left"], want[0])
    np.testing.assert_array_equal(pair["right"], want[1])
    raw = tdata.DaVinciDataset(trees["davinci"], "train")[1]
    assert raw["left"].dtype == np.uint8 and raw["left"].shape == (24, 40, 3)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------


def _pair(seed, shape=(20, 30)):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 256, (*shape, 3), np.uint8)
            for k in ("left", "right")}


def _pil(pair):
    return {k: Image.fromarray(v) for k, v in pair.items()}


@pytest.mark.parametrize("seed", range(6))
def test_transform_stack_equals_jax(seed):
    """Flip, ToArray and augment with the same generator: equal outputs
    (the JAX flip on PIL images, the port's on arrays) and equal draws."""
    def stack(m):
        return m.Compose([m.RandomFlip(0.5), m.ToArray(),
                          m.RandomAugment(0.5, gamma=(0.8, 1.2),
                                          brightness=(0.5, 2.0),
                                          colour=(0.8, 1.2))])

    pair = _pair(seed)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = stack(jdata)(_pil(pair), rj)
    got = stack(tdata)(pair, rt)
    for k in ("left", "right"):
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    assert rt.random() == rj.random()


@pytest.mark.parametrize("seed", range(4))
def test_flip_and_augment_on_arrays_equal_jax(seed):
    pair = {k: v / np.float32(255) for k, v in _pair(seed).items()}
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jdata.RandomAugment(1.0, (0.8, 1.2), (0.5, 2.0), (0.8, 1.2))(
        dict(pair), rj)
    got = tdata.RandomAugment(1.0, (0.8, 1.2), (0.5, 2.0), (0.8, 1.2))(
        dict(pair), rt)
    for k in ("left", "right"):
        np.testing.assert_array_equal(got[k], want[k])
    rt = np.random.default_rng(seed)
    flipped = tdata.RandomFlip(1.0)(_pair(seed), rt)
    want = jdata.RandomFlip(1.0)(_pil(_pair(seed)), np.random.default_rng(seed))
    for k in ("left", "right"):
        np.testing.assert_array_equal(flipped[k], np.asarray(want[k]))


@pytest.mark.parametrize("size", [(10, 15), (20, 30), (33, 41)])
def test_resize_image_near_pil(size):
    pair = _pair(9, shape=(40, 60))
    got = tdata.ResizeImage(size)(pair)
    want = jdata.ToArray()(jdata.ResizeImage(size)(_pil(pair)))
    for k in ("left", "right"):
        assert got[k].shape == (*size, 3) and got[k].dtype == np.float32
        assert np.abs(got[k] - want[k]).max() <= PIL_TOL


def test_to_array_rejects_other_types():
    with pytest.raises(TypeError):
        tdata.ToArray()({"left": np.zeros((2, 2, 3)), "right": np.zeros((2, 2, 3))})


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def loader_root(tmp_path_factory):
    """11 da Vinci pairs of 24x40 (an odd count leaves partial batches)."""
    root = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(2)
    for side in ("image_0", "image_1"):
        for i in range(11):
            _noise_png(str(root / "train" / side / f"{i:03}.png"), rng)
    return str(root)


LOADER_CASES = [
    # (augment, shuffle, seed, epoch, batch, drop_last, shard, shards)
    (True, True, 5, 0, 3, False, 0, 1),
    (True, True, 5, 1, 3, True, 0, 1),
    (True, True, 7, 2, 4, False, 1, 2),
    (True, True, 7, 2, 4, False, 0, 2),
    (False, False, 0, 0, 4, False, 0, 1),
    (False, True, 3, 1, 2, True, 2, 3),
    (None, True, 1, 0, 5, False, 0, 1),
]


@pytest.mark.parametrize("case", LOADER_CASES)
def test_loader_equals_jax_native(loader_root, case):
    """The same batches as the JAX ``DataLoader(backend="native")``:
    ``augment`` True is the training stack, False the eval stack, None no
    transform (full-size decode, then / 255)."""
    augment, shuffle, seed, epoch, batch, drop_last, shard, shards = case

    def make(m):
        transform = (None if augment is None else
                     m.default_augment_transform((16, 32)) if augment else
                     m.default_eval_transform((16, 32)))
        loader = m.DataLoader(m.DaVinciDataset(loader_root, "train", transform),
                              batch, shuffle=shuffle, seed=seed, num_workers=3,
                              drop_last=drop_last, shard_index=shard,
                              num_shards=shards, backend="native")
        loader.set_epoch(epoch)
        return loader

    want, got = make(jdata), make(tdata)
    assert len(got) == len(want)
    n = 0
    for a, b in zip(want, got):
        for k in ("left", "right"):
            assert b[k].dtype == np.float32 and b[k].shape == a[k].shape
            assert np.abs(b[k] - a[k]).max() <= LOADER_TOL
            np.testing.assert_array_equal(b[k], a[k])  # read: bit for bit
        n += 1
    assert n == len(got)


def test_loader_epochs_reshuffle_and_shards_partition(loader_root):
    ds = tdata.DaVinciDataset(loader_root, "train")
    loader = tdata.DataLoader(ds, 4, shuffle=True, seed=3)
    first = loader._shard_indices()
    loader.set_epoch(1)
    assert not np.array_equal(first, loader._shard_indices())
    parts = [tdata.DataLoader(ds, 4, shuffle=True, seed=3, shard_index=i,
                              num_shards=3)._shard_indices() for i in range(3)]
    assert sorted(np.concatenate(parts).tolist()) == list(range(11))


def test_loader_surfaces_worker_errors(loader_root, tmp_path):
    ds = tdata.DaVinciDataset(loader_root, "train",
                              tdata.default_eval_transform((16, 32)))
    ds.lefts = list(ds.lefts)
    missing = str(tmp_path / "gone.png")
    ds.lefts[5] = missing
    batches = []
    with pytest.raises(IOError, match="gone.png"):
        for b in tdata.DataLoader(ds, 4, num_workers=2):
            batches.append(b)
    assert len(batches) == 1  # the batch before the bad file's

    def broken(pair, rng):
        raise RuntimeError("a transform failed")

    ds = tdata.DaVinciDataset(loader_root, "train", broken)
    with pytest.raises(RuntimeError, match="a transform failed"):
        next(iter(tdata.DataLoader(ds, 4, num_workers=2)))


@pytest.mark.parametrize("backend", ["pil", "torch"])
def test_loader_refuses_other_backends(loader_root, backend):
    ds = tdata.DaVinciDataset(loader_root, "train")
    with pytest.raises(ValueError, match="no PIL path"):
        tdata.DataLoader(ds, 4, backend=backend)


def test_loader_stops_early_without_hanging(loader_root):
    ds = tdata.DaVinciDataset(loader_root, "train",
                              tdata.default_eval_transform((16, 32)))
    it = iter(tdata.DataLoader(ds, 1, num_workers=2, prefetch=1))
    next(it)
    it.close()


def test_decoder_reads_pil_optimized_files(tmp_path):
    """A PNG that PIL writes with ``optimize=True`` (its own filter and
    compression choices)."""
    arr = np.random.default_rng(8).integers(0, 256, (31, 47, 3), np.uint8)
    path = str(tmp_path / "optimized.png")
    Image.fromarray(arr).save(path, optimize=True)
    np.testing.assert_array_equal(tnative.decode_png(path), arr)


def test_host_library_key_names_the_cpu(monkeypatch):
    """The decode library is built with ``-march=native``: its cache key
    holds what that resolves to, so a library built for another CPU is not
    loaded but rebuilt."""
    from uncertainty_model_tpu_torch import _build

    here = _build.library_path("stereo_decode")
    assert _build.library_path("stereo_decode") == here
    monkeypatch.setattr(_build, "_host_target", lambda: b"another cpu")
    other = _build.library_path("stereo_decode")
    assert other != here and os.path.exists(other)
    os.remove(other)
    os.remove(other[:-3] + ".log")

"""The port's data layer against the JAX package's, on the same files.

Every dataset of the registry reads the same generated PNG, float-TIFF,
16-bit PNG and PFM files in both packages, with the same ``rng``, and must
give equal samples: the same keys, dtypes and values (``np.array_equal``),
in train and in eval.  The loaders must give equal batches for two epochs,
shuffled, per shard, and with a ragged final batch.  The port's native
sample prep must agree with its numpy path (normalization to the
tolerance of the JAX package's own native test, rtol 1e-5 / atol 1e-6,
since the library multiplies by 1 / (255 std) where numpy divides; the
downsample exactly).
"""

import os

import numpy as np
import pytest
from PIL import Image

from semstereo_tpu import data as jdata
from semstereo_tpu_torch import data as pdata
from semstereo_tpu_torch.data import native
from tests._torch_threads import two_torch_threads  # noqa: F401


def _write_pfm(path, data):
    h, w = data.shape
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        np.flipud(data).astype("<f4").tofile(f)


def _rgb(rng, h, w):
    return Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8))


def _disp16(rng, h, w):
    return Image.fromarray((rng.uniform(1, 60, (h, w)) * 256).astype(np.uint16))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """One small dataset per registry entry, in its own layout."""
    rng = np.random.default_rng(0)
    base = tmp_path_factory.mktemp("datasets")
    out = {}

    us3d = base / "us3d"
    us3d.mkdir()
    rows = []
    for i in range(5):
        _rgb(rng, 32, 32).save(us3d / f"l{i}.png")
        _rgb(rng, 32, 32).save(us3d / f"r{i}.png")
        Image.fromarray(rng.uniform(-20, 20, (32, 32)).astype(np.float32), mode="F").save(
            us3d / f"d{i}.tif")
        Image.fromarray(rng.integers(0, 6, (32, 32)).astype(np.uint8)).save(us3d / f"s{i}.png")
        rows.append(f"l{i}.png r{i}.png d{i}.tif s{i}.png")
    (us3d / "list.txt").write_text("\n".join(rows) + "\n")
    out["us3d"] = us3d

    whu = base / "whu"
    whu.mkdir()
    rows = []
    for i in range(2):
        _rgb(rng, 32, 48).save(whu / f"l{i}.png")
        _rgb(rng, 32, 48).save(whu / f"r{i}.png")
        _disp16(rng, 32, 48).save(whu / f"d{i}.png")
        rows.append(f"l{i}.png r{i}.png d{i}.png")
    (whu / "list.txt").write_text("\n".join(rows) + "\n")
    out["WhuDataset"] = out["whu"] = whu

    sf = base / "sceneflow"
    sf.mkdir()
    rows = []
    for i in range(2):  # the eval crop is the bottom-right 512 x 960
        _rgb(rng, 540, 960).save(sf / f"l{i}.png")
        _rgb(rng, 540, 960).save(sf / f"r{i}.png")
        _write_pfm(sf / f"d{i}.pfm", rng.uniform(0, 100, (540, 960)).astype(np.float32))
        rows.append(f"l{i}.png r{i}.png d{i}.pfm")
    (sf / "list.txt").write_text("\n".join(rows) + "\n")
    out["sceneflow"] = sf

    kitti = base / "kitti"
    for d in ("image_2", "image_3", "disp_occ_0", "semantic"):
        (kitti / "training" / d).mkdir(parents=True)
    rows = []
    for i in range(2):  # KITTI height; under the 384 x 1248 eval pad
        name = f"{i:06d}_10.png"
        _rgb(rng, 370, 600).save(kitti / "training" / "image_2" / name)
        _rgb(rng, 370, 600).save(kitti / "training" / "image_3" / name)
        _disp16(rng, 370, 600).save(kitti / "training" / "disp_occ_0" / name)
        Image.fromarray(rng.integers(0, 34, (370, 600)).astype(np.uint8)).save(
            kitti / "training" / "semantic" / name)
        rows.append(f"training/image_2/{name} training/image_3/{name} "
                    f"training/disp_occ_0/{name}")
    (kitti / "list.txt").write_text("\n".join(rows) + "\n")
    out["kitti"] = kitti

    cs = base / "cityscapes"
    cs.mkdir()
    rows = []
    for i in range(2):
        _rgb(rng, 288, 576).save(cs / f"l{i}.png")
        _rgb(rng, 288, 576).save(cs / f"r{i}.png")
        _disp16(rng, 288, 576).save(cs / f"d{i}.png")
        Image.fromarray(rng.integers(0, 34, (288, 576)).astype(np.uint8)).save(cs / f"s{i}.png")
        rows.append(f"l{i}.png r{i}.png d{i}.png s{i}.png")
    (cs / "list.txt").write_text("\n".join(rows) + "\n")
    out["cityscapes"] = cs
    return {k: str(v) for k, v in out.items()}


def _assert_samples_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert type(g) is type(w), k
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            assert np.array_equal(g, w), k
        elif isinstance(w, list):
            assert len(g) == len(w) and all(
                np.array_equal(a, b) for a, b in zip(g, w)), k
        else:
            assert g == w, k


def test_registry_keys_match_jax():
    assert set(pdata.__datasets__) == set(jdata.__datasets__) == {
        "us3d", "WhuDataset", "whu", "sceneflow", "kitti", "cityscapes"}


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("key", ["us3d", "WhuDataset", "whu", "sceneflow", "kitti",
                                 "cityscapes"])
def test_dataset_samples_equal_jax(roots, key, training):
    root = roots[key]
    lst = os.path.join(root, "list.txt")
    port = pdata.__datasets__[key](root, lst, training)
    ref = jdata.__datasets__[key](root, lst, training)
    assert len(port) == len(ref)
    for i in range(len(ref)):
        for seed in (0, 5):  # two draws of the augmentations
            _assert_samples_equal(port.get(i, np.random.default_rng(seed)),
                                  ref.get(i, np.random.default_rng(seed)))


class _Draws:
    """A dataset whose samples are its rng's draws: the loader's seeding
    contract decides every value."""

    def __len__(self):
        return 5

    def get(self, index, rng):
        return {"draw": rng.standard_normal(4).astype(np.float32), "index": index,
                "name": f"s{index}"}


@pytest.mark.parametrize("shard", [(0, 1), (0, 2), (1, 2)])
def test_loader_batches_equal_jax(shard):
    """Shuffled, two epochs, each shard; 5 samples in batches of 2 leave a
    ragged final batch in shards (0, 1) and (0, 2)."""
    ds = _Draws()
    kw = dict(batch_size=2, shuffle=True, num_workers=2, drop_last=False, seed=3, shard=shard)
    port, ref = pdata.DataLoader(ds, **kw), jdata.DataLoader(ds, **kw)
    sizes = []
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port) == len(ref)
        for g, w in zip(got, want):
            _assert_samples_equal(g, w)
        sizes.append([len(b["name"]) for b in want])
    if shard != (1, 2):
        assert sizes[0][-1] == 1
    assert sizes[0] == sizes[1]


def test_loader_over_files_equals_jax(roots):
    """The US3D eval dataset (arrays, ints and file names) through both
    loaders: drop_last off, a ragged final batch of 1."""
    root = roots["us3d"]
    lst = os.path.join(root, "list.txt")
    kw = dict(batch_size=2, shuffle=True, num_workers=2, seed=1)
    port = pdata.DataLoader(pdata.Us3dDataset(root, lst, False), **kw)
    ref = jdata.DataLoader(jdata.Us3dDataset(root, lst, False), **kw)
    got, want = list(port), list(ref)
    assert [len(b["left_filename"]) for b in want] == [2, 2, 1]
    for g, w in zip(got, want):
        _assert_samples_equal(g, w)


def test_loader_raises_a_sample_error():
    class Broken(_Draws):
        def get(self, index, rng):
            raise OSError(f"unreadable sample {index}")

    with pytest.raises(OSError, match="unreadable sample"):
        list(pdata.DataLoader(Broken(), batch_size=2, shuffle=False, num_workers=1))


def test_synthetic_dataset_equals_jax():
    """``get(index, rng)`` as the JAX package's: the draw is per index."""
    port = pdata.SyntheticStereoDataset(3, 16, 24, 16)
    ref = jdata.SyntheticStereoDataset(3, 16, 24, 16)
    for i in range(3):
        _assert_samples_equal(port.get(i, np.random.default_rng(9)),
                              ref.get(i, np.random.default_rng(0)))
    b = port.batch(1, 2)
    assert np.array_equal(b["left"].numpy()[1], ref.get(2, None)["left"])


def test_native_sampleprep_matches_numpy():
    if not native.available():
        pytest.skip(f"no native sample prep here: {native.status()}")
    assert native.status().startswith("native (libsampleprep-")
    lib = native.status()[len("native ("):-1]
    build = os.path.join(os.path.dirname(os.path.dirname(native.__file__)), "_build")
    assert os.path.exists(os.path.join(build, lib))
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (64, 48, 3)).astype(np.uint8)
    mean, std = pdata.io.IMAGENET_MEAN, pdata.io.IMAGENET_STD
    ref = (img.astype(np.float32) / 255.0 - mean) / std
    np.testing.assert_allclose(native.normalize_image(img, mean, std), ref, rtol=1e-5, atol=1e-6)
    arr = rng.standard_normal((32, 40)).astype(np.float32)
    assert np.array_equal(native.downsample_nearest(arr, 4), arr[::4, ::4])


def test_native_fallback_is_reported_once(monkeypatch, capsys):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_status", "not loaded")
    monkeypatch.setenv("SEMSTEREO_NATIVE", "0")
    img = np.zeros((4, 4, 3), np.uint8)
    for _ in range(2):
        out = pdata.io.normalize_image(img)
        np.testing.assert_allclose(out[0, 0], -pdata.io.IMAGENET_MEAN / pdata.io.IMAGENET_STD)
    assert native.status().startswith("numpy fallback")
    assert capsys.readouterr().err.count("falls back to numpy") == 1

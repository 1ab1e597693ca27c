"""The SR4000 `.dat` path, port vs JAX reference: the copied numpy parser
and exporter (data/sr4000.py, data/export.py) against their originals on
the same bytes, files written by either package read in the other, and
the port's native decoder (data/native_loader.py, built here by g++ from
native/sr4000_loader.cc into build/native/) against the numpy parser and
the reference's loader. Mirrors tests/test_data.py and the non-slow part
of tests/test_e2e_dat.py.

Tolerances: the copies are exact (array_equal, NaNs equal). The native
decoder parses each decimal straight to f32 (strtof) where numpy goes
through f64; with the port's flags (no fused multiply-adds) its output
equals the numpy parser's here bit for bit, and is held to 1 ulp, the
room double rounding leaves.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from pre3_tpu.data import export as jexport
from pre3_tpu.data import native_loader as jnative
from pre3_tpu.data import sr4000 as jsr
from pre3_tpu_torch.data import export as texport
from pre3_tpu_torch.data import native_loader as tnative
from pre3_tpu_torch.data import sr4000 as tsr
from pre3_tpu_torch.data.synthetic import render_sequence

REPO = Path(__file__).resolve().parent.parent
H, W = 144, 176
FIELDS = ("intensity", "xyz", "confidence")


def synth_dat(seed=0):
    """A raw [721, 176] value matrix in the reference layout
    (tests/test_data.py's)."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.5, 4.0, (H, W))
    x = rng.uniform(-1, 1, (H, W))
    y = rng.uniform(-1, 1, (H, W))
    inten = rng.uniform(0, 40000, (H, W))
    inten[0, 0] = 66000.0  # artifact to clamp
    conf = rng.uniform(0, 100, (H, W))
    ts = np.zeros((1, W))
    ts[0, 0] = 12345.0  # ms
    return np.concatenate([z, x, y, inten, conf, ts], axis=0)


def assert_frames_equal(a, b, maxulp=0):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype == np.float32, f
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y), err_msg=f)
        if maxulp:
            np.testing.assert_array_max_ulp(np.nan_to_num(x), np.nan_to_num(y),
                                            maxulp=maxulp)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.timestamp == b.timestamp


@pytest.fixture(scope="module")
def dat_dir(tmp_path_factory):
    """Six rendered frames exported by the reference's exporter."""
    d = tmp_path_factory.mktemp("dat")
    frames, _, _ = render_sequence(n_frames=6, n_points=200, noise=0.004)
    return jexport.export_dat_sequence(frames, str(d)), frames


@pytest.mark.parametrize("smooth", [True, False])
def test_parse_dat_copy_equals_reference(smooth):
    """parse_dat (layout, flip, >65000 clamp, normalisation, smoothing),
    normalize_intensity, _gaussian3x3 and depth_valid_mask: equal to the
    originals on the same values."""
    raw = synth_dat(seed=3)
    got, ref = tsr.parse_dat(raw, smooth=smooth), jsr.parse_dat(raw,
                                                               smooth=smooth)
    assert_frames_equal(got, ref)
    assert got.timestamp == pytest.approx(12.345)
    assert got.intensity[0, 0] == 0.0 or smooth
    np.testing.assert_array_equal(tsr.depth_valid_mask(got),
                                  jsr.depth_valid_mask(ref))
    np.testing.assert_array_equal(tsr.normalize_intensity(raw[3 * H:4 * H]),
                                  jsr.normalize_intensity(raw[3 * H:4 * H]))
    img = raw[:H].astype(np.float32)
    np.testing.assert_array_equal(tsr._gaussian3x3(img), jsr._gaussian3x3(img))


def test_layout_flip_and_mask():
    """tests/test_data.py's TestParse checks on the port's parser."""
    raw = synth_dat()
    fr = tsr.parse_dat(raw, smooth=False)
    np.testing.assert_allclose(fr.xyz[..., 0], -raw[H:2 * H], atol=1e-6)
    np.testing.assert_allclose(fr.xyz[..., 1], -raw[2 * H:3 * H], atol=1e-6)
    np.testing.assert_allclose(fr.xyz[..., 2], raw[0:H], atol=1e-6)
    assert fr.intensity.max() <= 1.0 and fr.intensity[0, 0] == 0.0
    m = tsr.depth_valid_mask(fr)
    assert m.dtype == bool and m.shape == (H, W)
    assert not np.any(m & (np.linalg.norm(fr.xyz, axis=-1) < 0.4))


def test_list_sequence_ordering(tmp_path):
    for i in (3, 1, 10):
        (tmp_path / f"d1_{i:04d}.dat").touch()
    (tmp_path / "other.txt").touch()
    seq = tsr.list_sequence(str(tmp_path))
    assert [os.path.basename(p) for p in seq] == [
        "d1_0001.dat", "d1_0003.dat", "d1_0010.dat"]
    assert seq == jsr.list_sequence(str(tmp_path))


def test_export_copy_equals_reference(tmp_path):
    """frame_to_raw equal, export_dat_sequence writes the same names and
    the same bytes as the reference's, and the round trip holds
    (tests/test_e2e_dat.py)."""
    frames, _, _ = render_sequence(n_frames=3, n_points=120, noise=0.004)
    np.testing.assert_array_equal(texport.frame_to_raw(frames[0]),
                                  jexport.frame_to_raw(frames[0]))
    got = texport.export_dat_sequence(frames, str(tmp_path / "port"))
    ref = jexport.export_dat_sequence(frames, str(tmp_path / "ref"))
    assert [os.path.basename(p) for p in got] == [
        "d1_0001.dat", "d1_0002.dat", "d1_0003.dat"]
    assert tsr.list_sequence(str(tmp_path / "port")) == got
    for a, b in zip(got, ref):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    back = tsr.parse_dat(texport.frame_to_raw(frames[0]), smooth=False)
    np.testing.assert_allclose(np.nan_to_num(back.xyz),
                               np.nan_to_num(frames[0].xyz), atol=1e-5)
    np.testing.assert_allclose(back.intensity * np.nanmax(
        frames[0].intensity), frames[0].intensity, atol=1e-4)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_dat_reads_equal_in_both_packages(tmp_path, writer):
    """A .dat written by either package: read_frame of both packages
    returns the same frame."""
    frames, _, _ = render_sequence(n_frames=2, n_points=120, noise=0.004)
    mod = jexport if writer == "reference" else texport
    for p in mod.export_dat_sequence(frames, str(tmp_path)):
        assert_frames_equal(tsr.read_frame(p), jsr.read_frame(p))


def test_native_library_is_built_from_source():
    """The port builds native/sr4000_loader.cc into build/native/ under a
    content-keyed name and loads that library, never the committed
    native/build/libsr4000.so."""
    assert tnative.native_available()
    lib = tnative.loaded_library()
    assert lib == tnative.library_path()
    assert lib.parent == REPO / "build" / "native" and lib.exists()
    assert lib.resolve() != (REPO / "native" / "build" / "libsr4000.so"
                             ).resolve()
    assert "-march=native" not in tnative.CXX_FLAGS


def test_native_loader_never_opens_committed_binary(dat_dir):
    """In a fresh process the port decodes a frame natively, and its
    memory map holds the port's library and not the committed one."""
    paths, _ = dat_dir
    code = (
        "import sys\n"
        "from pre3_tpu_torch.data import native_loader as n\n"
        f"n.read_frame_native({paths[0]!r})\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert str(n.loaded_library()) in maps, maps\n"
        "assert 'native/build/libsr4000.so' not in maps\n"
        "print('ok')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("smooth", [True, False])
def test_native_matches_numpy_and_reference(dat_dir, smooth):
    """One frame and the threaded batch (3 threads): the port's native
    decoder equals its numpy parser within 1 ulp (equal here), and the
    reference's loader on the same files."""
    paths, _ = dat_dir
    one = tnative.read_frame_native(paths[0], smooth=smooth)
    assert_frames_equal(one, tsr.read_frame(paths[0], smooth=smooth),
                        maxulp=1)
    assert_frames_equal(one, jnative.read_frame_native(paths[0],
                                                       smooth=smooth))
    batch = tnative.read_sequence_native(paths, smooth=smooth, threads=3)
    ref = jnative.read_sequence_native(paths, smooth=smooth, threads=3)
    assert len(batch) == len(paths)
    for got, want, p in zip(batch, ref, paths):
        assert_frames_equal(got, want)
        assert_frames_equal(got, tsr.read_frame(p, smooth=smooth), maxulp=1)


def test_native_batch_of_synthetic_layouts(tmp_path):
    """tests/test_data.py's batch decode: six raw matrices with the
    >65000 artifact, decoded natively, equal the numpy parse of the same
    values."""
    paths = []
    for i in range(6):
        p = tmp_path / f"d1_{i:04d}.dat"
        np.savetxt(p, synth_dat(seed=i), fmt="%.6f")
        paths.append(str(p))
    for i, fr in enumerate(tnative.read_sequence_native(paths, threads=3)):
        np.testing.assert_allclose(fr.xyz, tsr.parse_dat(synth_dat(seed=i)).xyz,
                                   atol=1e-4)
        assert_frames_equal(fr, tsr.read_frame(paths[i]), maxulp=1)
    with pytest.raises(IOError):
        tnative.read_frame_native(str(tmp_path / "missing.dat"))

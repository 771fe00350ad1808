"""The port's file formats and host data path against the JAX package's:
PLY and PCD byte streams, the feature-pair cache, the native library
(KITTI reader, pack_batch, the prefetching ScanLoader), io/kitti.py's two
routes and odometry's file stream. Everything here is held exactly: the
same numpy inputs give the same bytes and arrays.
"""

import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from quatro_tpu import native as jnative
from quatro_tpu.io import pcd as jpcd
from quatro_tpu.io import ply as jply

from quatro_tpu_torch import native, odometry
from quatro_tpu_torch.io import kitti, pcd, ply


@pytest.fixture(autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def jax_native():
    try:
        jnative._load()
    except OSError:
        pytest.skip("no C toolchain for the JAX package's native library")
    return jnative


def _bytes(write, path, *args, **kwargs):
    write(str(path), *args, **kwargs)
    return path.read_bytes()


def _bins(tmp_path, rng, sizes):
    paths, refs = [], []
    for i, n in enumerate(sizes):
        xyz = rng.normal(size=(n, 3)).astype(np.float32)
        p = str(tmp_path / f"{i:06d}.bin")
        kitti.save_kitti_bin(p, xyz, rng.random(n).astype(np.float32))
        paths.append(p)
        refs.append(xyz)
    return paths, refs


# -------------------------------------------------------------------- PLY --

def test_ply_bytes_equal(tmp_path, rng):
    xyz = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    for name, kw in (("one", dict(color=(255, 0, 0))), ("default", {}),
                     ("each", dict(colors=cols))):
        assert _bytes(ply.save_ply, tmp_path / f"t_{name}.ply", xyz, **kw) \
            == _bytes(jply.save_ply, tmp_path / f"j_{name}.ply", xyz, **kw)
    mask = np.arange(50) % 3 == 0
    for kw in ({}, dict(mask=mask, color=(1, 2, 3))):
        t = _bytes(ply.save_correspondences_ply, tmp_path / "tc.ply", xyz,
                   xyz + 1.0, **kw)
        assert t == _bytes(jply.save_correspondences_ply,
                           tmp_path / "jc.ply", xyz, xyz + 1.0, **kw)
    assert b"element vertex 34" in t and b"element edge 17" in t
    poses = rng.normal(size=(6, 4)).astype(np.float32)
    edges = (np.array([0, 1, 2, 3, 4, 0, 1]), np.array([1, 2, 3, 4, 5, 5, 4]),
             np.array([True, True, False, True, True, True, False]))
    for args in ((), edges[:2], edges):
        t = _bytes(ply.save_trajectory_ply, tmp_path / "tt.ply", poses, *args)
        assert t == _bytes(jply.save_trajectory_ply, tmp_path / "jt.ply",
                           poses, *args)
    assert b"element vertex 6" in t and b"element edge 7" in t


# -------------------------------------------------------------------- PCD --

@pytest.mark.parametrize("binary", [True, False])
def test_pcd_bytes_equal_and_cross_read(tmp_path, rng, binary):
    xyz = (rng.normal(size=(137, 3)) * 50).astype(np.float32)
    inten = rng.random(137).astype(np.float32)
    t = _bytes(pcd.save_pcd, tmp_path / "t.pcd", xyz, intensity=inten,
               binary=binary)
    assert t == _bytes(jpcd.save_pcd, tmp_path / "j.pcd", xyz,
                       intensity=inten, binary=binary)
    for path in (tmp_path / "t.pcd", tmp_path / "j.pcd"):
        got = pcd.load_pcd(str(path))
        np.testing.assert_array_equal(got, jpcd.load_pcd(str(path)))
    if binary:
        np.testing.assert_array_equal(got, xyz)
    else:
        np.testing.assert_allclose(got, xyz, rtol=1e-6)


def test_pcd_reads_pcl_layouts(tmp_path, rng):
    """PCL's XYZI binary with a padding field, and an organized cloud
    whose size comes from WIDTH x HEIGHT (no POINTS line)."""
    n = 21
    rec = np.zeros(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("_", "<f4"), ("intensity", "<f4")])
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    rec["x"], rec["y"], rec["z"] = xyz.T
    rec["intensity"] = rng.random(n)
    path = tmp_path / "pcl_xyzi.pcd"
    with open(path, "wb") as f:
        f.write((
            "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
            "FIELDS x y z _ intensity\nSIZE 4 4 4 4 4\nTYPE F F F F F\n"
            f"COUNT 1 1 1 1 1\nWIDTH 7\nHEIGHT 3\n"
            "VIEWPOINT 0 0 0 1 0 0 0\nDATA binary\n").encode())
        rec.tofile(f)
    got = pcd.load_pcd(str(path))
    np.testing.assert_array_equal(got, xyz)
    np.testing.assert_array_equal(got, jpcd.load_pcd(str(path)))
    bad = tmp_path / "bad.pcd"
    bad.write_bytes(b"VERSION 0.7\nFIELDS x y z\nPOINTS 0\n"
                    b"DATA binary_compressed\n")
    with pytest.raises(ValueError):
        pcd.load_pcd(str(bad))


def test_feature_pair_cache(tmp_path, rng):
    src = rng.normal(size=(50, 3)).astype(np.float32)
    tgt = rng.normal(size=(50, 3)).astype(np.float32)
    mask = np.ones(50, bool)
    mask[40:] = False
    path = pcd.save_feature_pair(str(tmp_path / "t"), 540, 1319, src, tgt,
                                 mask)
    assert path.endswith("000540_to_001319.pcd")      # fpfh_manager.hpp:183
    assert path == pcd.feature_pair_path(str(tmp_path / "t"), 540, 1319)
    jpath = jpcd.save_feature_pair(str(tmp_path / "j"), 540, 1319, src, tgt,
                                   mask)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    s2, t2 = pcd.load_feature_pair(str(tmp_path / "j"), 540, 1319)
    np.testing.assert_array_equal(s2, src[:40])
    np.testing.assert_array_equal(t2, tgt[:40])
    with pytest.raises(ValueError):
        pcd.save_feature_pair("", 0, 1, np.zeros((2, 3)), np.zeros((2, 3)))
    with pytest.raises(ValueError):
        pcd.load_feature_pair("", 0, 1)
    with pytest.raises(FileNotFoundError):
        pcd.load_feature_pair(str(tmp_path), 7, 8)
    with pytest.raises(ValueError):
        pcd.save_feature_pair(str(tmp_path), 0, 1, np.zeros((3, 3)),
                              np.zeros((2, 3)))


# ----------------------------------------------------------------- native --

def test_native_builds_into_build_dir():
    """The port builds its own copy of the C source into build/native/,
    not beside either package's files."""
    root = Path(native.__file__).resolve().parents[2]
    assert native.available()
    assert native._SO == root / "build" / "native" / "libquatro_native.so"
    assert native._SO.exists()


def test_native_kitti_and_pack_batch_equal_jax(tmp_path, rng, jax_native):
    paths, refs = _bins(tmp_path, rng, (4321, 0, 17))
    for p, ref in zip(paths, refs):
        got = native.load_kitti_bin(p)
        np.testing.assert_array_equal(got, jax_native.load_kitti_bin(p))
        np.testing.assert_array_equal(got[:, :3], ref)
    with pytest.raises(IOError):
        native.load_kitti_bin(str(tmp_path / "missing.bin"))
    clouds = [rng.normal(size=(n, 4)).astype(np.float32)
              for n in (10, 300, 0, 150)]
    pts, mask = native.pack_batch(clouds, capacity=200)
    jpts, jmask = jax_native.pack_batch(clouds, capacity=200)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(mask, jmask)
    assert mask.sum(1).tolist() == [10, 200, 0, 150]
    pts, mask = native.pack_batch([], capacity=16)
    assert pts.shape == (0, 16, 3) and mask.shape == (0, 16)
    with pytest.raises(ValueError):
        native.pack_batch([clouds[0], clouds[1][:, :3]], capacity=8)


def test_scan_loader_streams_equal_jax(tmp_path, rng, jax_native):
    sizes = [int(n) for n in rng.integers(10, 300, 12)] + [0]
    paths, refs = _bins(tmp_path, rng, sizes)
    # a small queue and several workers exercise the ring-slot reuse
    with native.ScanLoader(paths, capacity=256, n_workers=4,
                           queue_depth=3) as loader:
        got = list(loader)
    with jax_native.ScanLoader(paths, capacity=256, n_workers=4,
                               queue_depth=3) as loader:
        want = list(loader)
    assert len(got) == len(want) == len(paths)
    for (p, m), (jp, jm), ref in zip(got, want, refs):
        np.testing.assert_array_equal(p, jp)
        np.testing.assert_array_equal(m, jm)
        n = min(len(ref), 256)
        assert m.sum() == n
        np.testing.assert_array_equal(p[:n], ref[:n])
    assert list(native.ScanLoader([], capacity=32)) == []


def test_scan_loader_bad_file_and_close(tmp_path, rng):
    paths, _ = _bins(tmp_path, rng, (50,))
    loader = native.ScanLoader([paths[0], str(tmp_path / "missing.bin"),
                                paths[0]], capacity=64, n_workers=2)
    assert next(loader)[1].sum() == 50
    with pytest.raises(IOError):
        next(loader)
    assert next(loader)[1].sum() == 50      # the sequence goes on
    loader.close()
    loader.close()                          # idempotent
    with pytest.raises(StopIteration):
        next(loader)
    # closing with scans still queued neither hangs nor crashes
    many, _ = _bins(tmp_path, rng, [500] * 20)
    loader = native.ScanLoader(many, capacity=512, n_workers=4,
                               queue_depth=4)
    next(loader)
    loader.close()


def test_scan_loader_close_races_a_blocked_next(tmp_path):
    """close() from another thread while next() waits inside C wakes it
    with StopIteration (or delivers the scan), never a crash or hang."""
    fifo = str(tmp_path / "slow.bin")
    os.mkfifo(fifo)           # open() blocks until a writer appears
    loader = native.ScanLoader([fifo], capacity=32, n_workers=1)
    got = []

    def consume():
        try:
            next(loader)
            got.append("item")
        except (StopIteration, IOError):
            got.append("stopped")

    t = threading.Thread(target=consume)
    t.start()
    time.sleep(0.3)
    closer = threading.Thread(target=loader.close)
    closer.start()
    with open(fifo, "wb") as f:             # release the stalled worker
        f.write(b"")
    t.join(timeout=10)
    closer.join(timeout=10)
    assert not t.is_alive() and not closer.is_alive()
    assert got in (["stopped"], ["item"])


# ------------------------------------------------------------------ kitti --

def test_kitti_routes_equal(tmp_path, rng, monkeypatch):
    paths, refs = _bins(tmp_path, rng, (1000, 0))
    assert kitti._native_ready()
    native_route = [kitti.load_kitti_bin(p, with_intensity=True)
                    for p in paths]
    monkeypatch.setattr(kitti, "_native_ok", False)
    numpy_route = [kitti.load_kitti_bin(p, with_intensity=True)
                   for p in paths]
    for a, b, ref in zip(native_route, numpy_route, refs):
        assert a.shape == b.shape == (len(ref), 4)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a[:, :3], ref)
    monkeypatch.setattr(kitti, "_native_ok", None)
    # a per-file failure raises and leaves the native route on
    with pytest.raises((IOError, OSError)):
        kitti.load_kitti_bin(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        kitti.load_kitti_bin(str(tmp_path / "missing.bin"))
    np.testing.assert_array_equal(kitti.load_kitti_bin(paths[0]), refs[0])
    assert kitti._native_ready()


def test_odometry_file_stream_routes(tmp_path, rng, monkeypatch):
    """odometry's file stream gives ScanLoader's arrays, equal to the
    per-file PointBatch route taken where the library does not build."""
    paths, _ = _bins(tmp_path, rng, (120, 0, 300))
    stream = odometry._file_stream(paths, 256, n_workers=2, queue_depth=2)
    loaded = list(stream)
    monkeypatch.setattr(native, "available", lambda: False)
    fallback = list(odometry._file_stream(paths, 256, 2, 2))
    assert len(loaded) == len(fallback) == 3
    for (p, m), (fp, fm) in zip(loaded, fallback):
        np.testing.assert_array_equal(p, fp)
        np.testing.assert_array_equal(m, fm)

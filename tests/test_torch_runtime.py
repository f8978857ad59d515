"""The IO path of the port against the JAX package: the native runtime
(the port's g++ build and its numpy fallback) against mlis_tpu's
decode_pointcloud / parse_* exactly, xxh32 and LZ4 frames across the
packages byte for byte, and bags written by either package's BagWriter
(none / bz2 / lz4 chunks) read by the other, every extract_* and
export_euroc equal. Everything is host numpy, so equality is exact.

The JAX side runs its numpy fallback: its library builds with make (which
these tests never run) and ``-march=native``, which lets g++ fuse
``sec + 1e-9 * nsec`` into an FMA, so on a host with FMA it differs from
its own fallback in the last bit of some stamps. The port's library is
built without ``-march=native`` and agrees with both fallbacks bit for
bit."""

import filecmp

import numpy as np
import pytest

pytest.importorskip("jax")

import mlis_tpu.core.bag as jbag  # noqa: E402
import mlis_tpu.core.lz4f as jlz4  # noqa: E402
import mlis_tpu.runtime.native as jnative  # noqa: E402
import mlis_tpu_torch.core.bag as bag  # noqa: E402
import mlis_tpu_torch.core.lz4f as lz4  # noqa: E402
import mlis_tpu_torch.runtime.native as native  # noqa: E402


@pytest.fixture(autouse=True)
def _no_make(monkeypatch):
    monkeypatch.setattr(jnative, "_load", lambda: None)


@pytest.fixture(params=["native", "fallback"])
def path(request, monkeypatch):
    """The port's runtime through its g++ library, then through the numpy
    fallback of a host without a compiler."""
    if request.param == "native":
        if native.find_cxx() is None:
            pytest.skip("no C++ compiler (g++) on this host: the native library cannot build")
        assert native.native_available()
    else:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
        assert not native.native_available()
    return request.param


def point_blob(rng, n, point_step=48, ring_off=26, ring_size=2):
    """A PointCloud2 blob: float32 x/y/z at 0/4/8, a ring channel of
    ``ring_size`` bytes at ``ring_off`` (Ouster: 48-byte points, uint16 ring
    at 26), random bytes elsewhere."""
    buf = rng.integers(0, 256, (n, point_step), dtype=np.uint8)
    buf[:, :12] = rng.normal(size=(n, 3)).astype(np.float32).view(np.uint8)
    if ring_off >= 0 and ring_size == 2:
        buf[:, ring_off:ring_off + 2] = rng.integers(0, 128, n).astype(np.uint16)[:, None].view(
            np.uint8)
    return buf.tobytes()


LAYOUTS = {  # name: (point_step, ring_off, ring_size)
    "ouster": (48, 26, 2),
    "no_ring": (48, -1, 2),
    "ring_u8": (32, 20, 1),
    "ring_u16_odd": (22, 13, 2),
}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_pointcloud_matches_jax(path, layout, rng):
    step, ring_off, ring_size = LAYOUTS[layout]
    blob = point_blob(rng, 1000, step, ring_off, ring_size) + b"\x07" * (step - 3)  # ragged tail
    got = native.decode_pointcloud(blob, step, 0, 4, 8, ring_off, ring_size)
    want = jnative.decode_pointcloud(blob, step, 0, 4, 8, ring_off, ring_size)
    assert got[0].dtype == np.float32 and got[0].shape == (1000, 3)
    np.testing.assert_array_equal(got[0], want[0])
    if ring_off < 0:
        assert got[1] is None and want[1] is None
    else:
        assert got[1].dtype == np.int32
        np.testing.assert_array_equal(got[1], want[1])


def _messages(rng, n):
    """Serialized Imu and Odometry messages (frame ids of varied length),
    plus short and truncated ones that both parsers must skip."""
    stamps = 1.6e9 + np.cumsum(rng.uniform(0.001, 0.01, n))
    imu = [bag.encode_imu(stamps[i], rng.normal(size=3), rng.normal(size=3),
                          frame_id=b"imu" * (i % 4)) for i in range(n)]
    odo = [bag.encode_odometry(stamps[i], rng.normal(size=3), rng.normal(size=4),
                               frame_id=b"odom"[: i % 5], child=b"base" * (i % 3))
           for i in range(n)]
    for msgs in (imu, odo):
        msgs[3] = msgs[3][:10]  # shorter than a header
        msgs[7] = msgs[7][:40]  # truncated before the values
    return imu, odo


def _batch(msgs):
    lengths = np.asarray([len(m) for m in msgs])
    return b"".join(msgs), np.concatenate([[0], np.cumsum(lengths)[:-1]]), lengths


def test_parse_batches_match_jax(path, rng):
    imu, odo = _messages(rng, 64)
    got, want = native.parse_imu_batch(*_batch(imu)), jnative.parse_imu_batch(*_batch(imu))
    assert len(got[0]) == 62
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    got = native.parse_odometry_batch(*_batch(odo))
    want = jnative.parse_odometry_batch(*_batch(odo))
    assert got.shape == (62, 8)
    np.testing.assert_array_equal(got, want)


def test_parse_tum_native_matches_jax(path, tmp_path, rng):
    rows = np.column_stack([np.arange(50) + 1.6e9, rng.normal(size=(50, 7))])
    p = tmp_path / "t.txt"
    with open(p, "w") as f:
        f.write("# comment line\n\n   \t# indented comment\n")
        for r in rows:
            f.write(" ".join(f"{v:.9f}" for v in r) + "\n")
        f.write("1 2 3\n")  # short line: skipped
    got = native.parse_tum_native(str(p))
    if path == "fallback":
        assert got is None  # as the JAX package's without its library
        return
    np.testing.assert_allclose(got, rows, atol=1e-9)
    if jnative.native_available():
        np.testing.assert_array_equal(got, jnative.parse_tum_native(str(p)))
    with pytest.raises(FileNotFoundError):
        native.parse_tum_native(str(tmp_path / "missing.txt"))


def test_xxh32_known_vectors_and_jax(rng):
    assert lz4.xxh32(b"") == 0x02CC5D05
    assert lz4.xxh32(b"a") == 0x550D7456
    assert lz4.xxh32(b"abc") == 0x32D153FF
    assert lz4.xxh32(b"message digest") == 0x7C948494
    for n in (1, 3, 15, 16, 17, 31, 64, 1001):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 1, 0xDEADBEEF):
            assert lz4.xxh32(data, seed) == jlz4.xxh32(data, seed), (n, seed)


def test_lz4_frames_across_packages(rng):
    data = b"semantic-gating-" * 4096 + rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes()
    assert (lz4._LIB is None) == (jlz4._LIB is None)
    for bsid in (4, 7):
        frame = lz4.compress(data, block_size_id=bsid)
        assert frame == jlz4.compress(data, block_size_id=bsid)
        assert frame[:4] == b"\x04\x22\x4d\x18"
        assert jlz4.decompress(frame, verify_checksums=True) == data
        assert lz4.decompress(jlz4.compress(data, bsid), verify_checksums=True) == data
    # the pure-Python block decoder against liblz4's blocks and the JAX package's decoder
    if lz4._LIB is not None:
        comp = lz4.block_compress(data[:100_000])
        assert lz4._py_block_decompress(comp, 100_000) == data[:100_000] == \
            jlz4._py_block_decompress(comp, 100_000)
    with pytest.raises(ValueError):
        lz4.decompress(b"\x00" * 16)
    with pytest.raises(ValueError, match="literal run"):
        lz4._py_block_decompress(bytes([0xF0, 100]) + b"abcd", 1 << 20)


FIELDS = [("x", 0, 7, 1), ("y", 4, 7, 1), ("z", 8, 7, 1), ("ring", 26, 4, 1)]


def _write_bag(mod, p, rng, compression):
    """One bag of every message type the pipeline reads; the same draws for
    both packages' writers."""
    w = mod.BagWriter(p)
    stamps = 100.0 + np.arange(40) * 0.005
    for i, t in enumerate(stamps):
        w.write("/vectornav/imu", "sensor_msgs/Imu", t,
                mod.encode_imu(t, rng.normal(size=3), rng.normal(size=3)))
        if i % 4 == 0:
            w.write("/integrated_to_init", "nav_msgs/Odometry", t,
                    mod.encode_odometry(t, rng.normal(size=3), [0, 0, 0, 1]))
    fields = [mod.PointField(*f) for f in FIELDS]
    for i in range(3):
        w.write("/ouster/points", "sensor_msgs/PointCloud2", 100.0 + 0.1 * i,
                mod.encode_pointcloud2(100.0 + 0.1 * i, point_blob(rng, 96), 48, fields))
    img = rng.integers(0, 255, (12, 16, 3), dtype=np.uint8)
    for i in range(4):
        t = 100.0 + 0.05 * i
        w.write("/camera_array/cam1/image_raw", "sensor_msgs/Image", t, mod.encode_image(t, img))
        w.write("/camera_array/cam3/image_raw", "sensor_msgs/Image", t + 0.004,
                mod.encode_image(t + 0.004, img[..., 0], encoding="mono8"))
    w.close(compression=compression)


def _same_pointclouds(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) == 3
    for (sa, xa, ra), (sb, xb, rb) in zip(a, b):
        assert sa == sb
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ra, rb)


@pytest.mark.parametrize("compression", ["none", "bz2", "lz4"])
def test_bags_across_packages(tmp_path, compression):
    ours, theirs = tmp_path / "port.bag", tmp_path / "jax.bag"
    _write_bag(bag, ours, np.random.default_rng(1), compression)
    _write_bag(jbag, theirs, np.random.default_rng(1), compression)
    assert ours.read_bytes() == theirs.read_bytes()
    for reader_mod, path in ((bag, theirs), (jbag, ours)):  # each reads the other's
        info = reader_mod.BagReader(path).info()
        assert info["message_counts"] == {"/vectornav/imu": 40, "/integrated_to_init": 10,
                                          "/ouster/points": 3, "/camera_array/cam1/image_raw": 4,
                                          "/camera_array/cam3/image_raw": 4}
    assert bag.BagReader(ours).info() == {**jbag.BagReader(ours).info(), "path": str(ours)}
    got, want = bag.extract_imu(theirs), jbag.extract_imu(ours)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    topics = ["/aft_mapped_to_init", "/integrated_to_init"]
    np.testing.assert_array_equal(bag.extract_odometry_tum(theirs, topics),
                                  jbag.extract_odometry_tum(ours, topics))
    _same_pointclouds(bag.extract_pointclouds(theirs), jbag.extract_pointclouds(ours))
    pairs, ref_pairs = list(bag.extract_stereo_pairs(theirs)), list(jbag.extract_stereo_pairs(ours))
    assert len(pairs) == len(ref_pairs) == 4
    for (s, l, r), (rs, rl, rr) in zip(pairs, ref_pairs):
        assert s == rs and np.array_equal(l, rl) and np.array_equal(r, rr) and r.ndim == 2


def test_export_euroc_matches_jax(tmp_path):
    p = tmp_path / "stereo.bag"
    _write_bag(bag, p, np.random.default_rng(2), "none")
    counts = bag.export_euroc(p, tmp_path / "port")
    assert counts == jbag.export_euroc(p, tmp_path / "jax") == {"stereo_pairs": 4,
                                                                 "imu_samples": 40}
    cmp = filecmp.dircmp(tmp_path / "port" / "mav0", tmp_path / "jax" / "mav0")

    def same(c):
        assert not (c.left_only or c.right_only or c.diff_files or c.funny_files), c.report()
        _, mismatch, errors = filecmp.cmpfiles(c.left, c.right, c.common_files, shallow=False)
        assert not mismatch and not errors
        for sub in c.subdirs.values():
            same(sub)

    same(cmp)
    assert len(list((tmp_path / "port" / "mav0" / "cam1" / "data").glob("*.png"))) == 4


def test_message_codecs_match_jax(rng):
    blob = point_blob(rng, 8)
    fields = [bag.PointField(*f) for f in FIELDS]
    msg = bag.encode_pointcloud2(2.5, blob, 48, fields)
    assert msg == jbag.encode_pointcloud2(2.5, blob, 48, [jbag.PointField(*f) for f in FIELDS])
    stamp, out_fields, step, out_blob = bag.decode_pointcloud2(msg)
    assert (stamp, step, out_blob) == (2.5, 48, blob)
    assert [(f.name, f.offset, f.datatype, f.count) for f in out_fields] == FIELDS
    imu = bag.encode_imu(3.25, [1, 2, 3], [4, 5, 6], orientation=[0, 0, 1, 0])
    for got, want in zip(bag.decode_imu(imu), jbag.decode_imu(imu)):
        np.testing.assert_array_equal(got, want)
    odo = bag.encode_odometry(4.5, [1, 2, 3], [0, 0, 0, 1])
    for got, want in zip(bag.decode_odometry(odo), jbag.decode_odometry(odo)):
        np.testing.assert_array_equal(got, want)
    img = rng.integers(0, 255, (6, 8), dtype=np.uint8)
    s, out, enc = bag.decode_image(bag.encode_image(1.0, img, "mono8"))
    assert s == 1.0 and enc == "mono8" and np.array_equal(out, img)
    with pytest.raises(ValueError, match="not a ROS bag"):
        bag.BagReader(__file__)

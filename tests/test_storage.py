"""S3T storage tests (reference analogs: tests/storage.cpp round-trips with
all checksum levels and tests/storage_details.cpp byte-level checks)."""

import os
import struct
import zlib

import jax.numpy as jnp
import numpy as np
import pytest

from superbblas_tpu import cplx, storage as S


def test_header_bytes(tmp_path):
    """Byte-level header layout (storage_details.cpp analog)."""
    p = str(tmp_path / "t.s3t")
    S.create_storage(p, "xy", (4, 6), dtype=np.float64, metadata="hello",
                     checksum=0)
    raw = open(p, "rb").read()
    magic, version, dt, cs, nd, ms = struct.unpack("<6i", raw[:24])
    assert (magic, version, dt, cs, nd, ms) == (314, 0, 1, 0, 2, 5)
    assert raw[24:29] == b"hello"
    assert raw[29:32] == b"\x00\x00\x00"       # pad to 8
    dims = np.frombuffer(raw[32:48], dtype="<f8")
    np.testing.assert_array_equal(dims, [4.0, 6.0])
    cbs, nchunks = np.frombuffer(raw[48:64], dtype="<f8")
    assert cbs == 64 * 1024 * 1024
    assert nchunks == 0.0


@pytest.mark.parametrize("checksum", [0, 1, 2])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex128])
def test_save_load_roundtrip(tmp_path, checksum, dtype):
    p = str(tmp_path / "t.s3t")
    dim = (4, 6)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(dim).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(dim).astype(dtype)

    sto = S.create_storage(p, "xy", dim, dtype=dtype, checksum=checksum)
    S.append_blocks(sto, [((0, 0), (4, 3)), ((0, 3), (4, 3))])
    S.save(1.0, jnp.asarray(x), "xy", sto, "xy")
    S.check_or_write_checksums(sto)
    S.close_storage(sto)

    sto2 = S.open_storage(p, mode="r")
    assert sto2.dim == dim
    assert len(sto2.blocks) == 2
    y = S.load(1.0, sto2, np.zeros(dim, dtype=dtype), "xy")
    np.testing.assert_allclose(np.asarray(y), x, rtol=1e-6)
    if checksum == 2:
        S.check_or_write_checksums(sto2)
    S.close_storage(sto2)


def test_partial_load_with_permutation(tmp_path):
    p = str(tmp_path / "t.s3t")
    dim = (4, 6)
    x = np.arange(24, dtype=np.float64).reshape(dim)
    sto = S.create_storage(p, "xy", dim, dtype=np.float64)
    S.append_blocks(sto, [((0, 0), dim)])
    S.save(1.0, jnp.asarray(x), "xy", sto, "xy")

    # load a sub-box transposed into a differently-labeled tensor
    y = S.load(2.0, sto, np.zeros((6, 4)), "yx",
               from0=(1, 2), size0=(2, 3), from1=(0, 0))
    want = np.zeros((6, 4))
    want[0:3, 0:2] = 2.0 * x[1:3, 2:5].T
    np.testing.assert_allclose(np.asarray(y), want)
    S.close_storage(sto)


def test_partial_save_into_block(tmp_path):
    p = str(tmp_path / "t.s3t")
    dim = (4, 4)
    sto = S.create_storage(p, "xy", dim, dtype=np.float64)
    S.append_blocks(sto, [((0, 0), dim)])
    x = np.ones((2, 2))
    S.save(3.0, jnp.asarray(x), "xy", sto, "xy", from1=(1, 1))
    y = S.load(1.0, sto, np.zeros(dim), "xy")
    want = np.zeros(dim)
    want[1:3, 1:3] = 3.0
    np.testing.assert_allclose(np.asarray(y), want)
    S.close_storage(sto)


def test_save_outside_blocks_raises(tmp_path):
    p = str(tmp_path / "t.s3t")
    sto = S.create_storage(p, "xy", (4, 4), dtype=np.float64)
    S.append_blocks(sto, [((0, 0), (2, 4))])
    with pytest.raises(ValueError, match="not covered"):
        S.save(1.0, jnp.ones((4, 4)), "xy", sto, "xy")
    S.close_storage(sto)


def test_checksum_detects_corruption(tmp_path):
    p = str(tmp_path / "t.s3t")
    dim = (4, 4)
    sto = S.create_storage(p, "xy", dim, dtype=np.float64, checksum=2)
    S.append_blocks(sto, [((0, 0), dim)])
    S.save(1.0, jnp.ones(dim), "xy", sto, "xy")
    S.check_or_write_checksums(sto)
    off = sto.blocks[0].values_offset
    S.close_storage(sto)
    with open(p, "r+b") as f:
        f.seek(off)
        f.write(struct.pack("<d", 99.0))
    sto2 = S.open_storage(p, mode="r")
    with pytest.raises(ValueError, match="checksum mismatch"):
        S.check_or_write_checksums(sto2)
    S.close_storage(sto2)


def test_global_checksum_roundtrip(tmp_path):
    p = str(tmp_path / "t.s3t")
    dim = (4, 4)
    sto = S.create_storage(p, "xy", dim, dtype=np.float64, checksum=1)
    S.append_blocks(sto, [((0, 0), dim)])
    S.save(1.0, jnp.ones(dim), "xy", sto, "xy")
    S.check_or_write_checksums(sto)
    S.close_storage(sto)
    sto2 = S.open_storage(p, mode="r")
    sto2._has_trailer = True
    S.check_or_write_checksums(sto2)   # verifies, raises on mismatch
    S.close_storage(sto2)


def test_carray_save_load(tmp_path):
    p = str(tmp_path / "t.s3t")
    dim = (4, 4)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
    sto = S.create_storage(p, "xy", dim, dtype=np.complex128)
    S.append_blocks(sto, [((0, 0), dim)])
    S.save(1.0, cplx.from_complex(x), "xy", sto, "xy")
    y = S.load(1.0, sto, cplx.from_complex(np.zeros(dim, np.complex128)), "xy")
    assert cplx.is_carray(y)
    np.testing.assert_allclose(np.asarray(y.re) + 1j * np.asarray(y.im), x)
    S.close_storage(sto)


def test_crc_is_zlib_compatible():
    data = b"superbblas-s3t"
    assert S._crc(data) == zlib.crc32(data) & 0xFFFFFFFF


def test_big_endian_file_read(tmp_path):
    """Byte-swapped (big-endian) S3T files are detected by the magic and
    read correctly (storage.h:737-749)."""
    import struct

    path = str(tmp_path / "be.s3t")
    dim = (2, 3)
    vals = (np.arange(6) * 1.25).reshape(dim)
    meta = b"be!"
    pad = b"\x00" * ((8 - len(meta) % 8) % 8)
    hdr = struct.pack(">6i", 314, 0, 1, 0, 2, len(meta)) + meta + pad
    hdr += np.asarray(dim, dtype=">f8").tobytes()
    hdr += struct.pack(">d", float(64 * 1024 * 1024))
    hdr += struct.pack(">d", 1.0)                      # one chunk
    chunk = struct.pack(">d", 1.0)                     # one block
    chunk += np.asarray((0, 0), dtype=">f8").tobytes()
    chunk += np.asarray(dim, dtype=">f8").tobytes()
    chunk += vals.astype(">f8").tobytes()
    with open(path, "wb") as f:
        f.write(hdr + chunk)

    sto = S.open_storage(path, mode="r")
    assert sto.byteswap and sto.dim == dim and sto.metadata == "be!"
    got = S.load(1.0, sto, np.zeros(dim), "xy")
    np.testing.assert_array_equal(got, vals)
    S.close_storage(sto)


def test_gridhash_partial_load_many_blocks(tmp_path):
    """GridHash spatial index (storage.h:552-684): open + partial load on
    a 10^4-block manifest completes in well under a second because the
    query inspects only candidate cells, not the full block list."""
    import time

    p = str(tmp_path / "many.s3t")
    n = 10_000
    dim = (n, 4)
    sto = S.create_storage(p, "xy", dim, dtype=np.float64)
    S.append_blocks(sto, [((i, 0), (1, 4)) for i in range(n)])
    # write some recognizable values into a few scattered rows
    for row in (0, 1234, 9999):
        S.save(1.0, np.full((1, 4), float(row)), "xy", sto, "xy",
               from1=(row, 0))
    S.close_storage(sto)

    t0 = time.perf_counter()
    sto2 = S.open_storage(p, mode="r")
    out = np.zeros((3, 4))
    for k, row in enumerate((0, 1234, 9999)):
        got = S.load(1.0, sto2, np.zeros((1, 4)), "xy", from0=(row, 0),
                     size0=(1, 4))
        out[k] = got
    elapsed = time.perf_counter() - t0
    S.close_storage(sto2)
    np.testing.assert_array_equal(out, [[0.0] * 4, [1234.0] * 4,
                                        [9999.0] * 4])
    assert elapsed < 1.0, elapsed


def test_load_stream_windows(tmp_path):
    """Windowed streaming read (the MPI-IO windowed-read analog,
    storage.h:1326-1420): concatenated windows equal the plain load, and
    the window size honors max_window_bytes."""
    p = str(tmp_path / "stream.s3t")
    dim = (16, 8)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(dim)
    sto = S.create_storage(p, "xy", dim, dtype=np.float64)
    # two blocks with a toroidal wrap in the second one
    S.append_blocks(sto, [((0, 0), (10, 8)), ((10, 0), (6, 8))])
    S.save(1.0, x, "xy", sto, "xy")

    # window = 4 rows (4*8*8 bytes = 256B)
    rows = []
    for wfrom, wdata in S.load_stream(sto, max_window_bytes=256):
        assert wdata.shape[0] <= 4
        rows.append(wdata)
    got = np.concatenate(rows, axis=0)
    np.testing.assert_array_equal(got, x)

    # sub-region request with wrap
    rows = [w for _, w in S.load_stream(sto, from0=(12, 0), size0=(8, 8),
                                        max_window_bytes=256)]
    got = np.concatenate(rows, axis=0)
    want = x[(np.arange(12, 20) % 16)]
    np.testing.assert_array_equal(got, want)
    S.close_storage(sto)


def test_gridhash_matches_linear_sweep(tmp_path):
    """Index correctness fuzz: the GridHash query path yields exactly the
    intersections of the linear sweep, on wrapped and overlapping
    request boxes."""
    p = str(tmp_path / "gh.s3t")
    dim = (32, 24)
    rng = np.random.default_rng(5)
    boxes = []
    for _ in range(80):    # above _GRID_MIN_BLOCKS
        f = (int(rng.integers(0, 32)), int(rng.integers(0, 24)))
        s = (int(rng.integers(1, 9)), int(rng.integers(1, 7)))
        boxes.append((f, s))
    sto = S.create_storage(p, "xy", dim, dtype=np.float64)
    S.append_blocks(sto, boxes)
    assert len(sto.blocks) >= S._GRID_MIN_BLOCKS

    def collect(use_grid):
        out = []
        for case in range(30):
            f = (int(rng.integers(0, 32)), int(rng.integers(0, 24)))
            s = (int(rng.integers(1, 33)), int(rng.integers(1, 25)))
            hits = sorted(
                (b.values_offset, ifrom, isize)
                for b, ifrom, isize in S._block_intersections(sto, f, s))
            out.append(hits)
        return out

    rng = np.random.default_rng(6)
    with_grid = collect(True)
    # force the linear sweep by shrinking below the threshold
    rng = np.random.default_rng(6)
    orig = S._GRID_MIN_BLOCKS
    S._GRID_MIN_BLOCKS = 10 ** 9
    try:
        sto._grid = None
        linear = collect(False)
    finally:
        S._GRID_MIN_BLOCKS = orig
    assert with_grid == linear
    S.close_storage(sto)


def test_big_endian_file_write_roundtrip(tmp_path):
    """Writes into a byteswapped (reference-written, big-endian) storage
    must keep the file's declared endianness: a read-modify-write through
    save() would otherwise silently corrupt the block (storage.h:1200
    writes through the same byte-order the header declares)."""
    import struct

    path = str(tmp_path / "berw.s3t")
    dim = (2, 3)
    vals = (np.arange(6) * 1.25).reshape(dim)
    meta = b"be!"
    pad = b"\x00" * ((8 - len(meta) % 8) % 8)
    hdr = struct.pack(">6i", 314, 0, 1, 0, 2, len(meta)) + meta + pad
    hdr += np.asarray(dim, dtype=">f8").tobytes()
    hdr += struct.pack(">d", float(64 * 1024 * 1024))
    hdr += struct.pack(">d", 1.0)                      # one chunk
    chunk = struct.pack(">d", 1.0)                     # one block
    chunk += np.asarray((0, 0), dtype=">f8").tobytes()
    chunk += np.asarray(dim, dtype=">f8").tobytes()
    chunk += vals.astype(">f8").tobytes()
    with open(path, "wb") as f:
        f.write(hdr + chunk)

    # partial save: read-modify-write of the single block
    sto = S.open_storage(path, mode="r+")
    new = np.array([[7.5, 8.5]])
    S.save(1.0, new, "xy", sto, "xy", from1=(1, 1))
    S.close_storage(sto)

    want = vals.copy()
    want[1, 1:3] = new[0]
    # a fresh open must read back the updated values (bytes stayed BE)
    sto2 = S.open_storage(path, mode="r")
    got = S.load(1.0, sto2, np.zeros(dim), "xy")
    np.testing.assert_array_equal(got, want)
    S.close_storage(sto2)
    # and the raw bytes on disk really are big-endian
    with open(path, "rb") as f:
        raw = f.read()
    arr = np.frombuffer(raw[-6 * 8:], dtype=">f8").reshape(dim)
    np.testing.assert_array_equal(arr, want)


def test_fuzz_random_blocks_save_load(tmp_path):
    """Randomized S3T sweep (the tests/storage.cpp breadth): random
    (possibly wrapped, overlapping) block manifests, random saves and
    partial loads with label permutation, all mirrored against a global
    numpy shadow array.  Saves update every intersecting block, so
    overlapping blocks stay consistent and the shadow is exact."""
    rng = np.random.default_rng(99)
    for case in range(6):
        dim = (int(rng.integers(4, 10)), int(rng.integers(4, 10)))
        p = str(tmp_path / f"fuzz{case}.s3t")
        sto = S.create_storage(p, "xy", dim, dtype=np.float64)
        nblk = int(rng.integers(1, 5))
        boxes = []
        for _ in range(nblk):
            f = (int(rng.integers(0, dim[0])), int(rng.integers(0, dim[1])))
            z = (int(rng.integers(1, dim[0] + 1)),
                 int(rng.integers(1, dim[1] + 1)))
            boxes.append((f, z))
        S.append_blocks(sto, boxes)
        covered = np.zeros(dim, dtype=bool)
        for f, z in boxes:
            idx = np.ix_(*[np.arange(a, a + s) % d
                           for a, s, d in zip(f, z, dim)])
            covered[idx] = True
        shadow = np.zeros(dim)

        for step in range(5):
            # random save fully inside the covered set: pick a random box
            # and clip to covered cells via per-cell writes through save()
            f = (int(rng.integers(0, dim[0])), int(rng.integers(0, dim[1])))
            z = (int(rng.integers(1, dim[0] + 1)),
                 int(rng.integers(1, dim[1] + 1)))
            idx = np.ix_(*[np.arange(a, a + s) % d
                           for a, s, d in zip(f, z, dim)])
            if not covered[idx].all():
                continue                      # save() raises on uncovered
            vals = rng.standard_normal(z)
            S.save(1.0, vals, "xy", sto, "xy", from1=f)
            shadow[idx] = vals

            # random partial load, sometimes with a permuted output order
            lf = (int(rng.integers(0, dim[0])), int(rng.integers(0, dim[1])))
            lz = (int(rng.integers(1, dim[0] + 1)),
                  int(rng.integers(1, dim[1] + 1)))
            lidx = np.ix_(*[np.arange(a, a + s) % d
                            for a, s, d in zip(lf, lz, dim)])
            want = np.where(covered[lidx], shadow[lidx], 0.0)
            if rng.random() < 0.5:
                got = S.load(1.0, sto, np.zeros(lz), "xy",
                             from0=lf, size0=lz)
                np.testing.assert_allclose(got, want, atol=1e-13,
                                           err_msg=f"case {case} step {step}")
            else:
                got = S.load(1.0, sto, np.zeros(lz[::-1]), "yx",
                             from0=lf, size0=lz)
                np.testing.assert_allclose(got, want.T, atol=1e-13,
                                           err_msg=f"case {case} step {step}T")
        S.close_storage(sto)


def test_save_overlapping_blocks_uncovered_raises(tmp_path):
    """Review regression: overlapping blocks made the coverage check
    double-count fragment volumes — a request over uncovered cells
    passed silently and dropped data.  Unique-cell accounting raises."""
    p = str(tmp_path / "ov.s3t")
    sto = S.create_storage(p, "x", (4,), dtype=np.float64)
    S.append_blocks(sto, [((0,), (2,)), ((0,), (2,))])   # identical blocks
    with pytest.raises(ValueError, match="not covered"):
        S.save(1.0, np.arange(4.0), "x", sto, "x")
    # fully-covered saves still work through the duplicated blocks
    S.save(1.0, np.arange(2.0), "x", sto, "x", from1=(0,))
    got = S.load(1.0, sto, np.zeros(2), "x", from0=(0,), size0=(2,))
    np.testing.assert_array_equal(got, [0.0, 1.0])
    S.close_storage(sto)


def test_save_stream_roundtrip_and_checksums(tmp_path):
    """save_stream is the write-side mirror of load_stream
    (storage.h:1002-1094 windowed MPI-IO writes): tiny windows, narrow
    (read-modify-write) windows, multi-block layouts, and streamed
    level-2 CRC recompute all land bit-identically with save()."""
    dim = (12, 10)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(dim)

    pa = str(tmp_path / "a.s3t")
    sa = S.create_storage(pa, "xy", dim, dtype=np.float64, checksum=2)
    S.append_blocks(sa, [((0, 0), (6, 10)), ((6, 0), (6, 10))])
    S.save(1.0, x, "xy", sa, "xy")
    S.close_storage(sa)

    pb = str(tmp_path / "b.s3t")
    sb = S.create_storage(pb, "xy", dim, dtype=np.float64, checksum=2)
    S.append_blocks(sb, [((0, 0), (6, 10)), ((6, 0), (6, 10))])
    # 3-row slabs crossing the block boundary at row 6
    S.save_stream(sb, ((
        (r, 0), x[r:r + 3]) for r in range(0, 12, 3)))
    S.close_storage(sb)
    assert open(pa, "rb").read() == open(pb, "rb").read()

    # narrow window (columns 2:5 only) -> read-modify-write path
    sb = S.open_storage(pb)
    y = x.copy()
    y[4:9, 2:5] = rng.standard_normal((5, 3))
    S.save_stream(sb, [((4, 2), y[4:9, 2:5])])
    S.check_or_write_checksums(sb)      # level-2 CRCs must still verify
    got = S.load(1.0, sb, np.zeros(dim), "xy")
    np.testing.assert_array_equal(got, y)
    S.close_storage(sb)

    # file-to-file streaming copy: save_stream(dst, load_stream(src))
    pc = str(tmp_path / "c.s3t")
    sc = S.create_storage(pc, "xy", dim, dtype=np.float64, checksum=0)
    S.append_blocks(sc, [((0, 0), dim)])
    src = S.open_storage(pb, mode="r")
    S.save_stream(sc, S.load_stream(src, max_window_bytes=200))
    got = S.load(1.0, sc, np.zeros(dim), "xy")
    np.testing.assert_array_equal(got, y)
    S.close_storage(sc)
    S.close_storage(src)


def test_save_stream_outside_blocks_raises(tmp_path):
    p = str(tmp_path / "d.s3t")
    sto = S.create_storage(p, "xy", (8, 8), dtype=np.float64)
    S.append_blocks(sto, [((0, 0), (4, 8))])
    with pytest.raises(ValueError, match="not covered"):
        S.save_stream(sto, [((0, 0), np.zeros((6, 8)))])
    S.close_storage(sto)


def test_save_stream_unblocked_crc(tmp_path, monkeypatch):
    """_refresh_block_crc must mirror _blocked_crc when the file's
    checksum_blocksize is <= 0 (CRC blocking disabled, storage.h:698-730
    — the blocked scheme wraps piece CRCs, the unblocked one is the
    PLAIN data CRC): save_stream on such a file must leave level-2
    checksums verifiable."""
    monkeypatch.setattr(S, "DEFAULT_CHECKSUM_BLOCKSIZE", 0)
    dim = (6, 8)
    rng = np.random.default_rng(7)
    x = rng.standard_normal(dim)
    p = str(tmp_path / "u.s3t")
    sto = S.create_storage(p, "xy", dim, dtype=np.float64, checksum=2)
    assert sto.checksum_blocksize <= 0
    S.append_blocks(sto, [((0, 0), dim)])
    S.save(1.0, x, "xy", sto, "xy")
    S.close_storage(sto)

    sto = S.open_storage(p)
    y = x.copy()
    y[2:4] = rng.standard_normal((2, 8))
    S.save_stream(sto, [((2, 0), y[2:4])])
    S.check_or_write_checksums(sto)   # must verify, not raise
    got = S.load(1.0, sto, np.zeros(dim), "xy")
    np.testing.assert_array_equal(got, y)
    S.close_storage(sto)


def test_save_stream_byteswapped_file(tmp_path):
    """save_stream into a byteswapped (big-endian, reference-written)
    file must keep the declared byte order through the row-subrange
    writes and leave the raw bytes big-endian."""
    import struct

    path = str(tmp_path / "bes.s3t")
    dim = (4, 3)
    vals = (np.arange(12) * 0.5).reshape(dim)
    meta = b"be!"
    pad = b"\x00" * ((8 - len(meta) % 8) % 8)
    hdr = struct.pack(">6i", 314, 0, 1, 0, 2, len(meta)) + meta + pad
    hdr += np.asarray(dim, dtype=">f8").tobytes()
    hdr += struct.pack(">d", float(64 * 1024 * 1024))
    hdr += struct.pack(">d", 1.0)
    chunk = struct.pack(">d", 1.0)
    chunk += np.asarray((0, 0), dtype=">f8").tobytes()
    chunk += np.asarray(dim, dtype=">f8").tobytes()
    chunk += vals.astype(">f8").tobytes()
    with open(path, "wb") as f:
        f.write(hdr + chunk)

    sto = S.open_storage(path, mode="r+")
    assert sto.byteswap
    y = vals.copy()
    y[1:3] = 9.0
    S.save_stream(sto, [((1, 0), y[1:3])])
    got = S.load(1.0, sto, np.zeros(dim), "xy")
    np.testing.assert_array_equal(got, y)
    S.close_storage(sto)
    with open(path, "rb") as f:
        raw = f.read()
    arr = np.frombuffer(raw[-12 * 8:], dtype=">f8").reshape(dim)
    np.testing.assert_array_equal(arr, y)


def test_read_storage_header(tmp_path):
    """Header fields without a full open (read_storage_header,
    storage.h:2161, 2405)."""
    p = str(tmp_path / "hd.s3t")
    sto = S.create_storage(p, "xyz", (4, 6, 2), dtype=np.complex64,
                           metadata="hdr-meta", checksum=1)
    S.close_storage(sto)
    dtype, metadata, dim, level = S.read_storage_header(p)
    assert dtype == np.complex64
    assert metadata == "hdr-meta"
    assert dim == (4, 6, 2)
    assert level == 1


def test_get_blocks_windows_and_permutation(tmp_path):
    """get_blocks returns stored-block overlaps in DESTINATION
    coordinates (get_blocks, storage.h:1397-1420, 2330-2344)."""
    p = str(tmp_path / "gb.s3t")
    sto = S.create_storage(p, "xy", (4, 6), dtype=np.float64)
    S.append_blocks(sto, [((0, 0), (4, 3)), ((0, 3), (4, 3))])
    # identity order, full window
    assert sorted(S.get_blocks(sto, "xy")) == [
        ((0, 0), (4, 3)), ((0, 3), (4, 3))]
    # permuted destination order: boxes transpose
    assert sorted(S.get_blocks(sto, "xy", "yx")) == [
        ((0, 0), (3, 4)), ((3, 0), (3, 4))]
    # a window inside one block clips to the window
    assert S.get_blocks(sto, "xy", "xy", from1=(1, 1), size1=(2, 1)) == [
        ((1, 1), (2, 1))]
    # a wrapped window seam-splits (one fragment per linear piece)
    got = sorted(S.get_blocks(sto, "xy", "xy", from1=(3, 2), size1=(2, 2)))
    assert got == [((0, 2), (1, 1)), ((0, 3), (1, 1)),
                   ((3, 2), (1, 1)), ((3, 3), (1, 1))]
    S.close_storage(sto)


def test_flush_and_preallocate(tmp_path):
    """flush_storage resolves pending async writes and makes the bytes
    visible to other handles BEFORE close (flush_storage, storage.h:2434);
    preallocate_storage is a physical-allocation hint that leaves the
    logical layout untouched (preallocate_storage, storage.h:2427)."""
    p = str(tmp_path / "fl.s3t")
    sto = S.create_storage(p, "xy", (4, 4), dtype=np.float64, checksum=1)
    size_before = os.path.getsize(p)
    S.preallocate_storage(sto, 1 << 16)
    assert os.path.getsize(p) == size_before   # KEEP_SIZE: logical size
    S.append_blocks(sto, [((0, 0), (4, 4))])
    x = np.arange(16.0).reshape(4, 4)
    fut = S.save_async(1.0, x, "xy", sto, "xy")
    S.flush_storage(sto)
    assert fut.done()
    other = S.open_storage(p, mode="r")
    got = S.load(1.0, other, np.zeros((4, 4)), "xy")
    np.testing.assert_array_equal(got, x)
    S.close_storage(other)
    S.close_storage(sto)   # resolves nothing: _pending already drained
    back = S.open_storage(p, mode="r")
    S.check_or_write_checksums(back)
    S.close_storage(back)

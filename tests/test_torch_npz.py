"""The port's block-parallel .npz writer (`utils/npz.py`) on the CPU: what
`np.load` and `zipfile` read back, the archive's layout against
`np.savez_compressed`'s, members at the edges of a deflate block, the same
bytes whatever the number of workers, the size against numpy's, the path
rule and the DEFLATE counter."""

from __future__ import annotations

import os
import struct
import zipfile

import numpy as np
import pytest

from simd_minimizers_tpu_torch.utils import npz, profiling


def _header_len(a: np.ndarray) -> int:
    return len(npz._npy_header(np.asarray(a, order="C")))


def _compressible(rng, n: int) -> np.ndarray:
    """n bytes of a skewed four-letter alphabet: deflates to about a third."""
    return np.frombuffer(b"ACGT", np.uint8)[rng.choice(4, n, p=[0.55, 0.25, 0.15, 0.05])]


def _cell_like(rng, n: int) -> dict:
    """A record as the CLI writes it: sorted u32 positions at density about
    1/6 and 42-bit u64 values."""
    pos = np.cumsum(rng.integers(1, 12, n)).astype(np.uint32)
    return {"chr1/positions": pos, "chr1/values": rng.integers(0, 1 << 42, n, dtype=np.uint64)}


def _assert_loads(path, arrays: dict):
    with np.load(path) as z:
        assert z.files == list(arrays)
        for key, a in arrays.items():
            assert z[key].dtype == a.dtype and z[key].shape == a.shape
            np.testing.assert_array_equal(z[key], a)


def _local_zip64_sizes(path, info: zipfile.ZipInfo) -> tuple:
    """(file size, compressed size) from the zip64 extra field of the
    member's local header; the 32-bit fields must say 0xFFFFFFFF."""
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        head = f.read(zipfile.sizeFileHeader)
        sig, *_, compressed, uncompressed, name_len, extra_len = struct.unpack(
            zipfile.structFileHeader, head)
        assert sig == zipfile.stringFileHeader and compressed == uncompressed == 0xFFFFFFFF
        extra = f.read(name_len + extra_len)[name_len:]
    tag, size, file_size, compress_size = struct.unpack("<HHQQ", extra)
    assert (tag, size) == (1, 16)
    return file_size, compress_size


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64, np.bool_])
def test_round_trip(dtype, tmp_path):
    rng = np.random.default_rng(7)
    arrays = {f"chr{i}/positions": rng.integers(0, 2, n).astype(dtype) if dtype == np.bool_
              else rng.integers(0, np.iinfo(dtype).max, n, dtype=dtype, endpoint=True)
              for i, n in enumerate([0, 1, 1000, 300_000])}
    arrays["scalar"] = np.array(5, dtype)
    w = npz.savez_compressed(tmp_path / "s.npz", arrays)
    _assert_loads(w.path, arrays)


def test_archive_is_deflated_zip64(tmp_path):
    rng = np.random.default_rng(8)
    arrays = {**_cell_like(rng, 1_500_000), "b": rng.integers(0, 2, 99).astype(bool)}
    w = npz.savez_compressed(tmp_path / "s", arrays)
    with zipfile.ZipFile(w.path) as z:
        assert z.testzip() is None
        infos = z.infolist()
        assert [i.filename for i in infos] == [k + ".npy" for k in arrays]
        for i in infos:
            assert i.compress_type == zipfile.ZIP_DEFLATED and i.flag_bits == 0
            assert i.extract_version == i.create_version == zipfile.ZIP64_VERSION
            assert _local_zip64_sizes(w.path, i) == (i.file_size, i.compress_size)
    assert w.raw_bytes == sum(i.file_size for i in infos)
    assert w.deflated_bytes == sum(i.compress_size for i in infos)


def test_one_block_members_are_numpys_bytes(tmp_path):
    """Where every member is one block, the file is np.savez_compressed's
    byte for byte: the same headers, records and deflate streams."""
    rng = np.random.default_rng(9)
    arrays = {**_cell_like(rng, 200_000), "e": np.zeros(0, np.uint32),
              "m": rng.integers(0, 9, (30, 7)).astype(np.int16), "b": rng.random(500) < 0.3}
    ours = npz.savez_compressed(tmp_path / "a.npz", arrays)
    np.savez_compressed(tmp_path / "b.npz", **arrays)
    assert ours.blocks == len(arrays)
    assert (tmp_path / "a.npz").read_bytes() == (tmp_path / "b.npz").read_bytes()


@pytest.mark.parametrize("data_bytes", ["0", "block-1", "block", "block+1", "3 blocks+12345"])
def test_members_at_the_edges_of_a_block(data_bytes, tmp_path):
    """A member's bytes (its NPY header, then the array's) of none, one
    under, exactly at and one over a block, and of several blocks."""
    h = _header_len(np.zeros(npz.BLOCK, np.uint8))
    n = {"0": 0, "block-1": npz.BLOCK - h - 1, "block": npz.BLOCK - h,
         "block+1": npz.BLOCK - h + 1, "3 blocks+12345": 3 * npz.BLOCK + 12345}[data_bytes]
    a = _compressible(np.random.default_rng(n), n)
    assert _header_len(a) == h
    w = npz.savez_compressed(tmp_path / "s.npz", {"r/codes": a})
    assert w.blocks == -(-(h + n) // npz.BLOCK) and w.raw_bytes == h + n
    with zipfile.ZipFile(w.path) as z:
        assert z.testzip() is None
    _assert_loads(w.path, {"r/codes": a})


@pytest.mark.parametrize("kind", ["strided", "fortran"])
def test_non_contiguous_input_is_written_in_c_order(kind, tmp_path):
    rng = np.random.default_rng(10)
    base = rng.integers(0, 1 << 30, (600, 500), dtype=np.uint32)
    a = base[::3, 1::2] if kind == "strided" else base.T
    assert not a.flags.c_contiguous
    w = npz.savez_compressed(tmp_path / "s.npz", {"a": a})
    _assert_loads(w.path, {"a": a})
    with zipfile.ZipFile(w.path) as z, z.open("a.npy") as f:
        assert np.lib.format.read_magic(f) == (1, 0)
        shape, fortran_order, dtype = np.lib.format.read_array_header_1_0(f)
        assert shape == a.shape and not fortran_order and dtype == a.dtype
        assert f.read() == np.ascontiguousarray(a).tobytes()


def test_same_bytes_whatever_the_workers(tmp_path, monkeypatch):
    """Block boundaries depend on the bytes alone: one worker and eight
    write the same file."""
    rng = np.random.default_rng(11)
    arrays = {**_cell_like(rng, 1_200_000), "r/codes": _compressible(rng, 2 * npz.BLOCK + 99)}
    written = []
    for cpus in (1, 8):
        monkeypatch.setattr(os, "sched_getaffinity", lambda pid, n=cpus: set(range(n)))
        written.append(npz.savez_compressed(tmp_path / f"w{cpus}.npz", arrays))
    assert written[0].blocks == written[1].blocks > 4
    assert (written[0].workers, written[1].workers) == (1, 8)
    assert (tmp_path / "w1.npz").read_bytes() == (tmp_path / "w8.npz").read_bytes()
    _assert_loads(written[1].path, arrays)


def test_size_within_a_hundredth_of_a_percent_of_numpys(tmp_path):
    """On a compressible payload of several blocks a member, the blocks'
    flushes cost under 0.01% of np.savez_compressed's size."""
    rng = np.random.default_rng(12)
    arrays = _cell_like(rng, 2_200_000)  # 8.8 MB and 17.6 MB: 3 and 5 blocks
    w = npz.savez_compressed(tmp_path / "a.npz", arrays)
    np.savez_compressed(tmp_path / "b.npz", **arrays)
    assert w.blocks == 8
    ours, theirs = os.path.getsize(w.path), os.path.getsize(tmp_path / "b.npz")
    assert abs(ours - theirs) <= 1e-4 * theirs


@pytest.mark.parametrize("name, want", [("out", "out.npz"), ("out.npz", "out.npz"),
                                        ("out.tar", "out.tar.npz")])
def test_npz_suffix_is_appended(name, want, tmp_path):
    w = npz.savez_compressed(tmp_path / name, {"x": np.arange(3)})
    assert w.path == str(tmp_path / want) and os.path.exists(w.path)
    assert sorted(os.listdir(tmp_path)) == [want]


def test_deflate_counter_adds_each_write(tmp_path):
    """DEFLATE adds every write's blocks, workers and bytes; PROFILED too
    while a span records; BUS_BYTES is left alone."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(13)
    arrays = {"r/codes": _compressible(rng, npz.BLOCK + 5), "r/x": np.arange(10)}
    bus = profiling.BUS_BYTES.copy()
    before = profiling.DEFLATE.copy()
    profiling.PROFILED["deflate"].clear()
    w1 = npz.savez_compressed(tmp_path / "a.npz", arrays)
    assert not profiling.PROFILED["deflate"]
    with profile(activities=[ProfilerActivity.CPU]), profiling.span("write npz"):
        w2 = npz.savez_compressed(tmp_path / "b.npz", arrays)
    one = {"blocks": 3, "workers": w1.workers, "bytes in": w1.raw_bytes,
           "bytes out": w1.deflated_bytes}
    assert w2 == w1._replace(path=w2.path)
    assert dict(profiling.DEFLATE - before) == {k: 2 * v for k, v in one.items()}
    assert dict(profiling.PROFILED["deflate"]) == one
    assert profiling.BUS_BYTES == bus


def test_zip64_records_past_the_limit(tmp_path):
    """The central record and the end records of a member past 2 GiB, read
    back by zipfile: sizes and offset from the zip64 extra field, the
    directory's place from the zip64 end record. The file is a hole up to
    the directory (sparse), since zipfile reads no member to list them."""
    z = zipfile.ZipInfo("big/values.npy")
    z.compress_type = zipfile.ZIP_DEFLATED
    z.file_size, z.compress_size, z.CRC = 6 << 30, 5 << 30, 12345
    z.header_offset = zipfile.ZIP64_LIMIT + 1
    z.FileHeader(zip64=True)  # as the writer leaves it: versions 4.5
    start = zipfile.ZIP64_LIMIT + 4096
    path = tmp_path / "sparse.npz"
    with open(path, "wb") as f:
        f.seek(start)
        f.write(npz._central_record(z))
        f.write(npz._end_records(1, start, f.tell()))
    with zipfile.ZipFile(path) as zf:
        (info,) = zf.infolist()
        assert zf.start_dir == start
    assert (info.filename, info.file_size, info.compress_size, info.CRC, info.header_offset) == \
        ("big/values.npy", 6 << 30, 5 << 30, 12345, zipfile.ZIP64_LIMIT + 1)
    assert info.extract_version == zipfile.ZIP64_VERSION


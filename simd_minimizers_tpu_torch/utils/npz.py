"""A compressed .npz written with block-parallel deflate, on every CPU the
process may use.

`savez_compressed(path, arrays)` writes the file that
`np.savez_compressed(path, **arrays)` writes, and `np.load` and `zipfile`
read it unchanged: a zip64 archive of one deflated member `<key>.npy` per
array, in the dict's order, each member the NPY header of `np.lib.format`
and the array's C-order bytes; deflate at zlib level 6 with a raw 15-bit
window; local headers in zip64 form, the central directory and the end
records as `zipfile` writes them; a CRC-32 of every member.

Only the deflate streams of members past one block differ: a file whose
members are each one block is `np.savez_compressed`'s byte for byte (every
member dated 1980-01-01, as `zipfile.ZipFile.open` dates it). A member is
cut into blocks of `BLOCK` bytes; each block after the first is deflated
with the 32 KiB before it as its dictionary, and every block but the last
ends in a sync flush, so the blocks concatenate into one deflate stream (as
pigz makes it), some tens of bytes a block longer than zlib's. The blocks
depend on the bytes alone, so the file is the same whatever the number of
workers: a thread pool of `len(os.sched_getaffinity(0))`, no more than
there are blocks, with about two blocks a worker in flight, written in
order as they come back. zlib releases the interpreter lock in deflate and
in crc32; blocks are slices of the array's own memory, never a copy of a
whole member.

Each call counts its blocks, workers and bytes in and out into
`utils.profiling.DEFLATE` (`count_deflate`)."""

from __future__ import annotations

import collections
import io
import itertools
import os
import struct
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np

from .profiling import count_deflate

LEVEL = 6  # zlib's default level, the one zipfile deflates at
BLOCK = 4 << 20  # bytes of a member a block
WINDOW = 32 << 10  # deflate's window: the dictionary of the next block
IN_FLIGHT = 2  # blocks a worker deflated or deflating but not yet written


class Written(NamedTuple):
    """What `savez_compressed` wrote."""

    path: str
    raw_bytes: int  # the members' bytes: NPY headers and arrays
    deflated_bytes: int  # their deflate streams
    blocks: int
    workers: int


class _Member:
    """One array as a member of the archive: its ZipInfo, its NPY header and
    its bytes."""

    def __init__(self, key: str, array):
        a = np.asarray(array, order="C")
        self.header = memoryview(_npy_header(a))
        self.data = memoryview(a.reshape(-1).view(np.uint8)) if a.nbytes else memoryview(b"")
        self.size = len(self.header) + len(self.data)
        self.zinfo = zipfile.ZipInfo(key + ".npy")
        self.zinfo.compress_type = zipfile.ZIP_DEFLATED
        self.zinfo.external_attr = 0o600 << 16  # ?rw-------, as zipfile sets it
        self.zinfo.file_size = self.size
        self.zinfo.CRC = 0  # until its future below is read
        self.crc = None  # the future of its CRC-32

    def pieces(self, lo: int, hi: int) -> list:
        """The member's bytes [lo, hi) as views: the header's part, then the
        data's."""
        h = len(self.header)
        out = [self.header[lo:min(hi, h)]] if lo < h else []
        if hi > h:
            out.append(self.data[max(lo, h) - h:hi - h])
        return out

    def crc32(self) -> int:
        return zlib.crc32(self.data, zlib.crc32(self.header))


def _npy_header(a: np.ndarray) -> bytes:
    """The NPY header `np.save` writes for `a` (version 1.0, which holds the
    header of any array short of a structured dtype of thousands of fields;
    past that it raises)."""
    buf = io.BytesIO()
    np.lib.format.write_array_header_1_0(buf, np.lib.format.header_data_from_array_1_0(a))
    return buf.getvalue()


def _deflate(pieces: list, zdict, last: bool) -> bytes:
    """One block's deflate stream: primed with `zdict` (None for a member's
    first block), ended in a sync flush, a member's last block in Z_FINISH."""
    if zdict is None:
        c = zlib.compressobj(LEVEL, zlib.DEFLATED, -15)
    else:
        c = zlib.compressobj(LEVEL, zlib.DEFLATED, -15, zdict=zdict)
    out = [c.compress(p) for p in pieces]
    out.append(c.flush(zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH))
    return b"".join(out)


def _central_record(z: zipfile.ZipInfo) -> bytes:
    """The member's central directory entry, as `zipfile.ZipFile` writes
    it: zip64 fields only for what passes ZIP64_LIMIT."""
    extra = []
    file_size, compress_size, offset = z.file_size, z.compress_size, z.header_offset
    if file_size > zipfile.ZIP64_LIMIT or compress_size > zipfile.ZIP64_LIMIT:
        extra += [file_size, compress_size]
        file_size = compress_size = 0xFFFFFFFF
    if offset > zipfile.ZIP64_LIMIT:
        extra.append(offset)
        offset = 0xFFFFFFFF
    extra_data = struct.pack("<HH" + "Q" * len(extra), 1, 8 * len(extra), *extra) if extra else b""
    try:
        name, flag_bits = z.filename.encode("ascii"), z.flag_bits
    except UnicodeEncodeError:
        name, flag_bits = z.filename.encode("utf-8"), z.flag_bits | 0x800
    y, mo, d, h, mi, sec = z.date_time
    dostime, dosdate = h << 11 | mi << 5 | sec // 2, (y - 1980) << 9 | mo << 5 | d
    return struct.pack(zipfile.structCentralDir, zipfile.stringCentralDir, z.create_version,
                       z.create_system, z.extract_version, z.reserved, flag_bits,
                       z.compress_type, dostime, dosdate, z.CRC, compress_size, file_size,
                       len(name), len(extra_data), 0, 0, z.internal_attr, z.external_attr,
                       offset) + name + extra_data


def _end_records(count: int, start_dir: int, end_dir: int) -> bytes:
    """The end of central directory record, after the zip64 one and its
    locator where the count, offset or size needs them (as zipfile)."""
    size = end_dir - start_dir
    out = b""
    if (count > zipfile.ZIP_FILECOUNT_LIMIT or start_dir > zipfile.ZIP64_LIMIT
            or size > zipfile.ZIP64_LIMIT):
        out = struct.pack(zipfile.structEndArchive64, zipfile.stringEndArchive64,
                          zipfile.sizeEndCentDir64 - 12, 45, 45, 0, 0, count, count, size,
                          start_dir)
        out += struct.pack(zipfile.structEndArchive64Locator, zipfile.stringEndArchive64Locator,
                           0, end_dir, 1)
        count, size, start_dir = min(count, 0xFFFF), min(size, 0xFFFFFFFF), min(start_dir,
                                                                                0xFFFFFFFF)
    return out + struct.pack(zipfile.structEndArchive, zipfile.stringEndArchive, 0, 0, count,
                             count, size, start_dir, 0)


def savez_compressed(path, arrays: dict) -> Written:
    """Writes `arrays` (name -> array) as `np.savez_compressed(path,
    **arrays)` would, deflating blocks of every member on a thread pool of
    one worker per CPU the process may use; `.npz` is appended to a path
    without it. Returns what it wrote."""
    path = os.fspath(path)
    if not path.endswith(".npz"):
        path += ".npz"
    members = [_Member(key, a) for key, a in arrays.items()]
    blocks = sum(-(-m.size // BLOCK) for m in members)
    workers = max(min(len(os.sched_getaffinity(0)), blocks), 1)
    with open(path, "wb") as f, ThreadPoolExecutor(workers) as pool:

        def submitted():  # (member, first byte, future of its stream), in file order
            for m in members:
                m.crc = pool.submit(m.crc32)
                for lo in range(0, m.size, BLOCK):
                    hi = min(lo + BLOCK, m.size)
                    zdict = None if lo == 0 else b"".join(m.pieces(lo - WINDOW, lo))
                    yield m, lo, pool.submit(_deflate, m.pieces(lo, hi), zdict, hi == m.size)

        stream = submitted()
        ahead = collections.deque(itertools.islice(stream, IN_FLIGHT * workers))
        while ahead:
            m, lo, block = ahead.popleft()
            ahead.extend(itertools.islice(stream, 1))
            z = m.zinfo
            if lo == 0:
                z.header_offset = f.tell()
                f.write(z.FileHeader(zip64=True))  # sizes and CRC written at its end
            out = block.result()
            f.write(out)
            z.compress_size += len(out)
            if lo + BLOCK >= m.size:
                z.CRC = m.crc.result()
                end = f.tell()
                f.seek(z.header_offset)
                f.write(z.FileHeader(zip64=True))
                f.seek(end)
        start_dir = f.tell()
        for m in members:
            f.write(_central_record(m.zinfo))
        f.write(_end_records(len(members), start_dir, f.tell()))
    raw = sum(m.size for m in members)
    deflated = sum(m.zinfo.compress_size for m in members)
    count_deflate({"blocks": blocks, "workers": workers, "bytes in": raw, "bytes out": deflated})
    return Written(path, raw, deflated, blocks, workers)

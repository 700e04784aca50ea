"""The large-w route's pre-pass, kmer_top16, on the CPU: its plain version
(`pipeline.kmer_top16_plain`) against the JAX package's hashes of the same
inputs, and the wrapper on a CPU tensor.

The kernel itself (csrc/top16.cu) runs only on a card
(tests/test_torch_cuda.py, chip_smoke.py); on a CPU tensor its wrapper runs
this plain version and counts no launch. Inputs are made with numpy from a
seed; the tops are integers, so the tolerance is 0. The JAX side is
`hash_kmers_np(codes) >> 16` for 2-bit codes (packed and one code per byte)
and `pipeline.kmer_hashes_2d` on one row of text bytes, as
tests/test_torch_hashers.py runs it.

`model_kmer_top16` below is a NumPy model of csrc/top16.cu's arithmetic
(the package does not import it): the prefix-XOR fold through the
(p mod 32, c_out, c_in) pair table, the runs' scan, the block's O(k)
reduction at its first chunk, the carry from chunk to chunk over a
persistent grid, and the antilex tops read from the packed stream; run with
a small chunk so that several chunks, several blocks and k > chunk are
covered, and held bit-equal to the plain version.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simd_minimizers_tpu.hashers import AntiLexHasher, MulHasher, NtHasher
from simd_minimizers_tpu.ops import pipeline as jpipe
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import fused, pipeline
from simd_minimizers_tpu_torch.seq.packed import GenericSeq, PackedSeqVec

KINDS = {"nt": NtHasher, "mul": MulHasher, "antilex": AntiLexHasher}
KS = [1, 5, 21, 31, 64]
NS = ["k - 1", "k", "10,000"]


def _n(k: int, which: str) -> int:
    return {"k - 1": k - 1, "k": k, "10,000": 10_000}[which]


def _tops(got: torch.Tensor) -> np.ndarray:
    assert got.dtype == torch.int16
    return got.numpy().view(np.uint16)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("which", NS)
def test_plain_vs_jax_hashes_of_2bit_codes(kind, canonical, k, which):
    """2-bit codes, packed and as code bytes (high bits set, which the
    kernel ignores), seeded and not: the top halves of the JAX hasher's
    `hash_kmers_np`."""
    n = _n(k, which)
    codes = np.random.default_rng(k * 10 + n).integers(0, 4, n, dtype=np.uint8)
    for seed in (None, 7):
        jh = KINDS[kind](k, canonical=canonical, seed=seed)
        want = (jh.hash_kmers_np(codes) >> 16).astype(np.uint16)
        (kd, can, rot), tables = convert.hasher_tensors(convert.hasher_from(jh), "cpu")
        packed = convert.packed_words(PackedSeqVec.from_codes(codes), "cpu")
        np.testing.assert_array_equal(
            _tops(pipeline.kmer_top16_plain(packed, n, k, tables, rot, can, kind=kd)), want)
        high = convert.code_bytes(codes | 0xF0, "cpu")
        np.testing.assert_array_equal(
            _tops(pipeline.kmer_top16_plain(high, n, k, tables, rot, can, kind=kd,
                                            byte_codes=True)), want)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("which", NS)
def test_plain_vs_jax_pipeline_on_text(kind, canonical, k, which):
    """Text bytes: the top halves of the JAX pipeline's `kmer_hashes_2d` on
    one row of the same bytes."""
    n = _n(k, which)
    text = np.random.default_rng(k * 10 + n + 1).integers(0, 256, n, dtype=np.uint8)
    jh = KINDS[kind](k, canonical=canonical)
    (kd, can, rot), tables = convert.hasher_tensors(convert.hasher_from(jh), "cpu", text=True)
    got = _tops(pipeline.kmer_top16_plain(convert.text_bytes(GenericSeq(text), "cpu"), n, k,
                                          tables, rot, can, text=True, kind=kd))
    if n < k:
        assert got.size == 0
        return
    want = np.asarray(jpipe.kmer_hashes_2d(jnp.asarray(text[None, :]), jh, n))[0] >> 16
    np.testing.assert_array_equal(got, want.astype(np.uint16))


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("text", [False, True])
def test_wrapper_on_cpu_is_the_plain_version(kind, text):
    """fused.kmer_top16 on a CPU tensor returns the plain version and
    launches nothing; LAUNCHES counts the kernel by name; below one k-mer
    the result is empty."""
    k, n = 21, 5000
    rng = np.random.default_rng(3)
    jh = KINDS[kind](k, canonical=not text)
    (kd, can, rot), tables = convert.hasher_tensors(convert.hasher_from(jh), "cpu", text=text)
    if text:
        chars, kw = convert.text_bytes(GenericSeq(rng.integers(0, 256, n, dtype=np.uint8)),
                                       "cpu"), {"text": True}
    else:
        chars = convert.packed_words(PackedSeqVec.from_codes(
            rng.integers(0, 4, n, dtype=np.uint8)), "cpu")
        kw = {}
    assert "kmer_top16" in fused.LAUNCHES
    before = dict(fused.LAUNCHES)
    got = fused.kmer_top16(chars, n, k, tables, rot, can, kind=kd, **kw)
    assert torch.equal(got, pipeline.kmer_top16_plain(chars, n, k, tables, rot, can, kind=kd,
                                                      **kw))
    assert got.shape == (n - k + 1,)
    assert fused.kmer_top16(chars, k - 1, k, tables, rot, can, kind=kd, **kw).numel() == 0
    assert fused.LAUNCHES == before


def test_top16_argument_is_checked():
    """minimizer_tiles takes a `top16` array on the large-w route only, of
    int16 and at least n - k + 1 values; the CPU's plain version hashes on
    both routes and returns the same with or without it."""
    k = 21
    rng = np.random.default_rng(4)
    h = convert.hasher_from(NtHasher(k))
    (kd, can, rot), tables = convert.hasher_tensors(h, "cpu")
    for w in (11, fused.LARGE_W_MIN):
        n = fused.TILE + k + w + 50
        chars = convert.packed_words(PackedSeqVec.from_codes(
            rng.integers(0, 4, n, dtype=np.uint8)), "cpu")
        args = (chars, n, k, w, tables, rot, can)
        tops = fused.kmer_top16(chars, n, k, tables, rot, can, kind=kd)
        if fused.sub_tile(k, w, can) == 0:
            with pytest.raises(ValueError, match="large-w route only"):
                fused.minimizer_tiles(*args, top16=tops)
            continue
        want = fused.minimizer_tiles(*args)
        got = fused.minimizer_tiles(*args, top16=tops)
        assert all(torch.equal(g, p) for g, p in zip(got, want, strict=True))
        for bad in (tops.to(torch.int32), tops[:-1]):
            with pytest.raises(ValueError, match="top16"):
                fused.minimizer_tiles(*args, top16=bad)


@pytest.mark.parametrize("name", ["large-w branch", "pre-pass"])
def test_sources_hash_where_they_should(name):
    """The large-w branch of minimizer_tiles hashes nothing and reads no
    table (it reads kmer_top16's tops); the pre-pass has its own hash."""
    csrc = Path(fused.__file__).resolve().parents[1] / "csrc"
    if name == "pre-pass":
        # each top O(1) whatever k: one load of the pair table a k-mer, the
        # runs' scan, bulk copies; the one loop over k chars is the block's
        # state at its first chunk
        src = (csrc / "top16.cu").read_text()
        assert "pair[CODES * CODES * q + nib]" in src and "cp.async.bulk" in src
        assert src.count("p < b0 + k") == 1
        return
    src = (csrc / "minimizers.cu").read_text()
    branch = re.search(r"\n  } else {\n    // large-w route(.*?)\n  // B3/B4/B5/B6", src, re.S)
    assert branch is not None
    body = branch.group(1)
    assert "top16" in body
    for word in ("hash_cols", "rotl", "rotr", "tF[", "tR[", "s_roll", "table["):
        assert word not in body, word


# -- a model of csrc/top16.cu's arithmetic ------------------------------------

M32 = np.uint64(0xFFFFFFFF)
MODEL_RUN = 32  # k-mers a thread hashes per chunk (the kernel's RUN)
MODEL_THREADS = 4  # threads a block (the kernel: 256): a chunk of 128 k-mers
MODEL_CHUNK = MODEL_THREADS * MODEL_RUN
MODEL_GRID = 3  # blocks of the persistent grid (the kernel: SMs x blocks per SM)
MODEL_KS = [1, 2, 15, 16, 17, 21, 31, 32, 33, 63, 64, 100, MODEL_CHUNK + 3]
ANTILEX_KS = [1, 7, 8, 16, 17]
INPUTS = ["2-bit", "code bytes", "text"]


def _rotl(x, r):
    """u32 values in uint64, rotated left by r mod 32 (arrays broadcast)."""
    r = (np.asarray(r, dtype=np.int64) % 32).astype(np.uint64)
    x = np.asarray(x, dtype=np.uint64) & M32
    return ((x << r) | (x >> (np.uint64(32) - r))) & M32


def _rotr(x, r):
    return _rotl(x, -np.asarray(r, dtype=np.int64))


def _model_codes(data: np.ndarray, n: int, inp: str, fold_text: bool) -> np.ndarray:
    """The kernel's codes of the first n chars: 2-bit fields of the byte
    stream, the low two bits of a byte, or a text byte itself."""
    if inp == "2-bit":
        c = (data[:, None] >> np.arange(0, 8, 2, dtype=np.uint8)) & 3
        return c.reshape(-1)[:n].astype(np.int64)
    return data[:n].astype(np.int64) & (0xFF if fold_text else 3)


def model_kmer_top16(data: np.ndarray, n: int, k: int, tables, rot: int, canonical: bool,
                     kind: str, inp: str) -> np.ndarray:
    """csrc/top16.cu's tops (uint16, one per k-mer) computed its way.

    Fold (nt, mul): with Fa = rotl(F, rot), Fb = rotl(F, k + rot),
    Ra = rotl(R, k - 1 + rot), Rb = rotl(R, rot - 1), S_{p+1} = S_p ^ T_p
    where T_p = rotl(Fa[c_p] ^ Fb[c_{p+k}], p) (the complement strand:
    rotr(Ra[c_p] ^ Rb[c_{p+k}], p)); for 2-bit codes T_p is the entry
    (p mod 32, c_p, c_{p+k}) of the pair table. Block b of the grid owns the
    chunks [C b / G, C (b + 1) / G) and starts from S at its first k-mer,
    XOR_{p<k} rotl(Fa[c_p], p) (one block reduction); a chunk's thread t
    takes the exclusive prefix XOR of the T of its run of 32 k-mers, the
    runs' totals are scanned, and the chunk's total carries S to the next
    chunk. A top is (rotr(S_i, i) ^ rotl(S'_i, i)) >> 16.
    Antilex: a top is chars i .. i + 7 reversed into MSB-first order,
    complemented (forward) or XORed with chars i + k - 8 .. i + k - 1
    complemented (canonical; below k = 8 the k-mer's own chars, shifted to
    the top), masked to the first min(k, 16) chars."""
    nk = n - k + 1
    out = np.zeros(max(nk, 0), np.uint16)
    if nk <= 0:
        return out
    fold_text = inp == "text" and kind != "antilex"
    c = np.zeros(n + MODEL_CHUNK + 64, np.int64)  # chars past n read as 0
    c[:n] = _model_codes(data, n, inp, fold_text)
    if kind == "antilex":
        keep = 0xFFFFFFFF if k >= 16 else (0xFFFFFFFF << (32 - 2 * k)) & 0xFFFFFFFF
        i = np.arange(nk)
        la = sum(c[i + j] << (30 - 2 * j) for j in range(16))  # chars i .. i + 15, MSB-first
        if not canonical:
            return (((~la | ~keep) & 0xFFFFFFFF) >> 16).astype(np.uint16)
        kin, shift = (k - 8, 16) if k >= 8 else (0, 32 - 2 * k)
        nat = sum((c[i + kin + j] ^ 2) << (2 * j) for j in range(16))  # complemented, LSB-first
        return ((((la ^ (nat << shift)) & keep) & 0xFFFFFFFF) >> 16).astype(np.uint16)
    F, R = (np.asarray(t, dtype=np.int64).astype(np.uint64) & M32 for t in tables)
    Fa, Fb, Ra, Rb = _rotl(F, rot), _rotl(F, k + rot), _rotl(R, k - 1 + rot), _rotl(R, rot - 1)
    if not fold_text:  # the pair table, (p mod 32, c_out, c_in) -> T of both strands
        q = np.arange(32)[:, None, None]
        pair_f = _rotl(Fa[None, :, None] ^ Fb[None, None, :], q).reshape(32, 16)
        pair_r = _rotr(Ra[None, :, None] ^ Rb[None, None, :], q).reshape(32, 16)
    nchunks = -(-nk // MODEL_CHUNK)
    grid = min(MODEL_GRID, nchunks)
    for b in range(grid):
        c0, c1 = nchunks * b // grid, nchunks * (b + 1) // grid
        p = np.arange(c0 * MODEL_CHUNK, c0 * MODEL_CHUNK + k)  # the block's O(k) reduction
        S = np.bitwise_xor.reduce(_rotl(Fa[c[p]], p % 32))
        Sr = np.bitwise_xor.reduce(_rotr(Ra[c[p]], p % 32))
        for chunk in range(c0, c1):
            b0 = chunk * MODEL_CHUNK
            p = np.arange(b0, b0 + MODEL_CHUNK)
            if fold_text:
                T = _rotl(Fa[c[p]] ^ Fb[c[p + k]], p % 32)
                Tr = _rotr(Ra[c[p]] ^ Rb[c[p + k]], p % 32)
            else:
                T, Tr = pair_f[p % 32, 4 * c[p] + c[p + k]], pair_r[p % 32, 4 * c[p] + c[p + k]]
            tops = np.zeros(MODEL_CHUNK, np.uint64)
            for strand, (t, s0) in enumerate(((T, S), (Tr, Sr))):
                runs = t.reshape(MODEL_THREADS, MODEL_RUN)
                incl = np.bitwise_xor.accumulate(runs, axis=1)
                within = incl ^ runs  # exclusive prefix in each run
                totals = incl[:, -1]
                before = np.bitwise_xor.accumulate(totals) ^ totals  # the runs' scan
                state = (s0 ^ before[:, None] ^ within).reshape(-1)
                if strand == 0:
                    tops ^= _rotr(state, p % 32)
                    S = S ^ np.bitwise_xor.reduce(totals)
                elif canonical:
                    tops ^= _rotl(state, p % 32)
                    Sr = Sr ^ np.bitwise_xor.reduce(totals)
            m = min(MODEL_CHUNK, nk - b0)
            out[b0:b0 + m] = (tops[:m] >> np.uint64(16)).astype(np.uint16)
    return out


def _model_case(kind, canonical, inp, k, rot_seed):
    n = 5 * MODEL_CHUNK + k + 17  # three blocks of two chunks, the last one partial
    rng = np.random.default_rng(1000 * k + 10 * rot_seed + canonical)
    text = inp == "text"
    codes = rng.integers(0, 256 if text else 4, n, dtype=np.uint8)
    jh = KINDS[kind](k, canonical=canonical)
    (kd, can, rot), tables = convert.hasher_tensors(convert.hasher_from(jh), "cpu", text)
    if inp == "2-bit":
        chars = convert.packed_words(PackedSeqVec.from_codes(codes), "cpu")
    else:
        chars = convert.code_bytes(codes | (0 if text else 0xF0), "cpu")
    return chars, n, tables, rot, can, kd, {"text": text, "byte_codes": inp == "code bytes"}


@pytest.mark.parametrize("inp", INPUTS)
@pytest.mark.parametrize("kind", ["nt", "mul"])
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", MODEL_KS)
def test_model_of_the_kernel_fold(kind, canonical, inp, k):
    """The fold as csrc/top16.cu computes it (pair table, runs, scans, the
    block reduction and the chunk carry) equals kmer_top16_plain, at the
    hasher's rotation and three others."""
    chars, n, tables, rot, can, kd, kw = _model_case(kind, canonical, inp, k, 0)
    for r in (rot, 0, 7, 31):
        want = _tops(pipeline.kmer_top16_plain(chars, n, k, tables, r, can, kind=kd, **kw))
        got = model_kmer_top16(chars.numpy(), n, k, tables.numpy(), r, can, kd, inp)
        np.testing.assert_array_equal(got, want, err_msg=f"rot={r}")


@pytest.mark.parametrize("inp", INPUTS)
@pytest.mark.parametrize("canonical", [False, True])
@pytest.mark.parametrize("k", ANTILEX_KS)
def test_model_of_the_kernel_antilex(canonical, inp, k):
    """Antilex tops read from the packed stream as csrc/top16.cu reads them
    (below k = 8 masked to the k-mer's chars) equal kmer_top16_plain."""
    chars, n, tables, rot, can, kd, kw = _model_case("antilex", canonical, inp, k, 0)
    want = _tops(pipeline.kmer_top16_plain(chars, n, k, tables, rot, can, kind=kd, **kw))
    np.testing.assert_array_equal(model_kmer_top16(chars.numpy(), n, k, None, rot, can, kd, inp),
                                  want)


def test_model_covers_chunks_blocks_and_long_k():
    """The model's cases span several chunks per block, several blocks and
    a k past one chunk, as the kernel's do at its own size."""
    n = 5 * MODEL_CHUNK + max(MODEL_KS) + 17
    nchunks = -(-(n - max(MODEL_KS) + 1) // MODEL_CHUNK)
    assert nchunks == 6 and min(MODEL_GRID, nchunks) == 3 and max(MODEL_KS) > MODEL_CHUNK

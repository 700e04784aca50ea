"""The port's slice as a whole: `Builder.run(device="cpu")` == the JAX
package's `Builder.run` == its NumPy oracle (`run_scalar`).

The port runs on its own sequence and hasher classes; inputs made with the
JAX package's classes cross over through `convert.seq_from` and
`convert.hasher_from`. Integer outputs: tolerance 0. The kernel path of
the same builder is checked on a card by tests/test_torch_cuda.py and
chip_smoke.py.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import simd_minimizers_tpu as sm
import simd_minimizers_tpu_torch as smt
from simd_minimizers_tpu.hashers import AntiLexHasher, MulHasher, NtHasher
from simd_minimizers_tpu.seq.packed import AsciiSeq, GenericSeq, PackedNSeqVec, PackedSeqVec
from simd_minimizers_tpu_torch import convert
from simd_minimizers_tpu_torch.ops import oracle as port_oracle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = b"ACGTGCTCAGAGACTCAGAGGA"


def test_golden_vectors():
    ps = smt.PackedSeqVec.from_ascii(GOLD)
    assert list(smt.canonical_minimizer_positions(ps, 5, 7, device="cpu")) == [0, 7, 9, 15]
    assert list(smt.minimizer_positions(smt.AsciiSeq(b"ACGTGCTCAGAGACTCAG"), 5, 7,
                                        device="cpu")) == [4, 5, 8, 13]
    assert list(smt.canonical_minimizer_positions(ps.to_revcomp(), 5, 7,
                                                  device="cpu")) == [2, 8, 10, 17]
    out = smt.canonical_minimizers(5, 7).run(ps, device="cpu")
    assert out.values_u64()[0] == 721
    ref = sm.canonical_minimizers(5, 7).run(PackedSeqVec.from_ascii(GOLD))
    np.testing.assert_array_equal(out.positions, ref.positions)
    np.testing.assert_array_equal(out.values_u64(), ref.values_u64())
    np.testing.assert_array_equal(out.values_u128_limbs()[0], ref.values_u128_limbs()[0])


@pytest.mark.parametrize("n", [40, 4097, 30_000])
@pytest.mark.parametrize("canonical", [False, True])
def test_run_vs_jax_and_scalar(n, canonical):
    seq = PackedSeqVec.random(n, np.random.default_rng(n))
    k, w = 21, 11
    got = smt.Builder(k, w, canonical).run(convert.seq_from(seq), device="cpu")
    assert isinstance(got, smt.Output) and got.positions.dtype == np.uint32
    assert got.length == k and got.canonical == canonical
    ref = sm.Builder(k, w, canonical)
    np.testing.assert_array_equal(got.positions, ref.run(seq).positions)
    np.testing.assert_array_equal(got.positions, ref.run_scalar(seq).positions)


@pytest.mark.parametrize("start,end", [(3, 20_003), (1, 999), (2, 33), (4, 12_000)])
def test_packed_slice_offsets(start, end):
    """A PackedSeq view that starts inside a byte is repacked; an aligned
    one is used as it is. Both agree with the reference."""
    base = PackedSeqVec.random(20_010, np.random.default_rng(start))
    seq = base.slice(start, end)
    for b in (smt.canonical_minimizers(5, 7), smt.minimizers(21, 11)):
        got = b.run_once(convert.seq_from(seq), device="cpu")
        ref = sm.Builder(b.k, b.w, b.canonical)
        np.testing.assert_array_equal(got, ref.run_once(seq))
        np.testing.assert_array_equal(got, ref.run_scalar_once(seq))


def test_ascii_and_bytes_input():
    rng = np.random.default_rng(9)
    raw = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 5000)].tobytes()
    want = sm.canonical_minimizers(21, 11).run_once(AsciiSeq(raw))
    for seq in (smt.AsciiSeq(raw), raw, raw.decode(), convert.seq_from(AsciiSeq(raw))):
        got = smt.canonical_minimizers(21, 11).run_once(seq, device="cpu")
        np.testing.assert_array_equal(got, want)


def test_seeded_hasher_through_builder():
    seq = PackedSeqVec.random(8000, np.random.default_rng(4))
    h = NtHasher(21, canonical=True, seed=42)
    got = smt.canonical_minimizers(21, 11).hasher(convert.hasher_from(h)).run_once(
        convert.seq_from(seq), device="cpu")
    ref = sm.canonical_minimizers(21, 11).hasher(h)
    np.testing.assert_array_equal(got, ref.run_once(seq))
    np.testing.assert_array_equal(got, ref.run_scalar_once(seq))


def _raises(fn, exc=NotImplementedError, match="ROADMAP"):
    with pytest.raises(exc, match=match):
        fn()


def test_out_of_slice_modes_raise():
    """Super-k-mers, syncmers, skip-ambiguous windows, text, the mul and
    antilex hashers and batches, each refused until it was ported, run on
    the CPU and agree with the oracle and the JAX builder; w beyond the
    kernel's geometry still raises, and one launch of 2^31 chars raises the
    JAX package's AssertionError (sketch_long splits such inputs)."""
    ps = smt.PackedSeqVec.from_ascii(GOLD * 4)
    b = smt.canonical_minimizers(5, 7).super_kmers()
    out, want = b.run(ps, device="cpu"), b.run_scalar(ps)
    np.testing.assert_array_equal(out.positions, want.positions)
    np.testing.assert_array_equal(out.superkmer_indices, want.superkmer_indices)
    for syncmer in (1, 2):
        b = smt.Builder(5, 7, False, syncmer=syncmer)
        np.testing.assert_array_equal(b.run_once(ps, device="cpu"), b.run_scalar_once(ps))
    nseq = smt.PackedNSeqVec.from_ascii(GOLD.replace(b"T", b"N", 1))
    b = smt.canonical_minimizers(5, 7)
    np.testing.assert_array_equal(b.run_skip_ambiguous_windows_once(nseq, device="cpu"),
                                  b.run_scalar(nseq.seq, ambiguous=nseq.ambiguous).positions)
    text = b"any text at all! " * 5
    for seq, jseq in ((text, text), (smt.GenericSeq(GOLD), GenericSeq(GOLD)),
                      (ps, PackedSeqVec.from_ascii(GOLD * 4))):
        for cls in (NtHasher, MulHasher, AntiLexHasher):
            jh = cls(5)
            b = smt.minimizers(5, 7).hasher(convert.hasher_from(jh))
            got = b.run_once(seq, device="cpu")
            np.testing.assert_array_equal(got, b.run_scalar_once(seq))
            np.testing.assert_array_equal(got, sm.minimizers(5, 7).hasher(jh).run_once(jseq))
    got = smt.minimizers(5, 7).run_batch([GOLD, GOLD[:9], GOLD], device="cpu")
    want = sm.minimizers(5, 7).run_batch([GOLD, GOLD[:9], GOLD])
    for g, p in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, p)
    _raises(lambda: smt.minimizers(5, 100_000).run(ps, device="cpu"))
    _raises(lambda: smt.minimizers(5, 100_000).run(text, device="cpu"))
    from simd_minimizers_tpu_torch.ops import fused

    _raises(lambda: fused.fused_sketch(torch.zeros(4, dtype=torch.uint8), 1 << 31, 21, 11, None,
                                       0, False, text=True, kind="antilex"),
            AssertionError, "2\\^31")


def test_even_l_canonical_raises():
    # the JAX builder's exception, raised by the same check
    ps = smt.PackedSeqVec.from_ascii(GOLD)
    _raises(lambda: smt.canonical_minimizers(5, 6).run(ps, device="cpu"), AssertionError, "odd")
    _raises(lambda: sm.canonical_minimizers(5, 6).run(PackedSeqVec.from_ascii(GOLD)),
            AssertionError, "odd")


@pytest.mark.parametrize("k,w,n", [(5, 7, 200), (21, 11, 9000)])
def test_run_skip_ambiguous_windows_on_cpu(k, w, n):
    """The port's own entry point takes a device (the inherited one ran on
    the default CUDA device) and equals the JAX builder's."""
    rng = np.random.default_rng(n)
    raw = np.frombuffer(b"ACGTN", np.uint8)[rng.choice(5, n, p=[.24, .24, .24, .24, .04])]
    nseq = smt.PackedNSeqVec.from_ascii(raw.tobytes())
    jnseq = PackedNSeqVec.from_ascii(raw.tobytes())
    b, ref = smt.canonical_minimizers(k, w), sm.canonical_minimizers(k, w)
    out = b.run_skip_ambiguous_windows(nseq, device="cpu")
    want = ref.run_skip_ambiguous_windows(jnseq)
    assert isinstance(out, smt.Output) and out.seq is nseq.seq
    np.testing.assert_array_equal(out.positions, want.positions)
    np.testing.assert_array_equal(out.values_u64(), want.values_u64())
    np.testing.assert_array_equal(b.run_skip_ambiguous_windows_once(nseq, device="cpu"),
                                  ref.run_skip_ambiguous_windows_once(jnseq))
    np.testing.assert_array_equal(
        b.run_skip_ambiguous_windows_once(convert.seq_from(jnseq), device="cpu"), want.positions)
    with pytest.raises(AssertionError, match="canonical"):
        smt.minimizers(k, w).run_skip_ambiguous_windows(nseq, device="cpu")


def test_superkmers_with_ambiguity_raise():
    """Super-k-mers with an ambiguity mask: the reference's public API
    cannot express it, and both packages refuse the combination with
    AssertionError exactly where the JAX package does (Builder.run,
    Builder.run_batch, backend.sketch_records); below those entry points
    (backend.sketch) it runs in both, SKIPPED dropped after the dedup, and
    the two agree (k=5, w=7, canonical nt, 3,000 bases, 1% ambiguous)."""
    from simd_minimizers_tpu.ops import backend as jbackend
    from simd_minimizers_tpu_torch.ops import backend, pipeline

    amb = np.zeros(len(GOLD) * 4, bool)
    amb[5] = True
    for pkg, ps in ((smt, smt.PackedSeqVec.from_ascii(GOLD * 4)),
                    (sm, PackedSeqVec.from_ascii(GOLD * 4))):
        b = pkg.canonical_minimizers(5, 7).super_kmers()
        kw = {"device": "cpu"} if pkg is smt else {}
        with pytest.raises(AssertionError, match="cannot be combined with an ambiguity mask"):
            b.run(ps, ambiguous=amb, **kw)
        with pytest.raises(AssertionError, match="cannot be combined with an ambiguity mask"):
            b.run_batch([GOLD * 4], ambiguous=[amb], **kw)
    for bk in (backend, jbackend):
        kw = {"device": "cpu"} if bk is backend else {}
        h = (smt if bk is backend else sm).NtHasher(5, canonical=True)
        with pytest.raises(AssertionError, match="cannot be combined with an ambiguity mask"):
            bk.sketch_records([np.zeros(50, np.uint8)], 5, 7, h, pipeline.MODE_SUPERKMERS,
                              [np.zeros(50, np.uint8)], **kw)

    rng = np.random.default_rng(3000)
    codes = rng.integers(0, 4, 3000, dtype=np.uint8)
    mask = rng.random(3000) < 0.01
    ps = smt.PackedSeqVec.from_codes(codes)
    h = smt.NtHasher(5, canonical=True)
    got = backend.sketch(convert.packed_words(ps, "cpu"), 3000, 5, 7, h,
                         pipeline.MODE_SUPERKMERS, convert.ambiguity_plane(mask, 3000, "cpu"))
    want = jbackend.sketch(codes, 5, 7, NtHasher(5, canonical=True),
                           mode=pipeline.MODE_SUPERKMERS, ambiguous_np=mask.astype(np.uint8))
    assert want[0].size > 600
    for g, p in zip(got, want, strict=True):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), p)


def test_run_scalar_is_the_oracle():
    ps = smt.PackedSeqVec.from_ascii(GOLD)
    assert list(smt.canonical_minimizers(5, 7).run_scalar_once(ps)) == [0, 7, 9, 15]


def test_imports_without_jax(tmp_path):
    """The port runs with neither JAX nor the JAX package importable: its
    modules, tools, examples, native helpers and profiler trace."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['simd_minimizers_tpu'] = None\n"
        "import os\n"
        "import numpy as np\n"
        "import torch\n"
        "import simd_minimizers_tpu_torch as smt\n"
        "from simd_minimizers_tpu_torch.ops import backend, batch, fused, pipeline, _build\n"
        "from simd_minimizers_tpu_torch.ops import device_values, spans, values\n"
        "from simd_minimizers_tpu_torch import native\n"
        "from simd_minimizers_tpu_torch.parallel import multihost, shard\n"
        "from simd_minimizers_tpu_torch.ops.device_sketcher import ShortSeqSketcher\n"
        "from simd_minimizers_tpu_torch.seq import fasta\n"
        "from simd_minimizers_tpu_torch.utils import device, profiling\n"
        "from simd_minimizers_tpu_torch import sketch_fasta\n"
        "rid, pos = smt.minimizers(5, 7).run_batch([b'ACGTGCTCAGAGACTCAG'] * 3, device='cpu')\n"
        "assert list(pos[rid == 2]) == [4, 5, 8, 13]\n"
        "recs = [smt.AsciiSeq(b'ACGTGCTCAGAGACTCAG' * 200).codes()] * 2\n"
        "out = backend.sketch_records(recs, 5, 7, smt.NtHasher(5), device='cpu')\n"
        "assert list(out[1][:4]) == [4, 5, 8, 13]\n"
        "long = spans.sketch_long(torch.from_numpy(recs[0]), recs[0].size, 5, 7,\n"
        "                         smt.NtHasher(5), byte_codes=True, span_chars=5000)\n"
        "assert long.numpy().tolist() == out[0].tolist()\n"
        "ps = smt.PackedSeqVec.from_ascii(b'ACGTGCTCAGAGACTCAGAGGA')\n"
        "assert list(smt.canonical_minimizer_positions(ps, 5, 7, device='cpu')) == [0, 7, 9, 15]\n"
        "assert list(smt.minimizer_positions(smt.AsciiSeq(b'ACGTGCTCAGAGACTCAG'), 5, 7,\n"
        "                                    device='cpu')) == [4, 5, 8, 13]\n"
        "assert smt.canonical_minimizers(5, 7).run(ps, device='cpu').values_u64()[0] == 721\n"
        "chars = torch.from_numpy(ps.data)\n"
        "assert device_values.kmer_values_u64(chars, [0], 5, canonical=True)[0] == 721\n"
        "assert native.kmer_values_u64(ps.codes(), [0], 5, True)[0] == 721\n"
        "assert spans.sketch_long(torch.from_numpy(recs[0]), recs[0].size, 5, 7, smt.NtHasher(5),\n"
        "                         byte_codes=True).tolist() == long.tolist()\n"
        "out = smt.canonical_minimizers(5, 7).super_kmers().run(ps, device='cpu')\n"
        "assert list(out.positions) == [0, 7, 9, 15] and out.superkmer_indices.size == 4\n"
        "nseq = smt.PackedNSeqVec.from_ascii(b'ACGTGCTCAGAGANTCAGAGGA')\n"
        "b = smt.canonical_minimizers(5, 7)\n"
        "assert list(b.run_skip_ambiguous_windows_once(nseq, device='cpu')) == list(\n"
        "    b.run_scalar(nseq.seq, ambiguous=nseq.ambiguous).positions)\n"
        "text = b'Call me Ishmael. Some years ago, never mind how long precisely.'\n"
        "b = smt.minimizers(7, 5).hasher(smt.MulHasher(7))\n"
        "out = b.run(text, device='cpu')\n"
        "assert isinstance(out.seq, smt.GenericSeq) and out.positions.size\n"
        "assert list(out.positions) == list(b.run_scalar_once(text))\n"
        "assert list(out.values_u64()) == list(b.run_scalar(text).values_u64())\n"
        "codes = smt.AsciiSeq(b'ACGTGCTCAGAGACTCAG' * 40).codes()\n"
        "want = backend.sketch_records([codes], 5, 7, smt.NtHasher(5), device='cpu')[0]\n"
        "sk = ShortSeqSketcher(5, 7, smt.NtHasher(5), device='cpu')\n"
        "assert sk.sketch_many([codes, codes[:5]])[0].tolist() == want.tolist()\n"
        "got = shard.fused_sharded_sketch(codes, 5, 7, smt.NtHasher(5),\n"
        "                                 mesh=shard.default_mesh(3, device='cpu'))\n"
        "assert got.tolist() == want.tolist()\n"
        "assert multihost.multihost_sketch(codes, 5, 7, smt.NtHasher(5),\n"
        "                                  device='cpu').tolist() == want.tolist()\n"
        "from simd_minimizers_tpu_torch.tools import fuzz\n"
        "from simd_minimizers_tpu_torch.examples import bench, multihost_demo, variance\n"
        "assert fuzz.run(seed=1, configs=7, device='cpu')['configs'] == 7\n"
        "import contextlib, io\n"
        "with contextlib.redirect_stdout(io.StringIO()) as printed:\n"
        "    got = variance.main(['--len', '500', '--reps', '2', '--device', 'cpu'])\n"
        "assert got['density'] > 0 and 'density' in printed.getvalue()\n"
        "c, a = native.pack_ascii(np.frombuffer(b'ACGTN', np.uint8))\n"
        "assert c.tolist() == [0, 1, 3, 2, 3] and a.tolist() == [0, 0, 0, 0, 1]\n"
        "assert native.pack_2bit(c[:4]).tolist() == [0b10_11_01_00]\n"
        "codes, amb, starts = fasta.fasta_scan(np.frombuffer(b'>a\\nACGN\\n', np.uint8))\n"
        "assert codes.tolist() == [0, 1, 3, 3] and starts.tolist() == [0, 4]\n"
        "with profiling.trace(os.path.join(os.environ['SMT_TRACE_DIR'], 't')) as path:\n"
        "    smt.minimizers(5, 7).run(ps, device='cpu')\n"
        "assert os.path.exists(path)\n"
        "assert sys.modules['jax'] is None and sys.modules['simd_minimizers_tpu'] is None\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={**os.environ, "SMT_TRACE_DIR": str(tmp_path)})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def _port_files():
    pkg = os.path.join(ROOT, "simd_minimizers_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    return sorted(files) + [os.path.join(ROOT, "chip_smoke.py")]


def test_port_never_imports_the_jax_package():
    """No module of the port (its tools and examples included), and not
    chip_smoke.py, imports simd_minimizers_tpu or jax, at any depth of its
    code."""
    files = _port_files()
    assert len(files) >= 21
    names = {os.path.relpath(f, ROOT) for f in files}
    assert {os.path.join('simd_minimizers_tpu_torch', 'ops', 'device_sketcher.py'),
            os.path.join('simd_minimizers_tpu_torch', 'parallel', 'shard.py'),
            os.path.join('simd_minimizers_tpu_torch', 'tools', 'fuzz.py'),
            os.path.join('simd_minimizers_tpu_torch', 'examples', 'bench.py'),
            os.path.join('simd_minimizers_tpu_torch', 'examples', 'variance.py'),
            os.path.join('simd_minimizers_tpu_torch', 'examples', 'multihost_demo.py')} <= names
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("simd_minimizers_tpu", "jax"), f"{path} imports {name}"


def _imported(path):
    """Every module a file imports, and every name it imports from one, as
    absolute dotted names (relative imports resolved)."""
    parts = os.path.relpath(os.path.dirname(path), ROOT).split(os.sep)
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                base = ".".join(parts[:len(parts) - node.level + 1] + [base] * bool(base))
            yield base
            yield from (f"{base}.{a.name}" for a in node.names)


def test_ops_import_only_downward():
    """The kernel wrappers (ops/fused.py) import no driver, entry point or
    parallel module, and only at the top of the module; no module of ops/
    imports from parallel/ (the span driver, ops/spans.py, sits between)."""
    pkg = "simd_minimizers_tpu_torch."
    ops = os.path.join(ROOT, "simd_minimizers_tpu_torch", "ops")
    fused = os.path.join(ops, "fused.py")
    got = set(_imported(fused))
    assert pkg + "ops.pipeline" in got and pkg + "utils.profiling" in got
    for name in ("parallel", "ops.spans", "ops.backend", "ops.batch", "ops.device_values"):
        assert not {g for g in got if g == pkg + name or g.startswith(pkg + name + ".")}, name
    tree = ast.parse(open(fused).read(), fused)
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert len(top) == sum(isinstance(n, (ast.Import, ast.ImportFrom)) for n in ast.walk(tree))
    files = sorted(f for f in os.listdir(ops) if f.endswith(".py"))
    assert "spans.py" in files and "chunked.py" not in files
    for f in files:
        assert not any(g.startswith(pkg + "parallel") for g in _imported(os.path.join(ops, f))), f


def test_foreign_types_raise():
    """The JAX package's sequences and hashers are refused, not run: they
    cross over through convert.seq_from and convert.hasher_from."""
    jps = PackedSeqVec.from_ascii(GOLD)
    b = smt.canonical_minimizers(5, 7)
    for seq in (jps, AsciiSeq(GOLD), GenericSeq(GOLD), PackedNSeqVec.from_ascii(GOLD), 42):
        with pytest.raises(TypeError):
            b.run(seq, device="cpu")
    with pytest.raises(TypeError):
        b.run(smt.PackedNSeqVec.from_ascii(GOLD), device="cpu")
    with pytest.raises(TypeError):
        b.hasher(NtHasher(5, canonical=True))
    assert list(b.run_once(convert.seq_from(jps), device="cpu")) == [0, 7, 9, 15]


@pytest.mark.parametrize("offset,length", [(0, 22), (1, 20), (3, 17), (4, 18)])
def test_seq_from(offset, length):
    """seq_from keeps a packed sequence's data (no copy) and offset, and
    rebuilds the others from codes() and char_bits."""
    jps = PackedSeqVec.from_ascii(GOLD).slice(offset, offset + length)
    ps = convert.seq_from(jps)
    assert isinstance(ps, smt.PackedSeq) and ps.data is jps.data
    assert (ps.offset, len(ps)) == (jps.offset, len(jps))
    np.testing.assert_array_equal(ps.codes(), jps.codes())
    for jseq, cls in ((AsciiSeq(GOLD[offset:]), smt.PackedSeqVec),
                      (GenericSeq(GOLD[offset:] + b"!?"), smt.GenericSeq)):
        seq = convert.seq_from(jseq)
        assert isinstance(seq, cls) and seq.char_bits == jseq.char_bits
        np.testing.assert_array_equal(seq.codes(), jseq.codes())
    jn = PackedNSeqVec.from_ascii(GOLD[offset:].replace(b"G", b"N"))
    n = convert.seq_from(jn)
    assert isinstance(n, smt.PackedNSeqVec)
    np.testing.assert_array_equal(n.ambiguous, jn.ambiguous)
    np.testing.assert_array_equal(n.seq.codes(), jn.seq.codes())


@pytest.mark.parametrize("cls", [NtHasher, MulHasher, AntiLexHasher])
@pytest.mark.parametrize("seed", [None, 7])
def test_hasher_from(cls, seed):
    jh = cls(21, canonical=True, seed=seed)
    h = convert.hasher_from(jh)
    assert type(h).__name__ == cls.__name__ and isinstance(h, smt.KmerHasher)
    assert (h.kind, h.k, h.canonical, h.seed) == (jh.kind, 21, True, seed)
    assert convert.hasher_from(h) is h
    codes = np.random.default_rng(1).integers(0, 256, 500, dtype=np.uint8)
    np.testing.assert_array_equal(h.hash_kmers_np(codes), jh.hash_kmers_np(codes))


def test_one_minimizer():
    """The port's oracle copy of one_minimizer against the JAX package's."""
    window = GOLD[:11]
    for cls in (NtHasher, MulHasher, AntiLexHasher):
        jh = cls(5)
        got = port_oracle.one_minimizer(smt.AsciiSeq(window).codes(), convert.hasher_from(jh))
        assert got == sm.one_minimizer(window, jh)

"""The port's CUDA kernel against its plain version and the oracle, on a card.

Marked `cuda`; without a CUDA card every test skips. This file imports no
JAX, so on a machine without it run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from simd_minimizers_tpu.hashers import NtHasher
from simd_minimizers_tpu.ops import oracle
from simd_minimizers_tpu.seq.packed import PackedSeqVec
from simd_minimizers_tpu_torch import api, convert
from simd_minimizers_tpu_torch.ops import fused, pipeline

pytestmark = pytest.mark.cuda

TILE = fused.TILE


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _both(codes, k, w, h, dev):
    words = convert.packed_words(PackedSeqVec.from_codes(codes), dev)
    key, table, _ = convert.hasher_tensors(h, dev)
    args = (words, codes.size, k, w, table, key[2], h.canonical)
    got = fused.fused_sketch(*args)
    want = pipeline.run_pipeline(*args)
    torch.cuda.synchronize()
    return got.cpu().numpy(), want.cpu().numpy()


CONFIGS = [(5, 7), (21, 11), (31, 5), (19, 19), (1, 5), (64, 2), (33, 3), (21, 1)]
# canonical needs odd l = k + w - 1
CASES = [(k, w, c) for k, w in CONFIGS for c in (False, True) if not c or (k + w) % 2 == 0]


@pytest.mark.parametrize("k,w,canonical", CASES)
@pytest.mark.parametrize("seed", [None, 7])
def test_kernel_vs_plain_and_oracle(dev, k, w, canonical, seed):
    l = k + w - 1
    rng = np.random.default_rng(k * 1000 + w)
    h = NtHasher(k, canonical=canonical, seed=seed)
    # lengths around tile seams and a multi-tile run
    for nw in [1, 2, TILE - 1, TILE, TILE + 1, 3 * TILE + 17, 200_003]:
        codes = rng.integers(0, 4, nw + l - 1, dtype=np.uint8)
        got, want = _both(codes, k, w, h, dev)
        np.testing.assert_array_equal(got, want)
        ref = oracle.collect_and_dedup(oracle.selected_stream(codes, k, w, h))
        np.testing.assert_array_equal(got.astype(np.uint32), ref)


@pytest.mark.parametrize("canonical", [False, True])
def test_each_kernel_vs_its_plain_version(dev, canonical):
    k, w = 21, 11
    codes = np.random.default_rng(8).integers(0, 4, 3 * TILE + 17 + k + w - 2, dtype=np.uint8)
    h = NtHasher(k, canonical=canonical)
    words = convert.packed_words(PackedSeqVec.from_codes(codes), dev)
    key, table, _ = convert.hasher_tensors(h, dev)
    args = (words, codes.size, k, w, table, key[2], canonical)
    scratch, counts = fused.minimizer_tiles(*args)
    plain_scratch, plain_counts = pipeline.minimizer_tiles_plain(*args, TILE)
    assert torch.equal(counts, plain_counts)
    live = torch.arange(TILE, device=dev) < counts[:, None]
    assert torch.equal(scratch.view(-1, TILE)[live], plain_scratch.view(-1, TILE)[live])
    offsets = fused.tile_offsets(counts)
    assert torch.equal(offsets, pipeline.tile_offsets_plain(counts))
    total = int(offsets[-1])
    assert torch.equal(fused.tile_append(scratch, counts, offsets, total),
                       pipeline.tile_append_plain(scratch, counts, offsets, total, TILE))


@pytest.mark.parametrize("ntiles", [1, 1023, 1024, 1025, 24_415])
def test_tile_offsets_many_tiles(dev, ntiles):
    # more tiles than the scan kernel's 1024 threads: each thread sums a run
    counts = torch.randint(0, TILE + 1, (ntiles,), dtype=torch.int32, device=dev)
    assert torch.equal(fused.tile_offsets(counts), pipeline.tile_offsets_plain(counts))


@pytest.mark.parametrize("canonical", [False, True])
def test_widest_geometry(dev, canonical):
    # the largest w the gate admits uses (nearly) all of a block's shared memory
    k = 21
    w = max(w for w in range(1, 1 << 16, 2 if canonical else 1)
            if fused.fused_supported(k, w, canonical))
    assert not fused.fused_supported(k, w + 2, canonical)
    codes = np.random.default_rng(w).integers(0, 4, 4 * w + k + w - 2, dtype=np.uint8)
    got, want = _both(codes, k, w, NtHasher(k, canonical=canonical), dev)
    np.testing.assert_array_equal(got, want)
    assert got.size >= 4


def test_low_entropy_ties(dev):
    # long runs of one base make many equal top-16 keys: exercises the
    # leftmost/rightmost tie-breaks across tile seams
    rng = np.random.default_rng(3)
    codes = np.repeat(rng.integers(0, 4, 4000, dtype=np.uint8), rng.integers(1, 40, 4000))
    for canonical in (False, True):
        h = NtHasher(21, canonical=canonical)
        got, want = _both(codes, 21, 11, h, dev)
        np.testing.assert_array_equal(got, want)


def test_short_input_launches_nothing(dev):
    before = dict(fused.LAUNCHES)
    got, _ = _both(np.zeros(30, np.uint8), 21, 11, NtHasher(21, canonical=True), dev)
    assert got.size == 0 and fused.LAUNCHES == before


def test_builder_on_card_counts_launches(dev):
    seq = PackedSeqVec.random(100_000, np.random.default_rng(5))
    before = dict(fused.LAUNCHES)
    out = api.canonical_minimizers(21, 11).run(seq, device=dev)
    grew = {name: fused.LAUNCHES[name] - before[name] for name in before}
    assert grew == {"minimizer_tiles<canonical>": 1, "minimizer_tiles<forward>": 0,
                    "tile_offsets": 1, "tile_append": 1}
    np.testing.assert_array_equal(out.positions,
                                  api.canonical_minimizers(21, 11).run_scalar_once(seq))

"""Super-k-mers with their minimizers' values, with the semantics of the
simd-minimizers crate's `super_kmers()` and `values_u64()` (src/lib.rs) as
its documentation and sources state them:

- each window's minimizer position as `minimizers.py` selects it (the
  configuration's hasher, the top 16 bits, the leftmost of equal tops,
  the canonical strand rule), adjacent equal positions deduplicated;
- a kept position's first-window index: the window at which it became the
  minimum, the first of its run of equal positions;
- its value: the 2-bit code of char j of the k-mer at bits 2j, canonical
  the least of that and the reverse complement's value (the complement of
  code c is c ^ 2), as u64 (k <= 32).

A sequence's answer is four int64 planes: positions, first-window indices,
and the values' low and high 32 bits. `values_u64` and `halves` give the
value planes of any positions (the command line cell's minimizers). Super-k-mers take no ambiguity mask
(the crate has no such entry), so a mask raises. The control breaks the
leftmost rule as the minimizers' control does.
"""

from __future__ import annotations

import torch

import plugins

_LOW32 = 0xFFFF_FFFF
_SIGN = -(1 << 63)  # XORed in, it orders int64 as the u64 bits they hold


def values_u64(codes: torch.Tensor, pos: torch.Tensor, k: int, canonical: bool) -> torch.Tensor:
    """int64 holding the u64 values of the k-mers (k <= 32) at `pos` (int64)
    of the 2-bit `codes`."""
    fwd, rc = torch.zeros_like(pos), torch.zeros_like(pos)
    for j in range(k):
        c = codes[pos + j].long()
        fwd |= c << (2 * j)
        rc |= (c ^ 2) << (2 * (k - 1 - j))
    if not canonical:
        return fwd
    return torch.where((rc ^ _SIGN) < (fwd ^ _SIGN), rc, fwd)


def halves(values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(low, high) 32 bits of int64 values holding u64 bits, as int64."""
    return values & _LOW32, (values >> 32) & _LOW32


def make(config: dict, control: bool = False) -> "SuperKmers":
    if config.get("values") != "u64":
        raise ValueError(f"super-k-mers answer with u64 values, not {config.get('values')!r}")
    if not 1 <= config["k"] <= 32:
        raise ValueError(f"a u64 value holds a k-mer of at most 32 chars, not {config['k']}")
    return SuperKmers(plugins.load("references", "minimizers").make(config, control))


class SuperKmers:
    """The super-k-mers of one configuration, over its window selection
    (`minimizers.Minimizers`)."""

    def __init__(self, minimizers):
        self.minimizers = minimizers
        self.k, self.l, self.canonical = minimizers.k, minimizers.l, minimizers.canonical

    def least_work(self, windows: int, chars: int, positions: int, *, packed: bool,
                   masked: bool) -> tuple[float, float]:
        """(operations, bytes): the minimizers' (`Minimizers.least_work`),
        and per position 4 B of index and 8 B of value written besides."""
        ops, nbytes = self.minimizers.least_work(windows, chars, positions, packed=packed,
                                                 masked=masked)
        return ops, nbytes + 12 * positions

    def sequence(self, codes: torch.Tensor, ambiguous: torch.Tensor | None = None,
                 block_windows: int = 1 << 24) -> tuple[torch.Tensor, ...]:
        """(positions, first-window indices, value low 32 bits, value high
        32 bits), int64, of one sequence of 2-bit codes (1-D uint8), in
        blocks of `block_windows` windows."""
        if ambiguous is not None:
            raise ValueError("super-k-mers take no ambiguity mask")
        n, l = codes.shape[0], self.l
        planes, before = [], None
        for s in range(0, max(n - l + 1, 0), block_windows):
            e = min(s + block_windows, n - l + 1) + l - 1
            sel = self.minimizers.selected(codes[None, s:e])[0] + s
            keep = torch.ones_like(sel, dtype=torch.bool)
            keep[1:] = sel[1:] != sel[:-1]
            if before is not None:
                keep[0] = bool(sel[0] != before)
            pos = sel[keep]
            planes.append((pos, torch.nonzero(keep)[:, 0] + s,
                           *halves(values_u64(codes, pos, self.k, self.canonical))))
            before = int(sel[-1])
        if not planes:
            empty = torch.zeros(0, dtype=torch.int64, device=codes.device)
            return empty, empty, empty, empty
        return tuple(torch.cat(p) for p in zip(*planes))

    def rows(self, codes: torch.Tensor, lens: torch.Tensor | None = None):
        raise NotImplementedError("super-k-mers of a read matrix are no cell's answer yet")

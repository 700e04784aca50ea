"""Minimizer positions, with the semantics of the simd-minimizers crate as
its documentation and sources state them:

- each k-mer is hashed by the configuration's `hasher`
  (`benchmark/hashes/<hasher>.py`);
- a window of w k-mers compares the top 16 bits of each hash, and of equal
  tops takes the leftmost k-mer; a canonical window (a strict majority of
  its l = k + w - 1 chars are T or G, code bit 1) takes the leftmost
  minimum, any other canonical window the rightmost;
- a window that holds an ambiguous char is skipped: its position is a
  sentinel that takes part in the deduplication of adjacent equal
  positions and is dropped after it.

The control takes the leftmost minimum in every window, so the result of a
canonical configuration no longer depends on the strand alone.
"""

from __future__ import annotations

import torch

import plugins

SKIPPED = 0xFFFF_FFFE  # the position of a window with an ambiguous char
INVALID = 0xFFFF_FFFF  # a window past the end of a row
_LOW32 = 0xFFFF_FFFF


def make(config: dict, control: bool = False) -> "Minimizers":
    return Minimizers(config["k"], config["w"], config["canonical"],
                      plugins.load("hashes", config["hasher"]), control)


class Minimizers:
    """The positions of one configuration: k, w, the hash and the strand
    rule."""

    def __init__(self, k: int, w: int, canonical: bool, hasher, control: bool = False):
        self.k, self.w, self.canonical, self.hasher, self.control = k, w, canonical, hasher, control
        self.l = k + w - 1
        if canonical and self.l % 2 == 0:
            raise ValueError(f"a canonical window needs an odd l, not {self.l}")

    def least_work(self, windows: int, chars: int, positions: int, *, packed: bool,
                   masked: bool) -> tuple[float, float]:
        """(operations, bytes) of the least work of a sketch. Operations per
        window: the decode of a 2-bit packed char (2; none for a char
        already in a byte); per strand the hash's own, the key 2 (top 16
        bits, column), an O(1) sliding minimum 3 and the position 2; the
        strand count and blend 5 (canonical); the keep test 2; with a mask
        the sliding count 3. Bytes: the chars read once at 2 bits (and 1 bit
        of mask where masked) and each position written once as 4 bytes."""
        arms = 2 if self.canonical else 1
        per = ((2 if packed else 0) + arms * (self.hasher.OPS_PER_KMER + 2 + 3 + 2)
               + (5 if self.canonical else 0) + 2 + (3 if masked else 0))
        return windows * per, chars / 4 + (chars / 8 if masked else 0) + 4 * positions

    def selected(self, codes: torch.Tensor, ambiguous: torch.Tensor | None = None,
                 lens: torch.Tensor | None = None) -> torch.Tensor:
        """(B, L - l + 1) int64: each window's position (k-mer index in its
        row), SKIPPED where the window holds a flagged char, INVALID where
        it runs past the row's length `lens` (all of L if None). `codes`
        is (B, L) of 2-bit codes, `ambiguous` (B, L) bool or None."""
        k, w, l = self.k, self.w, self.l
        nk, nw = codes.shape[1] - k + 1, codes.shape[1] - l + 1
        c = codes.long()
        top = (self.hasher.kmer_hashes(c, k, self.canonical) >> 16) << 32
        idx = torch.arange(nk, dtype=torch.int64, device=c.device)
        lpos = (top | idx).unfold(1, w, 1).amin(2) & _LOW32
        if self.canonical and not self.control:
            rpos = _LOW32 - ((top | (_LOW32 - idx)).unfold(1, w, 1).amin(2) & _LOW32)
            tg = torch.nn.functional.pad(((c >> 1) & 1).cumsum(1), (1, 0))
            forward = 2 * (tg[:, l:] - tg[:, :-l]) > l
            sel = torch.where(forward, lpos, rpos)
        else:
            sel = lpos
        if ambiguous is not None:
            a = torch.nn.functional.pad(ambiguous.long().cumsum(1), (1, 0))
            sel = torch.where(a[:, l:] - a[:, :-l] > 0, SKIPPED, sel)
        if lens is not None:
            past = torch.arange(nw, device=c.device)[None, :] >= (lens.long() - l + 1)[:, None]
            sel = torch.where(past, INVALID, sel)
        return sel

    @staticmethod
    def _kept(sel: torch.Tensor, before: int | None = None) -> torch.Tensor:
        """Where adjacent equal positions dedup (the first of a row against
        `before`, the last window of the row's previous block) and no
        sentinel stands."""
        keep = torch.ones_like(sel, dtype=torch.bool)
        keep[:, 1:] = sel[:, 1:] != sel[:, :-1]
        if before is not None:
            keep[0, 0] = bool(sel[0, 0] != before)
        return keep & (sel < SKIPPED)

    def sequence(self, codes: torch.Tensor, ambiguous: torch.Tensor | None = None,
                 block_windows: int = 1 << 24) -> torch.Tensor:
        """int64 positions of one sequence of 2-bit codes (1-D uint8), with
        an optional 1-D bool mask, in blocks of `block_windows` windows."""
        n, l = codes.shape[0], self.l
        out, before = [], None
        for s in range(0, max(n - l + 1, 0), block_windows):
            e = min(s + block_windows, n - l + 1) + l - 1
            amb = None if ambiguous is None else ambiguous[None, s:e]
            sel = self.selected(codes[None, s:e], amb)
            sel = torch.where(sel < SKIPPED, sel + s, sel)
            keep = self._kept(sel, before)
            out.append(sel[keep])
            before = int(sel[0, -1])
        if not out:
            return torch.zeros(0, dtype=torch.int64, device=codes.device)
        return torch.cat(out)

    def rows(self, codes: torch.Tensor, lens: torch.Tensor | None = None,
             block_chars: int = 1 << 24) -> tuple[torch.Tensor, torch.Tensor]:
        """(row ids, positions), int64, ordered by row, of each row of the
        (B, L) code matrix alone (the first `lens[i]` codes of row i), in
        blocks of rows of about `block_chars` chars."""
        rids, poss = [], []
        step = max(1, block_chars // max(codes.shape[1], 1))
        for s in range(0, codes.shape[0], step):
            sub = codes[s:s + step]
            if sub.shape[1] < self.l:
                break
            sel = self.selected(sub, lens=None if lens is None else lens[s:s + step])
            r, p = torch.nonzero(self._kept(sel), as_tuple=True)
            rids.append(r + s)
            poss.append(sel[r, p])
        if not rids:
            empty = torch.zeros(0, dtype=torch.int64, device=codes.device)
            return empty, empty
        return torch.cat(rids), torch.cat(poss)

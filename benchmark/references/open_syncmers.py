"""Open syncmers with their values, with the semantics of the
simd-minimizers crate's `canonical_open_syncmers(k, w)` / `open_syncmers`
and `values_u64()` (src/lib.rs, src/syncmers.rs) as its documentation and
sources state them:

- a syncmer is a window of w s-mers of k chars each (l = k + w - 1 chars,
  w odd) whose minimum s-mer, as `minimizers.py` selects it (the
  configuration's hasher, the top 16 bits, the leftmost of equal tops, the
  canonical strand rule), is the middle one: window start + w // 2;
- its answer is its window index, and the value of its l-mer: the 2-bit
  code of char j at bits 2j, canonical the least of that and the reverse
  complement's value, as u64 (l <= 32).

A sequence's answer is three int64 planes: window indices, and the values'
low and high 32 bits (`superkmers.values_u64` at length l). Open syncmers
of a masked sequence are no cell's answer, so a mask raises. The control
breaks the leftmost rule as the minimizers' control does.
"""

from __future__ import annotations

import torch

import plugins


def make(config: dict, control: bool = False) -> "OpenSyncmers":
    if config.get("values") != "u64":
        raise ValueError(f"open syncmers answer with u64 values, not {config.get('values')!r}")
    if config["w"] % 2 == 0:
        raise ValueError(f"an open syncmer's middle s-mer needs an odd w, not {config['w']}")
    if not 1 <= config["k"] + config["w"] - 1 <= 32:
        raise ValueError(f"a u64 value holds a syncmer of at most 32 chars, not "
                         f"{config['k'] + config['w'] - 1}")
    return OpenSyncmers(plugins.load("references", "minimizers").make(config, control))


class OpenSyncmers:
    """The open syncmers of one configuration, over its window selection
    (`minimizers.Minimizers`)."""

    def __init__(self, minimizers):
        self.minimizers = minimizers
        self.w, self.l, self.canonical = minimizers.w, minimizers.l, minimizers.canonical

    def least_work(self, windows: int, chars: int, syncmers: int, *, packed: bool,
                   masked: bool) -> tuple[float, float]:
        """(operations, bytes): the minimizers' (`Minimizers.least_work`,
        with 4 B of window index written a syncmer), and 8 B of value
        written a syncmer besides."""
        ops, nbytes = self.minimizers.least_work(windows, chars, syncmers, packed=packed,
                                                 masked=masked)
        return ops, nbytes + 8 * syncmers

    def sequence(self, codes: torch.Tensor, ambiguous: torch.Tensor | None = None,
                 block_windows: int = 1 << 24) -> tuple[torch.Tensor, ...]:
        """(window indices, value low 32 bits, value high 32 bits), int64, of
        one sequence of 2-bit codes (1-D uint8), in blocks of
        `block_windows` windows."""
        if ambiguous is not None:
            raise ValueError("open syncmers take no ambiguity mask here")
        values_u64 = plugins.load("references", "superkmers").values_u64
        halves = plugins.load("references", "superkmers").halves
        n, l = codes.shape[0], self.l
        planes = []
        for s in range(0, max(n - l + 1, 0), block_windows):
            e = min(s + block_windows, n - l + 1) + l - 1
            sel = self.minimizers.selected(codes[None, s:e])[0]
            middle = torch.arange(sel.numel(), dtype=torch.int64, device=sel.device) + self.w // 2
            idx = torch.nonzero(sel == middle)[:, 0] + s
            planes.append((idx, *halves(values_u64(codes, idx, l, self.canonical))))
        if not planes:
            empty = torch.zeros(0, dtype=torch.int64, device=codes.device)
            return empty, empty, empty
        return tuple(torch.cat(p) for p in zip(*planes))

    def rows(self, codes: torch.Tensor, lens: torch.Tensor | None = None):
        raise NotImplementedError("open syncmers of a read matrix are no cell's answer yet")

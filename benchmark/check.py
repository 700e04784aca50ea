"""What decides `correct`: the reference's answer for each checked part of
a traffic's inputs (the inputs' generator says what a part is and how the
reference answers it), and the comparison of the program's answer with
it, bit for bit. The reference works from the inputs the harness made,
never from anything the program made.
"""

from __future__ import annotations

import gen
import reference


def differing(inputs, kept: list, ref, device) -> tuple[int, int]:
    """(parts of `kept`, a list of (key, answer), that differ from the
    reference, parts checked)."""
    by_key = {}
    for key, value in kept:
        by_key.setdefault(key, []).append(value)
    bad = 0
    for key, want in gen.expected(inputs, by_key.keys(), ref, device):
        bad += sum(not reference.same(v, want) for v in by_key[key])
    return bad, len(kept)

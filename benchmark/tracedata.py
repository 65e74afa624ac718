"""The benchmark's trace writer: a trace configuration -> a raw address
file, from a seeded generator.

A trace configuration names a loop nest (its spec document, ``spec``, as a
loop-nest configuration holds it) and the element size ``ds``.  Its trace
is what a DynamoRIO-style capture of that program's data references
holds: the byte address of every access, one thread running the nests in
program order (:func:`benchmark.reference.stream.serial_addresses`), as
packed little-endian u64.

Each array lives at a base of its own, as separate allocations do under
address-space randomisation: page-aligned, drawn from the generator in
``[2^32, 2^46)``, no two arrays' pages overlapping.  The bases are all the
generator decides; every seed's trace has the same accesses in the same
order, so every seed does the same work.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import stream

#: page size of the bases, and the range they are drawn from
PAGE = 4096
LOW, HIGH = 1 << 32, 1 << 46


def refs(config: dict) -> int:
    """Accesses of the whole trace: every nest's, once."""
    return sum(int(stream.iteration_sizes(n).sum())
               for n in config["spec"]["nests"])


def bases(config: dict, rng: np.random.Generator) -> dict:
    """Each array's first byte address, page-aligned, drawn from ``rng``
    until no two arrays' pages overlap."""
    arrays = config["spec"]["arrays"]
    pages = np.array([-(-n * config["ds"] // PAGE) for _, n in arrays],
                     np.int64)
    while True:
        first = rng.integers(LOW // PAGE, HIGH // PAGE - pages)
        order = np.argsort(first)
        if np.all(first[order][1:] >= (first + pages)[order][:-1]):
            return {name: int(b) * PAGE for (name, _), b in zip(arrays,
                                                                 first)}


def write(f, config: dict, rng: np.random.Generator, device="cpu") -> None:
    """Append the trace to the open binary file ``f``; the accesses are
    enumerated on ``device``."""
    for addr in stream.serial_addresses(config["spec"], config["ds"],
                                        bases(config, rng), device):
        addr.cpu().numpy().astype("<u8").tofile(f)
        del addr

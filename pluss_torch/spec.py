"""Loop-nest & reference specs — the rectangular subset of ``pluss/spec.py``.

A workload is a small declarative tree of :class:`Loop` and :class:`Ref`
nodes.  Because every loop of a rectangular nest has a constant trip count,
the *stream position* and the *element address* of every occurrence of every
static reference are affine functions of the iteration vector, which is what
lets the engine enumerate whole reference streams with broadcast arithmetic.

The dataclasses keep every field of the reference IR (``bound_coef``,
``start_coef``, ``bound_level``) so that any spec the codec carries across
decodes faithfully; :func:`flatten_nest` then refuses the shapes this slice
of the port does not run — bounded (triangular) loops, varying starts and
the quadratic-position contract — with ``NotImplementedError``.

Semantics preserved from the reference:

- Program order of references inside a loop body = their order in
  ``Loop.body``.
- One logical clock per simulated thread, incremented once per access.
- A reuse observed at a ref with ``share_span`` is "share" (crosses threads)
  iff ``2*reuse > span`` (``gemm_sampler.rs:199``).
"""

from __future__ import annotations

import dataclasses
from typing import Union

from pluss_torch.config import DEFAULT, SamplerConfig

#: the later slice of the port that runs the shapes refused here
LATER_SLICE = ("the triangular/quad engine slice of the port "
               "(see ROADMAP.md, PyTorch/CUDA port queue, item 1)")


@dataclasses.dataclass(frozen=True)
class Ref:
    """One static memory reference inside a loop body.

    ``addr_terms`` maps loop depth (0 = the nest's parallel loop) to the
    row-major address coefficient; the element address of an occurrence is
    ``addr_base + sum(coef * iv[depth])`` over iteration *values*.
    """

    name: str
    array: str
    addr_terms: tuple[tuple[int, int], ...]
    addr_base: int = 0
    share_span: int | None = None
    is_write: bool = False
    dtype_bytes: int | None = None


@dataclasses.dataclass(frozen=True)
class Loop:
    """``for iv in (start, start+step, ...) x trip: body``.

    ``bound_coef``/``start_coef``/``bound_level`` describe triangular and
    varying-start loops; they decode, but :func:`flatten_nest` refuses them.
    """

    trip: int
    body: tuple[Union["Loop", Ref], ...]
    start: int = 0
    step: int = 1
    bound_coef: tuple[int, int] | None = None
    start_coef: int = 0
    bound_level: int = 0


@dataclasses.dataclass(frozen=True)
class LoopNestSpec:
    """A workload: parallel loop nests over named arrays, run back to back.

    ``arrays``: (name, total elements) per array, in declaration order (the
    order of the reference's cold-miss flush and of the global line ids).
    """

    name: str
    arrays: tuple[tuple[str, int], ...]
    nests: tuple[Loop, ...]

    def array_index(self, name: str) -> int:
        for i, (a, _) in enumerate(self.arrays):
            if a == name:
                return i
        raise KeyError(name)

    def line_counts(self, cfg: SamplerConfig = DEFAULT) -> list[int]:
        """Cache lines per array: ceil(elements * DS / CLS)."""
        return [-(-n * cfg.ds // cfg.cls) for _, n in self.arrays]

    def line_bases(self, cfg: SamplerConfig = DEFAULT) -> list[int]:
        """Exclusive prefix sum of line_counts: global line-id base per array."""
        bases, acc = [], 0
        for n in self.line_counts(cfg):
            bases.append(acc)
            acc += n
        return bases

    def total_lines(self, cfg: SamplerConfig = DEFAULT) -> int:
        return sum(self.line_counts(cfg))


def loop_size(item: Union[Loop, Ref]) -> int:
    """Accesses performed by one execution of ``item``."""
    if isinstance(item, Ref):
        return 1
    return item.trip * sum(loop_size(b) for b in item.body)


@dataclasses.dataclass(frozen=True)
class FlatRef:
    """A reference flattened against its enclosing loop chain.

    For the occurrence with per-level indices ``idx[0..d]`` the stream
    position inside one execution of the nest is
    ``offset + sum(idx[l] * pos_strides[l])`` and the element address is
    ``addr_base + sum(addr_coefs[l] * (starts[l] + steps[l]*idx[l]))``.
    """

    ref: Ref
    trips: tuple[int, ...]
    starts: tuple[int, ...]
    steps: tuple[int, ...]
    pos_strides: tuple[int, ...]
    offset: int
    addr_coefs: tuple[int, ...]


def _nest_any(nest: Loop, pred) -> bool:
    """True when ``pred(loop)`` holds for any loop in the nest tree."""
    def walk(item) -> bool:
        if isinstance(item, Ref):
            return False
        return pred(item) or any(walk(b) for b in item.body)

    return walk(nest)


def nest_has_bounds(nest: Loop) -> bool:
    """True when any loop in the nest is bounded (``bound_coef``)."""
    return _nest_any(nest, lambda l: l.bound_coef is not None)


def nest_has_varying_start(nest: Loop) -> bool:
    """True when any loop in the nest has a nonzero ``start_coef``."""
    return _nest_any(nest, lambda l: bool(l.start_coef))


def nest_is_quad(nest: Loop) -> bool:
    """True when the nest needs the quadratic-position flatten: a bound
    referencing an inner level, or bounded loops nested inside each other."""
    def bounded_inside_bounded(item) -> bool:
        if isinstance(item, Ref):
            return False
        if item.bound_coef is not None and any(
                nest_has_bounds(b) for b in item.body if isinstance(b, Loop)):
            return True
        return any(bounded_inside_bounded(b) for b in item.body)

    inner = _nest_any(
        nest, lambda l: l.bound_coef is not None and l.bound_level > 0)
    return inner or bounded_inside_bounded(nest)


def check_rectangular(nest: Loop) -> None:
    """Raise ``NotImplementedError`` for any nest shape this slice cannot
    run exactly (never a silent wrong answer)."""
    for what, hit in (("the quadratic-position contract", nest_is_quad(nest)),
                      ("bounded (triangular) loops", nest_has_bounds(nest)),
                      ("varying loop starts", nest_has_varying_start(nest))):
        if hit:
            raise NotImplementedError(
                f"nest uses {what}; only rectangular nests run in this "
                f"slice — they wait for {LATER_SLICE}")


def flatten_nest(nest: Loop) -> list[FlatRef]:
    """Flatten one rectangular parallel nest into per-reference affine
    occurrence specs."""
    check_rectangular(nest)
    out: list[FlatRef] = []

    def walk(loop: Loop, chain: list[Loop], off: int) -> None:
        chain = chain + [loop]
        b_off = 0
        for item in loop.body:
            if isinstance(item, Ref):
                coefs = [0] * len(chain)
                for depth, coef in item.addr_terms:
                    if not 0 <= depth < len(chain):
                        raise ValueError(
                            f"ref {item.name}: addr term depth {depth} "
                            f"exceeds loop chain depth {len(chain)}")
                    coefs[depth] += coef
                out.append(FlatRef(
                    ref=item,
                    trips=tuple(l.trip for l in chain),
                    starts=tuple(l.start for l in chain),
                    steps=tuple(l.step for l in chain),
                    pos_strides=tuple(sum(loop_size(b) for b in l.body)
                                      for l in chain),
                    offset=off + b_off,
                    addr_coefs=tuple(coefs),
                ))
                b_off += 1
            else:
                walk(item, chain, off + b_off)
                b_off += loop_size(item)

    walk(nest, [], 0)
    return out


def nest_iteration_size(nest: Loop) -> int:
    """Accesses per iteration of the nest's outermost (parallel) loop."""
    check_rectangular(nest)
    return sum(loop_size(b) for b in nest.body)


def share_span_formula(trip: int, start: int = 0, step: int = 1) -> int:
    """The generated share threshold ``((trip-start)/step + 1) *
    ((trip-start)/step) + 1`` (``…omp.cpp:202``): 16513 for GEMM-128."""
    t = (trip - start) // step
    return (t + 1) * t + 1

"""The LoopNestSpec <-> JSON codec (the port's copy of ``pluss/spec_codec.py``).

A spec plus a :class:`~pluss_torch.config.SamplerConfig` is everything a run
depends on, so this JSON document is how a workload built by the JAX package
crosses into the port: :func:`spec_from_json` accepts exactly what the JAX
package's ``spec_to_json`` emits, and every malformation raises
:class:`SpecDecodeError` rather than a KeyError/TypeError.  The text and
file readers (:func:`load_spec_text`, :func:`load_spec_file`, the CLI's
``spec load``) raise the typed :class:`InvalidRequest` instead, for an
unparseable document, an unreadable file and a malformed spec alike.
"""

from __future__ import annotations

import json

from pluss_torch.resilience.errors import InvalidRequest
from pluss_torch.spec import Loop, LoopNestSpec, Ref


class SpecDecodeError(ValueError):
    """A spec document that does not decode."""


def spec_to_json(spec: LoopNestSpec) -> dict:
    """JSON-able dict encoding of a spec (inverse of :func:`spec_from_json`)."""

    def enc_item(item):
        if isinstance(item, Ref):
            d = {"name": item.name, "array": item.array,
                 "addr_terms": [list(t) for t in item.addr_terms]}
            if item.addr_base:
                d["addr_base"] = item.addr_base
            if item.share_span is not None:
                d["share_span"] = item.share_span
            if item.is_write:
                d["is_write"] = True
            if item.dtype_bytes is not None:
                d["dtype_bytes"] = item.dtype_bytes
            return d
        d = {"trip": item.trip, "body": [enc_item(b) for b in item.body]}
        if item.start:
            d["start"] = item.start
        if item.step != 1:
            d["step"] = item.step
        if item.bound_coef is not None:
            d["bound_coef"] = list(item.bound_coef)
        if item.start_coef:
            d["start_coef"] = item.start_coef
        if item.bound_level:
            d["bound_level"] = item.bound_level
        return d

    return {"name": spec.name,
            "arrays": [[a, n] for a, n in spec.arrays],
            "nests": [enc_item(n) for n in spec.nests]}


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _as_int(obj: dict, key: str, default, where: str) -> int:
    v = obj.get(key, default)
    if v is None:
        if default is None:
            raise SpecDecodeError(f"{where}: missing required field {key!r}")
        v = default   # explicit null means "use the default"
    if not _is_int(v):
        raise SpecDecodeError(
            f"{where}: field {key!r} must be an integer, got {v!r}")
    return v


def _dec_ref(d: dict, where: str) -> Ref:
    name, arr, terms = d.get("name"), d.get("array"), d.get("addr_terms")
    if not isinstance(name, str) or not isinstance(arr, str):
        raise SpecDecodeError(f"{where}: ref needs string 'name' and 'array'")
    if not isinstance(terms, list) or not all(
            isinstance(t, list) and len(t) == 2 and all(map(_is_int, t))
            for t in terms):
        raise SpecDecodeError(f"{where}: ref {name!r} needs addr_terms as a "
                              "list of [depth, coef] integer pairs")
    span, dtb = d.get("share_span"), d.get("dtype_bytes")
    for fld, v in (("share_span", span), ("dtype_bytes", dtb)):
        if v is not None and not _is_int(v):
            raise SpecDecodeError(f"{where}: ref {name!r} field {fld!r} "
                                  "must be an integer or null")
    return Ref(name=name, array=arr,
               addr_terms=tuple((t[0], t[1]) for t in terms),
               addr_base=_as_int(d, "addr_base", 0, where),
               share_span=span,
               is_write=bool(d.get("is_write", False)),
               dtype_bytes=dtb)


def _dec_item(d, where: str):
    if not isinstance(d, dict):
        raise SpecDecodeError(f"{where}: body item must be an object")
    if "array" in d:
        return _dec_ref(d, where)
    if "body" not in d:
        raise SpecDecodeError(f"{where}: item is neither a ref (has 'array') "
                              "nor a loop (has 'body')")
    body = d.get("body")
    if not isinstance(body, list) or not body:
        raise SpecDecodeError(f"{where}: loop needs a non-empty 'body' list")
    bc = d.get("bound_coef")
    if bc is not None and not (isinstance(bc, list) and len(bc) == 2
                               and all(map(_is_int, bc))):
        raise SpecDecodeError(
            f"{where}: bound_coef must be an [a, b] integer pair or null")
    return Loop(trip=_as_int(d, "trip", None, where),
                body=tuple(_dec_item(b, where + ".body") for b in body),
                start=_as_int(d, "start", 0, where),
                step=_as_int(d, "step", 1, where),
                bound_coef=tuple(bc) if bc is not None else None,
                start_coef=_as_int(d, "start_coef", 0, where),
                bound_level=_as_int(d, "bound_level", 0, where))


def spec_from_json(obj) -> LoopNestSpec:
    """Decode a spec document; every malformation raises
    :class:`SpecDecodeError`."""
    if not isinstance(obj, dict):
        raise SpecDecodeError(
            f"spec must be an object, got {type(obj).__name__}")
    name = obj.get("name")
    if not isinstance(name, str) or not name:
        raise SpecDecodeError("spec needs a non-empty string 'name'")
    arrays = obj.get("arrays")
    if not isinstance(arrays, list) or not all(
            isinstance(a, list) and len(a) == 2 and isinstance(a[0], str)
            and _is_int(a[1]) and a[1] > 0 for a in arrays):
        raise SpecDecodeError(
            "spec 'arrays' must be a list of [name, elements>0] pairs")
    nests = obj.get("nests")
    if not isinstance(nests, list) or not nests:
        raise SpecDecodeError("spec needs a non-empty 'nests' list")
    return LoopNestSpec(
        name=name,
        arrays=tuple((a, n) for a, n in arrays),
        nests=tuple(_dec_item(n, f"nests[{i}]") for i, n in enumerate(nests)),
    )


def dump_spec(spec: LoopNestSpec, indent: int | None = 1) -> str:
    """Spec as canonical JSON text (``cli spec dump``)."""
    return json.dumps(spec_to_json(spec), indent=indent)


def load_spec_text(text: str, where: str = "spec") -> LoopNestSpec:
    """Decode JSON text; a parse failure is the same typed
    :class:`InvalidRequest` as a schema failure."""
    try:
        obj = json.loads(text)
    except ValueError as e:
        raise InvalidRequest(f"{where}: unparseable spec JSON: {e}",
                             site="spec.codec", cause=e)
    try:
        return spec_from_json(obj)
    except SpecDecodeError as e:
        raise InvalidRequest(str(e), site="spec.codec", cause=e)


def load_spec_file(path: str) -> LoopNestSpec:
    """Decode one ``cli spec dump``-style file (``cli spec load``)."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError as e:
        raise InvalidRequest(f"cannot read spec file {path}: {e}",
                             site="spec.codec", cause=e)
    return load_spec_text(text, where=path)


def specs_equal(a: LoopNestSpec, b: LoopNestSpec) -> bool:
    """Codec equality: two specs whose canonical JSON documents match.
    (Frozen-dataclass ``==`` is the same relation; going through the
    codec additionally pins that no field escapes the encoding.)"""
    return spec_to_json(a) == spec_to_json(b)

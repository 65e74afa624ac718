"""SARIF 2.1.0 export of PLxxx findings.

The port's copy of ``pluss/analysis/sarif.py``.

``cli lint/analyze/predict --sarif <path>`` writes the diagnostics
stream as a single-run SARIF log so CI systems render them as native
code-scanning annotations.  The mapping is deliberately small and
lossless where SARIF has a slot:

- one ``run`` with ``tool.driver.name = "pluss"``; every PLxxx code that
  occurs becomes a ``rules`` entry (id = code, shortDescription = the
  registered :data:`pluss_torch.analysis.diagnostics.CODES` summary);
- one ``result`` per diagnostic: ``ruleId``/``level``/``message``; the
  model and IR tree path have no file/line to anchor to (specs are
  in-memory IR), so they travel in ``message.text`` and under
  ``properties`` (``model``, ``path``, ``nest``, ``ref``, ``array``)
  where SARIF consumers keep them queryable;
- severity map: ERROR -> ``error``, WARNING -> ``warning``,
  INFO -> ``note`` (the SARIF ``kind`` stays the default ``fail``).
"""

from __future__ import annotations

import json

from pluss_torch.analysis.diagnostics import CODES, Diagnostic, Severity

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")

_LEVEL = {
    Severity.ERROR: "error",
    Severity.WARNING: "warning",
    Severity.INFO: "note",
}


def _rule(code: str) -> dict:
    family, summary = CODES.get(code, ("unknown", code))
    return {
        "id": code,
        "shortDescription": {"text": summary},
        "properties": {"family": family},
    }


def _result(d: Diagnostic) -> dict:
    props = {k: v for k, v in (
        ("model", d.model), ("path", d.path), ("nest", d.nest),
        ("ref", d.ref), ("array", d.array),
    ) if v is not None and v != ""}
    out = {
        "ruleId": d.code,
        "level": _LEVEL[d.severity],
        "message": {"text": d.format()},
    }
    if props:
        out["properties"] = props
    return out


def to_sarif(diags: list[Diagnostic], tool_version: str = "0") -> dict:
    """The SARIF 2.1.0 document (a plain JSON-able dict)."""
    rules = sorted({d.code for d in diags})
    return {
        "version": SARIF_VERSION,
        "$schema": SARIF_SCHEMA,
        "runs": [{
            "tool": {"driver": {
                "name": "pluss",
                "informationUri": "https://github.com/",
                "version": tool_version,
                "rules": [_rule(c) for c in rules],
            }},
            "results": [_result(d) for d in diags],
        }],
    }


def write_sarif(path: str, diags: list[Diagnostic],
                tool_version: str = "0") -> None:
    with open(path, "w") as f:
        json.dump(to_sarif(diags, tool_version), f, indent=2)
        f.write("\n")


def validate(doc: dict) -> list[str]:
    """Structural round-trip check (no jsonschema dependency): the
    invariants the export guarantees and the tests pin.  Returns a list
    of violations (empty = valid)."""
    errs = []
    if doc.get("version") != SARIF_VERSION:
        errs.append(f"version {doc.get('version')!r} != {SARIF_VERSION}")
    if not str(doc.get("$schema", "")).startswith("https://"):
        errs.append("$schema missing")
    runs = doc.get("runs")
    if not isinstance(runs, list) or len(runs) != 1:
        return errs + ["runs must be a one-element list"]
    run = runs[0]
    driver = run.get("tool", {}).get("driver", {})
    if driver.get("name") != "pluss":
        errs.append("tool.driver.name != pluss")
    rule_ids = {r.get("id") for r in driver.get("rules", [])}
    for i, res in enumerate(run.get("results", [])):
        if res.get("ruleId") not in rule_ids:
            errs.append(f"results[{i}].ruleId {res.get('ruleId')!r} "
                        "not declared in driver.rules")
        if res.get("level") not in ("error", "warning", "note"):
            errs.append(f"results[{i}].level invalid")
        if not res.get("message", {}).get("text"):
            errs.append(f"results[{i}].message.text missing")
        if res.get("ruleId") not in CODES:
            errs.append(f"results[{i}].ruleId not a registered PL code")
    return errs

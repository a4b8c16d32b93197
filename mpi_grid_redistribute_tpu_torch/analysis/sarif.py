"""CI output formats for the port's findings (the port's copy of the JAX
package's ``analysis/sarif.py``; for the same findings the documents and
lines are byte-equal to the reference's).

SARIF 2.1.0 (the static-analysis interchange format GitHub code
scanning ingests) plus plain ``::warning`` workflow-command lines for
inline PR annotations without an upload step. Duck-typed: anything
carrying ``rule``/``path``/``line``/``message`` renders (the tools'
:class:`~.core.Finding`, progcheck's :class:`~.progcheck.ProgFinding`
with its ``program``).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemas/sarif-schema-2.1.0.json"
)


def _message_of(f) -> str:
    # progcheck findings carry the program name; fold it into the text
    # so SARIF viewers (which only show path/line) keep the context
    program = getattr(f, "program", None)
    if program:
        return f"<{program}>: {f.message}"
    symbol = getattr(f, "symbol", None)
    if symbol:
        return f"[{symbol}] {f.message}"
    return f.message


def to_sarif(
    findings: Iterable,
    tool_name: str,
    rule_docs: Optional[Dict[str, str]] = None,
) -> dict:
    """One SARIF run over ``findings``. ``rule_docs`` (rule id ->
    one-line description) populates the tool's rule metadata so viewers
    show what each id means."""
    findings = list(findings)
    rule_ids = sorted({f.rule for f in findings})
    if rule_docs:
        rule_ids = sorted(set(rule_ids) | set(rule_docs))
    rules = [
        {
            "id": rid,
            "shortDescription": {
                "text": (rule_docs or {}).get(rid, rid)
            },
        }
        for rid in rule_ids
    ]
    index = {rid: i for i, rid in enumerate(rule_ids)}
    results = []
    for f in findings:
        region = {"startLine": max(int(getattr(f, "line", 1)), 1)}
        col = getattr(f, "col", None)
        if col is not None:
            region["startColumn"] = max(int(col) + 1, 1)  # SARIF is 1-based
        results.append(
            {
                "ruleId": f.rule,
                "ruleIndex": index[f.rule],
                "level": "error",
                "message": {"text": _message_of(f)},
                "locations": [
                    {
                        "physicalLocation": {
                            "artifactLocation": {
                                "uri": str(f.path).replace("\\", "/")
                            },
                            "region": region,
                        }
                    }
                ],
            }
        )
    return {
        "version": SARIF_VERSION,
        "$schema": SARIF_SCHEMA,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": tool_name,
                        "informationUri": (
                            "https://github.com/mpi_grid_redistribute_tpu"
                        ),
                        "rules": rules,
                    }
                },
                "results": results,
            }
        ],
    }


def merge_sarif(docs: Iterable[dict]) -> dict:
    """One SARIF document holding every run of several tool outputs (one
    upload for several checkers). Runs keep their own tool metadata;
    SARIF viewers group results per driver."""
    runs = [run for doc in docs for run in doc.get("runs", [])]
    return {
        "version": SARIF_VERSION,
        "$schema": SARIF_SCHEMA,
        "runs": runs,
    }


def github_annotations(findings: Iterable) -> List[str]:
    """GitHub Actions workflow-command lines: printed to stdout inside a
    workflow they render as inline PR annotations, no SARIF upload
    needed."""
    lines = []
    for f in findings:
        loc = f"file={f.path},line={max(int(getattr(f, 'line', 1)), 1)}"
        col = getattr(f, "col", None)
        if col is not None:
            loc += f",col={max(int(col) + 1, 1)}"
        title = f.rule
        msg = _message_of(f).replace("%", "%25").replace("\n", "%0A")
        lines.append(f"::warning {loc},title={title}::{msg}")
    return lines

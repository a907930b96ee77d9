"""JSON Schema for ``results/benchmarks.json`` and a validator CLI (port
of :mod:`repro.obs.schema`, the schema JSON-equal to the reference's).

The benchmark driver (:mod:`benchmarks.run`) writes one JSON object
mapping section names to row arrays; CI validates the file after every
bench run so a malformed row (a stringified number, a dropped
``derived`` field, a telemetry dict that stopped being numeric) fails
the job instead of silently rotting the published results.

Row shapes, by construction of the writers:

  * timing rows: ``{"name", "us_per_call", "derived"}`` plus an
    optional ``"telemetry"`` dict of numeric fault/energy counters;
  * section-skip rows: ``{"name", "status": "skipped", "error"}``;
  * paper-figure rows: ``{"fig", ...}`` free-form numeric fields;
  * roofline cells: ``{"cell", ...}`` (ok cells carry the model
    breakdown, skipped cells ``status``/``reason``);
  * model-zoo rows (``sched_zoo_*``): a structured ``zoo`` object --
    arch/family/route/cache layouts plus tokens/sec and joules/token
    as real numbers, so per-family dashboards never parse the
    ``derived`` string.

Usage::

    PYTHONPATH=src python -m repro_torch.obs.schema results/benchmarks.json
"""
from __future__ import annotations

import json
import sys

BENCHMARKS_SCHEMA = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "title": "repro benchmark results",
    "type": "object",
    "minProperties": 1,
    "additionalProperties": {
        "type": "array",
        "items": {
            "type": "object",
            "anyOf": [
                {"required": ["name"]},
                {"required": ["fig"]},
                {"required": ["cell"]},
            ],
            "properties": {
                "name": {"type": "string", "minLength": 1},
                "fig": {"type": "string"},
                "cell": {"type": "string"},
                "status": {"const": "skipped"},
                "error": {"type": "string"},
                "reason": {"type": "string"},
                "us_per_call": {"type": "number", "minimum": 0},
                "derived": {"type": "string"},
                "telemetry": {
                    "type": "object",
                    "minProperties": 1,
                    "additionalProperties": {
                        "type": "number", "minimum": 0},
                },
                "zoo": {
                    "type": "object",
                    "required": ["arch", "family", "route",
                                 "cache_layouts", "tokens_per_sec",
                                 "joules_per_token", "decode_traces"],
                    "properties": {
                        "arch": {"type": "string", "minLength": 1},
                        "family": {"type": "string", "minLength": 1},
                        "route": {"enum": ["paged", "state"]},
                        "cache_layouts": {
                            "type": "array",
                            "minItems": 1,
                            "items": {"enum": ["full", "window",
                                               "cross", "state"]},
                        },
                        "tokens_per_sec": {
                            "type": "number", "exclusiveMinimum": 0},
                        "joules_per_token": {
                            "type": "number", "exclusiveMinimum": 0},
                        "decode_traces": {"const": 1},
                    },
                },
            },
            # A named timing row that was not skipped must carry the
            # CSV columns the drivers print.
            "if": {
                "required": ["name"],
                "not": {"required": ["status"]},
            },
            "then": {"required": ["us_per_call", "derived"]},
        },
    },
}


def validate_benchmarks(path: str) -> dict:
    """jsonschema-validate one results file; returns the parsed doc.

    Raises ``jsonschema.ValidationError`` on schema violations and
    ``ValueError`` on unparseable JSON.  ``jsonschema`` is imported here,
    not with the module: nothing else of the port needs it.
    """
    import jsonschema
    with open(path) as f:
        try:
            doc = json.load(f)
        except json.JSONDecodeError as e:
            raise ValueError(f"{path}: not valid JSON: {e}") from e
    jsonschema.validate(doc, BENCHMARKS_SCHEMA)
    return doc


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else "results/benchmarks.json"
    doc = validate_benchmarks(path)
    n_rows = sum(len(rows) for rows in doc.values())
    print(f"{path}: OK ({len(doc)} sections, {n_rows} rows)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

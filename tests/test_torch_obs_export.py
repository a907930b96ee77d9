"""The port's exporters and benchmark schema (``obs/export.py``,
``obs/schema.py``) against the reference's.

The reference's exporters are pure Python over a scheduler's ``stats``,
``metrics``, ``state``, ``trace`` and ``pricing_voltages``; they run here
on a stand-in that carries the port scheduler's, so no JAX scheduler is
compiled, and the port's text and snapshot must equal theirs.  The
schema is JSON-equal to the reference's and is checked on in-memory
documents (the reference test's two invalid rows among them); no
committed results file is read.
"""
import io
import json
import types

import numpy as np
import pytest
import torch

from repro.obs import export as jexport
from repro.obs import schema as jschema

from repro_torch.core.domains import MemoryDomain
from repro_torch.core.hbm import VCU128
from repro_torch.models.base import get_arch, init_params
from repro_torch.obs import export, schema
from repro_torch.serving.engine import ServeConfig
from repro_torch.serving.scheduler import ContinuousBatchingScheduler, Request
from repro_torch.training.undervolt import UndervoltPlan

BUNDLE = get_arch("llama3.2-3b")
CFG = BUNDLE.reduced
LENS = (5, 9, 12, 7, 3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs files in parallel workers, and
    the port's small tensors gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["clean", "0.91V"])
def served(request):
    """A port scheduler after five requests (metrics and trace on)."""
    params = init_params(BUNDLE.module.param_specs(CFG),
                         torch.Generator().manual_seed(0), device="cpu")
    plan = None if request.param == "clean" else UndervoltPlan(
        domains={"kv": MemoryDomain("kv", 0.91, (8, 15, 18, 29))},
        policy={"kv_cache": "kv"}, geometry=VCU128)
    sc = ServeConfig(max_len=32, max_new_tokens=4, undervolt=plan,
                     kv_injection="read", kv_method="word")
    s = ContinuousBatchingScheduler(BUNDLE, CFG, params, sc, num_slots=4,
                                    num_pages=16, page_slots=8,
                                    device="cpu")
    rng = np.random.RandomState(3)
    for i, ln in enumerate(LENS):
        s.submit(Request(rid=f"r{i}", tokens=rng.randint(0, CFG.vocab, (ln,)),
                         max_new_tokens=4))
    s.run()
    return s


def _standin(s):
    return types.SimpleNamespace(
        stats=s.stats, metrics=s.metrics, state=s.state, trace=s.trace,
        pricing_voltages=s.pricing_voltages)


def test_prometheus_text_equals_reference(served):
    txt = export.prometheus_text(served)
    assert txt == jexport.prometheus_text(_standin(served))
    for ln in txt.strip().split("\n"):
        if ln.startswith("#"):
            assert ln.startswith(("# HELP repro_", "# TYPE repro_")), ln
        else:
            name, _, val = ln.rpartition(" ")
            float(val)
            assert name.startswith("repro_"), ln
    assert "repro_decode_traces 1" in txt
    assert 'repro_tokens_decoded_total{shard="0"}' in txt
    assert "repro_fleet_joules_per_token" in txt
    assert f'repro_events_total{{kind="admission"}} {len(LENS)}' in txt


def test_json_snapshot_equals_reference(served):
    snap = export.json_snapshot(served)
    assert snap == jexport.json_snapshot(_standin(served))
    back = json.loads(json.dumps(snap))
    assert back["stats"]["decode_traces"] == 1
    assert back["stats"]["shards"][0]["shard"] == 0
    assert len(back["stats"]["shards"]) == 1
    assert back["metrics"]["totals"]["tokens_decoded"] == 3 * len(LENS)
    assert back["events"]["counts"]["retirement"] == len(LENS)
    assert export.shard_voltages(served) == [served.pricing_voltage]


def test_write_trace_jsonl_round_trips(served, tmp_path):
    path = tmp_path / "trace.jsonl"
    n = export.write_trace_jsonl(served, str(path))
    assert n == len(served.trace) > 0
    rows = [json.loads(ln) for ln in path.read_text().strip().split("\n")]
    assert rows == [e.to_dict() for e in served.trace]
    buf = io.StringIO()
    assert served.trace.to_jsonl(buf) == n
    assert buf.getvalue() == path.read_text()
    off = types.SimpleNamespace(trace=None)
    assert export.write_trace_jsonl(off, str(tmp_path / "none")) == 0


VALID = {
    "kernels": [{"name": "k", "us_per_call": 1.5, "derived": "x",
                 "telemetry": {"faults": 3}},
                {"name": "gone", "status": "skipped", "error": "e"}],
    "figs": [{"fig": "fig6", "v": 0.9}],
    "roofline": [{"cell": "c", "status": "skipped", "reason": "r"}],
    "zoo": [{"name": "sched_zoo_x", "us_per_call": 2.0, "derived": "d",
             "zoo": {"arch": "gemma3-4b", "family": "dense",
                     "route": "paged", "cache_layouts": ["full", "window"],
                     "tokens_per_sec": 10.0, "joules_per_token": 0.1,
                     "decode_traces": 1}}],
}
INVALID = [{"s": [{"name": "x", "us_per_call": "fast"}]},
           {"s": [{"us_per_call": 1.0}]},
           {"s": [{"name": "z", "us_per_call": 1.0, "derived": "d",
                   "zoo": {"arch": "a", "family": "f", "route": "paged",
                           "cache_layouts": ["full"], "tokens_per_sec": 1,
                           "joules_per_token": 1, "decode_traces": 2}}]}]


def test_schema_equals_reference_and_validates():
    jsonschema = pytest.importorskip("jsonschema")
    assert json.dumps(schema.BENCHMARKS_SCHEMA, sort_keys=True) == \
        json.dumps(jschema.BENCHMARKS_SCHEMA, sort_keys=True)
    jsonschema.validate(VALID, schema.BENCHMARKS_SCHEMA)
    for doc in INVALID:
        with pytest.raises(jsonschema.ValidationError):
            jsonschema.validate(doc, schema.BENCHMARKS_SCHEMA)


def test_schema_cli(tmp_path, capsys):
    jsonschema = pytest.importorskip("jsonschema")
    good = tmp_path / "good.json"
    good.write_text(json.dumps(VALID))
    assert schema.main([str(good)]) == 0
    assert capsys.readouterr().out.strip() == f"{good}: OK (4 sections, 5 rows)"
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.raises(ValueError, match="not valid JSON"):
        schema.validate_benchmarks(str(bad))
    bad.write_text(json.dumps(INVALID[0]))
    with pytest.raises(jsonschema.ValidationError):
        schema.validate_benchmarks(str(bad))

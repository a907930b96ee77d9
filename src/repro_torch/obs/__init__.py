"""Observability plane of the paged serving scheduler (port of
:mod:`repro.obs`): in-step metric counters kept on the device beside the
serving state, host-side step latencies, energy accounting from the
paper's power curve, a bounded trace of typed scheduler events, the
Prometheus-text / JSON exporters and the JSONL trace dump
(:mod:`repro_torch.obs.export`) and the benchmark artifact's schema
(:mod:`repro_torch.obs.schema`, which imports ``jsonschema`` only to
validate)."""
from repro_torch.obs.energy import DEFAULT_ENERGY_MODEL, EnergyModel
from repro_torch.obs.metrics import (STEP_COUNTERS, MetricsRegistry,
                                     ObsConfig, step_counter_delta)
from repro_torch.obs.trace import Event, EventTrace

__all__ = [
    "DEFAULT_ENERGY_MODEL", "EnergyModel", "STEP_COUNTERS",
    "MetricsRegistry", "ObsConfig", "step_counter_delta", "Event",
    "EventTrace",
]

"""Observability plane of the paged serving scheduler (port of
:mod:`repro.obs`): in-step metric counters kept on the device beside the
serving state, host-side step latencies, energy accounting from the
paper's power curve, and a bounded trace of typed scheduler events.
The Prometheus / JSON exporters and the artifact schema are not ported
yet."""
from repro_torch.obs.energy import DEFAULT_ENERGY_MODEL, EnergyModel
from repro_torch.obs.metrics import (STEP_COUNTERS, MetricsRegistry,
                                     ObsConfig, step_counter_delta)
from repro_torch.obs.trace import Event, EventTrace

__all__ = [
    "DEFAULT_ENERGY_MODEL", "EnergyModel", "STEP_COUNTERS",
    "MetricsRegistry", "ObsConfig", "step_counter_delta", "Event",
    "EventTrace",
]

"""The paper's own experimental configuration (port of
:mod:`repro.configs.paper`): the VCU128 testbench (2 x 4 GB HBM2 stacks,
32 pseudo-channels) and the calibrated models.  Not an LM architecture --
this is the configuration consumed by the paper-reproduction benchmarks
and the undervolt-aware training examples.
"""
import dataclasses

from repro_torch.core.faultmap import PAPER_MAP_SEED, FaultMap
from repro_torch.core.faultmodel import DEFAULT_FAULT_MODEL
from repro_torch.core.hbm import TPU_V5E, VCU128
from repro_torch.core.voltage import DEFAULT_POWER_MODEL


@dataclasses.dataclass(frozen=True)
class PaperConfig:
    geometry = VCU128
    tpu_geometry = TPU_V5E
    map_seed: int = PAPER_MAP_SEED
    fault_model = DEFAULT_FAULT_MODEL
    power_model = DEFAULT_POWER_MODEL

    def fault_map(self, geometry=None) -> FaultMap:
        return FaultMap.from_seed(geometry or self.geometry, self.map_seed)


PAPER = PaperConfig()

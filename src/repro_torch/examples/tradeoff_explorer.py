"""The paper's three-factor trade-off, driven by the vectorized frontier
solver (the port's counterpart of the reference's
``examples/tradeoff_explorer.py``): one call evaluates every voltage at
once, and the same stacked arrays back the runtime voltage governor,
whose walk is printed too.  Host only.

  PYTHONPATH=src python -m repro_torch.examples.tradeoff_explorer [cap_gb] [rate]
"""
from __future__ import annotations

import sys

import numpy as np

from repro_torch.core.domains import MemoryDomain
from repro_torch.core.faultmap import PAPER_MAP_SEED, FaultMap
from repro_torch.core.hbm import VCU128
from repro_torch.core.tradeoff import TradeoffSolver, voltage_grid
from repro_torch.training.undervolt import UndervoltPlan


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    cap_gb = float(argv[0]) if len(argv) > 0 else 4.0
    rate = float(argv[1]) if len(argv) > 1 else 1e-6
    fmap = FaultMap.from_seed(VCU128, seed=PAPER_MAP_SEED)
    solver = TradeoffSolver(fmap)

    p = solver.solve(int(cap_gb * 2**30), rate)
    print(f"requirement: {cap_gb} GB at fault rate <= {rate:g}")
    print(f"  -> run HBM at {p.voltage:.2f} V on {len(p.pc_ids)} PCs")
    print(f"     power savings {p.savings:.2f}x, worst PC rate "
          f"{p.worst_pc_rate:.2e}")

    # One vectorized frontier solve per tolerance: stacked per-voltage
    # arrays (savings, usable PCs, capacity) straight off the solver.
    print("\nFig. 6 frontier (usable PCs | savings):")
    rates = [0.0, 1e-8, 1e-6, 1e-4]
    grid = np.asarray([v for v in voltage_grid()
                       if round(v * 100) % 2 == 0])
    fronts = {r: solver.frontier(grid, r) for r in rates}
    print("   V    save " + "".join(f"  tol={r:<8g}" for r in rates))
    for i, v in enumerate(grid):
        cols = "".join(
            f"  {int(fronts[r].num_usable[i]):4d} PCs   " for r in rates)
        print(f"  {v:.2f} {float(fronts[rates[0]].savings[i]):4.2f}x{cols}")

    # The same frontier as a control loop: a runtime governor walking
    # voltage against a power budget for a cheap KV-cache domain.
    plan = UndervoltPlan(
        domains={"kv": MemoryDomain(
            "kv", 0.91,
            tuple(int(x) for x in fmap.reliability_order(0.91)[:16]))},
        policy={"kv_cache": "kv"}, geometry=VCU128,
        map_seed=PAPER_MAP_SEED)
    gov = plan.make_governor("kv", mode="power", tolerable_rate=1e-3)
    print("\ngovernor walk (power budget -> planned voltage):")
    for budget in (1.0, 0.75, 0.65, 0.6, 0.55):
        print(f"  budget {budget:4.2f}x nominal -> "
              f"{float(gov.voltage_at(budget)):.2f} V")


if __name__ == "__main__":
    main()

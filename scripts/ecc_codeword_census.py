#!/usr/bin/env python3
"""Which codewords of ``chip_smoke.py``'s T2 parameter arena can go
uncorrectable, from the fault map alone, and how many a pass should flag.

    python3 scripts/ecc_codeword_census.py [--voltage 0.94] [--device cuda]
        [--out build/ecc_codeword_census.json]

Run from the root of a checkout.  It places T2's parameter group
(llama3.2-3b at full width cut to ``chip_smoke.TRAIN_LAYERS`` layers) on
T2's plan with ECC at the voltage, and for every codeword (an adjacent
word pair) of the arena counts its stuck data cells -- the word path's
stuck-at-1 and stuck-at-0 masks of both words, as
``kernels/ecc/ref.py::ecc_codeword_events`` draws them -- and its parity
draw (one per codeword; a hit always counts as a fault).  A stuck data
cell shows only when the stored bit differs from the stuck value:
probability 1/2 for random data.  It prints the histogram of codewords by
(stuck data cells, parity hit), the expected uncorrectable (>= 2 faults
shown) and corrected (exactly 1) codewords per pass, and every codeword
that can go uncorrectable (word id, PC, weak row, stuck cells, parity).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CHUNK_BLOCKS = 2048


def census(voltage: float, device):
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import engine
    from repro_torch.core import faultmap as fm
    from repro_torch.core import hashing as H
    from repro_torch.kernels.bitflip.bitflip import block_word_ids
    from repro_torch.kernels.bitflip.ref import _weak_rows, word_masks
    from repro_torch.kernels.ecc.ref import STREAM_PARITY, popcount32
    from repro_torch.models.base import get_arch
    from repro_torch.training import trainer
    bundle = get_arch("llama3.2-3b")
    cfg = dataclasses.replace(bundle.cfg, n_layers=cs.TRAIN_LAYERS)
    plan = cs.train_plan(voltage, ecc=True)
    placement = trainer._placements(
        bundle, cfg, trainer.TrainConfig(undervolt=plan))["params"]
    fmap = plan.fault_map()
    base, thr, _ = engine.device_tables(placement, fmap, voltage, device)
    block_pc = torch.as_tensor(placement.block_table().block_pc).long()
    seed, wprl2 = fmap.seed, fmap.words_per_row_log2
    hist = {}
    p_unc = p_corr = 0.0
    risky = []
    nb = base.shape[0]
    for s in range(0, nb, CHUNK_BLOCKS):
        e = min(nb, s + CHUNK_BLOCKS)
        wid = block_word_ids(H.as_u64(base[s:e]))            # (nb, 4096)
        t = H.as_u64(thr[s:e])
        col = lambda c: t[:, c][:, None]                     # noqa: E731
        m01, m10 = word_masks(
            wid, seed, q01_weak=col(fm.COL_Q01_WEAK),
            q01_strong=col(fm.COL_Q01_STRONG), q10_weak=col(fm.COL_Q10_WEAK),
            q10_strong=col(fm.COL_Q10_STRONG),
            weak_row_q=col(fm.COL_WEAK_ROW_Q), words_per_row_log2=wprl2)
        stuck = popcount32((m01 | (m10 & (m01 ^ H.MASK))))
        pair = stuck.reshape(e - s, -1, 2).sum(-1)           # per codeword
        cw_wid = wid[:, 0::2]
        weak = _weak_rows(cw_wid, seed, col(fm.COL_WEAK_ROW_Q), wprl2)
        q = torch.where(weak, col(fm.COL_PAR_Q_WEAK),
                        col(fm.COL_PAR_Q_STRONG))
        par = (H.hash_stream(seed, STREAM_PARITY, cw_wid >> 1) < q).long()
        key = pair * 2 + par
        vals, cnt = torch.unique(key, return_counts=True)
        for v_, c_ in zip(vals.tolist(), cnt.tolist()):
            hist[(v_ // 2, v_ % 2)] = hist.get((v_ // 2, v_ % 2), 0) + c_
        for i, j in torch.nonzero(pair + par >= 2).tolist():
            blk = s + i
            risky.append(dict(
                word_id=int(cw_wid[i, j]) & H.MASK,
                pc=int(block_pc[blk]), weak_row=bool(weak[i, j]),
                stuck_data_cells=int(pair[i, j]), parity_hit=bool(par[i, j]),
                stuck_to_1=[int(m01[i, 2 * j + w]) & H.MASK for w in (0, 1)],
                stuck_to_0=[int(m10[i, 2 * j + w] & (m01[i, 2 * j + w]
                                                     ^ H.MASK)) & H.MASK
                            for w in (0, 1)]))
    for (n, par), c in hist.items():
        # faults shown: Binomial(n, 1/2) data cells + the parity hit
        p0 = 0.5 ** n
        p1 = n * 0.5 ** n
        if par:
            p_unc += c * (1.0 - p0)
            p_corr += c * p0
        else:
            p_unc += c * (1.0 - p0 - p1)
            p_corr += c * p1
    return dict(voltage=voltage, layers=cs.TRAIN_LAYERS, blocks=nb,
                codewords=sum(hist.values()),
                histogram={f"{n} stuck cells, parity {par}": c
                           for (n, par), c in sorted(hist.items())},
                expected_uncorrectable_per_pass=p_unc,
                expected_corrected_per_pass=p_corr,
                can_go_uncorrectable=risky)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--voltage", type=float, default=0.94)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("ecc_codeword_census.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    report = census(args.voltage, torch.device(args.device))
    if args.device == "cuda":
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps({k: v for k, v in report.items()
                      if k != "can_go_uncorrectable"}))
    for cw in report["can_go_uncorrectable"]:
        print(json.dumps(cw))
    return 0


if __name__ == "__main__":
    sys.exit(main())

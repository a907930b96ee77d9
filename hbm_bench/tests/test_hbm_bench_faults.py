"""The reference's frozen fault arithmetic against the program's."""
import numpy as np
import pytest
import torch

from hbm_bench.reference import dense as RD
from hbm_bench.reference import faults as F
from hbm_bench.tests.twins import yi_twin

from repro_torch.core import faultmap as fm
from repro_torch.core import hashing as H
from repro_torch.core.faultmap import PAPER_MAP_SEED, FaultMap
from repro_torch.core.hbm import VCU128
from repro_torch.kernels.ecc.ecc import arena_ecc_events
from repro_torch.kernels.flash_attention import faulty

VOLTAGES = (0.86, 0.875, 0.88, 0.9, 0.95, 1.0)


@pytest.mark.parametrize("v", VOLTAGES)
def test_pcs_and_thresholds_equal_the_programs(v):
    prog = FaultMap.from_seed(VCU128, seed=PAPER_MAP_SEED)
    mine = F.FaultMap(PAPER_MAP_SEED)
    assert tuple(int(p) for p in prog.usable_pcs(v, 1.0))[:16] == \
        mine.usable_pcs(v, 16)
    table = H.as_u64(prog.threshold_table(v))
    thr = mine.thresholds(v)
    for key, col in (("q01_weak", fm.COL_Q01_WEAK),
                     ("q01_strong", fm.COL_Q01_STRONG),
                     ("q10_weak", fm.COL_Q10_WEAK),
                     ("q10_strong", fm.COL_Q10_STRONG),
                     ("weak_row_q", fm.COL_WEAK_ROW_Q),
                     ("par_weak", fm.COL_PAR_Q_WEAK),
                     ("par_strong", fm.COL_PAR_Q_STRONG)):
        assert torch.equal(table[:, col], thr[key]), key


@pytest.mark.parametrize("v", (0.855, 0.86))
def test_secded_round_equals_the_programs(v):
    mine = F.FaultMap(PAPER_MAP_SEED)
    pcs = mine.usable_pcs(v, 16)
    data = torch.randint(0, 2**32, (96, 512), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(3))
    off = torch.arange(data.numel(), dtype=torch.int64).reshape(data.shape)
    wid, pc = F.physical_words(5, off + 77 * 4096, pcs)
    out, bad = F.ecc_round(data, wid, mine.thresholds(v), pc,
                           PAPER_MAP_SEED)
    table = H.as_u64(FaultMap.from_seed(VCU128, PAPER_MAP_SEED)
                     .threshold_table(v))
    row = tuple(table[pc][..., c] for c in range(fm.NUM_THR_COLS))
    want, _, unc = arena_ecc_events(data, wid, row, seed=PAPER_MAP_SEED,
                                    words_per_row_log2=8)
    assert torch.equal(out, want) and bad == int(unc.sum()) and bad > 0
    assert F.weak_codewords(wid, mine.thresholds(v), pc,
                            PAPER_MAP_SEED) >= bad


def test_kv_read_back_equals_the_programs_paged_read():
    """K words of random pages, read back by the reference, equal what
    the program's paged read path loads from the same pool pages."""
    from hbm_bench import serve_paged
    from hbm_bench.tests.twins import yi_mix
    from repro_torch.serving.paged import PagedKVCache
    cfg, mix = yi_twin(voltage=0.86), yi_mix()
    sched = serve_paged.build(cfg, mix, serve_paged.program_params(
        cfg, 5, "cpu"), torch.device("cpu"))
    pool = sched.pool
    tables = PagedKVCache(pool, "cpu").tables(0.86).ctx["s0_global"]
    rng = np.random.RandomState(0)
    pages = rng.permutation(pool.num_pages)[:mix.max_len // mix.page_slots]
    place = serve_paged.placement(cfg, mix, {"page_ids": pages})
    t = mix.max_len
    kv = torch.randn((t, 1, 8), generator=torch.Generator().manual_seed(1)
                     ).to(torch.bfloat16)
    first = F.bump_placement(RD.pool_leaves(cfg, place.total_pages,
                                            place.page_slots), place.pcs)
    thr = F.FaultMap(place.map_seed).thresholds(0.86)
    changed = 0
    for layer in range(cfg["num_hidden_layers"]):
        got, _ = RD._read_back(kv, "k", layer, place, first, thr,
                               place.map_seed)
        for lp, pid in enumerate(pages):
            rows = slice(lp * mix.page_slots, (lp + 1) * mix.page_slots)
            tile = kv[rows].reshape(mix.page_slots, -1)
            thr_row = tables.k.thr[layer][pid]
            want = faulty.corrupt_page_tile(
                tile, tables.k.base[layer][pid],
                tuple(thr_row[c] for c in range(fm.NUM_THR_COLS)),
                seed=place.map_seed, method="word", words_per_row_log2=8,
                ecc=True)
            assert torch.equal(got[rows].reshape(tile.shape).view(
                torch.int16), want.view(torch.int16))
        changed += int((got.view(torch.int16) != kv.view(torch.int16))
                       .sum())
    assert changed > 0

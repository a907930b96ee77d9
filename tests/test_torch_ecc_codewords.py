"""T2's uncorrectable codewords through both plain ECC paths.

``chip_smoke.py``'s training cell T2 (full-width llama3.2-3b cut to 8
layers, its parameters on 7 TPU_V5E PCs at 0.94 V with ECC) counts 0-2
uncorrectable codewords per step on an H100 where a reckoning from the
fault map's thresholds gave 0.16 per pass.  Its log names every codeword
K2 flagged in the 12 steps (NVIDIA H100 80GB HBM3, 700.00 W): the word id,
the PC, the stored words and K2's output.  Here those words, at those
addresses and that voltage, go through the port's plain ECC path
(``kernels/ecc/ecc.py::arena_ecc_events``) and the reference's
(``repro/kernels/ecc/ecc.py::arena_ecc_events`` over
``kernels/ecc/ref.py::ecc_codeword_events``, plain jnp, not Pallas), each
on its own fault map: both flag each codeword uncorrectable and give K2's
output words.  The same two physical codewords recur across steps: one
holds a stuck data cell and a parity fault, the other two stuck data
cells, and each flags whenever the stored bits expose two faults.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.faultmap import PAPER_MAP_SEED as JSEED
from repro.core.hbm import TPU_V5E as JTPU_V5E
from repro.kernels.bitflip import ref as jbref
from repro.kernels.ecc import ecc as jecc
from repro.kernels.ecc import ref as jref
from repro.training.undervolt import _fault_map as jfault_map

from repro_torch.core import faultmap as fm
from repro_torch.core import hashing as H
from repro_torch.core.faultmap import PAPER_MAP_SEED
from repro_torch.core.hbm import TPU_V5E
from repro_torch.kernels.ecc import ecc
from repro_torch.training.undervolt import _fault_map

V_TRAIN_ECC = 0.94
# (step, word id of the codeword's first word, PC, stored words, K2's
# output words): every codeword K2 flagged in the 12 steps of T2's cell
FLAGGED = [
    (0, 2440530662, 18, (991148873, 3129620911), (991148873, 3121232303)),
    (1, 2527135260, 18, (994490993, 3137714923), (960936561, 3137845995)),
    (4, 2440530662, 18, (991345466, 3119528421), (991345466, 3111139813)),
    (7, 2440530662, 18, (990952244, 3101309477), (990952244, 3092920869)),
    (8, 2440530662, 18, (990755633, 3065526839), (990755633, 3057138231)),
    (10, 2440530662, 18, (991148855, 3098032674), (991148855, 3089644066)),
    (10, 2527135260, 18, (973322888, 3140532978), (939768456, 3140664050)),
    (11, 2440530662, 18, (991279929, 3096984089), (991279929, 3088595481)),
]
# The threshold row K2 ran on these blocks (logged beside them)
THR_ROW = (535348, 3130, 442437, 2587, 214748364, 4, 0, 3, 0, 244446, 1429)


def _maps():
    tmap = _fault_map(TPU_V5E, PAPER_MAP_SEED)
    jmap = jfault_map(JTPU_V5E, JSEED)
    assert tmap.seed == jmap.seed
    return tmap, jmap


def test_threshold_rows_equal_the_logged_row():
    tmap, jmap = _maps()
    got = tmap.threshold_table(V_TRAIN_ECC).numpy().view(np.uint32)[18]
    want = np.asarray(jmap.threshold_table(jnp.float32(V_TRAIN_ECC)))[18]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(THR_ROW, np.uint32))


@pytest.mark.parametrize("step,word_id,pc,stored,k2_out", FLAGGED)
def test_flagged_codeword_plain_paths_agree(step, word_id, pc, stored,
                                            k2_out):
    """Port plain == reference plain == K2 on the card: uncorrectable,
    with K2's output words."""
    tmap, jmap = _maps()
    wid = np.array([[word_id, word_id + 1]], np.uint64)
    data = np.array([stored], np.uint64)
    trow = tmap.threshold_table(V_TRAIN_ECC)[pc]
    got_out, got_c, got_u = ecc.arena_ecc_events(
        torch.from_numpy(data.astype(np.int64)),
        torch.from_numpy(wid.astype(np.int64)),
        tuple(H.as_u64(trow[c]) for c in range(fm.NUM_THR_COLS)),
        seed=tmap.seed, words_per_row_log2=tmap.words_per_row_log2)
    jrow = jnp.asarray(np.asarray(jmap.threshold_table(
        jnp.float32(V_TRAIN_ECC)))[pc])
    want_out, want_c, want_u = jecc.arena_ecc_events(
        jnp.asarray(data.astype(np.uint32)), jnp.asarray(wid.astype(np.uint32)),
        jrow, seed=jmap.seed, words_per_row_log2=jmap.words_per_row_log2)
    assert bool(got_u[0, 0]) and bool(np.asarray(want_u)[0, 0])
    assert not bool(got_c[0, 0]) and not bool(np.asarray(want_c)[0, 0])
    np.testing.assert_array_equal(
        got_out.numpy().astype(np.uint32)[0], np.asarray(want_out)[0])
    np.testing.assert_array_equal(got_out.numpy().astype(np.uint32)[0],
                                  np.asarray(k2_out, np.uint32))


@pytest.mark.parametrize("word_id,data_cells,parity",
                         [(2440530662, 1, True), (2527135260, 2, False)])
def test_flagged_codewords_fault_makeup(word_id, data_cells, parity):
    """What makes each recurring codeword uncorrectable (the reference's
    masks and parity draw): stuck data cells in its two words, and
    whether its parity draw hits."""
    _, jmap = _maps()
    row = np.asarray(jmap.threshold_table(jnp.float32(V_TRAIN_ECC)))[18]
    wid = jnp.asarray(np.array([word_id, word_id + 1], np.uint32))
    cols = dict(q01_weak=0, q01_strong=1, q10_weak=2, q10_strong=3,
                weak_row_q=4)
    m01, m10 = jbref.word_masks(
        wid, jmap.seed, **{k: np.uint32(row[c]) for k, c in cols.items()},
        words_per_row_log2=jmap.words_per_row_log2)
    stuck = np.asarray(m01) | (np.asarray(m10) & ~np.asarray(m01))
    assert sum(bin(int(w)).count("1") for w in stuck) == data_cells
    weak = jref._weak_rows(wid[:1], jmap.seed, np.uint32(row[4]),
                           jmap.words_per_row_log2)
    q = np.where(np.asarray(weak), row[9], row[10])
    hit = np.asarray(jref.H.hash_stream(
        jmap.seed, jref.STREAM_PARITY, wid[:1] >> np.uint32(1))) < q
    assert bool(hit[0]) == parity

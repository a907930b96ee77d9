"""Online fault-map posterior: fold ECC telemetry into row beliefs (port
of :mod:`repro.core.faultmap_posterior`).

Per (pseudo-channel, DRAM row), the posterior probability that the row
behaves *weak* at the current operating point, updated from the SECDED
correction counts the serving scrub exports every step.

Model (two row classes, not per-cell):

  * prior: the static :class:`~repro_torch.core.faultmap.FaultMap` draw.
    A row the map marks weak starts near-certainly weak; a strong row
    carries a small "turned weak at runtime" prior.
  * likelihood: reading ``n`` SECDED(72,64) codewords of a row at voltage
    ``v`` yields ``c`` corrected events, ~Binomial(n, p_class(v)); each
    observation adds a binomial log-likelihood ratio (float32, as the
    reference's jnp) to the row's evidence (float64).

The reference keeps one Python object per tracked row and folds one
``observe`` call per (page, row).  At full width a page spans ~900 DRAM
rows, so the port keeps the beliefs in sorted numpy arrays keyed by
``pc * rows_per_pc + row`` and folds a whole step's observations in one
pass (:meth:`FaultMapPosterior.observe_many`), in the order given, with
the same float64 sums as the per-call loop (``np.add.at`` applies
repeated keys in order).  :meth:`FaultMapPosterior.observe` is that fold
on one observation.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.faultmap import FaultMap

# Floor rates so log-ratios stay finite in the guardband (both hypotheses
# predict ~zero corrections there -> LLR ~0).
_RATE_FLOOR = 1e-12
# A codeword correction needs >= 1 hit among 64 data + 8 parity bits: the
# per-codeword probability is ~72 p for small per-bit rates p (capped well
# below 1 to keep the binomial well-posed).
_CW_BITS = 72.0
_P_CAP = 0.5

# Prior that a statically-strong row drifted weak at runtime (~8 corrected
# codewords of weak-rate evidence overturn it).
TURN_WEAK_PRIOR = 1e-3
# Statically-weak rows: near-certain, but invertible by contrary evidence.
STATIC_WEAK_PRIOR = 1.0 - 1e-4


def binomial_llr(corrected, codewords, p_weak, p_strong):
    """log P(c | weak) - log P(c | strong) for c ~ Binomial(n, p), in
    float32 (the binomial coefficient cancels); arrays broadcast.
    ``p_weak`` / ``p_strong`` are per-codeword correction probabilities,
    already floored and capped by the caller."""
    c = np.asarray(corrected, np.float32)
    n = np.asarray(codewords, np.float32)
    pw = np.asarray(p_weak, np.float32)
    ps = np.asarray(p_strong, np.float32)
    return (c * (np.log(pw) - np.log(ps))
            + (n - c) * (np.log1p(-pw) - np.log1p(-ps)))


class FaultMapPosterior:
    """Per-row weak-probability posterior over a static map prior.

    Sparse: only rows with observed telemetry are tracked.  Deterministic
    in (map, observation stream)."""

    def __init__(self, faultmap: FaultMap, *,
                 turn_weak_prior: float = TURN_WEAK_PRIOR,
                 static_weak_prior: float = STATIC_WEAK_PRIOR):
        self.faultmap = faultmap
        self.turn_weak_prior = float(turn_weak_prior)
        self.static_weak_prior = float(static_weak_prior)
        self._rpp = int(faultmap.rows_per_pc)
        # tracked rows, sorted by key, with their accumulated beliefs
        self._keys = np.zeros((0,), np.int64)
        self._llr = np.zeros((0,), np.float64)
        self._corrected = np.zeros((0,), np.int64)
        self._uncorrectable = np.zeros((0,), np.int64)
        self._codewords = np.zeros((0,), np.int64)
        self._weak = np.zeros((0,), bool)   # the static map's class
        self.total_corrected = 0
        self.total_uncorrectable = 0
        self._rates: Dict[float, Tuple[np.ndarray, np.ndarray]] = {}
        self._probs: Dict[float, Tuple[np.ndarray, np.ndarray]] = {}

    # ---- priors -----------------------------------------------------------
    def _static_weak(self, keys: np.ndarray) -> np.ndarray:
        pcs, rows = np.divmod(keys, self._rpp)
        out = np.zeros(keys.shape, bool)
        for pc in np.unique(pcs):
            sel = pcs == pc
            out[sel] = self.faultmap.weak_row_mask(int(pc))[rows[sel]]
        return out

    def _prior(self, weak) -> np.ndarray:
        return np.where(weak, self.static_weak_prior, self.turn_weak_prior)

    def _row_rates(self, voltage: float) -> Tuple[np.ndarray, np.ndarray]:
        """The map's per-PC (weak-row, strong-row) rates, memoized per
        voltage (the scheduler asks every step)."""
        v = float(voltage)
        got = self._rates.get(v)
        if got is None:
            got = self._rates[v] = self.faultmap.row_rates(v)
        return got

    def _cw_probs(self, voltage: float) -> Tuple[np.ndarray, np.ndarray]:
        """Per-PC per-codeword correction probability under (weak,
        strong), memoized per voltage."""
        v = float(voltage)
        got = self._probs.get(v)
        if got is None:
            got = tuple(np.minimum(_P_CAP, np.maximum(
                _RATE_FLOOR, _CW_BITS * r.astype(np.float64)))
                for r in self._row_rates(v))
            self._probs[v] = got
        return got

    # ---- updates ----------------------------------------------------------
    def observe(self, pc: int, row: int, *, corrected: int, codewords: int,
                voltage: float, uncorrectable: int = 0) -> None:
        """Fold one step's counters for one row into its belief.

        ``codewords``: SECDED codewords of this row the read path touched
        this step; ``corrected``: how many reported a single-fault
        correction.  Uncorrectable events count as corrections for the
        likelihood (a multi-fault codeword implies at least the weak
        regime) and are also tallied separately."""
        self.observe_many([pc], [row], [corrected], [uncorrectable],
                          [codewords], voltage)

    def observe_many(self, pcs, rows, corrected, uncorrectable, codewords,
                     voltage: float) -> None:
        """Fold a batch of observations, in order: the beliefs equal those
        of one :meth:`observe` call per entry in the same order."""
        pcs = np.asarray(pcs, np.int64).reshape(-1)
        rows = np.asarray(rows, np.int64).reshape(-1)
        corr = np.asarray(corrected, np.int64).reshape(-1)
        bad = np.asarray(uncorrectable, np.int64).reshape(-1)
        cw = np.broadcast_to(np.asarray(codewords, np.int64),
                             pcs.shape).reshape(-1)
        keep = cw > 0
        if not keep.all():
            pcs, rows, corr, bad, cw = (a[keep] for a in
                                        (pcs, rows, corr, bad, cw))
        if not pcs.size:
            return
        keys = pcs * self._rpp + rows
        new = np.setdiff1d(keys, self._keys)
        if new.size:
            self._insert(new)
        idx = np.searchsorted(self._keys, keys)
        pw, ps = self._cw_probs(voltage)
        hits = np.minimum(corr + bad, cw)
        llr = binomial_llr(hits, cw, pw[pcs], ps[pcs]).astype(np.float64)
        np.add.at(self._llr, idx, llr)
        np.add.at(self._corrected, idx, corr)
        np.add.at(self._uncorrectable, idx, bad)
        np.add.at(self._codewords, idx, cw)
        self.total_corrected += int(corr.sum())
        self.total_uncorrectable += int(bad.sum())

    def _insert(self, new: np.ndarray) -> None:
        keys = np.concatenate([self._keys, new])
        order = np.argsort(keys, kind="stable")
        n_new = new.shape[0]

        def grow(arr, fill):
            return np.concatenate(
                [arr, np.full(n_new, fill, arr.dtype)])[order]

        self._keys = keys[order]
        self._llr = grow(self._llr, 0.0)
        self._corrected = grow(self._corrected, 0)
        self._uncorrectable = grow(self._uncorrectable, 0)
        self._codewords = grow(self._codewords, 0)
        self._weak = np.concatenate(
            [self._weak, self._static_weak(new)])[order]

    # ---- queries ----------------------------------------------------------
    def _p_weak_all(self) -> np.ndarray:
        """p_weak of every tracked row (the stable sigmoid, vectorised)."""
        p = self._prior(self._weak)
        logodds = np.log(p / (1.0 - p)) + self._llr
        e = np.exp(-np.abs(logodds))
        return np.where(logodds >= 0, 1.0 / (1.0 + e), e / (1.0 + e))

    def p_weak(self, pc: int, row: int) -> float:
        key = int(pc) * self._rpp + int(row)
        i = int(np.searchsorted(self._keys, key))
        tracked = i < self._keys.shape[0] and self._keys[i] == key
        p = (self.static_weak_prior
             if bool(self.faultmap.weak_row_mask(int(pc))[int(row)])
             else self.turn_weak_prior)
        logodds = math.log(p / (1.0 - p)) + (
            float(self._llr[i]) if tracked else 0.0)
        if logodds >= 0:
            return 1.0 / (1.0 + math.exp(-logodds))
        e = math.exp(logodds)
        return e / (1.0 + e)

    def suspect_rows(self, setpoint: float,
                     threshold: float = 0.9) -> List[Tuple[int, int]]:
        """Observed rows believed weak where weakness *matters* at
        ``setpoint``: none in the guardband (or wherever weak and strong
        rates coincide); else those with p_weak >= ``threshold``, sorted."""
        pcs, rows = np.divmod(self.suspect_keys(setpoint, threshold),
                              self._rpp)
        return [(int(a), int(b)) for a, b in zip(pcs, rows)]

    def suspect_keys(self, setpoint: float,
                     threshold: float = 0.9) -> np.ndarray:
        """:meth:`suspect_rows` as sorted ``pc * rows_per_pc + row``
        keys."""
        weak_r, strong_r = self._row_rates(setpoint)
        matters = (weak_r > strong_r + _RATE_FLOOR)[self._keys // self._rpp]
        return self._keys[matters & (self._p_weak_all() >= threshold)]

    def predicted_rates(self, v: float) -> np.ndarray:
        """Per-PC expected stuck-cell rate under the posterior: the prior
        blend plus, for each tracked row, the shift between its posterior
        and prior weak probability weighted by its 1/rows_per_pc share --
        what the adaptive governor re-plans from."""
        base = self.faultmap.pc_total_rate(float(v)).astype(np.float64)
        weak_r, strong_r = self._row_rates(v)
        pcs = self._keys // self._rpp
        delta = self._p_weak_all() - self._prior(self._weak)
        np.add.at(base, pcs,
                  delta * (weak_r[pcs] - strong_r[pcs]) / float(self._rpp))
        return np.clip(base, 0.0, 1.0)

    # ---- reporting --------------------------------------------------------
    @property
    def tracked_rows(self) -> Tuple[Tuple[int, int], ...]:
        pcs, rows = np.divmod(self._keys, self._rpp)
        return tuple((int(a), int(b)) for a, b in zip(pcs, rows))

    def stats(self) -> Dict[str, int]:
        return {
            "tracked_rows": int(self._keys.shape[0]),
            "corrected": int(self.total_corrected),
            "uncorrectable": int(self.total_uncorrectable),
        }

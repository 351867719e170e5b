"""NumPy float64 oracle for the banded pair-HMM forward-backward.

This is the *specification* implementation: exact log-sum-exp arithmetic,
cell-by-cell, matching the reference DP semantics
(/root/reference/impl/pairwiseAligner.c diagonalCalculation* +
impl/stateMachine.c stateMachine3_cellCalculate). It exists to

* pin down the algorithm for the device kernels (tests compare against it), and
* serve as a readable description of the recurrences.

It is O(cells * paths^2) Python and is only run on small problems in tests.

DP semantics summary (3-state HMM over states [match, gapX, gapY]):

* matrix coordinates: x in 0..lX indexes reference k-mers (cell x uses k-mer
  x-1; x=0 is the null boundary), y in 0..lY indexes events (cell y uses
  event y-1).
* transitions INTO a cell (x, y):
    - from (x-1, y-1) ("middle"): into match;   emission = match(kmer, event)
    - from (x-1, y)   ("lower"):  into gapX;    emission = gapX(kmer) = log 0.1
    - from (x,   y-1) ("upper"):  into gapY;    emission = gapY(kmer, event)
  with transition log-probs from the model's 3x3 table; gapX<->gapY switching
  disabled (log-zero), i.e. 7 live transitions.
* ambiguous reference positions expand into multiple "path" k-mers per cell
  (hdCell_construct2); a transition between paths of adjacent cells is legal
  iff from_kmer[1:] == to_kmer[:-1]; stay (upper) transitions require the
  identical path k-mer.
* start/end distributions (stateMachine.c:1134-1174): non-ragged start puts
  mass on match only; ragged start on gapX/gapY. Non-ragged end weighs state
  s by its transition-to-match prob; ragged end by gap-extend probs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from signalalign_jax.models.pore_model import (GAP_X, GAP_Y, LOG_ZERO, MATCH,
                                               PoreModel, ScalingParams,
                                               T_MM, T_MX, T_MY, T_XM, T_XX,
                                               T_YM, T_YY)
from signalalign_jax.ops.band_geometry import build_band
from signalalign_jax.utils.alphabet import expand_kmer_paths

LOG_GAPX_EMISSION = math.log(0.1)  # stateMachine3_construct (stateMachine.c:1586)
PAIR_ALIGNMENT_PROB_1 = 10000000  # inc/pairwiseAligner.h:27


def log_add(x: float, y: float) -> float:
    if x == LOG_ZERO:
        return y
    if y == LOG_ZERO:
        return x
    m = max(x, y)
    return m + math.log1p(math.exp(min(x, y) - m))


def _log_gauss(x, mu, sigma):
    if sigma == 0.0:
        return LOG_ZERO
    a = (x - mu) / sigma
    return -0.91893853320467267 - math.log(sigma) - 0.5 * a * a


def _log_inv_gauss(x, mu, lam):
    if x <= 0.0:
        x = 1e-9
    return (math.log(lam) - 1.8378770664093453 - 3.0 * math.log(x)
            - lam * ((x - mu) / mu) ** 2 / x) / 2.0


class Emissions:
    """Scalar emission evaluator over k-mer indices.

    Modes mirror the reference emission functions (stateMachine.c):
      * "mean_only":     strawMan...WithDescaling_MeanOnly (557) — the
                         production signalMachine path (buildStateMachine2)
      * "full_descaled": strawMan...WithDescaling (607)
      * "full":          strawMan...  (no descaling; C unit tests)
      * "hdp":           emissions_signal_getHdpKmerDensity (527)
    """

    def __init__(self, model: PoreModel, params: Optional[ScalingParams] = None,
                 mode: str = "mean_only", hdp=None, scale_noise: bool = False):
        self.model = model
        self.params = params or ScalingParams()
        self.mode = mode
        self.hdp = hdp
        if scale_noise:
            self.noise_mean, self.noise_sd, self.noise_lambda = model.scaled_noise_tables(self.params)
        else:
            self.noise_mean = model.noise_mean
            self.noise_sd = model.noise_sd
            self.noise_lambda = model.noise_lambda

    def match_logp(self, kmer_idx: Optional[int], event_mean: float,
                   event_sd: float, stay: bool = False) -> float:
        if kmer_idx is None:
            return LOG_ZERO
        m = self.model
        p = self.params
        mu = m.level_mean[kmer_idx]
        sd = (m.gap_y_level_sd if stay else m.level_sd)[kmer_idx]
        if self.mode == "mean_only":
            x = (event_mean + p.var * mu - p.scale * mu - p.shift) / p.var
            return math.log(1.0 / p.var) + _log_gauss(x, mu, sd)
        if self.mode == "full_descaled":
            x = (event_mean + p.var * mu - p.scale * mu - p.shift) / p.var
            noise = event_sd if event_sd != 0 else 1e-9
            return (_log_gauss(x, mu, sd)
                    + _log_inv_gauss(noise, self.noise_mean[kmer_idx], self.noise_lambda[kmer_idx]))
        if self.mode == "full":
            return (_log_gauss(event_mean, mu, sd)
                    + _log_inv_gauss(event_sd, self.noise_mean[kmer_idx], self.noise_lambda[kmer_idx]))
        if self.mode == "hdp":
            x = (event_mean + p.var * mu - p.scale * mu - p.shift) / p.var
            density = self.hdp.kmer_density(kmer_idx, x) / p.var
            return math.log(density) if density > 0 else LOG_ZERO
        raise ValueError(self.mode)

    def gapx_logp(self, kmer_idx: Optional[int]) -> float:
        return LOG_ZERO if kmer_idx is None else LOG_GAPX_EMISSION


@dataclasses.dataclass
class CellPaths:
    """Path k-mers for every reference position (cell x uses entry x-1)."""
    kmers: List[List[Optional[str]]]          # per position: list of path kmer strings
    indices: List[List[Optional[int]]]        # per position: kmer ranks

    @classmethod
    def from_sequence(cls, seq: str, model: PoreModel, ambig_map) -> "CellPaths":
        k = model.kmer_length
        lX = len(seq) - k + 1
        kmers, indices = [], []
        for i in range(lX):
            window = seq[i:i + k]
            paths = expand_kmer_paths(window, ambig_map)
            kmers.append(paths)
            indices.append([model.alphabet.kmer_index(p) for p in paths])
        return cls(kmers, indices)

    def at(self, x: int):
        """Paths of cell x (1-based). x == 0 -> single null path."""
        if x == 0:
            return [None], [None]
        return self.kmers[x - 1], self.indices[x - 1]


def _legal(from_kmer: Optional[str], to_kmer: Optional[str]) -> bool:
    # path_checkLegal (pairwiseAligner.c:610-621)
    if from_kmer is None or to_kmer is None:
        return True
    return from_kmer[1:] == to_kmer[:-1]


def start_state_logs(model: PoreModel, ragged: bool) -> np.ndarray:
    out = np.full(3, LOG_ZERO)
    if ragged:
        out[GAP_X] = 0.0
        out[GAP_Y] = 0.0
    else:
        out[MATCH] = 0.0
    return out


def end_state_logs(model: PoreModel, ragged: bool) -> np.ndarray:
    t = model.log_transitions
    out = np.empty(3)
    if ragged:
        out[MATCH] = (t[T_MX] + t[T_MY]) / 2.0
        out[GAP_X] = t[T_XX]
        out[GAP_Y] = t[T_YY]
    else:
        out[MATCH] = t[T_MM]
        out[GAP_X] = t[T_XM]
        out[GAP_Y] = t[T_YM]
    return out


class BandedMatrix:
    """Sparse banded DP values keyed by (xay, xmy) -> (n_paths, 3) arrays."""

    def __init__(self, xmyL: np.ndarray, xmyR: np.ndarray):
        self.xmyL = xmyL
        self.xmyR = xmyR
        self.cells: Dict[Tuple[int, int], np.ndarray] = {}

    def in_band(self, xay: int, xmy: int) -> bool:
        if xay < 0 or xay >= len(self.xmyL):
            return False
        return self.xmyL[xay] <= xmy <= self.xmyR[xay] and (xay + xmy) % 2 == 0

    def get(self, xay: int, xmy: int) -> Optional[np.ndarray]:
        return self.cells.get((xay, xmy))

    def band_range(self, xay: int):
        return range(int(self.xmyL[xay]), int(self.xmyR[xay]) + 1, 2)


def banded_forward_backward(
    seq_paths: CellPaths,
    events: np.ndarray,           # (lY, >=2): mean, stdv[, ...]
    model: PoreModel,
    emissions: Emissions,
    anchor_pairs: Sequence[Tuple[int, int]] = (),
    expansion: int = 20,
    ragged_start: bool = True,
    ragged_end: bool = True,
    threshold: float = 0.01,
    compute_expectations: bool = False,
    assignment_threshold: float = 0.1,
):
    """Run the full banded forward-backward; return posterior aligned pairs.

    Returns dict with keys:
      total_log_prob_f / total_log_prob_b : forward/backward total log probs
      aligned_pairs : list of (prob_int, x, y, path_kmer) as in
                      diagonalCalculationPosteriorMatchProbs
      transition_expectations : (3,3) array (if compute_expectations)
      likelihood : total_log_prob * n_diagonals (reference hack, see
                   diagonalCalculation_Expectations pairwiseAligner.c:1433)
      assignments : list of (path_kmer, event_mean, posterior) for HDP training
    """
    lX = len(seq_paths.kmers)
    lY = len(events)
    t = model.log_transitions
    D = lX + lY

    xmyL, xmyR = build_band(anchor_pairs, lX, lY, expansion)
    F = BandedMatrix(xmyL, xmyR)
    B = BandedMatrix(xmyL, xmyR)

    def n_paths(x: int) -> int:
        return 1 if x == 0 else len(seq_paths.kmers[x - 1])

    # --- initialise
    start = start_state_logs(model, ragged_start)
    end = end_state_logs(model, ragged_end)
    for xmy in F.band_range(0):
        x = (0 + xmy) // 2
        F.cells[(0, xmy)] = np.tile(start, (n_paths(x), 1))
    for xmy in B.band_range(D):
        x = (D + xmy) // 2
        B.cells[(D, xmy)] = np.tile(end, (n_paths(x), 1))

    def cell_inputs(xay: int, xmy: int):
        x = (xay + xmy) // 2
        y = (xay - xmy) // 2
        kmers, kidx = seq_paths.at(x)
        ev_mean = events[y - 1, 0] if y >= 1 else 0.0
        ev_sd = events[y - 1, 1] if y >= 1 else 0.0
        return x, y, kmers, kidx, ev_mean, ev_sd

    def transitions_into(xay: int, xmy: int, matrix_lower: BandedMatrix,
                         visit):
        """Enumerate the 7 transitions into cell (xay, xmy).

        ``visit(from_cell_key, from_path, from_state, to_path, to_state,
        eP, tP)`` is called for each legal (from, to) pair; from-cells are
        looked up in ``matrix_lower`` (diagonals xay-1 / xay-2).
        """
        x, y, kmers, kidx, ev_mean, ev_sd = cell_inputs(xay, xmy)
        # lower: (x-1, y) -> gapX
        lo = (xay - 1, xmy - 1)
        if matrix_lower.in_band(*lo):
            fk, _ = seq_paths.at(x - 1)
            for p, pk in enumerate(kmers):
                eP = emissions.gapx_logp(kidx[p])
                for q, qk in enumerate(fk):
                    if _legal(qk, pk):
                        visit(lo, q, MATCH, p, GAP_X, eP, t[T_MX])
                        visit(lo, q, GAP_X, p, GAP_X, eP, t[T_XX])
        # middle: (x-1, y-1) -> match
        mid = (xay - 2, xmy)
        if matrix_lower.in_band(*mid):
            fk, _ = seq_paths.at(x - 1)
            for p, pk in enumerate(kmers):
                eP = emissions.match_logp(kidx[p], ev_mean, ev_sd, stay=False)
                for q, qk in enumerate(fk):
                    if _legal(qk, pk):
                        visit(mid, q, MATCH, p, MATCH, eP, t[T_MM])
                        visit(mid, q, GAP_X, p, MATCH, eP, t[T_XM])
                        visit(mid, q, GAP_Y, p, MATCH, eP, t[T_YM])
        # upper: (x, y-1) -> gapY (same path k-mer)
        up = (xay - 1, xmy + 1)
        if matrix_lower.in_band(*up):
            for p, pk in enumerate(kmers):
                eP = emissions.match_logp(kidx[p], ev_mean, ev_sd, stay=True)
                visit(up, p, MATCH, p, GAP_Y, eP, t[T_MY])
                visit(up, p, GAP_Y, p, GAP_Y, eP, t[T_YY])

    # --- forward sweep
    for xay in range(1, D + 1):
        for xmy in F.band_range(xay):
            x = (xay + xmy) // 2
            cur = np.full((n_paths(x), 3), LOG_ZERO)

            def fwd_visit(fkey, q, s_from, p, s_to, eP, tP):
                fcell = F.get(*fkey)
                if fcell is not None and tP != LOG_ZERO:
                    cur[p, s_to] = log_add(cur[p, s_to], fcell[q, s_from] + eP + tP)

            transitions_into(xay, xmy, F, fwd_visit)
            F.cells[(xay, xmy)] = cur

    # --- forward total prob at final diagonal
    total_f = LOG_ZERO
    for xmy in F.band_range(D):
        cell = F.get(D, xmy)
        if cell is not None:
            for p in range(cell.shape[0]):
                for s in range(3):
                    total_f = log_add(total_f, cell[p, s] + end[s])

    # --- backward sweep: process diagonals descending; accumulate into
    # earlier diagonals (doTransitionBackward semantics).
    for xay in range(1, D + 1):
        for xmy in B.band_range(xay):
            x = (xay + xmy) // 2
            if (xay, xmy) not in B.cells:
                B.cells[(xay, xmy)] = np.full((n_paths(x), 3), LOG_ZERO)
    for xay in range(D, 0, -1):
        for xmy in B.band_range(xay):
            bcur = B.get(xay, xmy)

            def bwd_visit(fkey, q, s_from, p, s_to, eP, tP):
                if not B.in_band(*fkey) or tP == LOG_ZERO:
                    return
                fcell = B.cells.get(fkey)
                if fcell is None:
                    x_f = (fkey[0] + fkey[1]) // 2
                    fcell = np.full((n_paths(x_f), 3), LOG_ZERO)
                    B.cells[fkey] = fcell
                fcell[q, s_from] = log_add(fcell[q, s_from], bcur[p, s_to] + eP + tP)

            transitions_into(xay, xmy, B, bwd_visit)

    start_vec = start_state_logs(model, ragged_start)
    total_b = LOG_ZERO
    cell0 = B.get(0, 0)
    if cell0 is not None:
        for p in range(cell0.shape[0]):
            for s in range(3):
                total_b = log_add(total_b, cell0[p, s] + start_vec[s])

    # --- posterior aligned pairs
    aligned = []
    for xay in range(1, D + 1):
        for xmy in F.band_range(xay):
            x = (xay + xmy) // 2
            y = (xay - xmy) // 2
            if x <= 0 or y <= 0:
                continue
            fcell, bcell = F.get(xay, xmy), B.get(xay, xmy)
            if fcell is None or bcell is None:
                continue
            kmers, _ = seq_paths.at(x)
            for p, pk in enumerate(kmers):
                post = math.exp(fcell[p, MATCH] + bcell[p, MATCH] - total_f)
                if post >= threshold:
                    post = min(post, 1.0)
                    aligned.append((int(post * PAIR_ALIGNMENT_PROB_1), x - 1, y - 1, pk))

    out = {
        "total_log_prob_f": total_f,
        "total_log_prob_b": total_b,
        "aligned_pairs": aligned,
    }

    if compute_expectations:
        texp = np.zeros((3, 3))
        assignments = []
        for xay in range(1, D + 1):
            for xmy in B.band_range(xay):
                x, y, kmers, kidx, ev_mean, ev_sd = cell_inputs(xay, xmy)
                bcur = B.get(xay, xmy)
                if bcur is None:
                    continue

                def exp_visit(fkey, q, s_from, p, s_to, eP, tP):
                    fcell = F.get(*fkey)
                    if fcell is None or tP == LOG_ZERO:
                        return
                    pr = math.exp(fcell[q, s_from] + bcur[p, s_to] + eP + tP - total_f)
                    texp[s_from, s_to] += pr
                    if s_to == MATCH and pr >= assignment_threshold and kmers[p] is not None:
                        assignments.append((kmers[p], ev_mean, pr))

                transitions_into(xay, xmy, F, exp_visit)
        out["transition_expectations"] = texp
        out["likelihood"] = total_f * D
        out["assignments"] = assignments

    return out

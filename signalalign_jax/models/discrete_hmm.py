"""Discrete-symbol pair HMM: posterior alignment + Baum-Welch EM.

The reference carries a legacy discrete-emission HMM
(``impl/discreteHmm.c`` — almost entirely commented out upstream; the
surviving piece is the per-row transition normalization at
discreteHmm.c:125-137) and a symbol pair-HMM used by the multiple
aligner (``impl/multipleAligner.c:660`` calls getAlignedPairs on
sequence fragments). This module is a re-design of both: a
3-state (match / gapX / gapY) pair HMM over arbitrary discrete
alphabets, with

* dense log-space forward-backward (vectorized numpy — symbol MSA
  fragments are short host-side work, not device work, by design: see
  SURVEY §2.2 C13 "used only in C tests/HDP experiments");
* posterior aligned-pair extraction (plain [0, 1] float posteriors;
  ``PAIR_ALIGNMENT_PROB_1`` is exported for callers that want the
  pairwiseAligner.h integer-weight convention);
* transition + emission expectation accumulation and row normalization
  (hmmDiscrete_normalizeTransitions semantics), i.e. Baum-Welch EM.

State order matches the banded event DP: 0=match, 1=gapX, 2=gapY.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

PAIR_ALIGNMENT_PROB_1 = 10000000.0  # pairwiseAligner.h integer weight unit

NEG = -1e30


def _logsumexp(*xs):
    m = xs[0]
    for x in xs[1:]:
        m = np.maximum(m, x)
    s = sum(np.exp(x - m) for x in xs)
    return m + np.log(s)


class DiscreteHmm:
    """3-state discrete pair HMM over an ``alphabet``.

    transitions: (3, 3) row-stochastic. emissions[0]: (m, m) match
    emission joint table; emissions[1]/emissions[2]: (m,) gap emission
    distributions for X / Y symbols.
    """

    MATCH, GAPX, GAPY = 0, 1, 2

    def __init__(self, alphabet: str = "ACGT",
                 match_bias: float = 0.85,
                 gap_open: float = 0.05, gap_extend: float = 0.5):
        self.alphabet = alphabet
        m = len(alphabet)
        stay = 1.0 - 2.0 * gap_open
        self.transitions = np.array(
            [[stay, gap_open, gap_open],
             [1.0 - gap_extend, gap_extend, 0.0],
             [1.0 - gap_extend, 0.0, gap_extend]], dtype=np.float64)
        match = np.full((m, m), (1.0 - match_bias) / (m * m - m))
        np.fill_diagonal(match, match_bias / m)
        self.emissions = [match,
                          np.full(m, 1.0 / m), np.full(m, 1.0 / m)]

    # -- container ops (discreteHmm.c API surface) -----------------------
    def normalize(self) -> None:
        """Row-normalize transitions and emission tables
        (hmmDiscrete_normalizeTransitions, discreteHmm.c:125-137)."""
        t = self.transitions
        self.transitions = t / t.sum(axis=1, keepdims=True)
        e0 = self.emissions[0]
        self.emissions[0] = e0 / e0.sum()
        for s in (1, 2):
            self.emissions[s] = self.emissions[s] / self.emissions[s].sum()

    def randomize(self, rng=None) -> None:
        """Random re-init then normalize (hmmDiscrete_randomize)."""
        rng = rng or np.random.default_rng(0)
        m = len(self.alphabet)
        self.transitions = rng.random((3, 3))
        self.transitions[1, 2] = self.transitions[2, 1] = 0.0
        self.emissions = [rng.random((m, m)), rng.random(m), rng.random(m)]
        self.normalize()

    def digitize(self, seq: str) -> np.ndarray:
        lut = {c: i for i, c in enumerate(self.alphabet)}
        return np.array([lut[c] for c in seq.upper()], dtype=np.int64)

    # -- DP ---------------------------------------------------------------
    def _log_tables(self):
        with np.errstate(divide="ignore"):
            lt = np.where(self.transitions > 0,
                          np.log(np.maximum(self.transitions, 1e-300)), NEG)
            le0 = np.log(np.maximum(self.emissions[0], 1e-300))
            le1 = np.log(np.maximum(self.emissions[1], 1e-300))
            le2 = np.log(np.maximum(self.emissions[2], 1e-300))
        return lt, le0, le1, le2

    def forward(self, x: np.ndarray, y: np.ndarray):
        """Log forward lattice, shape (lx+1, ly+1, 3); x indexes rows."""
        lt, le0, le1, le2 = self._log_tables()
        lx, ly = len(x), len(y)
        F = np.full((lx + 1, ly + 1, 3), NEG)
        F[0, 0, :] = np.log(1.0 / 3.0)
        for i in range(lx + 1):
            for j in range(ly + 1):
                if i == 0 and j == 0:
                    continue
                acc = np.full(3, NEG)
                if i > 0 and j > 0:
                    prev = F[i - 1, j - 1]
                    acc[0] = _logsumexp(prev[0] + lt[0, 0],
                                        prev[1] + lt[1, 0],
                                        prev[2] + lt[2, 0]) \
                        + le0[x[i - 1], y[j - 1]]
                if i > 0:
                    prev = F[i - 1, j]
                    acc[1] = _logsumexp(prev[0] + lt[0, 1],
                                        prev[1] + lt[1, 1],
                                        prev[2] + lt[2, 1]) + le1[x[i - 1]]
                if j > 0:
                    prev = F[i, j - 1]
                    acc[2] = _logsumexp(prev[0] + lt[0, 2],
                                        prev[1] + lt[1, 2],
                                        prev[2] + lt[2, 2]) + le2[y[j - 1]]
                F[i, j] = acc
        return F

    def backward(self, x: np.ndarray, y: np.ndarray):
        lt, le0, le1, le2 = self._log_tables()
        lx, ly = len(x), len(y)
        B = np.full((lx + 1, ly + 1, 3), NEG)
        B[lx, ly, :] = 0.0
        for i in range(lx, -1, -1):
            for j in range(ly, -1, -1):
                if i == lx and j == ly:
                    continue
                terms = [np.full(3, NEG)]
                if i < lx and j < ly:
                    e = le0[x[i], y[j]] + B[i + 1, j + 1, 0]
                    terms.append(lt[:, 0] + e)
                if i < lx:
                    terms.append(lt[:, 1] + le1[x[i]] + B[i + 1, j, 1])
                if j < ly:
                    terms.append(lt[:, 2] + le2[y[j]] + B[i, j + 1, 2])
                B[i, j] = _logsumexp(*terms)
        return B

    def total_log_prob(self, F) -> float:
        return float(_logsumexp(F[-1, -1, 0], F[-1, -1, 1], F[-1, -1, 2]))

    def aligned_pairs(self, seq1: str, seq2: str,
                      threshold: float = 0.01
                      ) -> List[Tuple[float, int, int]]:
        """Posterior match probabilities per (i, j):
        [(posterior, i, j), ...] with posterior >= threshold — the
        symbol-space analogue of diagonalCalculationPosteriorMatchProbs
        (pairwiseAligner.c:1355)."""
        x, y = self.digitize(seq1), self.digitize(seq2)
        F, B = self.forward(x, y), self.backward(x, y)
        tot = self.total_log_prob(F)
        post = np.exp(F[1:, 1:, 0] + B[1:, 1:, 0] - tot)
        out = []
        ii, jj = np.nonzero(post >= threshold)
        for i, j in zip(ii.tolist(), jj.tolist()):
            out.append((min(float(post[i, j]), 1.0), i, j))
        return out

    # -- EM ----------------------------------------------------------------
    def expectations(self, seq1: str, seq2: str):
        """Posterior transition and emission expectation tables for one
        sequence pair (cell_calculateUpdateExpectation semantics in
        symbol space). Returns (texp (3,3), eexp [match (m,m), gapX (m,),
        gapY (m,)], log_likelihood)."""
        x, y = self.digitize(seq1), self.digitize(seq2)
        lt, le0, le1, le2 = self._log_tables()
        F, B = self.forward(x, y), self.backward(x, y)
        tot = self.total_log_prob(F)
        lx, ly = len(x), len(y)
        m = len(self.alphabet)
        texp = np.zeros((3, 3))
        e0 = np.zeros((m, m))
        e1 = np.zeros(m)
        e2 = np.zeros(m)
        for i in range(lx + 1):
            for j in range(ly + 1):
                # arrivals into each state at (i, j)
                if i > 0 and j > 0:
                    e = le0[x[i - 1], y[j - 1]]
                    p = np.exp(F[i - 1, j - 1] + lt[:, 0] + e
                               + B[i, j, 0] - tot)
                    texp[:, 0] += p
                    e0[x[i - 1], y[j - 1]] += p.sum()
                if i > 0:
                    e = le1[x[i - 1]]
                    p = np.exp(F[i - 1, j] + lt[:, 1] + e
                               + B[i, j, 1] - tot)
                    texp[:, 1] += p
                    e1[x[i - 1]] += p.sum()
                if j > 0:
                    e = le2[y[j - 1]]
                    p = np.exp(F[i, j - 1] + lt[:, 2] + e
                               + B[i, j, 2] - tot)
                    texp[:, 2] += p
                    e2[y[j - 1]] += p.sum()
        return texp, [e0, e1, e2], tot

    def em_step(self, pairs: Sequence[Tuple[str, str]],
                pseudocount: float = 1e-3) -> float:
        """One Baum-Welch round over sequence pairs; returns the summed
        log-likelihood under the PRE-update parameters."""
        texp = np.full((3, 3), pseudocount)
        texp[1, 2] = texp[2, 1] = 0.0
        m = len(self.alphabet)
        eexp = [np.full((m, m), pseudocount), np.full(m, pseudocount),
                np.full(m, pseudocount)]
        ll = 0.0
        for s1, s2 in pairs:
            t, e, tot = self.expectations(s1, s2)
            texp += t
            for k in range(3):
                eexp[k] += e[k]
            ll += tot
        self.transitions = texp
        self.emissions = eexp
        self.normalize()
        return ll

    # -- serialization ------------------------------------------------------
    def write(self, path: str) -> None:
        """3-line text format: header (alphabet), flat transitions, flat
        emissions (match table then gap tables)."""
        with open(path, "w") as fh:
            fh.write(f"3\t{self.alphabet}\n")
            fh.write("\t".join(f"{v:.12g}"
                               for v in self.transitions.reshape(-1)) + "\n")
            flat = np.concatenate([self.emissions[0].reshape(-1),
                                   self.emissions[1], self.emissions[2]])
            fh.write("\t".join(f"{v:.12g}" for v in flat) + "\n")

    @classmethod
    def load(cls, path: str) -> "DiscreteHmm":
        with open(path) as fh:
            header = fh.readline().split("\t")
            alphabet = header[1].strip()
            hmm = cls(alphabet)
            hmm.transitions = np.array(
                [float(v) for v in fh.readline().split("\t")]).reshape(3, 3)
            m = len(alphabet)
            flat = np.array([float(v) for v in fh.readline().split("\t")])
            hmm.emissions = [flat[:m * m].reshape(m, m),
                             flat[m * m:m * m + m], flat[m * m + m:]]
        return hmm

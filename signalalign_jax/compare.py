"""Model / HDP distribution comparison utilities.

reference parity:
  * per-kmer KL divergence / Hellinger distance / median delta between a
    model's HDP posterior predictive and its ONT Gaussian
    (hiddenMarkovModel.py:775-837 get_kl_divergence /
    get_hellinger_distance / get_median_delta / compare_distributions);
  * pairwise model-to-model comparison over the overlap kmer set with the
    shared-or-intersected linspace rule
    (visualization/compare_trained_models.py:622-729
    MultipleModelHandler.compare_distributions_between_models);
  * the sorted tab-separated distance logfile format
    (compare_trained_models.py:580-620);
  * compareDistributions-style per-kmer density dumps
    (impl/compareDistributions.c:26-76: x_vals.txt + <kmer>_distr.txt,
    one %.17g value per line).

Distances follow the reference's exact conventions: KL normalizes both
distributions to probability vectors and returns bits (scipy entropy
base=2 semantics; zero bins are floored at 1e-6 first, inf -> None);
Hellinger is the UNNORMALIZED euclidean(sqrt p, sqrt q)/sqrt(2) on the
raw pdf samples; median delta is the |argmax location| difference.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from signalalign_jax.models.hdp_model import NanoporeHDP
from signalalign_jax.models.pore_model import PoreModel

_SQRT2 = math.sqrt(2.0)


def kl_divergence(p: np.ndarray, q: np.ndarray) -> Optional[float]:
    """KL(p || q) in bits on normalized copies; zero bins floored at 1e-6
    (compare_trained_models.py:702-716)."""
    p = np.asarray(p, dtype=np.float64).copy()
    q = np.asarray(q, dtype=np.float64).copy()
    if p.min() == 0:
        p[p == 0] = 1e-6
    if q.min() == 0:
        q[q == 0] = 1e-6
    p = p / p.sum()
    q = q / q.sum()
    # log-difference form: p/q with 1e-6-floored bins can overflow f64
    # before the log; log2(p) - log2(q) cannot
    kl = float(np.sum(p * (np.log2(p) - np.log2(q))))
    if not np.isfinite(kl):
        return None
    return kl


def hellinger(p: np.ndarray, q: np.ndarray) -> float:
    """euclidean(sqrt p, sqrt q)/sqrt 2 on the raw pdf samples
    (hiddenMarkovModel.py:1119-1120 hellinger2)."""
    p = np.asarray(p, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    return float(np.linalg.norm(np.sqrt(p) - np.sqrt(q)) / _SQRT2)


def median_delta(p: np.ndarray, q: np.ndarray, x: np.ndarray) -> float:
    """|argmax-location difference| (compare_trained_models.py:723-729)."""
    return float(abs(x[int(np.argmax(p))] - x[int(np.argmax(q))]))


def gaussian_pdf(x: np.ndarray, mean: float, sd: float) -> np.ndarray:
    sd = max(float(sd), 1e-12)
    z = (np.asarray(x, dtype=np.float64) - mean) / sd
    return np.exp(-0.5 * z * z) / (sd * math.sqrt(2.0 * math.pi))


class ModelDistributions:
    """A pore model plus optional HDP: per-kmer pdf sampled on a linspace
    (the reference's HmmModel + nanopore HDP pair)."""

    def __init__(self, model: PoreModel, hdp: Optional[NanoporeHDP] = None,
                 name: Optional[str] = None):
        self.model = model
        self.hdp = hdp
        self.name = name or "model"

    @property
    def linspace(self) -> np.ndarray:
        if self.hdp is not None:
            return self.hdp.grid
        lo = float(self.model.level_mean.min() - 10.0)
        hi = float(self.model.level_mean.max() + 10.0)
        return np.linspace(lo, hi, 1200)

    def kmers(self) -> List[str]:
        alpha = (self.hdp.alphabet if self.hdp is not None
                 else self.model.alphabet)
        return [alpha.index_to_kmer(i) for i in range(alpha.num_kmers)]

    def gaussian_params(self, kmer: str) -> Tuple[float, float]:
        idx = self.model.alphabet.kmer_index(kmer)
        return (float(self.model.level_mean[idx]),
                float(self.model.level_sd[idx]))

    def hdp_distribution(self, kmer: str,
                         linspace: Optional[np.ndarray] = None
                         ) -> Optional[np.ndarray]:
        """HDP posterior predictive sampled on ``linspace`` (spline
        re-evaluation off-grid); None when no HDP or the kmer is outside
        the HDP alphabet."""
        if self.hdp is None:
            return None
        try:
            kid = self.hdp.alphabet.kmer_index(kmer)
        except (KeyError, ValueError):
            return None
        if linspace is None or (len(linspace) == len(self.hdp.grid)
                                and np.array_equal(linspace, self.hdp.grid)):
            return self.hdp.densities[kid].astype(np.float64)
        return np.array([self.hdp.kmer_density(kid, float(x))
                         for x in linspace])

    def distribution(self, kmer: str,
                     linspace: Optional[np.ndarray] = None,
                     prefer_hdp: bool = True) -> np.ndarray:
        if linspace is None:
            linspace = self.linspace
        if prefer_hdp:
            d = self.hdp_distribution(kmer, linspace)
            if d is not None and len(d) and d.max() > 0:
                return d
        mean, sd = self.gaussian_params(kmer)
        return gaussian_pdf(linspace, mean, sd)


def comparison_linspace(m1: ModelDistributions, m2: ModelDistributions,
                        hdp: bool = True) -> Tuple[np.ndarray, bool]:
    """The shared-or-intersected linspace rule
    (compare_trained_models.py:628-640). Returns (linspace, is_new)."""
    if hdp and m1.hdp is not None and m2.hdp is not None:
        if np.array_equal(m1.hdp.grid, m2.hdp.grid):
            return m1.hdp.grid, False
        lo = max(m1.hdp.grid[0], m2.hdp.grid[0])
        hi = min(m1.hdp.grid[-1], m2.hdp.grid[-1])
        return np.linspace(lo, hi, 3000), True
    if m1.hdp is not None:
        return m1.hdp.grid, False
    if m2.hdp is not None:
        return m2.hdp.grid, False
    return m1.linspace, False


def overlap_kmers(m1: ModelDistributions, m2: ModelDistributions
                  ) -> List[str]:
    """Kmers present in both models (compare_trained_models.py:664-673),
    in model-1 order."""
    s2 = set(m2.kmers())
    return [k for k in m1.kmers() if k in s2]


def compare_models(m1: ModelDistributions, m2: ModelDistributions,
                   hdp: bool = True):
    """Per-kmer (kmers, kl, hellinger, median_delta) between two models
    (compare_trained_models.py:622-662)."""
    linspace, _ = comparison_linspace(m1, m2, hdp)
    kmers = overlap_kmers(m1, m2)
    kls: List[Optional[float]] = []
    hels: List[float] = []
    deltas: List[float] = []
    for kmer in kmers:
        d1 = m1.distribution(kmer, linspace, prefer_hdp=hdp)
        d2 = m2.distribution(kmer, linspace, prefer_hdp=hdp)
        kls.append(kl_divergence(d1, d2))
        hels.append(hellinger(d1, d2))
        deltas.append(median_delta(d1, d2, linspace))
    return kmers, kls, hels, deltas


def compare_model_to_own_hdp(model: PoreModel, hdp: NanoporeHDP):
    """Per-kmer HDP-vs-ONT-Gaussian distances within ONE model — the
    HmmModel.compare_distributions suite (hiddenMarkovModel.py:775-837):
    (kmers, kl, hellinger, median_delta); kmers without HDP data skipped.
    """
    kmers, kls, hels, deltas = [], [], [], []
    md = ModelDistributions(model, hdp)
    for kid in range(hdp.alphabet.num_kmers):
        if not hdp.observed[kid] and hdp.densities[kid].max() <= 0:
            continue
        kmer = hdp.alphabet.index_to_kmer(kid)
        hdp_y = hdp.densities[kid].astype(np.float64)
        if hdp_y.max() <= 0:
            continue
        try:
            mean, sd = md.gaussian_params(kmer)
        except (KeyError, ValueError):
            continue
        ont = gaussian_pdf(hdp.grid, mean, sd)
        kmers.append(kmer)
        kls.append(kl_divergence(hdp_y, ont))
        hels.append(hellinger(hdp_y, ont))
        deltas.append(median_delta(hdp_y, ont, hdp.grid))
    return kmers, kls, hels, deltas


def write_comparison_tsv(path: str, kmers: Sequence[str],
                         kls: Sequence[Optional[float]],
                         hels: Sequence[float],
                         deltas: Sequence[float]) -> str:
    """The reference logfile: rows (kmer, kl, hellinger, delta) sorted by
    KL descending, None-KL rows last
    (write_kmer_distribution_comparison_logfile,
    compare_trained_models.py:580-607)."""
    rows = list(zip(kmers, kls, hels, deltas))
    good = sorted([r for r in rows if r[1] is not None],
                  key=lambda r: r[1], reverse=True)
    bad = [r for r in rows if r[1] is None]
    with open(path, "w") as fh:
        for k, d1, d2, d3 in good + bad:
            fh.write("\t".join([k, "" if d1 is None else repr(float(d1)),
                                repr(float(d2)), repr(float(d3))]) + "\n")
    return path


def read_comparison_tsv(path: str):
    """Inverse of :func:`write_comparison_tsv`
    (read_kmer_distribution_comparison_logfile)."""
    data = []
    with open(path) as fh:
        for line in fh:
            row = line.rstrip("\n").split("\t")
            if not row or not row[0]:
                continue
            data.append([row[0]] + [None if v == "" else float(v)
                                    for v in row[1:4]])
    return data


def dump_densities(hdp: NanoporeHDP, out_dir: str,
                   grid: Optional[np.ndarray] = None,
                   kmers: Optional[Iterable[str]] = None) -> List[str]:
    """compareDistributions-equivalent density dump: ``x_vals.txt`` plus
    one ``<kmer>_distr.txt`` per kmer, %.17g one value per line
    (impl/compareDistributions.c:26-76)."""
    os.makedirs(out_dir, exist_ok=True)
    if grid is None:
        grid = hdp.grid
    with open(os.path.join(out_dir, "x_vals.txt"), "w") as fh:
        fh.write("\n".join(f"{v:.17g}" for v in grid))
    written = []
    names = (list(kmers) if kmers is not None
             else [hdp.alphabet.index_to_kmer(i)
                   for i in range(hdp.alphabet.num_kmers)])
    for kmer in names:
        kid = hdp.alphabet.kmer_index(kmer)
        path = os.path.join(out_dir, f"{kmer}_distr.txt")
        with open(path, "w") as fh:
            fh.write("\n".join(
                f"{hdp.kmer_density(kid, float(x)):.17g}" for x in grid)
                + "\n")
        written.append(path)
    return written

"""Distribution-comparison suite (VERDICT r1 item 7): KL / Hellinger /
median-delta parity with the reference's conventions, logfile round-trip,
compareDistributions-style density dumps, and the compare CLI."""

import os

import numpy as np
import pytest

from signalalign_jax.compare import (ModelDistributions,
                                     compare_model_to_own_hdp,
                                     compare_models, dump_densities,
                                     gaussian_pdf, hellinger, kl_divergence,
                                     median_delta, read_comparison_tsv,
                                     write_comparison_tsv)
from signalalign_jax.models.pore_model import PoreModel

REF = "/root/reference"
NHDP = os.path.join(REF, "models/templateSingleLevelFixed.nhdp")
CPG6 = os.path.join(REF, "models/r9.4_450bps.cpg.6mer.template.model")


def _toy_model(shift=0.0, seed=0):
    m = PoreModel("ACGT", 3)
    K = m.alphabet.num_kmers
    rng = np.random.default_rng(seed)
    m.level_mean = np.linspace(70, 110, K) + shift
    m.level_sd = np.full(K, 1.5)
    m.noise_mean = np.full(K, 1.0)
    m.noise_sd = np.full(K, 0.2)
    m.noise_lambda = m.noise_mean ** 3 / m.noise_sd ** 2
    return m


def test_distance_primitives():
    x = np.linspace(60, 120, 600)
    p = gaussian_pdf(x, 90.0, 1.5)
    q = gaussian_pdf(x, 92.0, 1.5)
    # self-distances vanish
    assert kl_divergence(p, p) == pytest.approx(0.0, abs=1e-12)
    assert hellinger(p, p) == 0.0
    assert median_delta(p, p, x) == 0.0
    # closed forms: KL between equal-sd normals = delta^2/(2 sd^2) nats
    # -> bits; Hellinger^2 = 1 - exp(-delta^2/(8 sd^2)) for NORMALIZED
    # densities (the reference computes it on raw pdf samples, off by the
    # bin-width factor sqrt(dx))
    kl = kl_divergence(p, q)
    expect_bits = (2.0 ** 2 / (2 * 1.5 ** 2)) / np.log(2)
    assert kl == pytest.approx(expect_bits, rel=1e-3)
    dx = x[1] - x[0]
    h2 = 1 - np.exp(-(2.0 ** 2) / (8 * 1.5 ** 2))
    assert hellinger(p, q) == pytest.approx(np.sqrt(h2 / dx), rel=1e-3)
    assert median_delta(p, q, x) == pytest.approx(2.0, abs=2 * dx)
    # hand-computed KL on a tiny discrete case (reference entropy base=2
    # on normalized vectors with 1e-6 zero-flooring)
    a = np.array([0.5, 0.5, 0.0])
    b = np.array([0.25, 0.25, 0.5])
    pn = np.array([0.5, 0.5, 1e-6]) / (1.0 + 1e-6)
    kl_hand = float(np.sum(pn * np.log2(pn / b)))
    assert kl_divergence(a, b) == pytest.approx(kl_hand, rel=1e-9)


def test_compare_models_gaussian_only(tmp_path):
    m1 = ModelDistributions(_toy_model(0.0), name="a")
    m2 = ModelDistributions(_toy_model(2.0), name="b")
    kmers, kls, hels, deltas = compare_models(m1, m2)
    assert len(kmers) == 64
    assert all(k is not None and k > 0 for k in kls)
    # every kmer shifted by exactly +2 pA
    lin = m1.linspace
    dx = lin[1] - lin[0]
    assert np.allclose(deltas, 2.0, atol=2 * dx)
    # logfile round-trip, sorted by KL descending
    tsv = tmp_path / "dist.tsv"
    write_comparison_tsv(str(tsv), kmers, kls, hels, deltas)
    back = read_comparison_tsv(str(tsv))
    assert len(back) == 64
    vals = [r[1] for r in back]
    assert vals == sorted(vals, reverse=True)
    bykmer = {r[0]: r for r in back}
    i = kmers.index("ACG")
    assert bykmer["ACG"][1] == pytest.approx(kls[i])
    assert bykmer["ACG"][2] == pytest.approx(hels[i])
    assert bykmer["ACG"][3] == pytest.approx(deltas[i])


@pytest.mark.skipif(not os.path.exists(NHDP), reason="reference data")
def test_compare_shipped_hdp(tmp_path):
    from signalalign_jax.models.hdp_model import load_nhdp

    model = PoreModel.from_file(CPG6)
    hdp = load_nhdp(NHDP)
    kmers, kls, hels, deltas = compare_model_to_own_hdp(model, hdp)
    assert len(kmers) > 1000
    # KL is None (inf) whenever the Gaussian tail underflows under HDP
    # mass — the reference's entropy==inf -> None convention
    # (hiddenMarkovModel.py:786-793); the narrow-sd 6-mer Gaussians vs the
    # wide 30-180pA grid make that the common case, exactly as upstream
    finite = [k for k in kls if k is not None]
    assert len(finite) > 1000
    assert all(k > 0 for k in finite)
    assert all(h >= 0 for h in hels)
    # the shipped fixture nhdp is toy-trained (modes near 60 pA), so
    # deltas vs the real ONT means are large but must be finite and
    # bounded by the grid span
    assert np.isfinite(deltas).all()
    assert max(deltas) <= hdp.grid[-1] - hdp.grid[0]

    # density dump matches the loaded table at grid knots
    # (compareDistributions.c writes the spline evaluated on its own grid)
    dd = dump_densities(hdp, str(tmp_path / "dumps"), kmers=["AACGTA"])
    x = np.loadtxt(tmp_path / "dumps" / "x_vals.txt")
    np.testing.assert_allclose(x, hdp.grid, rtol=1e-12)
    y = np.loadtxt(dd[0])
    kid = hdp.alphabet.kmer_index("AACGTA")
    np.testing.assert_allclose(y, hdp.densities[kid], rtol=1e-10, atol=1e-14)


@pytest.mark.skipif(not os.path.exists(NHDP), reason="reference data")
def test_compare_cli(tmp_path):
    from signalalign_jax.cli import main

    out = tmp_path / "cmp"
    rc = main(["compare", "--model", CPG6, "--hdp", NHDP,
               "--output_dir", str(out), "--kmers", "AACGTA",
               "--dump_densities"])
    assert rc == 0
    assert (out / "kl_hellinger_delta_distances.tsv").exists()
    assert (out / "model_comparisons.png").exists()
    assert (out / "kmer_AACGTA.png").exists()
    assert (out / "density_dumps" / "x_vals.txt").exists()
    rows = read_comparison_tsv(str(out / "kl_hellinger_delta_distances.tsv"))
    assert len(rows) > 1000

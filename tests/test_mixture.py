"""Gaussian mixture modelling of kmer event distributions.

reference: src/signalalign/mixture_model.py (sklearn GaussianMixture
workflow) and utils/sequenceTools.py get_motif_kmers.
"""

import os

import numpy as np
import pytest

from signalalign_jax.pipeline.mixture import (
    GaussianMixture1D, closest_to_canonical, find_best_1d_gaussian_fit,
    find_modification_index_and_character, generate_mixture_model_for_motifs,
    get_motif_kmer_pairs, get_motif_kmers, get_mus_and_sigmas_1d,
    get_nanopore_gauss_mixture, read_assignment_table)

MODEL = "/root/reference/models/testModelR9p4_5mer_acegt_template.model"


def test_gmm_recovers_two_components():
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.normal(80.0, 1.5, 400),
                        rng.normal(92.0, 2.0, 600)])
    m = get_nanopore_gauss_mixture(x, 2)
    mus = sorted(m.means_[:, 0])
    assert abs(mus[0] - 80.0) < 0.5 and abs(mus[1] - 92.0) < 0.5
    sds = get_mus_and_sigmas_1d(m)
    assert len(sds) == 2
    w = sorted(m.weights_)
    assert abs(w[0] - 0.4) < 0.05
    # mixture density integrates to ~1
    xs = np.linspace(70, 105, 2000)
    assert abs(np.trapezoid(np.exp(m.score_samples(xs)), xs) - 1.0) < 1e-2


def test_model_selection_prefers_two():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(0.0, 1.0, 500),
                        rng.normal(8.0, 1.0, 500)])
    best = find_best_1d_gaussian_fit(x, 5, aic=True)
    assert best.n_components == 2
    best_bic = find_best_1d_gaussian_fit(x, 5, aic=False)
    assert best_bic.n_components == 2


def test_closest_to_canonical():
    match, rest, dist = closest_to_canonical([(80.0, 1.0), (92.0, 2.0)],
                                             81.0)
    assert match == (80.0, 1.0) and rest == [(92.0, 2.0)] and dist == 1.0


def test_motif_kmers_cover_modified_position():
    pos, old, new = find_modification_index_and_character("CCAGG", "CEAGG")
    assert (pos, old, new) == (1, "C", "E")
    kmers = get_motif_kmers(("CCAGG", "CEAGG"), 5, alphabet="ACGT")
    assert all("E" in k and len(k) == 5 for k in kmers)
    assert len(kmers) == len(set(kmers))
    # the fully-interior kmer is the motif itself
    assert "CEAGG" in kmers
    # windows hanging off both ends enumerate flanks: 4 front x CEAG core
    assert sum(1 for k in kmers if k.endswith("CEAG")) == 4
    pairs = get_motif_kmer_pairs(("CCAGG", "CEAGG"), 5, alphabet="ACGT")
    for canonical, modified in pairs:
        assert "E" not in canonical and "E" in modified
        assert canonical == modified.replace("E", "C")


def test_generate_mixture_model_for_motifs(tmp_path, reference_dir):
    from signalalign_jax.models.pore_model import PoreModel
    model = PoreModel.from_file(MODEL)

    # synthesize bimodal event means for one canonical kmer: the second
    # mode should land in the modified kmer's slot
    kmer = "CCAGG"
    ki = model.alphabet.kmer_index(kmer)
    mu = float(model.level_mean[ki])
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.normal(mu, 1.0, 300),
                        rng.normal(mu + 10.0, 1.0, 300)])
    table = tmp_path / "assign.tsv"
    with open(table, "w") as fh:
        for v in x:
            fh.write(f"{kmer}\tt\t{v:f}\t1.0\n")
    assignments = read_assignment_table(str(table))
    assert (("t", kmer) in assignments
            and len(assignments[("t", kmer)]) == 600)

    rows = generate_mixture_model_for_motifs(
        model, assignments, [[kmer, "CEAGG"]], strand="t",
        output_dir=str(tmp_path))
    assert len(rows) == 1
    kj = model.alphabet.kmer_index("CEAGG")
    assert abs(model.level_mean[kj] - (mu + 10.0)) < 0.5
    # distances TSV + model written
    out_model = tmp_path / "t_mixture_model.hmm"
    dist_tsv = tmp_path / "t_distances.tsv"
    assert out_model.exists() and dist_tsv.exists()
    reread = PoreModel.from_file(str(out_model))
    assert abs(reread.level_mean[kj] - model.level_mean[kj]) < 1e-4


def test_mixture_cli(tmp_path, reference_dir):
    from signalalign_jax.cli import main
    from signalalign_jax.models.pore_model import PoreModel
    model = PoreModel.from_file(MODEL)
    kmer = "ACCAG"
    ki = model.alphabet.kmer_index(kmer)
    mu = float(model.level_mean[ki])
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(mu, 1.0, 200),
                        rng.normal(mu + 8.0, 1.0, 200)])
    table = tmp_path / "assign.tsv"
    with open(table, "w") as fh:
        for v in x:
            fh.write(f"{kmer}\tt\t{v:f}\t1.0\n")
    rc = main(["mixture", "--model", MODEL, "--assignments", str(table),
               "--motif", "CCAGG,CEAGG", "--output_dir", str(tmp_path),
               "--strand", "t"])
    assert rc == 0
    assert (tmp_path / "t_distances.tsv").exists()

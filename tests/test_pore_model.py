import math
import os

import numpy as np
import pytest
from scipy.stats import invgauss, norm

from signalalign_jax.models.pore_model import (PoreModel, ScalingParams,
                                               _log_gauss_pdf,
                                               _log_inv_gauss_pdf)
from signalalign_jax.utils.alphabet import (Alphabet, DEFAULT_AMBIG_BASES,
                                            expand_kmer_paths,
                                            reverse_complement)

MODELS = "/root/reference/models"


def test_kmer_index_matches_lexicographic_rank():
    a = Alphabet("ACGT", 5)
    assert a.kmer_index("AAAAA") == 0
    assert a.kmer_index("AAAAC") == 1
    assert a.kmer_index("TTTTT") == 4 ** 5 - 1
    # round trip
    for idx in [0, 1, 77, 1023, 4 ** 5 - 1]:
        assert a.kmer_index(a.index_to_kmer(idx)) == idx


def test_seq_to_kmer_ids():
    a = Alphabet("ACGT", 3)
    ids = a.seq_to_kmer_ids("ACGTA")
    assert len(ids) == 3
    assert ids[0] == a.kmer_index("ACG")
    assert ids[1] == a.kmer_index("CGT")
    assert ids[2] == a.kmer_index("GTA")


def test_alphabet_is_sorted_even_if_given_unsorted():
    a = Alphabet("TGCA", 2)
    assert a.letters == "ACGT"
    assert a.kmer_index("AA") == 0


@pytest.mark.skipif(not os.path.isdir(MODELS), reason="reference models missing")
def test_load_r94_model():
    m = PoreModel.from_file(os.path.join(MODELS, "testModelR9p4_acegt_template.model"))
    assert m.alphabet.letters == "ACEGT"
    assert m.kmer_length == 6
    assert m.num_kmers == 5 ** 6
    # First values from the file (inspected directly):
    assert math.isclose(m.transitions[0], 0.790158882824, rel_tol=1e-12)
    assert math.isclose(m.level_mean[0], 86.486336, rel_tol=1e-9)
    assert math.isclose(m.level_sd[0], 1.517846, rel_tol=1e-9)
    assert math.isclose(m.noise_lambda[0], 2.24743385821, rel_tol=1e-9)
    # gap-Y table has inflated level_sd
    assert math.isclose(m.gap_y_level_sd[0], 1.517846 * 1.75, rel_tol=1e-9)
    # disabled transitions are log-zero even though file has small values
    assert m.log_transitions[5] == -np.inf
    assert m.log_transitions[7] == -np.inf


def test_model_write_read_roundtrip(tmp_path):
    m = PoreModel.from_file(os.path.join(MODELS, "testModelR9.4_450bps.nucleotide.6mer.template.model"))
    out = tmp_path / "roundtrip.model"
    m.write(str(out))
    m2 = PoreModel.from_file(str(out))
    np.testing.assert_allclose(m2.level_mean, m.level_mean, rtol=0)
    np.testing.assert_allclose(m2.transitions, m.transitions, rtol=0)
    assert m2.alphabet.letters == m.alphabet.letters


def test_nanopolish_model_matches_converted_signalalign_model():
    nano = PoreModel.from_nanopolish_file(
        os.path.join(MODELS, "r9.4_450bps.nucleotide.6mer.template.model"))
    sa = PoreModel.from_file(
        os.path.join(MODELS, "testModelR9.4_450bps.nucleotide.6mer.template.model"))
    assert nano.alphabet.letters == sa.alphabet.letters == "ACGT"
    np.testing.assert_allclose(nano.level_mean, sa.level_mean, rtol=1e-9)
    np.testing.assert_allclose(nano.noise_lambda, sa.noise_lambda, rtol=1e-9)


def test_log_gauss_pdf_matches_scipy():
    for x, mu, sd in [(85.0, 86.5, 1.5), (60.0, 80.0, 3.0)]:
        assert math.isclose(_log_gauss_pdf(x, mu, sd), norm(mu, sd).logpdf(x), rel_tol=1e-12)


def test_log_inv_gauss_pdf_matches_scipy():
    # scipy invgauss(mu=m/lam, scale=lam) parameterization as in
    # hiddenMarkovModel.py:416-422
    for x, mu, lam in [(1.2, 1.0, 2.2), (0.9, 1.1, 1.8)]:
        expect = invgauss(mu / lam, scale=lam).logpdf(x)
        assert math.isclose(_log_inv_gauss_pdf(x, mu, lam), expect, rel_tol=1e-10)


def test_descaling():
    p = ScalingParams(shift=3.0, scale=1.1, var=1.2)
    x, mu = 90.0, 85.0
    expect = (x + 1.2 * mu - 1.1 * mu - 3.0) / 1.2
    assert math.isclose(PoreModel.descale_event_mean(x, mu, p), expect, rel_tol=1e-12)


def test_expand_kmer_paths():
    paths = expand_kmer_paths("AXT", DEFAULT_AMBIG_BASES)
    assert paths == ["AAT", "ACT", "AGT", "ATT"]
    paths = expand_kmer_paths("APT", DEFAULT_AMBIG_BASES)  # P -> CE
    assert paths == ["ACT", "AET"]
    assert expand_kmer_paths("ACT", DEFAULT_AMBIG_BASES) == ["ACT"]


def test_reverse_complement():
    assert reverse_complement("ACGT") == "ACGT"
    assert reverse_complement("AACG") == "CGTT"

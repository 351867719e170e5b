"""Expectations-file format round-trip vs the shipped reference fixture."""

import numpy as np
import pytest

from signalalign_jax.models.expectations import (ExpectationsAccumulator,
                                                 write_expectations_file)
from signalalign_jax.models.pore_model import PoreModel

FIXTURE = ("/root/reference/tests/test_expectation_files/"
           "4f9a316c-8bb3-410a-8cfc-026061f7e8db.template.expectations.tsv")
MODEL = "/root/reference/models/testModelR9_acegt_complement.model"


def test_add_fixture_and_normalize():
    model = PoreModel.from_file(MODEL)
    acc = ExpectationsAccumulator(model)
    assert acc.add_file(FIXTURE)
    assert acc.add_file(FIXTURE)
    assert acc.n_files == 2
    t = acc.normalize_transitions()
    for row in t:
        assert abs(row.sum() - 1.0) < 1e-9
    lik = acc.likelihood
    model2 = acc.apply(update_transitions=True)
    assert model2.likelihood == lik


def test_alphabet_mismatch_rejected():
    model = PoreModel("ACGT", 5)
    model.level_mean = np.zeros(1024)
    acc = ExpectationsAccumulator(model)
    with pytest.raises(AssertionError):
        acc.add_file(FIXTURE)


def test_write_read_roundtrip(tmp_path):
    model = PoreModel.from_file(MODEL)
    K = model.alphabet.num_kmers
    rng = np.random.default_rng(0)
    texp = rng.random(9)
    me = rng.random(K)
    sd = rng.random(K)
    post = rng.random(K) + 0.5
    obs = rng.random(K) > 0.5
    path = write_expectations_file(
        str(tmp_path / "x.expectations.tsv"), model, texp, -123.5,
        me, sd, post, obs)
    acc = ExpectationsAccumulator(PoreModel.from_file(MODEL))
    assert acc.add_file(path)
    assert abs(acc.likelihood + 123.5) < 1e-6
    assert np.allclose(acc.transitions_expectations, texp, atol=1e-8)
    assert np.allclose(acc.mean_expectations, me, atol=1e-8)
    assert np.allclose(acc.posteriors, post, atol=1e-8)
    assert (acc.observed == obs).all()

def test_hdp_expectations_roundtrip(tmp_path):
    """HdpHmm 5-line format: transitions + thresholded (kmer, event)
    assignment lists (hdpHmm_writeToFile/loadFromFile,
    /root/reference/impl/continuousHmm.c:571-790)."""
    from signalalign_jax.models.expectations import (
        read_hdp_expectations_file, write_hdp_expectations_file)
    model = PoreModel.from_file(MODEL)
    rng = np.random.default_rng(1)
    texp = rng.random(9) * 10
    k = model.kmer_length
    letters = model.alphabet.letters
    kmers = ["".join(rng.choice(list(letters), k)) for _ in range(17)]
    events = rng.normal(65.0, 8.0, size=17)
    path = write_hdp_expectations_file(
        str(tmp_path / "x.hdp.expectations.tsv"), model, texp, -77.25,
        events, kmers)
    d = read_hdp_expectations_file(path)
    assert d["state_number"] == 3
    assert d["alphabet"] == letters
    assert d["kmer_length"] == k
    assert abs(d["likelihood"] + 77.25) < 1e-6
    assert np.allclose(d["transitions"], texp, atol=1e-8)
    assert d["kmer_assignments"] == kmers
    assert np.allclose(d["event_assignments"], events, atol=1e-8)
    assert np.allclose(d["event_model"][:, 0], model.level_mean, atol=1e-8)
    # reference loader line-shape invariants (continuousHmm.c:627-720):
    # header has 4 tokens, transitions line has 10, event model K*5
    with open(path) as fh:
        lines = fh.read().rstrip("\n").split("\n")
    assert len(lines) == 5
    assert len(lines[0].split()) == 4
    assert len(lines[1].split()) == 10
    assert len(lines[2].split()) == model.alphabet.num_kmers * 5

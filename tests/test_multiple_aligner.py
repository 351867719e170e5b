"""Discrete pair HMM + posterior-weight multiple aligner.

reference: impl/discreteHmm.c (transition normalization, EM container)
and impl/multipleAligner.c (posterior-weight MSA with poset-consistent
column merging).
"""

import numpy as np
import pytest

from signalalign_jax.models.discrete_hmm import DiscreteHmm
from signalalign_jax.pipeline.multiple_aligner import (
    alignment_score, make_alignment, make_all_pairwise_alignments,
    render_msa)


def test_forward_backward_totals_agree():
    hmm = DiscreteHmm()
    x, y = hmm.digitize("ACGTACGT"), hmm.digitize("ACGAACGT")
    F = hmm.forward(x, y)
    B = hmm.backward(x, y)
    tot_f = hmm.total_log_prob(F)
    # backward total: start-state-weighted B at origin
    import numpy as np
    tot_b = float(np.log(np.sum(np.exp(B[0, 0]) / 3.0)))
    assert abs(tot_f - tot_b) < 1e-9


def test_identical_sequences_align_diagonal():
    hmm = DiscreteHmm()
    pairs = hmm.aligned_pairs("ACGTACGTGG", "ACGTACGTGG")
    best = {}
    for p, i, j in pairs:
        if p > best.get(i, (0, None))[0]:
            best[i] = (p, j)
    assert all(best[i][1] == i for i in range(10))
    assert all(best[i][0] > 0.5 for i in range(10))
    assert alignment_score(pairs, 10, 10) > 0.5


def test_normalize_and_randomize():
    hmm = DiscreteHmm()
    hmm.randomize(np.random.default_rng(1))
    assert np.allclose(hmm.transitions.sum(axis=1), 1.0)
    assert abs(hmm.emissions[0].sum() - 1.0) < 1e-12
    assert np.allclose([hmm.emissions[1].sum(), hmm.emissions[2].sum()],
                       1.0)
    # the 3-state topology forbids gapX<->gapY hops
    assert hmm.transitions[1, 2] == 0.0 and hmm.transitions[2, 1] == 0.0


def test_em_increases_likelihood():
    hmm = DiscreteHmm(match_bias=0.5, gap_open=0.2)
    pairs = [("ACGTACGT", "ACGTACGT"), ("GGCATT", "GGCTT"),
             ("TTACG", "TTCCG")]
    lls = [hmm.em_step(pairs) for _ in range(6)]
    assert lls[-1] > lls[0]
    assert all(b >= a - 1e-6 for a, b in zip(lls, lls[1:]))


def test_em_round_trip_serialization(tmp_path):
    hmm = DiscreteHmm()
    hmm.em_step([("ACGTACGT", "ACGAACGT")])
    path = tmp_path / "sym.hmm"
    hmm.write(str(path))
    back = DiscreteHmm.load(str(path))
    assert np.allclose(back.transitions, hmm.transitions)
    assert np.allclose(back.emissions[0], hmm.emissions[0])


def test_msa_columns_are_consistent():
    seqs = ["ACGTTACG", "ACGTACG", "ACGTTACG", "ACTTTACG"]
    msa = make_alignment(seqs)
    # every position appears in exactly one column
    seen = set()
    for col in msa.columns:
        for key in col:
            assert key not in seen
            seen.add(key)
        # one position per sequence per column
        snames = [s for s, _ in col]
        assert len(snames) == len(set(snames))
    assert seen == {(s, p) for s in range(4) for p in range(len(seqs[s]))}
    rows = render_msa(seqs, msa)
    # rendering restores the input sequences when gaps are dropped
    for seq, row in zip(seqs, rows):
        assert row.replace("-", "") == seq
    assert len({len(r) for r in rows}) == 1
    # strong signal: most columns should stack 3+ sequences
    deep = sum(1 for c in msa.columns if len(c) >= 3)
    assert deep >= 6


def test_msa_respects_order_no_crossing():
    seqs = ["ACGT", "TGCA"]
    msa = make_alignment(seqs)
    # within the column order, each sequence's positions appear sorted
    for s in range(2):
        pos = [dict(c)[s] for c in msa.columns if s in dict(c)]
        assert pos == sorted(pos)


def test_pairwise_scores_rank_similarity():
    seqs = ["ACGTACGTAC", "ACGTACGTAC", "TTGGCCAATT"]
    _, scores = make_all_pairwise_alignments(seqs)
    assert scores[(0, 1)] > scores[(0, 2)]
    assert scores[(0, 1)] > scores[(1, 2)]

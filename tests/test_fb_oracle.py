"""Oracle DP tests replicating the reference C unit tests.

The golden case mirrors test_sm3_diagonalDPCalculations
(/root/reference/tests/stateMachineTests.c:441-560): a 13-base sequence with
one ambiguous position ('L' -> C/E/O paths) aligned to 7 events under the
testModelR73_acegot_template model, band expansion 2, no anchors,
non-ragged ends, threshold 0.2 -> expect exactly 14 aligned pairs drawn from
a known coordinate set, and forward/backward total probabilities agreeing.
"""

import math
import os

import numpy as np
import pytest

from signalalign_jax.models.pore_model import PoreModel, ScalingParams
from signalalign_jax.ops.band_geometry import (band_widths, build_band,
                                               filter_to_remove_overlap,
                                               get_split_points)
from signalalign_jax.ops.fb_oracle import (CellPaths, Emissions,
                                           banded_forward_backward)
from signalalign_jax.utils.alphabet import DEFAULT_AMBIG_BASES

MODELS = "/root/reference/models"

SX = "ACGATALGGACAT"
EVENTS = np.array([
    [58.743435, 0.887833, 0.0571, 0.0],
    [53.604965, 0.816836, 0.0571, 0.1],
    [58.432015, 0.735143, 0.0571, 0.2],
    [63.684352, 0.795437, 0.0571, 0.3],
    [58.921430, 0.812959, 0.0571, 0.4],
    [59.895882, 0.740952, 0.0571, 0.5],
    [61.684303, 0.722332, 0.0571, 0.67],
])

EXPECTED_PAIRS = {(0, 0), (1, 1), (2, 2), (3, 3), (4, 3), (5, 4), (6, 5), (7, 6)}


@pytest.fixture(scope="module")
def r73_model():
    return PoreModel.from_file(os.path.join(MODELS, "testModelR73_acegot_template.model"))


@pytest.fixture(scope="module")
def golden(r73_model):
    paths = CellPaths.from_sequence(SX, r73_model, DEFAULT_AMBIG_BASES)
    em = Emissions(r73_model, ScalingParams(), mode="full")
    return banded_forward_backward(
        paths, EVENTS, r73_model, em,
        anchor_pairs=(), expansion=2,
        ragged_start=False, ragged_end=False,
        threshold=0.2, compute_expectations=True)


def test_band_construction_no_anchors():
    # without anchors the band is a single expanded corridor from (0,0) to
    # (lX, lY); widths are bounded by expansion+1 cells
    xmyL, xmyR = build_band([], 8, 7, 2)
    assert len(xmyL) == 16
    assert xmyL[0] == xmyR[0] == 0
    assert (xmyL <= xmyR).all()
    w = band_widths(np.array(xmyL), np.array(xmyR))
    # with no anchors the corridor covers the whole matrix (the reference
    # band only narrows between anchor waypoints)
    assert w.max() == 7 + 1
    # last diagonal pinned at the corner cell
    assert xmyL[15] == xmyR[15] == 8 - 7


def test_band_narrows_with_anchors():
    anchors = [(i, i) for i in range(4, 60, 5)]
    xmyL, xmyR = build_band(anchors, 64, 64, 4)
    w = band_widths(np.array(xmyL), np.array(xmyR))
    assert w.max() <= 2 * 4 + 2  # expansion-bounded corridor
    assert xmyL[-1] == xmyR[-1] == 0


def test_band_with_anchor_passes_through_it():
    lX, lY, expansion = 20, 20, 4
    anchor = (10, 12)
    xmyL, xmyR = build_band([anchor], lX, lY, expansion)
    # matrix waypoint is anchor + 1; its diagonal must contain its xmy
    xay = (anchor[0] + 1) + (anchor[1] + 1)
    xmy = (anchor[0] + 1) - (anchor[1] + 1)
    assert xmyL[xay] <= xmy <= xmyR[xay]


def test_golden_total_probs_agree(golden):
    assert golden["total_log_prob_f"] != -np.inf
    assert math.isclose(golden["total_log_prob_f"], golden["total_log_prob_b"],
                        abs_tol=1e-6)


def test_golden_aligned_pairs(golden):
    pairs = golden["aligned_pairs"]
    assert len(pairs) == 14
    for prob, x, y, kmer in pairs:
        assert (x, y) in EXPECTED_PAIRS
        assert 0.2 * 1e7 <= prob <= 1e7


def test_golden_ambiguous_position_has_multiple_paths(golden):
    # position 1..6 windows include the 'L'; cell kmers there have 3 paths
    pairs_at_1 = [p for p in golden["aligned_pairs"] if p[1] == 1]
    kmers = {p[3] for p in pairs_at_1}
    assert len(kmers) >= 2  # multiple path kmers called at ambiguous windows


def test_transition_expectations_sane(golden):
    texp = golden["transition_expectations"]
    assert texp.shape == (3, 3)
    assert (texp >= 0).all()
    # disabled switch transitions accumulate nothing
    assert texp[1, 2] == 0 and texp[2, 1] == 0
    # roughly one match transition per aligned event
    assert 3.0 < texp[:, 0].sum() < 10.0


def test_filter_to_remove_overlap():
    # the reference filter drops every pair "crossed" by any other pair; a
    # conflicting (1, 5) poisons everything at x>=1, y<=5 as well
    pairs = [(0, 0), (1, 5), (2, 2), (3, 3), (5, 4)]
    out = filter_to_remove_overlap(sorted(pairs))
    assert out == [(0, 0)]
    # a clean strictly-increasing chain passes through untouched
    chain = [(0, 0), (2, 2), (3, 3), (5, 4)]
    assert filter_to_remove_overlap(chain) == chain


def test_split_points_no_split_needed():
    sp = get_split_points([(10, 10)], 100, 100, 3000 * 3000, True, True)
    assert sp == [(0, 0, 100, 100)]


def test_split_points_large_gap():
    sp = get_split_points([(100, 100), (9000, 9000)], 10000, 10000,
                          3000 * 3000, True, True)
    assert len(sp) >= 2
    # blocks tile the matrix monotonically
    for (x1, y1, x2, y2) in sp:
        assert x1 <= x2 and y1 <= y2

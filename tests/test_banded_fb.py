"""Device banded forward-backward vs the float64 oracle, on seeded models
(tests/conftest.py)."""

import math

import numpy as np
import pytest

from signalalign_jax.models.pore_model import ScalingParams
from signalalign_jax.ops import banded_fb as bfb
from signalalign_jax.ops.batch import run_banded_fb_batch
from signalalign_jax.ops.fb_oracle import (CellPaths, Emissions,
                                           banded_forward_backward)
from signalalign_jax.utils.alphabet import DEFAULT_AMBIG_BASES
from signalalign_jax.utils.synthetic import seeded_pore_model

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


@pytest.fixture(scope="module")
def r73_model():
    """ACEGOT 6-mer model: SX's L (C/E/O) expands to three paths."""
    model = seeded_pore_model("ACEGOT", 6, seed=5)
    model.level_mean = model.level_mean * 0.55   # R7.3-like ~35-70 pA
    return model


@pytest.fixture(scope="module")
def r94_model(acgt_model):
    return acgt_model


def test_golden_case_matches_oracle(r73_model):
    model = r73_model
    params = ScalingParams()
    problem = bfb.prepare_problem(
        SX, EVENTS, model, params, DEFAULT_AMBIG_BASES,
        W=16, Dpad=24, P=3, mode=bfb.MODE_FULL,
        anchor_pairs=(), expansion=2,
        ragged_start=False, ragged_end=False)
    res = bfb.run_banded_fb(problem, W=16, P=3, with_expectations=True)

    paths = CellPaths.from_sequence(SX, model, DEFAULT_AMBIG_BASES)
    em = Emissions(model, params, mode="full")
    oracle = banded_forward_backward(
        paths, EVENTS, model, em, anchor_pairs=(), expansion=2,
        ragged_start=False, ragged_end=False, threshold=0.2,
        compute_expectations=True)

    assert math.isclose(res["total_f"], oracle["total_log_prob_f"], rel_tol=1e-4)
    assert math.isclose(res["total_b"], oracle["total_log_prob_b"], rel_tol=1e-4)
    assert math.isclose(res["total_f"], res["total_b"], rel_tol=1e-4)

    pairs = bfb.extract_aligned_pairs(problem, res["post"], threshold=0.2)
    opairs = oracle["aligned_pairs"]
    assert len(pairs) == len(opairs) > 0
    dev = {(x, y, k): p for p, x, y, k in pairs}
    for p, x, y, k in opairs:
        assert (x, y, k) in dev
        assert abs(dev[(x, y, k)] - p) <= 2e-3 * 1e7  # f32 vs f64 tolerance

    np.testing.assert_allclose(res["texp"], oracle["transition_expectations"],
                               rtol=2e-3, atol=2e-3)


def _synthetic_read(model, rng, n_kmers, params, p_stay=0.1, p_skip=0.1):
    """Generate a plausible (sequence, events) pair from the model."""
    letters = "ACGT"
    seq = "".join(rng.choice(list(letters), size=n_kmers + model.kmer_length - 1))
    ids = model.alphabet.seq_to_kmer_ids(seq)
    events = []
    truth = []
    i = 0
    while i < len(ids):
        r = rng.random()
        mean = model.level_mean[ids[i]] * params.scale + params.shift
        sd = model.level_sd[ids[i]]
        events.append([rng.normal(mean, sd * params.var), abs(rng.normal(1.0, 0.1)),
                       0.005, len(events) * 0.005])
        truth.append((i, len(events) - 1))
        if r < p_stay:
            continue  # stay: emit another event for same kmer
        if r < p_stay + p_skip:
            i += 2  # skip
        else:
            i += 1
    return seq, np.array(events), truth


def test_random_case_matches_oracle_with_anchors(r94_model):
    model = r94_model
    rng = np.random.default_rng(42)
    params = ScalingParams(shift=2.0, scale=1.05, var=1.1)
    seq, events, truth = _synthetic_read(model, rng, 48, params)
    anchors = [truth[i] for i in range(4, len(truth) - 4, 8)]
    anchors = [(x, y) for x, y in anchors]

    problem = bfb.prepare_problem(
        seq, events, model, params, DEFAULT_AMBIG_BASES,
        W=32, Dpad=len(seq) + len(events) + 8, P=1, mode=bfb.MODE_MEAN_ONLY,
        anchor_pairs=anchors, expansion=6,
        ragged_start=True, ragged_end=True)
    res = bfb.run_banded_fb(problem, W=32, P=1, with_expectations=True)

    paths = CellPaths.from_sequence(seq, model, DEFAULT_AMBIG_BASES)
    em = Emissions(model, params, mode="mean_only")
    oracle = banded_forward_backward(
        paths, events, model, em, anchor_pairs=anchors, expansion=6,
        ragged_start=True, ragged_end=True, threshold=0.01,
        compute_expectations=True)

    assert math.isclose(res["total_f"], oracle["total_log_prob_f"], rel_tol=1e-4)
    assert math.isclose(res["total_f"], res["total_b"], rel_tol=1e-4)

    pairs = bfb.extract_aligned_pairs(problem, res["post"], threshold=0.01)
    opairs = oracle["aligned_pairs"]
    dev = {(x, y): p for p, x, y, k in pairs}
    orc = {(x, y): p for p, x, y, k in opairs}
    # identical cells above threshold (allow boundary flips right at 0.01)
    sym = set(dev) ^ set(orc)
    for x, y in sym:
        p = dev.get((x, y), orc.get((x, y)))
        assert abs(p / 1e7 - 0.01) < 2e-3
    for key in set(dev) & set(orc):
        assert abs(dev[key] - orc[key]) <= 3e-3 * 1e7

    np.testing.assert_allclose(res["texp"], oracle["transition_expectations"],
                               rtol=5e-3, atol=5e-3)
    # most true (kmer, event) matches should be recovered
    hits = sum(1 for t in truth if t in dev)
    assert hits / len(truth) > 0.8


def test_emission_expectations_match_posteriors(r94_model):
    """Device per-kmer emission moments == host accumulation over the
    posterior match tensor (into-match transition posteriors sum to the
    match-state posterior at every interior cell)."""
    model = r94_model
    rng = np.random.default_rng(11)
    params = ScalingParams(shift=2.0, scale=1.05, var=1.1)
    seq, events, truth = _synthetic_read(model, rng, 40, params)
    anchors = [truth[i] for i in range(4, len(truth) - 4, 8)]
    W = 32
    problem = bfb.prepare_problem(
        seq, events, model, params, DEFAULT_AMBIG_BASES,
        W=W, Dpad=len(seq) + len(events) + 8, P=1,
        mode=bfb.MODE_MEAN_ONLY, anchor_pairs=anchors, expansion=6)
    res = bfb.run_banded_fb(problem, W=W, P=1, with_expectations=True)
    post = res["post"]
    kexp = res["kexp"]
    K = model.alphabet.num_kmers
    assert kexp.shape == (3, K)
    sp = np.zeros(K)
    sdx = np.zeros(K)
    sdx2 = np.zeros(K)
    ids = model.alphabet.seq_to_kmer_ids(seq)
    means = events[:, 0]
    for d in range(problem.n_diag + 1):
        for o in range(W):
            p = float(post[d, 0, o])
            if p <= 0:
                continue
            x = int(problem.x0[d]) + o
            y = d - x
            if x < 1 or y < 1 or x > problem.lX or y > problem.lY:
                continue
            kid = int(ids[x - 1])
            m_hat = params.scale * model.level_mean[kid] + params.shift
            dx = (means[y - 1] - m_hat) / params.var
            sp[kid] += p
            sdx[kid] += p * dx
            sdx2[kid] += p * dx * dx
    np.testing.assert_allclose(kexp[0], sp, atol=5e-3)
    np.testing.assert_allclose(kexp[1], sdx, atol=2e-2)
    np.testing.assert_allclose(kexp[2], sdx2, atol=1e-1)
    # slot conversion: Σp·x and batch-centered Σp·(x−µ̂)²
    from signalalign_jax.models.expectations import emission_slots_from_kexp
    me, sd, po, obs = emission_slots_from_kexp(kexp, model.level_mean)
    ok = sp > 1e-3
    x_mean = model.level_mean + np.where(ok, sdx / np.maximum(sp, 1e-9), 0)
    np.testing.assert_allclose(me[ok], (sp * x_mean)[ok], rtol=1e-3)
    # posteriors are Σp, with unobserved (Σp <= 1e-6) k-mers zeroed
    assert (sd >= 0).all()
    assert (po == np.where(kexp[0] > 1e-6, kexp[0], 0.0)).all()
    assert obs.sum() > 20


def test_full_descaled_mode_matches_oracle(r94_model):
    model = r94_model
    rng = np.random.default_rng(7)
    params = ScalingParams(shift=1.0, scale=0.98, var=1.05, scale_sd=1.1, var_sd=0.9)
    seq, events, _ = _synthetic_read(model, rng, 24, params)
    problem = bfb.prepare_problem(
        seq, events, model, params, DEFAULT_AMBIG_BASES,
        W=64, Dpad=len(seq) + len(events) + 8, P=1, mode=bfb.MODE_FULL_DESCALED,
        anchor_pairs=(), expansion=4, scale_noise=True)
    res = bfb.run_banded_fb(problem, W=64, P=1)

    paths = CellPaths.from_sequence(seq, model, DEFAULT_AMBIG_BASES)
    em = Emissions(model, params, mode="full_descaled", scale_noise=True)
    oracle = banded_forward_backward(paths, events, model, em,
                                     anchor_pairs=(), expansion=4)
    assert math.isclose(res["total_f"], oracle["total_log_prob_f"], rel_tol=1e-4)


def test_batched_matches_single(r94_model):
    model = r94_model
    rng = np.random.default_rng(3)
    problems = []
    singles = []
    for i in range(4):
        params = ScalingParams(shift=float(rng.normal(0, 2)), scale=1.0, var=1.0 + 0.1 * i)
        seq, events, _ = _synthetic_read(model, rng, 20 + 4 * i, params)
        prob = bfb.prepare_problem(
            seq, events, model, params, DEFAULT_AMBIG_BASES,
            W=64, Dpad=256, P=1, mode=bfb.MODE_MEAN_ONLY,
            anchor_pairs=(), expansion=8)
        problems.append(prob)
        singles.append(bfb.run_banded_fb(prob, W=64, P=1, with_expectations=True))
    batch = run_banded_fb_batch(problems, W=64, P=1, with_expectations=True)
    for single, b in zip(singles, batch):
        assert math.isclose(single["total_f"], b["total_f"], rel_tol=1e-5)
        np.testing.assert_allclose(b["post"], single["post"], atol=2e-4)
        np.testing.assert_allclose(b["texp"], single["texp"], rtol=1e-3, atol=1e-3)


def test_hdp_mode_matches_oracle(acegt_model, acegt_hdp):
    model, hdp = acegt_model, acegt_hdp
    rng = np.random.default_rng(0)
    seq = "ACGATAPGGACATCCAGTTA"      # P = C/E: two paths
    params = ScalingParams(shift=1.0, scale=1.0, var=1.05)
    n = len(seq) - model.kmer_length + 1
    ev = np.array([[rng.uniform(60, 130), 1.0, .005, i * .005]
                   for i in range(n + 5)])
    problem = bfb.prepare_problem(
        seq, ev, model, params, DEFAULT_AMBIG_BASES,
        W=32, Dpad=127, P=2, mode=bfb.MODE_HDP, anchor_pairs=(),
        expansion=4, hdp=hdp)
    res = bfb.run_banded_fb(problem, W=32, P=2, with_expectations=True)
    paths = CellPaths.from_sequence(seq, model, DEFAULT_AMBIG_BASES)
    em = Emissions(model, params, mode="hdp", hdp=hdp)
    oracle = banded_forward_backward(paths, ev, model, em, anchor_pairs=(),
                                     expansion=4, compute_expectations=True)
    assert math.isclose(res["total_f"], oracle["total_log_prob_f"],
                        rel_tol=1e-4)
    kp = bfb.extract_aligned_pairs(problem, res["post"], 0.01)
    op = oracle["aligned_pairs"]
    assert len(kp) == len(op)
    dk = {(x, y, k): p for p, x, y, k in kp}
    for p, x, y, k in op:
        assert (x, y, k) in dk and abs(dk[(x, y, k)] - p) < 3e-3 * 1e7


def _seeded_problem(model, rng, n, params, mode, P, hdp=None, W=64):
    """One P-path banded problem with anchors, its oracle inputs, Dpad."""
    seq = list("".join(rng.choice(list("ACGT"), size=n)))
    if P == 2:
        for pos in range(7, n - 6, 11):
            seq[pos] = "P"              # C/E
    seq = "".join(seq)
    ids = model.alphabet.seq_to_kmer_ids(seq.replace("P", "C"))
    ev = np.stack([params.scale * model.level_mean[ids] + params.shift
                   + rng.normal(0, 1.2, len(ids)),
                   np.abs(rng.normal(1.0, 0.1, len(ids))),
                   np.full(len(ids), .005), np.arange(len(ids)) * .005], 1)
    anchors = [(j, j) for j in range(6, len(ids) - 6, 12)]
    problem = bfb.prepare_problem(
        seq, ev, model, params, DEFAULT_AMBIG_BASES, W=W, Dpad=160, P=P,
        mode=mode, anchor_pairs=anchors, expansion=6,
        scale_noise=(mode == bfb.MODE_FULL_DESCALED), hdp=hdp)
    return problem, seq, ev, anchors


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("mode", [bfb.MODE_MEAN_ONLY, bfb.MODE_FULL_DESCALED,
                                  bfb.MODE_HDP])
def test_xla_batch_matches_oracle(acegt_model, acegt_hdp, mode, P):
    """The batched XLA path (the only device path) against the float64
    oracle for every emission mode and one or two paths per cell:
    totals within 1e-4 relative (f32 sweeps vs f64) and the same aligned
    pairs above threshold, posteriors within 3e-3 (f32 exp/log)."""
    model = acegt_model
    hdp = acegt_hdp if mode == bfb.MODE_HDP else None
    oracle_mode = {bfb.MODE_MEAN_ONLY: "mean_only",
                   bfb.MODE_FULL_DESCALED: "full_descaled",
                   bfb.MODE_HDP: "hdp"}[mode]
    rng = np.random.default_rng(100 + 10 * mode + P)
    cases = []
    for i in range(2):
        params = ScalingParams(shift=0.5 * i, scale=1.0 + 0.02 * i,
                               var=1.0 + 0.05 * i, scale_sd=1.05,
                               var_sd=0.95)
        cases.append((params,) + _seeded_problem(
            model, rng, 50 + 8 * i, params, mode, P, hdp))
    got = run_banded_fb_batch([c[1] for c in cases], W=64, P=P,
                              threshold=0.01)
    for (params, problem, seq, ev, anchors), r in zip(cases, got):
        paths = CellPaths.from_sequence(seq, model, DEFAULT_AMBIG_BASES)
        em = Emissions(model, params, mode=oracle_mode, hdp=hdp,
                       scale_noise=(mode == bfb.MODE_FULL_DESCALED))
        oracle = banded_forward_backward(paths, ev, model, em,
                                         anchor_pairs=anchors, expansion=6)
        assert math.isclose(r["total_f"], oracle["total_log_prob_f"],
                            rel_tol=1e-4)
        dev = {(x, y, k): p for p, x, y, k in r["pairs"]}
        orc = {(x, y, k): p for p, x, y, k in oracle["aligned_pairs"]}
        for key in set(dev) ^ set(orc):     # flips right at the threshold
            p = dev.get(key, orc.get(key))
            assert abs(p / 1e7 - 0.01) < 2e-3
        for key in set(dev) & set(orc):
            assert abs(dev[key] - orc[key]) <= 3e-3 * 1e7


@pytest.mark.parametrize("threshold", [0.01, 0.0])
def test_compacted_pairs_equal_full_band(r94_model, threshold):
    """Device threshold compaction returns exactly the pairs the host
    extracts from the fetched band; at 0 every band cell survives, which
    overflows the first compaction width: it must rerun wider, not drop
    cells."""
    rng = np.random.default_rng(21)
    problems = [_seeded_problem(r94_model, rng, 60 + 9 * i,
                                ScalingParams(shift=0.3 * i),
                                bfb.MODE_MEAN_ONLY, 1)[0] for i in range(3)]
    full = run_banded_fb_batch(problems, W=64, P=1)
    comp = run_banded_fb_batch(problems, W=64, P=1, threshold=threshold)
    for p, f, c in zip(problems, full, comp):
        want = bfb.extract_aligned_pairs(p, f["post"], threshold)
        assert c["pairs"] == want
        assert c["total_f"] == f["total_f"]
    if threshold == 0.0:
        assert max(len(c["pairs"]) for c in comp) > 1024


@pytest.mark.gpu
def test_gpu_batch_matches_cpu(r94_model, gpu_device):
    """The same jitted batch on the GPU and on the host CPU: totals within
    1e-5 relative and identical pair sets within 1e-3 posterior (f32
    exp/log and summation order differ between the two backends)."""
    import jax
    rng = np.random.default_rng(8)
    problems = [_seeded_problem(r94_model, rng, 120, ScalingParams(),
                                bfb.MODE_MEAN_ONLY, 1)[0] for _ in range(4)]
    g = run_banded_fb_batch(problems, W=64, P=1, threshold=0.01,
                            device=gpu_device)
    c = run_banded_fb_batch(problems, W=64, P=1, threshold=0.01,
                            device=jax.devices("cpu")[0])
    for a, b in zip(g, c):
        assert math.isclose(a["total_f"], b["total_f"], rel_tol=1e-5)
        da = {(x, y): p for p, x, y, _ in a["pairs"]}
        db = {(x, y): p for p, x, y, _ in b["pairs"]}
        for key in set(da) ^ set(db):
            assert abs(da.get(key, db.get(key)) / 1e7 - 0.01) < 1e-3
        for key in set(da) & set(db):
            assert abs(da[key] - db[key]) <= 1e-3 * 1e7

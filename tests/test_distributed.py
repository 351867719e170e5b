"""Sharded EM step over the 8-device virtual CPU mesh."""

import jax
import numpy as np
import pytest

from signalalign_jax.models.pore_model import ScalingParams
from signalalign_jax.ops import banded_fb as bfb
from signalalign_jax.ops.batch import run_banded_fb_batch, stack_problems
from signalalign_jax.parallel import distributed as dist
from signalalign_jax.utils.alphabet import DEFAULT_AMBIG_BASES

@pytest.fixture(scope="module")
def problems(acgt_model):
    model = acgt_model
    rng = np.random.default_rng(0)
    probs = []
    for i in range(8):
        seq = "".join(rng.choice(list("ACGT"), size=40))
        ids = model.alphabet.seq_to_kmer_ids(seq)
        ev = np.stack([
            model.level_mean[ids] + rng.normal(0, 1, len(ids)),
            np.ones(len(ids)), np.full(len(ids), .005),
            np.arange(len(ids)) * .005], 1)
        probs.append(bfb.prepare_problem(
            seq, ev, model, ScalingParams(), DEFAULT_AMBIG_BASES,
            W=64, Dpad=128, P=1, mode=bfb.MODE_MEAN_ONLY, expansion=8))
    return probs


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_em_step_sharded_matches_unsharded(problems):
    args = stack_problems(problems)
    mesh = dist.make_mesh(8)
    new_trans, lik, totals = dist.em_train_step(
        mesh, args, W=64, P=1, mode=bfb.MODE_MEAN_ONLY)
    new_trans = np.asarray(new_trans)
    # rows are normalized probabilities
    np.testing.assert_allclose(new_trans.sum(axis=1), 1.0, rtol=1e-5)
    # compare against the unsharded batch path
    res = run_banded_fb_batch(problems, W=64, P=1, with_expectations=True)
    texp_sum = sum(r["texp"] for r in res)
    expect = texp_sum / texp_sum.sum(axis=1, keepdims=True)
    np.testing.assert_allclose(new_trans, expect, rtol=1e-3, atol=1e-4)
    totals_ref = np.array([r["total_f"] for r in res])
    np.testing.assert_allclose(np.asarray(totals), totals_ref, rtol=1e-4)


def test_infer_step_sharded_matches_unsharded(problems):
    """Data-parallel posterior inference over the mesh equals the
    single-device batched path."""
    args = stack_problems(problems)
    mesh = dist.make_mesh(8)
    total_f, total_b, post = dist.infer_step(
        mesh, args, W=64, P=1, mode=bfb.MODE_MEAN_ONLY)
    res = run_banded_fb_batch(problems, W=64, P=1)
    for i, r in enumerate(res):
        np.testing.assert_allclose(float(total_f[i]), r["total_f"],
                                   rtol=1e-5)
        np.testing.assert_allclose(np.asarray(post[i]), np.asarray(r["post"]),
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("reverse", [False, True])
def test_device_offsets_match_float64_prefix(reverse):
    """The sharded steps' compensated on-device prefix of the per-diagonal
    offsets (values to ~1e5 nats) stays within 1e-3 nats of the host's
    float64 prefix, where a plain f32 cumsum drifts further."""
    rng = np.random.default_rng(1)
    incr = rng.normal(-9.0, 3.0, size=(2, 12289)).astype(np.float32)
    hi, lo = dist._device_offsets(jax.numpy.asarray(incr), reverse)
    x = incr.astype(np.float64)
    want = (np.cumsum(x[:, ::-1], axis=1)[:, ::-1] if reverse
            else np.cumsum(x, axis=1))
    got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
    assert np.max(np.abs(got - want)) < 1e-3
    plain = (np.cumsum(incr[:, ::-1], axis=1)[:, ::-1] if reverse
             else np.cumsum(incr, axis=1))          # f32 throughout
    assert np.max(np.abs(plain - want)) > np.max(np.abs(got - want))

"""HDP Gibbs training: synthetic data -> .nhdp -> load round-trip."""

import numpy as np
import pytest

from signalalign_jax.hdp.train import (build_topology, gibbs_train,
                                       nig_params_from_data,
                                       train_hdp_from_alignment, write_nhdp)
from signalalign_jax.models.hdp_model import load_nhdp
from signalalign_jax.models.pore_model import PoreModel
from signalalign_jax.utils.alphabet import Alphabet


def test_topologies():
    a = Alphabet("ACGT", 3)
    single = build_topology(a, "singleLevelFixed")
    assert len(single.parent) == 64 + 1
    assert (single.parent[:64] == 64).all() and single.parent[64] == -1

    multi = build_topology(a, "multisetPrior")
    # number of multisets of size 3 from 4 letters = C(6,3) = 20
    assert len(multi.parent) == 64 + 20 + 1
    assert multi.parent[:64].min() >= 64

    mid = build_topology(a, "middleNtsFixed")
    assert len(mid.parent) == 64 + 16 + 1


def test_gibbs_recovers_modes(tmp_path):
    rng = np.random.default_rng(0)
    a = Alphabet("AC", 3)  # 8 kmers
    model = PoreModel("AC", 3)
    model.level_mean = np.linspace(70, 110, 8)
    model.level_sd = np.full(8, 1.5)
    model.noise_mean = np.full(8, 1.0)
    model.noise_sd = np.full(8, 0.2)
    model.noise_lambda = model.noise_mean ** 3 / model.noise_sd ** 2

    # observations for two kmers with distinct means
    k0 = a.kmer_index("AAA")
    k1 = a.kmer_index("CCC")
    build = tmp_path / "build.tsv"
    with open(build, "w") as fh:
        for _ in range(120):
            fh.write(f"AAA\tt\t{rng.normal(80.0, 1.2):f}\n")
            fh.write(f"CCC\tt\t{rng.normal(100.0, 1.2):f}\n")

    out = train_hdp_from_alignment(
        str(build), model, hdp_type="singleLevel",
        out_path=str(tmp_path / "test.nhdp"),
        grid_start=60, grid_stop=120, grid_length=120,
        gibbs_samples=30, burn_in=20, thinning=50)

    hdp = load_nhdp(out)
    assert hdp.alphabet.letters == "AC"
    assert hdp.observed[k0] and hdp.observed[k1]
    g = hdp.grid
    d0 = np.array([hdp.kmer_density(k0, x) for x in g])
    d1 = np.array([hdp.kmer_density(k1, x) for x in g])
    assert abs(g[d0.argmax()] - 80.0) < 3.0
    assert abs(g[d1.argmax()] - 100.0) < 3.0
    # densities integrate to ~1
    dx = g[1] - g[0]
    assert 0.7 < d0.sum() * dx < 1.3
    assert 0.7 < d1.sum() * dx < 1.3
    # unobserved kmer falls back to the base: bimodal-ish, sees both modes
    k2 = a.kmer_index("ACA")
    assert not hdp.observed[k2]
    d2 = np.array([hdp.kmer_density(k2, x) for x in g])
    near80 = d2[(g > 75) & (g < 85)].max()
    near100 = d2[(g > 95) & (g < 105)].max()
    assert near80 > 0.01 and near100 > 0.01


def test_full_type_registry():
    from signalalign_jax.hdp.train import (HDP_TYPE_REGISTRY, build_topology,
                                           hdp_type_alphabet)
    assert len(HDP_TYPE_REGISTRY) == 21  # trainModels.py:580-602
    a = hdp_type_alphabet("compFixed", 3)
    t = build_topology(a, "compFixed")
    # comp: middle dp = purine (AG) count, k+1 middles
    assert len(t.parent) == 216 + 4 + 1
    assert t.parent[a.kmer_index("AAA")] == 216 + 3
    assert t.parent[a.kmer_index("CCC")] == 216 + 0
    g = build_topology(a, "groupMultisetFixed")
    # ACEGOT group ids {0,1,1,2,1,3}: C/E/O collapse to one group
    assert g.parent[a.kmer_index("CEO")] == g.parent[a.kmer_index("EEE")]
    assert len(g.parent) == 216 + 20 + 1
    for name, (letters, kind) in HDP_TYPE_REGISTRY.items():
        al = hdp_type_alphabet(name, 3)
        assert al.letters == "".join(sorted(letters))
        tt = build_topology(al, name)
        assert (tt.parent[:al.num_kmers] >= al.num_kmers).all()


def test_prior_gamma_sampling(tmp_path):
    """*Prior* types resample per-depth concentration parameters
    (hdp.c:2165-2291 auxiliary-variable scheme): the posterior gammas move
    off their initialization, differ across seeds (they are random
    variables), and the trained .nhdp round-trips the sample_gamma block."""
    rng = np.random.default_rng(3)
    a = Alphabet("AC", 3)
    data, data_dp = [], []
    for k, mu in ((0, 78.0), (3, 92.0), (7, 105.0)):
        data += list(rng.normal(mu, 1.0, 80))
        data_dp += [k] * 80
    data = np.array(data)
    data_dp = np.array(data_dp, dtype=np.int64)
    topo = build_topology(a, "singleLevelPrior", base_gamma=1.0,
                          leaf_gamma=1.0)
    grid = np.linspace(60, 120, 60)
    nig = nig_params_from_data(data)

    fixed = gibbs_train(data, data_dp, topo, grid, nig, burn_in=2000,
                        num_samples=10, thinning=60, seed=7,
                        sample_gamma=False)
    # fixed run keeps the initial gammas
    np.testing.assert_allclose(fixed.gamma, [1.0, 1.0])

    ga = np.array([1.0, 1.0])
    gb = np.array([1.0, 1.0])
    runs = [gibbs_train(data, data_dp, topo, grid, nig, burn_in=2000,
                        num_samples=10, thinning=60, seed=s,
                        sample_gamma=True, gamma_alpha=ga, gamma_beta=gb)
            for s in (7, 8)]
    for r in runs:
        assert (r.gamma > 0).all()
        # posterior moved off the exact init with overwhelming probability
        assert not np.allclose(r.gamma, [1.0, 1.0])
        assert ((r.w_aux > 0) & (r.w_aux < 1))[np.array([0, 3, 7])].all()
    assert not np.allclose(runs[0].gamma, runs[1].gamma)
    # densities still recover the modes with sampled gammas
    d0 = runs[0].densities[0]
    assert abs(grid[d0.argmax()] - 78.0) < 4.0


def test_prior_nhdp_roundtrip(tmp_path):
    """singleLevelPrior end-to-end: .nhdp carries sample_gamma metadata and
    the sampled per-depth gammas; load_nhdp reads it back."""
    from signalalign_jax.models.hdp_model import load_nhdp

    rng = np.random.default_rng(1)
    model = PoreModel("AC", 3)
    model.level_mean = np.linspace(70, 110, 8)
    model.level_sd = np.full(8, 1.5)
    model.noise_mean = np.full(8, 1.0)
    model.noise_sd = np.full(8, 0.2)
    model.noise_lambda = model.noise_mean ** 3 / model.noise_sd ** 2
    build = tmp_path / "build.tsv"
    with open(build, "w") as fh:
        for _ in range(100):
            fh.write(f"AAA\tt\t{rng.normal(80.0, 1.2):f}\n")
            fh.write(f"CCC\tt\t{rng.normal(100.0, 1.2):f}\n")
    out = train_hdp_from_alignment(
        str(build), model, hdp_type="singleLevelPrior2",
        out_path=str(tmp_path / "prior.nhdp"),
        grid_start=60, grid_stop=120, grid_length=120,
        gibbs_samples=20, burn_in=20, thinning=40)
    with open(out) as fh:
        lines = fh.read().splitlines()
    assert lines[5] == "1"      # sample_gamma flag set
    a = Alphabet("ACEGT", 3)
    hdp = load_nhdp(out)
    assert hdp.observed[a.kmer_index("AAA")]
    g = hdp.grid
    d = np.array([hdp.kmer_density(a.kmer_index("AAA"), x) for x in g])
    assert abs(g[d.argmax()] - 80.0) < 4.0

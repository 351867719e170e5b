"""EM training tests on synthetic reads with known generative parameters."""

import os

import numpy as np
import pytest

from signalalign_jax.io.guide import GuideAlignment
from signalalign_jax.io.read import NanoporeReadData
from signalalign_jax.io.reference import ProcessedReference
from signalalign_jax.models.pore_model import PoreModel, ScalingParams
from signalalign_jax.pipeline.runner import run_alignment_batch
from signalalign_jax.pipeline.signal_align import AlignmentConfig
from signalalign_jax.pipeline.train import (collect_kmer_observations,
                                            em_train_transitions,
                                            train_gaussian_emissions,
                                            write_hdp_training_file)

MODEL = "/root/reference/models/testModelR9p4_5mer_acegt_template.model"


def _seeded_model():
    """ACGT 5-mer model with r9.4-like levels (utils/synthetic.py)."""
    from signalalign_jax.utils.synthetic import seeded_pore_model
    return seeded_pore_model("ACGT", 5, seed=11)


def _make_synthetic(tmp_path, n_reads=3, seq_len=260, p_stay=0.12, p_skip=0.05,
                    seed=0):
    model = _seeded_model()
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=1200))
    fasta = tmp_path / "ref.fa"
    with open(fasta, "w") as fh:
        fh.write(">chr\n" + genome + "\n")
    reference = ProcessedReference(str(fasta))

    k = model.kmer_length
    rgs = []
    for ri in range(n_reads):
        start = int(rng.integers(50, 800))
        read_seq = genome[start:start + seq_len]
        ids = model.alphabet.seq_to_kmer_ids(read_seq)
        events = []
        event_map = []
        for i, kid in enumerate(ids):
            event_map.append(len(events))
            events.append([rng.normal(model.level_mean[kid],
                                      model.level_sd[kid]),
                          1.0, .002, len(events) * .002])
            while rng.random() < p_stay:
                events.append([rng.normal(model.level_mean[kid],
                                          model.level_sd[kid]),
                              1.0, .002, len(events) * .002])
        event_map.extend([event_map[-1]] * (k - 1))
        events = np.array(events)
        read = NanoporeReadData(
            read_label=f"synt{ri}", template_read=read_seq,
            events=events, event_map=np.array(event_map),
            model_states=None, p_model_state=None, kmer_length=k,
            params=ScalingParams(), rna=False)
        guide = GuideAlignment(
            contig="chr", forward=True, window_start=start,
            window_end=start + seq_len, query_start=0, query_end=seq_len,
            ops=[(seq_len, "M")])
        rgs.append((read, guide))
    return model, reference, rgs


def test_em_transitions_likelihood_nondecreasing(tmp_path):
    model, reference, rgs = _make_synthetic(tmp_path)
    res = em_train_transitions(rgs, reference, model, iterations=3,
                               config=AlignmentConfig(diagonal_expansion=12),
                               assert_monotonic=False)
    assert len(res.log_likelihoods) == 3
    # the true log-likelihood improves overall (per-iteration wiggle is
    # possible because the end distribution is tied to the transitions but
    # excluded from the expectations — same approximation as upstream)
    assert res.log_likelihoods[-1] >= res.log_likelihoods[0]
    # transitions are proper distributions
    for probs in res.transitions_history:
        np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-9)
    # stay-heavy generator -> learned m->y probability reflects stays
    final = res.transitions_history[-1]
    assert 0.02 < final[0, 2] < 0.4


def test_em_likelihood_does_not_decrease_over_two_iterations(tmp_path):
    """Two EM iterations from the generating model: the second E-step's
    log-likelihood is no lower than the first (em_train's own
    assert_monotonic check, trainModels.py:966-979 test mode)."""
    from signalalign_jax.pipeline.train import em_train
    model, reference, rgs = _make_synthetic(tmp_path, n_reads=2, seed=5)
    res = em_train(rgs, reference, model, iterations=2,
                   config=AlignmentConfig(diagonal_expansion=12),
                   update_transitions=True, assert_monotonic=True)
    assert len(res.log_likelihoods) == 2
    assert np.isfinite(res.log_likelihoods).all()
    assert res.log_likelihoods[1] >= res.log_likelihoods[0]


def test_gaussian_emission_update(tmp_path):
    model, reference, rgs = _make_synthetic(tmp_path, n_reads=2)
    results = run_alignment_batch(rgs, reference, model,
                                  AlignmentConfig(diagonal_expansion=12))
    obs = collect_kmer_observations(results, model, threshold=0.5)
    assert len(obs) > 50
    shifted = _seeded_model()
    shifted.level_mean = shifted.level_mean + 2.0  # corrupt the model
    trained = train_gaussian_emissions(obs, shifted, prior_weight=1.0)
    # kmers with many observations move back toward the true means
    true = _seeded_model()
    moved = total = 0
    for kmer, data in obs.items():
        if len(data) < 2:
            continue
        total += 1
        idx = true.alphabet.kmer_index(kmer)
        before = abs(shifted.level_mean[idx] - true.level_mean[idx])
        after = abs(trained.level_mean[idx] - true.level_mean[idx])
        if after < before:
            moved += 1
    assert total >= 5
    assert moved / total > 0.7


def test_em_train_unified_emissions(tmp_path):
    """Unified EM: one device expectation pass updates transitions AND
    Gaussian emissions; expectations files + per-iteration checkpoints
    round-trip (VERDICT r1 item 3)."""
    import copy

    from signalalign_jax.models.expectations import ExpectationsAccumulator
    from signalalign_jax.pipeline.train import em_train

    model, reference, rgs = _make_synthetic(tmp_path, n_reads=3)
    shifted = copy.deepcopy(model)
    # corrupt per-kmer means with ZERO-MEAN noise: a global shift would be
    # absorbed by the per-read WLS scaling re-fit (ESTIMATE_PARAMS, same as
    # the reference), so EM can only recover kmer-relative deviations
    noise_rng = np.random.default_rng(99)
    noise = noise_rng.normal(0.0, 1.5, size=shifted.level_mean.shape)
    shifted.level_mean = shifted.level_mean + noise

    # prior-weighted EM over 2 iterations: likelihood recovers once the
    # emissions move (the raw normalize M-step would collapse the sd of
    # sparsely-observed kmers -- same failure the reference avoids by
    # training emissions with a prior weight)
    res = em_train(rgs, reference, shifted, iterations=2,
                   config=AlignmentConfig(diagonal_expansion=12),
                   update_transitions=True, update_emissions=True,
                   emission_prior_weight=5.0,
                   checkpoint_dir=str(tmp_path), write_expectations=True)
    assert len(res.expectations_files) == 2
    assert len(res.checkpoint_files) == 2
    assert res.log_likelihoods[-1] > res.log_likelihoods[0]

    # emissions moved toward the generative truth for well-observed kmers
    # that started meaningfully wrong (near-correct kmers can only wander)
    kexp = res.kexp_history[0]
    err0 = np.abs(shifted.level_mean - model.level_mean)
    heavy = np.where((kexp[0] > 3.0) & (err0 > 0.75))[0]
    assert len(heavy) >= 10
    trained = res.model
    before = err0[heavy]
    after = np.abs(trained.level_mean[heavy] - model.level_mean[heavy])
    assert (after < before).mean() > 0.7
    assert after.mean() < before.mean() * 0.8

    # pure-normalize single iteration: the expectations file reproduces the
    # checkpoint through the reference accumulate+normalize path
    res1 = em_train(rgs, reference, shifted, iterations=1,
                    config=AlignmentConfig(diagonal_expansion=12),
                    update_transitions=True, update_emissions=True,
                    checkpoint_dir=str(tmp_path / ""),
                    checkpoint_prefix="pure", write_expectations=True)
    acc = ExpectationsAccumulator(copy.deepcopy(shifted))
    assert acc.add_file(res1.expectations_files[0])
    m2 = acc.apply(update_transitions=True, update_emissions=True)
    ck0 = PoreModel.from_file(res1.checkpoint_files[0])
    np.testing.assert_allclose(m2.level_mean, ck0.level_mean, atol=1e-4)
    np.testing.assert_allclose(m2.level_sd, ck0.level_sd, atol=1e-4)
    np.testing.assert_allclose(np.asarray(m2.transitions, dtype=float),
                               np.asarray(ck0.transitions, dtype=float),
                               atol=1e-6)


def test_em_train_training_bases_trim(tmp_path):
    """training_bases caps each E-step to a read subset
    (trainModels.py:1144 / filter_reads trim semantics)."""
    from signalalign_jax.pipeline.train import em_train

    model, reference, rgs = _make_synthetic(tmp_path, n_reads=3)
    one_read_bases = rgs[0][0].read_length
    res = em_train(rgs, reference, model, iterations=1,
                   config=AlignmentConfig(diagonal_expansion=12),
                   training_bases=one_read_bases - 1)
    full = em_train(rgs, reference, model, iterations=1,
                    config=AlignmentConfig(diagonal_expansion=12))
    # trimmed run used fewer reads -> strictly less posterior mass
    assert res.kexp_history[0][0].sum() < full.kexp_history[0][0].sum()


def test_hdp_training_file(tmp_path):
    obs = {"AAAAA": np.array([80.0, 81.0]), "ACGTA": np.array([95.5])}
    path = write_hdp_training_file(obs, str(tmp_path / "build.tsv"))
    lines = open(path).read().strip().split("\n")
    assert len(lines) == 3
    assert lines[0].split("\t") == ["AAAAA", "t", "80.000000"]


def test_build_alignment_from_tsvs(tmp_path):
    """Top-N heap over SA full-output rows (build_alignments.py)."""
    from signalalign_jax.models.pore_model import PoreModel
    from signalalign_jax.pipeline.train import build_alignment_from_tsvs

    golden = ("/root/reference/tests/test_alignments/"
              "ecoli1D_test_alignments_sm3/"
              "6deaf971-6506-4e37-b486-cdf5e9d416ac.sm.forward.tsv")
    model = PoreModel.from_file(
        "/root/reference/models/testModelR9p4_5mer_acegt_template.model")
    out = build_alignment_from_tsvs(
        [golden], model, str(tmp_path / "build.tsv"),
        max_per_kmer=5, min_probability=0.9)
    from collections import Counter
    counts = Counter()
    probs = {}
    for line in open(out):
        kmer, strand, descaled, prob = line.split("\t")
        counts[kmer] += 1
        probs.setdefault(kmer, []).append(float(prob))
        assert strand == "t"
        assert float(prob) >= 0.9
    assert counts and max(counts.values()) <= 5
    # per-kmer rows are prob-descending (heap nlargest order)
    for k, ps in probs.items():
        assert ps == sorted(ps, reverse=True)


def test_complement_strand_em_train():
    """2D complement-strand EM (trainModels twoD path): complement reads
    from the pUC 2D fast5s train the complement model with
    strand_template=False plumbed through the runner."""
    from signalalign_jax.io.minialign import generate_guide_alignment
    from signalalign_jax.io.read import NanoporeRead2DData
    from signalalign_jax.pipeline.train import em_train
    cmodel = PoreModel.from_file(
        "/root/reference/models/testModelR9_5mer_acegot_complement.model")
    reference = ProcessedReference(
        "/root/reference/tests/test_sequences/pUC19_SspI.fa")
    import glob
    paths = sorted(glob.glob(
        "/root/reference/tests/minion_test_reads/pUC/*.fast5"))[:1]
    c_rgs = []
    for f5 in paths:
        read2d = NanoporeRead2DData.from_fast5(f5)
        guide = generate_guide_alignment(read2d.twod_sequence, reference)
        assert guide and guide.validate(len(read2d.twod_sequence))
        c_rgs.append((read2d.complement, guide))
    res = em_train(c_rgs, reference, cmodel, iterations=1,
                   strand_template=False)
    assert np.isfinite(res.log_likelihoods[0])
    tr = res.transitions_history[0]
    assert tr.shape == (3, 3)
    np.testing.assert_allclose(tr.sum(axis=1), 1.0, atol=1e-6)


def test_cli_train_multi_sample(tmp_path):
    """samples[] config blocks pool their reads into one EM batch."""
    import json
    import sys as _sys
    from signalalign_jax import cli
    oned = "/root/reference/tests/minion_test_reads/1D"
    # reconstruct the genome window fasta (conftest ecoli pattern)
    from signalalign_jax.io.sam import read_bam, reconstruct_reference_window
    _, records = read_bam(os.path.join(oned, "1D.bam"))
    genome = np.full(4641652, ord("A"), dtype=np.uint8)
    for rec in records:
        w = reconstruct_reference_window(rec)
        genome[rec.pos:rec.pos + len(w)] = np.frombuffer(
            w.encode("latin-1"), dtype=np.uint8)
    fa = tmp_path / "ecoli.fa"
    with open(fa, "w") as fh:
        fh.write(">gi_ecoli\n" + genome.tobytes().decode("latin-1") + "\n")
    sample = {"alignment_file": os.path.join(oned, "1D.bam"),
              "readdb": os.path.join(oned, "1D.fastq.index.readdb"),
              "fast5_dirs": [oned]}
    cfg = {"samples": [sample, dict(sample)],
           "reference": str(fa),
           "template_hmm_model": MODEL,
           "training": {"transitions": True, "em_iterations": 1},
           "output_dir": str(tmp_path / "out")}
    cfgp = tmp_path / "cfg.json"
    cfgp.write_text(json.dumps(cfg))
    argv = ["cli", "train", "--config", str(cfgp), "--max_reads", "4"]
    old_argv = _sys.argv
    _sys.argv = argv
    try:
        assert cli.main() == 0
    finally:
        _sys.argv = old_argv
    assert os.path.exists(tmp_path / "out" / "template_trained.model")


def test_em_train_three_state_hdp():
    """threeStateHdp transition EM: expectations accumulated under HDP
    emissions (HdpHmm semantics, trainModels stateMachineType)."""
    from signalalign_jax.io.guide import GuideAlignment
    from signalalign_jax.ops import banded_fb as bfb
    from signalalign_jax.pipeline.signal_align import AlignmentConfig
    from signalalign_jax.pipeline.train import em_train
    from signalalign_jax.utils.synthetic import seeded_hdp
    model = _seeded_model()
    hdp = seeded_hdp(model, grid_length=400)
    rng = np.random.default_rng(2)
    genome = "".join(rng.choice(list("ACGT"), size=600))
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        fa = os.path.join(d, "ref.fa")
        with open(fa, "w") as fh:
            fh.write(">chr\n" + genome + "\n")
        reference = ProcessedReference(fa)
        k = model.kmer_length
        rgs = []
        for ri in range(2):
            start = 50 + 120 * ri
            seq = genome[start:start + 180]
            ids = model.alphabet.seq_to_kmer_ids(seq)
            events, emap = [], []
            for kid in ids:
                emap.append(len(events))
                events.append([rng.normal(model.level_mean[kid], 1.5),
                               1.0, .002, len(events) * .002])
            emap.extend([emap[-1]] * (k - 1))
            read = NanoporeReadData(
                read_label=f"hdp{ri}", template_read=seq,
                events=np.array(events), event_map=np.array(emap),
                model_states=None, p_model_state=None, kmer_length=k,
                params=ScalingParams(var=1.05), rna=False)
            rgs.append((read, GuideAlignment(
                contig="chr", forward=True, window_start=start,
                window_end=start + 180, query_start=0, query_end=180,
                ops=[(180, "M")])))
        res = em_train(rgs, reference, model, iterations=1, hdp=hdp,
                       config=AlignmentConfig(emission_mode=bfb.MODE_HDP))
        assert np.isfinite(res.log_likelihoods[0])
        tr = res.transitions_history[0]
        np.testing.assert_allclose(tr.sum(axis=1), 1.0, atol=1e-6)


def test_cli_train_hdp_per_sample_motifs(tmp_path):
    """CLI HDP training-data assembly applies EACH sample's motifs when
    labelling its kmers (CreateHdpTrainingData per-sample substitution,
    /root/reference/src/signalalign/train/trainModels.py:427-520 +
    samples[] motifs schema README.md:185-203): a canonical + an mC
    sample (motifs CG->EG) train an HDP whose E-kmers are populated —
    through `cli train`, not hand-built tables."""
    import json
    import sys as _sys

    from signalalign_jax import cli
    oned = "/root/reference/tests/minion_test_reads/1D"
    from signalalign_jax.io.sam import read_bam, reconstruct_reference_window
    _, records = read_bam(os.path.join(oned, "1D.bam"))
    genome = np.full(4641652, ord("A"), dtype=np.uint8)
    for rec in records:
        w = reconstruct_reference_window(rec)
        genome[rec.pos:rec.pos + len(w)] = np.frombuffer(
            w.encode("latin-1"), dtype=np.uint8)
    fa = tmp_path / "ecoli.fa"
    with open(fa, "w") as fh:
        fh.write(">gi_ecoli\n" + genome.tobytes().decode("latin-1") + "\n")
    canonical = {"name": "canonical",
                 "alignment_file": os.path.join(oned, "1D.bam"),
                 "readdb": os.path.join(oned, "1D.fastq.index.readdb"),
                 "fast5_dirs": [oned],
                 "probability_threshold": 0.8,
                 "number_of_kmer_assignments": 30}
    mc = dict(canonical)
    mc.update({"name": "mC", "motifs": [["CG", "EG"]]})
    cfg = {"samples": [canonical, mc],
           "reference": str(fa),
           "template_hmm_model": MODEL,
           "training": {"transitions": False, "hdp_emissions": True,
                        "hdp_type": "singleLevelFixed",
                        "max_assignments": 30, "gibbs_samples": 10},
           "hdp_args": {"grid_start": 30.0, "grid_end": 180.0,
                        "grid_length": 120, "burnin_multiplier": 2,
                        "thinning": 10},
           "output_dir": str(tmp_path / "out")}
    cfgp = tmp_path / "cfg.json"
    cfgp.write_text(json.dumps(cfg))
    # 1D dir holds 3 reads; max_reads 4 -> 3 canonical + 1 mC read
    argv = ["cli", "train", "--config", str(cfgp), "--max_reads", "4"]
    old_argv = _sys.argv
    _sys.argv = argv
    try:
        assert cli.main() == 0
    finally:
        _sys.argv = old_argv
    # the buildAlignment table must carry E-labelled kmers from the mC
    # sample AND canonical kmers from the canonical sample
    build = tmp_path / "out" / "buildAlignment.tsv"
    assert build.exists()
    kmers = [line.split("\t")[0] for line in open(build)]
    e_kmers = {k for k in kmers if "E" in k}
    assert len(e_kmers) > 5, "mC sample produced no E-labelled rows"
    assert any("E" not in k for k in kmers)
    # and the trained HDP populates those E-kmer distributions
    from signalalign_jax.models.hdp_model import load_nhdp
    hdp = load_nhdp(str(tmp_path / "out" / "template.nhdp"))
    n_e_obs = int(sum(
        hdp.observed[i] for i in range(hdp.alphabet.num_kmers)
        if "E" in hdp.alphabet.index_to_kmer(i)))
    assert n_e_obs > 5

"""2D read support: alignment-table assembly, both-strand alignment, and
golden comparison against the upstream pUC 5-mer outputs
(tests/test_alignments/pUC_5mer_tempFiles_alignment). The guide alignment
comes from the built-in Smith-Waterman (bwa stand-in), so the DP band can
differ slightly from the golden run's BWA guide; rows that land on the same
(ref, event) cell must agree exactly on k-mer and event means.
"""

import glob

import numpy as np
import pandas as pd
import pytest

from signalalign_jax.io.minialign import generate_guide_alignment
from signalalign_jax.io.read import NanoporeRead2DData, assemble_2d_sequence
from signalalign_jax.io.reference import ProcessedReference
from signalalign_jax.models.pore_model import PoreModel
from signalalign_jax.pipeline import signal_align as sa

PUC_DIR = "/root/reference/tests/minion_test_reads/pUC"
PUC_REF = "/root/reference/tests/test_sequences/pUC19_SspI.fa"
T_MODEL = "/root/reference/models/testModelR9_5mer_acegot_template.model"
C_MODEL = "/root/reference/models/testModelR9_5mer_acegot_complement.model"
GOLD_DIR = "/root/reference/tests/test_alignments/pUC_5mer_tempFiles_alignment"

GOLD_COLS = ["contig", "ref", "kmer", "read", "strand", "ev", "evmean",
             "evnoise", "evdur", "alnkmer", "scaledE", "scaledN", "p",
             "descaled", "Emean", "pathkmer"]


def test_assemble_2d_sequence():
    # overlapping kmers merge by maximal overlap; repeats collapse
    assert assemble_2d_sequence(["ACGTA", "CGTAC", "CGTAC", "TACGG"]) \
        == "ACGTACGG"


@pytest.fixture(scope="module")
def aligned():
    reference = ProcessedReference(PUC_REF)
    tm = PoreModel.from_file(T_MODEL)
    cm = PoreModel.from_file(C_MODEL)
    path = sorted(glob.glob(PUC_DIR + "/*.fast5"))[0]
    read = NanoporeRead2DData.from_fast5(path)
    assert read.read_label == "c7815baf-a99a-4682-a146-976aa91a35a2"
    guide = generate_guide_alignment(read.twod_sequence, reference)
    assert guide is not None and not guide.forward
    t, c = sa.align_read_2d(read, guide, reference, tm, cm)
    return read, guide, t, c, tm, cm, reference


def test_event_maps_monotonic(aligned):
    read = aligned[0]
    assert np.all(np.diff(read.template.event_map) >= 0)
    assert np.all(np.diff(read.complement.event_map) >= 0)
    assert len(read.template.event_map) == len(read.twod_sequence)


def test_both_strand_kmers_equal_reference(aligned):
    _, _, t, c, tm, cm, reference = aligned
    fwd = reference.forward["pUC19"]
    for rows, mdl in ((t.full_rows(tm), tm), (c.full_rows(cm), cm)):
        assert rows
        for r in rows:
            assert fwd[r.reference_index:r.reference_index + 5] \
                == r.reference_kmer


def test_matches_golden_both_strands(aligned):
    read, _, t, c, tm, cm, _ = aligned
    gold = pd.read_csv(f"{GOLD_DIR}/{read.read_label}.sm.backward.tsv",
                       sep="\t", names=GOLD_COLS)
    for strand, res, mdl, min_frac, p_tol in (
            ("t", t, tm, 0.8, 0.02), ("c", c, cm, 0.55, 0.03)):
        gs = gold[gold.strand == strand]
        mine = pd.DataFrame(
            [(r.reference_index, r.event_index, r.reference_kmer,
              r.posterior_probability, r.descaled_event_mean, r.event_mean)
             for r in res.full_rows(mdl)],
            columns=["ref", "ev", "kmer", "p", "descaled", "evmean"])
        m = mine.merge(gs, on=["ref", "ev"], suffixes=("_m", "_g"))
        assert len(m) > min_frac * len(gs)
        assert (m.kmer_m == m.kmer_g).all()
        assert (m.evmean_m - m.evmean_g).abs().max() < 1e-4
        assert (m.descaled_m - m.descaled_g).abs().max() < 1e-4
        assert (m.p_m - m.p_g).abs().median() < p_tol


def test_zymo_r73_2d_vs_golden():
    """R7.3-era 2D fast5 (1.15 layout: events under Basecall_2D_000, read id
    under EventDetection Reads, 'weights' instead of p_model_state) against
    the shipped zymo golden."""
    import glob

    from signalalign_jax.io.minialign import generate_guide_alignment

    ref = ProcessedReference(
        "/root/reference/tests/test_sequences/zymo_sequence.fasta")
    tm = PoreModel.from_file(
        "/root/reference/models/testModelR73_acegt_template.model")
    cm = PoreModel.from_file(
        "/root/reference/models/testModelR73_acegt_complement.model")
    path = [p for p in glob.glob(
        "/root/reference/tests/minion_test_reads/C/*.fast5")
        if "ch173" in p][0]
    read = NanoporeRead2DData.from_fast5(path)
    assert read.read_label == "21d8690f-d748-43c8-b459-e2c9f3f26908"
    assert read.kmer_length == 6
    guide = generate_guide_alignment(read.twod_sequence, ref)
    assert guide is not None and not guide.forward
    t, c = sa.align_read_2d(read, guide, ref, tm, cm)
    gold = pd.read_csv(glob.glob(
        "/root/reference/tests/test_alignments/zymo_C_test_alignments_sm3/"
        "tempFiles_alignment/21d8690f-*.tsv")[0], sep="\t", names=GOLD_COLS)
    for strand, res, mdl, min_frac in (("t", t, tm, 0.85),
                                       ("c", c, cm, 0.3)):
        gs = gold[gold.strand == strand]
        mine = pd.DataFrame(
            [(r.reference_index, r.event_index, r.reference_kmer,
              r.posterior_probability, r.event_mean)
             for r in res.full_rows(mdl)],
            columns=["ref", "ev", "kmer", "p", "evmean"])
        m = mine.merge(gs, on=["ref", "ev"], suffixes=("_m", "_g"))
        assert len(m) > min_frac * len(gs)
        assert (m.kmer_m == m.kmer_g).all()
        assert (m.evmean_m - m.evmean_g).abs().max() < 1e-4
        assert (m.p_m - m.p_g).abs().median() < 0.02


def test_puc_forward_read_vs_golden():
    """Forward-mapped pUC 2D read (complement ref frame = revcomp window,
    shift = window_end) against its golden."""
    import glob

    from signalalign_jax.io.minialign import generate_guide_alignment

    reference = ProcessedReference(PUC_REF)
    tm = PoreModel.from_file(T_MODEL)
    cm = PoreModel.from_file(C_MODEL)
    path = [p for p in sorted(glob.glob(PUC_DIR + "/*.fast5"))
            if "read176" in p][0]
    read = NanoporeRead2DData.from_fast5(path)
    assert read.read_label.startswith("03274a9a")
    guide = generate_guide_alignment(read.twod_sequence, reference)
    assert guide is not None and guide.forward
    t, c = sa.align_read_2d(read, guide, reference, tm, cm)
    gold = pd.read_csv(f"{GOLD_DIR}/03274a9a-0eab-422e-ace7-b35fd3a0f48c"
                       ".sm.forward.tsv", sep="\t", names=GOLD_COLS)
    for strand, res, mdl, min_frac, p_tol in (("t", t, tm, 0.85, 0.02),
                                              ("c", c, cm, 0.6, 0.05)):
        gs = gold[gold.strand == strand]
        mine = pd.DataFrame(
            [(r.reference_index, r.event_index, r.reference_kmer,
              r.posterior_probability, r.event_mean)
             for r in res.full_rows(mdl)],
            columns=["ref", "ev", "kmer", "p", "evmean"])
        m = mine.merge(gs, on=["ref", "ev"], suffixes=("_m", "_g"))
        assert len(m) > min_frac * len(gs)
        assert (m.kmer_m == m.kmer_g).all()
        assert (m.evmean_m - m.evmean_g).abs().max() < 1e-4
        assert (m.p_m - m.p_g).abs().median() < p_tol


def test_hdp_mode_e2e_zymo():
    """threeStateHdp inference on a real read with the shipped .nhdp
    (a sparse test HDP: 351 observed kmers; unobserved fall back to the
    base distribution, so posteriors are diffuse but valid)."""
    import glob

    from signalalign_jax.io.minialign import generate_guide_alignment
    from signalalign_jax.models.hdp_model import load_nhdp
    from signalalign_jax.ops import banded_fb as bfb

    ref = ProcessedReference(
        "/root/reference/tests/test_sequences/zymo_sequence.fasta")
    tm = PoreModel.from_file(
        "/root/reference/models/testModelR73_acegot_template.model")
    hdp = load_nhdp(
        "/root/reference/models/templateSingleLevelFixed.nhdp")
    path = [p for p in glob.glob(
        "/root/reference/tests/minion_test_reads/C/*.fast5")
        if "ch173" in p][0]
    read = NanoporeRead2DData.from_fast5(path)
    guide = generate_guide_alignment(read.twod_sequence, ref)
    cfg = sa.AlignmentConfig(emission_mode=bfb.MODE_HDP)
    res = sa.align_read(read.template, guide, ref, tm, cfg, hdp=hdp)
    rows = res.full_rows(tm)
    assert len(rows) > 500
    assert res.score > 0
    fwd = ref.forward["ZYMO"]
    for r in rows:
        assert fwd[r.reference_index:r.reference_index + 6] \
            == r.reference_kmer

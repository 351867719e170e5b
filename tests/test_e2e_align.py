"""End-to-end alignment of a real bundled MinION read, validated against
the golden reference output TSV shipped with the upstream test suite
(tests/test_alignments/ecoli1D_test_alignments_sm3) and the upstream e2e
test's own properties (test_runSignalAlign.py:100-142: every output k-mer
equals the reference slice at its reported position; row count within
[1x, 3x] of the read's event count).
"""

import os

import numpy as np
import pandas as pd
import pytest

from signalalign_jax.io.guide import guide_from_sam_record
from signalalign_jax.io.read import NanoporeReadData
from signalalign_jax.io.reference import ProcessedReference
from signalalign_jax.io.sam import filter_reads
from signalalign_jax.models.pore_model import PoreModel
from signalalign_jax.pipeline import signal_align as sa

ONED = "/root/reference/tests/minion_test_reads/1D"
GOLDEN = ("/root/reference/tests/test_alignments/ecoli1D_test_alignments_sm3/"
          "6deaf971-6506-4e37-b486-cdf5e9d416ac.sm.forward.tsv")
MODEL = "/root/reference/models/testModelR9p4_5mer_acegt_template.model"

GOLD_COLS = ["contig", "ref", "kmer", "read", "strand", "ev", "evmean",
             "evnoise", "evdur", "alnkmer", "scaledE", "scaledN", "p",
             "descaled", "Emean", "pathkmer"]


@pytest.fixture(scope="module")
def aligned(ecoli_fasta):
    reference = ProcessedReference(ecoli_fasta)
    model = PoreModel.from_file(MODEL)
    pairs = filter_reads(os.path.join(ONED, "1D.bam"),
                         os.path.join(ONED, "1D.fastq.index.readdb"), [ONED])
    f5, rec = [p for p in pairs if p[1].qname.startswith("6deaf971")][0]
    read = NanoporeReadData.from_fast5(f5)
    guide = guide_from_sam_record(rec)
    result = sa.align_read(read, guide, reference, model,
                           sa.AlignmentConfig(compute_expectations=True))
    return read, result, model, reference


def test_row_count_within_reference_bounds(aligned):
    read, result, model, _ = aligned
    n = len(result.aligned_pairs)
    assert read.n_events <= n <= 3 * read.n_events


def test_output_kmers_equal_reference(aligned):
    _, result, model, reference = aligned
    rows = result.full_rows(model)
    fwd = reference.forward["gi_ecoli"]
    for r in rows:
        assert fwd[r.reference_index:r.reference_index + model.kmer_length] \
            == r.reference_kmer


def test_matches_golden_tsv(aligned):
    _, result, model, _ = aligned
    rows = result.full_rows(model)
    mine = pd.DataFrame(
        [(r.reference_index, r.event_index, r.reference_kmer,
          r.posterior_probability, r.descaled_event_mean, r.event_mean,
          r.scaled_mean_current) for r in rows],
        columns=["ref", "ev", "kmer", "p", "descaled", "evmean", "scaledE"])
    gold = pd.read_csv(GOLDEN, sep="\t", names=GOLD_COLS)
    m = mine.merge(gold, on=["ref", "ev"], suffixes=("_m", "_g"))
    # most cells shared
    assert len(m) > 0.8 * len(gold)
    assert (m.kmer_m == m.kmer_g).all()
    # exact agreement of the scaling/coordinate pipeline
    assert (m.evmean_m - m.evmean_g).abs().max() < 1e-4
    assert (m.descaled_m - m.descaled_g).abs().max() < 1e-4
    assert (m.scaledE_m - m.scaledE_g).abs().max() < 1e-4
    # posterior agreement within cross-implementation tolerance (the
    # upstream chunked-traceback backward re-initialisation is approximate)
    dp = (m.p_m - m.p_g).abs()
    assert dp.median() < 0.01
    assert dp.mean() < 0.04


def test_expectations_shape_and_mass(aligned):
    read, result, _, _ = aligned
    texp = result.transition_expectations
    assert texp.shape == (3, 3)
    # total transition mass ~ number of DP steps (events + kmers scale)
    assert texp.sum() > read.n_events * 0.5
    assert texp[1, 2] == 0 and texp[2, 1] == 0


def test_reverse_strand_read(ecoli_fasta):
    """Reverse-mapped read: coordinates and kmers must still line up."""
    reference = ProcessedReference(ecoli_fasta)
    model = PoreModel.from_file(MODEL)
    pairs = filter_reads(os.path.join(ONED, "1D.bam"),
                         os.path.join(ONED, "1D.fastq.index.readdb"), [ONED])
    f5, rec = [p for p in pairs if p[1].qname.startswith("5cc86bac")][0]
    assert rec.is_reverse
    read = NanoporeReadData.from_fast5(f5)
    guide = guide_from_sam_record(rec)
    result = sa.align_read(read, guide, reference, model, sa.AlignmentConfig())
    assert read.n_events * 0.9 <= len(result.aligned_pairs) <= 3 * read.n_events
    rows = result.full_rows(model)
    fwd = reference.forward["gi_ecoli"]
    for r in rows:
        assert fwd[r.reference_index:r.reference_index + model.kmer_length] \
            == r.reference_kmer
    # compare to the reverse-strand golden file
    gold = pd.read_csv(GOLDEN.replace("6deaf971-6506-4e37-b486-cdf5e9d416ac.sm.forward",
                                      "5cc86bac-79fd-4897-8631-8f1c55954a45.sm.backward"),
                       sep="\t", names=GOLD_COLS)
    mine = pd.DataFrame(
        [(r.reference_index, r.event_index, r.reference_kmer,
          r.posterior_probability, r.descaled_event_mean) for r in rows],
        columns=["ref", "ev", "kmer", "p", "descaled"])
    m = mine.merge(gold, on=["ref", "ev"], suffixes=("_m", "_g"))
    assert len(m) > 0.75 * len(gold)
    assert (m.kmer_m == m.kmer_g).all()
    assert (m.descaled_m - m.descaled_g).abs().max() < 1e-4
    assert (m.p_m - m.p_g).abs().median() < 0.01

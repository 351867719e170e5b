"""RNA end-to-end alignment of the bundled RNA edge-case read.

Validated against the upstream RNA e2e property
(test_runSignalAlign.py:176-194 + check_alignments: for RNA every output
k-mer equals the REVERSED reference slice at its reported position) and the
golden TSV shipped in tests/test_alignments/RNA_edge_case_tempFiles_alignment.

The golden run aligned against a pre-reversed reference contig
("rna_fake_reversed"), so its coordinates are in the reversed frame:
golden position g maps to forward-fasta kmer start (L - k) - g with
L=1086, k=5, i.e. 1081 - g; kmers and event indices are unchanged.
"""

import os

import pandas as pd
import pytest

from signalalign_jax.io.guide import guide_from_sam_record
from signalalign_jax.io.read import NanoporeReadData
from signalalign_jax.io.reference import ProcessedReference
from signalalign_jax.io.sam import filter_reads
from signalalign_jax.models.pore_model import PoreModel
from signalalign_jax.pipeline import signal_align as sa

RNA_DIR = "/root/reference/tests/minion_test_reads/RNA_edge_cases"
RNA_REF = "/root/reference/tests/test_sequences/fake_rna_ref.fa"
MODEL = "/root/reference/models/testModelR9p4_5mer_acgt_RNA.model"
GOLDEN = ("/root/reference/tests/test_alignments/"
          "RNA_edge_case_tempFiles_alignment/"
          "7d31de25-8c15-46d8-a08c-3d5043258c89.sm.forward.tsv")

GOLD_COLS = ["contig", "ref", "kmer", "read", "strand", "ev", "evmean",
             "evnoise", "evdur", "alnkmer", "scaledE", "scaledN", "p",
             "descaled", "Emean", "pathkmer"]


@pytest.fixture(scope="module")
def aligned():
    reference = ProcessedReference(RNA_REF)
    model = PoreModel.from_file(MODEL)
    pairs = filter_reads(os.path.join(RNA_DIR, "rna_reads.bam"),
                         os.path.join(RNA_DIR, "rna_reads.readdb"), [RNA_DIR])
    f5, rec = [p for p in pairs if p[1].qname.startswith("7d31de25")][0]
    read = NanoporeReadData.from_fast5(f5)
    assert read.rna
    guide = guide_from_sam_record(rec)
    result = sa.align_read(read, guide, reference, model,
                           sa.AlignmentConfig())
    return read, result, model, reference


def test_uses_resegmented_events(aligned):
    read, _, _, _ = aligned
    # the fast5's Basecall_1D table is index-scale; the embedded
    # re-segmented (time-scale) table must be picked up instead
    assert read.n_events == 2151


def test_row_count_within_reference_bounds(aligned):
    read, result, _, _ = aligned
    n = len(result.aligned_pairs)
    assert read.n_events * 0.5 <= n <= 3 * read.n_events


def test_output_kmers_equal_reversed_reference(aligned):
    """check_alignments rna branch: exp_kmer = ref[pos:pos+k][::-1]."""
    _, result, model, reference = aligned
    rows = result.full_rows(model)
    assert rows
    fwd = reference.forward["rna_fake"]
    k = model.kmer_length
    for r in rows:
        assert fwd[r.reference_index:r.reference_index + k][::-1] \
            == r.reference_kmer


def test_matches_golden_tsv(aligned):
    """The golden run used an event segmentation that is not shipped in the
    fast5 (its event means appear in neither embedded table), so per-event
    equality is impossible; instead require the per-position signal summary
    to agree: both runs cover the same reference window, report the same
    k-mers, and their posterior-weighted descaled currents track closely."""
    _, result, model, _ = aligned
    rows = result.full_rows(model)
    mine = pd.DataFrame(
        [(r.reference_index, r.reference_kmer,
          r.posterior_probability, r.descaled_event_mean) for r in rows],
        columns=["ref", "kmer", "p", "descaled"])
    gold = pd.read_csv(GOLDEN, sep="\t", names=GOLD_COLS)
    # reversed-reference frame -> forward frame
    gold["ref"] = 1081 - gold["ref"]
    assert set(gold.ref) == set(mine.ref)
    gk = gold.groupby("ref").kmer.first()
    mk = mine.groupby("ref").kmer.first()
    assert (gk == mk).all()

    def weighted(df):
        df = df[df.p > 0.2]
        g = df.groupby("ref")
        return g.apply(lambda d: (d.descaled * d.p).sum() / d.p.sum(),
                       include_groups=False)

    j = pd.concat([weighted(gold), weighted(mine)], axis=1,
                  keys=["g", "m"]).dropna()
    assert len(j) > 350
    d = (j.m - j.g).abs()
    assert d.median() < 2.5          # pA, model levels are ~60-130 pA
    assert (d < 8.0).mean() > 0.85
    assert j.m.corr(j.g) > 0.95

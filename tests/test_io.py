"""I/O layer tests against the bundled reference test data."""

import glob
import os

import numpy as np
import pytest

from signalalign_jax.io.fast5 import Fast5
from signalalign_jax.io.guide import find_guide_alignment, guide_from_sam_record
from signalalign_jax.io.read import NanoporeReadData, make_event_map, mean_fastq_quality
from signalalign_jax.io.reference import ProcessedReference, load_fasta
from signalalign_jax.io.sam import filter_reads, read_bam
from signalalign_jax.utils.alphabet import reverse_complement

TESTS = "/root/reference/tests"
ONED = os.path.join(TESTS, "minion_test_reads/1D")


@pytest.fixture(scope="module")
def oned_fast5s():
    return sorted(glob.glob(os.path.join(ONED, "*.fast5")))


def test_fast5_basic(oned_fast5s):
    with Fast5(oned_fast5s[0]) as f5:
        assert f5.read_id
        assert not f5.is_rna()
        raw = f5.raw_signal_pA()
        assert raw.ndim == 1 and len(raw) > 1000
        assert 0 < raw.mean() < 300  # plausible pA values
        analysis = f5.latest_analysis()
        assert analysis is not None
        events = f5.template_events(analysis)
        assert events is not None and len(events) > 100
        fq = f5.template_fastq(analysis)
        assert fq.startswith("@")


def test_make_event_map_simple():
    moves = np.array([0, 1, 0, 2, 1])
    probs = np.array([0.5, 0.6, 0.7, 0.2, 0.9])
    # k=3, bases = 1 + moves sum = 1+1+0+2+1 = 5 bases + (k-1) padding = 7
    em = make_event_map(moves, probs, 5 + 2, 3)
    # i=2 (move 0, higher prob) replaces the last entry; i=3 (move 2) fills
    # the skipped base with the previous event then appends itself
    assert list(em) == [0, 2, 2, 3, 4, 4, 4]
    assert (np.diff(em) >= 0).all()


def test_nanopore_read_from_fast5(oned_fast5s):
    rd = NanoporeReadData.from_fast5(oned_fast5s[0])
    assert rd.kmer_length in (5, 6)
    assert len(rd.event_map) == rd.read_length
    assert rd.event_map[-1] == rd.event_map[-rd.kmer_length]
    assert (np.diff(rd.event_map) >= 0).all()
    assert rd.events.shape[1] == 4
    assert rd.events[0, 3] == 0.0  # start rebased to 0
    # event means in pA range
    assert 40 < np.mean(rd.events[:, 0]) < 160


def test_read_bam(oned_fast5s):
    refs, records = read_bam(os.path.join(ONED, "1D.bam"))
    recs = list(records)
    assert len(recs) >= 1
    assert any("gi" in (r or "") or len(refs) > 0 for r in refs)
    rec = recs[0]
    assert rec.seq and rec.cigar
    assert rec.reference_span() > len(rec.seq) * 0.8


def test_filter_reads_matches_fast5s(oned_fast5s):
    pairs = filter_reads(os.path.join(ONED, "1D.bam"),
                         os.path.join(ONED, "1D.fastq.index.readdb"),
                         [ONED], quality_threshold=7.0)
    assert len(pairs) >= 1
    for f5, rec in pairs:
        assert os.path.exists(f5)


def test_guide_alignment_anchor_consistency(oned_fast5s, ecoli_fasta):
    """Anchors must pair read bases with target bases that mostly agree."""
    ref = load_fasta(ecoli_fasta)
    pairs = filter_reads(os.path.join(ONED, "1D.bam"),
                         os.path.join(ONED, "1D.fastq.index.readdb"),
                         [ONED], quality_threshold=7.0)
    checked = 0
    for f5path, rec in pairs:
        guide = guide_from_sam_record(rec)
        assert guide is not None
        rd = NanoporeReadData.from_fast5(f5path)
        assert guide.validate(rd.read_length)
        window = ref[guide.contig][guide.window_start:guide.window_end]
        target = window if guide.forward else reverse_complement(window)
        anchors = guide.anchor_pairs(trim=14)
        assert len(anchors) > 100
        agree = 0
        for x, k in anchors[:2000]:
            if target[x] == rd.template_read[k]:
                agree += 1
        frac = agree / min(len(anchors), 2000)
        assert frac > 0.8, f"anchor base agreement too low: {frac}"
        # anchors strictly increasing in both coords
        xs = [a[0] for a in anchors]
        ks = [a[1] for a in anchors]
        assert all(b > a for a, b in zip(xs, xs[1:]))
        assert all(b > a for a, b in zip(ks, ks[1:]))
        checked += 1
    assert checked >= 1


def test_processed_reference_targets(ecoli_fasta):
    pr = ProcessedReference(ecoli_fasta)
    name = next(iter(pr.forward))
    fwd = pr.template_target(name, 100, 160, True)
    assert fwd == pr.forward[name][100:160]
    rev = pr.template_target(name, 100, 160, False)
    assert rev == reverse_complement(pr.forward[name][100:160])


def test_motif_and_substring_utils():
    from signalalign_jax.io.reference import (find_gatc_motifs,
                                              find_substring_indices,
                                              replace_motifs)
    assert replace_motifs("ACCAGGT", [("CCAGG", "CEAGG")]) == "ACEAGGT"
    assert replace_motifs("CCAGGCCTGG",
                          [("CCAGG", "CEAGG"), ("CCTGG", "CETGG")]) \
        == "CEAGGCETGG"
    assert list(find_gatc_motifs("AGATCAGATC")) == [2, 7]
    assert list(find_substring_indices("GGG", "GG")) == [0, 1]
    assert list(find_substring_indices("GGG", "GG", overlap=False)) == [0]


def test_make_positions_file(tmp_path):
    from signalalign_jax.io.reference import (AmbiguityPositions,
                                              ProcessedReference,
                                              make_positions_file)
    fa = tmp_path / "r.fa"
    fa.write_text(">c\nACCAGGTTCCTGGA\n")
    out = make_positions_file(str(fa), str(tmp_path / "p.tsv"),
                              [("CCAGG", "CEAGG"), ("CCTGG", "CETGG")])
    lines = [l.split("\t") for l in open(out).read().strip().split("\n")]
    plus = [l for l in lines if l[2] == "+"]
    minus = [l for l in lines if l[2] == "-"]
    assert [int(l[1]) for l in plus] == [2, 9]
    assert all(l[3] == "C" and l[4] == "E" for l in plus)
    # minus-strand edits: the complement sequence (forward coords) carries
    # the reversed motifs; CCAGG@1 pairs with GGACC editing position 11,
    # CCTGG@8 with GGTCC editing position 4 (emitted per motif)
    assert sorted(int(l[1]) for l in minus) == [4, 11]
    # the generated file round-trips through the positions editor
    pos = AmbiguityPositions.from_file(out)
    ref = ProcessedReference(str(fa), positions=pos)
    assert ref.forward["c"][2] == "E" and ref.forward["c"][9] == "E"


def test_filter_reads_without_readdb():
    from signalalign_jax.io.sam import build_readdb, filter_reads
    d = "/root/reference/tests/minion_test_reads/RNA_edge_cases"
    mapping = build_readdb([d])
    assert any(k.startswith("7d31de25") for k in mapping)
    pairs = filter_reads(os.path.join(d, "rna_reads.bam"), None, [d])
    assert any(rec.qname.startswith("7d31de25") for _, rec in pairs)


def test_target_regions(tmp_path):
    from signalalign_jax.io.guide import GuideAlignment, TargetRegions
    f = tmp_path / "regions.tsv"
    f.write_text("100\t200\n5000\t5100\n")
    tr = TargetRegions(str(f))
    g_in = GuideAlignment("c", True, 50, 300, 0, 250, [(250, "M")])
    g_out = GuideAlignment("c", True, 300, 600, 0, 300, [(300, "M")])
    assert tr.accepts(g_in)
    assert not tr.accepts(g_out)


def test_extract_cli(tmp_path):
    """extract-binary equivalent: fast5 dir -> fastq + index readdb
    (impl/extract.c:23)."""
    from signalalign_jax.cli import main

    out = tmp_path / "reads.fastq"
    rc = main(["extract", "-d",
               "/root/reference/tests/minion_test_reads/1D",
               "-o", str(out)])
    assert rc == 0
    text = out.read_text()
    recs = [l for l in text.splitlines() if l.startswith("@")]
    assert len(recs) >= 3
    db = (tmp_path / "reads.fastq.index.readdb").read_text().splitlines()
    assert len(db) >= 3
    for line in db:
        rid, f5 = line.split("\t")
        assert f5.endswith(".fast5")
    # refuses to overwrite (reference st_errAbort behavior)
    assert main(["extract", "-d",
                 "/root/reference/tests/minion_test_reads/1D",
                 "-o", str(out)]) == 1

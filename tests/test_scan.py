"""Scan-mode single-nucleotide probabilities
(singleNucleotideProbabilities.py equivalent): periodic degenerate
reference -> per-site normalized base probabilities."""

import os

import pytest

from signalalign_jax.io.guide import guide_from_sam_record
from signalalign_jax.io.read import NanoporeReadData
from signalalign_jax.io.sam import filter_reads
from signalalign_jax.models.pore_model import PoreModel
from signalalign_jax.pipeline.scan import (PeriodicReference,
                                           replace_periodic_positions,
                                           scan_single_nucleotide_probabilities)

RNA_DIR = "/root/reference/tests/minion_test_reads/RNA_edge_cases"
RNA_REF = "/root/reference/tests/test_sequences/fake_rna_ref.fa"
MODEL = "/root/reference/models/testModelR9p4_5mer_acgt_RNA.model"


def test_replace_periodic_positions():
    assert replace_periodic_positions("ACGTACGTAC", 4, 1) == "AXGTAXGTAX"
    ref = PeriodicReference(RNA_REF, 10, 3)
    fwd = ref.forward["rna_fake"]
    assert all(fwd[i] == "X" for i in range(3, len(fwd), 10))
    assert fwd.count("X") == len([i for i in range(3, len(fwd), 10)])


def test_scan_rna_read(tmp_path):
    pairs = filter_reads(os.path.join(RNA_DIR, "rna_reads.bam"),
                         os.path.join(RNA_DIR, "rna_reads.readdb"), [RNA_DIR])
    f5, rec = [p for p in pairs if p[1].qname.startswith("7d31de25")][0]
    read = NanoporeReadData.from_fast5(f5)
    guide = guide_from_sam_record(rec)
    model = PoreModel.from_file(MODEL)
    out = scan_single_nucleotide_probabilities(
        [(read, guide)], RNA_REF, model, str(tmp_path),
        step_size=10, offsets=(0, 1), verbose=False)
    assert len(out) == 1
    seq = "".join(l.strip() for l in open(RNA_REF) if not l.startswith(">"))
    good = tot = 0
    rows = 0
    for line in open(out[0]):
        if line.startswith("#"):
            continue
        contig, pos, pa, pc, pg, pt = line.rstrip("\n").split("\t")
        rows += 1
        assert contig == "rna_fake"
        probs = dict(zip("ACGT", map(float, (pa, pc, pg, pt))))
        assert abs(sum(probs.values()) - 1.0) < 1e-6
        pos = int(pos)
        assert pos % 10 in (0, 1)
        if 0 <= pos < len(seq):
            tot += 1
            if max(probs, key=probs.get) == seq[pos]:
                good += 1
    assert rows > 80
    # 2017-era RNA single-read accuracy: most degenerate sites recover the
    # true base (upstream's aggregate bar is 0.85 over many reads/steps)
    assert good / tot > 0.6

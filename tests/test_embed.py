"""Fast5 embedding round-trip: align -> embed_alignment -> read back
(SignalAlignment.embed_file / alignedsignal.CreateLabels equivalents)."""

import os
import shutil

import numpy as np
import pytest

from signalalign_jax.io.embed import (embed_alignment, full_rows_to_table,
                                      mea_labels_from_events,
                                      read_mea_labels,
                                      read_signalalign_events)
from signalalign_jax.io.fast5 import Fast5
from signalalign_jax.io.guide import guide_from_sam_record
from signalalign_jax.io.read import NanoporeReadData
from signalalign_jax.io.reference import ProcessedReference
from signalalign_jax.io.sam import filter_reads
from signalalign_jax.models.pore_model import PoreModel
from signalalign_jax.pipeline import signal_align as sa

RNA_DIR = "/root/reference/tests/minion_test_reads/RNA_edge_cases"
RNA_REF = "/root/reference/tests/test_sequences/fake_rna_ref.fa"
MODEL = "/root/reference/models/testModelR9p4_5mer_acgt_RNA.model"


@pytest.fixture(scope="module")
def embedded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("embed")
    pairs = filter_reads(os.path.join(RNA_DIR, "rna_reads.bam"),
                         os.path.join(RNA_DIR, "rna_reads.readdb"), [RNA_DIR])
    f5_src, rec = [p for p in pairs if p[1].qname.startswith("7d31de25")][0]
    f5 = str(tmp / os.path.basename(f5_src))
    shutil.copy(f5_src, f5)
    read = NanoporeReadData.from_fast5(f5)
    guide = guide_from_sam_record(rec)
    model = PoreModel.from_file(MODEL)
    reference = ProcessedReference(RNA_REF)
    result = sa.align_read(read, guide, reference, model)
    rows = result.full_rows(model)
    # raw events table (re-segmented -> has raw_start/raw_length)
    with Fast5(f5) as fh:
        events = fh.template_events("Analyses/ReSegmentBasecall_000")
    path = embed_alignment(f5, rows, events,
                           vc_rows=result.vc_rows(model),
                           sam_string="fake\tsam\tline")
    return f5, rows, events, path


def test_embed_path_and_full_roundtrip(embedded):
    f5, rows, _, path = embedded
    assert path == "Analyses/SignalAlign_000"
    back = read_signalalign_events(f5)
    assert len(back) == len(rows)
    assert back["reference_index"][0] == rows[0].reference_index
    assert back["path_kmer"][0].decode() == rows[0].path_kmer
    assert np.allclose(back["posterior_probability"],
                       [r.posterior_probability for r in rows])
    # raw coords joined from the event table
    assert (back["raw_length"] > 0).all()


def test_mea_labels(embedded):
    f5, rows, events, _ = embedded
    labels = read_mea_labels(f5)
    # MEA path: one event per row, monotone raw starts, subset of rows
    assert 0 < len(labels) <= len(rows)
    assert (np.diff(labels["raw_start"]) >= 0).all()
    assert set(labels.dtype.names) == {"raw_start", "raw_length",
                                       "reference_index",
                                       "posterior_probability", "kmer"}
    # every event appears at most once on the path
    ev_starts = labels["raw_start"]
    assert len(np.unique(ev_starts)) == len(ev_starts)
    # MEA picks high-posterior cells: mean posterior on the path should
    # beat the all-rows mean
    table = full_rows_to_table(rows)
    assert labels["posterior_probability"].mean() \
        >= table["posterior_probability"].mean()


def test_second_embed_increments(embedded):
    f5, rows, events, _ = embedded
    path2 = embed_alignment(f5, rows, events)
    assert path2 == "Analyses/SignalAlign_001"
    back = read_signalalign_events(f5)  # latest
    assert len(back) == len(rows)


def test_create_labels_facade(embedded):
    from signalalign_jax.io.embed import CreateLabels
    f5, rows, _, _ = embedded
    cl = CreateLabels(f5)
    assert cl.read_id.startswith("7d31de25")
    ev = cl.add_signal_align_predictions()
    assert len(ev) == len(rows)
    mea = cl.add_mea_labels()
    assert 0 < len(mea) <= len(rows)
    assert set(cl.labels) == {"signalalign_full", "mea"}


def test_plot_labelled_read(embedded, tmp_path):
    from signalalign_jax.io.embed import CreateLabels
    from signalalign_jax.visualization import plot_labelled_read
    f5, _, _, _ = embedded
    cl = CreateLabels(f5)
    labels = cl.add_mea_labels()
    out = plot_labelled_read(cl.raw_signal, labels,
                             str(tmp_path / "read.png"))
    import os
    assert os.path.getsize(out) > 10000

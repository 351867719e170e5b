"""MEA decoding and variant-calling marginalization tests."""

import numpy as np
import pandas as pd
import pytest

from signalalign_jax.io.output import FullRow
from signalalign_jax.pipeline.mea import (mea_align, mea_from_aligned_pairs,
                                          mea_slow_spec)
from signalalign_jax.pipeline.variant_caller import (aggregate_over_reads,
                                                     marginalize_full_variants)


def _random_pairs(rng, n_events=30, n_refs=40, density=0.2):
    pairs = []
    for e in range(n_events):
        for r in range(n_refs):
            if rng.random() < density:
                pairs.append((r, e, float(rng.random())))
    return pairs


def test_mea_matches_slow_spec_on_random_matrices():
    rng = np.random.default_rng(0)
    for trial in range(20):
        pairs = _random_pairs(rng)
        if not pairs:
            continue
        path = mea_align(pairs)
        total = sum(p for r, e, p in path)
        expect = mea_slow_spec(pairs)
        assert abs(total - expect) < 1e-9, (trial, total, expect)
        # path is monotone: refs strictly increase, events increase
        refs = [r for r, e, p in path]
        events = [e for r, e, p in path]
        assert all(b > a for a, b in zip(refs, refs[1:]))
        assert all(b > a for a, b in zip(events, events[1:]))


def test_mea_simple_diagonal():
    pairs = [(i, i, 0.9) for i in range(5)] + [(0, 4, 0.5)]
    path = mea_align(pairs)
    assert [(r, e) for r, e, p in path] == [(i, i) for i in range(5)]


def test_mea_from_aligned_pairs():
    ap = [(9000000, 0, 0, "ACGTA"), (8000000, 1, 1, "CGTAC"),
          (7000000, 2, 2, "GTACG")]
    path = mea_from_aligned_pairs(ap)
    assert len(path) == 3
    assert abs(sum(p for _, _, p in path) - 2.4) < 1e-9


def _mk_row(ref_idx, ref_kmer, path_kmer, p, strand="t"):
    return FullRow(
        contig="chr", reference_index=ref_idx, reference_kmer=ref_kmer,
        read_file="r1", strand=strand, event_index=0, event_mean=80.0,
        event_noise=1.0, event_duration=0.001, aligned_kmer=ref_kmer,
        scaled_mean_current=80.0, scaled_noise=1.0,
        posterior_probability=p, descaled_event_mean=80.0,
        ont_model_mean=80.0, path_kmer=path_kmer)


def test_marginalize_full_variants():
    # ambiguity code for C/E is P; variant site at the LAST kmer slot
    rows = [
        _mk_row(10, "AAAAP", "AAAAC", 0.6),
        _mk_row(10, "AAAAP", "AAAAE", 0.2),
        _mk_row(10, "AAAAP", "AAAAC", 0.2),
        _mk_row(11, "AAAPA", "AAACA", 0.9),  # site not at last slot: ignored
    ]
    df = marginalize_full_variants(rows, "CE", "r1", True)
    assert len(df) == 1
    row = df.iloc[0]
    assert row.position == 10
    assert abs(row.C - 0.8) < 1e-9
    assert abs(row.E - 0.2) < 1e-9


def test_aggregate_over_reads():
    df1 = pd.DataFrame([["r1", "chr", 10, "t", "+", 0.8, 0.2]],
                       columns=["read_name", "contig", "position", "strand",
                                "forward_mapped", "C", "E"])
    df2 = pd.DataFrame([["r2", "chr", 10, "t", "-", 0.4, 0.6]],
                       columns=["read_name", "contig", "position", "strand",
                                "forward_mapped", "C", "E"])
    agg = aggregate_over_reads([df1, df2], "CE")
    assert len(agg) == 1
    assert abs(agg.iloc[0].C - 0.6) < 1e-9
    assert abs(agg.iloc[0].E - 0.4) < 1e-9


def test_validate_read_rna():
    """validateSignalAlignment equivalent: SA-vs-guide event distances."""
    import os
    from signalalign_jax.io.guide import guide_from_sam_record
    from signalalign_jax.io.read import NanoporeReadData
    from signalalign_jax.io.reference import ProcessedReference
    from signalalign_jax.io.sam import filter_reads
    from signalalign_jax.models.pore_model import PoreModel
    from signalalign_jax.pipeline import signal_align as sa
    from signalalign_jax.pipeline.validate import validate_read

    d = "/root/reference/tests/minion_test_reads/RNA_edge_cases"
    pairs = filter_reads(os.path.join(d, "rna_reads.bam"),
                         os.path.join(d, "rna_reads.readdb"), [d])
    f5, rec = [p for p in pairs if p[1].qname.startswith("7d31de25")][0]
    read = NanoporeReadData.from_fast5(f5)
    guide = guide_from_sam_record(rec)
    model = PoreModel.from_file(
        "/root/reference/models/testModelR9p4_5mer_acgt_RNA.model")
    ref = ProcessedReference(
        "/root/reference/tests/test_sequences/fake_rna_ref.fa")
    result = sa.align_read(read, guide, ref, model)
    report = validate_read(result, read, guide, threshold=10)
    s = report["summaries"]
    assert len(s) == len(result.aligned_pairs)
    with_guide = [x for x in s if x.guide_position is not None]
    assert len(with_guide) > 100
    # most events should sit near the guide alignment
    import numpy as np
    diffs = np.array([x.abs_diff for x in with_guide])
    assert np.median(diffs) <= 5
    # flagged sets are consecutive >threshold runs
    for f in report["flagged"]:
        assert f["peak_distance"] > 10
        assert f["event_count"] == len(f["events"])


def test_generate_labels():
    import pandas as pd
    from signalalign_jax.pipeline.variant_caller import (generate_labels,
                                                         write_variant_data)
    pred = pd.DataFrame([
        {"contig": "c1", "position": 10, "forward_mapped": True,
         "A": 0.9, "C": 0.1, "G": 0.0, "T": 0.0},
        {"contig": "c1", "position": 20, "forward_mapped": True,
         "A": 0.1, "C": 0.9, "G": 0.0, "T": 0.0},
        {"contig": "c1", "position": 99, "forward_mapped": True,
         "A": 0.5, "C": 0.5, "G": 0.0, "T": 0.0},   # unlabelled -> dropped
    ])
    pos = pd.DataFrame([
        {"contig": "c1", "position": 10, "strand": "+",
         "change_from": "A", "change_to": "A"},
        {"contig": "c1", "position": 20, "strand": "+",
         "change_from": "C", "change_to": "C"},
    ])
    out = generate_labels(pred, pos)
    assert len(out) == 2
    assert out.loc[0, "A_label"] == 1 and out.loc[0, "C_label"] == 0
    assert out.loc[1, "C_label"] == 1
    import tempfile, os
    with tempfile.TemporaryDirectory() as d:
        p = write_variant_data(out, os.path.join(d, "x.tsv"))
        assert open(p).readline().startswith("contig")

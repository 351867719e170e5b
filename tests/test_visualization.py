"""Smoke tests for the plotting toolkit (figures written, stats sane)."""

import os

import numpy as np
import pandas as pd

ONED = "/root/reference/tests/minion_test_reads/1D"
MODEL = "/root/reference/models/testModelR9p4_5mer_acegt_template.model"


def test_em_model_distributions(tmp_path):
    from signalalign_jax.visualization import plot_em_model_distributions
    out = plot_em_model_distributions(
        [MODEL, MODEL], ["ACGTA", "TTTTT"], str(tmp_path / "em.png"),
        assignments={"ACGTA": list(np.random.default_rng(0)
                                   .normal(85, 2, 100))})
    assert os.path.exists(out)


def test_kmer_overlay_and_animation(tmp_path):
    """plot_kmer_distribution2 + animate_kmer_distribution analogues
    (compare_trained_models.py:244-489): multi-kmer overlay PNG and the
    EM-iteration GIF (or its static fallback)."""
    from signalalign_jax.compare import ModelDistributions
    from signalalign_jax.models.hdp_model import load_nhdp
    from signalalign_jax.models.pore_model import PoreModel
    from signalalign_jax.visualization import (
        animate_kmer_distribution, plot_kmer_distribution_overlay)

    r73 = PoreModel.from_file(
        "/root/reference/models/testModelR73_acegot_template.model")
    hdp = load_nhdp(
        "/root/reference/models/templateSingleLevelFixed.nhdp")
    mds = [ModelDistributions(r73, name="gauss"),
           ModelDistributions(r73, hdp=hdp, name="hdp")]
    out = plot_kmer_distribution_overlay(
        mds, ["ACCGTA", "TACGGA"], str(tmp_path / "overlay.png"))
    assert os.path.exists(out) and os.path.getsize(out) > 5000
    anim = animate_kmer_distribution(
        [MODEL, MODEL, MODEL], "ACGTA", str(tmp_path / "anim.gif"),
        assignments=list(np.random.default_rng(1).normal(85, 2, 60)))
    assert os.path.exists(anim) and os.path.getsize(anim) > 2000


def test_multiclass_variant_accuracy(tmp_path):
    from signalalign_jax.visualization import \
        plot_multiclass_variant_accuracy
    rng = np.random.default_rng(1)
    n = 200
    label = rng.choice(list("CE"), size=n)
    pE = np.clip(rng.normal(0.2 + 0.6 * (label == "E"), 0.2), 0, 1)
    df = pd.DataFrame({"label": label, "E": pE, "C": 1 - pE})
    out = plot_multiclass_variant_accuracy(df, str(tmp_path), "smoke")
    assert set(out) == {"C", "E"}
    assert out["E"]["auc"] > 0.8
    assert os.path.exists(out["E"]["plot_path"])


def test_sequencing_summary(tmp_path):
    from signalalign_jax.visualization import sequencing_summary
    df = sequencing_summary(
        os.path.join(ONED, "1D.bam"),
        os.path.join(ONED, "1D.fastq.index.readdb"), [ONED],
        out_dir=str(tmp_path))
    assert len(df) >= 3
    assert df["mapped"].any()
    assert os.path.exists(tmp_path / "sequencing_summary.png")


def test_alignment_breaks_and_raw_verify(tmp_path):
    from signalalign_jax.io.guide import guide_from_sam_record
    from signalalign_jax.io.read import NanoporeReadData
    from signalalign_jax.io.reference import ProcessedReference
    from signalalign_jax.io.sam import filter_reads, read_bam
    from signalalign_jax.models.pore_model import PoreModel
    from signalalign_jax.pipeline.signal_align import (AlignmentConfig,
                                                       align_read)
    from signalalign_jax.pipeline.validate import event_summaries
    from signalalign_jax.visualization import (plot_alignment_breaks,
                                               verify_load_from_raw)

    pairs = filter_reads(os.path.join(ONED, "1D.bam"),
                         os.path.join(ONED, "1D.fastq.index.readdb"),
                         [ONED])
    f5, rec = [p for p in pairs if p[1].qname.startswith("6deaf971")][0]

    n_e, n_r, diff = verify_load_from_raw(
        f5, MODEL, rec, out_path=str(tmp_path / "raw.png"))
    assert n_e > 1000 and n_r > 1000
    assert os.path.exists(tmp_path / "raw.png")

    # breaks plot on a real alignment
    from signalalign_jax.io.sam import reconstruct_reference_window
    genome = np.full(4641652, ord("A"), dtype=np.uint8)
    _, records = read_bam(os.path.join(ONED, "1D.bam"))
    for r in records:
        w = reconstruct_reference_window(r)
        genome[r.pos:r.pos + len(w)] = np.frombuffer(
            w.encode("latin-1"), dtype=np.uint8)
    fa = tmp_path / "e.fa"
    with open(fa, "w") as fh:
        fh.write(">gi_ecoli\n" + genome.tobytes().decode("latin-1") + "\n")
    reference = ProcessedReference(str(fa))
    model = PoreModel.from_file(MODEL)
    read = NanoporeReadData.from_fast5(f5)
    guide = guide_from_sam_record(rec)
    res = align_read(read, guide, reference, model, AlignmentConfig())
    summ = event_summaries(res, read, guide)
    out = plot_alignment_breaks({read.read_label: summ},
                                str(tmp_path / "breaks.png"))
    assert os.path.exists(out)


def test_accuracy_vs_deviation(tmp_path):
    from signalalign_jax.visualization import (
        deviation_call_data, get_percent_accuracy_vs_deltas,
        plot_accuracy_vs_alignment_deviation)
    rng = np.random.default_rng(3)
    # synthetic vc rows: two candidate bases per (event, position) call;
    # calls drift off the guide with occasional wrong calls far away
    rows, gpos = [], {}
    for i in range(200):
        ev, pos = 10 + i, 1000 + i
        gpos[ev] = pos + int(rng.integers(0, 8))
        p_true = 0.9 if rng.random() > 0.2 else 0.2
        rows.append((ev, pos, "C", p_true))
        rows.append((ev, pos, "A", 1.0 - p_true))
    d, tf = deviation_call_data(rows, gpos, "C", threshold=0.5)
    assert len(d) == 200 and len(tf) == 200
    assert d.min() >= 0 and d.max() <= 7
    # normalization: p(label)/sum == raw p here (pairs sum to 1)
    assert 0.6 < tf.mean() < 0.95
    # events without a guide position are dropped
    d2, tf2 = deviation_call_data(rows[:2] + [(9999, 5, "C", 1.0)],
                                  gpos, "C")
    assert len(d2) == 1
    edges, percents = get_percent_accuracy_vs_deltas([(d, tf)], n_bins=8)
    assert len(edges) == 8 and len(percents[0]) == 8
    assert all(0.0 <= p <= 1.0 for p in percents[0])
    out = plot_accuracy_vs_alignment_deviation(
        [(d, tf)], ["C"], str(tmp_path / "dev.png"))
    assert os.path.exists(out)

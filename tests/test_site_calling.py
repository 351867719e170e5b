"""Production site-calling mode through the runner:
``run_alignment_batch(call_variants=...)`` folds each segment's compacted
device pairs onto per-site variant marginals, which must reproduce the
host marginalizer (marginalize_full_variants, reference
src/signalalign/variantCaller.py:123-187) applied to the full-output rows
of a plain run of the SAME batch; its TSVs must match the pandas writer
they replaced byte for byte."""

import os

import numpy as np
import pandas as pd
import pytest

from signalalign_jax.io.guide import GuideAlignment
from signalalign_jax.io.read import NanoporeReadData
from signalalign_jax.io.reference import ProcessedReference
from signalalign_jax.models.pore_model import PoreModel, ScalingParams
from signalalign_jax.pipeline.runner import (run_alignment_batch,
                                             write_variant_outputs)
from signalalign_jax.pipeline.signal_align import AlignmentConfig
from signalalign_jax.pipeline.variant_caller import marginalize_full_variants

MODEL = "/root/reference/models/testModelR9p4_5mer_acegt_template.model"


@pytest.fixture(scope="module")
def cpg_batch(tmp_path_factory, acgt_model):
    """8 synthetic reads over a CpG-dense Y-ambiguous reference (the
    same construction as the runner P=2 test)."""
    tmp_path = tmp_path_factory.mktemp("sitecall")
    model = acgt_model
    rng = np.random.default_rng(9)
    core = "".join(rng.choice(list("ACGT"), size=598))
    genome = ("ACGT" * 40 + core + "ACGT" * 40).replace("CG", "CGCG")
    fasta = tmp_path / "ref.fa"
    with open(fasta, "w") as fh:
        fh.write(">chr\n" + genome + "\n")
    reference = ProcessedReference(str(fasta), motifs=[("CG", "YG")])

    k = model.kmer_length
    rgs = []
    for ri in range(8):
        start = 40 + 17 * ri
        seq_len = 220
        read_seq = genome[start:start + seq_len]
        ids = model.alphabet.seq_to_kmer_ids(read_seq)
        events, event_map = [], []
        for kid in ids:
            event_map.append(len(events))
            events.append([rng.normal(model.level_mean[kid],
                                      model.level_sd[kid]),
                           1.0, .002, len(events) * .002])
        event_map.extend([event_map[-1]] * (k - 1))
        read = NanoporeReadData(
            read_label=f"p2r{ri}", template_read=read_seq,
            events=np.array(events), event_map=np.array(event_map),
            model_states=None, p_model_state=None, kmer_length=k,
            params=ScalingParams(), rna=False)
        guide = GuideAlignment(
            contig="chr", forward=ri % 2 == 0, window_start=start,
            window_end=start + seq_len, query_start=0, query_end=seq_len,
            ops=[(seq_len, "M")])
        rgs.append((read, guide))
    return reference, model, rgs


def _host_reference_calls(reference, model, rgs, cfg):
    """Golden: plain batch -> full rows -> host marginalizer."""
    base = run_alignment_batch(rgs, reference, model, cfg)
    out = {}
    for r in base:
        rows = r.full_rows(model)
        df = marginalize_full_variants(rows, "CT", r.read_label,
                                       r.forward, ambig_char="Y")
        out[r.read_label] = df
    return out


def _assert_calls_match(got, ref: pd.DataFrame, tol):
    gk = {(s, int(p)): (c, t) for s, p, c, t in
          zip(got["strand"], got["position"], got["C"], got["T"])}
    rk = {(r["strand"], int(r["position"])): (r["C"], r["T"])
          for _, r in ref.iterrows()}
    assert set(gk) == set(rk), (set(gk) ^ set(rk))
    for key in rk:
        assert abs(gk[key][0] - rk[key][0]) < tol, (key, gk[key], rk[key])
        assert abs(gk[key][1] - rk[key][1]) < tol
        assert abs(gk[key][0] + gk[key][1] - 1.0) < 1e-6
    # row ORDER mirrors MarginalizeFullVariants: t strand first,
    # positions ascending on '+' mapping, descending on '-'
    pos = [int(p) for p in got["position"]]
    want = list(ref["position"])
    assert pos == [int(p) for p in want]


def test_site_calling_xla_fold_matches_host_marginalizer(cpg_batch):
    reference, model, rgs = cpg_batch
    cfg = AlignmentConfig(ambig_map={"Y": "CT"})
    ref_calls = _host_reference_calls(reference, model, rgs, cfg)
    res = run_alignment_batch(rgs, reference, model, cfg,
                              call_variants="CT")
    assert len(res) == 8
    for r in res:
        assert r.aligned_pairs == []        # only calls, no pair stream
        # the pair fold is numerically identical to the marginalizer
        _assert_calls_match(r.variant_calls, ref_calls[r.read_label],
                            tol=1e-9)


def _pandas_variant_outputs(results, out_dir, variants):
    """The pandas writer the run path used before it went pandas-free:
    per-read DataFrame.to_csv, groupby aggregate, per-read means."""
    vs = sorted(variants)
    frames = []
    for r in results:
        df = pd.DataFrame(r.variant_calls.rows,
                          columns=r.variant_calls.columns)
        df.to_csv(os.path.join(out_dir, f"{r.read_label}.sm.variants.tsv"),
                  sep="\t", index=False)
        frames.append(df)
    nz = [df for df in frames if len(df)]
    if nz:
        allr = pd.concat(nz, ignore_index=True)
        agg = allr.groupby(["contig", "position", "strand"],
                           as_index=False)[vs].sum()
        totals = agg[vs].sum(axis=1)
        for v in vs:
            agg[v] = agg[v] / totals
    else:
        agg = pd.DataFrame(columns=["contig", "position", "strand",
                                    "forward_mapped"] + vs)
    agg.to_csv(os.path.join(out_dir, "variants_aggregate.tsv"), sep="\t",
               index=False)
    cols = ["read_name", "contig", "strand", "forward_mapped", "n_sites"] + vs
    data = []
    if frames:
        allp = pd.concat(frames, ignore_index=True)
        for (rn, contig, strand, fwd), grp in allp.groupby(
                ["read_name", "contig", "strand", "forward_mapped"],
                sort=False):
            data.append([rn, contig, strand, fwd, len(grp)]
                        + [float(grp[v].mean()) for v in vs])
    pd.DataFrame(data, columns=cols).to_csv(
        os.path.join(out_dir, "variants_per_read.tsv"), sep="\t",
        index=False)


@pytest.mark.parametrize("n_reads", [8, 0])
def test_variants_tsv_matches_pandas_writer(cpg_batch, tmp_path, n_reads):
    """Site-mode TSVs (per read, aggregate, per-read summary) are byte
    for byte what the pandas writer wrote, including the empty batch."""
    reference, model, rgs = cpg_batch
    cfg = AlignmentConfig(ambig_map={"Y": "CT"})
    res = run_alignment_batch(rgs[:n_reads], reference, model, cfg,
                              call_variants="CT")
    new, old = tmp_path / "new", tmp_path / "old"
    new.mkdir()
    old.mkdir()
    written = write_variant_outputs(res, str(new), "CT")
    _pandas_variant_outputs(res, str(old), "CT")
    assert len(written) == len(os.listdir(old)) == n_reads + 2
    for path in written:
        name = os.path.basename(path)
        assert open(path, "rb").read() == open(old / name, "rb").read(), name


@pytest.mark.slow
def test_run_signal_align_variants_output(tmp_path, ecoli_fasta):
    """CLI-level production calling: output_format='variants' writes the
    per-read marginalize_full_variants tables + the across-read
    aggregate (reference flow runSignalAlign -> variantCaller)."""
    import os

    from signalalign_jax.pipeline.runner import run_signal_align

    oned = "/root/reference/tests/minion_test_reads/1D"
    model = PoreModel.from_file(MODEL)
    written = run_signal_align(
        alignment_file=os.path.join(oned, "1D.bam"),
        readdb=os.path.join(oned, "1D.fastq.index.readdb"),
        fast5_dirs=[oned], reference_fasta=ecoli_fasta, model=model,
        output_dir=str(tmp_path),
        config=AlignmentConfig(ambig_map={"Y": "CT"}),
        output_format="variants", motifs=[("CG", "YG")], max_reads=1,
        verbose=False)
    per_read = [w for w in written if w.endswith(".sm.variants.tsv")]
    agg = [w for w in written if w.endswith("variants_aggregate.tsv")]
    assert len(per_read) == 1 and len(agg) == 1
    # per-read per-strand summary (MarginalizeFullVariants
    # per_read_calls): mean of per-position probs + site count
    prc = pd.read_csv([w for w in written
                       if w.endswith("variants_per_read.tsv")][0],
                      sep="\t")
    assert list(prc.columns) == ["read_name", "contig", "strand",
                                 "forward_mapped", "n_sites", "C", "T"]
    assert len(prc) >= 1 and int(prc["n_sites"].iloc[0]) > 10
    df = pd.read_csv(per_read[0], sep="\t")
    assert list(df.columns) == ["read_name", "contig", "position",
                                "strand", "forward_mapped", "C", "T"]
    assert len(df) > 50
    assert np.allclose(df["C"] + df["T"], 1.0)
    adf = pd.read_csv(agg[0], sep="\t")
    assert len(adf) == len(set(df["position"]))

"""variantCaller equivalence on the shipped methylation-calling goldens
(tests/test_variantCalled_files): the per-position C/E marginals computed by
our marginalizer from the reference's own full-output rows must match the
reference algorithm (MarginalizeFullVariants, variantCaller.py:92-189).
The fast5s for these reads are not shipped, so the alignment itself cannot
be re-run; the marginalization layer is exercised on identical inputs."""

import glob
import os

import numpy as np
import pandas as pd
import pytest

from signalalign_jax.io.output import FullRow
from signalalign_jax.pipeline.variant_caller import (aggregate_over_reads,
                                                     marginalize_full_variants)

CANONICAL = "/root/reference/tests/test_variantCalled_files/canonical"
METHYL = "/root/reference/tests/test_variantCalled_files/methylated"

GOLD_COLS = ["contig", "ref", "kmer", "read", "strand", "ev", "evmean",
             "evnoise", "evdur", "alnkmer", "scaledE", "scaledN", "p",
             "descaled", "Emean", "pathkmer"]


def rows_from_tsv(path):
    gold = pd.read_csv(path, sep="\t", names=GOLD_COLS,
                       keep_default_na=False)
    rows = []
    for r in gold.itertuples():
        rows.append(FullRow(
            contig=r.contig, reference_index=int(r.ref),
            reference_kmer=str(r.kmer), read_file=str(r.read),
            strand=str(r.strand), event_index=int(r.ev),
            event_mean=float(r.evmean), event_noise=float(r.evnoise),
            event_duration=float(r.evdur), aligned_kmer=str(r.alnkmer),
            scaled_mean_current=float(r.scaledE),
            scaled_noise=float(r.scaledN),
            posterior_probability=float(r.p),
            descaled_event_mean=float(r.descaled),
            ont_model_mean=float(r.Emean), path_kmer=str(r.pathkmer)))
    return gold, rows


def reference_marginals(gold, variants="CE", k=6):
    """The reference algorithm, straight from variantCaller.py:124-180."""
    k1 = k - 1
    out = {}
    gv = gold[[("X" in km or any(v in km for v in "X")) and "X" in km
               for km in gold.kmer]]
    for strand in ("t", "c"):
        gs = gv[gv.strand == strand]
        for pos in sorted(set(gs.ref)):
            pdta = gs[gs.ref == pos]
            if pdta.alnkmer.iloc[0][k1] != "X":
                continue
            probs = {}
            for nuc in variants:
                probs[nuc] = pdta[[km[k1] == nuc for km in pdta.pathkmer]
                                  ].p.sum()
            tot = sum(probs.values())
            if tot > 0:
                out[(strand, pos)] = {n: v / tot for n, v in probs.items()}
    return out


@pytest.mark.parametrize("dirname", [CANONICAL, METHYL])
def test_marginalize_matches_reference_algorithm(dirname):
    files = sorted(glob.glob(os.path.join(dirname, "*.sm.*.tsv")))
    assert files
    checked = 0
    for path in files:
        forward = ".sm.forward" in path
        gold, rows = rows_from_tsv(path)
        mine = marginalize_full_variants(rows, "CE", "r", forward)
        if len(mine) == 0:
            continue
        ref = reference_marginals(gold)
        msites = {(r["strand"], int(r["position"])): (r["C"], r["E"])
                  for _, r in mine.iterrows()}
        assert set(msites) == set(ref)
        for key in ref:
            assert abs(msites[key][0] - ref[key]["C"]) < 1e-9
            assert abs(msites[key][1] - ref[key]["E"]) < 1e-9
            assert abs(msites[key][0] + msites[key][1] - 1.0) < 1e-9
        checked += 1
    assert checked >= 1


def test_call_methylation_cli_on_goldens(tmp_path):
    """scripts/call_methylation.py equivalent: the CLI consumes a
    directory of full-format .sm TSVs and writes per-site calls +
    aggregate; values must match the in-process marginalizer."""
    from signalalign_jax.cli import main as cli_main
    out = tmp_path / "calls.tsv"
    rc = cli_main(["call_methylation", "--input_dir", METHYL,
                   "--variants", "CE", "--out", str(out)])
    assert rc == 0
    df = pd.read_csv(out, sep="\t")
    assert len(df) > 10
    assert np.allclose(df["C"] + df["E"], 1.0)
    agg = pd.read_csv(str(out) + ".aggregate", sep="\t")
    assert len(agg) == len(set(zip(df["contig"], df["position"],
                                   df["strand"])))
    # spot-check one file against the direct marginalizer
    path = glob.glob(os.path.join(METHYL, "*.sm.forward.tsv"))[0]
    _, rows = rows_from_tsv(path)
    ref = marginalize_full_variants(rows, "CE",
                                    os.path.basename(path), True)
    sub = df[df["read_name"] == os.path.basename(path)]
    got = {(r["strand"], int(r["position"])): r["E"]
           for _, r in sub.iterrows()}
    for _, r in ref.iterrows():
        assert abs(got[(r["strand"], int(r["position"]))] - r["E"]) < 1e-9


def test_kmer_hist_cli_on_goldens(tmp_path):
    """scripts/generate_kmer_histograms.py equivalent."""
    from signalalign_jax.cli import main as cli_main
    path = glob.glob(os.path.join(CANONICAL, "*.sm.*.tsv"))[0]
    import pandas as _pd
    gold = _pd.read_csv(path, sep="\t", names=GOLD_COLS,
                        keep_default_na=False)
    kmer = gold[gold.strand == "t"].pathkmer.iloc[13]
    import shutil
    one = tmp_path / "one"
    one.mkdir()
    shutil.copy(path, one / os.path.basename(path))
    rc = cli_main(["kmer_hist", "--input_dir", str(one),
                   "--kmer", kmer, "--output_dir",
                   str(tmp_path / "hist")])
    assert rc == 0
    data = open(tmp_path / "hist" / f"{kmer}_hist.txt").read().split()
    n_ref = sum(1 for _, r in gold.iterrows()
                if r.pathkmer == kmer and r.strand == "t")
    assert len(data) == n_ref > 0
    assert os.path.exists(tmp_path / "hist" / f"{kmer}_hist.png")


def test_aggregate_over_golden_reads():
    per_read = []
    for path in sorted(glob.glob(os.path.join(CANONICAL, "*.sm.*.tsv"))):
        _, rows = rows_from_tsv(path)
        df = marginalize_full_variants(rows, "CE", os.path.basename(path),
                                       ".sm.forward" in path)
        if len(df):
            per_read.append(df)
    for path in sorted(glob.glob(os.path.join(METHYL, "*.sm.*.tsv"))):
        _, rows = rows_from_tsv(path)
        df = marginalize_full_variants(rows, "CE", os.path.basename(path),
                                       ".sm.forward" in path)
        if len(df):
            per_read.append(df)
    agg = aggregate_over_reads(per_read, "CE")
    assert len(agg)
    s = agg["C"] + agg["E"]
    assert np.allclose(s, 1.0)

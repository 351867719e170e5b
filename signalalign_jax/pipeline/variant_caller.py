"""Variant / methylation calling: marginalize posterior mass per candidate
base at ambiguous reference positions, per read and across reads.

reference: src/signalalign/variantCaller.py — MarginalizeFullVariants (92),
MarginalizeVariants (18), AggregateOverReads(Full) (190/282).
"""

from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from signalalign_jax.io.output import FullRow
from signalalign_jax.utils.alphabet import AMBIG_FROM_VARIANTS


@dataclasses.dataclass
class CallTable:
    """A small named-column table of per-site or per-read calls.

    The site-calling run path keeps its tables in plain rows (pandas is
    an optional install); ``write_tsv`` writes them byte for byte as
    ``pandas.DataFrame.to_csv(sep="\\t", index=False)`` would.
    """
    columns: List[str]
    rows: List[list]

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, name: str) -> list:
        j = self.columns.index(name)
        return [r[j] for r in self.rows]

    def write_tsv(self, path: str) -> str:
        def fmt(v):
            if isinstance(v, float):
                return "" if math.isnan(v) else repr(v)
            return str(v)
        with open(path, "w") as fh:
            fh.write("\t".join(self.columns) + "\n")
            for r in self.rows:
                fh.write("\t".join(fmt(v) for v in r) + "\n")
        return path


def _kahan_sum(values: Iterable[float]) -> float:
    """Compensated sum in input order (pandas' groupby-sum arithmetic,
    so aggregated tables match the pandas writer to the last bit)."""
    total = comp = 0.0
    for v in values:
        y = v - comp
        t = total + y
        comp = (t - total) - y
        total = t
    return total


def marginalize_full_variants(rows: Sequence[FullRow], variants: str,
                              read_name: str, forward_mapped: bool,
                              ambig_char: Optional[str] = None):
    """Per-position normalized variant probabilities for one read.

    reference: MarginalizeFullVariants.get_data (variantCaller.py:123-187):
    only rows whose ALIGNED k-mer (target orientation) carries the
    ambiguity code (or 'X') at its last position report; per position the
    posterior mass of path k-mers calling each candidate base at that slot
    is normalized.
    """
    import pandas as pd

    variants = sorted(variants)
    ambig = ambig_char or AMBIG_FROM_VARIANTS.get("".join(variants), "X")
    k1 = None
    per_strand: Dict[str, Dict[int, Dict[str, float]]] = {
        "t": defaultdict(lambda: {v: 0.0 for v in variants}),
        "c": defaultdict(lambda: {v: 0.0 for v in variants}),
    }
    contig = rows[0].contig if rows else ""
    for r in rows:
        if k1 is None:
            k1 = len(r.reference_kmer) - 1
        base = r.aligned_kmer[k1]
        if base != ambig and base != "X":
            continue
        called = r.path_kmer[k1]
        if called in per_strand[r.strand][r.reference_index]:
            per_strand[r.strand][r.reference_index][called] += \
                r.posterior_probability

    data = []
    mapping_strands = ["+", "-"] if forward_mapped else ["-", "+"]
    for si, strand in enumerate(("t", "c")):
        positions = sorted(per_strand[strand])
        if mapping_strands[si] == "-":
            positions = positions[::-1]
        for pos in positions:
            probs = per_strand[strand][pos]
            total = sum(probs.values())
            if total <= 0:
                continue
            data.append([read_name, contig, pos, strand, mapping_strands[si]]
                        + [probs[v] / total for v in variants])
    cols = ["read_name", "contig", "position", "strand", "forward_mapped"] \
        + list(variants)
    return pd.DataFrame(data, columns=cols)


def marginalize_vc_rows(vc_rows: Sequence[Tuple], variants: str,
                        read_name: str):
    """Per-position probabilities from variantCaller-format rows
    (y, position, base, prob, strand, forward_label, read, score, contig).

    reference: MarginalizeVariants.get_data (variantCaller.py:18-90).
    """
    import pandas as pd

    variants = sorted(variants)
    agg: Dict[Tuple[str, int, str], Dict[str, float]] = defaultdict(
        lambda: {v: 0.0 for v in variants})
    meta: Dict[Tuple[str, int, str], Tuple[str, str]] = {}
    for (y, pos, base, p, strand, fwd, read, score, contig) in vc_rows:
        if base in agg[(strand, pos, fwd)]:
            agg[(strand, pos, fwd)][base] += p
            meta[(strand, pos, fwd)] = (contig, fwd)
    data = []
    for (strand, pos, fwd), probs in sorted(agg.items(),
                                            key=lambda kv: kv[0][1]):
        total = sum(probs.values())
        if total <= 0:
            continue
        contig, fwd_label = meta[(strand, pos, fwd)]
        data.append([read_name, contig, pos, strand, fwd_label]
                    + [probs[v] / total for v in variants])
    cols = ["read_name", "contig", "position", "strand", "forward_mapped"] \
        + list(variants)
    return pd.DataFrame(data, columns=cols)


def aggregate_call_rows(rows: Iterable[Sequence], variants: str
                        ) -> CallTable:
    """Across-read aggregation with per-position normalization.

    reference: AggregateOverReadsFull.marginalize_over_all_reads
    (variantCaller.py:385-408): sum each candidate's probabilities across
    reads at a position, then renormalize. ``rows`` are per-read call
    rows (read_name, contig, position, strand, forward_mapped,
    *variants); the result is sorted by (contig, position, strand).
    """
    vs = sorted(variants)
    groups: Dict[Tuple, List[List[float]]] = {}
    for r in rows:
        acc = groups.setdefault((r[1], r[2], r[3]), [[] for _ in vs])
        for j in range(len(vs)):
            acc[j].append(float(r[5 + j]))
    if not groups:
        return CallTable(["contig", "position", "strand",
                          "forward_mapped"] + vs, [])
    out = []
    for key in sorted(groups):
        sums = [_kahan_sum(col) for col in groups[key]]
        total = 0.0
        for v in sums:
            total += v
        out.append(list(key) + [v / total if total else float("nan")
                                for v in sums])
    return CallTable(["contig", "position", "strand"] + vs, out)


def aggregate_over_reads(per_read, variants: str):
    """aggregate_call_rows over per-read DataFrames (the analysis
    commands' form); returns a DataFrame."""
    import pandas as pd

    rows = [list(r) for df in per_read if len(df)
            for r in df.itertuples(index=False)]
    table = aggregate_call_rows(rows, variants)
    return pd.DataFrame(table.rows, columns=table.columns)


def call_methylation(aggregated, canonical: str, modified: str,
                     threshold: float = 0.5):
    """Binary calls from aggregated probabilities."""
    out = aggregated.copy()
    out["call"] = np.where(out[modified] >= threshold, modified, canonical)
    return out


FULL_TSV_COLS = ["contig", "reference_index", "reference_kmer", "read_file",
                 "strand", "event_index", "event_mean", "event_noise",
                 "event_duration", "aligned_kmer", "scaled_mean_current",
                 "scaled_noise", "posterior_probability",
                 "descaled_event_mean", "ont_model_mean", "path_kmer"]


def full_rows_from_tsv(path: str, threshold: float = 0.0):
    """Full-format output TSV -> FullRow list (the reference's
    alignment-file consumers re-read .sm TSVs this way,
    scripts/call_methylation.py / alignmentAnalysisLib.CallMethylation)."""
    df = pd.read_csv(path, sep="\t", names=FULL_TSV_COLS,
                     keep_default_na=False)
    rows = []
    for r in df.itertuples():
        p = float(r.posterior_probability)
        if p < threshold:
            continue
        rows.append(FullRow(
            contig=str(r.contig), reference_index=int(r.reference_index),
            reference_kmer=str(r.reference_kmer),
            read_file=str(r.read_file), strand=str(r.strand),
            event_index=int(r.event_index),
            event_mean=float(r.event_mean),
            event_noise=float(r.event_noise),
            event_duration=float(r.event_duration),
            aligned_kmer=str(r.aligned_kmer),
            scaled_mean_current=float(r.scaled_mean_current),
            scaled_noise=float(r.scaled_noise), posterior_probability=p,
            descaled_event_mean=float(r.descaled_event_mean),
            ont_model_mean=float(r.ont_model_mean),
            path_kmer=str(r.path_kmer)))
    return rows


def call_methylation_from_tsvs(tsv_paths, variants: str, out_path: str,
                               threshold: float = 0.0,
                               ambig_char: Optional[str] = None,
                               aggregate: bool = True) -> str:
    """Methylation/variant calling from a directory of full-format
    .sm TSVs: per-read per-site marginals concatenated to one table,
    plus the across-read aggregate appended as a second section when
    ``aggregate``.

    reference: scripts/call_methylation.py (+ CallMethylation,
    alignmentAnalysisLib.py) — per alignment file, rows whose aligned
    k-mer carries the ambiguity code report, marginalized per site.
    File orientation comes from the .sm.forward/.backward name.
    """
    import pandas as pd

    frames = []
    for path in tsv_paths:
        rows = full_rows_from_tsv(path, threshold=threshold)
        if not rows:
            continue
        import os as _os
        name = _os.path.basename(path)
        forward = ".backward" not in name
        df = marginalize_full_variants(rows, variants, name, forward,
                                       ambig_char=ambig_char)
        if len(df):
            frames.append(df)
    allr = (pd.concat(frames, ignore_index=True) if frames
            else pd.DataFrame(columns=["read_name", "contig", "position",
                                       "strand", "forward_mapped"]
                              + sorted(variants)))
    allr.to_csv(out_path, sep="\t", index=False)
    if aggregate and frames:
        agg = aggregate_over_reads(frames, variants)
        agg.to_csv(out_path + ".aggregate", sep="\t", index=False)
    return out_path


def write_variant_data(df, out_path: str) -> str:
    """reference: AggregateOverReads.write_data (variantCaller.py:246-248)."""
    df.to_csv(out_path, sep="\t", index=False)
    return out_path


def generate_labels(predicted, positions, variants: str = "ACGT"):
    """One-hot truth labels per site from a positions table.

    reference: AggregateOverReads.generate_labels + get_true_character
    (variantCaller.py:250-269, 445-455): rows whose (contig, strand,
    position) have no labelled truth are dropped; otherwise the 'change_to'
    base gets label 1.
    """
    out = predicted.copy()
    for ch in variants:
        out[ch + "_label"] = 0
    keep = []
    for i, row in out.iterrows():
        strand = "+" if row.get("forward_mapped", True) in (True, "forward") \
            else "-"
        hit = positions[(positions["contig"] == row["contig"])
                        & (positions["strand"] == strand)
                        & (positions["position"] == row["position"])]
        if len(hit) == 0:
            continue
        true_char = str(hit.iloc[0]["change_to"])
        if true_char in variants:
            out.loc[i, true_char + "_label"] = 1
            keep.append(i)
    return out.loc[keep].reset_index(drop=True)


def marginals_from_pairs(pairs, site_cells, problem, variants: str
                         ) -> Dict[int, Dict[str, float]]:
    """Host fold of a segment's decoded pair stream onto per-site
    variant marginals (the site-calling run path).

    Same aggregation as MarginalizeFullVariants (variantCaller.py:
    123-187): pairs whose cell x is a site cell contribute their
    posterior to the base their path k-mer calls at the k-mer's last
    position; normalized per site. Keys are (x-1)+k1 segment positions
    (0-based ref index of the k-mer's LAST base).
    """
    k1 = problem.kmer_len - 1
    vs = sorted(variants)
    cellset = {int(c) for c in site_cells}
    acc: Dict[int, Dict[str, float]] = {}
    for prob, x, y, kmer in pairs:
        if (x + 1) not in cellset:
            continue
        base = kmer[k1]
        slot = acc.setdefault(x + k1, {v: 0.0 for v in vs})
        if base in slot:
            slot[base] += prob / 1e7
    out = {}
    for pos, probs in acc.items():
        total = sum(probs.values())
        if total > 0:
            out[pos] = {v: p / total for v, p in probs.items()}
    return out


def variant_call_table(per_pos: Dict[Tuple[str, int], Dict[str, float]],
                       read_name: str, contig: str,
                       forward_mapped: bool, variants: str) -> CallTable:
    """Per-read calls table from {(strand, genomic position): {base: p}}.

    Schema and row order mirror ``marginalize_full_variants``
    (MarginalizeFullVariants.get_data, variantCaller.py:123-187):
    template strand first, positions ascending on the '+' mapping
    strand and descending on '-'.
    """
    vs = sorted(variants)
    data = []
    mapping_strands = ["+", "-"] if forward_mapped else ["-", "+"]
    for si, strand in enumerate(("t", "c")):
        positions = sorted(pos for (s, pos) in per_pos if s == strand)
        if mapping_strands[si] == "-":
            positions = positions[::-1]
        for pos in positions:
            probs = per_pos[(strand, pos)]
            total = sum(probs.get(v, 0.0) for v in vs)
            if total <= 0:
                continue
            data.append([read_name, contig, int(pos), strand,
                         mapping_strands[si]]
                        + [probs.get(v, 0.0) / total for v in vs])
    cols = ["read_name", "contig", "position", "strand", "forward_mapped"] \
        + list(vs)
    return CallTable(cols, data)


def per_read_call_table(tables: Sequence[CallTable],
                        variants: str) -> CallTable:
    """Per-read per-strand averages of the per-position calls.

    reference: MarginalizeFullVariants.per_read_calls
    (variantCaller.py:120-121, 176-180): mean of the normalized
    per-position probabilities over a read's sites, with the site
    count. Groups keep first-appearance order."""
    vs = sorted(variants)
    groups: Dict[Tuple, List[list]] = {}
    for t in tables:
        for r in t.rows:
            groups.setdefault((r[0], r[1], r[3], r[4]), []).append(r)
    data = []
    for (rn, contig, strand, fwd), grp in groups.items():
        data.append([rn, contig, strand, fwd, len(grp)]
                    + [float(np.sum(np.array([r[5 + j] for r in grp],
                                             dtype=np.float64)) / len(grp))
                       for j in range(len(vs))])
    cols = ["read_name", "contig", "strand", "forward_mapped", "n_sites"] \
        + list(vs)
    return CallTable(cols, data)

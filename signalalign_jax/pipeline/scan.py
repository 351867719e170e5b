"""Scan-mode per-position nucleotide probabilities.

reference: singleNucleotideProbabilities.py
(discover_single_nucleotide_probabilities:551-726) + the marginalization in
scripts/alignmentAnalysisLib.py (CallMethylation.call_methyls:159-250): for
each offset s of a step grid the reference is re-written with every
grid position replaced by the full-degenerate base 'X', reads are aligned
against it (the path expansion makes the DP consider all four bases), and
per site the path-called base probabilities are summed over the covering
k-mers and normalized. Steps are coalesced into one per-read TSV
(#CHROM POS pA pC pG pT).
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from signalalign_jax.io.reference import ProcessedReference
from signalalign_jax.models.pore_model import PoreModel
from signalalign_jax.pipeline.signal_align import AlignmentConfig, ReadAlignment


def replace_periodic_positions(seq: str, step: int, offset: int,
                               char: str = "X") -> str:
    """reference: replace_periodic_sequence_positions
    (sequenceTools.py:208-225)."""
    out = list(seq)
    for i in range(offset, len(seq), step):
        out[i] = char
    return "".join(out)


class PeriodicReference(ProcessedReference):
    """ProcessedReference with every step-grid position degenerate."""

    def __init__(self, fasta_path: str, step: int, offset: int,
                 char: str = "X"):
        super().__init__(fasta_path)
        for name in list(self.forward):
            self.forward[name] = replace_periodic_positions(
                self.forward[name], step, offset, char)
            self.backward[name] = replace_periodic_positions(
                self.backward[name], step, offset, char)


def marginalize_step(result: ReadAlignment, model: PoreModel, step: int,
                     offset: int, threshold: float = 0.0
                     ) -> List[Tuple[str, str, int, Dict[str, float]]]:
    """Per-site normalized base probabilities for one read at one step
    offset (CallMethylation.call_methyls with step_offset set)."""
    k = model.kmer_length
    rows = result.full_rows(model)
    if not rows:
        return []
    refs = np.array([r.reference_index for r in rows])
    lo = int(refs.min()) - step
    hi = int(refs.max()) + step
    while lo % step != 0:
        lo -= 1
    while hi % step != 0:
        hi += 1
    sites = range(lo + offset, hi, step)
    by_ref: Dict[int, List] = defaultdict(list)
    for r in rows:
        if r.posterior_probability >= threshold:
            by_ref[r.reference_index].append(r)
    # template strand of a 1D read: regular_offset follows the mapping
    # orientation (alignmentAnalysisLib.py:245-246)
    regular = result.forward if result.strand_template \
        else (not result.forward)
    out = []
    for site in sites:
        probs = {"A": 0.0, "C": 0.0, "G": 0.0, "T": 0.0}
        contig = None
        n = 0
        for rpos in range(site - (k - 1), site + 1):
            for r in by_ref.get(rpos, ()):
                off = site - r.reference_index if regular \
                    else (k - 1) - (site - r.reference_index)
                call = r.path_kmer[off]
                if call in probs:
                    probs[call] += r.posterior_probability
                    contig = r.contig
                    n += 1
        total = sum(probs.values())
        if n == 0 or total <= 0:
            continue
        for b in probs:
            probs[b] /= total
        out.append((contig, "t" if result.strand_template else "c",
                    site, probs))
    return out


def scan_single_nucleotide_probabilities(
    reads_and_guides: Sequence,
    reference_fasta: str,
    model: PoreModel,
    output_dir: str,
    step_size: int = 10,
    config: Optional[AlignmentConfig] = None,
    threshold: float = 0.0,
    verbose: bool = True,
    offsets: Optional[Sequence[int]] = None,
) -> List[str]:
    """Full scan: one alignment pass per step offset against periodically
    degenerate references, coalesced into per-read TSVs. ``offsets``
    restricts the scan to a subset of step offsets (default: all)."""
    from signalalign_jax.pipeline.runner import run_alignment_batch

    config = config or AlignmentConfig()
    os.makedirs(output_dir, exist_ok=True)
    per_read: Dict[str, List] = defaultdict(list)
    read_dir: Dict[str, bool] = {}
    for s in (offsets if offsets is not None else range(step_size)):
        ref = PeriodicReference(reference_fasta, step_size, s)
        results = run_alignment_batch(reads_and_guides, ref, model, config,
                                      verbose=False)
        for res in results:
            calls = marginalize_step(res, model, step_size, s, threshold)
            per_read[res.read_label].extend(calls)
            fwd_orig = (not res.forward) if res.rna else res.forward
            read_dir[res.read_label] = fwd_orig
        if verbose:
            print(f"[scan] step offset {s}: {len(results)} reads aligned")

    written = []
    for label, calls in per_read.items():
        calls.sort(key=lambda c: c[2])
        contigs = sorted({c[0] for c in calls})
        reverse = not read_dir.get(label, True)
        path = os.path.join(output_dir, f"{label}.tsv")
        with open(path, "w") as fh:
            fh.write(f"## read_id: {label}\n")
            fh.write(f"## contig: {','.join(contigs)}\n")
            fh.write("## strand: {}\n".format(
                "complement" if reverse else "template"))
            fh.write("#CHROM\tPOS\tpA\tpC\tpG\tpT\n")
            for contig, strand, site, p in calls:
                if reverse:
                    vals = (p["T"], p["G"], p["C"], p["A"])
                else:
                    vals = (p["A"], p["C"], p["G"], p["T"])
                fh.write(f"{contig}\t{site}\t" +
                         "\t".join(f"{v}" for v in vals) + "\n")
        written.append(path)
    if verbose:
        print(f"[scan] wrote {len(written)} per-read files to {output_dir}")
    return written

"""Synthetic flowcell-like workload generation (bench + heuristic tuning).

The bundled reference test data is 3 fast5s; every bucketing/packing/
split heuristic tuned against it sees an unrepresentatively narrow
(band width, length, path-class) distribution. This module generates
reads FROM the pore model over a random genome with a nanopore-like
error process, so the guide anchors carry realistic gaps and the band
geometry (bulges, getSplitPoints-class splits, width classes) matches
a real flowcell's diversity:

  * read lengths log-uniform over a caller-chosen event range
    (real flowcells: ~1k-100k events);
  * substitution/insertion/deletion errors at nanopore-like rates
    build the guide CIGAR, so anchor gaps and band bulges arise the
    same way they do from a real basecaller+bwa guide;
  * events per k-mer follow a geometric stay distribution (~1.4x);
  * CpG-ambiguity editions give the natural P in {2, 4} mix of
    methylation workloads (adjacent CpGs inside one k-mer window).

The reference has no analogue (its tests replay shipped fast5s); this
exists because batch-shape heuristics need a distribution, not a sample
of three. ``seeded_pore_model`` and ``seeded_hdp`` make the model side
from a seed too, so tests and chip runs need no data files.
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

from signalalign_jax.io.guide import GuideAlignment
from signalalign_jax.io.read import NanoporeReadData
from signalalign_jax.models.hdp_model import NanoporeHDP
from signalalign_jax.models.pore_model import PoreModel, ScalingParams
from signalalign_jax.utils.alphabet import Alphabet

BASES = "ACGT"


def seeded_pore_model(alphabet: str = "ACGT", kmer_length: int = 6,
                      seed: int = 0) -> PoreModel:
    """A random pore model with the shape of the r9.4 450 bps template
    models (nanopolish tables, 4^6 k-mers): level means 60-130 pA, level
    sd 1-3 pA, noise mean 0.8-2.5 with sd 0.2-0.7, lambda = mean^3/sd^2.
    Every modified base (any letter outside ACGT, e.g. E = 5mC) reads as
    C with a per-k-mer offset of N(0, 1.5) pA at each modified position,
    so a modified k-mer sits near its canonical twin as real ones do.
    """
    rng = np.random.default_rng(seed)
    model = PoreModel(alphabet, kmer_length)
    canon = PoreModel("ACGT", kmer_length)
    canon.level_mean = rng.uniform(60.0, 130.0, canon.num_kmers)
    canon.level_sd = rng.uniform(1.0, 3.0, canon.num_kmers)
    canon.noise_mean = rng.uniform(0.8, 2.5, canon.num_kmers)
    canon.noise_sd = rng.uniform(0.2, 0.7, canon.num_kmers)
    table = str.maketrans({c: "C" for c in alphabet if c not in "ACGT"})
    for kid in range(model.num_kmers):
        kmer = model.alphabet.index_to_kmer(kid)
        base = canon.alphabet.kmer_index(kmer.translate(table))
        n_mod = sum(c not in "ACGT" for c in kmer)
        model.level_mean[kid] = canon.level_mean[base] \
            + rng.normal(0.0, 1.5) * n_mod
        model.level_sd[kid] = canon.level_sd[base]
        model.noise_mean[kid] = canon.noise_mean[base]
        model.noise_sd[kid] = canon.noise_sd[base]
    model.noise_lambda = model.noise_mean ** 3 / model.noise_sd ** 2
    return model


def seeded_hdp(model: PoreModel, grid_start: float = 30.0,
               grid_stop: float = 180.0, grid_length: int = 1200
               ) -> NanoporeHDP:
    """An HDP emission table built from the model's Gaussians: per k-mer
    the N(level_mean, level_sd) density sampled on the grid, with its
    exact derivative as the spline knot slopes. The grid defaults are
    the HDP trainer's (hdp/train.py, the reference trainModels
    defaults); the table is (num_kmers, grid_length)."""
    grid = np.linspace(grid_start, grid_stop, grid_length)
    mu = model.level_mean[:, None]
    sd = model.level_sd[:, None]
    z = (grid[None, :] - mu) / sd
    dens = np.exp(-0.5 * z * z) / (sd * np.sqrt(2.0 * np.pi))
    n = model.num_kmers
    return NanoporeHDP(alphabet=Alphabet(model.alphabet.letters,
                                         model.kmer_length),
                       grid=grid, densities=dens, slopes=-z / sd * dens,
                       observed=np.ones(n, dtype=bool), num_dps=n)


def synthetic_genome(rng: np.random.Generator, length: int = 400_000) -> str:
    return "".join(rng.choice(list(BASES), size=length))


def write_genome_fasta(genome: str, path: str, contig: str = "synth") -> str:
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        fh.write(f">{contig}\n")
        for i in range(0, len(genome), 10000):
            fh.write(genome[i:i + 10000] + "\n")
    os.replace(tmp, path)
    return path


def synthetic_read(rng: np.random.Generator, genome: str, model: PoreModel,
                   start: int, n_bases: int, label: str,
                   sub_rate: float = 0.05, ins_rate: float = 0.03,
                   del_rate: float = 0.03, stay_p: float = 0.28,
                   contig: str = "synth"
                   ) -> Tuple[NanoporeReadData, GuideAlignment]:
    """One read + its guide alignment from a genome window.

    The error process walks the reference window emitting M/I/D runs
    (the guide CIGAR a real basecall+aligner would produce); events are
    sampled per READ k-mer from the model's Gaussians with a geometric
    stay count (mean 1/(1-stay_p) events per k-mer).
    """
    k = model.kmer_length
    ref_seq = genome[start:start + n_bases]
    read_chars: List[str] = []
    ops: List[List] = []    # run-length [count, op]

    def push(op: str):
        if ops and ops[-1][1] == op:
            ops[-1][0] += 1
        else:
            ops.append([1, op])

    i = 0
    while i < len(ref_seq):
        r = rng.random()
        if r < del_rate:
            push("D")
            i += 1
            continue
        if r < del_rate + ins_rate:
            read_chars.append(BASES[rng.integers(4)])
            push("I")
            continue
        c = ref_seq[i]
        if r < del_rate + ins_rate + sub_rate:
            c = BASES[(BASES.index(c) + 1 + rng.integers(3)) % 4]
        read_chars.append(c)
        push("M")
        i += 1
    read_seq = "".join(read_chars)
    if len(read_seq) < 2 * k:
        raise ValueError("window too small for a read")

    ids = model.alphabet.seq_to_kmer_ids(read_seq)
    n_ev_per = 1 + rng.geometric(1.0 - stay_p, size=len(ids)) - 1
    n_ev_per = np.minimum(n_ev_per, 8)
    total = int(n_ev_per.sum())
    means = np.repeat(model.level_mean[ids], n_ev_per) \
        + np.repeat(model.level_sd[ids], n_ev_per) \
        * rng.standard_normal(total)
    noises = np.abs(np.repeat(model.noise_mean[ids], n_ev_per)
                    + rng.standard_normal(total))
    event_map = np.concatenate(
        [np.concatenate([[0], np.cumsum(n_ev_per)[:-1]]),
         np.full(k - 1, total - 1)]).astype(np.int64)
    events = np.stack([means, noises,
                       np.full(total, 0.002),
                       np.arange(total) * 0.002], axis=1)
    read = NanoporeReadData(
        read_label=label, template_read=read_seq, events=events,
        event_map=event_map, model_states=None, p_model_state=None,
        kmer_length=k, params=ScalingParams(), rna=False)
    guide = GuideAlignment(
        contig=contig, forward=True, window_start=start,
        window_end=start + n_bases, query_start=0,
        query_end=len(read_seq),
        ops=[(int(n), op) for n, op in ops])
    return read, guide


def build_synthetic_batch(model: PoreModel, n_reads: int = 100,
                          ev_min: int = 1000, ev_max: int = 100_000,
                          seed: int = 0, genome_len: int = 400_000,
                          stay_p: float = 0.28,
                          fasta_path: Optional[str] = None,
                          ambig_frac: float = 0.0,
                          ambig_motif: Tuple[str, str] = ("CG", "YG")):
    """A flowcell-like read batch: (rgs, reference, ambig_rgs,
    ambig_reference, fasta_path).

    Read event counts are log-uniform in [ev_min, ev_max]. The first
    ``ambig_frac`` of reads are returned separately with a
    motif-edited (CpG-ambiguous) reference edition — the methylation-
    calling configuration with its natural P in {2, 4} mix.
    """
    from signalalign_jax.io.reference import ProcessedReference

    rng = np.random.default_rng(seed)
    genome = synthetic_genome(rng, genome_len)
    if fasta_path is None:
        fasta_path = os.path.join(tempfile.gettempdir(),
                                  f"signalalign_synth_{seed}_{genome_len}.fa")
    if not os.path.exists(fasta_path):
        write_genome_fasta(genome, fasta_path)
    reference = ProcessedReference(fasta_path)
    n_ambig = int(round(n_reads * ambig_frac))
    ambig_reference = (ProcessedReference(fasta_path, motifs=[ambig_motif])
                       if n_ambig else None)

    ev_targets = np.exp(rng.uniform(np.log(ev_min), np.log(ev_max),
                                    size=n_reads))
    rgs, ambig_rgs = [], []
    mean_ev_per_base = 1.0 / (1.0 - stay_p)
    for ri, ev_t in enumerate(ev_targets):
        n_bases = max(int(ev_t / mean_ev_per_base), 4 * model.kmer_length)
        start = int(rng.integers(0, max(genome_len - n_bases - 1, 1)))
        read, guide = synthetic_read(rng, genome, model, start, n_bases,
                                     label=f"synth{ri}", stay_p=stay_p)
        (ambig_rgs if ri < n_ambig else rgs).append((read, guide))
    return rgs, reference, ambig_rgs, ambig_reference, fasta_path

"""Model training: Baum-Welch transition EM, Gaussian emission updates,
HDP training-data assembly.

reference: src/signalalign/train/trainModels.py —
expectation_maximization_training (986), train_transitions (922),
train_normal_emmissions (735), CreateHdpTrainingData/train_hdp (427/830).

The reference accumulates expectations in per-read TSV files summed in
Python; here expectations come back from the device kernels as (3,3)
tensors (already psum-reducible across a mesh, parallel/distributed.py)
and the M-step is a normalization.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from signalalign_jax.models.pore_model import PoreModel
from signalalign_jax.ops import banded_fb as bfb
from signalalign_jax.pipeline.runner import run_alignment_batch
from signalalign_jax.pipeline.signal_align import AlignmentConfig


@dataclasses.dataclass
class EMResult:
    model: PoreModel
    likelihoods: List[float]          # reference-style (tot * n_diagonals)
    log_likelihoods: List[float]      # true sum of total log probs
    transitions_history: List[np.ndarray]
    # per-iteration raw (3, num_kmers) emission moments (device kexp sums);
    # empty unless the EM ran with emission expectations
    kexp_history: List[np.ndarray] = dataclasses.field(default_factory=list)
    expectations_files: List[str] = dataclasses.field(default_factory=list)
    checkpoint_files: List[str] = dataclasses.field(default_factory=list)


def normalize_transitions_expectations(texp: np.ndarray) -> np.ndarray:
    """Row-normalize the 3x3 transition expectation matrix.

    reference: normalize_transitions_expectations
    (hiddenMarkovModel.py:477-487).
    """
    out = texp.astype(np.float64).copy()
    for i in range(3):
        rs = out[i].sum()
        if rs > 0:
            out[i] /= rs
    return out


def run_alignment_batch_grouped(batch, reference, model, config,
                                hdp=None, strand_template: bool = True):
    """run_alignment_batch over entries that may carry a per-read
    reference override: ``(read, guide)`` uses the shared ``reference``,
    ``(read, guide, ref_i)`` aligns against ``ref_i`` (per-sample
    motif/positions-edited genomes, trainModels.py samples[] semantics).
    Entries sharing a reference batch together; result order follows the
    input order."""
    from collections import defaultdict as _dd
    groups = _dd(list)
    refs = {}
    order = []
    for i, rg in enumerate(batch):
        ref_i = rg[2] if len(rg) > 2 and rg[2] is not None else reference
        refs[id(ref_i)] = ref_i
        groups[id(ref_i)].append((i, rg[0], rg[1]))
        order.append(i)
    out = [None] * len(batch)
    for key, items in groups.items():
        res = run_alignment_batch([(r, g) for _, r, g in items],
                                  refs[key], model, config, hdp=hdp,
                                  strand_template=strand_template)
        # per-read fault isolation can drop reads: match by read_label
        by_label = {}
        for r in res:
            by_label.setdefault(r.read_label, []).append(r)
        for i, read, _ in items:
            lst = by_label.get(read.read_label)
            if lst:
                out[i] = lst.pop(0)
    return [r for r in out if r is not None]


def em_train(
    reads_and_guides,
    reference,
    model: PoreModel,
    iterations: int = 3,
    config: Optional[AlignmentConfig] = None,
    hdp=None,
    update_transitions: bool = True,
    update_emissions: bool = False,
    emission_prior_weight: float = 0.0,
    min_sd: float = 0.0,
    training_bases: Optional[int] = None,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_prefix: str = "template_trained",
    write_expectations: bool = False,
    cross_host: bool = False,
    verbose: bool = False,
    assert_monotonic: bool = False,
    strand_template: bool = True,
) -> EMResult:
    """Unified per-iteration Baum-Welch EM over a read batch.

    Each iteration runs ONE expectation pass on device (transition posteriors
    AND per-kmer emission moments come back from the same kernel,
    banded_fb._expectations_core) and applies both M-steps — vs the
    reference's two separate alignment passes per round
    (expectation_maximization_training, trainModels.py:986-1060, whose
    emission pass re-aligns with output_format=full). The likelihood trace
    is asserted non-decreasing in test mode (trainModels.py:966-979).

    ``training_bases`` caps the E-step to a random read subset totalling
    that many read bases per iteration (filter_reads trim semantics,
    trainModels.py:1144 / filter_reads.py:155-170).
    ``reads_and_guides`` entries may be ``(read, guide)`` pairs or
    ``(read, guide, reference)`` triples: a triple aligns that read
    against its own (per-sample motif/positions-edited) reference — the
    reference edits each sample's genome before aligning
    (processReferenceFasta per sample, trainModels.py samples[] schema),
    so an mC sample's expectations carry E-labelled kmers.
    ``strand_template=False`` trains a complement-strand model on 2D
    complement reads (trainModels trains both strand HMMs for twoD
    chemistry). ``hdp`` + config.emission_mode=MODE_HDP runs the
    threeStateHdp transition EM (HdpHmm expectations) — emission
    updates then come from the HDP training path, not the Gaussian
    M-step. ``checkpoint_dir``
    writes a model file per iteration (trainModels.py:938-949) and, with
    ``write_expectations``, a reference-format expectations file summing
    the batch (continuousHmm_writeToFile layout).
    """
    import random as _random

    from signalalign_jax.models.expectations import (
        emission_slots_from_kexp, write_expectations_file)

    model = copy.deepcopy(model)
    config = config or AlignmentConfig()
    config = dataclasses.replace(config, compute_expectations=True)
    likelihoods: List[float] = []
    lls: List[float] = []
    history: List[np.ndarray] = []
    kexp_history: List[np.ndarray] = []
    exp_files: List[str] = []
    ckpt_files: List[str] = []

    for it in range(iterations):
        batch = list(reads_and_guides)
        if training_bases:
            _random.Random(seed + it).shuffle(batch)
            subset, n_bases = [], 0
            for rg in batch:
                if n_bases > training_bases:
                    break
                subset.append(rg)
                n_bases += rg[0].read_length
            batch = subset
        results = run_alignment_batch_grouped(
            batch, reference, model, config, hdp=hdp,
            strand_template=strand_template)
        texp = np.zeros((3, 3))
        kexp = np.zeros((3, model.alphabet.num_kmers))
        lik = 0.0
        ll = 0.0
        for r in results:
            texp += r.transition_expectations
            if r.emission_expectations is not None:
                kexp += r.emission_expectations
            lik += r.likelihood
            ll += r.total_log_prob
        if cross_host:
            # multi-host EM: every process aligned only its host_shard of
            # the reads; sum the (tiny) expectation tensors across hosts
            # so the M-step below is identical everywhere (replaces the
            # reference's expectation-TSV file merge)
            import jax
            if jax.process_count() > 1:
                from jax.experimental import multihost_utils
                flat = np.concatenate([texp.reshape(-1), kexp.reshape(-1),
                                       [lik, ll]])
                import jax.numpy as jnp
                tot = np.asarray(multihost_utils.process_allgather(
                    jnp.asarray(flat))).sum(axis=0)
                texp = tot[:9].reshape(3, 3)
                kexp = tot[9:-2].reshape(kexp.shape)
                lik, ll = float(tot[-2]), float(tot[-1])
        mean_exp, sd_exp, posteriors, observed = emission_slots_from_kexp(
            kexp, model.level_mean)
        if write_expectations and checkpoint_dir:
            ep = os.path.join(checkpoint_dir,
                              f"{checkpoint_prefix}_{it}"
                              ".template.expectations.tsv")
            write_expectations_file(
                ep, model, texp.reshape(-1), lik,
                mean_expectations=mean_exp, sd_expectations=sd_exp,
                posteriors=posteriors, observed=observed)
            exp_files.append(ep)
        if update_transitions:
            probs = normalize_transitions_expectations(texp)
            model.set_transitions(probs.reshape(-1))
            history.append(probs)
        if update_emissions:
            # HmmModel.normalize emission M-step
            # (hiddenMarkovModel.py:488-517): µ̂ = Σpx/Σp, σ̂ = √(Σp(x−µ̂)²/Σp).
            # ``emission_prior_weight`` > 0 blends with the current model
            # exactly like train_normal_emmissions (trainModels.py:761-828,
            # prior weight 100): sparsely-observed kmers would otherwise
            # collapse their sd and crater the next E-step's likelihood.
            safe = np.maximum(posteriors, 1e-300)
            u = mean_exp / safe
            o = np.sqrt(sd_exp / safe)
            w = emission_prior_weight
            if w > 0:
                u = (mean_exp + model.level_mean * w) / (posteriors + w)
                o = (o * posteriors + model.level_sd * w) / (posteriors + w)
            upd = observed & (u > 0)
            model.level_mean = np.where(upd, u, model.level_mean)
            model.level_sd = np.maximum(
                np.where(upd & (o > 0), o, model.level_sd), min_sd)
        model.likelihood = lik
        likelihoods.append(lik)
        lls.append(ll)
        kexp_history.append(kexp)
        if checkpoint_dir:
            cp = os.path.join(checkpoint_dir,
                              f"{checkpoint_prefix}_{it}.model")
            model.write(cp)
            ckpt_files.append(cp)
        if verbose:
            print(f"[train] iter {it}: log-likelihood {ll:.2f} "
                  f"({len(batch)} reads)", file=sys.stderr)
        if assert_monotonic and it > 0 and ll + 1e-6 < lls[-2]:
            raise AssertionError(
                f"EM log-likelihood decreased: {lls[-2]} -> {ll}")
    return EMResult(model=model, likelihoods=likelihoods,
                    log_likelihoods=lls, transitions_history=history,
                    kexp_history=kexp_history, expectations_files=exp_files,
                    checkpoint_files=ckpt_files)


def em_train_transitions(
    reads_and_guides,
    reference,
    model: PoreModel,
    iterations: int = 3,
    config: Optional[AlignmentConfig] = None,
    verbose: bool = False,
    assert_monotonic: bool = False,
) -> EMResult:
    """Transition-only Baum-Welch EM (train_transitions,
    trainModels.py:922-985). Thin wrapper over em_train."""
    return em_train(reads_and_guides, reference, model,
                    iterations=iterations, config=config,
                    update_transitions=True, update_emissions=False,
                    verbose=verbose, assert_monotonic=assert_monotonic)


def collect_kmer_observations(results, model: PoreModel,
                              threshold: float = 0.0,
                              max_per_kmer: Optional[int] = None):
    """(kmer -> descaled event means) from alignment results.

    reference: the buildAlignment table path (CreateHdpTrainingData,
    trainModels.py:427-520): per aligned pair above threshold, the
    descaled event mean keyed by the PATH k-mer; optionally keep the top-N
    highest-probability observations per k-mer
    (generate_top_n_kmers_from_sa_output, build_alignments.py).
    """
    per_kmer: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for r in results:
        p = r.params
        for prob_int, x, y, kmer in r.aligned_pairs:
            prob = prob_int / 10000000.0
            if prob < threshold:
                continue
            idx = model.alphabet.kmer_index(kmer)
            mu = model.level_mean[idx]
            ev = float(r.events[y + r.event_offset, 0])
            descaled = (ev + p.var * mu - p.scale * mu - p.shift) / p.var
            per_kmer[kmer].append((prob, descaled))
    out: Dict[str, np.ndarray] = {}
    for kmer, vals in per_kmer.items():
        vals.sort(key=lambda t: -t[0])
        if max_per_kmer:
            vals = vals[:max_per_kmer]
        out[kmer] = np.array([v for _, v in vals])
    return out


def train_gaussian_emissions(observations: Dict[str, np.ndarray],
                             model: PoreModel,
                             prior_weight: float = 100.0,
                             use_median: bool = False,
                             min_sd: float = 0.0,
                             mod_only: bool = False) -> PoreModel:
    """Per-kmer Gaussian update with an original-model prior.

    reference: train_normal_emmissions (trainModels.py:735-828):
    new_mean = (sum(data) + prior_mean*W) / (n + W), likewise for sd,
    with optional median/MAD estimators and a min-sd floor.
    """
    from scipy.stats import median_abs_deviation

    model = copy.deepcopy(model)
    for kmer, data in observations.items():
        if mod_only and set(kmer) <= set("ACGT"):
            continue
        n = len(data)
        if n == 0:
            continue
        if use_median:
            mean_n = float(np.median(data)) * n
            sd_n = float(median_abs_deviation(data, scale="normal")) * n
        else:
            mean_n = float(np.mean(data)) * n
            sd_n = float(np.std(data)) * n
        idx = model.alphabet.kmer_index(kmer)
        pm = model.level_mean[idx] * prior_weight
        ps = model.level_sd[idx] * prior_weight
        model.level_mean[idx] = (mean_n + pm) / (n + prior_weight)
        model.level_sd[idx] = max((sd_n + ps) / (n + prior_weight), min_sd)
    return model


def write_hdp_training_file(observations: Dict[str, np.ndarray], path: str,
                            strand: str = "t") -> str:
    """buildAlignment.tsv for the HDP Gibbs trainer.

    Format (CreateHdpTrainingData.write_hdp_training_file /
    nanopore_hdp update_nhdp_from_alignment): kmer \t strand \t event_mean.
    """
    with open(path, "w") as fh:
        for kmer, vals in sorted(observations.items()):
            for v in vals:
                fh.write(f"{kmer}\t{strand}\t{v:f}\n")
    return path


def build_alignment_from_tsvs(tsv_paths, model: PoreModel,
                              out_path: str,
                              max_per_kmer: int = 100,
                              min_probability: float = 0.8,
                              strands=("t",),
                              full: bool = True) -> str:
    """Top-N highest-probability observations per k-mer from SA output TSVs.

    reference: build_alignments.py generate_top_n_kmers_from_sa_output
    (heap-nlargest per kmer over full-format rows with prob >= threshold);
    output rows are ``kmer \t strand \t descaled_mean \t prob`` sorted by
    kmer, matching the buildAlignment table consumed by HDP training.
    """
    import heapq
    from collections import defaultdict

    per_kmer = defaultdict(list)
    for path in tsv_paths:
        with open(path) as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if full:
                    if len(parts) < 16:
                        continue
                    strand, prob = parts[4], float(parts[12])
                    kmer, descaled = parts[15], float(parts[13])
                else:   # assignments format: kmer strand descaled prob
                    if len(parts) < 4:
                        continue
                    kmer, strand = parts[0], parts[1]
                    descaled, prob = float(parts[2]), float(parts[3])
                if strand not in strands or prob < min_probability:
                    continue
                entry = (prob, descaled, strand)
                bucket = per_kmer[kmer]
                if len(bucket) < max_per_kmer:
                    heapq.heappush(bucket, entry)
                elif entry > bucket[0]:
                    heapq.heapreplace(bucket, entry)
    with open(out_path, "w") as fh:
        for kmer in sorted(per_kmer):
            for prob, descaled, strand in sorted(per_kmer[kmer],
                                                 reverse=True):
                fh.write(f"{kmer}\t{strand}\t{descaled:f}\t{prob:f}\n")
    return out_path

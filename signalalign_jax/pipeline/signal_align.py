"""Per-read signal alignment pipeline: events + guide alignment -> banded
posterior decoding -> output records.

This is the equivalent of the signalMachine per-read flow
(impl/signalMachine.c:484-940): re-estimate per-read scaling, trim the event
sequence to the guide window, remap anchors, split at large anchor gaps, run
the banded forward-backward, and emit aligned pairs / output rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from signalalign_jax.io.guide import GuideAlignment
from signalalign_jax.io.output import (build_full_rows, build_vc_rows,
                                       posterior_score)
from signalalign_jax.io.read import NanoporeReadData
from signalalign_jax.io.reference import ProcessedReference
from signalalign_jax.models.pore_model import PoreModel, ScalingParams
from signalalign_jax.ops import banded_fb as bfb
from signalalign_jax.ops.band_geometry import (band_widths, build_band,
                                               get_split_points,
                                               remap_anchors_to_events)
from signalalign_jax.ops.scaling import (adjust_events_for_drift,
                                         estimate_nanopore_params)
from signalalign_jax.utils.alphabet import (DEFAULT_AMBIG_BASES,
                                            max_paths_per_kmer)


@dataclasses.dataclass
class AlignmentConfig:
    threshold: float = 0.01
    diagonal_expansion: int = 50       # signalMachine.c:487 default
    constraint_trim: int = 14
    split_bigger_than: int = 3000 * 3000
    # split segments whose band bulges past this width at the bulge's
    # flanking anchors, so the bulk of a read keeps a narrow band
    # bucket; cap segment diagonal counts so a long read becomes several
    # problems that sweep side by side in one batch instead of one long
    # sequential sweep, and shape buckets stay homogeneous
    # (band_geometry.split_segment_by_width). Splitting at anchors is
    # exact up to the anchor pinning the path.
    max_band_width: int = 768
    max_segment_diagonals: int = 11800
    estimate_params: bool = True       # signalMachine ESTIMATE_PARAMS
    emission_mode: int = bfb.MODE_MEAN_ONLY
    ambig_map: Dict[str, str] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_AMBIG_BASES))
    compute_expectations: bool = False
    assignment_threshold: float = 0.1  # signalMachine ASSIGNMENT_THRESHOLD
    # isolate sparse adjacent-degenerate (P>2) windows into their own
    # segments so the bulk runs at 2 paths per cell
    # (band_geometry.split_segment_by_paths); it adds shape buckets, so
    # it only pays on batches large enough to fill them
    # (scripts/measure_path_split.py measures it). None = AUTO: the
    # batch runner enables it for batches of >= 128 reads.
    path_split: Optional[bool] = None


@dataclasses.dataclass
class ReadAlignment:
    read_label: str
    contig: str
    forward: bool
    strand_template: bool
    aligned_pairs: List[Tuple[int, int, int, str]]  # (prob_int, x, y, kmer)
    score: float
    target: str
    event_offset: int
    ref_offset: int
    params: ScalingParams
    events: np.ndarray            # drift-adjusted full event table
    total_log_prob: float
    rna: bool = False
    transition_expectations: Optional[np.ndarray] = None
    likelihood: float = 0.0
    # (3, num_kmers) per-kmer emission moments [Σp, Σp·dx, Σp·dx²]
    # (banded_fb._expectations_core; convert with
    # models.expectations.emission_slots_from_kexp)
    emission_expectations: Optional[np.ndarray] = None
    # site-calling mode (runner call_variants): per-read variant-call
    # marginals (marginalize_full_variants schema, a
    # variant_caller.CallTable); aligned_pairs stays empty on this path
    variant_calls: Optional[object] = None

    def full_rows(self, model: PoreModel):
        return build_full_rows(
            self.aligned_pairs, self.target, self.events, model, self.params,
            self.contig, self.read_label, self.strand_template, self.forward,
            self.event_offset, self.ref_offset, self.rna)

    def vc_rows(self, model: PoreModel, ambig_map=None):
        return build_vc_rows(
            self.aligned_pairs, self.target, model,
            ambig_map or DEFAULT_AMBIG_BASES, self.contig, self.read_label,
            self.strand_template, self.forward, self.event_offset,
            self.ref_offset, self.score, self.rna)


def _bucket_w(w: int) -> int:
    # coarse power-of-two-ish buckets: padded band compute is cheap, while
    # every distinct (W, Dpad) shape costs a kernel compile
    for b in (64, 128, 256, 512, 768, 1024):
        if w <= b:
            return b
    return ((w + 255) // 256) * 256


def _bucket_d(d: int) -> int:
    # pow2 up to 8192, then 4096-granular: the diagonal count divides the
    # kernel wall time directly, so coarse pow2 buckets above 8k waste up
    # to half the sweep on padding; the segment splitter targets
    # max_segment_diagonals so long reads pack the 12288 bucket densely
    for b in (2048, 4096, 8192, 12288, 16384):
        if d + 1 <= b:
            return b
    return ((d + 4096) // 4096) * 4096


def align_read(read: NanoporeReadData, guide: GuideAlignment,
               reference: ProcessedReference, model: PoreModel,
               config: Optional[AlignmentConfig] = None,
               hdp=None, strand_template: bool = True) -> ReadAlignment:
    """Align one read strand against its guide window.

    ``strand_template=False`` runs the complement strand of a 2D read: the
    target comes from the opposite reference edition
    (referenceSequence_getComplementTarget, signalMachineUtils.c:68-70) and
    the coordinate shift is the opposite window end (rCoordinateShift_c =
    pA->end1, signalMachine.c:749).
    """
    config = config or AlignmentConfig()
    k = model.kmer_length

    # RNA coordinate flip on the query window (signalMachine.c:716-720):
    # the stored read was reversed, so the guide's query window flips too.
    qstart, qend = guide.query_start, guide.query_end
    if read.rna:
        qstart, qend = read.read_length - guide.query_end, read.read_length - guide.query_start

    if strand_template:
        target = reference.template_target(
            guide.contig, guide.window_start, guide.window_end, guide.forward)
    else:
        target = reference.complement_target(
            guide.contig, guide.window_start, guide.window_end, guide.forward)
    if read.rna:
        # fastaHandler_ReferenceSequenceConstructFull rna branch: the target
        # is reversed (3'->5' signal order)
        target = target[::-1]

    # --- per-read scaling (signalMachine ESTIMATE_PARAMS path)
    params = dataclasses.replace(read.params)
    if config.estimate_params:
        assign_read = read.assign_read or read.template_read
        assign_map = read.assign_event_map if read.assign_event_map is not None \
            else read.event_map
        params = estimate_nanopore_params(assign_read, assign_map,
                                          read.events, model, params)
    events = adjust_events_for_drift(read.events, params.drift)

    # --- event window from the guide's query span
    ev_start = int(read.event_map[qstart])
    ev_end = int(read.event_map[qend - 1])
    window_events = events[ev_start:ev_end]
    lX = len(target) - k + 1
    lY = ev_end - ev_start
    if lY <= 0 or lX <= 0:
        raise ValueError(f"{read.read_label}: empty alignment window")

    # --- anchors: target-space pairs -> event-space, overlap-filtered
    anchors_rb = guide.anchor_pairs(config.constraint_trim)
    if read.rna:
        # flip query coords to the reversed-read frame, ref coords to the
        # reversed-target frame
        Lw = guide.window_length
        anchors_rb = [(Lw - 1 - x - (k - 1), read.read_length - 1 - q)
                      for x, q in anchors_rb]
        anchors_rb = sorted((x, q) for x, q in anchors_rb if x >= 0)
    anchors = remap_anchors_to_events(anchors_rb, read.event_map, qstart)
    anchors = [(x, y) for x, y in anchors if 0 <= x < lX and 0 <= y < lY]

    # --- split at large anchor gaps, run each segment
    splits = get_split_points(anchors, lX, lY, config.split_bigger_than,
                              True, True)
    all_pairs: List[Tuple[int, int, int, str]] = []
    texp_total = np.zeros((3, 3))
    kexp_total = np.zeros((3, model.alphabet.num_kmers))
    likelihood = 0.0
    total_lp = 0.0
    j = 0
    for (x1, y1, x2, y2) in splits:
        seg_chars = target[x1:x2 + k - 1]
        seg_events = window_events[y1:y2]
        seg_anchors = []
        while j < len(anchors):
            ax, ay = anchors[j]
            if ax + ay >= x2 + y2:
                break
            seg_anchors.append((ax - x1, ay - y1))
            j += 1
        pairs, seg_out = _align_segment(
            seg_chars, seg_events, seg_anchors, model, params, config, hdp)
        total_lp += float(seg_out["total_f"])
        if config.compute_expectations:
            texp_total += seg_out["texp"]
            kexp_total += seg_out["kexp"]
            likelihood += float(seg_out["total_f"]) * (len(seg_chars) - k + 1 + len(seg_events))
        for prob, x, y, kmer in pairs:
            all_pairs.append((prob, x + x1, y + y1, kmer))

    all_pairs.sort(key=lambda r: (r[1] + r[2], r[1]))
    score = posterior_score(all_pairs)

    if strand_template:
        fwd_out, ref_shift = guide.output_frame(read.rna)
    else:
        fwd_out = guide.forward
        ref_shift = guide.window_end if guide.forward else guide.window_start
    return ReadAlignment(
        read_label=read.read_label, contig=guide.contig, forward=fwd_out,
        strand_template=strand_template, aligned_pairs=all_pairs, score=score,
        target=target, event_offset=ev_start, ref_offset=ref_shift,
        params=params, events=events, total_log_prob=total_lp, rna=read.rna,
        transition_expectations=texp_total if config.compute_expectations else None,
        likelihood=likelihood,
        emission_expectations=kexp_total if config.compute_expectations else None)


def align_read_2d(read2d, guide: GuideAlignment,
                  reference: ProcessedReference,
                  template_model: PoreModel, complement_model: PoreModel,
                  config: Optional[AlignmentConfig] = None,
                  template_hdp=None, complement_hdp=None
                  ) -> Tuple[ReadAlignment, ReadAlignment]:
    """Both strands of a 2D read (signalMachine.c twoD path, 850-916):
    template aligned with the template model against the template target,
    complement with the complement model against the opposite edition; both
    share the guide anchors remapped through their own 2D event maps."""
    t = align_read(read2d.template, guide, reference, template_model,
                   config, hdp=template_hdp, strand_template=True)
    c = align_read(read2d.complement, guide, reference, complement_model,
                   config, hdp=complement_hdp, strand_template=False)
    return t, c


def _align_segment(seg_chars: str, seg_events: np.ndarray,
                   seg_anchors: Sequence[Tuple[int, int]],
                   model: PoreModel, params: ScalingParams,
                   config: AlignmentConfig, hdp=None):
    k = model.kmer_length
    lX = len(seg_chars) - k + 1
    lY = len(seg_events)
    xmyL, xmyR = build_band(seg_anchors, lX, lY, config.diagonal_expansion)
    W = _bucket_w(int(band_widths(xmyL, xmyR).max()))
    Dpad = _bucket_d(lX + lY)
    P = max_paths_per_kmer(seg_chars, k, config.ambig_map)

    problem = bfb.prepare_problem(
        seg_chars, seg_events, model, params, config.ambig_map,
        W=W, Dpad=Dpad, P=P, mode=config.emission_mode,
        anchor_pairs=seg_anchors, expansion=config.diagonal_expansion,
        ragged_start=True, ragged_end=True,
        scale_noise=(config.emission_mode in (bfb.MODE_FULL_DESCALED,)),
        hdp=hdp)
    res = bfb.run_banded_fb(problem, W=W, P=P,
                            with_expectations=config.compute_expectations)
    pairs = bfb.extract_aligned_pairs(problem, res["post"], config.threshold)
    return pairs, res

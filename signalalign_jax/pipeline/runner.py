"""Multi-read signal-alignment driver: the replacement for
runSignalAlign + multithread_signal_alignment (one process + one
signalMachine subprocess per read in the reference,
src/signalalign/signalAlignment.py:740-848).

Reads are prepared host-side (fast5 load, scaling, anchors, banding),
bucketed by device shape, and executed as batched XLA programs
(ops/batch.py) on every local device.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from signalalign_jax.io.guide import GuideAlignment, guide_from_sam_record
from signalalign_jax.io.output import (posterior_score,
                                       write_assignments_tsv,
                                       write_full_tsv, write_vc_tsv)
from signalalign_jax.io.read import NanoporeReadData
from signalalign_jax.io.reference import ProcessedReference
from signalalign_jax.io.sam import filter_reads
from signalalign_jax.models.pore_model import PoreModel, ScalingParams
from signalalign_jax.ops import banded_fb as bfb
from signalalign_jax.ops.band_geometry import (band_widths, build_band,
                                               get_split_points,
                                               remap_anchors_to_events,
                                               split_segment_by_paths,
                                               split_segment_by_width)
from signalalign_jax.ops.scaling import (adjust_events_for_drift,
                                         estimate_nanopore_params)
from signalalign_jax.pipeline.signal_align import (AlignmentConfig,
                                                   ReadAlignment, _bucket_d,
                                                   _bucket_w)
from signalalign_jax.utils.alphabet import (max_paths_per_kmer,
                                            paths_per_kmer)


# dispatch-order trace (None = off): when a list, the batch runner
# appends ("dispatch"|"drain", device_slot, in_flight_after) events so
# tests and chip_smoke.py can assert the per-device queues actually
# OVERLAP (several devices holding in-flight chunks at once) instead of
# serializing — a queue-logic bug would otherwise be invisible until
# multi-card hardware
_dispatch_trace: Optional[list] = None


def set_dispatch_trace(trace: Optional[list]) -> None:
    global _dispatch_trace
    _dispatch_trace = trace


@dataclasses.dataclass
class SegmentTask:
    read_idx: int
    x1: int
    y1: int
    problem: bfb.BandedProblem
    W: int
    Dpad: int
    P: int
    # site-calling mode: 1-based segment cell x positions whose k-mer
    # has a degenerate char at its LAST base (the cells that report in
    # MarginalizeFullVariants, variantCaller.py:123-187)
    cells: Optional[np.ndarray] = None


@dataclasses.dataclass
class PreparedRead:
    read: NanoporeReadData
    guide: GuideAlignment
    target: str
    params: ScalingParams
    events: np.ndarray
    ev_start: int
    segments: List[int]       # indices into the global segment list
    failure: Optional[str] = None


def prepare_read(read: NanoporeReadData, guide: GuideAlignment,
                 reference: ProcessedReference, model: PoreModel,
                 config: AlignmentConfig, hdp=None,
                 strand_template: bool = True):
    """Host-side prep of one read -> list of SegmentTasks (unbucketed)."""
    k = model.kmer_length
    qstart, qend = guide.query_start, guide.query_end
    if read.rna:
        qstart, qend = (read.read_length - guide.query_end,
                        read.read_length - guide.query_start)
    if strand_template:
        target = reference.template_target(guide.contig, guide.window_start,
                                           guide.window_end, guide.forward)
    else:
        target = reference.complement_target(
            guide.contig, guide.window_start, guide.window_end, guide.forward)
    if read.rna:
        target = target[::-1]

    params = dataclasses.replace(read.params)
    if config.estimate_params:
        assign_read = read.assign_read or read.template_read
        assign_map = read.assign_event_map \
            if read.assign_event_map is not None else read.event_map
        params = estimate_nanopore_params(assign_read, assign_map,
                                          read.events, model, params)
    events = adjust_events_for_drift(read.events, params.drift)
    ev_start = int(read.event_map[qstart])
    ev_end = int(read.event_map[qend - 1])
    window_events = events[ev_start:ev_end]
    lX = len(target) - k + 1
    lY = ev_end - ev_start
    if lY <= 0 or lX <= 0:
        raise ValueError(f"{read.read_label}: empty alignment window")

    anchors_rb = guide.anchor_pairs(config.constraint_trim)
    if read.rna:
        Lw = guide.window_length
        anchors_rb = [(Lw - 1 - x - (k - 1), read.read_length - 1 - q)
                      for x, q in anchors_rb]
        anchors_rb = sorted((x, q) for x, q in anchors_rb if x >= 0)
    anchors = remap_anchors_to_events(anchors_rb, read.event_map, qstart)
    anchors = [(x, y) for x, y in anchors if 0 <= x < lX and 0 <= y < lY]

    splits = get_split_points(anchors, lX, lY, config.split_bigger_than,
                              True, True)
    tasks = []
    j = 0
    for (x1, y1, x2, y2) in splits:
        seg_anchors = []
        while j < len(anchors):
            ax, ay = anchors[j]
            if ax + ay >= x2 + y2:
                break
            seg_anchors.append((ax - x1, ay - y1))
            j += 1
        # width-capped sub-splitting: confine band bulges to small blocks
        # so the bulk of the read keeps a narrow band bucket
        for (sx1, sy1, sx2, sy2, sub_anchors) in split_segment_by_width(
                seg_anchors, x2 - x1, y2 - y1,
                config.diagonal_expansion, config.max_band_width,
                config.max_segment_diagonals):
            w_chars = target[x1 + sx1:x1 + sx2 + k - 1]
            # path-class sub-splitting: isolate adjacent-degenerate
            # (P>2) windows so the bulk runs at 2 paths per cell (on
            # bundled CpG workloads only ~4% of positions are P=4, but
            # they double the whole segment's band tensors)
            blocks = [(0, 0, sx2 - sx1, sy2 - sy1, sub_anchors)]
            if config.path_split and \
                    max_paths_per_kmer(w_chars, k, config.ambig_map) > 2:
                # tiered isolation:
                #  * P>2 isolation (the bulk runs 2 paths) is gated on
                #    the resulting average block length: on CpG-dense
                #    references it fragments segments ~5x into
                #    ~150-cell blocks, each a shorter problem in more
                #    shape buckets;
                #  * P>4 isolation applies whenever such windows exist:
                #    one adjacent-degenerate cluster would otherwise
                #    widen the whole segment's path axis
                ppk = paths_per_kmer(w_chars, k, config.ambig_map)
                for thresh in (2, 4):
                    hotv = ppk > thresh
                    if not hotv.any() or hotv.mean() > 0.25:
                        continue
                    cand = split_segment_by_paths(
                        sub_anchors, sx2 - sx1, sy2 - sy1, hotv)
                    if thresh == 2 and \
                            (sx2 - sx1) / max(len(cand), 1) < 400:
                        continue    # too fragmented; isolate only P>4
                    blocks = cand
                    break
            for (px1, py1, px2, py2, p_anchors) in blocks:
                ax1, ay1 = sx1 + px1, sy1 + py1
                ax2, ay2 = sx1 + px2, sy1 + py2
                seg_chars = target[x1 + ax1:x1 + ax2 + k - 1]
                seg_events = window_events[y1 + ay1:y1 + ay2]
                slX = len(seg_chars) - k + 1
                slY = len(seg_events)
                if slX < 1 or slY < 1:
                    continue
                xmyL, xmyR = build_band(p_anchors, slX, slY,
                                        config.diagonal_expansion)
                W = _bucket_w(int(band_widths(xmyL, xmyR).max()))
                Dpad = _bucket_d(slX + slY)
                P = max_paths_per_kmer(seg_chars, k, config.ambig_map)
                problem = bfb.prepare_problem(
                    seg_chars, seg_events, model, params, config.ambig_map,
                    W=W, Dpad=Dpad, P=P, mode=config.emission_mode,
                    anchor_pairs=p_anchors,
                    expansion=config.diagonal_expansion,
                    scale_noise=(config.emission_mode
                                 == bfb.MODE_FULL_DESCALED),
                    hdp=hdp)
                tasks.append(((x1 + ax1, y1 + ay1), problem, W, Dpad, P))
    return target, params, events, ev_start, tasks


def device_budget_bytes(device) -> int:
    """Device bytes one in-flight chunk of a bucket may take.

    Two chunks may be in flight per device (one running, one being
    finished on the host), so each gets 40% of what the allocator may
    hand out. Devices that report no limit (the CPU backend) get 2 GiB.
    """
    stats = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        return 2 << 30
    return int(0.4 * stats["bytes_limit"])


def run_alignment_batch(
    reads_and_guides: Sequence[Tuple[NanoporeReadData, GuideAlignment]],
    reference: ProcessedReference,
    model: PoreModel,
    config: Optional[AlignmentConfig] = None,
    hdp=None,
    verbose: bool = False,
    strand_template: bool = True,
    call_variants: Optional[str] = None,
) -> List[ReadAlignment]:
    """Align many reads: prep -> shape buckets -> batched device runs.

    Each (W, Dpad, P) bucket is cut into chunks that fit the device's
    memory budget (device_budget_bytes); each chunk goes to the
    least-loaded local device, with at most two chunks in flight per
    device, so host finishing of one chunk overlaps the next one's
    sweeps and every local device is kept busy.

    ``call_variants`` (a candidate-base string, e.g. "CE" for CpG
    methylation) switches the batch into SITE-CALLING mode — the
    production variant/methylation path: each segment's compacted pairs
    are folded onto per-site marginals on the host; results carry
    ``variant_calls`` (the MarginalizeFullVariants per-read table,
    variantCaller.py:123-187, as a variant_caller.CallTable) and EMPTY
    aligned_pairs. Segments with no degenerate-last-base cells (always
    the case for P=1 segments) are skipped outright: segment DPs are
    independent by construction (ragged anchors), so a siteless segment
    contributes no calling rows (the reference computes the full-read
    DP and discards non-ambiguous rows, signalAlignment.py:498-565).

    Observability: SIGNALALIGN_TIMING=1 prints a per-stage wall-time
    breakdown (prep / kernels+dispatch / fetch+decode / assemble);
    SIGNALALIGN_PROFILE=<dir> captures a jax.profiler trace of the
    device phase.
    """
    import jax

    from signalalign_jax.ops.batch import (launch_banded_fb_batch,
                                           problem_device_bytes)

    config = config or AlignmentConfig()
    if config.path_split is None:
        # AUTO: splitting pays once the extra shape buckets fill
        config = dataclasses.replace(config,
                                     path_split=len(reads_and_guides) >= 128)
    site_mode = call_variants is not None and not config.compute_expectations
    timing_on = bool(os.environ.get("SIGNALALIGN_TIMING"))
    profile_dir = os.environ.get("SIGNALALIGN_PROFILE")
    stage_s: Dict[str, float] = defaultdict(float)

    t_stage = time.perf_counter()

    def mark(stage: str):
        nonlocal t_stage
        now = time.perf_counter()
        stage_s[stage] += now - t_stage
        t_stage = now

    seg_tasks: List[SegmentTask] = []
    prepped: List[Optional[PreparedRead]] = []

    def _prep_one(rg):
        read, guide = rg
        try:
            return read, guide, prepare_read(
                read, guide, reference, model, config, hdp,
                strand_template=strand_template), None
        except Exception as exc:  # per-read fault isolation
            # (reference: KEY:FAILED handling, signalAlignment.py:627-737)
            return read, guide, None, str(exc)

    # host prep is numpy-heavy (WLS scaling, banding, per-x tables) and
    # embarrassingly per-read; thread it — the reference's analogue is
    # its per-read worker pool (utils/multithread.py) doing the same
    # prep in N processes. Order is preserved; fault isolation is
    # per read as before.
    if len(reads_and_guides) > 3:
        from concurrent.futures import ThreadPoolExecutor
        nw = min(8, max(2, (os.cpu_count() or 4) - 2))
        with ThreadPoolExecutor(max_workers=nw) as ex:
            prep_out = list(ex.map(_prep_one, reads_and_guides))
    else:
        prep_out = [_prep_one(rg) for rg in reads_and_guides]
    for ridx, (read, guide, out_, failure) in enumerate(prep_out):
        if failure is not None:
            prepped.append(PreparedRead(read, guide, "", ScalingParams(),
                                        np.zeros((0, 4)), 0, [],
                                        failure=failure))
            if verbose:
                print(f"[runner] FAILED {read.read_label}: {failure}",
                      file=sys.stderr)
            continue
        target, params, events, ev_start, tasks = out_
        pr = PreparedRead(read, guide, target, params, events, ev_start, [])
        for (off, problem, W, Dpad, P) in tasks:
            pr.segments.append(len(seg_tasks))
            seg_tasks.append(SegmentTask(ridx, off[0], off[1], problem,
                                         W, Dpad, P))
        prepped.append(pr)

    if site_mode:
        # site cells: x (1-based) where the segment k-mer's LAST base is
        # a degenerate char — the only cells that report in
        # MarginalizeFullVariants (variantCaller.py:123-187)
        k_ = model.kmer_length
        amb = np.frombuffer("".join(config.ambig_map).encode(), np.uint8)
        for t in seg_tasks:
            seq_b = np.frombuffer(t.problem.seq.encode(), np.uint8)
            lastb = seq_b[k_ - 1:k_ - 1 + t.problem.lX]
            t.cells = np.flatnonzero(np.isin(lastb, amb)) + 1

    mark("prep")
    if profile_dir:
        jax.profiler.start_trace(profile_dir)

    # bucket segments by device shape and execute
    buckets: Dict[Tuple[int, int, int], List[int]] = defaultdict(list)
    for i, t in enumerate(seg_tasks):
        buckets[(t.W, t.Dpad, t.P)].append(i)

    seg_results: List[Optional[dict]] = [None] * len(seg_tasks)
    # multi-device dispatch: chunks go to the least-loaded of this
    # process's local devices (the replacement for the reference's 96
    # worker processes, utils/multithread.py:79-236); each device keeps
    # its own in-flight queue
    devices = jax.local_devices()
    budgets = [device_budget_bytes(d) for d in devices]
    pending: List[Tuple[List[int], object, int]] = []  # (idxs, finish, dev)
    dev_depth = [0] * len(devices)
    expect = bool(config.compute_expectations)

    def finish_oldest(dev_slot: Optional[int] = None):
        t0 = time.perf_counter()
        k = 0 if dev_slot is None else next(
            i for i, e in enumerate(pending) if e[2] == dev_slot)
        p_idxs, fin, ds = pending.pop(k)
        for i, r in zip(p_idxs, fin()):
            seg_results[i] = r
        dev_depth[ds] -= 1
        if _dispatch_trace is not None:
            _dispatch_trace.append(("drain", ds, sum(dev_depth)))
        stage_s["fetch+decode"] += time.perf_counter() - t0

    for (W, Dpad, P), idxs in sorted(buckets.items()):
        if site_mode and P == 1:
            # a degenerate-last-base cell implies >=2 paths at that
            # cell, so P=1 segments carry no site cells: they produce
            # zero calling rows and (segment DPs being independent)
            # their sweeps are pure discarded work — skip them
            for i in idxs:
                seg_results[i] = {"total_f": 0.0, "pairs": []}
            continue
        n_chunk = max(1, min(budgets) // problem_device_bytes(
            Dpad, W, P, expect))
        for c0 in range(0, len(idxs), n_chunk):
            cidx = idxs[c0:c0 + n_chunk]
            devi = min(range(len(devices)), key=lambda i_: dev_depth[i_])
            while dev_depth[devi] >= 2:
                finish_oldest(devi)
            fin = launch_banded_fb_batch(
                [seg_tasks[i].problem for i in cidx], W=W, P=P,
                with_expectations=expect, threshold=config.threshold,
                device=devices[devi])
            pending.append((cidx, fin, devi))
            dev_depth[devi] += 1
            if _dispatch_trace is not None:
                _dispatch_trace.append(("dispatch", devi, sum(dev_depth)))
    while pending:
        finish_oldest()

    stage_s["kernels+dispatch"] += (time.perf_counter() - t_stage
                                    - stage_s["fetch+decode"])
    t_stage = time.perf_counter()
    if profile_dir:
        jax.profiler.stop_trace()

    # assemble per-read results
    if site_mode:
        from signalalign_jax.io.guide import adjust_reference_coordinate
        from signalalign_jax.pipeline.variant_caller import (
            marginals_from_pairs, variant_call_table)
    out: List[ReadAlignment] = []
    for ridx, pr in enumerate(prepped):
        if pr.failure is not None:
            continue
        if strand_template:
            fwd_out, ref_shift = pr.guide.output_frame(pr.read.rna)
        else:
            fwd_out = pr.guide.forward
            ref_shift = pr.guide.window_end if pr.guide.forward \
                else pr.guide.window_start
        all_pairs = []
        total_lp = 0.0
        texp = np.zeros((3, 3))
        kexp = np.zeros((3, model.alphabet.num_kmers))
        lik = 0.0
        per_pos = {}                # site mode: (strand, genomic kmer
        #                             start) -> {base: normalized p}
        k1 = model.kmer_length - 1
        s_lab = "t" if strand_template else "c"
        for si in pr.segments:
            t = seg_tasks[si]
            r = seg_results[si]
            total_lp += r["total_f"]
            if expect:
                texp += r["texp"]
                kexp += r["kexp"]
                lik += r["total_f"] * t.problem.n_diag
            if site_mode:
                segm = marginals_from_pairs(r["pairs"], t.cells, t.problem,
                                            call_variants)
                for pos_seg, probs in segm.items():
                    # segment k-mer-start cell -> genomic kmer start
                    # (the reference_index key MarginalizeFullVariants
                    # aggregates on, variantCaller.py:141-155)
                    gpos = adjust_reference_coordinate(
                        (pos_seg - k1) + t.x1, ref_shift, len(pr.target),
                        model.kmer_length, strand_template, fwd_out)
                    per_pos[(s_lab, gpos)] = probs
                continue
            for prob, x, y, kmer in r["pairs"]:
                all_pairs.append((prob, x + t.x1, y + t.y1, kmer))
        all_pairs.sort(key=lambda r: (r[1] + r[2], r[1]))
        vcalls = None
        if site_mode:
            vcalls = variant_call_table(
                per_pos, pr.read.read_label, pr.guide.contig, fwd_out,
                call_variants)
        out.append(ReadAlignment(
            variant_calls=vcalls,
            read_label=pr.read.read_label, contig=pr.guide.contig,
            forward=fwd_out, strand_template=strand_template,
            aligned_pairs=all_pairs, score=posterior_score(all_pairs),
            target=pr.target, event_offset=pr.ev_start,
            ref_offset=ref_shift, params=pr.params,
            events=pr.events, total_log_prob=total_lp, rna=pr.read.rna,
            transition_expectations=texp if expect else None,
            likelihood=lik,
            emission_expectations=kexp if expect else None))
    mark("assemble")
    if timing_on:
        total = sum(stage_s.values())
        parts = " ".join(f"{k}={v:.2f}s" for k, v in stage_s.items())
        print(f"[runner-timing] total={total:.2f}s {parts} "
              f"({len(prepped)} reads, {len(seg_tasks)} segments)",
              file=sys.stderr)
    return out


def write_variant_outputs(results: Sequence[ReadAlignment], output_dir: str,
                          variants: str) -> List[str]:
    """Site-calling outputs: per read ``<label>.sm.variants.tsv``
    (marginalize_full_variants schema), the across-read
    ``variants_aggregate.tsv`` (AggregateOverReadsFull, reference
    variantCaller.py:385-408) and the per-read per-strand summary
    ``variants_per_read.tsv`` (MarginalizeFullVariants per_read_calls,
    variantCaller.py:176-180). Returns the written paths."""
    from signalalign_jax.pipeline.variant_caller import (
        aggregate_call_rows, per_read_call_table)
    written = []
    tables = [r.variant_calls for r in results if r.variant_calls is not None]
    for r in results:
        if r.variant_calls is not None:
            written.append(r.variant_calls.write_tsv(os.path.join(
                output_dir, f"{r.read_label}.sm.variants.tsv")))
    written.append(aggregate_call_rows(
        [row for t in tables for row in t.rows], variants).write_tsv(
        os.path.join(output_dir, "variants_aggregate.tsv")))
    written.append(per_read_call_table(tables, variants).write_tsv(
        os.path.join(output_dir, "variants_per_read.tsv")))
    return written


def run_signal_align(
    alignment_file: str,
    readdb: str,
    fast5_dirs: Sequence[str],
    reference_fasta: str,
    model: PoreModel,
    output_dir: str,
    config: Optional[AlignmentConfig] = None,
    output_format: str = "full",
    positions=None,
    motifs=None,
    hdp=None,
    max_reads: Optional[int] = None,
    quality_threshold: float = 7.0,
    ambig_map=None,
    verbose: bool = True,
    embed: bool = False,
    overwrite: bool = True,
    force_kmer_event_alignment: bool = False,
    target_regions=None,
    distributed: bool = False,
    variants: Optional[str] = None,
) -> List[str]:
    """Full CLI-equivalent run: filter reads -> align -> write TSVs.

    ``output_format="variants"`` runs the production site-calling path
    (run_alignment_batch call_variants): per-site marginals computed
    from DEVICE posterior sums, written per read as
    ``<label>.sm.variants.tsv`` (marginalize_full_variants schema)
    plus an across-read ``variants_aggregate.tsv``
    (AggregateOverReadsFull, reference variantCaller.py:385-408).
    ``variants`` names the candidate bases (e.g. "CE"); derived from
    the config's ambiguity map when omitted.

    reference: runSignalAlign.main (scripts/runSignalAlign.py:135-319);
    ``embed`` mirrors --embed (SignalAlignment.embed_file): alignment rows +
    MEA labels written into each fast5 under /Analyses/SignalAlign_NNN.
    Returns the list of written output files.

    ``distributed=True`` host-shards the read list over
    ``jax.process_count()`` processes (jax.distributed init from
    SIGNALALIGN_* env, parallel/multihost.py): each host preps, aligns,
    and writes TSVs for only its shard — per-read output files never
    collide, so the union over hosts equals the single-process output
    (the reference scales inference with one signalMachine process per
    read across Toil workers; here reads shard across hosts and batch
    across each host's chips). Returns THIS host's written files.
    """
    config = config or AlignmentConfig()
    reference = ProcessedReference(reference_fasta, positions=positions,
                                   motifs=motifs)
    pairs = filter_reads(alignment_file, readdb, list(fast5_dirs),
                         quality_threshold=quality_threshold)
    if max_reads:
        pairs = pairs[:max_reads]
    if distributed:
        from signalalign_jax.parallel import multihost
        multihost.initialize()
        pairs = multihost.host_shard(pairs)
        if verbose:
            import jax
            print(f"[runner] process {jax.process_index()}/"
                  f"{jax.process_count()}: {len(pairs)} reads in shard",
                  file=sys.stderr)
    if not overwrite:
        # rerun-resume: skip reads whose outputs already exist (the
        # reference's check_for_temp_file_existance behavior,
        # signalAlignment.py:250-260). The skip key must be the SAME
        # read_label that names the outputs (the fast5 read id), matched
        # against exact candidate filenames -- a prefix glob would
        # false-positive on labels that prefix other labels.
        from signalalign_jax.io.fast5 import Fast5

        def _done(f5_path, rec):
            try:
                with Fast5(f5_path) as f5:
                    label = f5.read_id or f5_path
            except Exception:
                label = rec.qname
            return any(os.path.exists(os.path.join(output_dir,
                                                   f"{label}.sm.{sfx}.tsv"))
                       for sfx in ("forward", "backward", "vc",
                                   "assignments"))
        pairs = [(f5, rec) for f5, rec in pairs if not _done(f5, rec)]

    rgs = []
    for f5, rec in pairs:
        try:
            try:
                if force_kmer_event_alignment:
                    raise ValueError("no basecall events (forced)")
                read = NanoporeReadData.from_fast5(
                    f5, quality_threshold=quality_threshold)
            except ValueError as exc:
                if "no basecall events" not in str(exc) and \
                        "index-scale" not in str(exc):
                    raise
                # signal files without events: run raw-signal kmer-event
                # alignment (NanoporeRead.generate_new_event_table path)
                from signalalign_jax.pipeline.event_align import \
                    nanopore_read_from_raw
                if verbose:
                    print(f"[runner] {os.path.basename(f5)}: no usable "
                          "event table; running kmer-event alignment",
                          file=sys.stderr)
                read = nanopore_read_from_raw(f5, model, rec)
            guide = guide_from_sam_record(rec)
            if guide is None or not guide.validate(read.read_length):
                raise ValueError("invalid guide alignment")
            if target_regions is not None and not target_regions.accepts(guide):
                raise ValueError("alignment outside target regions")
            rgs.append((read, guide))
        except Exception as exc:
            if verbose:
                print(f"[runner] skipping {f5}: {exc}", file=sys.stderr)

    call_variants = None
    if output_format == "variants":
        if variants is None:
            opts = {v for v in config.ambig_map.values()}
            if len(opts) != 1:
                raise ValueError(
                    "output_format='variants' needs an explicit "
                    f"variants= candidate set (ambig_map offers {opts})")
            variants = opts.pop()
        call_variants = variants
    t0 = time.time()
    results = run_alignment_batch(rgs, reference, model, config, hdp=hdp,
                                  verbose=verbose,
                                  call_variants=call_variants)
    dt = time.time() - t0
    n_events = sum(r.events.shape[0] for r in results)
    if verbose:
        print(f"[runner] aligned {len(results)} reads "
              f"({n_events} events) in {dt:.1f}s", file=sys.stderr)

    os.makedirs(output_dir, exist_ok=True)
    written = []
    for r in results:
        if verbose:
            # per-read summary (signalMachine.c:917-923 format)
            print(f"[runner] {r.read_label} "
                  f"{len(r.aligned_pairs)}({r.score:.6f})",
                  file=sys.stderr)
        # file orientation label is the ORIGINAL mapping strand (upstream
        # names files from the guide strand before the RNA frame flip,
        # signalAlignment.py:330-346)
        fwd_orig = (not r.forward) if r.rna else r.forward
        fwd_label = "forward" if fwd_orig else "backward"
        path = os.path.join(output_dir, f"{r.read_label}.sm.{fwd_label}.tsv")
        vcp = os.path.join(output_dir, f"{r.read_label}.sm.vc.tsv")
        if output_format in ("full", "both"):
            write_full_tsv(path, r.full_rows(model), append=False)
            written.append(path)
        if output_format in ("variantCaller", "both"):
            write_vc_tsv(vcp, r.vc_rows(model), append=False)
            written.append(vcp)
        if output_format == "assignments":
            ap = os.path.join(output_dir,
                              f"{r.read_label}.sm.assignments.tsv")
            write_assignments_tsv(ap, r.aligned_pairs, r.events, model,
                                  r.params, r.strand_template,
                                  r.event_offset, append=False)
            written.append(ap)
    if output_format == "variants":
        written += write_variant_outputs(results, output_dir, variants)
    if embed:
        from signalalign_jax.io.embed import embed_alignment
        from signalalign_jax.io.fast5 import Fast5
        by_label = {read.read_label: read for read, _ in rgs}
        for r in results:
            read = by_label.get(r.read_label)
            if read is None or read.fast5_path is None:
                continue
            try:
                with Fast5(read.fast5_path) as f5:
                    raw_events = f5.template_events(read.analysis_path)
                embed_alignment(
                    read.fast5_path, r.full_rows(model), raw_events,
                    vc_rows=r.vc_rows(model),
                    basecall_events_path=(read.analysis_path or "")
                    + "/BaseCalled_template/Events")
            except Exception as exc:
                if verbose:
                    print(f"[runner] embed failed for {r.read_label}: {exc}",
                          file=sys.stderr)
    return written


def run_signal_align_2d(
    fast5_dirs: Sequence[str],
    reference_fasta: str,
    template_model: PoreModel,
    complement_model: PoreModel,
    output_dir: str,
    config: Optional[AlignmentConfig] = None,
    output_format: str = "full",
    positions=None,
    motifs=None,
    template_hdp=None,
    complement_hdp=None,
    max_reads: Optional[int] = None,
    verbose: bool = True,
) -> List[str]:
    """2D (template + complement) run over a directory of 2D fast5s.

    reference: runSignalAlign with --2d (SignalAlignment twoD_chemistry
    path): guide from the 2D alignment-table sequence (built-in SW replaces
    the external bwa call), both strands aligned and appended to one output
    file per read (outputAlignment, signalMachine.c:276-309).
    """
    import glob as _glob

    from signalalign_jax.io.minialign import generate_guide_alignment
    from signalalign_jax.io.read import NanoporeRead2DData

    config = config or AlignmentConfig()
    reference = ProcessedReference(reference_fasta, positions=positions,
                                   motifs=motifs)
    paths = []
    for d in fast5_dirs:
        paths.extend(sorted(_glob.glob(os.path.join(d, "*.fast5"))))
    if max_reads:
        paths = paths[:max_reads]

    os.makedirs(output_dir, exist_ok=True)
    t0 = time.time()
    t_pairs, c_pairs, guides = [], [], {}
    for f5 in paths:
        try:
            read = NanoporeRead2DData.from_fast5(f5)
            guide = generate_guide_alignment(read.twod_sequence, reference)
            if guide is None or not guide.validate(len(read.twod_sequence)):
                raise ValueError("could not map 2D read")
        except Exception as exc:
            if verbose:
                print(f"[runner2d] skipping {f5}: {exc}", file=sys.stderr)
            continue
        guides[read.read_label] = guide
        t_pairs.append((read.template, guide))
        c_pairs.append((read.complement, guide))

    t_results = run_alignment_batch(t_pairs, reference, template_model,
                                    config, hdp=template_hdp,
                                    verbose=verbose, strand_template=True)
    c_results = run_alignment_batch(c_pairs, reference, complement_model,
                                    config, hdp=complement_hdp,
                                    verbose=verbose, strand_template=False)
    by_label = {}
    for t in t_results:
        by_label[t.read_label] = [t, None]
    for c in c_results:
        by_label.setdefault(c.read_label, [None, None])[1] = c

    written = []
    n_reads = 0
    for label, (t, c) in by_label.items():
        guide = guides.get(label)
        if guide is None:
            continue
        n_reads += 1
        fwd_label = "forward" if guide.forward else "backward"
        path = os.path.join(output_dir, f"{label}.sm.{fwd_label}.tsv")
        vcp = os.path.join(output_dir, f"{label}.sm.vc.tsv")
        if output_format in ("full", "both"):
            write_full_tsv(path, t.full_rows(template_model) if t else [],
                           append=False)
            if c:
                write_full_tsv(path, c.full_rows(complement_model),
                               append=True)
            written.append(path)
        if output_format in ("variantCaller", "both"):
            write_vc_tsv(vcp, t.vc_rows(template_model) if t else [],
                         append=False)
            if c:
                write_vc_tsv(vcp, c.vc_rows(complement_model), append=True)
            written.append(vcp)
    if verbose:
        print(f"[runner2d] aligned {n_reads} 2D reads in "
              f"{time.time() - t0:.1f}s", file=sys.stderr)
    return written

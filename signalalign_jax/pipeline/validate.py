"""Alignment validation: per-event distance between the signalAlign
posterior alignment and the basecall guide alignment, with flagging of
consecutive large-gap regions.

reference: validateSignalAlignment.py (flag_large_gaps:103-142,
get_all_event_summaries:145-215) built on alignedsignal.CreateLabels; here
the guide positions come straight from the guide CIGAR + event map instead
of a re-parsed BAM.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from signalalign_jax.io.guide import GuideAlignment
from signalalign_jax.io.read import NanoporeReadData
from signalalign_jax.pipeline.mea import mea_from_aligned_pairs
from signalalign_jax.pipeline.signal_align import ReadAlignment


@dataclasses.dataclass
class EventSummary:
    event_index: int
    sa_position: int
    guide_position: Optional[int]
    abs_diff: int
    on_mea_path: bool


def guide_event_positions(read: NanoporeReadData, guide: GuideAlignment
                          ) -> Dict[int, int]:
    """event index -> genomic reference position implied by the basecall
    guide alignment (first base mapped to that event)."""
    # base -> ref position from the CIGAR walk (match ops only)
    base_to_ref: Dict[int, int] = {}
    j = guide.window_start if guide.forward else guide.window_end - 1
    q = guide.query_start
    step = 1 if guide.forward else -1
    for length, op in guide.ops:
        if op in ("M", "=", "X"):
            for i in range(length):
                base_to_ref[q + i] = j + step * i
            q += length
            j += step * length
        elif op in ("D", "N"):
            j += step * length
        elif op == "I":
            q += length
    out: Dict[int, int] = {}
    emap = read.event_map
    for b, rpos in base_to_ref.items():
        if read.rna:
            # guide query coords are in fastq (5'->3') orientation; the
            # stored RNA read and its event map are reversed
            b = read.read_length - 1 - b
        if 0 <= b < len(emap):
            ev = int(emap[b])
            if ev not in out:
                out[ev] = rpos
    return out


def event_summaries(result: ReadAlignment, read: NanoporeReadData,
                    guide: GuideAlignment) -> List[EventSummary]:
    gpos = guide_event_positions(read, guide)
    mea_path = mea_from_aligned_pairs(result.aligned_pairs)
    mea_events = {e for _, e, _ in mea_path}
    k = len(result.aligned_pairs[0][3]) if result.aligned_pairs else 5
    out = []
    target_len = len(result.target)
    for prob, x, y, _ in result.aligned_pairs:
        # genomic position of the aligned kmer start
        from signalalign_jax.io.guide import adjust_reference_coordinate
        sa_pos = adjust_reference_coordinate(
            x, result.ref_offset, target_len, k,
            result.strand_template, result.forward)
        y_full = y + result.event_offset
        gp = gpos.get(y_full)
        diff = abs(sa_pos - gp) if gp is not None else 0
        out.append(EventSummary(event_index=y_full, sa_position=sa_pos,
                                guide_position=gp, abs_diff=diff,
                                on_mea_path=(y in mea_events)))
    out.sort(key=lambda s: s.event_index)
    return out


def flag_large_gaps(summaries: Sequence[EventSummary],
                    threshold: int = 10) -> List[dict]:
    """Consecutive runs of events whose SA-vs-guide distance exceeds the
    threshold (flag_large_gaps, validateSignalAlignment.py:103-142)."""
    flagged: List[dict] = []
    current: List[EventSummary] = []
    for s in summaries:
        if s.abs_diff > threshold:
            current.append(s)
        elif current:
            mea_hits = [c for c in current if c.on_mea_path]
            flagged.append({
                "events": list(current),
                "event_count": len(current),
                "peak_distance": max(c.abs_diff for c in current),
                "mea_peak_distance": max((c.abs_diff for c in mea_hits),
                                         default=0),
                "center_event_id": int(np.mean(
                    [c.event_index for c in current])),
            })
            current = []
    return flagged


def distance_histogram(summaries: Sequence[EventSummary],
                       bucket: float = 5.0) -> Dict[int, int]:
    hist: Dict[int, int] = {}
    for s in summaries:
        b = int(s.abs_diff // bucket)
        hist[b] = hist.get(b, 0) + 1
    return hist


def validate_read(result: ReadAlignment, read: NanoporeReadData,
                  guide: GuideAlignment, threshold: int = 10,
                  verbose: bool = False) -> dict:
    summaries = event_summaries(result, read, guide)
    flagged = flag_large_gaps(summaries, threshold)
    hist = distance_histogram(summaries)
    if verbose:
        total = max(len(summaries), 1)
        for b in sorted(hist):
            print(f"\t{int(b * 5):3d} to {int(b * 5 + 4):3d}: "
                  f"{hist[b]:6d}  ({hist[b] / total:.4f})")
        print(f"Found {len(flagged)} flagged event sets")
    return {"summaries": summaries, "flagged": flagged, "histogram": hist}

"""Raw-signal to basecalled-event-table initialization ("load_from_raw").

Pipeline (reference: impl/eventAligner.c:1242-1305 load_from_raw2 and
impl/kmerEventAlign.c): raw fast5 signal -> MAD trim -> t-stat event
detection -> method-of-moments scaling -> Suzuki-Kasahara adaptive banded
Viterbi event<->kmer alignment -> basecalled event table (model_state /
move / p_model_state per event) embedded back into the fast5.

The band fill is data-dependent sequential work and runs in native C++
(csrc/signalalign_native.cpp) with a NumPy fallback.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from signalalign_jax.io.fast5 import Fast5, BASECALL_EVENT_COLUMNS
from signalalign_jax.models.pore_model import PoreModel, ScalingParams
from signalalign_jax.ops.event_detect import detect_events, trim_and_segment_raw
from signalalign_jax.ops.scaling import estimate_scalings_using_mom

# QC constants (eventAligner.c:920-921, 1204-1233)
MIN_AVG_LOG_EMISSION = -5.2
MAX_GAP_THRESHOLD = 50
MAX_EVENTS_PER_KMER = 5.0


def read_kmer_ids(seq: str, model: PoreModel, rna: bool) -> np.ndarray:
    """K-mer ranks per read position; RNA k-mers are reversed strings
    (build_kmer_list, eventAligner.c:774-790)."""
    k = model.kmer_length
    seq = seq.replace("U", "T")
    if not rna:
        return model.alphabet.seq_to_kmer_ids(seq)
    n = len(seq) - k + 1
    return np.array([model.alphabet.kmer_index(seq[i:i + k][::-1])
                     for i in range(n)], dtype=np.int64)


def _emission_params(kmer_ids: np.ndarray, model: PoreModel,
                     params: ScalingParams):
    """MeanOnly emission parameters per read position
    (strawMan...WithDescaling_MeanOnly, stateMachine.c:557)."""
    mu = model.level_mean[kmer_ids]
    sd = model.level_sd[kmer_ids]
    m_hat = params.scale * mu + params.shift
    inv = 1.0 / (params.var * sd)
    cst = -0.91893853320467267 - np.log(sd) - math.log(params.var)
    return m_hat, inv, cst


def _adaptive_align_py(ev_mean, m_hat, inv, cst):
    """NumPy fallback of the adaptive banded Viterbi
    (adaptive_banded_simple_event_align2, eventAligner.c:902-1233)."""
    bandwidth = 100
    half = bandwidth // 2
    n_events = len(ev_mean)
    n_kmers = len(m_hat)
    NEG = -np.inf
    events_per_kmer = n_events / n_kmers
    lp_skip = math.log(1e-10)
    lp_stay = math.log(1.0 - 1.0 / (events_per_kmer + 1.0))
    lp_step = math.log(1.0 - math.exp(lp_skip) - math.exp(lp_stay))
    lp_trim = math.log(0.01)

    n_bands = n_events + n_kmers + 2
    bands = np.full((n_bands, bandwidth), NEG)
    trace = np.zeros((n_bands, bandwidth), dtype=np.uint8)
    ll_ev = np.zeros(n_bands, dtype=np.int64)
    ll_km = np.zeros(n_bands, dtype=np.int64)
    ll_ev[0], ll_km[0] = half - 1, -1 - half
    ll_ev[1], ll_km[1] = ll_ev[0] + 1, ll_km[0]
    bands[0, -1 - ll_km[0]] = 0.0
    bands[1, ll_ev[1] - 0] = lp_trim
    trace[1, ll_ev[1]] = 1

    offs = np.arange(bandwidth)
    for bi in range(2, n_bands):
        ll, ur = bands[bi - 1, 0], bands[bi - 1, -1]
        right = (bi % 2 == 1) if (ll == NEG and ur == NEG) else (ll < ur)
        ll_ev[bi] = ll_ev[bi - 1] + (0 if right else 1)
        ll_km[bi] = ll_km[bi - 1] + (1 if right else 0)

        trim_off = -1 - ll_km[bi]
        if 0 <= trim_off < bandwidth:
            ei = ll_ev[bi] - trim_off
            bands[bi, trim_off] = lp_trim * (ei + 1) if 0 <= ei < n_events else NEG
            if 0 <= ei < n_events:
                trace[bi, trim_off] = 1

        mn = max(0, -ll_km[bi], ll_ev[bi] - (n_events - 1))
        mx = min(bandwidth, n_kmers - ll_km[bi], ll_ev[bi] + 1)
        if mn >= mx:
            continue
        o = offs[mn:mx]
        ei = ll_ev[bi] - o
        ki = ll_km[bi] + o
        up_off = (ll_ev[bi - 1] - (ei - 1))
        left_off = (ki - 1) - ll_km[bi - 1]
        diag_off = (ki - 1) - ll_km[bi - 2]
        up = np.where((up_off >= 0) & (up_off < bandwidth),
                      bands[bi - 1, np.clip(up_off, 0, bandwidth - 1)], NEG)
        left = np.where((left_off >= 0) & (left_off < bandwidth),
                        bands[bi - 1, np.clip(left_off, 0, bandwidth - 1)], NEG)
        diag = np.where((diag_off >= 0) & (diag_off < bandwidth),
                        bands[bi - 2, np.clip(diag_off, 0, bandwidth - 1)], NEG)
        a = (ev_mean[ei] - m_hat[ki]) * inv[ki]
        lp = cst[ki] - 0.5 * a * a
        sd_ = (diag + lp_step + lp).astype(np.float32)
        su_ = (up + lp_stay + lp).astype(np.float32)
        sl_ = (left + lp_skip).astype(np.float32)
        best = sd_.copy()
        frm = np.zeros(len(o), dtype=np.uint8)
        best = np.maximum(best, su_)
        frm = np.where(best == su_, 1, frm)
        best = np.maximum(best, sl_)
        frm = np.where(best == sl_, 2, frm)
        bands[bi, mn:mx] = best
        trace[bi, mn:mx] = frm

    # backtrack
    max_score = NEG
    curr_event, curr_kmer = 0, n_kmers - 1
    for ei in range(n_events):
        bi = (ei + 1) + (curr_kmer + 1)
        if bi >= n_bands:
            continue
        off = ll_ev[bi] - ei
        if 0 <= off < bandwidth:
            s = bands[bi, off] + (n_events - ei) * lp_trim
            if s > max_score:
                max_score = s
                curr_event = ei
    pairs_k, pairs_e = [], []
    sum_emission, n_aligned, curr_gap, max_gap = 0.0, 0, 0, 0
    while curr_kmer >= 0 and curr_event >= 0:
        pairs_k.append(curr_kmer)
        pairs_e.append(curr_event)
        a = (ev_mean[curr_event] - m_hat[curr_kmer]) * inv[curr_kmer]
        sum_emission += cst[curr_kmer] - 0.5 * a * a
        n_aligned += 1
        bi = (curr_event + 1) + (curr_kmer + 1)
        off = ll_ev[bi] - curr_event
        frm = trace[bi, off]
        if frm == 0:
            curr_kmer -= 1
            curr_event -= 1
            curr_gap = 0
        elif frm == 1:
            curr_event -= 1
            curr_gap = 0
        else:
            curr_kmer -= 1
            curr_gap += 1
            max_gap = max(max_gap, curr_gap)
    pairs_k.reverse()
    pairs_e.reverse()
    avg = sum_emission / n_aligned if n_aligned else NEG
    spanned = bool(pairs_k) and pairs_k[0] == 0 and pairs_k[-1] == n_kmers - 1
    qc = np.array([avg, 1.0 if spanned else 0.0, max_gap, events_per_kmer])
    return np.array(pairs_k), np.array(pairs_e), qc


def adaptive_event_align(ev_mean: np.ndarray, kmer_ids: np.ndarray,
                         model: PoreModel, params: ScalingParams):
    m_hat, inv, cst = _emission_params(kmer_ids, model, params)
    try:
        from signalalign_jax.utils import native
        if native.available():
            return native.adaptive_banded_align(ev_mean, m_hat, inv, cst)
    except ImportError:
        pass
    return _adaptive_align_py(ev_mean, m_hat, inv, cst)


def qc_passes(qc: np.ndarray) -> Tuple[bool, str]:
    avg, spanned, max_gap, epk = qc
    ok = (avg >= MIN_AVG_LOG_EMISSION and spanned > 0.5
          and max_gap <= MAX_GAP_THRESHOLD and epk <= MAX_EVENTS_PER_KMER)
    msg = (f"avg_emission:{avg:.2f};spanned:{'ok' if spanned > .5 else 'not_ok'};"
           f"max_gap:{int(max_gap)};events_per_kmer:{epk:.2f}")
    return ok, msg


def alignment_to_base_event_map(pairs_k, pairs_e, kmer_ids, ev_mean,
                                model, params, n_events, rna: bool = False):
    """Per-event model_state/move/p_model_state columns from the alignment.

    reference: alignment_to_base_event_map / rna_alignment_to_base_event_map
    (eventAligner.c:1307-1408).
    """
    m_hat, inv, cst = _emission_params(kmer_ids, model, params)
    n_kmers = len(kmer_ids)
    state_idx = np.full(n_events, -1, dtype=np.int64)
    moves = np.zeros(n_events, dtype=np.int64)
    p_model = np.zeros(n_events, dtype=np.float64)

    order = range(len(pairs_k)) if not rna else range(len(pairs_k) - 1, -1, -1)
    prev_event = -1
    prev_kmer = 0 if not rna else n_kmers - 1
    for i in order:
        ki = int(pairs_k[i])
        ei = int(pairs_e[i])
        a = (ev_mean[ei] - m_hat[ki]) * inv[ki]
        lp = cst[ki] - 0.5 * a * a
        delta = (ki - prev_kmer) if not rna else (prev_kmer - ki)
        if ei == prev_event:
            if ki == prev_kmer:
                continue
            if not rna and prev_kmer == 0:
                continue
            p_model[ei] = math.exp(lp)
            state_idx[ei] = ki
            moves[ei] += delta
            prev_kmer, prev_event = ki, ei
        else:
            p_model[ei] = math.exp(lp)
            state_idx[ei] = ki
            moves[ei] = 0 if ki == prev_kmer else delta
            prev_kmer, prev_event = ki, ei
    return state_idx, moves, p_model


@dataclasses.dataclass
class RawAlignResult:
    events: np.ndarray          # (n, 4) mean, stdv, length(s), start(s)-start0
    model_states: np.ndarray    # per-event kmer strings (bytes)
    moves: np.ndarray
    p_model_state: np.ndarray
    params: ScalingParams
    qc: np.ndarray
    qc_ok: bool
    qc_msg: str
    raw_start: np.ndarray
    raw_length: np.ndarray


def align_raw_read(fast5_path: str, model: PoreModel, read_sequence: str,
                   rna: bool = False) -> RawAlignResult:
    """Full load_from_raw pipeline for one read (no fast5 writeback)."""
    with Fast5(fast5_path) as f5:
        raw = f5.raw_signal_pA()
        cp = f5.channel_params()
        start_time = f5.start_time()

    trimmed, offset = trim_and_segment_raw(raw, 200, 10, 100, 0.0)
    et = detect_events(trimmed, rna=rna, start_sample=offset)
    if rna:
        et = et[::-1].copy()

    kmer_ids = read_kmer_ids(read_sequence, model, rna)
    params = estimate_scalings_using_mom(kmer_ids, model, et[:, 0])
    pairs_k, pairs_e, qc = adaptive_event_align(et[:, 0], kmer_ids, model,
                                                params)
    ok, msg = qc_passes(qc)

    n_events = len(et)
    state_idx, moves, p_model = alignment_to_base_event_map(
        pairs_k, pairs_e, kmer_ids, et[:, 0], model, params, n_events,
        rna=rna)
    if rna:
        state_idx = state_idx[::-1].copy()
        moves = moves[::-1].copy()
        p_model = p_model[::-1].copy()
        et = et[::-1].copy()

    k = model.kmer_length
    seq_t = read_sequence.replace("U", "T")
    kmers = np.array([
        (seq_t[i:i + k] if not rna else seq_t[i:i + k][::-1]).encode()
        if i >= 0 else b"" for i in state_idx], dtype=f"S{k}")

    sample_rate = cp["sampling_rate"]
    starts_sec = et[:, 3] / sample_rate + start_time / sample_rate
    events = np.stack([et[:, 0], et[:, 1], et[:, 2] / sample_rate,
                       starts_sec - starts_sec[0]], axis=1)
    return RawAlignResult(
        events=events, model_states=kmers, moves=moves,
        p_model_state=p_model, params=params, qc=qc, qc_ok=ok, qc_msg=msg,
        raw_start=et[:, 3].astype(np.int64),
        raw_length=et[:, 2].astype(np.int64))


def embed_event_table(fast5_path: str, result: RawAlignResult,
                      fastq: str, analysis_base: str = "SignalAlign_Basecall_1D") -> str:
    """Write the basecalled event table back into the fast5
    (fast5_set_basecall_event_table, eventAligner.c)."""
    n = len(result.events)
    table = np.zeros(n, dtype=BASECALL_EVENT_COLUMNS)
    table["start"] = result.events[:, 3]
    table["length"] = result.events[:, 2]
    table["mean"] = result.events[:, 0]
    table["stdv"] = result.events[:, 1]
    table["model_state"] = result.model_states
    table["move"] = result.moves
    table["raw_start"] = result.raw_start
    table["raw_length"] = result.raw_length
    table["p_model_state"] = result.p_model_state
    with Fast5(fast5_path, "r+") as f5:
        return f5.write_event_table(table, fastq, base=analysis_base)


def nanopore_read_from_raw(fast5_path: str, model: PoreModel, sam_record,
                           embed: bool = True):
    """Build a DP-ready NanoporeReadData for a fast5 WITHOUT basecall events.

    reference: NanoporeRead.generate_new_event_table -> load_from_raw2
    (nanoporeRead.py:280-301, event_detection.py:230-330): the nucleotide
    sequence comes from the BAM record (revcomp'd back to read orientation
    for reverse mappings), the event table from raw-signal kmer-event
    alignment, and (optionally) the result is embedded into the fast5.
    """
    from signalalign_jax.io.fast5 import Fast5
    from signalalign_jax.io.read import NanoporeReadData, make_event_map
    from signalalign_jax.utils.alphabet import reverse_complement

    seq = sam_record.seq.upper()
    q = sam_record.qual
    if q is None or len(q) == 0:
        qual = "!" * len(seq)
    else:
        qual = "".join(chr(int(v) + 33) for v in q)
    if sam_record.is_reverse:
        seq = reverse_complement(seq)
        qual = qual[::-1]
    with Fast5(fast5_path) as f5:
        rna = f5.is_rna()
        read_id = f5.read_id
    result = align_raw_read(fast5_path, model, seq, rna=rna)
    if not result.qc_ok:
        raise ValueError(f"{fast5_path}: kmer-event alignment QC failed "
                         f"({result.qc_msg})")
    fastq = f"@{read_id}\n{seq}\n+\n{qual}\n"
    analysis = None
    if embed:
        try:
            analysis = embed_event_table(fast5_path, result, fastq)
        except OSError:
            analysis = None  # read-only fast5: keep the in-memory table
    stored_read = seq.replace("U", "T")[::-1] if rna else seq
    event_map = make_event_map(result.moves, result.p_model_state,
                               len(stored_read), model.kmer_length,
                               strict=False)
    return NanoporeReadData(
        read_label=read_id or fast5_path,
        template_read=stored_read,
        events=result.events,
        event_map=event_map,
        model_states=result.model_states,
        p_model_state=result.p_model_state,
        kmer_length=model.kmer_length,
        params=result.params,
        rna=rna,
        fastq=fastq,
        fast5_path=fast5_path,
        analysis_path=analysis,
    )

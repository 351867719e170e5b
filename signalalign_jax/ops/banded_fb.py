"""Banded forward-backward on the device: fixed-width band tensors over
anti-diagonals, advanced by ``jax.lax.scan`` and batched over reads.

Design (vs the reference's per-cell function-pointer DP,
/root/reference/impl/pairwiseAligner.c:1450-1590):

* A read segment's band is parameterized host-side by per-diagonal band
  origins ``x0[d]`` (x coordinate of band offset 0) and ``width[d]``
  (signalalign_jax.ops.band_geometry reproduces the reference band
  geometry exactly).
* The DP state for one diagonal is a dense (S=3, P, W) tensor: S states
  [match, gapX, gapY], P path k-mers per cell (degenerate positions), W
  band offsets (lanes). Cells outside the band hold NEG_INF.
* One scan step computes diagonal d from d-1 and d-2 carried tensors.
  Neighbor alignment between diagonals with different origins is a
  shift-window slice; emissions are contiguous dynamic slices of
  per-position parameter arrays precomputed once per read (the model
  gather happens outside the scan).
* No chunked traceback (reference pairwiseAligner.c:1486-1580): the full
  forward band stack lives in device memory (O(D*W*P*S) floats) and the backward
  sweep streams against it; memory is bounded by the band, not the matrix.
* Expectations (EM) accumulate per-transition posteriors inside the
  backward scan (reference cell_signal_updateExpectations,
  pairwiseAligner.c:914-944).

Everything is float32 on device; tests compare against the float64 oracle
(signalalign_jax.ops.fb_oracle) within tolerance.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from signalalign_jax.models.pore_model import (GAP_X, GAP_Y, MATCH, PoreModel,
                                               ScalingParams, T_MM, T_MX,
                                               T_MY, T_XM, T_XX, T_YM, T_YY)
from signalalign_jax.ops.band_geometry import band_widths, build_band
from signalalign_jax.ops.fb_oracle import LOG_GAPX_EMISSION
from signalalign_jax.utils.alphabet import expand_kmer_paths

NEG = -1.0e30  # finite log-zero: avoids inf-inf NaNs
# anti-diagonal steps per scan-loop iteration (all three scans). Measured
# on an H100 (PERF.md, PR 1): unroll 4 runs within 7-14% of unroll 8 per
# step and compiles in about half the time; unroll 1-2 compiles fastest
# but runs 10-55% slower.
SCAN_UNROLL = 4

# Device dtype: float32 in production; tests may set
# SIGNALALIGN_DTYPE=float64 (with JAX_ENABLE_X64=1) to isolate
# precision effects.
import os as _os
DTYPE = np.float64 if _os.environ.get("SIGNALALIGN_DTYPE") == "float64" else np.float32

# emission modes
MODE_MEAN_ONLY = 0      # log(1/var) + N(descaled mean; mu, sd)     [production]
MODE_FULL = 1           # N(mean; mu, sd) + invGauss(noise; nm, lam) [no descale]
MODE_FULL_DESCALED = 2  # N(descaled) + invGauss(noise)
MODE_HDP = 3            # log((1/var) * hdp_spline(descaled mean))

# per-position match/stay parameter layout (NPAR, P, LX):
#   0: m_hat   = scale*mu + shift          (expected scaled level mean)
#   1: inv_m   = 1/(var*sd_match)
#   2: c_m     = -log sqrt(2pi) - log sd_match - log var   (match const)
#   3: inv_y   = 1/(var*sd_stay)
#   4: c_y     = const for stay (sd*1.75 table)
#   5: nm      = noise mean (possibly rescaled)
#   6: nlam    = noise lambda
#   7: mu      = unscaled level mean (descaling ref, full modes)
#   8: sd_m    = level sd
#   9: sd_y    = stay level sd
NPAR = 10
# event parameter layout (NEVP, LE) in REVERSED order (see prepare):
#   0: mean (drift-adjusted)   1: noise (sd)   2: log(noise)   3: valid(0/1)
NEVP = 4


@dataclasses.dataclass
class BandedProblem:
    """Host-side arrays describing one read segment's banded DP."""
    # static-ish metadata
    lX: int
    lY: int
    n_diag: int                    # lX + lY (index of final diagonal)
    mode: int
    log_trans: np.ndarray          # (9,) f32
    start_logs: np.ndarray         # (3,) f32
    end_logs: np.ndarray           # (3,) f32
    var: float
    # per-diagonal geometry (length Dpad+1)
    x0: np.ndarray                 # i32
    width: np.ndarray              # i32
    # per-position tables
    ref_params: np.ndarray         # (NPAR, P, LXpad) f32
    kmer_ids: np.ndarray           # (P, LXpad) i32  (for HDP / outputs)
    path_valid: np.ndarray         # (P, LXpad) bool
    legal: np.ndarray              # (P, P, LXpad) bool  legal[p_to, q_from, x]
    n_paths: np.ndarray            # (LXpad,) i32
    # reversed event tables
    ev_params: np.ndarray          # (NEVP, LEpad) f32
    ev_front_pad: int              # index offset of j=0 in ev arrays
    # HDP density tables (MODE_HDP): (num_kmers, grid), (num_kmers, grid),
    # (2,)=[grid_start, grid_step]
    hdp_dens: Optional[np.ndarray] = None
    hdp_slopes: Optional[np.ndarray] = None
    hdp_grid: Optional[np.ndarray] = None
    # bookkeeping for output decoding
    num_kmers: int = 0             # model alphabet size**k (emission EM)
    seq: str = ""                  # segment nucleotide sequence
    kmer_len: int = 0
    path_kmers: Optional[List[List[str]]] = None  # per position path kmers
                                                  # (None for canonical P==1)

    def path_kmer_at(self, x: int, p: int) -> Optional[str]:
        """Path k-mer string for cell x (1-based), path slot p."""
        if self.path_kmers is not None:
            row = self.path_kmers[x - 1]
            return row[p] if p < len(row) else None
        return self.seq[x - 1:x - 1 + self.kmer_len] if p == 0 else None


def _gauss_const(sd):
    return -0.91893853320467267 - np.log(sd)


def prepare_problem(
    seq: str,
    events: np.ndarray,            # (lY, >=3): mean, noise, [duration, start]
    model: PoreModel,
    params: ScalingParams,
    ambig_map: Dict[str, str],
    W: int,
    Dpad: int,
    P: int,
    mode: int = MODE_MEAN_ONLY,
    anchor_pairs: Sequence[Tuple[int, int]] = (),
    expansion: int = 20,
    ragged_start: bool = True,
    ragged_end: bool = True,
    scale_noise: bool = False,
    drift_deltas: Optional[np.ndarray] = None,
    hdp=None,
) -> BandedProblem:
    """Precompute all device arrays for one segment.

    ``W`` must be >= the maximum band width; ``Dpad`` >= lX+lY; ``P`` >= the
    maximum paths per cell. ``drift_deltas`` optionally supplies per-event
    delta-times for drift correction of event means (nanopore.c:633-653).
    """
    from signalalign_jax.ops.fb_oracle import end_state_logs, start_state_logs

    k = model.kmer_length
    lX = len(seq) - k + 1
    lY = len(events)
    if lX < 1 or lY < 1:
        raise ValueError("empty sequence or events")

    xmyL, xmyR = build_band(anchor_pairs, lX, lY, expansion)
    widths = band_widths(xmyL, xmyR)
    if widths.max() > W:
        raise ValueError(f"band width {widths.max()} exceeds W={W}")
    D = lX + lY
    if D > Dpad:
        raise ValueError(f"diagonal count {D} exceeds Dpad={Dpad}")

    x0 = np.zeros(Dpad + 1, dtype=np.int32)
    width = np.zeros(Dpad + 1, dtype=np.int32)
    x0[:D + 1] = (np.arange(D + 1) + xmyL) // 2
    width[:D + 1] = widths
    # pad diagonals: keep slice starts in range (masked anyway)
    if Dpad > D:
        x0[D + 1:] = x0[D]

    # ---- per-position path expansion
    LXpad = lX + 1 + W
    kmer_ids = np.zeros((P, LXpad), dtype=np.int32)
    path_valid = np.zeros((P, LXpad), dtype=bool)
    n_paths = np.zeros(LXpad, dtype=np.int32)
    n_paths[0] = 1  # null boundary cell
    legal = np.zeros((P, P, LXpad), dtype=bool)
    has_ambig = any(c in ambig_map for c in set(seq))

    if P == 1 and not has_ambig:
        # canonical fast path: fully vectorized, k-mer strings decoded lazily
        path_kmers = None
        kmer_ids[0, 1:lX + 1] = model.alphabet.seq_to_kmer_ids(seq)
        path_valid[0, 1:lX + 1] = True
        n_paths[1:lX + 1] = 1
        legal[0, 0, 1:lX + 1] = True
    else:
        path_kmers = []
        for i in range(lX):
            paths = expand_kmer_paths(seq[i:i + k], ambig_map)
            if len(paths) > P:
                raise ValueError(
                    f"position {i} expands to {len(paths)} paths > P={P}")
            path_kmers.append(paths)
            x = i + 1
            n_paths[x] = len(paths)
            for p, pk in enumerate(paths):
                kmer_ids[p, x] = model.alphabet.kmer_index(pk)
                path_valid[p, x] = True
        # legality masks: legal[p, q, x] == transition from path q of cell
        # x-1 into path p of cell x is legal (path_checkLegal semantics)
        for x in range(1, lX + 1):
            if x == 1:
                for p in range(int(n_paths[1])):
                    legal[p, 0, 1] = True  # from the null boundary path
            else:
                prev = path_kmers[x - 2]
                cur = path_kmers[x - 1]
                for p, pk in enumerate(cur):
                    for q, qk in enumerate(prev):
                        legal[p, q, x] = qk[1:] == pk[:-1]

    # ---- per-position emission parameters
    if scale_noise:
        nm_t, ns_t, nl_t = model.scaled_noise_tables(params)
    else:
        nm_t, ns_t, nl_t = model.noise_mean, model.noise_sd, model.noise_lambda

    ref_params = np.zeros((NPAR, P, LXpad), dtype=np.float64)
    ids = kmer_ids[path_valid]
    mu = model.level_mean
    sd_m = model.level_sd
    sd_y = model.gap_y_level_sd

    def fill(slot, values_per_kmer):
        buf = np.zeros((P, LXpad))
        buf[path_valid] = values_per_kmer[ids]
        ref_params[slot] = buf

    fill(0, params.scale * mu + params.shift)
    with np.errstate(divide="ignore"):
        fill(1, 1.0 / (params.var * sd_m))
        fill(2, _gauss_const(sd_m) - math.log(params.var))
        fill(3, 1.0 / (params.var * sd_y))
        fill(4, _gauss_const(sd_y) - math.log(params.var))
    fill(5, nm_t)
    fill(6, nl_t)
    fill(7, mu)
    fill(8, sd_m)
    fill(9, sd_y)

    # ---- reversed event arrays
    ev_front_pad = 2
    LEpad = lY + ev_front_pad + W + 4
    ev_params = np.zeros((NEVP, LEpad), dtype=np.float64)
    means = events[:, 0].astype(np.float64).copy()
    if drift_deltas is not None and params.drift != 0.0:
        means = means - params.drift * np.asarray(drift_deltas, dtype=np.float64)
    noise = events[:, 1].astype(np.float64)
    noise = np.where(noise == 0.0, 1e-9, noise)
    # j = lY - y for y in 1..lY  ->  reversed order
    rev = slice(ev_front_pad, ev_front_pad + lY)
    ev_params[0, rev] = means[::-1]
    ev_params[1, rev] = noise[::-1]
    ev_params[2, rev] = np.log(noise[::-1])
    ev_params[3, rev] = 1.0

    hdp_dens = hdp_slopes = hdp_grid = None
    if mode == MODE_HDP:
        if hdp is None:
            raise ValueError("MODE_HDP requires an hdp model")
        hdp_dens, hdp_slopes, g0, dx = hdp.density_arrays()
        hdp_grid = np.array([g0, dx], dtype=np.float32)

    return BandedProblem(
        lX=lX, lY=lY, n_diag=D, mode=mode,
        log_trans=np.where(np.isfinite(model.log_transitions),
                           model.log_transitions, NEG).astype(DTYPE),
        start_logs=np.where(np.isfinite(start_state_logs(model, ragged_start)),
                            start_state_logs(model, ragged_start), NEG).astype(DTYPE),
        end_logs=np.where(np.isfinite(end_state_logs(model, ragged_end)),
                          end_state_logs(model, ragged_end), NEG).astype(DTYPE),
        var=float(params.var),
        x0=x0, width=width,
        ref_params=ref_params.astype(DTYPE),
        kmer_ids=kmer_ids, path_valid=path_valid, legal=legal, n_paths=n_paths,
        ev_params=ev_params.astype(DTYPE), ev_front_pad=ev_front_pad,
        hdp_dens=hdp_dens, hdp_slopes=hdp_slopes, hdp_grid=hdp_grid,
        num_kmers=model.alphabet.num_kmers,
        seq=seq, kmer_len=k, path_kmers=path_kmers,
    )


# --------------------------------------------------------------------------
# device kernel
# --------------------------------------------------------------------------

def _lae(a, b):
    return jnp.logaddexp(a, b)


def _window2(prev, shift, W):
    """(..., W) diagonal tensor -> (..., W+1) window at offsets o+shift.

    Index i of the result is prev[o + shift] for o = i; the caller reads
    [..., :W] for shift and [..., 1:] for shift+1. Out-of-overlap shifts
    produce NEG everywhere.
    """
    pad = [(0, 0)] * (prev.ndim - 1) + [(W + 2, W + 3)]
    padded = jnp.pad(prev, pad, constant_values=NEG)
    ok = (shift >= -W) & (shift <= W)
    start = jnp.clip(shift, -W, W) + W + 2
    win = jax.lax.dynamic_slice_in_dim(padded, start, W + 1, axis=-1)
    return jnp.where(ok, win, NEG)


def _slice_cols(arr, start, W):
    """Slice W trailing-axis columns starting at ``start`` (clamped)."""
    start = jnp.clip(start, 0, arr.shape[-1] - W)
    return jax.lax.dynamic_slice_in_dim(arr, start, W, axis=-1)


def hdp_spline_density(x, kmer_w, dens, slopes, g0, dx):
    """Monotone-cubic spline density evaluation on the HDP grid with
    linear extrapolation outside it (hdp.c:2588-2612 grid evaluation).

    x: descaled event means; kmer_w: density-table row indices (same
    shape as x); dens/slopes: (K, G) tables; returns density >= 0.
    """
    G = dens.shape[1]
    il = jnp.clip(((x - g0) // dx).astype(jnp.int32), 0, G - 2)
    flat_l = kmer_w * G + il
    df = dens.reshape(-1)
    sf = slopes.reshape(-1)
    yl = jnp.take(df, flat_l)
    yr = jnp.take(df, flat_l + 1)
    sl = jnp.take(sf, flat_l)
    sr = jnp.take(sf, flat_l + 1)
    dy = yr - yl
    a = sl * dx - dy
    b = dy - sr * dx
    tl = (x - (g0 + il * dx)) / dx
    tr = 1.0 - tl
    mid = tr * yl + tl * yr + tl * tr * (a * tr + b * tl)
    gN = g0 + (G - 1) * dx
    below = jnp.take(dens[:, 0], kmer_w) \
        - jnp.take(slopes[:, 0], kmer_w) * (g0 - x)
    above = jnp.take(dens[:, G - 1], kmer_w) \
        + jnp.take(slopes[:, G - 1], kmer_w) * (x - gN)
    v = jnp.where(x <= g0, below, jnp.where(x >= gN, above, mid))
    return jnp.maximum(v, 0.0)


def _emissions_at(refw, evw, mode, var, hdp=None, kmer_w=None):
    """Match / stay / gapX log emissions for one diagonal.

    refw: (NPAR, P, W) parameter window for cells' k-mers
    evw:  (NEVP, W) event window aligned to offsets
    hdp:  (dens (K, G), slopes (K, G), grid (2,)=[g0, dx]) for MODE_HDP
    kmer_w: (P, W) k-mer rank window (MODE_HDP)
    returns (e_match, e_stay, e_gapx): (P, W) each
    """
    m_hat, inv_m, c_m, inv_y, c_y, nm, nlam, mu, sd_m, sd_y = [refw[i] for i in range(NPAR)]
    ev_mean = evw[0][None, :]
    ev_noise = evw[1][None, :]
    ev_lnoise = evw[2][None, :]
    ev_valid = evw[3][None, :] > 0.5
    kvalid = inv_m > 0.0  # invalid path slots have zeroed params

    if mode == MODE_MEAN_ONLY:
        am = (ev_mean - m_hat) * inv_m
        ay = (ev_mean - m_hat) * inv_y
        e_match = c_m - 0.5 * am * am
        e_stay = c_y - 0.5 * ay * ay
    elif mode == MODE_HDP:
        # log((1/var) * hdp_spline(descaled mean)); stay uses the same
        # density (emissions_signal_getHdpKmerDensity, stateMachine.c:527;
        # stateMachine3HDP_cellCalculate upper branch)
        dens, slopes, grid2 = hdp
        x = mu + (ev_mean - m_hat) / var
        v = hdp_spline_density(x, kmer_w, dens, slopes,
                               grid2[0], grid2[1]) / var
        # densities below 1e-37 (f32 subnormals, which the GPU flushes to
        # zero and the CPU keeps) count as zero on every backend
        e_match = jnp.where(v > 1e-37, jnp.log(jnp.maximum(v, 1e-37)), NEG)
        e_stay = e_match
    else:
        # descaled (or raw) level term + inverse-gaussian noise term
        if mode == MODE_FULL:
            xm = ev_mean
        else:
            # descale: (x + var*mu - scale*mu - shift)/var == mu + (x - m_hat)/var
            xm = mu + (ev_mean - m_hat) * (1.0 / var)
        with np.errstate(divide="ignore"):
            pass
        am = (xm - mu) / jnp.where(sd_m > 0, sd_m, 1.0)
        ay = (xm - mu) / jnp.where(sd_y > 0, sd_y, 1.0)
        lg_m = -0.91893853320467267 - jnp.log(jnp.where(sd_m > 0, sd_m, 1.0)) - 0.5 * am * am
        lg_y = -0.91893853320467267 - jnp.log(jnp.where(sd_y > 0, sd_y, 1.0)) - 0.5 * ay * ay
        nmok = jnp.where(nm > 0, nm, 1.0)
        nlok = jnp.where(nlam > 0, nlam, 1.0)
        a = (ev_noise - nmok) / nmok
        ig = (jnp.log(nlok) - 1.8378770664093453 - 3.0 * ev_lnoise
              - nlok * a * a / ev_noise) / 2.0
        e_match = lg_m + ig
        e_stay = lg_y + ig

    ok = kvalid & ev_valid
    e_match = jnp.where(ok, e_match, NEG)
    e_stay = jnp.where(ok, e_stay, NEG)
    e_gapx = jnp.where(kvalid, LOG_GAPX_EMISSION, NEG)
    return e_match, e_stay, e_gapx


def _legal_reduce(source_PW1, legal_PPW, use_plus1: bool, W: int):
    """logsumexp over source paths q with legality mask.

    source_PW1: (P, W+1) source-state window values (per source path q)
    legal_PPW:  (P, P, W) legality legal[p, q, o]
    returns (P, W): for each target path p, logsumexp_q masked source.
    """
    src = source_PW1[:, 1:] if use_plus1 else source_PW1[:, :W]
    # (1, P_q, W) + mask -> reduce over q
    masked = jnp.where(legal_PPW, src[None, :, :], NEG)
    m = jnp.max(masked, axis=1)
    s = jnp.sum(jnp.exp(masked - m[:, None, :]), axis=1)
    return m + jnp.log(jnp.maximum(s, 1e-37))


def _diag_max(cur):
    """Max over a diagonal tensor, guarded for all-NEG (empty) diagonals."""
    m = jnp.max(cur)
    return jnp.where(m > NEG * 0.5, m, 0.0)


def _banded_sweeps_core(
    x0, width, ref_params, legal, ev_params,
    log_trans, start_logs, end_logs, var,
    lX, lY, n_diag, ev_front_pad,
    hdp_dens=None, hdp_slopes=None, hdp_grid=None, kmer_ids=None,
    *, W: int, P: int, mode: int, store_full: bool = True,
):
    """Forward + backward banded sweeps with per-diagonal max-rescaling.

    Every stored diagonal is normalized so its max cell is ~0; the scalar
    log-offsets are returned as per-diagonal increments whose prefix sums
    (computed host-side in float64) restore absolute log-probabilities.
    This keeps float32 fully accurate regardless of read length (absolute
    log-probs reach -1e4..-1e5 where f32 resolution would be ~1e-2).

    Returns (fstack, f_incr, lse_f, bstack, b_incr, lse_b):
      fstack/bstack: (Dpad+1, 3, P, W) normalized band values
      f_incr/b_incr: (Dpad+1,) per-diagonal offset increments
      lse_f: logsumexp(fstack[n_diag] + end_logs)  (+ f offsets = total)
      lse_b: logsumexp(bstack[0] + start_logs)     (+ b offsets = total)
    """
    Dpad = x0.shape[0] - 1
    f32 = jnp.dtype(DTYPE)
    t = log_trans
    hdp = (hdp_dens, hdp_slopes, hdp_grid) if mode == MODE_HDP else None

    def step_fwd(carry, d):
        prev1, prev2, m_prev = carry  # diagonals d-1 (offset base), d-2
        xd = x0[d]
        wd = width[d]

        refw = _slice_cols(ref_params, xd, W)
        evw = _slice_cols(ev_params, lY - d + xd + ev_front_pad, W)
        legw = _slice_cols(legal, xd, W)  # (P_to, P_from, W)
        kw = _slice_cols(kmer_ids, xd, W) if mode == MODE_HDP else None
        e_match, e_stay, e_gapx = _emissions_at(refw, evw, mode, var, hdp, kw)

        shift1 = xd - x0[d - 1] - 1
        shift2 = xd - x0[jnp.maximum(d - 2, 0)] - 1
        shift2 = jnp.where(d >= 2, shift2, W + 5)  # no diagonal -2

        w1 = _window2(prev1, shift1, W)   # [..., :W]=lower, [..., 1:]=upper
        # prev2 values are relative to offset(prev2) = offset(prev1) - m_prev
        w2 = _window2(prev2, shift2, W)

        # gapX: from lower (x-1, y): match->gapX, gapX->gapX
        src_x = _lae(w1[MATCH] + t[T_MX], w1[GAP_X] + t[T_XX])
        gx = _legal_reduce(src_x, legw, False, W) + e_gapx

        # match: from middle (x-1, y-1): m->m, x->m, y->m
        src_m = _lae(_lae(w2[MATCH] + t[T_MM], w2[GAP_X] + t[T_XM]),
                     w2[GAP_Y] + t[T_YM]) - m_prev
        mm = _legal_reduce(src_m, legw, False, W) + e_match

        # gapY: from upper (x, y-1), same path: m->y, y->y
        gy = _lae(w1[MATCH][:, 1:] + t[T_MY], w1[GAP_Y][:, 1:] + t[T_YY]) + e_stay

        cur = jnp.stack([mm, gx, gy])  # (3, P, W), offset base = offset(prev1)
        o = jnp.arange(W, dtype=jnp.int32)
        inband = (o < wd) & (d <= n_diag)
        cur = jnp.where(inband[None, None, :], cur, NEG)
        m = _diag_max(cur)
        cur = jnp.maximum(cur - m, NEG)
        out = cur if store_full else cur[MATCH]
        # normalized end-distribution dot for this diagonal (used for the
        # total prob when full states are not stored)
        lse_d = jax.scipy.special.logsumexp(
            jnp.maximum(cur + end_logs[:, None, None], NEG))
        return (cur, prev1, m), (out, m, lse_d)

    # init: diagonal 0 = single cell (0,0) with the start distribution.
    # (derive constants from traced inputs so the carries carry the right
    # device-varying type under shard_map)
    zvar = jnp.zeros((), f32) * var.astype(f32)
    f0 = jnp.full((3, P, W), NEG, dtype=f32) + zvar
    f0 = f0.at[:, 0, 0].set(start_logs)
    fm1 = jnp.full((3, P, W), NEG, dtype=f32) + zvar

    _, (fstack, f_incr, f_lse) = jax.lax.scan(
        step_fwd, (f0, fm1, zvar), jnp.arange(1, Dpad + 1), unroll=SCAN_UNROLL)
    fstack = jnp.concatenate([(f0 if store_full else f0[MATCH])[None], fstack],
                             axis=0)
    f_incr = jnp.concatenate([jnp.zeros(1, f32), f_incr])
    lse0 = jax.scipy.special.logsumexp(
        jnp.maximum(f0 + end_logs[:, None, None], NEG))
    f_lse = jnp.concatenate([lse0[None], f_lse])

    lse_f = f_lse[n_diag]

    # ---- backward sweep (descending diagonals)
    def step_bwd(carry, d):
        b1, b2, m_prev = carry  # diagonals d+1 (offset base), d+2
        xd = x0[d]
        wd = width[d]

        # TO-cell parameter windows aligned to current offsets
        refw_x1 = _slice_cols(ref_params, xd + 1, W)
        refw_x0 = _slice_cols(ref_params, xd, W)
        evw_y1 = _slice_cols(ev_params, lY - d + xd + ev_front_pad - 1, W)
        legw_x1 = _slice_cols(legal, xd + 1, W)  # legal[p_to, q_from] at x+1

        kw1 = _slice_cols(kmer_ids, xd + 1, W) if mode == MODE_HDP else None
        kw0 = _slice_cols(kmer_ids, xd, W) if mode == MODE_HDP else None
        e_match_to, _, _ = _emissions_at(refw_x1, evw_y1, mode, var, hdp, kw1)
        _, e_stay_same, _ = _emissions_at(refw_x0, evw_y1, mode, var, hdp, kw0)
        gapx_valid = jnp.where(refw_x1[1] > 0.0, LOG_GAPX_EMISSION, NEG)

        u1 = x0[d] - x0[jnp.minimum(d + 1, Dpad)]
        u1 = jnp.where(d + 1 <= Dpad, u1, W + 5)
        u2 = x0[d] + 1 - x0[jnp.minimum(d + 2, Dpad)]
        u2 = jnp.where(d + 2 <= Dpad, u2, W + 5)

        wb1 = _window2(b1, u1, W)   # [..., :W]=gapY target (x,y+1); [..., 1:]=gapX target (x+1,y)
        wb2 = _window2(b2, u2, W)   # [..., :W]=match target (x+1,y+1), offset -m_prev

        gx_term = wb1[GAP_X][:, 1:] + gapx_valid
        mm_term = wb2[MATCH][:, :W] + e_match_to - m_prev
        legT = jnp.transpose(legw_x1, (1, 0, 2))  # (q_from, p_to, W)

        def red(term):
            masked = jnp.where(legT, term[None, :, :], NEG)
            m = jnp.max(masked, axis=1)
            s = jnp.sum(jnp.exp(masked - m[:, None, :]), axis=1)
            return m + jnp.log(jnp.maximum(s, 1e-37))

        gx_red = red(gx_term)
        mm_red = red(mm_term)
        gy_term = wb1[GAP_Y][:, :W] + e_stay_same

        b_match = _lae(_lae(gx_red + t[T_MX], mm_red + t[T_MM]), gy_term + t[T_MY])
        b_gapx = _lae(gx_red + t[T_XX], mm_red + t[T_XM])
        b_gapy = _lae(mm_red + t[T_YM], gy_term + t[T_YY])

        cur = jnp.stack([b_match, b_gapx, b_gapy])
        o = jnp.arange(W, dtype=jnp.int32)
        inband = (o < wd) & (d <= n_diag)
        cur = jnp.where(inband[None, None, :], cur, NEG)
        is_final = d == n_diag
        bfin = jnp.where(inband[None, None, :],
                         jnp.broadcast_to(end_logs[:, None, None], (3, P, W)), NEG)
        cur = jnp.where(is_final, bfin, cur)
        m = jnp.where(is_final, 0.0, _diag_max(cur))
        cur = jnp.maximum(cur - m, NEG)
        out = cur if store_full else cur[MATCH]
        lse_d = jax.scipy.special.logsumexp(
            jnp.maximum(cur + start_logs[:, None, None], NEG))
        return (cur, b1, m), (out, m, lse_d)

    bD = jnp.full((3, P, W), NEG, dtype=f32) + zvar
    bD1 = jnp.full((3, P, W), NEG, dtype=f32) + zvar
    _, (bstack_rev, b_incr_rev, b_lse_rev) = jax.lax.scan(
        step_bwd, (bD, bD1, zvar), jnp.arange(Dpad, -1, -1), unroll=SCAN_UNROLL)
    bstack = bstack_rev[::-1]
    b_incr = b_incr_rev[::-1]
    lse_b = b_lse_rev[-1]  # diagonal 0 start-distribution dot

    return fstack, f_incr, lse_f, bstack, b_incr, lse_b


def _posterior_core(fstack, bstack, cvec, x0, width, n_diag, *, W: int, P: int):
    """Posterior match probs from normalized stacks + per-diagonal offsets.

    cvec[d] = Foffset[d] + Boffset[d] - total_log_prob  (host f64 -> f32).
    """
    Dpad1 = fstack.shape[0]
    d_idx = jnp.arange(Dpad1, dtype=jnp.int32)[:, None]
    o_idx = jnp.arange(W, dtype=jnp.int32)[None, :]
    xs = x0[:, None] + o_idx
    ys = d_idx - xs
    cellmask = (o_idx < width[:, None]) & (xs > 0) & (ys > 0) & (d_idx <= n_diag)
    fm = fstack[:, MATCH] if fstack.ndim == 4 else fstack
    bm = bstack[:, MATCH] if bstack.ndim == 4 else bstack
    logp = fm + bm + cvec[:, None, None]
    post = jnp.exp(jnp.maximum(logp, NEG))
    post = jnp.where(cellmask[:, None, :], post, 0.0)
    return jnp.minimum(post, 1.0)


def _expectations_core(
    fstack, bstack, cvec_d1, cvec_d2,
    x0, width, ref_params, legal, ev_params,
    log_trans, var, lY, n_diag, ev_front_pad,
    kmer_ids=None, hdp_dens=None, hdp_slopes=None, hdp_grid=None,
    *, W: int, P: int, mode: int, num_kmers: int = 0,
):
    """Transition + per-kmer emission expectation accumulation over the band.

    For diagonal d (TO cells), FROM cells are on d-1 (gapX/gapY) and d-2
    (match). cvec_d1[d] = Fo[d-1] + Bo[d] - total; cvec_d2[d] uses Fo[d-2].
    Returns (texp (3,3), kexp (3, num_kmers)): per-transition posterior
    sums and per-kmer emission moments.

    ``kexp`` rows are [Σp, Σp·dx, Σp·dx²] with dx = (event_mean − m̂)/var =
    descaled_mean − µ_model, accumulated by segment-sum over kmer ids
    (num_kmers == 0 disables the accumulation and returns zeros (3, 1)).
    Centering on the model mean keeps float32 accumulation well-conditioned
    (deviations are a few pA, vs descaled means ~100 pA whose squares would
    lose the variance signal to cancellation); the host converts to the
    reference's (Σp·x, Σp·(x−µ̂)²) file slots exactly.

    reference: cell_signal_updateExpectations /
    cell_signal_updateExpectationsAndAssignments (pairwiseAligner.c:914-970)
    + continuousPairHmm_addToEmissionExpectation (continuousHmm.c:159-178;
    its running-mean update rule is order-dependent — this kernel computes
    the exact batch moments instead).
    """
    Dpad = x0.shape[0] - 1
    f32 = jnp.dtype(DTYPE)
    t = log_trans
    hdp = (hdp_dens, hdp_slopes, hdp_grid) if mode == MODE_HDP else None

    def step_exp(acc, d):
        texp, kexp = acc
        xd = x0[d]
        wd = width[d]
        refw = _slice_cols(ref_params, xd, W)
        evw = _slice_cols(ev_params, lY - d + xd + ev_front_pad, W)
        legw = _slice_cols(legal, xd, W)
        kw = _slice_cols(kmer_ids, xd, W) \
            if (mode == MODE_HDP or num_kmers > 0) else None
        e_match, e_stay, e_gapx = _emissions_at(
            refw, evw, mode, var, hdp, kw if mode == MODE_HDP else None)

        shift1 = xd - x0[jnp.maximum(d - 1, 0)] - 1
        shift1 = jnp.where(d >= 1, shift1, W + 5)
        shift2 = xd - x0[jnp.maximum(d - 2, 0)] - 1
        shift2 = jnp.where(d >= 2, shift2, W + 5)

        f1 = _window2(fstack[jnp.maximum(d - 1, 0)], shift1, W)
        f2 = _window2(fstack[jnp.maximum(d - 2, 0)], shift2, W)
        bcur = bstack[d]
        c1 = cvec_d1[d]
        c2 = cvec_d2[d]

        o = jnp.arange(W, dtype=jnp.int32)
        inband = (o < wd) & (d <= n_diag) & (d >= 1)

        def pair_post(f_src_PW1, e_to, t_log, b_state, c):
            src = f_src_PW1[:, :W]
            val = (src[None, :, :] + e_to[:, None, :] + t_log
                   + bcur[b_state][:, None, :] + c)
            val = jnp.where(legw & inband[None, None, :], val, NEG)
            return jnp.exp(jnp.maximum(val, NEG))

        p_mx = pair_post(f1[MATCH], e_gapx, t[T_MX], GAP_X, c1)
        p_xx = pair_post(f1[GAP_X], e_gapx, t[T_XX], GAP_X, c1)
        p_mm = pair_post(f2[MATCH], e_match, t[T_MM], MATCH, c2)
        p_xm = pair_post(f2[GAP_X], e_match, t[T_XM], MATCH, c2)
        p_ym = pair_post(f2[GAP_Y], e_match, t[T_YM], MATCH, c2)
        up_m = f1[MATCH][:, 1:]
        up_y = f1[GAP_Y][:, 1:]
        val_my = jnp.exp(jnp.maximum(jnp.where(
            inband[None, :], up_m + e_stay + t[T_MY] + bcur[GAP_Y] + c1, NEG), NEG))
        val_yy = jnp.exp(jnp.maximum(jnp.where(
            inband[None, :], up_y + e_stay + t[T_YY] + bcur[GAP_Y] + c1, NEG), NEG))

        texp = texp.at[MATCH, GAP_X].add(jnp.sum(p_mx))
        texp = texp.at[GAP_X, GAP_X].add(jnp.sum(p_xx))
        texp = texp.at[MATCH, MATCH].add(jnp.sum(p_mm))
        texp = texp.at[GAP_X, MATCH].add(jnp.sum(p_xm))
        texp = texp.at[GAP_Y, MATCH].add(jnp.sum(p_ym))
        texp = texp.at[MATCH, GAP_Y].add(jnp.sum(val_my))
        texp = texp.at[GAP_Y, GAP_Y].add(jnp.sum(val_yy))

        mtp = jnp.sum(p_mm + p_xm + p_ym, axis=1)
        if num_kmers > 0:
            # per-kmer emission moments from into-match posteriors:
            # dx = (event_mean − m̂)/var = descaled_mean − µ_model
            dx = (evw[0][None, :] - refw[0]) / var
            dx = jnp.where(refw[1] > 0.0, dx, 0.0)  # zero invalid path slots
            kexp = kexp.at[0, kw].add(mtp)
            kexp = kexp.at[1, kw].add(mtp * dx)
            kexp = kexp.at[2, kw].add(mtp * dx * dx)
        return (texp, kexp), None

    zvar = jnp.zeros((), f32) * var.astype(f32)
    texp0 = jnp.zeros((3, 3), dtype=f32) + zvar
    kexp0 = jnp.zeros((3, max(num_kmers, 1)), dtype=f32) + zvar
    (texp, kexp), _ = jax.lax.scan(step_exp, (texp0, kexp0),
                                   jnp.arange(0, Dpad + 1), unroll=SCAN_UNROLL)
    return texp, kexp


banded_sweeps_device = partial(
    jax.jit, static_argnames=("W", "P", "mode", "store_full"))(
    _banded_sweeps_core)
posterior_device = partial(jax.jit, static_argnames=("W", "P"))(_posterior_core)
expectations_device = partial(
    jax.jit, static_argnames=("W", "P", "mode", "num_kmers"))(
    _expectations_core)

# Batched variants: vmap over a leading problem axis of every array arg.
# The scan inside becomes a batched scan: each diagonal step processes
# (B, 3, P, W) tensors: one read's diagonal is far too small to fill the
# device, a bucket of them is not.
@partial(jax.jit, static_argnames=("W", "P", "mode", "store_full"))
def banded_sweeps_batched(*args, W, P, mode, store_full=True):
    f = partial(_banded_sweeps_core, W=W, P=P, mode=mode,
                store_full=store_full)
    if len(args) > 13:  # hdp tables replicated across the batch
        axes = (0,) * 13 + (None, None, None, 0)
        return jax.vmap(f, in_axes=axes)(*args)
    return jax.vmap(f)(*args)


@partial(jax.jit, static_argnames=("W", "P"))
def posterior_batched(*args, W, P):
    return jax.vmap(partial(_posterior_core, W=W, P=P))(*args)


@partial(jax.jit, static_argnames=("W", "P", "mode", "num_kmers"))
def expectations_batched(*args, W, P, mode, num_kmers=0):
    f = partial(_expectations_core, W=W, P=P, mode=mode,
                num_kmers=num_kmers)
    if len(args) > 15:  # ... kmer_ids(batched) + 3 replicated hdp tables
        axes = (0,) * 15 + (None, None, None)
        return jax.vmap(f, in_axes=axes)(*args)
    return jax.vmap(f)(*args)


# --------------------------------------------------------------------------
# host wrapper
# --------------------------------------------------------------------------

def run_banded_fb(problem: BandedProblem, W: int, P: int,
                  with_expectations: bool = False) -> Dict:
    """Run the two-phase device pipeline for one problem.

    Phase 1: forward+backward sweeps (normalized stacks + offset increments).
    Host: float64 prefix sums of the offsets -> per-diagonal correction
    vectors. Phase 2: posterior (and optionally expectation) kernels.
    """
    args = [
        jnp.asarray(problem.x0), jnp.asarray(problem.width),
        jnp.asarray(problem.ref_params), jnp.asarray(problem.legal),
        jnp.asarray(problem.ev_params),
        jnp.asarray(problem.log_trans), jnp.asarray(problem.start_logs),
        jnp.asarray(problem.end_logs), jnp.asarray(problem.var, dtype=DTYPE),
        jnp.int32(problem.lX), jnp.int32(problem.lY), jnp.int32(problem.n_diag),
        jnp.int32(problem.ev_front_pad),
    ]
    if problem.mode == MODE_HDP:
        args += [jnp.asarray(problem.hdp_dens),
                 jnp.asarray(problem.hdp_slopes),
                 jnp.asarray(problem.hdp_grid),
                 jnp.asarray(problem.kmer_ids)]
    fstack, f_incr, lse_f, bstack, b_incr, lse_b = banded_sweeps_device(
        *args, W=W, P=P, mode=problem.mode)

    D = problem.n_diag
    fo = np.cumsum(np.asarray(f_incr, dtype=np.float64))
    bo_rev = np.cumsum(np.asarray(b_incr, dtype=np.float64)[::-1])[::-1]
    total_f = float(lse_f) + fo[D]
    total_b = float(lse_b) + bo_rev[0]

    cvec = (fo + bo_rev - total_f).astype(DTYPE)
    post = posterior_device(fstack, bstack, jnp.asarray(cvec),
                            jnp.asarray(problem.x0), jnp.asarray(problem.width),
                            jnp.int32(D), W=W, P=P)
    out = {"post": np.asarray(post), "total_f": total_f, "total_b": total_b}

    if with_expectations:
        fo_d1 = np.concatenate([[0.0], fo[:-1]])
        fo_d2 = np.concatenate([[0.0, 0.0], fo[:-2]])
        cvec_d1 = (fo_d1 + bo_rev - total_f).astype(DTYPE)
        cvec_d2 = (fo_d2 + bo_rev - total_f).astype(DTYPE)
        eargs = [fstack, bstack, jnp.asarray(cvec_d1), jnp.asarray(cvec_d2),
                 jnp.asarray(problem.x0), jnp.asarray(problem.width),
                 jnp.asarray(problem.ref_params), jnp.asarray(problem.legal),
                 jnp.asarray(problem.ev_params),
                 jnp.asarray(problem.log_trans),
                 jnp.asarray(problem.var, dtype=DTYPE),
                 jnp.int32(problem.lY), jnp.int32(D),
                 jnp.int32(problem.ev_front_pad),
                 jnp.asarray(problem.kmer_ids)]
        if problem.mode == MODE_HDP:
            eargs += [jnp.asarray(problem.hdp_dens),
                      jnp.asarray(problem.hdp_slopes),
                      jnp.asarray(problem.hdp_grid)]
        texp, kexp = expectations_device(
            *eargs, W=W, P=P, mode=problem.mode,
            num_kmers=problem.num_kmers)
        out["texp"] = np.asarray(texp, dtype=np.float64)
        out["kexp"] = np.asarray(kexp, dtype=np.float64)
    return out


@partial(jax.jit, static_argnames=("K",))
def compact_posterior(post, threshold, K: int):
    """Device-side compaction of a batch of posterior bands.

    Returns, per problem, the number of cells at or above ``threshold``
    and the first ``K`` of them as flat (Dpad+1, P, W) indices with their
    values, so only those cells cross to the host instead of the whole
    band. Entries past a problem's count are padding; the caller reruns
    with a larger ``K`` when a count exceeds it.
    """
    B = post.shape[0]
    flat = post.reshape(B, -1)
    hit = flat >= threshold
    counts = jnp.sum(hit, axis=1, dtype=jnp.int32)
    idx = jax.vmap(lambda h: jnp.nonzero(h, size=K, fill_value=0)[0])(hit)
    idx = idx.astype(jnp.int32)
    return counts, jnp.take_along_axis(flat, idx, axis=1), idx


def decode_compact_pairs(problem: BandedProblem, vals: np.ndarray,
                         idx: np.ndarray, P: int, W: int):
    """Host decode of compacted cells into aligned pairs, in the same
    form and order as ``extract_aligned_pairs`` on the full band."""
    d = idx // (P * W)
    p = (idx // W) % P
    x = problem.x0[d].astype(np.int64) + idx % W
    y = d - x
    ok = (x > 0) & (y > 0) & (x <= problem.lX) & (y <= problem.lY)
    d, p, x, y, vals = d[ok], p[ok], x[ok], y[ok], vals[ok]
    order = np.lexsort((x, x + y))
    probs = (np.minimum(vals[order].astype(np.float64), 1.0)
             * 10000000).astype(np.int64)
    out = []
    for v, xi, yi, pi in zip(probs.tolist(), x[order].tolist(),
                             y[order].tolist(), p[order].tolist()):
        kmer = problem.path_kmer_at(xi, pi)
        if kmer is not None:
            out.append((v, xi - 1, yi - 1, kmer))
    return out


def extract_aligned_pairs(problem: BandedProblem, post: np.ndarray,
                          threshold: float = 0.01) -> List[Tuple[int, int, int, str]]:
    """Threshold the posterior band tensor into (prob_int, x, y, kmer) pairs.

    Output matches diagonalCalculationPosteriorMatchProbs
    (pairwiseAligner.c:1355-1420): coordinates are 0-based sequence indices,
    probability is floor(p * 1e7).
    """
    D = problem.n_diag
    out = []
    hits = np.argwhere(post[:D + 1] >= threshold)
    for d, p, o in hits:
        x = int(problem.x0[d]) + int(o)
        y = int(d) - x
        if x <= 0 or y <= 0 or x > problem.lX or y > problem.lY:
            continue
        kmer = problem.path_kmer_at(x, p)
        if kmer is None:
            continue
        prob = min(float(post[d, p, o]), 1.0)
        out.append((int(prob * 10000000), x - 1, y - 1, kmer))
    out.sort(key=lambda r: (r[1] + r[2], r[1]))
    return out

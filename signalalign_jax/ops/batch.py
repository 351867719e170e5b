"""Batched execution of banded-FB problems.

Problems sharing a (W, Dpad, P, mode) bucket are stacked along a leading
axis and run through the vmapped kernels, so each scan step processes a
(B, 3, P, W) tensor: one read's diagonal is far too small to fill the
device, a bucket of them is not.

This replaces the reference's process pool over reads
(utils/multithread.py:79-236 + one signalMachine subprocess per read).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import jax
import numpy as np

from signalalign_jax.ops import banded_fb as bfb


def _pad_last(arr: np.ndarray, size: int) -> np.ndarray:
    if arr.shape[-1] == size:
        return arr
    pad = [(0, 0)] * (arr.ndim - 1) + [(0, size - arr.shape[-1])]
    return np.pad(arr, pad)


def stack_kmer_ids(problems: Sequence[bfb.BandedProblem]) -> np.ndarray:
    """Stacked (B, P, LX) kmer-id windows (emission-EM segment-sum keys)."""
    LX = max(p.ref_params.shape[-1] for p in problems)
    return np.stack([_pad_last(p.kmer_ids, LX) for p in problems])


def stack_problems(problems: Sequence[bfb.BandedProblem]):
    """Stack same-bucket problems into batched host arrays."""
    LX = max(p.ref_params.shape[-1] for p in problems)
    LE = max(p.ev_params.shape[-1] for p in problems)
    Dp = max(p.x0.shape[0] for p in problems)
    if any(p.x0.shape[0] != Dp for p in problems):
        raise ValueError("Dpad mismatch in bucket")

    def stk(get, size=None):
        arrs = [get(p) for p in problems]
        if size is not None:
            arrs = [_pad_last(a, size) for a in arrs]
        return np.stack(arrs)

    return (
        stk(lambda p: p.x0),
        stk(lambda p: p.width),
        stk(lambda p: p.ref_params, LX),
        stk(lambda p: p.legal, LX),
        stk(lambda p: p.ev_params, LE),
        stk(lambda p: p.log_trans),
        stk(lambda p: p.start_logs),
        stk(lambda p: p.end_logs),
        np.array([p.var for p in problems], dtype=bfb.DTYPE),
        np.array([p.lX for p in problems], dtype=np.int32),
        np.array([p.lY for p in problems], dtype=np.int32),
        np.array([p.n_diag for p in problems], dtype=np.int32),
        np.array([p.ev_front_pad for p in problems], dtype=np.int32),
    )


def problem_device_bytes(Dpad: int, W: int, P: int,
                         with_expectations: bool = False) -> int:
    """Peak device bytes one problem of a (W, Dpad, P) bucket holds.

    Forward and backward stacks are (Dpad+1, 3, P, W) f32 when the
    expectation pass needs every state, (Dpad+1, P, W) otherwise; on top
    come the posterior band and, as working room, the reversed backward
    stack and the compaction's index scan (two more bands).
    """
    states = 3 if with_expectations else 1
    return 4 * (Dpad + 1) * P * W * (2 * states + 3)


def _compact_k(n: int) -> int:
    """Power-of-two compaction width >= n (shapes recur across buckets)."""
    return 1 << max(10, int(n - 1).bit_length())


def launch_banded_fb_batch(problems: Sequence[bfb.BandedProblem], W: int,
                           P: int, with_expectations: bool = False,
                           threshold: Optional[float] = None,
                           device=None) -> Callable[[], List[Dict]]:
    """Put a same-bucket batch on ``device`` and enqueue its sweeps.

    Returns a function that finishes the batch: it waits for the sweeps,
    takes the float64 offset prefix sums on the host, runs the posterior
    (and expectation) kernels and returns one result dict per problem.
    With ``threshold`` the posterior band stays on the device and only
    the cells at or above it come back, decoded as "pairs"; without it
    the whole "post" band is fetched.
    """
    if not problems:
        return lambda: []
    mode = problems[0].mode
    args = jax.device_put(stack_problems(problems), device)
    extra = ()
    if mode == bfb.MODE_HDP or with_expectations:
        kmer_ids = jax.device_put(stack_kmer_ids(problems), device)
    if mode == bfb.MODE_HDP:
        # replicated density tables + per-problem kmer-id windows
        extra = jax.device_put((problems[0].hdp_dens,
                                problems[0].hdp_slopes,
                                problems[0].hdp_grid), device)
    sweep_args = list(args)
    if mode == bfb.MODE_HDP:
        sweep_args += [*extra, kmer_ids]
    fstack, f_incr, lse_f, bstack, b_incr, lse_b = bfb.banded_sweeps_batched(
        *sweep_args, W=W, P=P, mode=mode, store_full=with_expectations)

    def finish() -> List[Dict]:
        f_incr_h = np.asarray(f_incr, dtype=np.float64)
        b_incr_h = np.asarray(b_incr, dtype=np.float64)
        lse_f_h = np.asarray(lse_f, dtype=np.float64)
        lse_b_h = np.asarray(lse_b, dtype=np.float64)

        B = len(problems)
        fo = np.cumsum(f_incr_h, axis=1)
        bo = np.cumsum(b_incr_h[:, ::-1], axis=1)[:, ::-1]
        Ds = np.array([p.n_diag for p in problems], dtype=np.int32)
        total_f = lse_f_h + fo[np.arange(B), Ds]
        total_b = lse_b_h + bo[:, 0]

        cvec = (fo + bo - total_f[:, None]).astype(bfb.DTYPE)
        post = bfb.posterior_batched(fstack, bstack, cvec, args[0], args[1],
                                     Ds, W=W, P=P)

        results = []
        if threshold is not None:
            # ~3x events bounds the pairs above 1% per read (upstream
            # property: rows <= 3x events); a larger count reruns wider
            K = _compact_k(3 * max(p.lY for p in problems))
            counts, vals, idx = bfb.compact_posterior(post, threshold, K=K)
            counts_h = np.asarray(counts)
            if counts_h.max() > K:
                K = _compact_k(int(counts_h.max()))
                counts, vals, idx = bfb.compact_posterior(post, threshold,
                                                          K=K)
            vals_h = np.asarray(vals)
            idx_h = np.asarray(idx)
            for i, p in enumerate(problems):
                n = int(counts_h[i])
                pairs = bfb.decode_compact_pairs(p, vals_h[i, :n],
                                                 idx_h[i, :n], P, W)
                results.append({"pairs": pairs, "total_f": float(total_f[i]),
                                "total_b": float(total_b[i])})
        else:
            post_h = np.asarray(post)
            for i in range(B):
                results.append({"post": post_h[i],
                                "total_f": float(total_f[i]),
                                "total_b": float(total_b[i])})

        if with_expectations:
            z = np.zeros((B, 1))
            fo_d1 = np.concatenate([z, fo[:, :-1]], axis=1)
            fo_d2 = np.concatenate([z, z, fo[:, :-2]], axis=1)
            cvec_d1 = (fo_d1 + bo - total_f[:, None]).astype(bfb.DTYPE)
            cvec_d2 = (fo_d2 + bo - total_f[:, None]).astype(bfb.DTYPE)
            eargs = [fstack, bstack, cvec_d1, cvec_d2,
                     args[0], args[1], args[2], args[3], args[4], args[5],
                     args[8], args[10], Ds, args[12], kmer_ids, *extra]
            texp, kexp = bfb.expectations_batched(
                *eargs, W=W, P=P, mode=mode,
                num_kmers=problems[0].num_kmers)
            texp_h = np.asarray(texp, dtype=np.float64)
            kexp_h = np.asarray(kexp, dtype=np.float64)
            for i in range(B):
                results[i]["texp"] = texp_h[i]
                results[i]["kexp"] = kexp_h[i]
        return results

    return finish


def run_banded_fb_batch(problems: Sequence[bfb.BandedProblem], W: int, P: int,
                        with_expectations: bool = False,
                        threshold: Optional[float] = None,
                        device=None) -> List[Dict]:
    """Run a same-bucket batch to completion (see launch_banded_fb_batch)."""
    return launch_banded_fb_batch(problems, W, P, with_expectations,
                                  threshold, device)()

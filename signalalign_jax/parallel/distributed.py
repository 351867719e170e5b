"""Multi-chip execution: read-batch data parallelism over a device mesh.

The reference's entire parallel story is a process pool running one
signalMachine subprocess per read (utils/multithread.py:79-236) plus
file-based EM reduction (expectation TSVs summed in Python,
hiddenMarkovModel.py:424-557). Here:

* reads (stacked banded problems) are sharded along a ``reads`` mesh axis;
* the model/tables are tiny and replicated;
* EM expectation reduction is an on-device ``psum`` over the mesh —
  transitions are a (3,3) tensor, so the collective is trivial;
* multi-host scaling shards the read batch across hosts with the same
  program (jax.distributed + the same mesh). The mesh is one flat
  ``reads`` axis: the cards of a host are joined all to all, so no
  axis needs to follow a physical topology.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
try:                                   # jax >= 0.8 moved shard_map to core
    from jax import shard_map
except ImportError:                    # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as PS

from signalalign_jax.ops import banded_fb as bfb

READS_AXIS = "reads"


def make_mesh(n_devices: Optional[int] = None, axis: str = READS_AXIS) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _df_add(x, y):
    """Double-float addition of (hi, lo) f32 pairs (Knuth TwoSum): about
    twice f32's precision, and associative enough for a scan."""
    s, e = _two_sum(x[0], y[0])
    e = e + (x[1] + y[1])
    hi = s + e
    return hi, e - (hi - s)


def _df_neg(x):
    return -x[0], -x[1]


def _df_value(*terms):
    """Sum of (hi, lo) terms, rounded to f32 once at the end."""
    acc = terms[0]
    for t in terms[1:]:
        acc = _df_add(acc, t)
    return acc[0] + acc[1]


def _device_offsets(incr, reverse: bool):
    """Per-diagonal offset prefix sums on device, as (hi, lo) pairs.

    Offsets reach 1e4-1e5 nats, where one f32 rounding is ~1e-2 nats, and
    the posterior normalizer is a difference of such offsets; a plain f32
    cumsum costs ~1e-3 in posteriors over a few thousand diagonals. The
    compensated scan keeps the host path's float64 accuracy within a few
    f32 ulps of the small differences the kernels consume.
    """
    x = incr[..., ::-1] if reverse else incr
    hi, lo = jax.lax.associative_scan(_df_add, (x, jnp.zeros_like(x)),
                                      axis=-1)
    if reverse:
        hi, lo = hi[..., ::-1], lo[..., ::-1]
    return hi, lo


def _at_diag(off, n_diag):
    idx = n_diag[:, None]
    return (jnp.take_along_axis(off[0], idx, axis=1)[:, 0],
            jnp.take_along_axis(off[1], idx, axis=1)[:, 0])


def _shift(off, k):
    """Offsets of diagonal d-k at position d (zeros before diagonal k)."""
    z = jnp.zeros(off[0].shape[:-1] + (k,), off[0].dtype)
    return (jnp.concatenate([z, off[0][..., :-k]], axis=-1),
            jnp.concatenate([z, off[1][..., :-k]], axis=-1))


def _col(x):
    return x[0][:, None], x[1][:, None]


def _em_shard_fn(args, W: int, P: int, mode: int, num_kmers: int = 0):
    """Per-shard EM expectation computation over a local read batch.

    ``args`` is the 13-tuple from batch.stack_problems, optionally followed
    by a stacked (B, P, LX) kmer_ids array enabling per-kmer emission
    expectations (num_kmers > 0)."""
    (x0, width, ref_params, legal, ev_params, log_trans, start_logs,
     end_logs, var, lX, lY, n_diag, ev_front_pad) = args[:13]

    sweep = jax.vmap(partial(bfb._banded_sweeps_core, W=W, P=P, mode=mode))
    fstack, f_incr, lse_f, bstack, b_incr, lse_b = sweep(
        x0, width, ref_params, legal, ev_params, log_trans, start_logs,
        end_logs, var, lX, lY, n_diag, ev_front_pad)

    fo = _device_offsets(f_incr, reverse=False)
    bo = _device_offsets(b_incr, reverse=True)
    total = _df_add((lse_f, jnp.zeros_like(lse_f)), _at_diag(fo, n_diag))
    total_f = total[0] + total[1]
    neg_total = _col(_df_neg(total))
    cvec_d1 = _df_value(_shift(fo, 1), bo, neg_total)
    cvec_d2 = _df_value(_shift(fo, 2), bo, neg_total)

    exps = jax.vmap(partial(bfb._expectations_core, W=W, P=P, mode=mode,
                            num_kmers=num_kmers))
    eargs = [fstack, bstack, cvec_d1, cvec_d2, x0, width, ref_params,
             legal, ev_params, log_trans, var, lY, n_diag, ev_front_pad]
    if len(args) > 13:
        eargs.append(args[13])
    texp, kexp = exps(*eargs)

    # likelihood uses the reference's per-diagonal accumulation hack
    # (diagonalCalculation_Expectations, pairwiseAligner.c:1433)
    lik = jnp.sum(total_f * n_diag.astype(total_f.dtype))
    texp_sum = jnp.sum(texp, axis=0)

    texp_all = jax.lax.psum(texp_sum, READS_AXIS)
    lik_all = jax.lax.psum(lik, READS_AXIS)
    # per-kmer emission moments: tiny (3, num_kmers) -> all-reduce
    kexp_all = jax.lax.psum(jnp.sum(kexp, axis=0), READS_AXIS)
    return texp_all, lik_all, total_f, kexp_all


def em_expectation_step(mesh: Mesh, stacked_args, W: int, P: int, mode: int,
                        num_kmers: int = 0):
    """Sharded EM E-step: returns (replicated (3,3) transition expectations,
    total likelihood, per-read total log probs, replicated (3, num_kmers)
    emission moments)."""
    specs_in = tuple(PS(READS_AXIS) for _ in stacked_args)
    fn = shard_map(
        partial(_em_shard_fn, W=W, P=P, mode=mode, num_kmers=num_kmers),
        mesh=mesh,
        in_specs=(specs_in,),
        out_specs=(PS(), PS(), PS(READS_AXIS), PS()),
    )
    return jax.jit(fn)(tuple(stacked_args))


def normalize_transitions(texp: jnp.ndarray) -> jnp.ndarray:
    """Row-normalize transition expectations (M-step for transitions).

    reference: normalize_transitions_expectations
    (hiddenMarkovModel.py:488-520 via continuousHmm normalization).
    """
    rows = jnp.sum(texp, axis=1, keepdims=True)
    return jnp.where(rows > 0, texp / rows, texp)


def em_train_step(mesh: Mesh, stacked_args, W: int, P: int, mode: int,
                  num_kmers: int = 0):
    """One full EM iteration over a sharded read batch: E-step psum +
    transition M-step. The flagship multi-chip training program.

    With num_kmers > 0 (stacked_args carries kmer_ids as element 14) the
    replicated per-kmer emission moments come back too; the Gaussian M-step
    (models.expectations.emission_slots_from_kexp + HmmModel.normalize
    semantics) is a host-side O(num_kmers) update."""
    texp, lik, totals, kexp = em_expectation_step(mesh, stacked_args, W, P,
                                                  mode, num_kmers)
    new_trans = normalize_transitions(texp)
    if num_kmers > 0:
        return new_trans, lik, totals, kexp
    return new_trans, lik, totals


def _infer_shard_fn(args, W: int, P: int, mode: int):
    """Per-shard posterior inference: forward/backward totals + per-read
    diagonal normalization vector (compact posterior summary)."""
    (x0, width, ref_params, legal, ev_params, log_trans, start_logs,
     end_logs, var, lX, lY, n_diag, ev_front_pad) = args
    sweep = jax.vmap(partial(bfb._banded_sweeps_core, W=W, P=P, mode=mode))
    fstack, f_incr, lse_f, bstack, b_incr, lse_b = sweep(
        x0, width, ref_params, legal, ev_params, log_trans, start_logs,
        end_logs, var, lX, lY, n_diag, ev_front_pad)
    fo = _device_offsets(f_incr, reverse=False)
    bo = _device_offsets(b_incr, reverse=True)
    total = _df_add((lse_f, jnp.zeros_like(lse_f)), _at_diag(fo, n_diag))
    total_f = total[0] + total[1]
    total_b = _df_value((lse_b, jnp.zeros_like(lse_b)),
                        (bo[0][:, 0], bo[1][:, 0]))
    cvec = _df_value(fo, bo, _col(_df_neg(total)))
    post = jax.vmap(partial(bfb._posterior_core, W=W, P=P))(
        fstack, bstack, cvec, x0, width, n_diag)
    return total_f, total_b, post


def infer_step(mesh: Mesh, stacked_args, W: int, P: int, mode: int):
    """Data-parallel posterior decoding over the mesh: each device aligns
    its shard of reads with identical replicated model tables; outputs stay
    sharded along ``reads`` (fetch per-shard or feed downstream sharded
    ops). This is the multi-chip analogue of the reference's process pool
    (utils/multithread.py) for inference."""
    specs_in = tuple(PS(READS_AXIS) for _ in stacked_args)
    fn = shard_map(
        partial(_infer_shard_fn, W=W, P=P, mode=mode),
        mesh=mesh,
        in_specs=(specs_in,),
        out_specs=(PS(READS_AXIS), PS(READS_AXIS), PS(READS_AXIS)),
    )
    return jax.jit(fn)(tuple(stacked_args))

#!/usr/bin/env python3
"""Smoke run of the main path on an NVIDIA GPU, end to end, at deployment size.

    python chip_smoke.py                 # one card: phases W1, W2, W3
    python chip_smoke.py --four-cards    # four local cards: multi-card paths only
    python chip_smoke.py --profile       # also trace one warm W1 run and reduce it

Everything is made from ``--seed`` (utils/synthetic.py): models, genomes and
reads. Nothing is read from outside the repository.

* W1, flowcell posterior alignment: a 6-mer ACGT pore model (4,096 k-mers,
  the shape of the r9.4 450 bps template model), ~64 reads with events
  log-uniform over 1k-100k, through ``run_alignment_batch`` and full TSVs.
* W2, CpG methylation calling with HDP emissions in site mode: a 6-mer ACEGT
  model with an HDP table of 15,625 k-mers x 1,200 grid points, 16 reads
  over the CG->YG reference edition, ``run_alignment_batch(call_variants=
  "CE")`` and the variants TSVs.
* W3, one EM iteration (transitions + Gaussian emissions) over 16 reads.

Every phase is checked twice: its device op against the float64 oracle
(ops/fb_oracle.py) on short inputs, and the same jitted functions on the GPU
against the host CPU at full width. Any mismatch fails the run. The last
line of standard output is the one JSON object the chip harness reads; it is
printed only when every phase passed.

Tolerances (the DP has no matrix product, so TF32 plays no part; the
differences come from f32 exp/log and summation order):
  * oracle: total log-prob 1e-4 relative (f32 sweeps vs f64 over a few
    thousand diagonals), pair posteriors 3e-3 absolute, transition
    expectations 5e-3 absolute + 5e-3 relative;
  * GPU vs CPU, same f32 program at full width (thousands of diagonals,
    bands up to 768 wide): total log-prob 1e-5 relative (1e-4 for HDP
    emissions: measured 2.4e-5 on the H100 for a P=8 bucket, against 9e-8
    for Gaussian emissions); pair posteriors 3e-3 absolute, the oracle's
    own f32-vs-f64 bound (rounding accumulates along the diagonal chain
    differently on each backend: measured 9.7e-4 for a W=768 Gaussian
    bucket and 2.2e-3 for a P=8 HDP bucket); site marginals 1e-2 at sites
    with the same contributing pairs on both sides and a mass >= 0.5 (a
    few pairs per site, each within 3e-3; a pair flipping at the
    threshold moves a site by its whole share, so such sites are counted,
    not held); expectation sums 1e-3 relative + 1e-2 absolute (sums over
    ~1e5 cells of those posteriors).
  * --four-cards: the one-card and four-card runner results must be
    identical (same program, same chunks); the sharded EM / infer steps
    run the same f32 sweeps and take their offset prefix sums on the
    device in compensated (double-float) arithmetic against the host's
    float64 (parallel/distributed.py): 1e-4 on transitions, 1e-5 relative
    on totals, 1e-3 of the largest entry on emission moments and 1e-3 on
    posteriors. (A plain f32 prefix had missed by 6.3e-4 on transitions
    on four H100s.)
Pairs whose posterior sits within the tolerance of the 0.01 threshold may
appear on one side only.
"""

import argparse
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
THRESHOLD = 0.01


class SmokeFailure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def card_lines():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


class CompileCounter:
    """Counts XLA backend compiles and their seconds (jax.monitoring)."""

    def __init__(self):
        import jax
        from jax._src import dispatch
        self.event = dispatch.BACKEND_COMPILE_EVENT
        self.n = 0
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, *args, **kwargs):
        if event == self.event:
            self.n += 1
            self.seconds += duration

    def snapshot(self):
        return self.n, self.seconds


def timed_batch(rgs, reference, model, config, **kw):
    """run_alignment_batch with the runner's stage timing captured."""
    from signalalign_jax.pipeline.runner import run_alignment_batch
    os.environ["SIGNALALIGN_TIMING"] = "1"
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(buf):
            res = run_alignment_batch(rgs, reference, model, config, **kw)
    finally:
        os.environ.pop("SIGNALALIGN_TIMING", None)
    wall = time.perf_counter() - t0
    stages = {}
    for line in buf.getvalue().splitlines():
        if line.startswith("[runner-timing]"):
            stages = {k: float(v) for k, v in
                      re.findall(r"(\S+)=([0-9.]+)s", line)}
    sys.stderr.write(buf.getvalue())
    return res, wall, stages


# ---------------------------------------------------------------------------
# correctness helpers
# ---------------------------------------------------------------------------

def compare_pairs(a, b, tol, what):
    """Same pairs above threshold (flips within tol of it allowed), values
    within tol. Pairs are (prob_int, x, y, kmer) with prob_int = p * 1e7."""
    da = {(x, y, k): p for p, x, y, k in a}
    db = {(x, y, k): p for p, x, y, k in b}
    worst = 0.0
    for key in set(da) ^ set(db):
        p = da.get(key, db.get(key)) / 1e7
        check(abs(p - THRESHOLD) <= tol,
              f"{what}: pair {key} p={p} on one side only")
    for key in set(da) & set(db):
        worst = max(worst, abs(da[key] - db[key]) / 1e7)
    check(worst <= tol, f"{what}: pair posterior differs by {worst}")
    return worst


def oracle_problems(model, seed, n, mode, P, hdp=None):
    """Short (<=1k event) seeded problems with anchors, for the oracle."""
    import numpy as np

    from signalalign_jax.models.pore_model import ScalingParams
    from signalalign_jax.ops import banded_fb as bfb
    from signalalign_jax.ops.band_geometry import band_widths, build_band
    from signalalign_jax.pipeline.signal_align import _bucket_d, _bucket_w
    from signalalign_jax.utils.alphabet import DEFAULT_AMBIG_BASES

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        nk = 300 + 200 * i
        seq = list("".join(rng.choice(list("ACGT"), size=nk)))
        if P == 2:
            for pos in range(9, nk - 8, 23):
                seq[pos] = "P"                   # C/E
        seq = "".join(seq)
        ids = model.alphabet.seq_to_kmer_ids(seq.replace("P", "C"))
        reps = 1 + (rng.random(len(ids)) < 0.25)  # some stays
        kid = np.repeat(ids, reps)
        params = ScalingParams(shift=0.4 * i, scale=1.0 + 0.01 * i,
                               var=1.0 + 0.03 * i)
        ev = np.stack([params.scale * model.level_mean[kid] + params.shift
                       + rng.normal(0, 1.0, len(kid)) * model.level_sd[kid],
                       np.abs(rng.normal(1.0, 0.1, len(kid))),
                       np.full(len(kid), .002),
                       np.arange(len(kid)) * .002], 1)
        pos_ev = np.concatenate([[0], np.cumsum(reps)[:-1]])
        anchors = [(int(x), int(pos_ev[x])) for x in range(20, len(ids) - 20,
                                                           40)]
        lX = len(ids)
        xmyL, xmyR = build_band(anchors, lX, len(kid), 20)
        W = _bucket_w(int(band_widths(xmyL, xmyR).max()))
        Dpad = _bucket_d(lX + len(kid))
        prob = bfb.prepare_problem(
            seq, ev, model, params, DEFAULT_AMBIG_BASES, W=W, Dpad=Dpad,
            P=P, mode=mode, anchor_pairs=anchors, expansion=20, hdp=hdp)
        out.append((prob, seq, ev, anchors, params, W))
    return out


def check_against_oracle(gpu, model, seed, mode, P, hdp=None,
                         expectations=False):
    """Device op (ops/batch.py on the GPU) vs the float64 oracle."""
    import numpy as np

    from signalalign_jax.ops import banded_fb as bfb
    from signalalign_jax.ops.batch import run_banded_fb_batch
    from signalalign_jax.ops.fb_oracle import (CellPaths, Emissions,
                                               banded_forward_backward)
    from signalalign_jax.utils.alphabet import DEFAULT_AMBIG_BASES

    oname = {bfb.MODE_MEAN_ONLY: "mean_only", bfb.MODE_HDP: "hdp"}[mode]
    worst = {"total_rel": 0.0, "pair_abs": 0.0}
    for prob, seq, ev, anchors, params, W in oracle_problems(
            model, seed, 3, mode, P, hdp):
        got = run_banded_fb_batch([prob], W=W, P=P, threshold=THRESHOLD,
                                  with_expectations=expectations,
                                  device=gpu)[0]
        paths = CellPaths.from_sequence(seq, model, DEFAULT_AMBIG_BASES)
        em = Emissions(model, params, mode=oname, hdp=hdp)
        orc = banded_forward_backward(
            paths, ev, model, em, anchor_pairs=anchors, expansion=20,
            threshold=THRESHOLD, compute_expectations=expectations)
        rel = abs(got["total_f"] - orc["total_log_prob_f"]) \
            / abs(orc["total_log_prob_f"])
        check(rel <= 1e-4, f"oracle total: rel diff {rel}")
        worst["total_rel"] = max(worst["total_rel"], rel)
        worst["pair_abs"] = max(worst["pair_abs"], compare_pairs(
            got["pairs"], orc["aligned_pairs"], 3e-3, "oracle pairs"))
        if expectations:
            want = orc["transition_expectations"]
            d = float(np.max(np.abs(got["texp"] - want)
                             / (5e-3 + 5e-3 * np.abs(want))))
            check(d <= 1.0, f"oracle texp outside tolerance ({d})")
            worst["texp_tol_used"] = max(worst.get("texp_tol_used", 0.0), d)
    return worst


def runner_buckets(rgs, reference, model, config, hdp=None):
    """{(W, Dpad, P): problems} as the runner's own host prep builds them."""
    from collections import defaultdict

    from signalalign_jax.pipeline.runner import prepare_read
    buckets = defaultdict(list)
    for read, guide in rgs:
        for _, problem, W, Dpad, P in prepare_read(
                read, guide, reference, model, config, hdp)[4]:
            buckets[(W, Dpad, P)].append(problem)
    return buckets


def widest_bucket(buckets, n=2, want_p=1):
    """Up to n problems of the widest bucket with at least want_p paths."""
    keys = [k for k in buckets if k[2] >= want_p]
    key = max(keys, key=lambda k: (k[0] * k[2], k[1], len(buckets[k])))
    return key, buckets[key][:n]


def check_gpu_vs_cpu(gpu, problems, key, expectations=False, sites=None,
                     variants=None, total_tol=1e-5):
    """The same jitted batch on the GPU and on the host CPU."""
    import jax
    import numpy as np

    from signalalign_jax.ops.batch import run_banded_fb_batch
    from signalalign_jax.pipeline.variant_caller import marginals_from_pairs

    W, _, P = key
    cpu = jax.devices("cpu")[0]
    g = run_banded_fb_batch(problems, W=W, P=P, threshold=THRESHOLD,
                            with_expectations=expectations, device=gpu)
    c = run_banded_fb_batch(problems, W=W, P=P, threshold=THRESHOLD,
                            with_expectations=expectations, device=cpu)
    worst = {"total_rel": 0.0, "pair_abs": 0.0, "n_pairs": 0}
    for i, (a, b) in enumerate(zip(g, c)):
        rel = abs(a["total_f"] - b["total_f"]) / abs(b["total_f"])
        check(rel <= total_tol, f"gpu vs cpu total: rel diff {rel}")
        worst["total_rel"] = max(worst["total_rel"], rel)
        worst["pair_abs"] = max(worst["pair_abs"], compare_pairs(
            a["pairs"], b["pairs"], 3e-3, "gpu vs cpu pairs"))
        worst["n_pairs"] += len(a["pairs"])
        if sites is not None:
            # a pair at the threshold on one side only moves its site's
            # marginal by its whole share, so only sites with the same
            # contributing pairs on both sides and mass >= 0.5 are held
            # to the tolerance (each pair within 3e-3, a few per site)
            k1 = problems[i].kmer_len - 1
            cells = {int(c) for c in sites[i]}

            def by_site(pairs):
                out = {}
                for p, x, y, k in pairs:
                    if x + 1 in cells:
                        out.setdefault(x + k1, {})[(x, y, k)] = p / 1e7
                return out
            sa, sb = by_site(a["pairs"]), by_site(b["pairs"])
            ma = marginals_from_pairs(a["pairs"], sites[i], problems[i],
                                      variants)
            mb = marginals_from_pairs(b["pairs"], sites[i], problems[i],
                                      variants)
            held = [pos for pos in sa if pos in sb and pos in ma
                    and pos in mb and set(sa[pos]) == set(sb[pos])
                    and sum(sb[pos].values()) >= 0.5]
            d = max([abs(ma[pos][v] - mb[pos][v]) for pos in held
                     for v in ma[pos]], default=0.0)
            check(d <= 1e-2, f"gpu vs cpu site marginal differs by {d}")
            worst["site_abs"] = max(worst.get("site_abs", 0.0), d)
            worst["sites_held"] = worst.get("sites_held", 0) + len(held)
            worst["sites_other"] = worst.get("sites_other", 0) \
                + len(set(ma) | set(mb)) - len(held)
        if expectations:
            for name in ("texp", "kexp"):
                x, y = np.asarray(a[name]), np.asarray(b[name])
                d = float(np.max(np.abs(x - y) / (1e-2 + 1e-3 * np.abs(y))))
                check(d <= 1.0, f"gpu vs cpu {name} outside tolerance ({d})")
                worst[name + "_tol_used"] = max(
                    worst.get(name + "_tol_used", 0.0), d)
    return worst


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_w1(gpu, out_dir, seed, n_reads, ev_max, counter, profile=False):
    from signalalign_jax.io.output import write_full_tsv
    from signalalign_jax.ops import banded_fb as bfb
    from signalalign_jax.pipeline.signal_align import AlignmentConfig
    from signalalign_jax.utils.synthetic import (build_synthetic_batch,
                                                 seeded_pore_model)

    model = seeded_pore_model("ACGT", 6, seed=seed)
    rgs, reference, _, _, _ = build_synthetic_batch(
        model, n_reads=n_reads, ev_max=ev_max, seed=seed,
        fasta_path=os.path.join(out_dir, "w1_genome.fa"))
    cfg = AlignmentConfig()
    n_events = sum(r.n_events for r, _ in rgs)
    info = {"reads": len(rgs), "events": n_events,
            "model": "ACGT 6-mer (4096 k-mers)"}

    c0 = counter.snapshot()
    res, cold_s, _ = timed_batch(rgs, reference, model, cfg)
    c1 = counter.snapshot()
    res, warm_s, stages = timed_batch(rgs, reference, model, cfg)
    c2 = counter.snapshot()
    check(len(res) == len(rgs), f"W1: {len(rgs) - len(res)} reads failed")
    check(c2[0] == c1[0], f"W1: second call compiled {c2[0] - c1[0]} times")
    t0 = time.perf_counter()
    w_dir = os.path.join(out_dir, "w1_tsv")
    os.makedirs(w_dir, exist_ok=True)
    n_rows = 0
    for r in res:
        check(math.isfinite(r.total_log_prob), f"W1 {r.read_label}: total")
        check(r.aligned_pairs, f"W1 {r.read_label}: no aligned pairs")
        rows = r.full_rows(model)
        n_rows += len(rows)
        label = "forward" if r.forward else "backward"
        write_full_tsv(os.path.join(w_dir, f"{r.read_label}.sm.{label}.tsv"),
                       rows, append=False)
    out_s = time.perf_counter() - t0
    info.update({
        "cold_s": cold_s, "compiles": c1[0] - c0[0],
        "compile_s": c1[1] - c0[1], "warm_s": warm_s,
        "warm_compiles": c2[0] - c1[0], "stages_s": stages,
        "events_per_s": n_events / warm_s, "reads_per_s": len(rgs) / warm_s,
        "tsv_s": out_s, "tsv_rows": n_rows,
        "events_per_s_with_tsv": n_events / (warm_s + out_s)})
    info["oracle"] = check_against_oracle(gpu, model, seed + 1,
                                          bfb.MODE_MEAN_ONLY, 1)
    buckets = runner_buckets(rgs, reference, model, cfg)
    info["buckets"] = {f"W{k[0]}_D{k[1]}_P{k[2]}": len(v)
                       for k, v in sorted(buckets.items())}
    key, probs = widest_bucket(buckets)
    info["gpu_vs_cpu"] = dict(check_gpu_vs_cpu(gpu, probs, key),
                              bucket=list(key), problems=len(probs))
    if profile:
        info["trace"] = profile_w1(gpu, rgs, reference, model, cfg, buckets,
                                   out_dir)
        info["trace"]["idle_share_of_warm_run"] = \
            1.0 - info["trace"]["device_busy_s"] / warm_s
    return info, (rgs, reference, model)


def phase_w2(gpu, out_dir, seed, n_reads, ev_max, counter):
    import numpy as np

    from signalalign_jax.ops import banded_fb as bfb
    from signalalign_jax.pipeline.runner import write_variant_outputs
    from signalalign_jax.pipeline.signal_align import AlignmentConfig
    from signalalign_jax.utils.synthetic import (build_synthetic_batch,
                                                 seeded_hdp,
                                                 seeded_pore_model)

    model = seeded_pore_model("ACEGT", 6, seed=seed + 10)
    hdp = seeded_hdp(model)
    _, _, rgs, reference, _ = build_synthetic_batch(
        model, n_reads=n_reads, ev_max=ev_max, seed=seed + 10,
        ambig_frac=1.0, ambig_motif=("CG", "YG"),
        fasta_path=os.path.join(out_dir, "w2_genome.fa"))
    cfg = AlignmentConfig(emission_mode=bfb.MODE_HDP, ambig_map={"Y": "CE"})
    n_events = sum(r.n_events for r, _ in rgs)
    info = {"reads": len(rgs), "events": n_events,
            "model": "ACEGT 6-mer (15625 k-mers), HDP grid 1200"}
    c0 = counter.snapshot()
    res, cold_s, _ = timed_batch(rgs, reference, model, cfg, hdp=hdp,
                                 call_variants="CE")
    c1 = counter.snapshot()
    res, warm_s, stages = timed_batch(rgs, reference, model, cfg, hdp=hdp,
                                      call_variants="CE")
    c2 = counter.snapshot()
    check(len(res) == len(rgs), f"W2: {len(rgs) - len(res)} reads failed")
    check(c2[0] == c1[0], f"W2: second call compiled {c2[0] - c1[0]} times")
    n_calls = sum(len(r.variant_calls) for r in res)
    check(n_calls > 0, "W2: no site calls")
    for r in res:
        for c, e in zip(r.variant_calls["C"], r.variant_calls["E"]):
            check(abs(c + e - 1.0) < 1e-6, "W2: site probabilities")
    t0 = time.perf_counter()
    w_dir = os.path.join(out_dir, "w2_variants")
    os.makedirs(w_dir, exist_ok=True)
    written = write_variant_outputs(res, w_dir, "CE")
    out_s = time.perf_counter() - t0
    info.update({
        "cold_s": cold_s, "compiles": c1[0] - c0[0],
        "compile_s": c1[1] - c0[1], "warm_s": warm_s,
        "warm_compiles": c2[0] - c1[0], "stages_s": stages,
        "events_per_s": n_events / warm_s, "reads_per_s": len(rgs) / warm_s,
        "site_calls": n_calls, "tsv_files": len(written), "tsv_s": out_s})
    info["oracle"] = check_against_oracle(gpu, model, seed + 11,
                                          bfb.MODE_HDP, 2, hdp=hdp)
    key, probs = widest_bucket(runner_buckets(rgs, reference, model, cfg,
                                              hdp), want_p=2)
    k1 = model.kmer_length
    amb = np.frombuffer(b"Y", np.uint8)
    sites = [np.flatnonzero(np.isin(np.frombuffer(
        p.seq.encode(), np.uint8)[k1 - 1:k1 - 1 + p.lX], amb)) + 1
        for p in probs]
    info["gpu_vs_cpu"] = dict(check_gpu_vs_cpu(gpu, probs, key, sites=sites,
                                               variants="CE", total_tol=1e-4),
                              bucket=list(key), problems=len(probs))
    return info


def phase_w3(gpu, seed, w1_data, n_reads, counter):
    import numpy as np

    from signalalign_jax.ops import banded_fb as bfb
    from signalalign_jax.pipeline.signal_align import AlignmentConfig
    from signalalign_jax.pipeline.train import em_train

    rgs, reference, model = w1_data
    rgs = rgs[:n_reads]
    n_events = sum(r.n_events for r, _ in rgs)
    c0 = counter.snapshot()
    t0 = time.perf_counter()
    res = em_train(rgs, reference, model, iterations=1,
                   update_transitions=True, update_emissions=True,
                   emission_prior_weight=100.0)
    cold_s = time.perf_counter() - t0
    c1 = counter.snapshot()
    t0 = time.perf_counter()
    res = em_train(rgs, reference, model, iterations=1,
                   update_transitions=True, update_emissions=True,
                   emission_prior_weight=100.0)
    warm_s = time.perf_counter() - t0
    c2 = counter.snapshot()
    check(c2[0] == c1[0], f"W3: second call compiled {c2[0] - c1[0]} times")
    trans = res.transitions_history[0]
    rows = trans.sum(axis=1)
    check(np.allclose(rows, 1.0, atol=1e-9), f"W3: transition rows {rows}")
    check(all(math.isfinite(v) for v in res.log_likelihoods),
          "W3: likelihood not finite")
    check(np.isfinite(res.model.level_mean).all(), "W3: emission update")
    info = {"reads": len(rgs), "events": n_events, "cold_s": cold_s,
            "compiles": c1[0] - c0[0], "compile_s": c1[1] - c0[1],
            "warm_s": warm_s, "warm_compiles": c2[0] - c1[0],
            "events_per_s": n_events / warm_s,
            "log_likelihood": res.log_likelihoods[0],
            "transition_row_sums": rows.tolist()}
    info["oracle"] = check_against_oracle(gpu, model, seed + 21,
                                          bfb.MODE_MEAN_ONLY, 1,
                                          expectations=True)
    key, probs = widest_bucket(runner_buckets(
        rgs, reference, model, AlignmentConfig(compute_expectations=True)))
    info["gpu_vs_cpu"] = dict(check_gpu_vs_cpu(gpu, probs, key,
                                               expectations=True),
                              bucket=list(key), problems=len(probs))
    return info


def profile_w1(gpu, rgs, reference, model, cfg, buckets, out_dir):
    """One warm W1 run under the profiler, reduced to device metrics; then
    the largest bucket alone, for its sweep's time per scan step."""
    import jax

    from signalalign_jax.ops.batch import launch_banded_fb_batch
    from signalalign_jax.utils.trace import module_runs, reduce_trace
    trace_dir = os.path.join(out_dir, "w1_trace")
    os.environ["SIGNALALIGN_PROFILE"] = trace_dir
    try:
        _, traced_s, _ = timed_batch(rgs, reference, model, cfg)
    finally:
        os.environ.pop("SIGNALALIGN_PROFILE", None)
    out = {"run": reduce_trace(trace_dir), "traced_run_s": traced_s}
    # the traced run's wall-clock includes the tracer's own host cost;
    # the untraced warm run is the phase's window
    out["device_busy_s"] = out["run"]["busy_s"]
    # largest bucket by band cells: sweep time per anti-diagonal step
    key = max(buckets, key=lambda k: len(buckets[k]) * (k[1] + 1)
              * k[0] * k[2])
    W, Dpad, P = key
    probs = buckets[key]
    launch_banded_fb_batch(probs, W, P, threshold=THRESHOLD, device=gpu)()
    bucket_dir = os.path.join(out_dir, "w1_bucket_trace")
    with jax.profiler.trace(bucket_dir):
        launch_banded_fb_batch(probs, W, P, threshold=THRESHOLD,
                               device=gpu)()
    sweep = module_runs(bucket_dir, "jit_banded_sweeps_batched")[0]
    steps = 2 * (Dpad + 1)                 # forward + backward scans
    out["largest_bucket"] = {
        "bucket": [W, Dpad, P], "problems": len(probs),
        "sweep": sweep, "scan_steps": steps,
        "kernel_us_per_step": sweep["busy_s"] / steps * 1e6,
        "gap_us_per_step": (sweep["window_s"] - sweep["busy_s"])
        / steps * 1e6,
        "modules": reduce_trace(bucket_dir)["kernel_s_by_module"]}
    return out


def four_cards(out_dir, seed, n_reads, ev_max):
    """Multi-card paths only: the runner over 4 local cards vs one card,
    and the sharded EM / infer steps vs the unsharded batch."""
    import jax
    import numpy as np

    from signalalign_jax.ops import banded_fb as bfb
    from signalalign_jax.ops.batch import (run_banded_fb_batch,
                                           stack_kmer_ids, stack_problems)
    from signalalign_jax.parallel import distributed as dist
    from signalalign_jax.pipeline import runner as runner_mod
    from signalalign_jax.pipeline.signal_align import AlignmentConfig
    from signalalign_jax.utils.synthetic import (build_synthetic_batch,
                                                 seeded_pore_model)

    devs = jax.local_devices()
    model = seeded_pore_model("ACGT", 6, seed=seed)
    rgs, reference, _, _, _ = build_synthetic_batch(
        model, n_reads=n_reads, ev_max=ev_max, seed=seed,
        fasta_path=os.path.join(out_dir, "c4_genome.fa"))
    cfg = AlignmentConfig()
    info = {"reads": len(rgs), "events": sum(r.n_events for r, _ in rgs)}

    # one card: the runner sees only the first device
    real = jax.local_devices
    jax.local_devices = lambda *a, **k: real(*a, **k)[:1]
    try:
        one, _, _ = timed_batch(rgs, reference, model, cfg)
        one, one_s, _ = timed_batch(rgs, reference, model, cfg)
    finally:
        jax.local_devices = real
    timed_batch(rgs, reference, model, cfg)          # compile on all cards
    trace = []
    runner_mod.set_dispatch_trace(trace)
    try:
        four, four_s, stages = timed_batch(rgs, reference, model, cfg)
    finally:
        runner_mod.set_dispatch_trace(None)
    disp = [e for e in trace if e[0] == "dispatch"]
    used = sorted({e[1] for e in disp})
    check(used == [0, 1, 2, 3], f"chunks went to cards {used}")
    depth, all_four = [0] * 4, False      # replay the per-card queues
    for kind, dev, _ in trace:
        depth[dev] += 1 if kind == "dispatch" else -1
        all_four = all_four or min(depth) > 0
    check(all_four, "never all four cards in flight at once")
    for a, b in zip(one, four):
        check(a.read_label == b.read_label, "read order")
        check(a.total_log_prob == b.total_log_prob and
              a.aligned_pairs == b.aligned_pairs,
              f"{a.read_label}: four-card result differs from one card")
    info.update({"one_card_s": one_s, "four_card_s": four_s,
                 "scaling": one_s / four_s, "dispatches": len(disp),
                 "max_in_flight": max(t for _, _, t in disp),
                 "stages_s": stages})

    # sharded EM / infer over a 4-device mesh vs the unsharded batch
    key, probs = widest_bucket(runner_buckets(rgs, reference, model, cfg),
                               n=8)
    probs = (probs * 8)[:8]
    W, _, P = key
    args = stack_problems(probs)
    mesh = dist.make_mesh(4)
    new_trans, lik, totals, kexp = dist.em_train_step(
        mesh, tuple(args) + (stack_kmer_ids(probs),), W=W, P=P,
        mode=bfb.MODE_MEAN_ONLY, num_kmers=model.num_kmers)
    ref = run_banded_fb_batch(probs, W=W, P=P, with_expectations=True,
                              device=devs[0])
    texp = sum(r["texp"] for r in ref)
    want = texp / texp.sum(axis=1, keepdims=True)
    d = float(np.max(np.abs(np.asarray(new_trans) - want)))
    check(d <= 1e-4, f"sharded EM transitions differ by {d}")
    rt = np.array([r["total_f"] for r in ref])
    dt = float(np.max(np.abs(np.asarray(totals) - rt) / np.abs(rt)))
    check(dt <= 1e-5, f"sharded EM totals differ by {dt} relative")
    kref = sum(r["kexp"] for r in ref)
    dk = float(np.max(np.abs(np.asarray(kexp) - kref)) / np.max(np.abs(kref)))
    check(dk <= 1e-3, f"sharded EM kexp differs by {dk} of its largest entry")
    total_f, _, post = dist.infer_step(mesh, args, W=W, P=P,
                                       mode=bfb.MODE_MEAN_ONLY)
    full = run_banded_fb_batch(probs, W=W, P=P, device=devs[0])
    di = float(np.max(np.abs(np.asarray(total_f) - rt) / np.abs(rt)))
    check(di <= 1e-5, f"sharded infer totals differ by {di} relative")
    dp = max(float(np.max(np.abs(np.asarray(post[i]) - f["post"])))
             for i, f in enumerate(full))
    check(dp <= 1e-3, f"sharded infer posteriors differ by {dp}")
    info["sharded"] = {"bucket": list(key), "problems": len(probs),
                       "em_trans_abs": d, "em_total_rel": dt,
                       "em_kexp_rel": dk, "infer_total_rel": di,
                       "infer_post_abs": dp}
    return info


def run_phases(args, devs, out_dir):
    """The phases; genomes, TSVs and traces go to ``out_dir`` (a scratch
    directory: a flowcell's TSVs run to hundreds of MB)."""
    summary = {"devices": [d.device_kind for d in devs], "seed": args.seed}
    t_all = time.perf_counter()
    if args.four_cards:
        check(len(devs) == 4, f"--four-cards needs 4 local GPUs: {devs}")
        summary["four_cards"] = four_cards(out_dir, args.seed,
                                           args.w1_reads // 4,
                                           min(args.ev_max, 20_000))
    else:
        gpu = devs[0]
        counter = CompileCounter()
        summary["W1"], w1_data = phase_w1(gpu, out_dir, args.seed,
                                          args.w1_reads, args.ev_max,
                                          counter, profile=args.profile)
        print("W1", json.dumps(summary["W1"]), flush=True)
        summary["W2"] = phase_w2(gpu, out_dir, args.seed, args.w2_reads,
                                 args.ev_max, counter)
        print("W2", json.dumps(summary["W2"]), flush=True)
        summary["W3"] = phase_w3(gpu, args.seed, w1_data, args.w3_reads,
                                 counter)
        print("W3", json.dumps(summary["W3"]), flush=True)
    summary["total_s"] = time.perf_counter() - t_all
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths and their checks")
    ap.add_argument("--profile", action="store_true",
                    help="trace one warm W1 run and reduce the trace")
    ap.add_argument("--w1-reads", type=int, default=64)
    ap.add_argument("--w2-reads", type=int, default=16)
    ap.add_argument("--w3-reads", type=int, default=16)
    ap.add_argument("--ev-max", type=int, default=100_000,
                    help="longest read, in events (log-uniform from 1k)")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU, JAX found {devs}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import signalalign_jax  # noqa: F401  (fails outside the repository)

    for line in card_lines():
        print(line)
    with tempfile.TemporaryDirectory() as work:
        summary = run_phases(args, devs, work)
    out_dir = os.path.join(REPO, "chiprun_out", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)

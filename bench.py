"""Benchmark: end-to-end rates of the served path on one GPU.

Drives the two entry points users call, on a seeded synthetic flowcell
batch (utils/synthetic.py: a 6-mer ACGT pore model, reads with events
log-uniform over 1k..--ev-max and nanopore-like guide errors):

  * run_alignment_batch — posterior alignment, host prep and result
    decode included (events/s and reads/s from the caller's side);
  * em_train — one EM iteration (transitions + Gaussian emissions).

A warm-up call compiles every bucket shape first; timed calls run to
completion (results are host values, so the device work has finished).
Prints one JSON line with the device as JAX reports it (platform,
device_kind, count), the card's name and power limit from nvidia-smi,
and the rates. Exits non-zero when JAX finds no GPU: no number here is
ever a CPU number.

    python bench.py [--reads 64] [--ev-max 100000] [--reps 3] [--seed 0]
"""

import argparse
import json
import os
import subprocess
import sys
import time


def card_info():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=64)
    ap.add_argument("--ev-max", type=int, default=100_000)
    ap.add_argument("--em-reads", type=int, default=16)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench: needs an NVIDIA GPU, JAX found {devs}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from signalalign_jax.pipeline.runner import run_alignment_batch
    from signalalign_jax.pipeline.signal_align import AlignmentConfig
    from signalalign_jax.pipeline.train import em_train
    from signalalign_jax.utils.synthetic import (build_synthetic_batch,
                                                 seeded_pore_model)

    model = seeded_pore_model("ACGT", 6, seed=args.seed)
    rgs, reference, _, _, _ = build_synthetic_batch(
        model, n_reads=args.reads, ev_max=args.ev_max, seed=args.seed)
    cfg = AlignmentConfig()
    n_events = sum(r.n_events for r, _ in rgs)

    t0 = time.perf_counter()
    run_alignment_batch(rgs, reference, model, cfg)
    cold = time.perf_counter() - t0
    align_s = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        res = run_alignment_batch(rgs, reference, model, cfg)
        align_s.append(time.perf_counter() - t0)
    if len(res) != len(rgs):
        raise RuntimeError(f"{len(rgs) - len(res)} reads failed")

    em_rgs = rgs[:args.em_reads]
    em_events = sum(r.n_events for r, _ in em_rgs)
    em_train(em_rgs, reference, model, iterations=1, update_emissions=True,
             emission_prior_weight=100.0)
    em_s = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        em_train(em_rgs, reference, model, iterations=1,
                 update_emissions=True, emission_prior_weight=100.0)
        em_s.append(time.perf_counter() - t0)

    med = sorted(align_s)[len(align_s) // 2]
    em_med = sorted(em_s)[len(em_s) // 2]
    print(json.dumps({
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs)},
        "card": card_info(),
        "workload": {"reads": len(rgs), "events": n_events,
                     "ev_max": args.ev_max, "seed": args.seed},
        "align_cold_s": cold, "align_s": align_s,
        "align_events_per_s": n_events / med,
        "align_reads_per_s": len(rgs) / med,
        "em_reads": len(em_rgs), "em_iteration_s": em_s,
        "em_events_per_s": em_events / em_med,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Measure path_split at flowcell scale on the GPU.

path_split isolates sparse adjacent-degenerate (P=4) windows into their
own segments so the bulk of a CpG-calling workload runs at 2 paths per
cell, at the price of extra shape buckets. This times it at batch sizes
that fill those buckets: a synthetic all-CpG-ambiguous workload of
SPLIT_READS (default 512) reads through run_alignment_batch in
site-calling mode, split off vs on.

Usage: SPLIT_READS=512 python scripts/measure_path_split.py
Prints one JSON line per configuration; exits non-zero without a GPU.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs an NVIDIA GPU, JAX found {dev}", file=sys.stderr)
        return 2
    from signalalign_jax.pipeline.runner import run_alignment_batch
    from signalalign_jax.pipeline.signal_align import AlignmentConfig
    from signalalign_jax.utils.synthetic import (build_synthetic_batch,
                                                 seeded_pore_model)

    n_reads = int(os.environ.get("SPLIT_READS", "512"))
    reps = int(os.environ.get("SPLIT_REPS", "3"))
    model = seeded_pore_model("ACGT", 6, seed=23)
    # all-ambiguous: every read over the CpG-Y-edited reference --
    # sparse adjacent CpGs in random sequence give the natural P mix
    _, _, rgs, reference, _ = build_synthetic_batch(
        model, n_reads=n_reads, ev_min=800, ev_max=8000, seed=23,
        ambig_frac=1.0)
    ev = sum(r.events.shape[0] for r, _ in rgs)
    print(f"# {len(rgs)} reads, {ev} events", file=sys.stderr)

    for split in (False, True):
        cfg = AlignmentConfig(ambig_map={"Y": "CT"}, path_split=split)

        def run():
            res = run_alignment_batch(rgs, reference, model, cfg,
                                      call_variants="CT")
            assert sum(len(x.variant_calls) for x in res) > 0

        run()     # compile + warm
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        dt = time.perf_counter() - t0
        print(json.dumps({
            "device": {"platform": dev.platform, "kind": dev.device_kind},
            "path_split": split,
            "events_per_s": ev * reps / dt,
            "reads": len(rgs), "events": ev,
            "wall_s_per_rep": dt / reps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

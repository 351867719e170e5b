"""Command-line interface: runSignalAlign / trainModels equivalents.

reference: scripts/runSignalAlign.py (run/run2 subcommands, JSON config)
and src/signalalign/train/trainModels.py. The JSON config schema follows
the reference's documented keys (README.md:85-251) where they map onto
this pipeline; process-pool keys (job_count etc.) are accepted and
ignored (device batching replaces them).

Usage:
  python -m signalalign_jax.cli run --config config.json
  python -m signalalign_jax.cli run --alignment_file x.bam --readdb x.readdb \
      --fast5_dir d/ --ref ref.fa --model m.model --output_dir out/
  python -m signalalign_jax.cli train --config trainModels-config.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional



def _load_config(path: Optional[str]) -> dict:
    if path is None:
        return {}
    with open(path) as fh:
        return json.load(fh)


def _sample_from_config(cfg: dict) -> dict:
    samples = cfg.get("samples")
    if samples:
        return samples[0]
    return cfg


def cmd_run(args) -> int:
    from signalalign_jax.io.reference import AmbiguityPositions
    from signalalign_jax.models.hdp_model import load_nhdp
    from signalalign_jax.models.pore_model import PoreModel
    from signalalign_jax.ops import banded_fb as bfb
    from signalalign_jax.pipeline.runner import run_signal_align
    from signalalign_jax.pipeline.signal_align import AlignmentConfig

    cfg = _load_config(args.config)
    sample = _sample_from_config(cfg)

    alignment_file = args.alignment_file or sample.get("alignment_file")
    readdb = args.readdb or sample.get("readdb")
    fast5_dirs = args.fast5_dir or sample.get("fast5_dirs") or []
    if isinstance(fast5_dirs, str):
        fast5_dirs = [fast5_dirs]
    ref = args.ref or cfg.get("reference") or sample.get("bwa_reference")
    model_path = args.model or cfg.get("template_hmm_model")
    output_dir = args.output_dir or cfg.get("output_dir") or "signalalign_out"
    hdp_path = args.hdp or cfg.get("template_hdp_model")

    if args.twod:
        from signalalign_jax.pipeline.runner import run_signal_align_2d
        cmodel_path = args.complement_model or cfg.get("complement_hmm_model")
        missing = [n for n, v in [("fast5_dir", fast5_dirs), ("ref", ref),
                                  ("model", model_path),
                                  ("complement_model", cmodel_path)] if not v]
        if missing:
            print(f"missing required arguments: {missing}", file=sys.stderr)
            return 1
        config = AlignmentConfig(
            threshold=float(args.threshold),
            diagonal_expansion=int(args.diagonal_expansion),
            constraint_trim=int(args.constraint_trim))
        written = run_signal_align_2d(
            fast5_dirs=fast5_dirs, reference_fasta=ref,
            template_model=PoreModel.from_file(model_path),
            complement_model=PoreModel.from_file(cmodel_path),
            output_dir=output_dir, config=config,
            output_format=args.output_format, max_reads=args.max_reads)
        print(f"[signalalign_jax] wrote {len(written)} output files to "
              f"{output_dir}")
        return 0

    missing = [n for n, v in [("alignment_file", alignment_file),
                              ("fast5_dir", fast5_dirs),
                              ("ref", ref), ("model", model_path)] if not v]
    if missing:
        print(f"missing required arguments: {missing}", file=sys.stderr)
        return 1

    model = PoreModel.from_file(model_path)
    hdp = load_nhdp(hdp_path) if hdp_path else None
    positions = None
    pf = args.positions_file or sample.get("positions_file")
    if pf:
        positions = AmbiguityPositions.from_file(pf)
    motifs = sample.get("motifs")

    ambig_map = None
    am = args.ambig_model or sample.get("ambig_model")
    if am:
        from signalalign_jax.utils.alphabet import load_ambig_model
        ambig_map = load_ambig_model(am)
    config = AlignmentConfig(
        threshold=float(args.threshold),
        diagonal_expansion=int(args.diagonal_expansion),
        constraint_trim=int(args.constraint_trim),
        emission_mode=bfb.MODE_HDP if hdp else bfb.MODE_MEAN_ONLY,
        **({"ambig_map": ambig_map} if ambig_map else {}),
    )
    written = run_signal_align(
        alignment_file=alignment_file, readdb=readdb, fast5_dirs=fast5_dirs,
        reference_fasta=ref, model=model, output_dir=output_dir,
        config=config, output_format=args.output_format,
        positions=positions, motifs=motifs, hdp=hdp,
        max_reads=args.max_reads, embed=args.embed,
        force_kmer_event_alignment=args.force_kmer_event_alignment,
        target_regions=(__import__("signalalign_jax.io.guide",
                                   fromlist=["TargetRegions"])
                        .TargetRegions(args.target_regions)
                        if args.target_regions else None),
        quality_threshold=float(cfg.get("filter_reads", 7.0) or 7.0),
        distributed=bool(getattr(args, "distributed", False)),
        variants=getattr(args, "variants", None))
    print(f"[signalalign_jax] wrote {len(written)} output files to "
          f"{output_dir}")
    return 0


def cmd_train(args) -> int:
    from signalalign_jax.io.guide import guide_from_sam_record
    from signalalign_jax.io.read import NanoporeReadData
    from signalalign_jax.io.reference import ProcessedReference
    from signalalign_jax.io.sam import filter_reads
    from signalalign_jax.models.pore_model import PoreModel
    from signalalign_jax.pipeline.runner import run_alignment_batch
    from signalalign_jax.pipeline.signal_align import AlignmentConfig
    from signalalign_jax.pipeline.train import (collect_kmer_observations,
                                                em_train,
                                                train_gaussian_emissions,
                                                write_hdp_training_file)

    cfg = _load_config(args.config)
    # multi-sample training: expectations pool over every sample block
    # (trainModels.py samples[] semantics); CLI args override/define a
    # single sample when no config list is given
    samples = cfg.get("samples") or [_sample_from_config(cfg)]
    if args.alignment_file or args.readdb or args.fast5_dir:
        # CLI read-source args define exactly one sample; mixing them
        # into config sample blocks would mispair BAMs and readdbs
        samples = [samples[0]]
    training = cfg.get("training", {})

    ref = args.ref or cfg.get("reference") \
        or samples[0].get("bwa_reference")
    model_path = args.model or cfg.get("template_hmm_model")
    output_dir = args.output_dir or cfg.get("output_dir") or "training_out"
    iterations = int(args.iterations or training.get("em_iterations", 3))

    model = PoreModel.from_file(model_path)
    reference = ProcessedReference(ref)

    def _sample_reference(sample):
        """The sample's motif/positions-edited reference
        (CreateHdpTrainingData per-sample labels,
        /root/reference/src/signalalign/train/trainModels.py:427-520 +
        samples[] motifs/positions schema, README.md:185-203): an mC
        sample's alignments must carry E-labelled kmers."""
        motifs = sample.get("motifs")
        pf = sample.get("positions_file")
        if not motifs and not pf:
            return reference
        from signalalign_jax.io.reference import AmbiguityPositions
        positions = AmbiguityPositions.from_file(pf) if pf else None
        motifs_t = [tuple(m) for m in motifs] if motifs else None
        sref = sample.get("bwa_reference") or ref
        return ProcessedReference(sref, positions=positions,
                                  motifs=motifs_t)

    pairs = []          # (fast5, sam_record, sample_index)
    sample_refs = [_sample_reference(s) for s in samples]
    for si, sample in enumerate(samples):
        alignment_file = args.alignment_file or sample.get("alignment_file")
        readdb = args.readdb or sample.get("readdb")
        fast5_dirs = args.fast5_dir or sample.get("fast5_dirs") or []
        if isinstance(fast5_dirs, str):
            fast5_dirs = [fast5_dirs]
        pairs.extend((f5, rec, si) for f5, rec in
                     filter_reads(alignment_file, readdb, fast5_dirs))
    if args.max_reads:
        pairs = pairs[:args.max_reads]
    distributed = bool(getattr(args, "distributed", False))
    proc0 = True
    if distributed:
        # each host aligns only its shard; em_train cross_host sums the
        # expectation tensors over jax.process_count() hosts
        import jax

        from signalalign_jax.parallel import multihost
        multihost.initialize()
        pairs = multihost.host_shard(pairs)
        proc0 = jax.process_index() == 0
    rgs = []            # (read, guide, per-sample reference) triples
    rgs_by_sample = [[] for _ in samples]
    for f5, rec, si in pairs:
        try:
            read = NanoporeReadData.from_fast5(f5)
            guide = guide_from_sam_record(rec)
            if guide and guide.validate(read.read_length):
                rgs.append((read, guide, sample_refs[si]))
                rgs_by_sample[si].append((read, guide))
        except Exception as exc:
            print(f"[train] skipping {f5}: {exc}", file=sys.stderr)

    os.makedirs(output_dir, exist_ok=True)
    result = None
    trans_args = cfg.get("transitions_args", {})
    smt = (training.get("stateMachineType")
           or cfg.get("stateMachineType") or "threeState")
    em_cfg = None
    em_hdp = None
    if smt == "threeStateHdp":
        # HdpHmm transition EM: expectations under HDP emissions
        # (trainModels stateMachineType=threeStateHdp); requires a
        # trained .nhdp alongside the .model
        from signalalign_jax.models.hdp_model import load_nhdp
        from signalalign_jax.pipeline.signal_align import AlignmentConfig
        from signalalign_jax.ops import banded_fb as _bfb
        hdp_path = (cfg.get("template_hdp_model")
                    or training.get("template_hdp_model"))
        if not hdp_path:
            print("threeStateHdp training requires template_hdp_model",
                  file=sys.stderr)
            return 2
        em_hdp = load_nhdp(hdp_path)
        em_cfg = AlignmentConfig(emission_mode=_bfb.MODE_HDP)
    if training.get("transitions", True):
        # unified per-iteration EM: transition posteriors + per-kmer
        # emission moments from one device expectation pass; per-iteration
        # model checkpoints and reference-format expectations files
        # (trainModels.py:922-985 + expectation_maximization_training)
        result = em_train(
            rgs, reference, model, iterations=iterations, verbose=True,
            config=em_cfg, hdp=em_hdp,
            update_transitions=True,
            update_emissions=bool(training.get("em_emissions", False)),
            training_bases=(trans_args.get("training_bases")
                            or training.get("training_bases")),
            checkpoint_dir=output_dir if proc0 else None,
            write_expectations=proc0,
            cross_host=distributed,
            assert_monotonic=bool(trans_args.get("test", False)))
        model = result.model
    def _sample_observations(threshold_default, max_per_kmer=None):
        """Pool per-sample kmer observations, each sample aligned
        against ITS edited reference so modified-base kmers (e.g. CpG->E)
        label that sample's rows (CreateHdpTrainingData semantics,
        trainModels.py:427-520); per-sample probability_threshold and
        number_of_kmer_assignments honored (samples[] schema)."""
        merged = {}
        for si, sample in enumerate(samples):
            if not rgs_by_sample[si]:
                continue
            results = run_alignment_batch(
                rgs_by_sample[si], sample_refs[si], model,
                AlignmentConfig())
            thr = float(sample.get("probability_threshold",
                                   threshold_default))
            mpk = max_per_kmer
            if mpk is not None:
                mpk = int(sample.get("number_of_kmer_assignments", mpk))
            obs = collect_kmer_observations(results, model, threshold=thr,
                                            max_per_kmer=mpk)
            for kmer, vals in obs.items():
                if kmer in merged:
                    import numpy as _np
                    merged[kmer] = _np.concatenate([merged[kmer], vals])
                else:
                    merged[kmer] = vals
        return merged

    if training.get("normal_emissions", False):
        obs = _sample_observations(0.5)
        model = train_gaussian_emissions(obs, model)
    if training.get("hdp_emissions", False):
        obs = _sample_observations(
            0.8, max_per_kmer=int(training.get("max_assignments", 100)))
        build = write_hdp_training_file(
            obs, os.path.join(output_dir, "buildAlignment.tsv"))
        from signalalign_jax.hdp.train import train_hdp_from_alignment
        nhdp_out = os.path.join(output_dir, "template.nhdp")
        hdp_args = cfg.get("hdp_args", {})
        train_hdp_from_alignment(
            build, model,
            hdp_type=training.get("hdp_type",
                                  hdp_args.get("hdp_type",
                                               "singleLevelFixed")),
            out_path=nhdp_out,
            grid_start=float(hdp_args.get("grid_start", 30.0)),
            grid_stop=float(hdp_args.get("grid_end", 180.0)),
            grid_length=int(hdp_args.get("grid_length", 1200)),
            base_gamma=float(hdp_args.get("base_gamma", 1.0)),
            middle_gamma=float(hdp_args.get("middle_gamma", 1.0)),
            leaf_gamma=float(hdp_args.get("leaf_gamma", 1.0)),
            base_alpha=float(hdp_args.get("base_alpha", 1.0)),
            base_beta=float(hdp_args.get("base_beta", 1.0)),
            middle_alpha=float(hdp_args.get("middle_alpha", 1.0)),
            middle_beta=float(hdp_args.get("middle_beta", 1.0)),
            leaf_alpha=float(hdp_args.get("leaf_alpha", 1.0)),
            leaf_beta=float(hdp_args.get("leaf_beta", 1.0)),
            gibbs_samples=int(training.get(
                "gibbs_samples", hdp_args.get("gibbs_samples", 1000))),
            burn_in=int(training.get(
                "burnin_multiplier", hdp_args.get("burnin_multiplier", 32))),
            thinning=int(training.get(
                "thinning", hdp_args.get("thinning", 100))))
        print(f"[train] wrote {nhdp_out}")

    # complement-strand training (2D chemistry): the reference trains
    # both strand HMMs (trainModels twoD path); complement reads come
    # from the 2D fast5s with SW-generated guides (run2 semantics)
    cmodel_path = (getattr(args, "complement_model", None)
                   or cfg.get("complement_hmm_model"))
    if cmodel_path and (getattr(args, "twod", False)
                        or training.get("complement", False)):
        import glob as _glob

        from signalalign_jax.io.minialign import generate_guide_alignment
        from signalalign_jax.io.read import NanoporeRead2DData
        cmodel = PoreModel.from_file(cmodel_path)
        c_rgs = []
        for sample in samples:
            dirs = args.fast5_dir or sample.get("fast5_dirs") or []
            if isinstance(dirs, str):
                dirs = [dirs]
            for d in dirs:
                for f5 in sorted(_glob.glob(os.path.join(d, "*.fast5"))):
                    try:
                        read2d = NanoporeRead2DData.from_fast5(f5)
                        guide = generate_guide_alignment(
                            read2d.twod_sequence, reference)
                        if guide and guide.validate(
                                len(read2d.twod_sequence)):
                            c_rgs.append((read2d.complement, guide))
                    except Exception as exc:
                        print(f"[train] skipping complement {f5}: {exc}",
                              file=sys.stderr)
            if args.fast5_dir:
                break
        if args.max_reads:
            c_rgs = c_rgs[:args.max_reads]
        if c_rgs:
            cres = em_train(
                c_rgs, reference, cmodel, iterations=iterations,
                verbose=True, update_transitions=True,
                update_emissions=bool(training.get("em_emissions", False)),
                checkpoint_dir=output_dir if proc0 else None,
                checkpoint_prefix="complement_trained",
                write_expectations=proc0, cross_host=distributed,
                strand_template=False)
            cfinal = os.path.join(output_dir, "complement_trained.model")
            cres.model.likelihood = cres.model.likelihood or 0.0
            cres.model.write(cfinal)
            print(f"[train] complement log-likelihoods: "
                  f"{cres.log_likelihoods}")
            print(f"[train] wrote {cfinal}")

    final = os.path.join(output_dir, "template_trained.model")
    model.likelihood = model.likelihood or 0.0
    model.write(final)
    if result:
        print(f"[train] log-likelihoods: {result.log_likelihoods}")
    print(f"[train] wrote {final}")
    return 0


def cmd_scan(args) -> int:
    from signalalign_jax.io.guide import guide_from_sam_record
    from signalalign_jax.io.read import NanoporeReadData
    from signalalign_jax.io.sam import filter_reads
    from signalalign_jax.models.pore_model import PoreModel
    from signalalign_jax.pipeline.scan import \
        scan_single_nucleotide_probabilities

    fast5_dirs = args.fast5_dir or []
    model = PoreModel.from_file(args.model)
    pairs = filter_reads(args.alignment_file, args.readdb, fast5_dirs)
    if args.max_reads:
        pairs = pairs[:args.max_reads]
    rgs = []
    for f5, rec in pairs:
        try:
            read = NanoporeReadData.from_fast5(f5)
            guide = guide_from_sam_record(rec)
            if guide and guide.validate(read.read_length):
                rgs.append((read, guide))
        except Exception as exc:
            print(f"[scan] skipping {f5}: {exc}", file=sys.stderr)
    written = scan_single_nucleotide_probabilities(
        rgs, args.ref, model, args.output_dir or "scan_out",
        step_size=int(args.step_size))
    print(f"[signalalign_jax] wrote {len(written)} scan files")
    return 0


def cmd_plot(args) -> int:
    """Plotting toolkit front-end (reference ships one __main__ per
    visualization/*.py; here one subcommand dispatches)."""
    from signalalign_jax import visualization as viz
    if args.what == "summary":
        if not (args.alignment_file and args.readdb):
            print("plot summary requires --alignment_file and --readdb",
                  file=sys.stderr)
            return 2
        os.makedirs(args.output_dir, exist_ok=True)
        viz.sequencing_summary(args.alignment_file, args.readdb,
                               args.fast5_dir or [],
                               out_dir=args.output_dir)
    elif args.what == "em_models":
        if not (args.model and args.kmer):
            print("plot em_models requires --model (repeatable, EM "
                  "iteration order) and --kmer", file=sys.stderr)
            return 2
        os.makedirs(args.output_dir, exist_ok=True)
        out = os.path.join(args.output_dir, "em_models.png")
        viz.plot_em_model_distributions(args.model, args.kmer, out)
        print(f"[plot] wrote {out}")
    elif args.what == "compare_models":
        # per-kmer distance plots live in the compare subcommand; this
        # alias keeps plot discovery symmetrical
        print("use `signalalign_jax compare --plot` for model "
              "comparison figures", file=sys.stderr)
        return 2
    elif args.what == "kmer_overlay":
        # multiple kmers x models on one axes, colormap family per
        # model (compare_trained_models.py plot_kmer_distribution2)
        if not (args.model and args.kmer):
            print("plot kmer_overlay requires --model (repeatable) and "
                  "--kmer (repeatable)", file=sys.stderr)
            return 2
        from signalalign_jax.compare import ModelDistributions
        from signalalign_jax.models.hdp_model import load_nhdp
        from signalalign_jax.models.pore_model import PoreModel
        hdps = list(args.hdp or [])
        mds = []
        for i, mp in enumerate(args.model):
            hdp = load_nhdp(hdps[i]) if i < len(hdps) else None
            mds.append(ModelDistributions(PoreModel.from_file(mp),
                                          hdp=hdp, name=f"model{i}"))
        os.makedirs(args.output_dir, exist_ok=True)
        out = os.path.join(args.output_dir, "kmer_overlay.png")
        viz.plot_kmer_distribution_overlay(mds, args.kmer, out)
        print(f"[plot] wrote {out}")
    elif args.what == "animate":
        # EM-iteration animation of one kmer's distribution
        # (compare_trained_models.py animate_kmer_distribution)
        if not (args.model and args.kmer):
            print("plot animate requires --model (repeatable, EM "
                  "iteration order) and --kmer", file=sys.stderr)
            return 2
        os.makedirs(args.output_dir, exist_ok=True)
        out = os.path.join(args.output_dir,
                           f"em_{args.kmer[0]}.gif")
        written = viz.animate_kmer_distribution(args.model, args.kmer[0],
                                                out)
        print(f"[plot] wrote {written}")
    elif args.what == "deviation":
        # per-site call accuracy vs distance from the guide alignment
        # (reference: visualization/plot_accuracy_vs_alignment_deviation
        # .py) — joins .sm.vc.tsv variant calls with the guide
        # alignment's per-event positions (no DP re-run)
        if not (args.alignment_file and args.readdb and args.fast5_dir
                and args.variant_tsv_dir and args.label):
            print("plot deviation requires --alignment_file --readdb "
                  "--fast5_dir --variant_tsv_dir --label",
                  file=sys.stderr)
            return 2
        import glob as _glob

        from signalalign_jax.io.guide import guide_from_sam_record
        from signalalign_jax.io.read import NanoporeReadData
        from signalalign_jax.io.sam import filter_reads
        from signalalign_jax.pipeline.validate import guide_event_positions
        vc_by_label = {}
        for p in _glob.glob(os.path.join(args.variant_tsv_dir,
                                         "*.sm.vc.tsv")):
            vc_by_label[os.path.basename(p)[:-len(".sm.vc.tsv")]] = p
        all_deltas, all_tf = [], []
        for f5, rec in filter_reads(args.alignment_file, args.readdb,
                                    args.fast5_dir):
            try:
                read = NanoporeReadData.from_fast5(f5)
                vc = vc_by_label.get(read.read_label)
                if vc is None:
                    continue
                guide = guide_from_sam_record(rec)
                gpos = guide_event_positions(read, guide)
                rows = []
                with open(vc) as fh:
                    for line in fh:
                        parts = line.rstrip("\n").split("\t")
                        if len(parts) >= 4:
                            rows.append((int(parts[0]), int(parts[1]),
                                         parts[2], float(parts[3])))
                d, tf = viz.deviation_call_data(rows, gpos, args.label,
                                                args.threshold)
                all_deltas.append(d)
                all_tf.append(tf)
            except Exception as exc:
                print(f"[plot] skipping {f5}: {exc}", file=sys.stderr)
        if not all_deltas:
            print("plot deviation: no joined calls", file=sys.stderr)
            return 1
        import numpy as np
        data = [(np.concatenate(all_deltas), np.concatenate(all_tf))]
        os.makedirs(args.output_dir, exist_ok=True)
        out = os.path.join(args.output_dir,
                           "accuracy_vs_alignment_deviation.png")
        viz.plot_accuracy_vs_alignment_deviation(data, [args.label], out)
        print(f"[plot] wrote {out}")
    return 0


def cmd_call_methylation(args) -> int:
    """reference: scripts/call_methylation.py — marginalize methylation
    status per site from a directory of full-format .sm TSVs."""
    import glob as _glob

    from signalalign_jax.pipeline.variant_caller import \
        call_methylation_from_tsvs
    paths = sorted(_glob.glob(os.path.join(args.input_dir, "*.sm.*.tsv")))
    paths = [p for p in paths
             if p.endswith(".sm.forward.tsv")
             or p.endswith(".sm.backward.tsv")]
    if not paths:
        print(f"no .sm.forward/.backward.tsv files in {args.input_dir}",
              file=sys.stderr)
        return 2
    out = call_methylation_from_tsvs(paths, args.variants, args.out,
                                     threshold=args.threshold)
    print(f"[call_methylation] {len(paths)} files -> {out} (+ .aggregate)")
    return 0


def cmd_kmer_hist(args) -> int:
    """reference: scripts/generate_kmer_histograms.py."""
    import glob as _glob

    from signalalign_jax.visualization import kmer_histograms_from_tsvs
    paths = sorted(_glob.glob(os.path.join(args.input_dir, "*.sm.*.tsv")))
    written = kmer_histograms_from_tsvs(
        paths, args.kmer, args.output_dir, strand=args.strand,
        threshold=args.threshold, max_assignments=args.max_assignments)
    print(f"[kmer_hist] wrote {len(written)} histogram files to "
          f"{args.output_dir}")
    return 0


def cmd_extract(args) -> int:
    """Pull fastqs (+ index readdb) from fast5 files — the reference's
    ``extract`` binary (impl/extract.c:23 + eventAligner.c
    write_fastq_and_readdb_file1: one fastq, one <out>.index.readdb
    mapping read_id -> fast5 basename)."""
    import glob

    from signalalign_jax.io.fast5 import Fast5

    out = args.output
    if not (out.endswith(".fastq") or out.endswith(".fq")):
        print(f"output file must have fastq or fq extension: {out}",
              file=sys.stderr)
        return 1
    readdb = out + ".index.readdb"
    for p in (out, readdb):
        if os.path.exists(p):
            print(f"output file already exists: {p}", file=sys.stderr)
            return 1
    dirs = [args.fast5dir]
    if args.recursive:
        dirs += [d for d in sorted(glob.glob(os.path.join(args.fast5dir,
                                                          "*")))
                 if os.path.isdir(d)]
    n = 0
    with open(out, "w") as fq, open(readdb, "w") as db:
        for d in dirs:
            for f5path in sorted(glob.glob(os.path.join(d, "*.fast5"))):
                try:
                    with Fast5(f5path) as f5:
                        fastq = f5.template_fastq()
                        read_id = f5.read_id
                except Exception as exc:
                    print(f"[extract] skipping {f5path}: {exc}",
                          file=sys.stderr)
                    continue
                if not fastq:
                    continue
                if not fastq.endswith("\n"):
                    fastq += "\n"
                fq.write(fastq)
                rid = read_id or fastq.split("\n", 1)[0].lstrip("@").split()[0]
                db.write(f"{rid}\t{os.path.basename(f5path)}\n")
                n += 1
    print(f"[extract] wrote {n} reads to {out} (+ {readdb})")
    return 0


def cmd_compare(args) -> int:
    from signalalign_jax.compare import (ModelDistributions,
                                         compare_model_to_own_hdp,
                                         compare_models, dump_densities,
                                         write_comparison_tsv)
    from signalalign_jax.models.hdp_model import load_nhdp
    from signalalign_jax.models.pore_model import PoreModel
    from signalalign_jax.visualization import (plot_kmer_distributions,
                                               plot_model_comparisons)

    os.makedirs(args.output_dir, exist_ok=True)
    model1 = PoreModel.from_file(args.model)
    hdp1 = load_nhdp(args.hdp) if args.hdp else None
    m1 = ModelDistributions(model1, hdp1,
                            name=os.path.basename(args.model))
    if args.model2 or args.hdp2:
        model2 = PoreModel.from_file(args.model2 or args.model)
        hdp2 = load_nhdp(args.hdp2) if args.hdp2 else None
        m2 = ModelDistributions(
            model2, hdp2,
            name=os.path.basename(args.model2 or args.hdp2))
        kmers, kls, hels, deltas = compare_models(m1, m2)
        label = f"{m1.name} vs {m2.name}"
        models = [m1, m2]
    elif hdp1 is not None:
        # single model: HDP vs its own ONT Gaussians
        kmers, kls, hels, deltas = compare_model_to_own_hdp(model1, hdp1)
        label = f"{m1.name} HDP vs ONT"
        models = [m1]
    else:
        print("compare needs --hdp or a second model (--model2/--hdp2)",
              file=sys.stderr)
        return 1
    tsv = os.path.join(args.output_dir, "kl_hellinger_delta_distances.tsv")
    write_comparison_tsv(tsv, kmers, kls, hels, deltas)
    png = os.path.join(args.output_dir, "model_comparisons.png")
    plot_model_comparisons(kls, hels, deltas, png, label=label)
    print(f"[compare] {len(kmers)} kmers -> {tsv}, {png}")
    if args.kmers:
        for kmer in args.kmers.split(","):
            out = os.path.join(args.output_dir, f"kmer_{kmer}.png")
            plot_kmer_distributions(models, kmer, out)
            print(f"[compare] {out}")
    if args.dump_densities and hdp1 is not None:
        dd = os.path.join(args.output_dir, "density_dumps")
        written = dump_densities(hdp1, dd)
        print(f"[compare] dumped {len(written)} kmer densities to {dd}")
    return 0


def cmd_mixture(args) -> int:
    from signalalign_jax.models.pore_model import PoreModel
    from signalalign_jax.pipeline.mixture import (
        generate_mixture_model_for_motifs, get_motif_kmer_pairs,
        read_assignment_table)

    import numpy as np

    model = PoreModel.from_file(args.model)
    assignments = {}
    for path in args.assignments:
        for key, vals in read_assignment_table(path).items():
            prev = assignments.get(key)
            assignments[key] = (vals if prev is None
                                else np.concatenate([prev, vals]))
    pairs = []
    for spec in args.motif:
        canonical, modified = spec.split(",")
        pairs.extend(get_motif_kmer_pairs(
            (canonical, modified), model.alphabet.kmer_length,
            alphabet="ATGC"))
    rows = generate_mixture_model_for_motifs(
        model, assignments, pairs, strand=args.strand,
        output_dir=args.output_dir, name=args.name, plot=args.plot)
    print(f"[mixture] fit {len(rows)}/{len(pairs)} kmer pairs -> "
          f"{args.output_dir}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="signalalign_jax")
    sub = parser.add_subparsers(dest="command", required=True)

    runp = sub.add_parser("run", help="align reads (runSignalAlign)",
                          aliases=["run2"])
    runp.add_argument("--config")
    runp.add_argument("--alignment_file")
    runp.add_argument("--readdb")
    runp.add_argument("--fast5_dir", action="append")
    runp.add_argument("--ref")
    runp.add_argument("--model")
    runp.add_argument("--hdp")
    runp.add_argument("--positions_file")
    runp.add_argument("--target_regions",
                      help="2-column tsv restricting alignments to regions")
    runp.add_argument("--ambig_model",
                      help="custom ambiguity-expansion table (tsv)")
    runp.add_argument("--output_dir")
    runp.add_argument("--output_format", default="full",
                      choices=["full", "variantCaller", "both",
                               "assignments", "variants"])
    runp.add_argument("--variants",
                      help="candidate bases for --output_format=variants "
                           "(e.g. CE for CpG methylation); derived from "
                           "the ambiguity map when omitted")
    runp.add_argument("--threshold", default=0.01)
    runp.add_argument("--diagonal_expansion", default=50)
    runp.add_argument("--constraint_trim", default=14)
    runp.add_argument("--max_reads", type=int)
    runp.add_argument("--force_kmer_event_alignment", action="store_true",
                      help="regenerate event tables from raw signal even "
                           "when basecall events exist")
    runp.add_argument("--distributed", action="store_true",
                      help="host-shard the read list over "
                      "jax.process_count() processes (jax.distributed; "
                      "set SIGNALALIGN_COORD/NPROC/PROC off-pod); each "
                      "host writes its shard's TSVs")
    runp.add_argument("--embed", action="store_true",
                      help="write alignment + MEA labels into the fast5s")
    runp.add_argument("--2d", dest="twod", action="store_true",
                      help="2D chemistry: align template + complement")
    runp.add_argument("--complement_model")
    runp.set_defaults(func=cmd_run)

    trainp = sub.add_parser("train", help="train models (trainModels)")
    trainp.add_argument("--config")
    trainp.add_argument("--alignment_file")
    trainp.add_argument("--readdb")
    trainp.add_argument("--fast5_dir", action="append")
    trainp.add_argument("--ref")
    trainp.add_argument("--model")
    trainp.add_argument("--output_dir")
    trainp.add_argument("--iterations", type=int)
    trainp.add_argument("--max_reads", type=int)
    trainp.add_argument("--complement_model",
                        help="train a complement-strand model too "
                             "(2D chemistry; reads from the 2D fast5s)")
    trainp.add_argument("--2d", dest="twod", action="store_true")
    trainp.add_argument("--distributed", action="store_true",
                        help="multi-host EM (jax.distributed; set "
                             "SIGNALALIGN_COORD/NPROC/PROC per host)")
    trainp.set_defaults(func=cmd_train)

    scanp = sub.add_parser(
        "scan", help="per-position base probabilities "
                     "(singleNucleotideProbabilities)")
    scanp.add_argument("--alignment_file", required=True)
    scanp.add_argument("--readdb", required=True)
    scanp.add_argument("--fast5_dir", action="append")
    scanp.add_argument("--ref", required=True)
    scanp.add_argument("--model", required=True)
    scanp.add_argument("--output_dir")
    scanp.add_argument("--step_size", default=10)
    scanp.add_argument("--max_reads", type=int)
    scanp.set_defaults(func=cmd_scan)

    cmpp = sub.add_parser(
        "compare", help="per-kmer distribution distances between models "
                        "(compareDistributions / compare_trained_models)")
    cmpp.add_argument("--model", required=True)
    cmpp.add_argument("--hdp")
    cmpp.add_argument("--model2")
    cmpp.add_argument("--hdp2")
    cmpp.add_argument("--output_dir", default="compare_out")
    cmpp.add_argument("--kmers", help="comma-separated kmers to plot")
    cmpp.add_argument("--dump_densities", action="store_true",
                      help="write x_vals.txt + per-kmer _distr.txt density "
                           "dumps (compareDistributions equivalent)")
    cmpp.set_defaults(func=cmd_compare)

    plotp = sub.add_parser("plot", help="plotting toolkit "
                           "(sequencing summary, EM model evolution, "
                           "accuracy vs alignment deviation)")
    plotp.add_argument("what",
                       choices=["summary", "em_models", "compare_models",
                                "deviation", "kmer_overlay", "animate"])
    plotp.add_argument("--hdp", action="append",
                       help=".nhdp file(s) paired with --model "
                            "(kmer_overlay)")
    plotp.add_argument("--alignment_file")
    plotp.add_argument("--readdb")
    plotp.add_argument("--fast5_dir", action="append")
    plotp.add_argument("--model", action="append",
                       help="model file(s), EM iteration order")
    plotp.add_argument("--kmer", action="append")
    plotp.add_argument("--variant_tsv_dir",
                       help="directory of .sm.vc.tsv files (deviation)")
    plotp.add_argument("--label",
                       help="known-correct base for the sample (deviation)")
    plotp.add_argument("--threshold", type=float, default=0.5)
    plotp.add_argument("--output_dir", default="plots")
    plotp.set_defaults(func=cmd_plot)

    cmp_ = sub.add_parser(
        "call_methylation",
        help="per-site variant calls from full-format .sm TSVs "
             "(scripts/call_methylation.py)")
    cmp_.add_argument("--input_dir", required=True,
                      help="directory of .sm.*.tsv full-format outputs")
    cmp_.add_argument("--variants", default="CE",
                      help="candidate bases (twoWay CE, threeWay CEO)")
    cmp_.add_argument("--threshold", type=float, default=0.0)
    cmp_.add_argument("--out", required=True)
    cmp_.set_defaults(func=cmd_call_methylation)

    khp = sub.add_parser(
        "kmer_hist",
        help="per-kmer descaled event-mean histograms from .sm TSVs "
             "(scripts/generate_kmer_histograms.py)")
    khp.add_argument("--input_dir", required=True)
    khp.add_argument("--kmer", action="append", required=True)
    khp.add_argument("--strand", default="t", choices=["t", "c"])
    khp.add_argument("--threshold", type=float, default=0.0)
    khp.add_argument("--max_assignments", type=int, default=10000)
    khp.add_argument("--output_dir", default="kmer_hist")
    khp.set_defaults(func=cmd_kmer_hist)

    extp = sub.add_parser("extract",
                          help="pull fastqs from fast5 files (extract)")
    extp.add_argument("-d", "--fast5dir", required=True)
    extp.add_argument("-o", "--output", required=True)
    extp.add_argument("-r", "--recursive", action="store_true",
                      help="search all immediate subdirectories")
    extp.set_defaults(func=cmd_extract)

    mixp = sub.add_parser(
        "mixture", help="fit per-kmer Gaussian mixtures at modification "
                        "motifs and build a modified-kmer model "
                        "(mixture_model)")
    mixp.add_argument("--model", required=True)
    mixp.add_argument("--assignments", nargs="+", required=True,
                      help="buildAlignment/assignments TSVs "
                           "(kmer strand mean [prob])")
    mixp.add_argument("--motif", action="append", required=True,
                      help="canonical,modified motif pair, e.g. CCAGG,CEAGG"
                           " (repeatable)")
    mixp.add_argument("--strand", default="t", choices=("t", "c"))
    mixp.add_argument("--output_dir", required=True)
    mixp.add_argument("--name", default="")
    mixp.add_argument("--plot", action="store_true")
    mixp.set_defaults(func=cmd_mixture)

    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())

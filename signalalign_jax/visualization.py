"""Plotting utilities: labelled raw-signal reads and variant accuracy.

reference: visualization/plot_labelled_read.py + validateSignalAlignment
plot generation and visualization/plot_variant_accuracy.py (simplified to
the core plots; the reference ships ~3k lines of experiment-specific
figures).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def plot_labelled_read(raw_signal: np.ndarray, labels: np.ndarray,
                       out_path: str, title: str = "",
                       window: Optional[tuple] = None,
                       max_labels: int = 400) -> str:
    """Raw signal with MEA label segments (kmer + posterior colouring).

    ``labels`` is the embedded MEA label table (raw_start, raw_length,
    reference_index, posterior_probability, kmer)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lo, hi = window or (int(labels["raw_start"][0]),
                        int(labels["raw_start"][min(len(labels) - 1,
                                                    max_labels)]
                            + labels["raw_length"][min(len(labels) - 1,
                                                       max_labels)]))
    fig, ax = plt.subplots(figsize=(16, 4))
    xs = np.arange(lo, min(hi, len(raw_signal)))
    ax.plot(xs, raw_signal[lo:min(hi, len(raw_signal))], lw=0.4,
            color="0.4", zorder=1)
    cmap = plt.get_cmap("viridis")
    for row in labels:
        s, l = int(row["raw_start"]), int(row["raw_length"])
        if s + l < lo or s > hi:
            continue
        p = float(row["posterior_probability"])
        ax.axvspan(s, s + l, color=cmap(p), alpha=0.25, zorder=0)
    ax.set_xlabel("raw sample")
    ax.set_ylabel("current (pA)")
    ax.set_title(title or "MEA-labelled read")
    sm = plt.cm.ScalarMappable(cmap=cmap)
    sm.set_array([0, 1])
    fig.colorbar(sm, ax=ax, label="posterior")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_variant_accuracy(labelled: "pandas.DataFrame", out_path: str,
                          variants: str = "CE") -> str:
    """Per-site called-probability distribution split by truth label
    (plot_variant_accuracy.py core panel)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(variants), figsize=(5 * len(variants), 4),
                             squeeze=False)
    for ax, v in zip(axes[0], variants):
        truth = labelled[labelled[v + "_label"] == 1]
        other = labelled[labelled[v + "_label"] == 0]
        ax.hist(truth[v], bins=20, alpha=0.6, label=f"true {v}",
                color="tab:green")
        ax.hist(other[v], bins=20, alpha=0.6, label=f"not {v}",
                color="tab:red")
        ax.set_xlabel(f"P({v})")
        ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    import matplotlib.pyplot as plt2
    plt2.close(fig)
    return out_path

def plot_kmer_distributions(model_dists, kmer: str, out_path: str,
                            assignments=None) -> str:
    """Overlay one kmer's distributions across models: ONT Gaussian +
    HDP posterior predictive per model, optional event-mean KDE of
    assignment data (compare_trained_models.py:66-242
    plot_kmer_distribution / hiddenMarkovModel.py plot_kmer_distribution).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from signalalign_jax.compare import gaussian_pdf

    fig, ax = plt.subplots(figsize=(10, 5))
    for md in model_dists:
        x = md.linspace
        try:
            mean, sd = md.gaussian_params(kmer)
            ax.plot(x, gaussian_pdf(x, mean, sd), "--", lw=1.2,
                    label=f"{md.name} ONT N({mean:.1f}, {sd:.2f})")
        except (KeyError, ValueError):
            pass
        hdp_y = md.hdp_distribution(kmer)
        if hdp_y is not None and len(hdp_y) and hdp_y.max() > 0:
            ax.plot(md.hdp.grid, hdp_y, "-", lw=1.4,
                    label=f"{md.name} HDP")
    if assignments is not None and len(assignments):
        vals = np.asarray(assignments, dtype=np.float64)
        # gaussian KDE, bandwidth 0.5 (the reference's KernelDensity setup)
        x = model_dists[0].linspace
        z = (x[:, None] - vals[None, :]) / 0.5
        kde = np.exp(-0.5 * z * z).sum(axis=1) / (
            len(vals) * 0.5 * np.sqrt(2 * np.pi))
        ax.plot(x, kde, ":", lw=1.2, label=f"KDE ({len(vals)} events)")
        ax.plot(vals, -0.005 - 0.01 * np.random.default_rng(0)
                .random(len(vals)), "+k", ms=4)
    ax.set_title(kmer)
    ax.set_xlabel("event mean (pA)")
    ax.set_ylabel("density")
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def kmer_histograms_from_tsvs(tsv_paths, kmers, out_dir: str,
                              strand: str = "t", threshold: float = 0.0,
                              max_assignments: int = 10_000,
                              plot: bool = True):
    """Per-kmer histograms of descaled event means collected from
    full-format .sm TSVs (reference:
    scripts/generate_kmer_histograms.py + KmerHistogram,
    alignmentAnalysisLib.py): writes ``<kmer>_hist.txt`` data files
    (one mean per line) and, with ``plot``, a histogram PNG per kmer.
    Returns the list of written data files."""
    import os

    from signalalign_jax.pipeline.variant_caller import full_rows_from_tsv

    os.makedirs(out_dir, exist_ok=True)
    wanted = set(kmers)
    per_kmer = {k: [] for k in wanted}
    for path in tsv_paths:
        for r in full_rows_from_tsv(path, threshold=threshold):
            if r.strand != strand or r.path_kmer not in wanted:
                continue
            vals = per_kmer[r.path_kmer]
            if len(vals) < max_assignments:
                vals.append(r.descaled_event_mean)
    written = []
    for kmer, vals in sorted(per_kmer.items()):
        dp = os.path.join(out_dir, f"{kmer}_hist.txt")
        with open(dp, "w") as fh:
            for v in vals:
                fh.write(f"{v:f}\n")
        written.append(dp)
        if plot and vals:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(6, 4))
            ax.hist(vals, bins=40, color="0.4")
            ax.set_title(f"{kmer} ({strand}) — {len(vals)} events")
            ax.set_xlabel("descaled event mean (pA)")
            fig.tight_layout()
            fig.savefig(os.path.join(out_dir, f"{kmer}_hist.png"), dpi=110)
            plt.close(fig)
    return written


def plot_kmer_distribution_overlay(model_dists, kmers, out_path: str,
                                   strand: str = "t") -> str:
    """SEVERAL kmers' distributions on one axes, one colormap shade
    family per model so same-model curves read as a group
    (compare_trained_models.py:244-330 plot_kmer_distribution2).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm

    from signalalign_jax.compare import gaussian_pdf

    cmaps = [cm.Blues, cm.Oranges, cm.Greens, cm.Purples, cm.Reds,
             cm.Greys]
    fig, ax = plt.subplots(figsize=(12, 6))
    for mi, md in enumerate(model_dists):
        cmap = cmaps[mi % len(cmaps)]
        for ki, kmer in enumerate(kmers):
            shade = 0.45 + 0.5 * (ki + 1) / max(len(kmers), 1)
            color = cmap(min(shade, 0.95))
            try:
                mean, sd = md.gaussian_params(kmer)
                x = md.linspace
                ax.plot(x, gaussian_pdf(x, mean, sd), "--", lw=1.1,
                        color=color,
                        label=f"{md.name} {kmer} ONT")
            except (KeyError, ValueError):
                pass
            hdp_y = md.hdp_distribution(kmer)
            if hdp_y is not None and len(hdp_y) and hdp_y.max() > 0:
                ax.plot(md.hdp.grid, hdp_y, "-", lw=1.4, color=color,
                        label=f"{md.name} {kmer} HDP")
    ax.set_title(f"kmer distributions ({strand} strand)")
    ax.set_xlabel("event mean (pA)")
    ax.set_ylabel("density")
    ax.legend(fontsize=7, ncol=2)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def animate_kmer_distribution(model_paths, kmer: str, out_path: str,
                              assignments=None, fps: int = 2) -> str:
    """EM-iteration animation of one kmer's emission distribution over
    a training run's model checkpoints
    (compare_trained_models.py:331-489 animate_kmer_distribution).
    Writes an animated GIF when a matplotlib animation writer is
    available, otherwise falls back to the static per-iteration overlay
    (plot_em_model_distributions)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from signalalign_jax.models.pore_model import PoreModel

    models = [PoreModel.from_file(p) for p in model_paths]
    params = []
    for m in models:
        kid = m.alphabet.kmer_index(kmer)
        params.append((float(m.level_mean[kid]), float(m.level_sd[kid])))
    lo = min(mu - 4 * sd for mu, sd in params)
    hi = max(mu + 4 * sd for mu, sd in params)
    xs = np.linspace(lo, hi, 300)

    try:
        from matplotlib.animation import FuncAnimation, PillowWriter

        fig, ax = plt.subplots(figsize=(8, 5))
        line, = ax.plot([], [], lw=1.6)
        title = ax.set_title("")
        ax.set_xlim(lo, hi)
        ymax = max(1.0 / (sd * np.sqrt(2 * np.pi)) for _, sd in params)
        ax.set_ylim(0, 1.15 * ymax)
        ax.set_xlabel("descaled current (pA)")
        ax.set_ylabel("density")
        if assignments is not None and len(assignments):
            ax.hist(assignments, bins=30, density=True, color="0.85",
                    zorder=0)

        def frame(i):
            mu, sd = params[i]
            line.set_data(xs, np.exp(-0.5 * ((xs - mu) / sd) ** 2)
                          / (sd * np.sqrt(2 * np.pi)))
            title.set_text(f"{kmer} — EM iteration {i} "
                           f"(mu={mu:.2f}, sd={sd:.2f})")
            return line, title

        anim = FuncAnimation(fig, frame, frames=len(params))
        anim.save(out_path, writer=PillowWriter(fps=fps))
        plt.close(fig)
        return out_path
    except Exception:
        fallback = out_path.rsplit(".", 1)[0] + ".png"
        return plot_em_model_distributions(model_paths, [kmer], fallback,
                                           assignments={kmer: assignments}
                                           if assignments is not None
                                           else None)


def plot_model_comparisons(kls, hels, deltas, out_path: str,
                           label: str = "model1 vs model2") -> str:
    """3-panel histogram of per-kmer KL / Hellinger / median-delta
    distances (compare_trained_models.py:490-578
    plot_all_model_comparisons)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(3, 1, figsize=(10, 9))
    panels = [
        ("Kullback-Leibler divergence (bits)",
         [x for x in kls if x is not None and x > 0]),
        ("Hellinger distance", [x for x in hels if x > 0]),
        ("abs(median delta) (pA)", [x for x in deltas if x > 0]),
    ]
    for ax, (title, vals) in zip(axes, panels):
        vals = vals or [0.0]
        ax.hist(vals, bins=np.linspace(0, max(vals) or 1.0, 30),
                alpha=0.7, label=f"{label} | {len(vals)} kmers")
        ax.set_title(title)
        ax.set_ylabel("count")
        ax.grid(alpha=0.4)
        ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_mixture_fit(canonical_kmer: str, modified_kmer: str,
                     model_mean: float, model_sd: float,
                     canonical_comp, modified_comp,
                     mixture=None, event_means=None,
                     out_path: str = "mixture.png") -> str:
    """Mixture-model comparison figure for one kmer pair: the ONT model
    curve, the fitted canonical/modified mixture components, the overall
    mixture pdf, and a KDE of the raw event means
    (mixture_model.py:203-303 plot_mixture_model_distribution)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from signalalign_jax.compare import gaussian_pdf

    fig, ax = plt.subplots(figsize=(10, 6))
    curves = [(model_mean, model_sd, f"{canonical_kmer} ONT model", "--"),
              (canonical_comp[0], canonical_comp[1],
               f"{canonical_kmer} mixture", "-"),
              (modified_comp[0], modified_comp[1],
               f"{modified_kmer} mixture", "-")]
    lo = min(m - 4 * s for m, s, _, _ in curves)
    hi = max(m + 4 * s for m, s, _, _ in curves)
    x = np.linspace(lo, hi, 400)
    for m, s, label, style in curves:
        ax.plot(x, gaussian_pdf(x, m, s), style, lw=1.4, label=label)
    if mixture is not None:
        ax.plot(x, np.exp(mixture.score_samples(x)), "-k", lw=0.9,
                label="mixture pdf")
    if event_means is not None and len(event_means):
        vals = np.asarray(event_means, dtype=np.float64)
        z = (x[:, None] - vals[None, :]) / 0.5
        kde = np.exp(-0.5 * z * z).sum(axis=1) / (
            len(vals) * 0.5 * np.sqrt(2 * np.pi))
        ax.plot(x, kde, ":", lw=1.2, label=f"KDE ({len(vals)} events)")
        ax.plot(vals, -0.005 - 0.01 * np.random.default_rng(0)
                .random(len(vals)), "+k", ms=4)
    ax.set_title(f"Mixture Model Comparison: {canonical_kmer}")
    ax.set_xlabel("pA")
    ax.set_ylabel("Density")
    ax.grid(alpha=0.4)
    ax.legend(fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_em_model_distributions(model_paths, kmers, out_path: str,
                                assignments=None, show: bool = False):
    """Overlay the per-iteration EM models' emission Gaussians for the
    given kmers — the evolution view of a training run's checkpoints
    (reference: visualization/plot_em_model_distributions.py, reduced to
    the static overlay; the reference animates the same data).

    model_paths: iterable of .model files (EM iteration order);
    assignments: optional {kmer: [descaled means]} observation lists to
    histogram behind the curves.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from signalalign_jax.models.pore_model import PoreModel

    models = [PoreModel.from_file(p) for p in model_paths]
    fig, axes = plt.subplots(len(kmers), 1,
                             figsize=(8, 2.6 * len(kmers)), squeeze=False)
    for ax, kmer in zip(axes[:, 0], kmers):
        for i, m in enumerate(models):
            kid = m.alphabet.kmer_index(kmer)
            mu = float(m.level_mean[kid])
            sd = float(m.level_sd[kid])
            xs = np.linspace(mu - 4 * sd, mu + 4 * sd, 200)
            ys = np.exp(-0.5 * ((xs - mu) / sd) ** 2) / (
                sd * np.sqrt(2 * np.pi))
            ax.plot(xs, ys, label=f"iter {i}",
                    alpha=0.5 + 0.5 * i / max(len(models) - 1, 1))
        if assignments and kmer in assignments and len(assignments[kmer]):
            ax.hist(assignments[kmer], bins=30, density=True,
                    color="0.8", zorder=0)
        ax.set_title(kmer)
        ax.set_xlabel("descaled current (pA)")
        ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    if not show:
        plt.close(fig)
    return out_path


def plot_multiclass_variant_accuracy(labelled, out_dir: str, name: str,
                                     threshold: float = 0.5):
    """Per-class precision/recall and ROC curves for variant calls
    against known labels (reference:
    visualization/plot_multiple_variant_accuracy.py, with the curve
    math in numpy instead of py3helpers' ClassificationMetrics).

    labelled: DataFrame with one row per (read, site): column
    ``label`` (true base) and one probability column per variant base.
    Returns {class: {auc, precision_at_threshold, recall_at_threshold,
    plot_path}}.
    """
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    classes = [c for c in labelled.columns if len(c) == 1]
    out = {}
    fig, (ax_roc, ax_pr) = plt.subplots(1, 2, figsize=(10, 4))
    for cls in classes:
        y = (labelled["label"] == cls).to_numpy().astype(int)
        p = labelled[cls].to_numpy(dtype=float)
        if y.sum() == 0 or y.sum() == len(y):
            continue
        # evaluate the staircase only at distinct-threshold boundaries
        # (tied probabilities advance TP and FP together, so the curve
        # and AUC are order-independent) and anchor at (0, 0)
        order = np.argsort(-p, kind="stable")
        ps = p[order]
        ys = y[order]
        tp_all = np.cumsum(ys)
        fp_all = np.cumsum(1 - ys)
        last = np.nonzero(np.diff(ps, append=-np.inf))[0]
        tp = np.concatenate([[0], tp_all[last]])
        fp = np.concatenate([[0], fp_all[last]])
        tpr = tp / y.sum()
        fpr = fp / (len(y) - y.sum())
        auc = float(np.trapezoid(tpr, fpr))
        prec = tp / np.maximum(tp + fp, 1)
        ax_roc.plot(fpr, tpr, label=f"{cls} (AUC {auc:.3f})")
        ax_pr.plot(tpr, prec, label=cls)
        called = p >= threshold
        tp_t = int(np.sum(called & (y == 1)))
        out[cls] = {
            "auc": auc,
            "precision_at_threshold":
                tp_t / max(int(called.sum()), 1),
            "recall_at_threshold": tp_t / max(int(y.sum()), 1),
        }
    ax_roc.plot([0, 1], [0, 1], "k:", lw=0.7)
    ax_roc.set_xlabel("FPR")
    ax_roc.set_ylabel("TPR")
    ax_roc.set_title(f"ROC — {name}")
    ax_roc.legend(fontsize=8)
    ax_pr.set_xlabel("recall")
    ax_pr.set_ylabel("precision")
    ax_pr.set_title(f"precision-recall — {name}")
    ax_pr.legend(fontsize=8)
    fig.tight_layout()
    path = os.path.join(out_dir, f"{name}_accuracy.png")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    for cls in out:
        out[cls]["plot_path"] = path
    return out


def sequencing_summary(alignment_file: str, readdb: str, fast5_dirs,
                       out_dir: Optional[str] = None,
                       pass_threshold: float = 7.0):
    """Per-read sequencing-run summary: read length, mean q-score,
    mapped/pass flags, plus the headline fractions and histograms
    (reference: visualization/sequencing_summary.py
    get_alignment_summary_info / print_summary_information /
    plot_summary_information, without the worker-pool plumbing — the
    BAM+readdb scan is a single pass here).
    """
    import os

    from signalalign_jax.io.sam import load_readdb, read_bam

    _, records = read_bam(alignment_file)
    by_name = {}
    for rec in records:
        by_name.setdefault(rec.qname.split("_")[0], []).append(rec)
    rows = []
    for name, f5 in load_readdb(readdb, list(fast5_dirs)).items():
        recs = by_name.get(name.split("_")[0], [])
        primary = [r for r in recs if not (r.flag & 0x900)]
        q = 0.0
        length = 0
        if primary:
            qual = primary[0].qual
            if qual:
                phred = np.frombuffer(qual.encode("latin-1"),
                                      dtype=np.uint8) - 33
                q = float(phred.mean())
                length = len(qual)
        rows.append({
            "read_id": name,
            "read_length": length,
            "q_score_average": q,
            "mapped": bool(primary),
            "num_secondary_mappings":
                sum(1 for r in recs if r.flag & 0x100),
            "num_supplementary":
                sum(1 for r in recs if r.flag & 0x800),
            "pass": bool(primary) and q >= pass_threshold,
        })
    import pandas as pd
    df = pd.DataFrame(rows)
    if len(df):
        n_pass = int(df["pass"].sum())
        print(f"[summary] reads={len(df)} passing={n_pass} "
              f"({n_pass / len(df):.3f})")
        failed = df[~df["pass"]]
        if len(failed):
            print(f"[summary] failed unmapped fraction: "
                  f"{float((~failed['mapped']).mean()):.3f}")
            print(f"[summary] failed low-q fraction: "
                  f"{float((failed['q_score_average'] < pass_threshold).mean()):.3f}")
    if out_dir and len(df):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(9, 3.5))
        axes[0].hist(df["read_length"], bins=30)
        axes[0].set_xlabel("read length (bases)")
        axes[1].hist(df["q_score_average"], bins=30)
        axes[1].axvline(pass_threshold, color="r", ls=":")
        axes[1].set_xlabel("mean q-score")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, "sequencing_summary.png"),
                    dpi=110)
        plt.close(fig)
    return df


def plot_alignment_breaks(summaries_by_read, out_path: str,
                          gap_threshold: int = 10):
    """Flagged-gap overview across reads: per-read gap counts and the
    distribution of gap sizes (reference:
    visualization/plot_breaks_in_alignments.py on top of
    validateSignalAlignment's flag_large_gaps — the flagging itself
    lives in pipeline/validate.py here).

    summaries_by_read: {read_label: list[EventSummary]} from
    pipeline.validate.event_summaries.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from signalalign_jax.pipeline.validate import flag_large_gaps

    labels, counts, sizes = [], [], []
    for label, summaries in summaries_by_read.items():
        flagged = flag_large_gaps(summaries, gap_threshold)
        labels.append(label[:8])
        counts.append(len(flagged))
        sizes.extend(f["event_count"] for f in flagged)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(10, 3.6))
    ax1.bar(range(len(labels)), counts)
    ax1.set_xticks(range(len(labels)), labels, rotation=45, fontsize=7)
    ax1.set_ylabel(f"gaps > {gap_threshold}")
    ax1.set_title("flagged alignment breaks per read")
    if sizes:
        ax2.hist(sizes, bins=min(30, max(len(sizes), 2)))
    ax2.set_xlabel("gap size (events)")
    ax2.set_title("gap size distribution")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def verify_load_from_raw(fast5_path: str, model_path: str, sam_record,
                         out_path: Optional[str] = None):
    """Debug check that regenerating the event table from raw signal
    reproduces the embedded basecall segmentation (reference:
    visualization/verify_load_from_raw.py): aligns the two tables'
    mean traces and reports/plots the drift.

    Returns (n_embedded, n_regenerated, mean_abs_diff_of_head).
    """
    import numpy as np

    from signalalign_jax.io.read import NanoporeReadData
    from signalalign_jax.models.pore_model import PoreModel
    from signalalign_jax.pipeline.event_align import \
        nanopore_read_from_raw

    embedded = NanoporeReadData.from_fast5(fast5_path)
    model = PoreModel.from_file(model_path)
    regen = nanopore_read_from_raw(fast5_path, model, sam_record,
                                   embed=False)
    n_e = embedded.events.shape[0]
    n_r = regen.events.shape[0]
    n = min(n_e, n_r, 512)
    diff = float(np.mean(np.abs(embedded.events[:n, 0]
                                - regen.events[:n, 0])))
    if out_path:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(10, 3))
        ax.plot(embedded.events[:n, 0], label="embedded", lw=0.8)
        ax.plot(regen.events[:n, 0], label="regenerated", lw=0.8,
                alpha=0.7)
        ax.set_xlabel("event index")
        ax.set_ylabel("mean current")
        ax.legend()
        fig.tight_layout()
        fig.savefig(out_path, dpi=110)
        plt.close(fig)
    return n_e, n_r, diff


def deviation_call_data(vc_rows, guide_positions, label: str,
                        threshold: float = 0.5):
    """Join per-event variant-call rows with the guide alignment's
    per-event positions into (guide_delta, true_false) arrays.

    vc_rows: (event_index, variant_position, base, prob, ...) tuples
    (io.output.build_vc_rows / one read's .sm.vc.tsv); guide_positions:
    {event_index: genomic position} (pipeline.validate
    .guide_event_positions); ``label`` is the known-correct base for the
    sample, ``true_false`` is prob(label)/sum(probs) > threshold per
    (event, position) call — get_distance_from_guide_alignment +
    threshold semantics (reference: visualization/
    plot_accuracy_vs_alignment_deviation.py:118-133,
    alignedsignal.py:388).
    """
    by_call = {}
    for r in vc_rows:
        ev, pos, base, prob = int(r[0]), int(r[1]), str(r[2]), float(r[3])
        by_call.setdefault((ev, pos), {})[base] = prob
    deltas, correct = [], []
    for (ev, pos), probs in sorted(by_call.items()):
        gp = guide_positions.get(ev)
        if gp is None:
            continue
        tot = sum(probs.values())
        p_label = probs.get(label, 0.0) / tot if tot > 0 else 0.0
        deltas.append(abs(pos - gp))
        correct.append(p_label > threshold)
    return np.asarray(deltas, dtype=np.float64), \
        np.asarray(correct, dtype=bool)


def get_percent_accuracy_vs_deltas(all_data, n_bins: int = 20):
    """Per-delta-bin call accuracy (reference: plot_accuracy_vs_
    alignment_deviation.py get_percent_accuracy_vs_deltas:228-262
    semantics — n_bins edges spanning the FIRST experiment's delta
    range, per-bin (not cumulative) accuracy, with a final bucket for
    calls at/above the last edge).

    all_data: [(deltas, true_false), ...] per experiment. Returns
    (deltas (n_bins,), [percents (n_bins,)] per experiment) — percents
    has one entry per edge after the first, plus the overflow bucket.
    """
    d0 = np.asarray(all_data[0][0], dtype=np.float64)
    edges = np.linspace(d0.min(), d0.max(), n_bins)
    all_percents = []
    for deltas, tf in all_data:
        deltas = np.asarray(deltas, dtype=np.float64)
        tf = np.asarray(tf, dtype=np.float64)
        order = np.argsort(deltas, kind="stable")
        deltas, tf = deltas[order], tf[order]
        percents = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            m = (deltas >= lo) & (deltas < hi)
            percents.append(float(tf[m].mean()) if m.any() else 0.0)
        m = deltas >= edges[-1]
        percents.append(float(tf[m].mean()) if m.any() else 0.0)
        all_percents.append(np.asarray(percents))
    return edges, all_percents


def plot_accuracy_vs_alignment_deviation(all_data, labels, out_path: str,
                                         n_bins: int = 20):
    """Per-site call accuracy vs distance from the guide alignment
    (reference: visualization/plot_accuracy_vs_alignment_deviation.py
    plot_classification_accuracy_vs_deviation:208-226 +
    plot_alignment_deviation:135-152): left panel the deviation density
    histogram per experiment, right panel per-bin accuracy bars.

    all_data: [(guide_deltas, true_false), ...]; labels: experiment
    names. Returns out_path.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    edges, all_percents = get_percent_accuracy_vs_deltas(all_data, n_bins)
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4.2))
    ax1.hist([np.asarray(d) for d, _ in all_data],
             bins=max(n_bins // 2, 5), density=True, label=list(labels),
             alpha=0.7)
    ax1.set_xlabel("Delta from guide alignment (reference bases)")
    ax1.set_ylabel("Density")
    ax1.grid(color="black", linestyle="-", linewidth=0.3)
    ax1.legend(loc="upper right", fontsize=8)
    width = (edges[1] - edges[0]) if len(edges) > 1 else 1.0
    xs = np.concatenate([edges[1:], [edges[-1] + width]])
    for percents, lab in zip(all_percents, labels):
        ax2.bar(xs, height=percents, width=width, label=lab, alpha=0.6)
    ax2.set_xlabel("Delta from guide alignment (reference bases)")
    ax2.set_ylabel("Accuracy of calls")
    ax2.set_ylim(0, 1.05)
    ax2.legend(loc="lower right", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path

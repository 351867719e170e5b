"""Multi-read runner end-to-end on seeded synthetic reads, mirroring the
upstream full-CLI test (test_runSignalAlign.py): the batched runner must
reproduce the per-read path, including across chunk and device splits."""

import os
import subprocess
import sys

import numpy as np
import pytest

from signalalign_jax.io.guide import GuideAlignment
from signalalign_jax.io.read import NanoporeReadData
from signalalign_jax.io.reference import ProcessedReference
from signalalign_jax.models.pore_model import ScalingParams
from signalalign_jax.pipeline import runner as runner_mod
from signalalign_jax.pipeline.runner import run_alignment_batch
from signalalign_jax.pipeline.signal_align import AlignmentConfig, align_read
from signalalign_jax.utils.synthetic import build_synthetic_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup(acgt_model, tmp_path_factory):
    """Three flowcell-like reads (150-400 events, nanopore-like guide
    errors) over a seeded 5 kb genome."""
    fa = str(tmp_path_factory.mktemp("synth") / "genome.fa")
    rgs, reference, _, _, _ = build_synthetic_batch(
        acgt_model, n_reads=3, ev_min=150, ev_max=400, seed=3,
        genome_len=5000, fasta_path=fa)
    return reference, acgt_model, rgs


def _synthetic_rgs(model, genome, rng, n_reads, seq_len, step, label):
    k = model.kmer_length
    rgs = []
    for ri in range(n_reads):
        start = 40 + step * ri
        read_seq = genome[start:start + seq_len]
        ids = model.alphabet.seq_to_kmer_ids(read_seq)
        events, event_map = [], []
        for kid in ids:
            event_map.append(len(events))
            events.append([rng.normal(model.level_mean[kid],
                                      model.level_sd[kid]),
                           1.0, .002, len(events) * .002])
        event_map.extend([len(events) - 1] * (k - 1))
        read = NanoporeReadData(
            read_label=f"{label}{ri}", template_read=read_seq,
            events=np.array(events), event_map=np.array(event_map),
            model_states=None, p_model_state=None, kmer_length=k,
            params=ScalingParams(), rna=False)
        guide = GuideAlignment(
            contig="chr", forward=True, window_start=start,
            window_end=start + seq_len, query_start=0, query_end=seq_len,
            ops=[(seq_len, "M")])
        rgs.append((read, guide))
    return rgs


def _assert_same(a, b):
    assert a.read_label == b.read_label
    assert a.total_log_prob == pytest.approx(b.total_log_prob, rel=1e-9)
    assert a.aligned_pairs == b.aligned_pairs


def test_runner_xla_path(setup):
    reference, model, rgs = setup
    results = run_alignment_batch(rgs, reference, model, AlignmentConfig())
    assert len(results) == len(rgs)
    fwd = reference.forward["synth"]
    for (read, _), r in zip(rgs, results):
        assert 0 < len(r.aligned_pairs) <= 3 * read.n_events
        assert np.isfinite(r.total_log_prob)
        rows = r.full_rows(model)
        for row in rows[::37]:
            assert fwd[row.reference_index:row.reference_index + 5] \
                == row.reference_kmer


def test_runner_matches_align_read(setup):
    """Bucketed, batched, compacted device runs == the per-read path
    (align_read: one problem at a time, full band to the host)."""
    reference, model, rgs = setup
    batch = run_alignment_batch(rgs, reference, model, AlignmentConfig())
    for (read, guide), r in zip(rgs, batch):
        _assert_same(r, align_read(read, guide, reference, model,
                                   AlignmentConfig()))


def test_assignments_output_format(setup, tmp_path):
    """writeAssignments format through the runner (kmer strand descaled p)."""
    reference, model, rgs = setup
    from signalalign_jax.io.output import write_assignments_tsv
    res = run_alignment_batch(rgs[:1], reference, model,
                              AlignmentConfig())[0]
    out = tmp_path / "a.tsv"
    write_assignments_tsv(str(out), res.aligned_pairs, res.events, model,
                          res.params, res.strand_template, res.event_offset,
                          append=False)
    lines = open(out).read().strip().split("\n")
    assert len(lines) == len(res.aligned_pairs)
    k, s, d, p = lines[0].split("\t")
    assert s == "t" and len(k) == model.kmer_length
    assert 0.0 <= float(p) <= 1.0


def test_runner_stage_timing(setup, capfd, monkeypatch):
    """SIGNALALIGN_TIMING=1 prints a per-stage wall-time breakdown."""
    reference, model, rgs = setup
    monkeypatch.setenv("SIGNALALIGN_TIMING", "1")
    run_alignment_batch(rgs[:1], reference, model, AlignmentConfig())
    err = capfd.readouterr().err
    assert "[runner-timing]" in err
    for stage in ("prep=", "kernels+dispatch=", "fetch+decode=",
                  "assemble="):
        assert stage in err


def test_budget_chunking_splits_bucket(acgt_model, tmp_path, monkeypatch):
    """A device budget smaller than a bucket cuts it into chunks (here:
    below one problem, so one problem per chunk) spread over the (8
    virtual) devices with several in flight at once, and the results
    are identical to the single-chunk run."""
    rng = np.random.default_rng(4)
    genome = "".join(rng.choice(list("ACGT"), size=800))
    fasta = tmp_path / "ref.fa"
    fasta.write_text(">chr\n" + genome + "\n")
    reference = ProcessedReference(str(fasta))
    rgs = _synthetic_rgs(acgt_model, genome, rng, 12, 160, 30, "c")
    whole = run_alignment_batch(rgs, reference, acgt_model,
                                AlignmentConfig())

    monkeypatch.setattr(runner_mod, "device_budget_bytes", lambda dev: 1)
    trace = []
    runner_mod.set_dispatch_trace(trace)
    try:
        split = run_alignment_batch(rgs, reference, acgt_model,
                                    AlignmentConfig())
    finally:
        runner_mod.set_dispatch_trace(None)
    dispatches = [e for e in trace if e[0] == "dispatch"]
    assert len(dispatches) >= len(rgs)
    assert len({e[1] for e in dispatches}) == 8
    assert any(tot >= 2 for _, _, tot in dispatches)
    assert sum(1 for e in trace if e[0] == "drain") == len(dispatches)
    for a, b in zip(whole, split):
        _assert_same(a, b)


def test_runner_p2_matches_align_read(acgt_model, tmp_path):
    """P=2 ambiguity expansion THROUGH the runner (bucketing, chunking,
    compaction, path-k-mer decode) reproduces the per-read path on
    synthetic reads over a CpG-ambiguous reference."""
    rng = np.random.default_rng(9)
    core = "".join(rng.choice(list("ACGT"), size=598))
    genome = ("ACGT" * 40 + core + "ACGT" * 40).replace("CG", "CGCG")
    fasta = tmp_path / "ref.fa"
    fasta.write_text(">chr\n" + genome + "\n")
    # Y -> C/T ambiguity at every CG cytosine
    reference = ProcessedReference(str(fasta), motifs=[("CG", "YG")])
    rgs = _synthetic_rgs(acgt_model, genome, rng, 6, 220, 17, "p2r")
    cfg = AlignmentConfig(ambig_map={"Y": "CT"})
    batch = run_alignment_batch(rgs, reference, acgt_model, cfg)
    assert len(batch) == 6
    for (read, guide), r in zip(rgs, batch):
        assert r.aligned_pairs
        _assert_same(r, align_read(read, guide, reference, acgt_model, cfg))


def test_runner_path_split_matches_xla(acgt_model, tmp_path):
    """path_split=True (isolating sparse P=4 windows into their own
    segments, band_geometry.split_segment_by_paths) reproduces the
    unsplit results on a reference with sparse adjacent CpGs."""
    model = acgt_model
    rng = np.random.default_rng(13)
    core = list("".join(rng.choice(list("ACGT"), size=760))
                .replace("CG", "CA"))
    # sparse CpGs, one adjacent pair (P=4 window) mid-sequence
    for pos in (120, 260, 404, 600):
        core[pos:pos + 2] = "CG"
    core[404:408] = "CGCG"
    genome = "ACGT" * 20 + "".join(core) + "ACGT" * 20
    fasta = tmp_path / "ref.fa"
    fasta.write_text(">chr\n" + genome + "\n")
    reference = ProcessedReference(str(fasta), motifs=[("CG", "YG")])
    rgs = _synthetic_rgs(model, genome, rng, 4, 500, 29, "ps")

    cfg0 = AlignmentConfig(ambig_map={"Y": "CT"})
    cfg1 = AlignmentConfig(ambig_map={"Y": "CT"}, path_split=True)
    base = run_alignment_batch(rgs, reference, model, cfg0)
    split = run_alignment_batch(rgs, reference, model, cfg1)
    for b, s_ in zip(base, split):
        db = {(x, y, k_): p for p, x, y, k_ in b.aligned_pairs}
        ds = {(x, y, k_): p for p, x, y, k_ in s_.aligned_pairs}
        common = set(db) & set(ds)
        # splits pin the path at an anchor, which perturbs posteriors
        # NEAR each cut (the reference's own >3000x3000 splits do the
        # same): demand distribution-level equivalence — same pair set,
        # sub-quantization median, and a bounded perturbed tail
        assert len(common) > 0.95 * max(len(db), len(ds))
        diffs = np.array([abs(db[k_] - ds[k_]) for k_ in common])
        assert np.median(diffs) < 0.005 * 1e7
        assert (diffs > 0.05 * 1e7).mean() < 0.03


@pytest.mark.parametrize("env,want", [
    ({}, os.path.join(REPO, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}, None),
    ({"SIGNALALIGN_NO_COMPILE_CACHE": "1"}, None),
])
def test_compile_cache_dir_rule(env, want):
    """The package sets JAX's compile cache to a fixed git-ignored path in
    the checkout unless JAX_COMPILATION_CACHE_DIR is set (JAX reads that
    itself) or the opt-out is."""
    from signalalign_jax import compile_cache_dir
    assert compile_cache_dir(env) == want
    if want:
        with open(os.path.join(REPO, ".gitignore")) as fh:
            assert os.path.basename(want) in fh.read().split()


def test_runner_imports_without_optional_packages():
    """The run path (runner, training, site calling, seeded data) needs
    neither h5py, pandas nor matplotlib."""
    code = ("import sys\n"
            "for m in ('h5py', 'pandas', 'matplotlib'):\n"
            "    sys.modules[m] = None\n"
            "import signalalign_jax.pipeline.runner\n"
            "import signalalign_jax.pipeline.train\n"
            "import signalalign_jax.pipeline.variant_caller\n"
            "import signalalign_jax.utils.synthetic\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


class _FakeDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,want", [
    ({"bytes_limit": 60 << 30, "bytes_in_use": 0}, int(0.4 * (60 << 30))),
    (None, 2 << 30),
    ({}, 2 << 30),
])
def test_device_budget_from_memory_stats(stats, want):
    """The chunk budget is 40% of the allocator's limit (two chunks in
    flight per device); devices that report none get 2 GiB."""
    assert runner_mod.device_budget_bytes(_FakeDevice(stats)) == want
    from signalalign_jax.ops.batch import problem_device_bytes
    # f32 (Dpad+1, P, W) bands: two match-only stacks (three states each
    # for EM) + posterior + two bands of working room
    cells = 4 * 2049 * 2 * 256
    assert problem_device_bytes(2048, 256, 2, False) == cells * 5
    assert problem_device_bytes(2048, 256, 2, True) == cells * 9

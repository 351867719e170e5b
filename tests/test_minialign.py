"""Built-in guide aligner (bwa stand-in): native SW + reverse-strand frames."""

import numpy as np
import pytest

from signalalign_jax.io.minialign import _sw, generate_guide_alignment
from signalalign_jax.io.reference import ProcessedReference
from signalalign_jax.utils.alphabet import reverse_complement


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    rng = np.random.default_rng(7)
    seq = "".join(rng.choice(list("ACGT"), 800))
    path = tmp_path_factory.mktemp("ref") / "r.fa"
    with open(path, "w") as fh:
        fh.write(f">ctg\n{seq}\n")
    return ProcessedReference(str(path)), seq


def _mutate(rng, s, sub=0.05, indel=0.01):
    out = []
    for ch in s:
        r = rng.random()
        if r < indel / 2:
            continue                       # deletion
        if r < indel:
            out.append(rng.choice(list("ACGT")))  # insertion
        if rng.random() < sub:
            out.append(rng.choice([c for c in "ACGT" if c != ch]))
        else:
            out.append(ch)
    return "".join(out)


def test_exact_hit():
    rng = np.random.default_rng(3)
    ref = "".join(rng.choice(list("ACGT"), 200))
    score, qs, qe, rs, re_, cigar = _sw(ref[30:90], ref)
    assert (qs, qe, rs, re_) == (0, 60, 30, 90)
    assert cigar == [(60, "M")]


def test_forward_hit_with_errors(ref):
    reference, seq = ref
    rng = np.random.default_rng(1)
    read = _mutate(rng, seq[100:600])
    g = generate_guide_alignment(read, reference)
    assert g is not None and g.forward
    assert abs(g.window_start - 100) < 10
    assert abs(g.window_end - 600) < 10
    assert g.validate(len(read))


def test_reverse_hit(ref):
    reference, seq = ref
    rng = np.random.default_rng(2)
    read = _mutate(rng, reverse_complement(seq[150:650]))
    g = generate_guide_alignment(read, reference)
    assert g is not None and not g.forward
    assert abs(g.window_start - 150) < 10
    assert abs(g.window_end - 650) < 10
    assert g.validate(len(read))
    # anchors must land inside the window in target orientation
    anchors = g.anchor_pairs(5)
    assert anchors
    for x, q in anchors:
        assert 0 <= x < g.window_length
        assert g.query_start <= q < g.query_end


def test_no_hit(ref):
    reference, _ = ref
    g = generate_guide_alignment("T" * 15, reference, min_score=50.0)
    assert g is None


def test_seeded_genome_scale_reverse_strand():
    """Reverse-strand genome-scale map: the revcomp of a bundled 1D
    read against the full E. coli reconstruction must come back as a
    reverse-strand guide over the same window, with valid anchors."""
    import bench
    from signalalign_jax.io.sam import read_bam
    from signalalign_jax.utils import native

    if not native.available():
        pytest.skip("native library unavailable")
    reference = ProcessedReference(bench._ecoli_fasta())
    _, records = read_bam(
        "/root/reference/tests/minion_test_reads/1D/1D.bam")
    rec = next(iter(records))
    read_rc = reverse_complement(rec.seq)
    g = generate_guide_alignment(read_rc, reference)
    assert g is not None and not g.forward
    span = rec.reference_span()
    assert abs(g.window_start - rec.pos) < 50
    assert abs(g.window_end - (rec.pos + span)) < 50
    assert g.validate(len(read_rc))
    assert g.mapq > 10     # unique locus: confident map
    anchors = g.anchor_pairs(5)
    assert anchors
    for x, q in anchors:
        assert 0 <= x < g.window_length
        assert g.query_start <= q < g.query_end


def test_seeded_min_ref_boundary(tmp_path):
    """References straddling SEEDED_MIN_REF route to different engines
    (full DP below, minimizer-seeded above); both must recover the same
    window for the same read."""
    from signalalign_jax.io.minialign import SEEDED_MIN_REF
    from signalalign_jax.utils import native

    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(11)
    core = "".join(rng.choice(list("ACGT"), SEEDED_MIN_REF + 500))
    read = _mutate(rng, core[40_000:40_700])
    for size, want_seeded in ((SEEDED_MIN_REF - 100, False),
                              (SEEDED_MIN_REF + 500, True)):
        path = tmp_path / f"r{size}.fa"
        with open(path, "w") as fh:
            fh.write(">ctg\n")
            for i in range(0, size, 10000):
                fh.write(core[i:i + 10000] + "\n")
        reference = ProcessedReference(str(path))
        g = generate_guide_alignment(read, reference)
        assert g is not None and g.forward, size
        assert abs(g.window_start - 40_000) < 30, (size, g.window_start)
        assert abs(g.window_end - 40_700) < 30, (size, g.window_end)
        assert g.validate(len(read))
        assert g.mapq > 10


def test_seeded_repeat_ambiguity():
    """A read from a repeat present at TWO genome loci must map with
    MAPQ ~ 0 (two near-equal chains — bwa's repeat signal,
    utils/bwaWrapper.py maps inherit it from bwa mem), while a
    unique-region read from the same genome keeps high confidence."""
    from signalalign_jax.io.minialign import SEEDED_MIN_REF
    from signalalign_jax.utils import native

    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(13)
    n = SEEDED_MIN_REF + 60_000
    genome = list(rng.choice(list("ACGT"), n))
    repeat = "".join(rng.choice(list("ACGT"), 3000))
    genome[10_000:13_000] = repeat
    genome[90_000:93_000] = repeat          # exact second copy
    genome = "".join(genome)
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/rep.fa"
        with open(path, "w") as fh:
            fh.write(">ctg\n")
            for i in range(0, n, 10000):
                fh.write(genome[i:i + 10000] + "\n")
        reference = ProcessedReference(path)
        amb = generate_guide_alignment(
            _mutate(rng, genome[10_200:12_800]), reference)
        assert amb is not None
        assert amb.mapq <= 5, amb.mapq      # repeat: ambiguous
        uniq = generate_guide_alignment(
            _mutate(rng, genome[40_000:42_600]), reference)
        assert uniq is not None and uniq.mapq > 10


def test_seeded_genome_scale():
    """Seeded path (minimizer index + chain + banded extension): map a
    bundled 1D read against the full 4.6Mb reconstructed E. coli
    reference WITHOUT its BAM record and recover the BAM's window.
    reference: utils/bwaWrapper.py (indexed bwa mem guide generation)."""
    import time

    import bench
    from signalalign_jax.io.sam import read_bam
    from signalalign_jax.utils import native

    if not native.available():
        pytest.skip("native library unavailable")
    reference = ProcessedReference(bench._ecoli_fasta())
    _, records = read_bam(
        "/root/reference/tests/minion_test_reads/1D/1D.bam")
    rec = next(iter(records))
    t0 = time.time()
    g = generate_guide_alignment(rec.seq, reference)
    dt = time.time() - t0
    assert g is not None and g.forward
    span = rec.reference_span()
    assert abs(g.window_start - rec.pos) < 50
    assert abs(g.window_end - (rec.pos + span)) < 50
    assert g.validate(len(rec.seq))
    # the point of seeding: well under the multi-minute full-DP cost
    assert dt < 10.0

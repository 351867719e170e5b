import os

# Unit tests run on a virtual 8-device CPU mesh so sharding and
# multi-device dispatch logic is exercised without GPUs. Must be set
# before jax is imported. SIGNALALIGN_TEST_GPU=1 keeps the machine's own
# platform, for the tests marked ``gpu`` (README: running the tests).
if not os.environ.get("SIGNALALIGN_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# signalalign_jax/__init__ turns on the persistent compilation cache.
# Serializing CPU executables through it segfaulted on an earlier jaxlib
# (put_executable_and_time -> executable.serialize() SIGSEGV killing the
# whole pytest run), and CPU compiles are cheap — keep it off for tests.
os.environ["SIGNALALIGN_NO_COMPILE_CACHE"] = "1"
jax.config.update("jax_enable_compilation_cache", False)
import pytest  # noqa: E402

REFERENCE_DIR = "/root/reference"


@pytest.fixture(scope="session")
def reference_dir():
    if not os.path.isdir(REFERENCE_DIR):
        pytest.skip("reference checkout not available")
    return REFERENCE_DIR


@pytest.fixture(scope="session")
def ecoli_fasta(tmp_path_factory):
    """Reconstruct the E. coli reference windows covered by the bundled 1D
    test BAM (the genome fasta itself is not shipped in the reference
    snapshot; MD tags let us rebuild the exact aligned windows)."""
    from signalalign_jax.io.sam import read_bam, reconstruct_reference_window

    bam = os.path.join(REFERENCE_DIR, "tests/minion_test_reads/1D/1D.bam")
    refs, records = read_bam(bam)
    genome = np.full(4641652, ord("A"), dtype=np.uint8)
    for rec in records:
        window = reconstruct_reference_window(rec)
        assert window is not None
        genome[rec.pos:rec.pos + len(window)] = np.frombuffer(
            window.encode("latin-1"), dtype=np.uint8)
    path = tmp_path_factory.mktemp("ref") / "ecoli_reconstructed.fa"
    with open(path, "w") as fh:
        fh.write(">gi_ecoli\n")
        s = genome.tobytes().decode("latin-1")
        for i in range(0, len(s), 10000):
            fh.write(s[i:i + 10000] + "\n")
    return str(path)


import numpy as np  # noqa: E402


# ---------------------------------------------------------------------------
# Seeded models (no data files: utils/synthetic.py makes them from a seed)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="session")
def acgt_model():
    """ACGT 5-mer pore model with r9.4-like level statistics."""
    from signalalign_jax.utils.synthetic import seeded_pore_model
    return seeded_pore_model("ACGT", 5, seed=11)


@pytest.fixture(scope="session")
def acegt_model():
    """ACEGT 5-mer model (E = 5mC near its C twin) for P>1 and HDP tests."""
    from signalalign_jax.utils.synthetic import seeded_pore_model
    return seeded_pore_model("ACEGT", 5, seed=12)


@pytest.fixture(scope="session")
def acegt_hdp(acegt_model):
    """HDP emission tables built from the ACEGT model's Gaussians."""
    from signalalign_jax.utils.synthetic import seeded_hdp
    return seeded_hdp(acegt_model, grid_length=400)


@pytest.fixture
def gpu_device():
    """The first GPU; skips (decided at run time) when there is none."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip("needs a GPU: run with SIGNALALIGN_TEST_GPU=1 -m gpu "
                    "on a machine that has one")
    return devs[0]


# ---------------------------------------------------------------------------
# Suite hygiene + tiers
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop jax's in-process caches after every test module.

    A full single-process `pytest tests/` run reproducibly stalled in a
    late XLA CPU compile (test_twod via banded_fb.run_banded_fb) after
    ~137 tests: state accumulated across ~hundreds of compiles (live
    executables + tracing caches + RSS) made one late compile blow up.
    Clearing between modules keeps the process near a fresh-start
    profile; per-module recompiles are cheap on CPU.
    """
    yield
    jax.clear_caches()


# Fast tier: `pytest -m fast` runs the quick pure-host/unit modules
# (< ~3 min total); `-m "not slow"` is the default CI tier; no marker
# runs everything. Module-level marking keeps the tier list in one
# place.
_FAST_MODULES = {
    "test_compare", "test_expectations", "test_io", "test_mixture",
    "test_multiple_aligner", "test_pore_model", "test_visualization",
    "test_mea_variants", "test_event_align", "test_embed",
    "test_minialign", "test_scan",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in _FAST_MODULES and "slow" not in item.keywords:
            item.add_marker(pytest.mark.fast)

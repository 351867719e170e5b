"""Event detection + adaptive banded alignment (load_from_raw path)."""

import glob
import os

import numpy as np
import pytest

from signalalign_jax.io.fast5 import Fast5
from signalalign_jax.models.pore_model import PoreModel, ScalingParams
from signalalign_jax.ops.event_detect import (_peak_detector_py,
                                              compute_tstat, detect_events,
                                              trim_and_segment_raw)
from signalalign_jax.pipeline import event_align as ea
from signalalign_jax.utils import native

ONED = "/root/reference/tests/minion_test_reads/1D"
MODEL = "/root/reference/models/testModelR9p4_5mer_acegt_template.model"


@pytest.fixture(scope="module")
def fast5_path():
    return sorted(glob.glob(os.path.join(ONED, "*.fast5")))[0]


@pytest.fixture(scope="module")
def model():
    return PoreModel.from_file(MODEL)


def test_native_builds():
    assert native.available(), "C++ native library failed to build"


def test_tstat_properties():
    rng = np.random.default_rng(0)
    # step signal: flat then jump
    sig = np.concatenate([rng.normal(80, 1, 50), rng.normal(120, 1, 50)]).astype(np.float32)
    t = compute_tstat(sig, 5)
    assert t.argmax() in range(45, 56)  # peak at the boundary
    assert t[:4].max() == 0.0


def test_peak_detector_native_matches_python():
    rng = np.random.default_rng(1)
    sig = np.concatenate([rng.normal(80 + 10 * (i % 7), 1, rng.integers(5, 30))
                          for i in range(100)]).astype(np.float32)
    t1 = compute_tstat(sig, 3)
    t2 = compute_tstat(sig, 6)
    py = _peak_detector_py(t1, t2, 3, 6, 1.4, 9.0, 0.2)
    nat = native.peak_detector(t1, t2, 3, 6, 1.4, 9.0, 0.2)
    np.testing.assert_array_equal(py, nat)
    assert len(py) > 50


def test_detect_events_on_real_raw(fast5_path):
    with Fast5(fast5_path) as f5:
        raw = f5.raw_signal_pA()
    trimmed, off = trim_and_segment_raw(raw, 200, 10, 100, 0.0)
    assert off >= 200
    et = detect_events(trimmed, rna=False, start_sample=off)
    assert len(et) > 1000
    # events tile the signal
    assert (et[:, 2] > 0).all()
    assert abs((et[-1, 3] + et[-1, 2]) - (off + len(trimmed))) < 2
    # means in pA range
    assert 40 < np.median(et[:, 0]) < 160


def test_adaptive_align_native_matches_python(model):
    rng = np.random.default_rng(2)
    n_kmers = 150
    seq = "".join(rng.choice(list("ACGT"), size=n_kmers + model.kmer_length - 1))
    ids = model.alphabet.seq_to_kmer_ids(seq)
    # synthesize events following the kmer sequence
    ev = []
    for i in ids:
        ev.append(rng.normal(model.level_mean[i], model.level_sd[i]))
        if rng.random() < 0.3:
            ev.append(rng.normal(model.level_mean[i], model.level_sd[i]))
    ev = np.array(ev)
    params = ScalingParams()
    m_hat, inv, cst = ea._emission_params(ids, model, params)
    pk_py, pe_py, qc_py = ea._adaptive_align_py(ev, m_hat, inv, cst)
    pk_nat, pe_nat, qc_nat = native.adaptive_banded_align(ev, m_hat, inv, cst)
    np.testing.assert_array_equal(pk_py, pk_nat)
    np.testing.assert_array_equal(pe_py, pe_nat)
    np.testing.assert_allclose(qc_py, qc_nat, rtol=1e-9)
    ok, _ = ea.qc_passes(qc_nat)
    assert ok
    # alignment covers all kmers monotonically
    assert pk_nat[0] == 0 and pk_nat[-1] == n_kmers - 1
    assert (np.diff(pk_nat) >= 0).all() and (np.diff(pe_nat) >= 0).all()


def test_align_raw_real_read(fast5_path, model):
    with Fast5(fast5_path) as f5:
        fastq = f5.template_fastq()
    read_seq = fastq.split("\n")[1]
    res = ea.align_raw_read(fast5_path, model, read_seq, rna=False)
    assert res.qc_ok, res.qc_msg
    n_mapped = (res.model_states != b"").sum()
    assert n_mapped > 0.5 * len(res.events)
    assert res.moves.max() >= 1
    # event map reconstruction works downstream
    from signalalign_jax.io.read import make_event_map
    em = make_event_map(res.moves, res.p_model_state,
                        len(read_seq), model.kmer_length)
    assert len(em) == len(read_seq)
    assert (np.diff(em) >= 0).all()

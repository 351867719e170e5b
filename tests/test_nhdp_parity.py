"""Field-for-field .nhdp serializer parity with the reference format.

The strict parser below is written directly against the reference's
serializers — serialize_nhdp (/root/reference/impl/nanopore_hdp.c:
1077-1088) and serialize_hdp (+ serialize_factor_tree_internal,
/root/reference/impl/hdp.c:2868-3049) — NOT against this repo's lenient
reader, so it validates the byte-level contract both ways:

  * parsing the reference's own shipped fixture proves the parser
    matches what reference tooling produces;
  * parsing a repo-TRAINED .nhdp through the same parser proves
    reference tooling (deserialize_nhdp) can consume trained models,
    including the factor-tree tail encoding the final Gibbs seating.
"""

import math

import numpy as np
import pytest

REF_FIXTURE = "/root/reference/models/templateSingleLevelFixed.nhdp"


class StrictNhdp:
    """deserialize_nhdp + deserialize_hdp, field for field."""

    def __init__(self, path):
        with open(path) as fh:
            self.lines = fh.read().split("\n")
        self.pos = 0
        self._parse()

    def _line(self):
        ln = self.lines[self.pos]
        self.pos += 1
        return ln

    def _parse(self):
        self.alphabet_size = int(self._line())
        self.alphabet = self._line().strip()
        assert len(self.alphabet) == self.alphabet_size
        self.kmer_length = int(self._line())
        # serialize_hdp body
        self.splines_finalized = int(self._line())
        self.has_data = int(self._line())
        self.sample_gamma = int(self._line())
        self.num_dps = int(self._line())
        if self.has_data:
            self.data = np.array([float(v) for v in self._line().split("\t")])
            self.dp_ids = np.array([int(v) for v in self._line().split("\t")])
            assert len(self.data) == len(self.dp_ids)
        self.mu, self.nu, self.alpha, self.beta = (
            float(v) for v in self._line().split("\t"))
        gs, ge, gl = self._line().split("\t")
        self.grid_start, self.grid_stop = float(gs), float(ge)
        self.grid_length = int(gl)
        self.gamma = np.array([float(v) for v in self._line().split("\t")])
        self.depth = len(self.gamma)
        if self.sample_gamma:
            self.gamma_alpha = np.array(
                [float(v) for v in self._line().split("\t")])
            self.gamma_beta = np.array(
                [float(v) for v in self._line().split("\t")])
            assert len(self.gamma_alpha) == self.depth
            assert len(self.gamma_beta) == self.depth
            self.w_aux = np.array(
                [float(v) for v in self._line().split("\t")])
            self.s_aux = np.array(
                [int(v) for v in self._line().split("\t")])
            assert len(self.w_aux) == self.num_dps
            assert len(self.s_aux) == self.num_dps
        # dp parent / num_factor_children lines
        self.parent = np.full(self.num_dps, -1, dtype=np.int64)
        self.nfc = np.zeros(self.num_dps, dtype=np.int64)
        for i in range(self.num_dps):
            a, b = self._line().split("\t")
            self.parent[i] = -1 if a == "-" else int(a)
            self.nfc[i] = int(b)
        # posterior predictive grids (empty line = dp without data)
        self.post_pred = {}
        if self.has_data:
            for i in range(self.num_dps):
                ln = self._line()
                if ln:
                    row = np.array([float(v) for v in ln.split("\t")])
                    assert len(row) == self.grid_length
                    self.post_pred[i] = row
        self.slopes = {}
        if self.splines_finalized:
            for i in range(self.num_dps):
                ln = self._line()
                if ln:
                    row = np.array([float(v) for v in ln.split("\t")])
                    assert len(row) == self.grid_length
                    self.slopes[i] = row
            assert set(self.slopes) == set(self.post_pred)
        # factor tree tail (present when the serializer had data + state)
        self.factors = []        # (type, parent_id, payload-str)
        if self.has_data:
            while self.pos < len(self.lines):
                ln = self._line()
                if not ln:
                    continue
                typ, par, payload = ln.split("\t")
                self.factors.append(
                    (int(typ), -1 if par == "-" else int(par), payload))

    def check_factor_tree(self):
        """Structural invariants of the reference factor encoding."""
        assert self.factors, "no factor tree tail"
        n_data_factors = 0
        ids_of_type = {}
        for fid, (typ, par, payload) in enumerate(self.factors):
            ids_of_type[fid] = typ
            if typ == 0:                      # BASE: cached NIG params
                assert par == -1
                params = [float(v) for v in payload.split(";")]
                assert len(params) == 5       # N_IG_NUM_PARAMS + 1
                mu_p, nu_p, two_a, beta_p, lp = params
                assert nu_p >= self.nu and beta_p > 0
                expect_lp = (math.lgamma(0.5 * two_a)
                             - 0.5 * (math.log(nu_p)
                                      + two_a * math.log(beta_p)))
                assert abs(lp - expect_lp) < 1e-9 * max(1.0, abs(expect_lp))
            elif typ == 1:                    # MIDDLE: dp id
                assert 0 <= par < fid and ids_of_type[par] in (0, 1)
                assert 0 <= int(payload) < self.num_dps
            else:                             # DATA: data index
                assert typ == 2
                assert 0 <= par < fid and ids_of_type[par] in (0, 1)
                n_data_factors += 1
                assert 0 <= int(payload) < len(self.data)
        assert n_data_factors == len(self.data)


def test_strict_parser_reads_reference_fixture():
    """The parser accepts the reference's own serialized model — the
    format spec transcription is correct."""
    f = StrictNhdp(REF_FIXTURE)
    assert f.alphabet == "ACEGOT" and f.kmer_length == 6
    assert f.num_dps == 6 ** 6 + 1
    assert f.grid_length >= 100 and f.grid_stop > f.grid_start
    # single-level fixed: every kmer dp hangs off the base dp
    base = np.flatnonzero(f.parent < 0)
    assert len(base) == 1
    assert (f.parent[f.parent >= 0] == base[0]).all()
    assert f.post_pred and f.slopes


def _train_tiny(tmp_path):
    from signalalign_jax.hdp.train import train_hdp_from_alignment
    from signalalign_jax.models.pore_model import PoreModel
    from signalalign_jax.utils import native

    if not native.available():
        pytest.skip("native library unavailable")
    model = PoreModel.from_file(
        "/root/reference/models/testModelR9p4_5mer_acgt_RNA.model")
    rng = np.random.default_rng(5)
    path = tmp_path / "assignments.tsv"
    kmers = ["AACGT", "CCGTA", "GGTAC", "ACGTA"]
    with open(path, "w") as fh:
        for i in range(240):
            k = kmers[i % len(kmers)]
            v = 80.0 + 10.0 * (i % len(kmers)) + rng.normal(0, 1.0)
            fh.write(f"{k}\tt\t{v:.5f}\n")
    out = tmp_path / "trained.nhdp"
    return train_hdp_from_alignment(
        str(path), model, hdp_type="singleLevelFixed", out_path=str(out),
        grid_start=60.0, grid_stop=120.0, grid_length=300,
        gibbs_samples=30, burn_in=4, thinning=5, seed=3)


def test_trained_nhdp_matches_reference_contract(tmp_path):
    """A repo-trained .nhdp round-trips through the reference-spec
    parser: header, every serialize_hdp section, and a well-formed
    factor tree encoding the final Gibbs seating."""
    out = _train_tiny(tmp_path)
    f = StrictNhdp(out)
    assert f.splines_finalized == 1 and f.has_data == 1
    assert f.kmer_length == 5 and f.alphabet == "ACEGOT"
    assert f.num_dps == 6 ** 5 + 1
    assert len(f.data) == 240
    assert (f.dp_ids < f.num_dps).all()
    base = np.flatnonzero(f.parent < 0)
    assert len(base) == 1
    f.check_factor_tree()
    # num_factor_children bookkeeping (hdp.c:1368): total customers of
    # each dp's factors; the base dp's children are the middle factors
    mid = sum(1 for t, _, _ in f.factors if t == 1)
    assert f.nfc[base[0]] == mid
    assert f.nfc.sum() == mid + len(f.data)

    # densities written = densities this repo's own reader loads, and
    # the observed leaf dps carry proper (positive, normalized-ish) mass
    from signalalign_jax.models.hdp_model import load_nhdp
    nhdp = load_nhdp(out)
    grid = np.linspace(f.grid_start, f.grid_stop, f.grid_length)
    dx = grid[1] - grid[0]
    for i, row in f.post_pred.items():
        assert np.isfinite(row).all() and (row >= 0).all()
        if i != base[0]:
            assert abs(row.sum() * dx - 1.0) < 0.15
    # spline slopes section consistent with the density rows (natural
    # cubic spline of the grid; reference spline_knot_slopes)
    from signalalign_jax.hdp.train import spline_slopes
    for i, row in f.slopes.items():
        expect = spline_slopes(grid, f.post_pred[i][None])[0]
        np.testing.assert_allclose(row, expect, rtol=1e-8, atol=1e-10)
    assert len(nhdp.grid) == f.grid_length

"""Trace reduction (utils/trace.py) on a small trace recorded here."""

import jax
import jax.numpy as jnp
import pytest

from signalalign_jax.utils.trace import (interval_stats, merge_intervals,
                                         module_runs, reduce_trace)


def test_interval_stats_union_and_gaps():
    ivs = [(0, 10), (5, 20), (30, 40), (45, 50)]
    assert merge_intervals(ivs) == [(0, 20), (30, 40), (45, 50)]
    st = interval_stats(ivs)
    assert st["kernels"] == 4 and st["gaps"] == 2
    assert st["window_s"] == pytest.approx(50e-9)
    assert st["busy_s"] == pytest.approx(35e-9)
    assert st["idle_share"] == pytest.approx(15 / 50)
    assert st["median_gap_us"] == pytest.approx(7.5e-3)
    assert interval_stats([])["idle_share"] == 1.0


def test_reduce_recorded_trace(tmp_path):
    """A jitted function traced on the CPU: its module shows up with
    kernel time, one run per call, and the window covers them."""
    @jax.jit
    def smoke_step(x):
        return jnp.cumsum(jnp.sin(x) * 2.0)

    x = jnp.ones(4096)
    smoke_step(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        for i in range(3):
            smoke_step(x * i).block_until_ready()
    out = reduce_trace(str(tmp_path), plane_name="/host:CPU")
    assert out["kernels"] > 0 and 0.0 <= out["idle_share"] < 1.0
    assert any(m.startswith("jit_smoke_step")
               for m in out["kernel_s_by_module"])
    runs = module_runs(str(tmp_path), "jit_smoke_step",
                       plane_name="/host:CPU")
    assert len(runs) == 3
    assert runs[0]["window_s"] >= runs[-1]["window_s"] > 0
    with pytest.raises(ValueError):
        reduce_trace(str(tmp_path))          # no GPU plane in a CPU trace

"""The port's offline tuner (``repro_torch.core.tuner``, paper §3.5 and App. A)
against the JAX package's, on the same inputs.

The tuner is numpy on both sides over copies of the same hardware and
disk models, so the solved tuples are held equal field for field (the
modeled times included) and the delay and memory models to 1e-12
relative.  The dims are each ported arch's, built as the reference's
``examples/offline_tuning.py`` builds them (``d_ff = cfg.d_ff or
4·d_model``).
"""

import dataclasses

import numpy as np
import pytest

from repro.configs import registry as jreg
from repro.core import hardware as jhw, tuner as jtuner
from repro_torch.configs import registry
from repro_torch.core import hardware, tuner
from repro_torch.main_path import model_dims, tuned_engine_config

PORTED = list(registry.ALL_ARCHS)
DISKS = ("nvme", "ufs", "emmc")
BUDGETS_MIB = (8, 40, 96, 310, 1024)
RTOL = 1e-12


def dims_pair(arch):
    cfg = jreg.get(arch)
    kw = dict(d_model=cfg.d_model, n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim, d_ff=cfg.d_ff or 4 * cfg.d_model)
    return cfg, jhw.ModelDims(**kw), hardware.ModelDims(**kw)


def inputs(arch, budget_mib, **kw):
    cfg, jd, td = dims_pair(arch)
    common = dict(n_layers=cfg.n_layers, b_max=4, s_max=8192,
                  budget_bytes=int(budget_mib * (1 << 20)), **kw)
    return jtuner.TunerInputs(dims=jd, **common), tuner.TunerInputs(dims=td, **common)


def solved(mod, inp, **kw):
    try:
        return dataclasses.asdict(mod.solve(inp, **kw))
    except ValueError as exc:
        return ("infeasible", str(exc))


@pytest.mark.parametrize("warm", [0, 64 << 20], ids=["no-warm", "warm-64MiB"])
@pytest.mark.parametrize("disk", DISKS)
def test_solve_matches_reference(disk, warm):
    n = 0
    for arch in PORTED:
        for mib in BUDGETS_MIB:
            ji, ti = inputs(arch, mib, disk=disk, warm_budget_bytes=warm)
            want = solved(jtuner, ji)
            assert solved(tuner, ti) == want, (arch, mib)
            n += isinstance(want, dict)
    assert n > len(PORTED)        # most points are feasible


@pytest.mark.parametrize("disk", DISKS)
def test_solve_grid_matches_reference(disk):
    table = jtuner.build_reuse_table(n_steps=60)
    for arch in ("llama3-8b", "olmoe-1b-7b", "stablelm-12b"):
        ji, ti = inputs(arch, 96, disk=disk)
        want = jtuner.solve_grid(ji, reuse_table=table, b_step=2, s_step=2048, s_min=4096)
        got = tuner.solve_grid(ti, reuse_table=table, b_step=2, s_step=2048, s_min=4096)
        assert got == want and len(got) == 6


@pytest.mark.parametrize("disk", DISKS)
def test_delay_and_memory_models_match_reference(disk):
    table = jtuner.default_reuse_table()
    for arch in ("llama3-8b", "olmoe-1b-7b", "qwen3-32b", "zamba2-1.2b"):
        for warm in (0, 32 << 20):
            ji, ti = inputs(arch, 96, disk=disk, warm_budget_bytes=warm)
            for g, m, c, b, s, sigma in [(1, 400, 0, 1, 4096, 8.0), (4, 100, 32, 4, 8192, 16.0),
                                         (16, 25, 96, 2, 2048, 4.0), (8, 50, 1000, 8, 512, 1.0)]:
                assert (tuner.memory_bytes(ti, sigma=sigma, g=g, m=m, c=c, b=b, s=s)
                        == jtuner.memory_bytes(ji, sigma=sigma, g=g, m=m, c=c, b=b, s=s))
                np.testing.assert_allclose(
                    tuner.t_io(ti, g=g, m=m, c=c, b=b, reuse_table=table),
                    jtuner.t_io(ji, g=g, m=m, c=c, b=b, reuse_table=table), rtol=RTOL)
                np.testing.assert_allclose(
                    tuner.t_model(ti, g=g, m=m, b=b, s=s, sigma=sigma),
                    jtuner.t_model(ji, g=g, m=m, b=b, s=s, sigma=sigma), rtol=RTOL)
                assert (tuner.warm_hit_fraction(ti, g=g, m=m, b=b, misses_per_layer=m * 0.3)
                        == jtuner.warm_hit_fraction(ji, g=g, m=m, b=b,
                                                    misses_per_layer=m * 0.3))


@pytest.mark.parametrize("seed", [0, 7])
def test_build_reuse_table_matches_reference(seed):
    got = tuner.build_reuse_table(step_overlap=0.7, working_set=256, n_steps=80, seed=seed)
    want = jtuner.build_reuse_table(step_overlap=0.7, working_set=256, n_steps=80, seed=seed)
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in got], [want[k] for k in got], rtol=RTOL)


def test_reuse_lookup_and_json_match_reference():
    table = tuner.default_reuse_table()
    assert table == jtuner.default_reuse_table()
    for c in (-5, 0, 7, 16, 100, 300, 1024, 5000):
        assert tuner.lookup_reuse(table, c) == jtuner.lookup_reuse(table, c)
    ji, ti = inputs("llama3-8b", 310)
    assert tuner.solve(ti).to_json() == jtuner.solve(ji).to_json()


def test_tuned_engine_config_for_olmoe():
    """The OLMoE path's tuner call (``chip_smoke.py``): the reference's
    tuple, a rank kernel A takes, and every field carried into the
    ``EngineConfig``."""
    cfg = registry.get("olmoe-1b-7b")
    assert dataclasses.asdict(model_dims(cfg)) == dataclasses.asdict(dims_pair("olmoe-1b-7b")[1])
    tuned, ecfg = tuned_engine_config(cfg, b_max=4, s_max=4096, budget_bytes=256 << 20,
                                      disk="nvme", device_resident=True)
    want = jtuner.solve(jtuner.TunerInputs(dims=dims_pair("olmoe-1b-7b")[1], n_layers=16,
                                           b_max=4, s_max=4096, budget_bytes=256 << 20))
    assert dataclasses.asdict(tuned) == dataclasses.asdict(want)
    assert (tuned.group_size, tuned.n_select, tuned.rank, tuned.reuse_capacity) == (16, 25, 256, 96)
    assert (ecfg.group_size, ecfg.n_select, ecfg.rank, ecfg.reuse_capacity, ecfg.max_seq) == \
        (16, 25, 256, 96, 4096)
    assert ecfg.device_resident and ecfg.disk == "nvme"
    # a budget whose tuple has C = 0 is raised to 16 for the engine, as the
    # reference's quickstart raises it
    tuned, ecfg = tuned_engine_config(cfg, b_max=4, s_max=4096, budget_bytes=40 << 20)
    assert tuned.reuse_capacity == 0 and ecfg.reuse_capacity == 16


def test_infeasible_budget_raises_like_reference():
    ji, ti = inputs("chameleon-34b", 0.001, disk="emmc")
    with pytest.raises(ValueError, match="infeasible") as got:
        tuner.solve(ti)
    with pytest.raises(ValueError) as want:
        jtuner.solve(ji)
    assert str(got.value) == str(want.value)

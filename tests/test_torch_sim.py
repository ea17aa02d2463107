"""The port's cost model (``repro_torch.core.sim``) against the JAX
package's ``repro.core.sim``: the same public functions, equal results on
a grid of inputs, with ``link_bw`` and ``t_sync`` passed explicitly (the
port's ``stage_hardware_from_roofline`` has no defaults for them)."""
import dataclasses
import inspect
import itertools

import pytest

from repro.core import sim as jsim
from repro_torch.core import sim

HW_GRID = [dict(n_stages=n, t_stage_one=one, t_stage_width=width,
                t_comm=comm, t_draft=draft, t_sync=sync)
           for n, one, width, comm, draft, sync in itertools.product(
               (1, 4, 8), (1e-3,), (1.2e-3, 5e-3), (0.0, 2e-4),
               (0.0, 3e-3, 9e-2), (0.0, 1e-4))]
BATCHES = (1, 3, 8, 16)
SCALES = (None, lambda b: 1.0 + 0.1 * b)


def _public(mod):
    return {name for name, obj in vars(mod).items()
            if not name.startswith("_") and getattr(obj, "__module__", None)
            == mod.__name__}


def _hws(kw):
    return sim.StageHardware(**kw), jsim.StageHardware(**kw)


def test_same_public_functions():
    assert _public(sim) == _public(jsim)
    for name in _public(sim) - {"stage_hardware_from_roofline"}:
        assert (inspect.signature(getattr(sim, name)).parameters.keys()
                == inspect.signature(getattr(jsim, name)).parameters.keys())


@pytest.mark.parametrize("kw", HW_GRID[::3])
def test_latency_functions_equal(kw):
    hw, jhw = _hws(kw)
    assert sim.pp_latency_per_token(hw) == jsim.pp_latency_per_token(jhw)
    for tpt in (0.0, 0.3, 0.93, 1.0):
        assert sim.pipedec_latency_per_token(hw, tpt) == \
            jsim.pipedec_latency_per_token(jhw, tpt)
    for depth, acc in itertools.product((1, 3, 4), (0.0, 1.857, 3.0)):
        assert sim.stpp_latency_per_token(hw, depth, acc) == \
            jsim.stpp_latency_per_token(jhw, depth, acc)


@pytest.mark.parametrize("kw", HW_GRID[::3])
def test_throughput_functions_equal(kw):
    hw, jhw = _hws(kw)
    for b, scale in itertools.product(BATCHES, SCALES):
        assert sim.pp_throughput(hw, b, scale) == \
            jsim.pp_throughput(jhw, b, scale)
        assert sim.stpp_throughput(hw, b, 4, 1.5, scale) == \
            jsim.stpp_throughput(jhw, b, 4, 1.5, scale)
        for fn in ("pipedec_throughput", "specpipe_db_throughput",
                   "specpipe_db_tbt"):
            assert getattr(sim, fn)(hw, b, 0.8, scale) == \
                getattr(jsim, fn)(jhw, b, 0.8, scale), fn
        assert sim.specpipe_db_timestep(hw, b, scale) == \
            jsim.specpipe_db_timestep(jhw, b, scale)


@pytest.mark.parametrize("kw", HW_GRID[::3])
def test_sharded_and_async_functions_equal(kw):
    hw, jhw = _hws(kw)
    terms = [{}, dict(ctrl_rate=0.4, t_ctrl=2e-4),
             dict(ctrl_rate=1.0, t_ctrl=1e-4, prefill_rate=0.1,
                  t_prefill=3e-3)]
    for b, scale, flush, ct in itertools.product(BATCHES, SCALES,
                                                 (False, True), terms):
        assert sim.specpipe_db_sharded_timestep(hw, b, scale, flush, **ct) \
            == jsim.specpipe_db_sharded_timestep(jhw, b, scale, flush, **ct)
        for fn in ("specpipe_db_sharded_throughput",
                   "specpipe_db_sharded_tbt"):
            assert getattr(sim, fn)(hw, b, 0.7, scale, flush, **ct) == \
                getattr(jsim, fn)(jhw, b, 0.7, scale, flush, **ct), fn
        async_ct = {k: v for k, v in ct.items() if "prefill" not in k}
        assert sim.specpipe_db_async_timestep(hw, b, scale, **async_ct) == \
            jsim.specpipe_db_async_timestep(jhw, b, scale, **async_ct)
        for fn in ("specpipe_db_async_throughput", "specpipe_db_async_tbt"):
            assert getattr(sim, fn)(hw, b, 0.7, scale, **async_ct) == \
                getattr(jsim, fn)(jhw, b, 0.7, scale, **async_ct), fn


@pytest.mark.parametrize("link_bw,t_sync,t_draft", [
    (50e9, 1e-5, 0.0), (3.0e12, 2.5e-3, 4e-3), (1.25e9, 0.0, 1e-2)])
def test_stage_hardware_from_roofline_equal(link_bw, t_sync, t_draft):
    kw = dict(n_stages=8, layer_time_one=1.1e-4, layer_time_width=1.3e-4,
              layers_per_stage=10, bytes_per_activation=8 * 8192 * 4,
              link_bw=link_bw, t_draft=t_draft, t_sync=t_sync)
    got = sim.stage_hardware_from_roofline(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jsim.stage_hardware_from_roofline(**kw))


def test_link_and_sync_have_no_default():
    """The port names no interconnect: ``link_bw`` and ``t_sync`` describe
    the deployment and must be given."""
    params = inspect.signature(sim.stage_hardware_from_roofline).parameters
    for name in ("link_bw", "t_sync"):
        assert params[name].default is inspect.Parameter.empty, name
        assert params[name].kind is inspect.Parameter.KEYWORD_ONLY
    kw = dict(n_stages=2, layer_time_one=1.0, layer_time_width=1.0,
              layers_per_stage=1, bytes_per_activation=1.0)
    with pytest.raises(TypeError):
        sim.stage_hardware_from_roofline(**kw, link_bw=1.0)
    with pytest.raises(TypeError):
        sim.stage_hardware_from_roofline(**kw, t_sync=0.0)

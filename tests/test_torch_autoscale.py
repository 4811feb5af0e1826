"""The port's autoscaler (``dllama_tpu_torch.serving.autoscale``) and the
fleet's restart backoff and elastic supervisor (``serving.fleet``) against
the JAX package's.

* Every case of ``tests/test_autoscale.py`` runs again on the port's
  modules (the policy tables, the backoff, the router's replica registry
  and checkpoint TTL sweep against ``FakeReplica`` servers, the
  ``policy_eval``/``scale_up``/``scale_down`` seams on a stub fleet);
  ``tests/torch_mirror.py`` rebinds the cases.
* ``decide`` and ``AutoscalePolicy`` give the JAX originals' decisions on
  the JAX tests' observation windows and on hypothesis-made ones, and
  ``restart_backoff_s`` the same delays.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import tests.test_autoscale as jt
from dllama_tpu import faults as jfaults
from dllama_tpu.serving import autoscale as jasc
from dllama_tpu.serving import fleet as jfleet
from dllama_tpu_torch import faults
from dllama_tpu_torch.serving import autoscale as tasc
from dllama_tpu_torch.serving import fleet as tfleet
from tests.torch_mirror import mirror

_CFG = dict(min_replicas=1, max_replicas=4, up_pressure=0.75, down_pressure=0.25,
            up_consecutive=2, down_consecutive=3, cooldown_up_s=5.0, cooldown_down_s=20.0)
assert all(getattr(jt.CFG, k) == v for k, v in _CFG.items())

globals().update(mirror(jt, overrides={"CFG": tasc.PolicyConfig(**_CFG)}))


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


_SIGNAL_KEYS = ("firing", "queue_depth", "slots_occupied", "slots_total",
                "kv_pages_free", "kv_pages_total", "kv_pages_reclaimable")


def _pair(sig):
    """A JAX ``Signals`` and the port's with the same fields."""
    kw = {k: getattr(sig, k) for k in _SIGNAL_KEYS}
    return jasc.Signals(**kw), tasc.Signals(**kw)


def _view(d):
    return d.action, d.target, d.reason, d.pressure


# the observation windows of tests/test_autoscale.py's policy tables
H, C, M = jt.hot(), jt.cold(), jt.mid()
WINDOWS = {"one_hot": [H], "hot_streak": [H, H], "firing_streak": [jt.hot(1), jt.hot(1)],
           "absorbed": [C, C, H], "flap": [H if i % 2 else C for i in range(10)],
           "mid_band": [M] * 6, "cold_pair": [C, C], "cold_streak": [C, C, C],
           "firing_tail": [C, C, jasc.Signals(firing=1, slots_total=4, kv_pages_free=8,
                                              kv_pages_total=8)],
           "hot_three": [H] * 3, "mixed": [C, M, H, H]}


@pytest.mark.parametrize("n_replicas", [0, 1, 2, 4, 5])
@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_decide_on_the_jax_tests_windows_matches_jax(name, n_replicas):
    jwin, twin = zip(*(_pair(s) for s in WINDOWS[name]))
    jcfg, tcfg = jasc.PolicyConfig(**_CFG), tasc.PolicyConfig(**_CFG)
    for now, last in ((0.0, None), (103.0, 100.0), (106.0, 100.0), (110.0, 100.0),
                      (121.0, 100.0)):
        assert (_view(tasc.decide(list(twin), n_replicas, tcfg, now, last))
                == _view(jasc.decide(list(jwin), n_replicas, jcfg, now, last)))


_signal = st.builds(tasc.Signals, firing=st.integers(0, 2), queue_depth=st.integers(0, 12),
                    slots_occupied=st.integers(0, 4), slots_total=st.integers(0, 4),
                    kv_pages_free=st.integers(0, 8), kv_pages_total=st.integers(0, 8),
                    kv_pages_reclaimable=st.integers(0, 8))
_cfg = st.fixed_dictionaries({
    "min_replicas": st.integers(1, 2), "max_replicas": st.integers(2, 5),
    "up_pressure": st.sampled_from([0.5, 0.75, 1.0]), "down_pressure": st.sampled_from([0.0, 0.25]),
    "up_consecutive": st.integers(1, 3), "down_consecutive": st.integers(1, 4),
    "cooldown_up_s": st.sampled_from([0.0, 2.0]), "cooldown_down_s": st.sampled_from([0.0, 5.0]),
    "alert_up": st.integers(1, 2), "window": st.integers(0, 6)})
_steps = st.lists(st.tuples(st.integers(0, 6), _signal, st.booleans()), min_size=1, max_size=25)


@settings(max_examples=80, deadline=None)
@given(_cfg, _steps)
def test_policy_on_any_observation_stream_matches_jax(cfg, steps):
    """``AutoscalePolicy.evaluate`` once a second over one stream of
    observations and replica counts, with some forced scale events
    (``note_scale``): the same decisions and the same window."""
    jpol, tpol = jasc.AutoscalePolicy(jasc.PolicyConfig(**cfg)), tasc.AutoscalePolicy(
        tasc.PolicyConfig(**cfg))
    for t, (n, sig, forced) in enumerate(steps):
        jsig, tsig = _pair(sig)
        if forced:
            jpol.note_scale(t - 0.5)
            tpol.note_scale(t - 0.5)
        assert _view(tpol.evaluate(float(t), n, tsig)) == _view(jpol.evaluate(float(t), n, jsig))
        assert tsig.pressure() == jsig.pressure()
    assert len(tpol.window_snapshot()) == len(jpol.window_snapshot())


@pytest.mark.parametrize("bad", [dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
                                 dict(up_pressure=0.2, down_pressure=0.5), dict(up_consecutive=0),
                                 dict(cooldown_up_s=-1.0), dict(alert_up=0)])
def test_policy_config_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError) as jerr:
        jasc.PolicyConfig(**bad)
    with pytest.raises(ValueError) as terr:
        tasc.PolicyConfig(**bad)
    assert str(terr.value) == str(jerr.value)


def test_restart_backoff_matches_jax():
    for restarts in range(12):
        for salt in (0, 1, 9990, 9991, 65535):
            for base, cap, jitter in ((0.5, 8.0, 0.25), (0.1, 1.0, 0.0), (2.0, 60.0, 1.0)):
                assert (tfleet.restart_backoff_s(restarts, base, cap, jitter, salt)
                        == jfleet.restart_backoff_s(restarts, base, cap, jitter, salt))

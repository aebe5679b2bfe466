"""The mixed and nbody models of the port against the JAX package's, both
with the fused dispatch (`pallas_fused=True`; the JAX kernel in interpret
mode, the port's plain version on the CPU), from the same seeds.

- mixed: 256 workers, 4 behaviours, 4 dependent float rounds a body, both
  seedings (every token on step0, and every behaviour id every tick).
  `done` and the counters are integers, compared exactly; the F32 `acc`
  within rtol 1e-6, as tests/test_fused_dispatch.py compares floats.
- nbody: one all-pairs round at 96 bodies. `seen` exactly; `ax`/`ay`
  within rtol 1e-6 of the JAX package, with an absolute floor of 1e-6 of
  the largest acceleration: XLA:CPU and torch round the float32 body and
  its 95-term sums differently, so a component that cancels to near zero
  differs by up to 2.4e-7 on accelerations up to 1.6 (1.5e-7 of the
  largest). And within the JAX package's own oracle tolerance
  (tests/test_models.py: rtol 2e-4, atol 2e-5) of `reference_accels`.
"""

import numpy as np
import pytest

from ponyc_tpu import RuntimeOptions as JOpts
from ponyc_tpu.models import mixed as jmixed
from ponyc_tpu.models import nbody as jnbody
from ponyc_tpu_torch import RuntimeOptions as TOpts
from ponyc_tpu_torch.models import mixed as tmixed
from ponyc_tpu_torch.models import nbody as tnbody

from _torch_programs import counters

MIXED_KW = dict(mailbox_cap=4, batch=1, max_sends=1, msg_words=1,
                spill_cap=256, inject_slots=8, pallas_fused=True,
                tuning_cache="off")


@pytest.mark.parametrize("mix", [False, True])
def test_mixed_fused_matches_jax(mix):
    n, b, ticks = 256, 4, 10
    jrt, jids, jwt = jmixed.build(n, b, JOpts(**MIXED_KW), work=4)
    jmixed.seed_all(jrt, jids, jwt, hops=1 << 30, mix=mix)
    jrt.run(max_steps=ticks)
    trt, tids, twt = tmixed.build(n, b, TOpts(**MIXED_KW), work=4,
                                  device="cpu")
    tmixed.seed_all(trt, tids, twt, hops=1 << 30, mix=mix)
    trt.run(max_steps=ticks)
    assert trt.steps_run == jrt.steps_run == ticks
    assert counters(trt) == counters(jrt)
    assert trt.counter("n_processed") == n * ticks
    js, ts = jrt.cohort_state(jwt), trt.cohort_state(twt)
    np.testing.assert_array_equal(ts["done"], js["done"])
    np.testing.assert_array_equal(ts["next_ref"], js["next_ref"])
    np.testing.assert_allclose(ts["acc"], js["acc"], rtol=1e-6)


def test_nbody_fused_matches_jax_and_oracle():
    n = 96
    kw = dict(mailbox_cap=16, batch=4, max_sends=1, msg_words=4,
              spill_cap=1024, pallas_fused=True, tuning_cache="off")
    jrt = jnbody.run_round(n, JOpts(**kw))
    trt = tnbody.run_round(n, TOpts(**kw), device="cpu")
    js, ts = jrt.cohort_state(jnbody.Body), trt.cohort_state(tnbody.Body)
    assert (ts["seen"] == n - 1).all()
    np.testing.assert_array_equal(ts["seen"], js["seen"])
    assert trt.steps_run == jrt.steps_run
    for k in ("ax", "ay"):
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-6,
                                   atol=1e-6 * np.abs(js[k]).max())
    ax, ay = tnbody.reference_accels(ts["x"], ts["y"], ts["m"])
    np.testing.assert_allclose(ts["ax"], ax, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(ts["ay"], ay, rtol=2e-4, atol=2e-5)

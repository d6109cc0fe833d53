"""The fused forecast entry point and the predictive policy's slot round
against the JAX package, on the CPU.

`forecast_basis` evaluates each slot's basis weights at u = (step -
last_step) / interval, masked by n_valid, and the weighted sum over the
difference stack; on the card in one kernel launch, on the CPU through its
plain version (`basis_coeffs` + `forecast_ref`), which is what runs here.
It is held slot by slot against JAX's `forecast_from_diffs`, and one
`PredictivePolicy.apply_slots` walk over 4 slots against the JAX policy's
`apply` per slot.  Inputs come from a numpy seed and go through both
packages.  Tolerances: 1e-6 abs in f32 (the same f32 formulas, sums in
another order); for a bf16 stack the port returns bf16, so one bf16
rounding of the output: 2^-8 relative (plus 1e-6 abs).
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from repro.core.predictive import PredictivePolicy as JaxPredictivePolicy  # noqa: E402
from repro.core.predictive import forecast_from_diffs as jax_forecast_from_diffs  # noqa: E402
from repro_torch.core import PredictivePolicy  # noqa: E402
from repro_torch.kernels.forecast import forecast_basis  # noqa: E402

BASES = ["taylor", "newton", "hermite", "ab"]


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("basis", BASES)
@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forecast_basis_matches_jax_slot_by_slot(basis, order, dtype):
    """One slot for each n_valid in 0 .. order + 1, each at its own u."""
    rng = np.random.default_rng(order)
    S = order + 2
    diffs = rng.standard_normal((S, order + 1, 6, 10), np.float32)
    last = np.arange(S, dtype=np.int32) * 3
    steps = last + 1 + np.arange(S) % 3
    n_valid = np.arange(S, dtype=np.int32)
    td = _t(diffs).to(getattr(torch, dtype))
    out = forecast_basis(td, steps, _t(last), _t(n_valid), 3, basis, 0.5)
    assert out.dtype == td.dtype and out.shape == (S, 6, 10)
    for s in range(S):
        u = np.float32(steps[s] - last[s]) / np.float32(3.0)
        ref = np.asarray(jax_forecast_from_diffs(
            jnp.asarray(td[s].float().numpy()), u, n_valid[s], basis, 0.5))
        if dtype == "float32":
            np.testing.assert_allclose(out[s].numpy(), ref, atol=1e-6, rtol=0)
        else:
            np.testing.assert_allclose(out[s].float().numpy(), ref,
                                       rtol=2 ** -8, atol=1e-6)


@pytest.mark.parametrize("basis", BASES)
def test_forecast_basis_unbatched_matches_jax(basis):
    """A 0-d last_step and n_valid: diffs (m+1, ...) -> (...)."""
    rng = np.random.default_rng(7)
    diffs = rng.standard_normal((3, 5, 7), np.float32)
    out = forecast_basis(_t(diffs), 9, torch.tensor(4, dtype=torch.int32),
                         torch.tensor(2, dtype=torch.int32), 4, basis)
    ref = jax_forecast_from_diffs(jnp.asarray(diffs), np.float32(5 / 4), 2,
                                  basis)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("basis", ["taylor", "hermite"])
def test_apply_slots_round_matches_jax_policy(basis):
    """4 slots at different phases, 7 ticks: each tick some slots compute
    (their fresh output enters the stack) and the rest forecast, in one
    `apply_slots`; the JAX policy's `apply` runs each slot alone.  Outputs
    and states within 1e-6 abs."""
    S, shape, interval = 4, (3, 8), 3
    pol = PredictivePolicy(interval, 2, basis)
    jpol = JaxPredictivePolicy(interval, 2, basis)
    states = {k: torch.stack([v] * S)
              for k, v in pol.init_state(shape, device="cpu").items()}
    jstates = [jpol.init_state(shape) for _ in range(S)]
    rng = np.random.default_rng(3)
    for r in range(7):
        steps = np.arange(S) + r
        fresh = rng.standard_normal((S,) + shape, np.float32)
        xs = _t(rng.standard_normal((S,) + shape, np.float32))
        want = steps % interval == 0
        ys = torch.where(_t(want).view(S, 1, 1), _t(fresh), torch.zeros(()))
        y, states = pol.apply_slots(states, steps, xs, ys)
        for s in range(S):
            jy, jstates[s] = jpol.apply(jstates[s], int(steps[s]),
                                        jnp.asarray(xs[s].numpy()),
                                        lambda x, f=fresh[s]: jnp.asarray(f))
            np.testing.assert_allclose(y[s].numpy(), np.asarray(jy),
                                       atol=1e-6, rtol=0)
    for s in range(S):
        for k in ("diffs", "n_valid", "last_step"):
            np.testing.assert_allclose(states[k][s].numpy(),
                                       np.asarray(jstates[s][k]), atol=1e-6,
                                       rtol=0)

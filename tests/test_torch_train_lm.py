"""The port's LM training (`lm_loss`, `make_lm_train_step`) against the JAX
package on the CPU, at zamba2-2.7b SMOKE size (hybrid: Mamba2 layers and a
shared attention block; on CPU tensors the SSD scan's plain version
carries the gradient; the card's backward kernel is held against its plain
VJP in tests/test_torch_ssd_bwd.py and tests/test_torch_cuda.py).

Tolerances: the loss 1e-5 relative and its gradient 1e-4 relative per leaf
(summation order of XLA and torch); 3 steps with accum=4 against JAX's
accum=4: params and moments 1e-4 relative per leaf (AdamW normalizes the
gradient, so its rounding reaches the update); the port's accum=4 against
its accum=1 on the same batch 1e-4 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import lm_batches  # noqa: E402
from repro.train import steps as jax_steps  # noqa: E402

from repro_torch.bridge import to_torch, train_state_to_torch  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.train import steps  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

ARCH = "zamba2-2.7b"


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _assert_tree_close(port, ref, rtol, what):
    got = tree_paths(port)
    want = tree_paths(jax.tree_util.tree_map(np.asarray, ref))
    assert [k for k, _ in got] == [k for k, _ in want]
    bad = {k: r for (k, g), (_, w) in zip(got, want)
           if not (r := _rel(g.float().numpy(), np.asarray(w, np.float32)))
           <= rtol}
    assert not bad, (what, bad)


@pytest.fixture(scope="module")
def lm():
    cfg = jax_smoke(ARCH)
    state = jax_steps.init_train_state(jax.random.PRNGKey(0), cfg)
    it = lm_batches(0, 8, 16, cfg.vocab_size)
    batches = [next(it) for _ in range(3)]
    t, y = batches[0]
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jax_steps.lm_loss(p, jnp.asarray(t), jnp.asarray(y), cfg),
        has_aux=True))(state.params)
    step = jax.jit(jax_steps.make_lm_train_step(cfg, warmup=0, total_steps=10,
                                                accum=4))
    s, hist = state, []
    for t_, y_ in batches:
        s, m = step(s, {"tokens": jnp.asarray(t_), "targets": jnp.asarray(y_)})
        hist.append({k: float(v) for k, v in m.items()})
    return {"cfg": get_smoke_config(ARCH), "state": state, "batches": batches,
            "loss": float(loss), "metrics": {k: float(v) for k, v in
                                             metrics.items()},
            "grads": grads, "after": s, "hist": hist}


def _batch(lm, i):
    t, y = lm["batches"][i]
    return {"tokens": torch.from_numpy(t), "targets": torch.from_numpy(y)}


def test_lm_loss_and_gradient_match_jax(lm):
    params = to_torch(jax.tree_util.tree_map(np.asarray, lm["state"].params),
                      "cpu")
    b = _batch(lm, 0)

    def loss_fn(p, _):
        return steps.lm_loss(p, b["tokens"], b["targets"], lm["cfg"])

    grads, metrics = steps._value_and_grad(loss_fn, params, None)
    assert set(metrics) == set(lm["metrics"]) == {"loss", "lb_loss", "z_loss"}
    assert abs(float(metrics["loss"]) - lm["loss"]) <= 1e-5 * lm["loss"]
    assert float(metrics["lb_loss"]) == float(metrics["z_loss"]) == 0.0
    _assert_tree_close(grads, lm["grads"], 1e-4, "gradient")


def test_lm_train_step_with_accumulation_matches_jax(lm):
    state = train_state_to_torch(lm["state"].params, lm["state"].opt, "cpu")
    step = steps.make_lm_train_step(lm["cfg"], warmup=0, total_steps=10,
                                    accum=4)
    for i, want in enumerate(lm["hist"]):
        state, m = step(state, _batch(lm, i))
        assert set(m) == set(want)
        for k, v in want.items():
            assert abs(float(m[k]) - v) <= 1e-4 * max(abs(v), 1e-6), k
    assert int(state.opt.step) == 3
    _assert_tree_close(state.params, lm["after"].params, 1e-4, "params")
    _assert_tree_close(state.opt.mu, lm["after"].opt.mu, 1e-4, "mu")
    _assert_tree_close(state.opt.nu, lm["after"].opt.nu, 1e-4, "nu")


def test_lm_accumulation_equals_one_batch(lm):
    outs = []
    for accum in (1, 4):
        state = train_state_to_torch(lm["state"].params, lm["state"].opt,
                                     "cpu")
        step = steps.make_lm_train_step(lm["cfg"], warmup=0, total_steps=10,
                                        accum=accum)
        outs.append(step(state, _batch(lm, 0)))
    (s1, m1), (s4, m4) = outs
    assert abs(float(m1["loss"]) - float(m4["loss"])) <= 1e-5 * float(m1["loss"])
    for a, b in zip(tree_leaves(s4), tree_leaves(s1)):
        assert _rel(a.float().numpy(), b.float().numpy()) <= 1e-4
    with pytest.raises(ValueError, match="microbatches"):
        steps.make_lm_train_step(lm["cfg"], accum=3)(s1, _batch(lm, 0))


def test_lm_launcher_trains_on_the_cpu():
    from repro_torch.launch import train as launch
    state, hist = launch.main(["--arch", ARCH, "--smoke", "--steps", "2",
                               "--batch", "2", "--seq", "16", "--accum", "2",
                               "--device", "cpu"])
    assert hist and np.isfinite(hist[0]["loss"]) and int(state.opt.step) == 2
    assert set(hist[0]) == {"step", "loss", "lb_loss", "z_loss", "grad_norm",
                            "lr", "steps_per_s"}

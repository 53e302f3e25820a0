"""The port's optimizer against the JAX package's: each case of
``tests/test_optim.py``, ``apply_updates`` on seeded trees against the
reference's, bf16 moments, both schedules step by step, and the int8
error-feedback property through ``tests/_hyp.py``.

Tolerances: ``RTOL = 1e-6`` (float32 on both sides; the same roundings,
only ``sqrt``, ``pow`` and the norm's sums may differ in the last bit),
elementwise with an absolute floor of ``RTOL`` times the leaf's largest
magnitude (where m b1 and g (1 - b1) nearly cancel, a last-bit difference
in the clip's scale is many ulps of the difference: measured 1.9e-9 on a
moment of 7e-4 in a leaf whose largest is 0.027);
bf16 moments within one bf16 ulp (2^-7 relative) of the reference's, a
rounding boundary crossed by an f32 last-bit difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.optim import adamw as RA
from repro.optim import compress as RC
from repro.optim import schedule as RS
from repro_torch.optim import adamw, compress
from repro_torch.optim.schedule import constant, linear_warmup_cosine

RTOL = 1e-6
BF16_ULP = 2.0 ** -7


def _tree(seed, dtype=np.float32):
    """A nested tree of seeded arrays (sorted keys not in insertion order)."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((8, 5)).astype(dtype),
        "b": {"z": rng.standard_normal((5,)).astype(dtype),
              "a": rng.standard_normal((3, 2, 4)).astype(dtype)},
    }


def _torch(tree):
    return adamw.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _flat_np(tree):
    return [np.asarray(leaf, np.float32) for leaf in adamw.tree_leaves(
        adamw.tree_map(lambda t: t.float().numpy() if isinstance(t, torch.Tensor) else t, tree))]


# ---------------------------------------------------------------------------
# tests/test_optim.py, case by case
# ---------------------------------------------------------------------------


def test_adamw_matches_hand_reference():
    cfg = adamw.AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.01, clip_norm=None)
    p = {"w": torch.tensor([1.0, -2.0])}
    g = {"w": torch.tensor([0.5, 0.25])}
    st_ = adamw.init_state(cfg, p)
    new_p, new_st, _ = adamw.apply_updates(cfg, p, st_, g)
    gh = np.array([0.5, 0.25])
    delta = gh / (np.sqrt(gh ** 2) + 1e-8) + 0.01 * np.array([1.0, -2.0])
    want = np.array([1.0, -2.0]) - 0.1 * delta
    np.testing.assert_allclose(new_p["w"].numpy(), want, rtol=1e-5)
    assert int(new_st["step"]) == 1 and new_st["step"].dtype == torch.int32
    assert new_p["w"] is p["w"]  # written in place


def test_clip_norm_bounds_update():
    cfg = adamw.AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0)
    p = {"w": torch.zeros(4)}
    g = {"w": torch.full((4,), 100.0)}
    _, _, metrics = adamw.apply_updates(cfg, p, adamw.init_state(cfg, p), g)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert float(g["w"].norm()) == pytest.approx(1.0)  # scaled in place by the clip


def test_moment_dtype_bf16_halves_state():
    cfg = adamw.AdamWConfig(moment_dtype="bfloat16")
    st_ = adamw.init_state(cfg, {"w": torch.zeros((8, 8))})
    assert st_["m"]["w"].dtype == torch.bfloat16
    assert st_["v"]["w"].dtype == torch.bfloat16


def test_schedule_warmup_and_decay():
    fn = linear_warmup_cosine(warmup=10, total=110, final_scale=0.1)
    step = lambda s: torch.tensor(s, dtype=torch.int32)
    assert float(fn(step(0))) == pytest.approx(0.0)
    assert float(fn(step(5))) == pytest.approx(0.5)
    assert float(fn(step(10))) == pytest.approx(1.0)
    assert float(fn(step(110))) == pytest.approx(0.1, abs=1e-6)
    assert float(constant()(step(7))) == 1.0


def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.05, weight_decay=0.0, clip_norm=None)
    p = {"w": torch.tensor([5.0, -3.0])}
    st_ = adamw.init_state(cfg, p)
    for _ in range(300):
        g = {"w": 2 * p["w"]}  # d/dw w^2
        p, st_, _ = adamw.apply_updates(cfg, p, st_, g)
    assert float(p["w"].abs().max()) < 1e-2


def test_bf16_compress_is_cast_roundtrip():
    g = {"w": torch.tensor([1.0 + 1e-4, -2.0])}
    c = compress.compress_bf16(g)
    np.testing.assert_array_equal(c["w"].numpy(), g["w"].bfloat16().float().numpy())
    want = RC.compress_bf16({"w": jnp.asarray(g["w"].numpy())})["w"]
    np.testing.assert_array_equal(c["w"].numpy(), np.asarray(want))


@settings(deadline=None, max_examples=20)
@given(seed=st.integers(0, 1000), steps=st.integers(5, 40))
def test_int8_error_feedback_sum_is_unbiased(seed, steps):
    """Error feedback: the SUM of compressed gradients tracks the sum of raw
    gradients to within one quantization step (the residual bound); and
    every step equals the reference's compressor."""
    rng = np.random.default_rng(seed)
    grads = [rng.normal(size=(16,)).astype(np.float32) for _ in range(steps)]
    residual = compress.init_error_feedback({"w": torch.zeros(16)})
    r_residual = RC.init_error_feedback({"w": jnp.zeros(16)})
    total_raw = np.zeros(16)
    total_comp = np.zeros(16)
    max_scale = 0.0
    for g in grads:
        comp, residual = compress.compress_int8_ef({"w": torch.from_numpy(g)}, residual)
        r_comp, r_residual = RC.compress_int8_ef({"w": jnp.asarray(g)}, r_residual)
        np.testing.assert_allclose(comp["w"].numpy(), np.asarray(r_comp["w"]), rtol=RTOL, atol=1e-7)
        total_raw += g
        total_comp += comp["w"].numpy()
        max_scale = max(max_scale, float(np.abs(g).max()) / 127.0)
    err = np.abs(total_raw - total_comp)
    np.testing.assert_allclose(err, np.abs(residual["w"].numpy()), atol=1e-5)
    assert err.max() <= max_scale * 2 + 1e-6


# ---------------------------------------------------------------------------
# Against the reference on seeded trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip_norm", [1.0, None, 1e6])
@pytest.mark.parametrize("schedule", [None, "warmup_cosine"])
def test_apply_updates_matches_reference(clip_norm, schedule):
    """Five steps on a seeded three-leaf tree, gradients drawn anew each
    step: parameters, moments, step, grad norm and lr equal the
    reference's within RTOL."""
    sched = {None: (None, None),
             "warmup_cosine": (linear_warmup_cosine(2, 5), RS.linear_warmup_cosine(2, 5))}[schedule]
    cfg = adamw.AdamWConfig(lr=0.01, clip_norm=clip_norm, schedule=sched[0])
    r_cfg = RA.AdamWConfig(lr=0.01, clip_norm=clip_norm, schedule=sched[1])
    params, r_params = _torch(_tree(0)), _jax(_tree(0))
    state, r_state = adamw.init_state(cfg, params), RA.init_state(r_cfg, r_params)
    for step in range(5):
        g = _tree(10 + step)
        params, state, m = adamw.apply_updates(cfg, params, state, _torch(g))
        r_params, r_state, r_m = RA.apply_updates(r_cfg, r_params, r_state, _jax(g))
        for key in ("grad_norm", "lr"):
            assert float(m[key]) == pytest.approx(float(r_m[key]), rel=RTOL), key
        assert int(state["step"]) == int(r_state["step"]) == step + 1
    for got, want in zip(_flat_np(params) + _flat_np(state["m"]) + _flat_np(state["v"]),
                         _flat_np(r_params) + _flat_np(r_state["m"]) + _flat_np(r_state["v"])):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_apply_updates_bf16_moments_match_reference():
    """bf16 moments (f32 parameters): updated in f32 and rounded once a
    step, as the reference's; moments within a bf16 ulp, parameters within
    RTOL."""
    cfg = adamw.AdamWConfig(lr=0.01, moment_dtype="bfloat16")
    r_cfg = RA.AdamWConfig(lr=0.01, moment_dtype="bfloat16")
    params, r_params = _torch(_tree(1)), _jax(_tree(1))
    state, r_state = adamw.init_state(cfg, params), RA.init_state(r_cfg, r_params)
    for step in range(4):
        g = _tree(20 + step)
        params, state, _ = adamw.apply_updates(cfg, params, state, _torch(g))
        r_params, r_state, _ = RA.apply_updates(r_cfg, r_params, r_state, _jax(g))
    assert all(t.dtype == torch.bfloat16 for t in adamw.tree_leaves(state["m"]))
    for got, want in zip(_flat_np(state["m"]) + _flat_np(state["v"]),
                         _flat_np(r_state["m"]) + _flat_np(r_state["v"])):
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-30)
    for got, want in zip(_flat_np(params), _flat_np(r_params)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_apply_updates_bf16_parameters_match_reference():
    """bf16 parameters and moments: each rounded once a step."""
    cfg = adamw.AdamWConfig(lr=0.01, moment_dtype="bfloat16")
    r_cfg = RA.AdamWConfig(lr=0.01, moment_dtype="bfloat16")
    tree = adamw.tree_map(lambda a: a, _tree(2))
    params = adamw.tree_map(lambda a: torch.from_numpy(a).bfloat16(), tree)
    r_params = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), tree)
    state, r_state = adamw.init_state(cfg, params), RA.init_state(r_cfg, r_params)
    g = _tree(30)
    params, state, _ = adamw.apply_updates(
        cfg, params, state, adamw.tree_map(lambda a: torch.from_numpy(a).bfloat16(), g))
    r_params, r_state, _ = RA.apply_updates(r_cfg, r_params, r_state,
                                            jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), g))
    for got, want in zip(_flat_np(params), _flat_np(r_params)):
        np.testing.assert_allclose(got, want, rtol=BF16_ULP, atol=1e-30)


def test_global_norm_matches_reference():
    tree = _tree(3)
    assert float(adamw.global_norm(_torch(tree))) == pytest.approx(
        float(RA.global_norm(_jax(tree))), rel=RTOL)


@pytest.mark.parametrize("kind", ["warmup_cosine", "constant"])
def test_schedule_matches_reference_at_every_step(kind):
    """Every step of a 50-step run (warmup 10)."""
    fn = linear_warmup_cosine(10, 50) if kind == "warmup_cosine" else constant()
    r_fn = RS.linear_warmup_cosine(10, 50) if kind == "warmup_cosine" else RS.constant()
    got = [float(fn(torch.tensor(s, dtype=torch.int32))) for s in range(51)]
    want = [float(r_fn(jnp.asarray(s, jnp.int32))) for s in range(51)]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_trees_walk_in_sorted_key_order():
    """The port's tree order is jax.tree's (sorted dict keys), so global
    norms sum and checkpoints list their leaves in the reference's order."""
    tree = _tree(4)
    got = [t.shape for t in adamw.tree_leaves(_torch(tree))]
    want = [tuple(a.shape) for a in jax.tree.leaves(_jax(tree))]
    assert [tuple(s) for s in got] == want
    back = adamw.tree_unflatten(tree, adamw.tree_leaves(tree))
    assert back.keys() == tree.keys() and back["b"]["a"] is tree["b"]["a"]

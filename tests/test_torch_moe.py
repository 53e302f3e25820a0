"""The port's MoE against the JAX package's: the routing and dispatch
invariants of ``tests/test_moe.py`` (property-tested), replication groups
and the balanced-router aux loss, each also equal to the reference on the
same inputs; the gradient test waits for the training slice.

Tolerances: the dispatch and combine move and weight rows, so their
buffers and slot maps equal the reference's exactly (combine within
1e-6, one float32 product per slot); ``moe_apply`` within rtol = 1e-5 and
atol = 1e-5 times the output's largest magnitude of the reference (float32
matmuls summed in another order: the error scales with the terms summed,
and the reference's fan-in rule gives the (E, D, F) expert tables a
scale of E ** -0.5, outputs in the hundreds)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, st  # optional-hypothesis shim

from repro.configs.registry import get_arch as ref_arch
from repro.models import blocks as RB
from repro_torch.configs.registry import get_arch
from repro_torch.models import blocks as TB
from repro_torch.models.model import seeded_numpy_params

TOL = 1e-5


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL, atol=TOL * np.abs(want).max())


@settings(deadline=None, max_examples=30)
@given(
    t=st.integers(4, 64),
    e=st.integers(2, 8),
    k=st.integers(1, 2),
    seed=st.integers(0, 100),
)
def test_dispatch_capacity_and_routing_invariants(t, e, k, seed):
    rng = np.random.default_rng(seed)
    d = 8
    cap = max((t * k) // e, 1)
    x = rng.normal(size=(t, d)).astype(np.float32)
    idx = rng.integers(0, e, size=(t, k)).astype(np.int32)
    buf, dest = TB._dispatch_local(torch.from_numpy(x), torch.from_numpy(idx), e, k, cap, e)
    buf, dest = buf.numpy(), dest.numpy()

    # every slot dest is a valid buffer row or the overflow sentinel
    assert ((0 <= dest) & (dest <= e * cap)).all()
    # no two valid slots share a row (capacity rows are unique)
    valid = dest < e * cap
    assert len(np.unique(dest[valid])) == valid.sum()
    # each dispatched row equals its source token
    tok_of_slot = np.arange(t * k) // k
    flat = buf.reshape(e * cap, d)
    for slot in np.nonzero(valid)[0][:50]:
        np.testing.assert_allclose(flat[dest[slot]], x[tok_of_slot[slot]], rtol=1e-6)
    # per-expert occupancy never exceeds capacity
    experts_of_rows = dest[valid] // cap
    for ee in range(e):
        assert (experts_of_rows == ee).sum() <= cap
    # the reference drops and places the same slots
    r_buf, r_dest = RB._dispatch_local(jnp.asarray(x), jnp.asarray(idx), e, k, cap, e)
    np.testing.assert_array_equal(dest, np.asarray(r_dest))
    np.testing.assert_array_equal(buf, np.asarray(r_buf))


@settings(deadline=None, max_examples=20)
@given(t=st.integers(4, 32), e=st.integers(2, 4), seed=st.integers(0, 50))
def test_dispatch_combine_roundtrip_identity(t, e, seed):
    """With capacity >= all tokens and gates == 1, combine(dispatch(x)) == x
    per selected expert (top-1)."""
    rng = np.random.default_rng(seed)
    d, k = 4, 1
    cap = t  # no drops possible
    x = rng.normal(size=(t, d)).astype(np.float32)
    idx = rng.integers(0, e, size=(t, k)).astype(np.int32)
    buf, dest = TB._dispatch_local(torch.from_numpy(x), torch.from_numpy(idx), e, k, cap, e)
    out = TB._combine_local(buf, dest, torch.ones((t, k)), k)
    np.testing.assert_allclose(out.numpy(), x, rtol=1e-6)


@settings(deadline=None, max_examples=20)
@given(t=st.integers(4, 48), e=st.integers(2, 6), k=st.integers(1, 2), seed=st.integers(0, 50))
def test_combine_matches_reference_with_drops(t, e, k, seed):
    rng = np.random.default_rng(seed)
    d = 8
    cap = max((t * k) // (2 * e), 1)  # tight: some slots drop
    x = rng.normal(size=(t, d)).astype(np.float32)
    idx = rng.integers(0, e, size=(t, k)).astype(np.int32)
    gates = rng.random((t, k)).astype(np.float32)
    buf, dest = TB._dispatch_local(torch.from_numpy(x), torch.from_numpy(idx), e, k, cap, e)
    out = TB._combine_local(buf * 2, dest, torch.from_numpy(gates), k)
    r_buf, r_dest = RB._dispatch_local(jnp.asarray(x), jnp.asarray(idx), e, k, cap, e)
    want = RB._combine_local(r_buf * 2, r_dest, jnp.asarray(gates), k)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _moe_pair(cfg_t, cfg_r, seed=0):
    """One unstacked MoE block's parameters in both packages (the seeded
    numpy recipe's first stage of the arch's first MoE block)."""
    tree = seeded_numpy_params(cfg_t, seed)
    block = next(b for b in tree["stages"].values() if "router" in b.get("mlp", {}))

    def first(tree, to):
        return {n: first(v, to) if isinstance(v, dict) else to(v[0]) for n, v in tree.items()}

    return first(block["mlp"], torch.from_numpy), first(block["mlp"], jnp.asarray)


def test_expert_replication_shards_equivalent():
    """expert_shards > E must not change the MoE output at all."""
    cfg_base = get_arch("mixtral_8x7b").reduced()  # E=4 after reduction
    x = np.random.default_rng(0).standard_normal((2, 16, cfg_base.d_model)).astype(np.float32)
    p, rp = _moe_pair(cfg_base, ref_arch("mixtral_8x7b").reduced())
    outs = []
    for shards in (4, 8, 16):
        cfg = dataclasses.replace(cfg_base, expert_shards=shards)
        out, aux = TB.moe_apply(p, torch.from_numpy(x), cfg)
        outs.append(out.numpy())
        r_out, r_aux = RB.moe_apply(rp, jnp.asarray(x), dataclasses.replace(
            ref_arch("mixtral_8x7b").reduced(), expert_shards=shards))
        _close(outs[-1], r_out)
        np.testing.assert_allclose(aux.item(), float(r_aux), rtol=TOL)
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-5, atol=1e-6)


def test_aux_loss_balanced_router_is_one():
    """Switch aux loss: uniform routing gives its minimum 1.0; with a zero
    router every top-1 tie goes to expert 0 (the lower index), as
    ``lax.top_k`` breaks it."""
    cfg = get_arch("mixtral_8x7b").reduced()
    p, rp = _moe_pair(cfg, ref_arch("mixtral_8x7b").reduced())
    p["router"] = torch.zeros_like(p["router"])
    rp["router"] = jnp.zeros_like(rp["router"])
    x = np.random.default_rng(0).standard_normal((1, 64, cfg.d_model)).astype(np.float32)
    out, aux = TB.moe_apply(p, torch.from_numpy(x), cfg)
    assert aux.item() == pytest.approx(1.0, abs=1e-3)
    r_out, r_aux = RB.moe_apply(rp, jnp.asarray(x), ref_arch("mixtral_8x7b").reduced())
    assert aux.item() == pytest.approx(float(r_aux), abs=1e-6)
    _close(out.numpy(), r_out)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_top_k_breaks_ties_to_the_lower_index(k):
    rng = np.random.default_rng(k)
    probs = rng.integers(0, 3, size=(200, 6)).astype(np.float32) / 4  # many ties
    vals, idx = TB._top_k(torch.from_numpy(probs), k)
    r_vals, r_idx = jax.lax.top_k(jnp.asarray(probs), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(r_vals))


@pytest.mark.parametrize("arch", ["mixtral_8x7b", "jamba_v01_52b", "llama4_maverick_400b"])
@pytest.mark.parametrize("dropless", [False, True])
def test_moe_apply_matches_reference(arch, dropless):
    """Capacity drops (the default factor at 48 tokens) and dropless decode
    sizing, shared experts (Llama-4), top-1 and top-2."""
    cfg, rcfg = get_arch(arch).reduced(), ref_arch(arch).reduced()
    p, rp = _moe_pair(cfg, rcfg)
    x = np.random.default_rng(1).standard_normal((3, 16, cfg.d_model)).astype(np.float32)
    out, aux = TB.moe_apply(p, torch.from_numpy(x), cfg, dropless=dropless)
    r_out, r_aux = RB.moe_apply(rp, jnp.asarray(x), rcfg, dropless=dropless)
    _close(out.numpy(), r_out)
    assert aux.item() == pytest.approx(float(r_aux), rel=TOL)

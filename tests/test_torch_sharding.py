"""The port's sharding rules against the JAX package's, case by case from
``tests/test_sharding_roofline.py`` (the rule tests): the port's
``spec_for_axes`` returns a tuple where the reference returns a
``PartitionSpec``, and the two must hold the same entries."""

import numpy as np
import pytest
import torch
from _hyp import given, settings, st  # optional-hypothesis shim

from repro.parallel import sharding as R
from repro_torch.parallel import sharding as T


class FakeMesh:
    """Duck-typed mesh: only axis_names + devices.shape are consulted."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.zeros(tuple(sizes.values()))


MESH1 = FakeMesh({"data": 16, "model": 16})
MESH2 = FakeMesh({"pod": 2, "data": 16, "model": 16})


def _spec(axes, shape, mesh, kind):
    """The port's spec, asserted equal to the reference's."""
    got = T.spec_for_axes(axes, shape, mesh, getattr(T, kind))
    assert isinstance(got, tuple)
    assert got == tuple(R.spec_for_axes(axes, shape, mesh, getattr(R, kind)))
    return got


def test_rule_tables_equal_reference():
    assert T.DEFAULT_PARAM_RULES == R.DEFAULT_PARAM_RULES
    assert T.DEFAULT_ACT_RULES == R.DEFAULT_ACT_RULES


def test_param_rules_basic_tp_fsdp():
    assert _spec(("embed", "mlp"), (4096, 14336), MESH1, "DEFAULT_PARAM_RULES") == ("data", "model")


def test_kv_heads_fallback_replicated():
    """granite: kv=1 cannot shard over model=16 -> replicated dim."""
    spec = _spec(("embed", "kv_heads", None), (6144, 1, 128), MESH1, "DEFAULT_PARAM_RULES")
    assert spec == ("data", None, None)


def test_experts_fallback_to_mlp_tp():
    """mixtral: 8 experts % 16 != 0 -> experts dim unsharded, mlp takes TP."""
    spec = _spec(("experts", "embed", "mlp"), (8, 4096, 14336), MESH1, "DEFAULT_PARAM_RULES")
    assert spec == (None, "data", "model")
    spec = _spec(("experts", "embed", "mlp"), (128, 5120, 8192), MESH1, "DEFAULT_PARAM_RULES")
    assert spec == ("model", "data", None)


def test_no_mesh_axis_used_twice():
    spec = _spec(("heads", "mlp", "vocab"), (32, 14336, 32000), MESH1, "DEFAULT_PARAM_RULES")
    flat = []
    for u in spec:
        if u is not None:
            flat.extend(u if isinstance(u, tuple) else (u,))
    assert len(flat) == len(set(flat))


_AXIS_NAMES = [
    "batch", "seq", "embed", "heads", "kv_heads", "mlp", "experts",
    "expert_cap", "vocab", "cache_seq", "inner", None,
]


@settings(deadline=None, max_examples=200)
@given(
    axes=st.lists(st.sampled_from(_AXIS_NAMES), min_size=1, max_size=5),
    dims=st.lists(st.integers(1, 4096), min_size=5, max_size=5),
    multi_pod=st.booleans(),
    rules_kind=st.booleans(),
)
def test_spec_invariants_hold_for_any_axes(axes, dims, multi_pod, rules_kind):
    """Allocator invariants for ANY logical-axes tuple (every assigned group
    divides its dim, no mesh axis used twice, one entry per dim), and the
    reference's spec for the same draw."""
    mesh = MESH2 if multi_pod else MESH1
    kind = "DEFAULT_PARAM_RULES" if rules_kind else "DEFAULT_ACT_RULES"
    shape = tuple(dims[: len(axes)])
    spec = _spec(axes, shape, mesh, kind)
    assert len(spec) == len(axes)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    used = []
    for entry, dim in zip(spec, shape):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        prod = 1
        for g in group:
            prod *= sizes[g]
            used.append(g)
        assert dim % prod == 0, f"{entry} does not divide {dim}"
    assert len(used) == len(set(used)), f"axis reused in {spec}"


def test_batch_2d_and_fallbacks():
    act = "DEFAULT_ACT_RULES"
    assert _spec(("batch", "seq"), (256, 4096), MESH1, act)[0] == ("data", "model")
    assert _spec(("batch", "seq"), (256, 4096), MESH2, act)[0] == ("pod", "data")
    spec = _spec(("batch", "kv_heads", "cache_seq", None), (1, 8, 524288, 128), MESH1, act)
    assert spec == (None, None, "data", None)
    spec = _spec(("batch", "kv_heads", "cache_seq", None), (128, 8, 32768, 128), MESH1, act)
    assert spec[0] in (("data", "model"), "data")


def test_rank_mismatch_raises_as_reference():
    for mod in (R, T):
        with pytest.raises(ValueError, match="rank mismatch"):
            mod.spec_for_axes(("embed",), (4, 4), MESH1, mod.DEFAULT_PARAM_RULES)


def test_no_mesh_is_active_on_the_port():
    x = torch.ones(2, 3)
    assert T.active_mesh() is None and T.active_act_rules() is None
    assert T.shard_hint(x, "batch", "embed") is x
    assert R.active_mesh() is None  # the reference outside activation_sharding

"""Placement on a DeviceMesh against the JAX package's NamedSharding, and
the port's sharded step and MoE dispatch on eight CPU ranks.

* ``launch.mesh`` raises the reference's error without a process group.
* For every input leaf of the ten reduced archs' train, prefill and decode
  specs on (4, 2) and (2, 2, 2) meshes, ``Sharding.shard_shape`` and
  ``shard_slices`` equal JAX's ``NamedSharding.shard_shape`` and
  ``devices_indices_map`` (rank r = device r).  The JAX side runs in a
  subprocess with 8 forced host devices and an Auto-axis
  ``jax.sharding.Mesh`` (``jax.make_mesh``'s Explicit axes reject the
  reference's sharding constraints on this JAX).
* ``tests/_torch_mesh_worker.py`` spawns 8 gloo ranks on a (4, 2) mesh:
  the yi_6b reduced f32 loss, every gradient leaf and every parameter after
  one AdamW step, and the serving forward's logits on both attention
  routes, lie within TRAIN_TOL (relative L2) of the unsharded ones, and
  so do the mixtral reduced step's loss, gradients and update, whose MoE
  takes the sharded branch under autograd (capacity for every token, so
  that per-shard and global capacity drop none), and so do the xlstm
  reduced step's, whose gates' ``F.logsigmoid`` (DTensor has no sharding
  rule for its backward) and mLSTM recurrence run through ``local_map``;
  that step runs in float64, since the f32 step's own gradients lie up to
  1.6e-5 from float64's, above TRAIN_TOL;
  each rank's placed block is the global tensor's block at its coordinate;
  and the mixtral reduced MoE's sharded dispatch (``local_map``) lies within
  MOE_TOL (relative L2; its aux loss relative) of the reference's
  ``shard_map`` branch on the same inputs; above the compact path's rule,
  DTensor tokens keep that capacity dispatch, within MOE_TOL of the plain
  tokens' compact path.

Each subprocess has its own timeout and rendezvous goes through a file in
``tmp_path``; no process group is left in the test process.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import ARCH_IDS, ShapeSpec, get_arch
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_mesh, make_test_mesh
from repro_torch.models import model as M
from repro_torch.parallel import sharding as sh

ROOT = Path(__file__).resolve().parents[1]
# float32 sums in another order (sharded contractions, all-reduces)
TRAIN_TOL = 1e-5
MOE_TOL = 1e-5
MESHES = {"4x2": ((4, 2), ("data", "model")), "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
KINDS = ("train", "prefill", "decode")


class FakeMesh:
    """Duck-typed mesh: axis_names + devices.shape."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = np.zeros(shape)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = value
    return out


def _shape(kind):
    return ShapeSpec("t", kind, 64, 8)


JAX_REFERENCE = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs.registry import ARCH_IDS, ShapeSpec, get_arch
    from repro.launch import specs
    from repro.models import blocks
    from repro.parallel import sharding as sh

    MESHES = {"4x2": ((4, 2), ("data", "model")),
              "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
    meshes = {k: Mesh(np.asarray(jax.devices()[:8]).reshape(s), a) for k, (s, a) in MESHES.items()}

    def key(path):
        return "/".join(str(p.key) for p in path)

    def axes_at(tree, path):
        for p in path:
            tree = tree[p.key]
        return tree

    out = {"placement": {}}
    for arch in ARCH_IDS:
        cfg = get_arch(arch).reduced()
        for kind in ("train", "prefill", "decode"):
            in_specs, in_axes = specs.input_specs(cfg, ShapeSpec("t", kind, 64, 8))
            leaves = jax.tree_util.tree_flatten_with_path(in_specs)[0]
            for name, mesh in meshes.items():
                rec = {}
                for path, sds in leaves:
                    ns = sh.sharding_for(axes_at(in_axes, path), sds.shape, mesh,
                                         sh.DEFAULT_PARAM_RULES)
                    idx = ns.devices_indices_map(sds.shape)
                    blocks_ = [[[s.start or 0, n if s.stop is None else s.stop]
                                for s, n in zip(idx[d], sds.shape)]
                               for d in sorted(idx, key=lambda d: d.id)]
                    rec[key(path)] = {"shard_shape": list(ns.shard_shape(sds.shape)),
                                      "blocks": blocks_}
                out["placement"][f"{arch}/{kind}/{name}"] = rec

    data = np.load(sys.argv[1])
    cfg = get_arch("mixtral_8x7b").reduced()
    p = {k[2:]: jnp.asarray(data[k]) for k in data.files if k.startswith("p/")}
    with sh.activation_sharding(meshes["4x2"]):
        moe, aux = jax.jit(lambda p, x: blocks.moe_apply(p, x, cfg))(p, jnp.asarray(data["x"]))
    out["moe_out"] = np.asarray(moe).tolist()
    out["moe_aux"] = float(aux)
    print(json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX reference and the 8-rank gloo worker, run side by side."""
    tmp = tmp_path_factory.mktemp("mesh")
    cfg = get_arch("mixtral_8x7b").reduced()
    mlp = M.seeded_numpy_params(cfg, 0)["stages"]["block0"]["mlp"]
    x = np.random.default_rng(1).standard_normal((8, 16, cfg.d_model), dtype=np.float32)
    npz = tmp / "moe.npz"
    np.savez(npz, x=x, **{"p/" + k: v[0] for k, v in mlp.items()})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, "-c", JAX_REFERENCE, str(npz)], stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
    worker = subprocess.run([sys.executable, str(ROOT / "tests" / "_torch_mesh_worker.py"),
                             str(tmp / "store"), str(npz), str(tmp / "worker.json")],
                            capture_output=True, text=True, env=env, cwd=ROOT, timeout=900)
    ref_out, ref_err = ref.communicate(timeout=900)
    assert worker.returncode == 0, worker.stderr[-3000:]
    assert ref.returncode == 0, ref_err[-3000:]
    return json.loads(ref_out.strip().splitlines()[-1]), json.loads((tmp / "worker.json").read_text())


# ---------------------------------------------------------------------------
# Meshes and Sharding records (no process group)
# ---------------------------------------------------------------------------


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match=r"mesh \(4, 2\) needs 8 devices, have 0"):
        make_mesh((4, 2), ("data", "model"))
    with pytest.raises(ValueError, match=r"needs 8 devices"):
        make_test_mesh(data=2, model=2, pod=2, device_type="cpu")


def test_sharding_groups_take_mesh_dims_major_first():
    mesh = FakeMesh((2, 4, 2), ("pod", "data", "model"))
    s = sh.sharding_for(("batch", "embed"), (16, 6), mesh, sh.DEFAULT_ACT_RULES)
    assert s.spec == (("pod", "data", "model"), None)
    assert s.shard_shape((16, 6)) == (1, 6)
    # rank at (pod 1, data 2, model 1) holds row 1*8 + 2*2 + 1 = 13
    assert s.shard_slices((16, 6), (1, 2, 1)) == (slice(13, 14), slice(0, 6))
    from torch.distributed.tensor import Replicate, Shard

    assert s.placements == (Shard(0), Shard(0), Shard(0))
    r = sh.sharding_for(("embed", "mlp"), (8, 6), mesh, sh.DEFAULT_PARAM_RULES)
    assert r.placements == (Replicate(), Shard(0), Shard(1))


def test_sharding_rejects_a_group_out_of_mesh_order():
    mesh = FakeMesh((2, 2), ("data", "model"))
    with pytest.raises(ValueError, match="not in the mesh's order"):
        sh.Sharding(mesh, (("model", "data"), None))


def test_activation_sharding_is_a_scoped_context():
    mesh = FakeMesh((2, 2), ("data", "model"))
    x = torch.ones(2, 3)
    with sh.activation_sharding(mesh):
        assert sh.active_mesh() is mesh and sh.active_act_rules() is sh.DEFAULT_ACT_RULES
        assert sh.shard_hint(x, "batch", "embed") is x  # a plain tensor stays plain
    assert sh.active_mesh() is None and sh.active_act_rules() is None


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shard_shapes_and_blocks_equal_jax(runs, arch, kind, mesh_name):
    want = runs[0]["placement"][f"{arch}/{kind}/{mesh_name}"]
    shape, axes = MESHES[mesh_name]
    mesh = FakeMesh(shape, axes)
    in_specs, in_axes = specs_lib.input_specs(get_arch(arch).reduced(), _shape(kind))
    leaves, leaf_axes = _flat(in_specs), _flat(in_axes)
    assert set(leaves) == set(want)
    for name, t in leaves.items():
        s = sh.sharding_for(leaf_axes[name], tuple(t.shape), mesh, sh.DEFAULT_PARAM_RULES)
        assert list(s.shard_shape(t.shape)) == want[name]["shard_shape"], name
        got = [[[sl.start, sl.stop] for sl in s.shard_slices(t.shape, np.unravel_index(r, shape))]
               for r in range(8)]
        assert got == want[name]["blocks"], name


# ---------------------------------------------------------------------------
# Eight gloo ranks against the unsharded step and the reference
# ---------------------------------------------------------------------------

_LEAVES = sorted(_flat(M.Model(get_arch("yi_6b").reduced(), None, device="meta").stage(None)))
_MOE_LEAVES = sorted(_flat(M.Model(get_arch("mixtral_8x7b").reduced(), None,
                                   device="meta").stage(None)))
_XLSTM_LEAVES = sorted(_flat(M.Model(get_arch("xlstm_1p3b").reduced(), None,
                                     device="meta").stage(None)))


def test_sharded_loss_equals_unsharded(runs):
    assert runs[1]["train"]["loss"] <= TRAIN_TOL


@pytest.mark.parametrize("route", ["kernel", "torch"])
def test_sharded_forward_equals_unsharded(runs, route):
    """The serving forward under inference mode, on parameters placed with
    gradients on; attention through local_map on each rank's shards."""
    assert runs[1][f"forward_{route}"] <= TRAIN_TOL


@pytest.mark.parametrize("leaf", _LEAVES)
def test_sharded_gradient_equals_unsharded(runs, leaf):
    assert runs[1]["train"]["grads"][leaf] <= TRAIN_TOL


@pytest.mark.parametrize("leaf", _LEAVES)
def test_sharded_update_equals_unsharded(runs, leaf):
    assert runs[1]["train"]["params"][leaf] <= TRAIN_TOL


# The mixtral reduced step: its MoE on the sharded branch, backward through
# the two local_maps and the expert-parallel redistribution
def test_moe_sharded_train_loss_equals_unsharded(runs):
    # every MoE call of the sharded step split its tokens over the mesh
    assert runs[1]["moe_train"]["token_partitions"]
    assert all(axes == ["data", "model"] for axes in runs[1]["moe_train"]["token_partitions"])
    assert runs[1]["moe_train"]["loss"] <= TRAIN_TOL


@pytest.mark.parametrize("leaf", _MOE_LEAVES)
def test_moe_sharded_train_gradient_equals_unsharded(runs, leaf):
    assert runs[1]["moe_train"]["grads"][leaf] <= TRAIN_TOL


@pytest.mark.parametrize("leaf", _MOE_LEAVES)
def test_moe_sharded_train_update_equals_unsharded(runs, leaf):
    assert runs[1]["moe_train"]["params"][leaf] <= TRAIN_TOL


# The xlstm reduced step in float64: its gates' log-sigmoid and its mLSTM
# recurrence through local_map, forward and backward, each rank on its own
# block
def test_xlstm_sharded_train_loss_equals_unsharded(runs):
    assert runs[1]["xlstm_train"]["loss"] <= TRAIN_TOL


@pytest.mark.parametrize("leaf", _XLSTM_LEAVES)
def test_xlstm_sharded_train_gradient_equals_unsharded(runs, leaf):
    assert runs[1]["xlstm_train"]["grads"][leaf] <= TRAIN_TOL


@pytest.mark.parametrize("leaf", _XLSTM_LEAVES)
def test_xlstm_sharded_train_update_equals_unsharded(runs, leaf):
    assert runs[1]["xlstm_train"]["params"][leaf] <= TRAIN_TOL


def test_place_gives_each_rank_its_block(runs):
    assert runs[1]["blocks_equal_on_every_rank"] is True


def test_moe_sharded_dispatch_equals_reference_shard_map(runs):
    ref, got = runs
    want = np.asarray(ref["moe_out"], dtype=np.float32)
    out = np.asarray(got["moe_out"], dtype=np.float32)
    assert out.shape == want.shape == (8, 16, get_arch("mixtral_8x7b").reduced().d_model)
    rel = np.linalg.norm(out.astype(np.float64) - want) / np.linalg.norm(want)
    assert rel <= MOE_TOL, rel
    assert got["moe_aux"] == pytest.approx(ref["moe_aux"], rel=MOE_TOL)


def test_moe_on_dtensors_keeps_the_capacity_path(runs):
    """Above the compact path's rule, DTensor tokens take the sharded
    capacity dispatch (the all-to-all moves its dense buffers) and plain
    tokens the compact path; with no token dropped, one function."""
    got = runs[1]["moe_rule"]
    assert got["compact_layers"] == {"plain": 1, "dtensor": 0}
    assert got["rel"] <= MOE_TOL, got["rel"]


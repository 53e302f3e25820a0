"""The port's step-input specs against the JAX package's: for every
(arch, shape) cell of the registry, ``launch.specs.input_specs`` gives
meta tensors with the reference ``eval_shape``'s shapes and types and the
same logical-axes trees; and the step functions of ``launch.steps``."""

import numpy as np
import pytest
import torch
from _torch_reference import flat_keys

from repro.configs import registry as RR
from repro.launch import specs as RSP
from repro.launch import steps as RS
from repro.optim import adamw as RA
from repro_torch.configs import registry as TR
from repro_torch.launch import specs as TSP
from repro_torch.launch import steps as TS
from repro_torch.models import model as TM
from repro_torch.optim import adamw

CELLS = TR.all_cells()


@pytest.fixture(autouse=True)
def _few_threads():
    """The suite runs in several worker processes at once: keep this file's
    small torch programs from taking every core (where each of several
    workers spins 8 threads over tiny products, a step takes 20x longer)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _axes_leaves(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_axes_leaves(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = value
    return out


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_reference(arch, shape):
    specs, axes = TSP.input_specs(TR.get_arch(arch), TR.SHAPES[shape])
    r_specs, r_axes = RSP.input_specs(RR.get_arch(arch), RR.SHAPES[shape])
    got, want = flat_keys(specs), flat_keys(r_specs)
    assert got.keys() == want.keys()
    for key, leaf in got.items():
        assert leaf.device.type == "meta", key
        assert tuple(leaf.shape) == tuple(want[key].shape), key
        assert str(leaf.dtype).removeprefix("torch.") == str(want[key].dtype), key
    assert _axes_leaves(axes) == _axes_leaves(r_axes)


def test_train_state_specs_follow_the_moment_dtype():
    cfg = TR.get_arch("llama4_maverick_400b")
    state, axes = TSP.train_state_specs(cfg, adamw.AdamWConfig(moment_dtype="bfloat16"))
    r_state, r_axes = RSP.train_state_specs(RR.get_arch("llama4_maverick_400b"),
                                           RA.AdamWConfig(moment_dtype="bfloat16"))
    got, want = flat_keys(state), flat_keys(r_state)
    assert {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in got.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
    assert all(v.device.type == "meta" for v in got.values())
    assert _axes_leaves(axes) == _axes_leaves(r_axes)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_step_for_shape(kind):
    """Each kind's step and the arguments the reference donates (which the
    port's steps update in place); a step runs on its specs' shapes."""
    shape = {"train": TR.ShapeSpec("t", "train", 16, 2), "prefill": TR.ShapeSpec("p", "prefill", 16, 2),
             "decode": TR.ShapeSpec("d", "decode", 16, 2)}[kind]
    cfg = TR.get_arch("qwen2_vl_7b").reduced()
    fn, donate = TS.step_for_shape(cfg, shape)
    assert donate == RS.step_for_shape(RR.get_arch("qwen2_vl_7b").reduced(), shape)[1]
    specs, _ = TSP.input_specs(cfg, shape)
    rng = np.random.default_rng(0)

    def real(spec):
        if spec.dtype == torch.int32:
            return torch.from_numpy(rng.integers(0, 16, tuple(spec.shape), dtype=np.int32))
        return torch.zeros(tuple(spec.shape), dtype=spec.dtype)

    params = TM.from_reference_params(cfg, TM.seeded_numpy_params(cfg, 0)).stage(None)
    batch = adamw.tree_map(real, specs["batch"])
    if kind == "train":
        batch["positions"] = TM.default_positions(cfg, 2, 16)
        state = {"params": params, "opt_state": adamw.init_state(adamw.AdamWConfig(), params)}
        state, metrics = fn(state, batch)
        assert bool(torch.isfinite(metrics["loss"])) and int(state["opt_state"]["step"]) == 1
    elif kind == "prefill":
        batch["positions"] = TM.default_positions(cfg, 2, 16)
        logits = fn(params, batch)
        assert tuple(logits.shape) == (2, cfg.vocab_size)
    else:
        cache = adamw.tree_map(real, specs["cache"])
        cache = {k: {n: (t.fill_(-1) if n == "slot_pos" else t) for n, t in v.items()}
                 for k, v in cache.items()}
        batch["pos"] = torch.tensor(0, dtype=torch.int32)
        logits, new_cache = fn(params, cache, batch)
        assert tuple(logits.shape) == (2, cfg.vocab_size) and new_cache is cache


def test_token_shape_is_the_decode_spec_shape():
    for arch in TR.ARCH_IDS:
        cfg = TR.get_arch(arch)
        specs, _ = TSP.decode_batch_specs(cfg, TR.SHAPES["decode_32k"])
        assert tuple(specs["tokens"].shape) == TSP.token_shape(cfg, 128, 1)
        assert TSP.token_shape(cfg, 3, 7) == RSP.token_shape(RR.get_arch(arch), 3, 7)

"""The port's training path against the JAX package's, at S = 32
(``tests/test_torch_training_long.py`` holds S = 128): the ten reduced
archs' loss and every gradient leaf, three train steps, the committed
``train_reference.json``, and the cases of ``tests/test_perf_variants.py``
(chunked cross-entropy, remat modes, bf16 Mamba state),
``tests/test_archs.py:50``'s train step and ``tests/test_moe.py:100``'s
gradient flow.

Both packages run the same parameters (``seeded_numpy_params``; MoE
capacity E, no drops) on the reference pipeline's batches, in float32.
Tolerances, stated once:

* ``GRAD_RTOL = 1e-4``, relative L2 per gradient leaf (measured: at most
  8.8e-6, xLSTM's; 1e-6 on the attention archs).
* ``METRIC_RTOL = 1e-5`` on ``loss``, ``ce``, ``aux``, ``grad_norm`` and
  ``lr`` (measured: at most 2.4e-6, a grad norm after two updates).
* ``PARAM_RTOL = 1e-4``, relative L2 per parameter after three AdamW
  steps (measured: at most 1.1e-5).
* ``FILE_TOL = 1e-6`` for the rebuilt reference file against the
  committed one (XLA's CPU code follows the host's vector width).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_reference import (
    TRAIN,
    TRAIN_METRICS,
    TRAIN_REFERENCE_PATH,
    build_train_reference,
    flat_keys,
    port_loss_and_grads,
    reference_train_run,
    stream_batch,
    train_batches,
    train_cfg,
)
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as RR
from repro.launch import steps as RS
from repro.optim import adamw as RA
from repro_torch.configs import registry as TR
from repro_torch.data.pipeline import DataConfig, batch_at_step
from repro_torch.launch import steps as TS
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.optim import adamw

GRAD_RTOL = 1e-4
METRIC_RTOL = 1e-5
PARAM_RTOL = 1e-4
FILE_TOL = 1e-6
ARCH_IDS = TR.ARCH_IDS


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


def rel_l2(got, want) -> float:
    want = np.asarray(want, np.float64)
    diff = np.linalg.norm(np.asarray(got, np.float64) - want)
    return float(diff / np.linalg.norm(want)) if np.any(want) else float(diff)


def check_metrics(got: dict, want: dict, rtol: float) -> None:
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=rtol, abs=1e-12), key


def check_loss_and_grads(arch: str, seq: int, steps: int) -> None:
    """The port's loss and gradient at the first batch against the
    reference run's, leaf by leaf."""
    run = reference_train_run(arch, seq, steps)
    cfg = train_cfg(TR.get_arch(arch).reduced())
    values, grads = port_loss_and_grads(cfg, TRAIN["seed"], train_batches(cfg, seq, 1)[0])
    check_metrics(values, {k: run["metrics"][0][k] for k in ("loss", "ce", "aux")}, METRIC_RTOL)
    assert set(grads) == set(run["grads"])
    for key, want in run["grads"].items():
        assert grads[key].shape == want.shape, key
        assert rel_l2(grads[key], want) <= GRAD_RTOL, (key, rel_l2(grads[key], want))


def check_file_part(part: str) -> None:
    """The JAX package computes today what the committed file holds."""
    built = build_train_reference(part)
    have = json.loads(TRAIN_REFERENCE_PATH.read_text())
    assert {k: v for k, v in built.items() if k != "archs"} == {
        k: v for k, v in have.items() if k != "archs"}
    assert set(built["archs"]) == set(have["archs"]) == set(ARCH_IDS)

    def close(got, want, where):
        if isinstance(want, dict):
            assert set(got) == set(want), where
            for key in want:
                close(got[key], want[key], f"{where}/{key}")
        elif isinstance(want, list):
            assert len(got) == len(want), where
            for i, (g, w) in enumerate(zip(got, want)):
                close(g, w, f"{where}[{i}]")
        else:
            assert got == pytest.approx(want, rel=FILE_TOL, abs=1e-9), where

    for arch, doc in built["archs"].items():
        close(doc, {k: have["archs"][arch][k] for k in doc}, arch)
    # the port's pipeline draws the file's token streams on this machine
    for arch, doc in have["archs"].items():
        cfg = TR.get_arch(arch).reduced()
        if part == "steps":
            want, seq = doc["streams"], TRAIN["seq"]
        else:
            want, seq = [doc["long"]["stream"]], TRAIN["long_seq"]
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=TRAIN["batch"],
                          num_codebooks=cfg.num_codebooks, seed=TRAIN["seed"])
        for step, stream in enumerate(want):
            batch = batch_at_step(data, step)
            for key, value in stream_batch(stream).items():
                assert np.array_equal(batch[key], value), (arch, step, key)


def _batch(cfg, seed, b=2, s=32):
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape, dtype=np.int32))
    return {"tokens": toks, "labels": toks}


def _loss_and_grads(cfg, params, batch):
    """(loss, metrics, gradient leaves by key) of the port on ``params``."""
    flat = flat_keys(params)
    loss, metrics = TM.loss_fn(cfg, params, batch)
    return loss, metrics, dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))


def _params(cfg, seed=0):
    return TM.from_reference_params(cfg, TM.seeded_numpy_params(cfg, seed)).stage(None)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    check_loss_and_grads(arch, TRAIN["seq"], TRAIN["steps"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_steps_match_reference(arch):
    """Three ``make_train_step`` steps with ``AdamWConfig()``: each step's
    metrics, then every parameter, against the reference's."""
    run = reference_train_run(arch, TRAIN["seq"], TRAIN["steps"])
    cfg = train_cfg(TR.get_arch(arch).reduced())
    opt_cfg = adamw.AdamWConfig()
    params = _params(cfg, TRAIN["seed"])
    state = {"params": params, "opt_state": adamw.init_state(opt_cfg, params)}
    step_fn = TS.make_train_step(cfg, opt_cfg)
    for want, batch in zip(run["metrics"], train_batches(cfg, TRAIN["seq"], TRAIN["steps"])):
        state, metrics = step_fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(metrics) == set(TRAIN_METRICS)
        assert all(m.dtype == torch.float32 and m.dim() == 0 for m in metrics.values())
        check_metrics({k: float(v) for k, v in metrics.items()}, want, METRIC_RTOL)
    assert state["params"] is params and int(state["opt_state"]["step"]) == TRAIN["steps"]
    got = flat_keys(state["params"])
    for key, want in run["params"].items():
        assert rel_l2(got[key].detach().numpy(), want) <= PARAM_RTOL, key


@pytest.mark.parametrize("compression", ["none", "bf16"])
def test_train_step_matches_reference_make_train_step(compression):
    """The reference's own jitted ``make_train_step`` (with its gradient
    compression hook) against the port's, two steps on yi_6b."""
    rcfg, tcfg = RR.get_arch("yi_6b").reduced(), TR.get_arch("yi_6b").reduced()
    tree = TM.seeded_numpy_params(tcfg, 1)
    r_state = {"params": jax.tree.map(jnp.asarray, tree)}
    r_state["opt_state"] = RA.init_state(RA.AdamWConfig(), r_state["params"])
    r_step = jax.jit(RS.make_train_step(rcfg, RA.AdamWConfig(), compression))
    params = _params(tcfg, 1)
    state = {"params": params, "opt_state": adamw.init_state(adamw.AdamWConfig(), params)}
    step_fn = TS.make_train_step(tcfg, adamw.AdamWConfig(), compression)
    for batch in train_batches(tcfg, 16, 2):
        r_state, r_metrics = r_step(r_state, jax.tree.map(jnp.asarray, batch))
        state, metrics = step_fn(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        check_metrics({k: float(v) for k, v in metrics.items()},
                      {k: float(v) for k, v in r_metrics.items()}, METRIC_RTOL)
    want = flat_keys(r_state["params"])
    for key, value in flat_keys(state["params"]).items():
        assert rel_l2(value.detach().numpy(), want[key]) <= PARAM_RTOL, key


def test_train_reference_file_is_current():
    check_file_part("steps")


# ---------------------------------------------------------------------------
# test_perf_variants.py: the perf levers leave the math as it is
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["yi_6b", "mixtral_8x7b"])
def test_chunked_ce_matches_full(arch):
    cfg0 = TR.get_arch(arch).reduced()
    cfg1 = dataclasses.replace(cfg0, loss_chunk=8)  # 32/8 = 4 chunks
    params = _params(cfg0)
    batch = _batch(cfg0, 0)
    l0, _, g0 = _loss_and_grads(cfg0, params, batch)
    l1, _, g1 = _loss_and_grads(cfg1, params, batch)
    assert l0.item() == pytest.approx(l1.item(), rel=1e-6)
    for key in g0:
        np.testing.assert_allclose(g0[key].numpy(), g1[key].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("remat", ["block", "dots", "none", "full"])
def test_remat_matches_stage_remat(remat):
    """Remat never changes values: jamba's heterogeneous 8-block stage
    under each mode against "stage" (the reference's test holds "block"
    to rtol 1e-5; the port's recompute repeats the same kernels, so the
    values are equal)."""
    cfg0 = dataclasses.replace(TR.get_arch("jamba_v01_52b").reduced(), n_layers=16)
    cfg1 = dataclasses.replace(cfg0, remat=remat)
    params = _params(cfg0, 1)
    batch = _batch(cfg0, 1, s=16)
    l0, m0, g0 = _loss_and_grads(cfg0, params, batch)
    l1, m1, g1 = _loss_and_grads(cfg1, params, batch)
    assert torch.equal(l0, l1) and torch.equal(m0["aux"], m1["aux"])
    for key in g0:
        assert torch.equal(g0[key], g1[key]), key


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.products = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                    torch.ops.aten.addmm.default):
            self.products += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", ["stage", "dots", "none", "block"])
def test_remat_places_its_checkpoints(remat):
    """The backward's matrix products: "stage" and "block" recompute the
    forward's, "dots" saves them (its backward runs as many as "none")."""
    cfg = dataclasses.replace(TR.get_arch("yi_6b").reduced(), remat=remat, n_layers=2)
    params = _params(cfg)
    flat = flat_keys(params)
    loss, _ = TM.loss_fn(cfg, params, _batch(cfg, 2, s=16))
    with _CountProducts() as counter:
        torch.autograd.grad(loss, list(flat.values()))
    cfg_none = dataclasses.replace(cfg, remat="none")
    loss, _ = TM.loss_fn(cfg_none, params, _batch(cfg, 2, s=16))
    with _CountProducts() as baseline:
        torch.autograd.grad(loss, list(flat.values()))
    if remat in ("dots", "none"):
        assert counter.products == baseline.products
    else:
        assert counter.products > baseline.products


def test_bf16_mamba_state_bounded_deviation():
    cfg0 = TR.get_arch("jamba_v01_52b").reduced()
    cfg1 = dataclasses.replace(cfg0, mamba_state_dtype="bfloat16")
    params = _params(cfg0, 2)
    batch = _batch(cfg0, 2, s=32)
    l0, _, g0 = _loss_and_grads(cfg0, params, batch)
    l1, _, g1 = _loss_and_grads(cfg1, params, batch)
    # bf16 state is an approximation: <1% loss deviation and bounded
    # relative grad-norm deviation, the reference's bounds
    assert l1.item() == pytest.approx(l0.item(), rel=1e-2)
    n0 = np.sqrt(sum(float(g.double().square().sum()) for g in g0.values()))
    n1 = np.sqrt(sum(float(g.double().square().sum()) for g in g1.values()))
    assert n1 == pytest.approx(n0, rel=0.05)


# ---------------------------------------------------------------------------
# test_archs.py's train step, test_moe.py's gradient flow, the routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_train_step(arch):
    """The port's own seeded init: a finite loss, a gradient for every
    parameter and a positive norm; the state keeps its structure."""
    cfg = TR.get_arch(arch).reduced()
    params = TM.init_params(cfg, torch.Generator().manual_seed(0))[0].stage(None)
    opt_cfg = adamw.AdamWConfig()
    state = {"params": params, "opt_state": adamw.init_state(opt_cfg, params)}
    state, metrics = TS.make_train_step(cfg, opt_cfg)(state, _batch(cfg, 0))
    assert bool(torch.isfinite(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert flat_keys(state["opt_state"]["m"]).keys() == flat_keys(params).keys()
    assert all(bool(m.any()) for m in flat_keys(state["opt_state"]["m"]).values())


def test_moe_gradients_flow_to_all_parts():
    cfg = TR.get_arch("mixtral_8x7b").reduced()
    p = TB.Moe(torch.Generator().manual_seed(3), cfg, None).stage(None)
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(4))
    out, aux = TB.moe_apply(p, x, cfg)
    loss = (out ** 2).sum() + 0.01 * aux
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert float(grads[name].abs().sum()) > 0, f"no grad for {name}"


def test_loss_kernel_route_raises_with_gradients():
    """K7 is forward only: the kernel route raises in a differentiable
    loss and never falls back; without gradients it evaluates, within
    1e-5 of the torch route (K7's plain version on the CPU)."""
    cfg = TR.get_arch("qwen3_8b").reduced()
    params = _params(cfg)
    batch = _batch(cfg, 3)
    with pytest.raises(ValueError, match="no backward"):
        TM.loss_fn(cfg, params, batch, attention="kernel")
    with torch.no_grad():
        kernel, _ = TM.loss_fn(cfg, params, batch, attention="kernel")
        plain, _ = TM.loss_fn(cfg, params, batch)
    assert float(kernel) == pytest.approx(float(plain), rel=1e-5)
    with pytest.raises(ValueError, match="attention route"):
        TM.loss_fn(cfg, params, batch, attention="flash")


def test_checks_of_the_step_options():
    cfg = dataclasses.replace(TR.get_arch("yi_6b").reduced(), remat="everything")
    with pytest.raises(ValueError, match="remat"):
        TM.loss_fn(cfg, _params(cfg), _batch(cfg, 0))
    with pytest.raises(ValueError, match="grad_compression"):
        TS.make_train_step(cfg, adamw.AdamWConfig(), "int4")


def test_serving_entry_points_build_no_graph():
    """Parameters carry gradients, and the serving entry points still run
    under inference mode: no graph, the same logits as the loss's body."""
    cfg = TR.get_arch("yi_6b").reduced()
    model = TM.from_reference_params(cfg, TM.seeded_numpy_params(cfg, 0))
    assert all(p.requires_grad for p in model.parameters())
    toks = _batch(cfg, 5)["tokens"]
    logits, _ = TM.forward(cfg, model, toks)
    assert not logits.requires_grad and logits.is_inference()
    x, _ = TM._hidden(cfg, model, toks, None, "torch")
    assert x.requires_grad
    assert torch.equal(TM._head(cfg, model, x).detach(), logits)

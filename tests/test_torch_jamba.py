"""Jamba's mixer in the port on the CPU: the inner RMSNorms on dt, B and C
(``cfg.mamba_inner_norms``), the scan's two routes and L3's plain version,
and the whole model against the benchmark's plain reference
(``portbench/reference/jamba.py``) at a small size with seeded weights.

The small config is Jamba-shaped: one 8-layer period (attention at 4,
Mamba elsewhere, the MoE at odd layers), the inner norms on, no RoPE and
un-renormalised top-2 gates, in float32, at 64 tokens with a scan chunk
of 16 (four chunks), on the reference's long-memory draws.  Tolerances:

* the port against the reference, ``REF_TOL`` = 1e-5 relative L2 of the
  last position's logits: float32 on both sides, summed in other orders
  (the Hillis-Steele scan against the token-by-token recurrence, blockwise
  attention, index-add against the capacity buffers); about 3e-6 read;
* the port against the JAX package with the norms off, ``JAX_TOL`` = 1e-4,
  the port's model-level tolerance against the reference
  (``test_torch_decode_consistency.py``);
* decode after forward against forward, ``DECODE_TOL`` = 2e-3, the
  reference's decode tolerance.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.registry import get_arch as ref_arch
from repro.models import ssm as RS
from repro_torch.configs.registry import get_arch
from repro_torch.kernels.selective_scan import kernel as L3
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.kernels.selective_scan.ref import selective_scan_ref
from repro_torch.models import model as TM
from repro_torch.models import ssm

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))  # the benchmark's reference and harness

from portbench import check, harness  # noqa: E402
from portbench.reference import _plain  # noqa: E402

REF_TOL = 1e-5
JAX_TOL = 1e-4
DECODE_TOL = 2e-3
SEQ, CHUNK = 64, 16

SMALL = {"n_layers": 8, "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 32,
         "d_ff": 96, "vocab_size": 256, "num_experts": 4, "top_k": 2, "capacity_factor": 2.0,
         "renormalize_topk": False, "rope_kind": "none", "window": None, "mamba_d_state": 16,
         "mamba_d_conv": 4, "mamba_expand": 2, "mamba_dt_rank": 8, "mamba_inner_norms": True,
         "attn_layer_offset": 4, "attn_layer_period": 8, "expert_layer_offset": 1,
         "expert_layer_period": 2, "rms_eps": 1e-6}
_NOT_PORT = ("attn_layer_offset", "attn_layer_period", "expert_layer_offset",
             "expert_layer_period", "rms_eps")


@pytest.fixture(autouse=True)
def _few_threads():
    """The suite runs in several worker processes at once: keep this file's
    torch programs from taking every core."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _doc(dtype: str = "float32", **sizes) -> dict:
    model = dict(SMALL, **sizes)
    replace = {k: v for k, v in model.items() if k not in _NOT_PORT}
    return {"name": "small_jamba", "source": "test", "family": "jamba", "dtype": dtype,
            "port": {"arch": "jamba_v01_52b", "replace": dict(replace, scan_chunk=CHUNK)},
            "model": model, "reduced": [], "assumed": {}, "deployment": "test"}


def _family():
    return harness.load_module(harness.PKG / "reference" / "jamba.py")


def _setup(seed: int = 3, dtype: str = "float32", batch: int = 3, seq: int = SEQ, **sizes):
    doc = _doc(dtype, **sizes)
    cfg = harness.port_config(doc)
    family = _family()
    weights = harness.draw_weights(family.param_specs(doc["model"]), seed, "cpu",
                                   getattr(torch, dtype))
    tokens = torch.randint(0, doc["model"]["vocab_size"], (batch, seq),
                           generator=torch.Generator().manual_seed(seed), dtype=torch.int32)
    return doc, cfg, family, weights, tokens


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()


# ---------------------------------------------------------------------------
# The model against the plain reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("attention", ["torch", "kernel"])
def test_port_matches_the_jamba_reference(attention, seed):
    doc, cfg, family, weights, tokens = _setup(seed)
    assert SEQ // cfg.scan_chunk >= 2 and cfg.rope_kind == "none" and not cfg.renormalize_topk
    program = harness.load_program(cfg, weights)
    got = TM.forward(cfg, program, tokens, last_only=True, attention=attention)[0]
    want = family.last_logits(doc["model"], weights, tokens)
    assert got.shape == want.shape == (3, doc["model"]["vocab_size"])
    assert _rel(got, want) < REF_TOL


def test_the_program_carries_the_reference_weights_by_name():
    doc, cfg, family, weights, _ = _setup()
    state = harness.load_program(cfg, weights).state_dict()
    assert set(state) == set(weights)
    assert {"stages.block0.mixer.dt_norm", "stages.block0.mixer.b_norm",
            "stages.block0.mixer.c_norm"} <= set(state)
    assert not any(k.startswith("stages.block4.mixer.") and "norm" in k for k in state)


def test_the_draws_keep_a_long_memory():
    """At least 1% of the (token, channel, state) decays of the first Mamba
    layer lie within 0.1% of one: state carried across the whole prompt."""
    doc, _, family, weights, tokens = _setup()
    model = doc["model"]
    mixer = _plain.layer_weights(weights, "stages.block0.mixer.", 0)
    x = _plain.rms_norm(weights["embed"][tokens.long()], weights["stages.block0.ln1"][0], 1e-6)
    di = model["mamba_expand"] * model["d_model"]
    padded = F.pad((x @ mixer["in_proj"])[..., :di], (0, 0, 3, 0))
    x_act = F.silu(mixer["conv_b"] + sum(padded[:, i:i + SEQ] * mixer["conv_w"][i]
                                         for i in range(4)))
    delta, _, _ = family._mamba_params(model, mixer, x_act, _plain.f32_mm)
    slow = (delta[..., None] * torch.exp(mixer["A_log"])) < 1e-3
    assert slow.float().mean().item() >= 0.01


def test_a_dropped_state_carry_fails_the_comparison(monkeypatch):
    """The chunked scan with its state dropped between chunks reads far
    beyond the tolerance against the reference, and fails the Jamba
    cell's limits."""
    doc, cfg, family, weights, tokens = _setup()
    program = harness.load_program(cfg, weights)
    want = family.last_logits(doc["model"], weights, tokens)
    real = ssm._ssm_chunk
    monkeypatch.setattr(ssm, "_ssm_chunk", lambda h0, a, b: real(torch.zeros_like(h0), a, b))
    got = TM.forward(cfg, program, tokens, last_only=True)[0]
    assert _rel(got, want) > 1000 * REF_TOL
    limits = check.load_limits("jamba2_mini.prefill_long")
    assert not check.judge(check.numbers(got, list(want)), limits)[0]


def test_last_token_paths_at_margin_nought_are_the_reference():
    """The candidates' first row, rebuilt from each layer's keys and values
    or convolution window and state, is the full pass's last row."""
    doc, _, family, weights, tokens = _setup()
    want = family.last_logits(doc["model"], weights, tokens)
    got = family.last_logit_candidates(doc["model"], weights, tokens, 0.0)
    assert [c.shape[0] for c in got] == [1, 1, 1]
    assert _rel(torch.cat(got), want) < REF_TOL
    wide = family.last_logit_candidates(doc["model"], weights, tokens, 10.0)
    assert all(c.shape[0] > 1 and torch.allclose(c[0], w, rtol=1e-5, atol=1e-5)
               for c, w in zip(wide, want))


def test_active_matmul_params_count_the_ports_products():
    doc = json.loads((harness.PKG / "configs" / "jamba2_mini.json").read_text())
    cfg = harness.port_config(doc)
    shapes, _ = TM.shapes_and_axes(cfg)
    products = ("in_proj", "x_proj", "dt_proj", "out_proj", "wq", "wk", "wv", "wo", "router",
                "w_gate", "w_up", "w_down")
    total = 0
    for name, leaf in TM._flatten(shapes).items():
        if name.startswith("stages.") and name.rsplit(".", 1)[-1] in products:
            expert = leaf.ndim == 4 and ".mlp." in name
            total += leaf.numel() * cfg.top_k // cfg.num_experts if expert else leaf.numel()
    assert _family().active_matmul_params(doc["model"]) == total == 5_783_945_216


# ---------------------------------------------------------------------------
# The inner norms, the routes and L3's plain version
# ---------------------------------------------------------------------------


def _mixer_params(cfg, seed: int):
    tree = TM.seeded_numpy_params(cfg, seed)["stages"]["block0"]["mixer"]
    return tree, {k: torch.from_numpy(np.asarray(v)[0]) for k, v in tree.items()}


def test_without_inner_norms_the_mamba_mixer_is_the_jax_packages():
    """Norms off (every registry entry): the port's mixer holds the JAX
    package's parameters and computes its function; on, it holds three
    more and computes another."""
    cfg = get_arch("jamba_v01_52b").reduced()
    rcfg = ref_arch("jamba_v01_52b").reduced()
    assert not cfg.mamba_inner_norms
    tree, p = _mixer_params(cfg, 5)
    x = np.random.default_rng(5).standard_normal((2, 48, cfg.d_model), dtype=np.float32)
    got = ssm.mamba_apply(p, torch.from_numpy(x), cfg).numpy()
    want = np.asarray(RS.mamba_apply(jax.tree.map(lambda v: jnp.asarray(v[0]), tree),
                                     jnp.asarray(x), rcfg))
    np.testing.assert_allclose(got, want, rtol=JAX_TOL, atol=JAX_TOL)
    on = dataclasses.replace(cfg, mamba_inner_norms=True)
    _, p_on = _mixer_params(on, 5)
    assert set(p_on) - set(p) == {"dt_norm", "b_norm", "c_norm"}
    normed = ssm.mamba_apply(p_on, torch.from_numpy(x), on).numpy()
    assert np.abs(normed - want).max() > 100 * JAX_TOL


def test_decode_after_forward_matches_forward_with_the_norms():
    """The cache filled by decoding a prompt, then one more decode step,
    against the forward's last position over the longer prompt."""
    cfg = dataclasses.replace(get_arch("jamba_v01_52b").reduced(), mamba_inner_norms=True,
                              rope_kind="none", renormalize_topk=False, capacity_factor=4.0)
    params = TM.from_reference_params(cfg, TM.seeded_numpy_params(cfg, 7))
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 33)))
    want = TM.forward(cfg, params, tokens, last_only=True)[0]
    _, cache = TM.prefill_with_cache(cfg, params, tokens[:, :-1], cache_seq_len=33)
    got, _ = TM.decode_step(cfg, params, cache, tokens[:, -1:], 32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=DECODE_TOL, atol=DECODE_TOL)


def _operand(device: str, requires_grad: bool = False, *, shape=(2, 64, 512), n_state=16,
             dtype=torch.bfloat16):
    """A stand-in with what ``scan_route`` reads of a tensor: the
    activations of ``shape`` and an A_log of ``n_state`` states."""
    return (SimpleNamespace(device=SimpleNamespace(type=device), requires_grad=requires_grad,
                            shape=shape, dtype=dtype),
            SimpleNamespace(device=SimpleNamespace(type=device), requires_grad=False,
                            shape=(shape[-1], n_state), dtype=torch.float32))


def test_the_scan_route_is_fixed_by_the_inputs():
    assert ssm.scan_route(*_operand("cuda")) == "kernel"
    assert ssm.scan_route(torch.zeros(1, 1, 16), torch.zeros(16, 16)) == "chunked"
    with torch.no_grad():
        assert ssm.scan_route(*_operand("cuda", requires_grad=True)) == "kernel"
    with torch.enable_grad():
        assert ssm.scan_route(*_operand("cuda", requires_grad=True)) == "chunked"
        assert ssm.scan_route(*_operand("cuda")) == "kernel"
    with torch.inference_mode():
        assert ssm.scan_route(*_operand("cuda", requires_grad=True)) == "kernel"
    # out of L3's contract the chunked scan runs, as before the kernel
    assert ssm.scan_route(*_operand("cuda", dtype=torch.float32)) == "kernel"
    assert ssm.scan_route(*_operand("cuda", dtype=torch.float16)) == "chunked"
    assert ssm.scan_route(*_operand("cuda", n_state=8)) == "chunked"
    assert ssm.scan_route(*_operand("cuda", shape=(2, 64, 520))) == "chunked"
    assert ssm.scan_route(*_operand("cuda", shape=(65536, 1, 512))) == "chunked"


def _scan_operands(seed: int, b: int, s: int, di: int, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(dtype)

    return (draw(b, s, di), draw(b, s, di, scale=3.0), draw(b, s, di), draw(b, s, 16),
            draw(b, s, 16), -torch.exp(draw(di, 16, scale=2.0).float()), draw(di).float(),
            draw(di, scale=3.0).float())


@pytest.mark.parametrize("b,s,di", [(1, 1, 32), (2, 65, 64), (3, 130, 32)])
def test_plain_scan_matches_the_oracle_and_the_chunked_route(b, s, di):
    """L3's plain version (its chunk's edges at 64 and 128 tokens) against
    the float64 recurrence, and the chunked route against both."""
    ops = _scan_operands(b * s + di, b, s, di)
    want = selective_scan_ref(*ops)
    plain = L3.selective_scan_fwd(*ops)  # a CPU tensor: the plain version
    assert plain.dtype == torch.float32 and plain.shape == (b, s, di)
    assert _rel(plain.reshape(-1, di), want.reshape(-1, di)) < 1e-5
    u, dt, z, bm, cm, a, d, bias = ops
    cfg = dataclasses.replace(get_arch("jamba_v01_52b").reduced(), scan_chunk=16)
    p = {"A_log": torch.log(-a), "D": d, "dt_bias": bias}
    chunked = ssm._chunked_scan(p, u, z, dt, bm, cm, cfg, cfg.scan_chunk)
    assert _rel(chunked.reshape(-1, di), want.reshape(-1, di)) < 1e-5
    exact = L3.selective_scan_fwd_plain(*(x.double() for x in ops))
    assert exact.dtype == torch.float64 and _rel(exact, want) < 1e-12


def test_the_plain_scan_takes_strided_views():
    u, dt, z, bm, cm, a, d, bias = _scan_operands(1, 2, 40, 64)
    xz = torch.cat([u, z], dim=-1)
    dbc = torch.cat([torch.zeros(2, 40, 8), bm, cm], dim=-1)
    got = L3.selective_scan_fwd(xz[..., :64], dt, xz[..., 64:], dbc[..., 8:24], dbc[..., 24:],
                                a, d, bias)
    assert torch.equal(got, L3.selective_scan_fwd(u, dt, z, bm, cm, a, d, bias))


def test_the_public_entry_takes_numpy_on_the_cpu_engine():
    ops = _scan_operands(3, 2, 33, 32)
    got = selective_scan(*(x.numpy() for x in ops), engine="torch")
    assert torch.equal(got, L3.selective_scan_fwd(*ops))


def test_the_wrapper_checks_its_operands():
    ops = list(_scan_operands(2, 1, 8, 32))
    with pytest.raises(ValueError):
        L3.selective_scan_fwd(*ops[:3], ops[3][..., :8], *ops[4:])
    with pytest.raises(TypeError):
        L3.selective_scan_fwd(ops[0].double(), *ops[1:])
    before = L3.selective_scan_fwd.launches
    L3.selective_scan_fwd(*ops)
    assert L3.selective_scan_fwd.launches == before  # the CPU takes the plain version


# ---------------------------------------------------------------------------
# The benchmark's cell, at a small size, through the harness on the CPU
# ---------------------------------------------------------------------------

RUNNER = """
import json, sys, time
import torch
from portbench import harness, faults
program = harness.forward
if sys.argv[2] == "altered_token":
    program = lambda cfg, model, tokens: faults.altered_token(harness.forward(cfg, model, tokens))
sys.exit(harness.execute(sys.argv[1], 2**31 + 17, 0.5, True, device=torch.device("cpu"),
                         t0=time.perf_counter(), program=program))
"""


@pytest.fixture(scope="module")
def small_cell(tmp_path_factory):
    """A checkout holding the benchmark and the cell ``small_jamba.tiny_chat``,
    whose limits are the Jamba cell's own."""
    from portbench.tests.conftest import make_copy

    root = make_copy(tmp_path_factory.mktemp("jamba"))
    pkg = root / "portbench"
    (pkg / "configs" / "small_jamba.json").write_text(json.dumps(_doc()))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "small_jamba.tiny_chat", "config": "small_jamba",
                               "traffic": "tiny_chat", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (pkg / "limits" / "small_jamba.tiny_chat.json").write_text(
        (pkg / "limits" / "jamba2_mini.prefill_long.json").read_text())
    return root


def _run_cell(root: Path, fault: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(ROOT / "src")]),
               OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", RUNNER, "small_jamba.tiny_chat", fault],
                          cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fault,correct", [("none", True), ("altered_token", False)])
def test_the_harness_runs_a_small_jamba_cell(small_cell, fault, correct):
    result = _run_cell(small_cell, fault)
    assert result["correct"] is correct, result["checks"]
    assert result["device"] == {"platform": "cpu", "kind": "cpu", "count": 1}
    assert result["metrics"] == {}  # no device metric from a CPU run


# The control's sizes: one 8-layer period of 16 experts, 512 wide.  (At
# such a size the Mixtral chat limits' control reads 0.13, under their
# 0.15: they rest on the card's readings, where the control's largest
# prompt of a run reads 0.23-0.32; PERF.md section 4.)
CONTROL_SIZES = {"n_layers": 8, "d_model": 512, "num_heads": 8, "num_kv_heads": 2, "head_dim": 64,
                 "d_ff": 1536, "vocab_size": 8192, "num_experts": 16, "mamba_dt_rank": 32,
                 "capacity_factor": 8.0}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_the_jamba_cells_limits(seed):
    """At a size a test can hold, the program in bf16 passes the Jamba
    cell's limits and the control (the reference with every weight
    product in float8 e4m3) fails them."""
    limits = check.load_limits("jamba2_mini.prefill_long")
    doc, cfg, family, weights, tokens = _setup(seed, "bfloat16", batch=4, seq=256, **CONTROL_SIZES)
    program = harness.forward(cfg, harness.load_program(cfg, weights), tokens).float()
    ref = family.last_logit_candidates(doc["model"], weights, tokens,
                                       limits["route_margin"]["value"])
    control = family.last_logits(doc["model"], weights, tokens, mm=_plain.fp8_mm)
    assert check.judge(check.numbers(program, ref), limits)[0]
    assert not check.judge(check.numbers(control, ref), limits)[0]

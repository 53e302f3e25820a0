"""The port's model stack against the JAX package's, case by case from
``tests/test_archs.py`` (its gradient step is in ``test_torch_training.py``),
plus the layers function by function, the parameter
trees leaf for leaf, the attention routes, and the committed
``models_reference.json``.

Both packages run the same parameters (``seeded_numpy_params``, loaded by
the port through ``from_reference_params``) on the same seeded numpy
tokens, in float32.  Tolerances, stated once:

* ``RTOL = ATOL = 1e-4`` for the port against the reference, logits and
  caches.  Both compute in float32; only the order of the sums differs
  (torch's matmuls, the Hillis-Steele scan in place of
  ``lax.associative_scan``).  The largest difference measured on the ten
  reduced archs is about 2e-5, on logits of magnitude 4-24.
* ``ROUTE_TOL = 1e-5`` (rtol and atol) for the "kernel" route against the
  "torch" route on the CPU: the kernel route is K7's plain version, one
  dense f32 softmax, where the torch route is the reference's (blockwise
  above ``attn_chunk``).
* ``BF16_REL = 5e-3``, relative L2, for bf16 logits against the
  reference's in bf16: the same roundings but where float32 sums in
  another order round to another bf16 neighbour.
* ``FILE_TOL = 1e-6`` (rtol and atol) for the rebuilt reference file
  against the committed one: XLA compiles its CPU code for the host's
  vector width, so the last bits of a float32 sum may differ between
  hosts.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_reference import (
    MODELS,
    MODELS_REFERENCE_PATH,
    build_models_reference,
    decode_f32,
    models_case,
)

from repro.configs import registry as RR
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import registry as TR
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

RTOL = ATOL = 1e-4
ROUTE_TOL = 1e-5
FILE_TOL = 1e-6
BF16_REL = 5e-3
ARCH_IDS = TR.ARCH_IDS
ATTENTION_ARCHS = [a for a in ARCH_IDS if any(m == "attn" for m, _ in TR.get_arch(a).stage_pattern)]

# published sizes (total params, billions) with tolerance bands (test_archs.py)
EXPECTED_B = {
    "musicgen_medium": (1.38, 0.3),
    "jamba_v01_52b": (52, 3),
    "qwen2_vl_7b": (7.6, 0.8),
    "xlstm_1p3b": (2.0, 0.7),
    "granite_20b": (20, 1.5),
    "yi_6b": (6, 0.5),
    "qwen15_4b": (4, 0.4),
    "qwen3_8b": (8.2, 0.6),
    "llama4_maverick_400b": (400, 15),
    "mixtral_8x7b": (46.7, 2),
}
ACTIVE_B = {"llama4_maverick_400b": (17, 3), "mixtral_8x7b": (12.9, 1.5)}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


@functools.lru_cache(maxsize=None)
def _pair(arch: str, seed: int = 0):
    """(reference cfg, port cfg, reference params, port params) of the
    reduced ``arch`` on the seeded numpy parameters."""
    rcfg, tcfg = RR.get_arch(arch).reduced(), TR.get_arch(arch).reduced()
    tree = TM.seeded_numpy_params(tcfg, seed)
    return rcfg, tcfg, jax.tree.map(jnp.asarray, tree), TM.from_reference_params(tcfg, tree)


def _tokens(cfg, seed, b, s):
    rng = np.random.default_rng(seed)
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    return rng.integers(0, cfg.vocab_size, shape, dtype=np.int32)


# ---------------------------------------------------------------------------
# Parameter counts, shapes and axes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_count(arch):
    """Equal integers, total and active, for every full config (and within
    the reference test's published-size bands)."""
    rcfg, tcfg = RR.get_arch(arch), TR.get_arch(arch)
    n = TM.count_params_analytic(tcfg)
    assert n == RM.count_params_analytic(rcfg)
    assert tcfg.param_count() == rcfg.param_count() == n
    assert tcfg.active_param_count() == rcfg.active_param_count()
    assert TM.count_params_analytic(tcfg, exclude_embed=True) == RM.count_params_analytic(
        rcfg, exclude_embed=True)
    want, tol = EXPECTED_B[arch]
    assert abs(n / 1e9 - want) <= tol, f"{arch}: {n / 1e9:.2f}B vs {want}B"
    if arch in ACTIVE_B:
        want_a, tol_a = ACTIVE_B[arch]
        assert abs(tcfg.active_param_count() / 1e9 - want_a) <= tol_a


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_and_axes_equal_reference(arch):
    """Leaf for leaf: the same names, shapes, types and logical axes, built
    on the meta device (no allocation, Llama-4 Maverick's 400B included)."""
    shapes, axes = TM.shapes_and_axes(TR.get_arch(arch))
    r_shapes, r_axes = RM.shapes_and_axes(RR.get_arch(arch))
    got, want = _flat(shapes), _flat(r_shapes)
    assert set(got) == set(want)
    for name, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(want[name].shape), name
        assert str(leaf.dtype).removeprefix("torch.") == str(want[name].dtype), name
    assert _flat(axes) == _flat(r_axes)


@pytest.mark.parametrize("arch", ["qwen3_8b", "jamba_v01_52b", "musicgen_medium"])
def test_init_params_follows_the_reference_init(arch):
    """The port's own seeded init: the reference's tree, its constant leaves
    (ones and zeros exactly; Mamba's log(1..N) within torch's and XLA's
    last-bit difference in ``log``) and its fan-in scales; seeded."""
    cfg = TR.get_arch(arch).reduced()
    params, axes = TM.init_params(cfg, torch.Generator().manual_seed(3))
    r_params, r_axes = RM.init_params(RR.get_arch(arch).reduced(), jax.random.PRNGKey(3))
    got, want = _flat(params.stage(None)), _flat(r_params)
    assert set(got) == set(want) and _flat(axes) == _flat(r_axes)
    assert all(value.requires_grad for value in got.values())  # trainable
    got = {name: value.detach() for name, value in got.items()}
    again, _ = TM.init_params(cfg, torch.Generator().manual_seed(3))
    for name, value in got.items():
        ref = np.asarray(want[name])
        if name.endswith("A_log"):
            np.testing.assert_allclose(value.numpy(), ref, rtol=1e-6, atol=0, err_msg=name)
        elif np.all(ref == ref.flat[0]):
            np.testing.assert_array_equal(value.numpy(), ref, err_msg=name)
        else:
            assert abs(value.std().item() / ref.std() - 1) < 0.25, name
        assert torch.equal(value, _flat(again.stage(None))[name])


def test_from_reference_params_rejects_a_wrong_tree():
    cfg = TR.get_arch("yi_6b").reduced()
    tree = TM.seeded_numpy_params(cfg, 0)
    del tree["stages"]["block0"]["ln2"]
    with pytest.raises(ValueError, match="missing"):
        TM.from_reference_params(cfg, tree)
    tree = TM.seeded_numpy_params(cfg, 0)
    tree["head"] = tree["head"][:, :-1]
    with pytest.raises(ValueError, match="shape"):
        TM.from_reference_params(cfg, tree)


# ---------------------------------------------------------------------------
# test_archs.py: forward, decode step, cell matrix, Mixtral window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_forward_matches_reference(arch):
    rcfg, tcfg, rp, tp = _pair(arch)
    b, s = 2, 32
    toks = _tokens(tcfg, 0, b, s)
    logits, aux = TM.forward(tcfg, tp, torch.from_numpy(toks))
    want_shape = (b, s, tcfg.num_codebooks, tcfg.vocab_size) if tcfg.num_codebooks > 1 else (
        b, s, tcfg.vocab_size)
    assert tuple(logits.shape) == want_shape and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())
    r_logits, r_aux = RM.forward(rcfg, rp, jnp.asarray(toks))
    _close(logits, r_logits)
    _close(aux, r_aux)
    last, _ = TM.forward(tcfg, tp, torch.from_numpy(toks), last_only=True)
    _close(last, logits[:, -1], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_decode_step_matches_reference(arch):
    """One step at position 0 on a 16-slot cache: the logits and every cache
    leaf equal the reference's; the cache keeps its structure, shapes and
    types and is written in place."""
    rcfg, tcfg, rp, tp = _pair(arch)
    b = 2
    cache, caxes = TM.init_cache(tcfg, b, 16)
    r_cache, r_caxes = RM.init_cache(rcfg, b, 16)
    assert _flat(caxes) == _flat(r_caxes)
    before = {k: (v.shape, v.dtype, v.data_ptr()) for k, v in _flat(cache).items()}
    tok = _tokens(tcfg, 1, b, 1)
    logits, cache2 = TM.decode_step(tcfg, tp, cache, torch.from_numpy(tok), 0)
    want = (b, tcfg.num_codebooks, tcfg.vocab_size) if tcfg.num_codebooks > 1 else (b, tcfg.vocab_size)
    assert tuple(logits.shape) == want and bool(torch.isfinite(logits).all())
    assert cache2 is cache
    assert {k: (v.shape, v.dtype, v.data_ptr()) for k, v in _flat(cache2).items()} == before
    r_logits, r_cache2 = RM.decode_step(rcfg, rp, r_cache, jnp.asarray(tok), jnp.int32(0))
    _close(logits, r_logits)
    r_flat = _flat(r_cache2)
    for name, value in _flat(cache2).items():
        assert str(value.dtype).removeprefix("torch.") == str(r_flat[name].dtype), name
        _close(value, r_flat[name])


@pytest.mark.parametrize("arch", ["qwen3_8b", "mixtral_8x7b", "musicgen_medium"])
def test_bf16_forward_tracks_reference(arch):
    """bf16 weights and compute in both packages (products accumulate in f32
    and round to bf16, norms in f32): logits within BF16_REL of the
    reference's in relative L2, where each package's bf16 rendering lies
    0.6-0.9% from float32 (measured on these archs).  Jamba and xLSTM are
    left out: in bf16 both packages lie 2-7% from their own float32
    rendering there (MoE routing flips, recurrences), the port no further
    from float32 than the reference."""
    rcfg = RR.get_arch(arch).reduced().with_dtypes("bfloat16", "bfloat16")
    tcfg = TR.get_arch(arch).reduced().with_dtypes("bfloat16", "bfloat16")
    tree = TM.seeded_numpy_params(tcfg, 0)
    params = TM.from_reference_params(tcfg, tree)
    assert params["head"].dtype == torch.bfloat16
    toks = _tokens(tcfg, 4, 2, 16)
    logits, _ = TM.forward(tcfg, params, torch.from_numpy(toks))
    r_logits, _ = RM.forward(rcfg, jax.tree.map(lambda v: jnp.asarray(v, jnp.bfloat16), tree),
                             jnp.asarray(toks))
    assert logits.dtype == torch.bfloat16 and r_logits.dtype == jnp.bfloat16
    want = np.asarray(r_logits, np.float32)
    rel = np.linalg.norm(logits.float().numpy() - want) / np.linalg.norm(want)
    assert rel <= BF16_REL, rel


def test_cell_matrix_counts():
    """33 runnable cells: 10 archs x 4 shapes - 7 long_500k skips."""
    cells = TR.all_cells()
    assert len(cells) == 33 and cells == RR.all_cells()
    skipped = [a for a in ARCH_IDS if not TR.applicable(TR.get_arch(a), TR.SHAPES["long_500k"])]
    assert len(skipped) == 7
    for a in ("jamba_v01_52b", "xlstm_1p3b", "mixtral_8x7b"):
        assert (a, "long_500k") in cells


def test_mixtral_window_bounds_cache():
    assert TM.cache_len_for(TR.get_arch("mixtral_8x7b"), 524288) == 4096
    assert TM.cache_len_for(TR.get_arch("yi_6b"), 32768) == 32768


# ---------------------------------------------------------------------------
# Attention routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
@pytest.mark.parametrize("seq", [12, 128])
def test_attention_routes_agree_on_the_cpu(arch, seq):
    """``attention="kernel"`` (K7's plain version on CPU tensors, KV heads
    not repeated) against ``"torch"`` (the reference's program; blockwise
    at 128 > attn_chunk), and ``None`` picks "torch" on the CPU."""
    _, tcfg, _, tp = _pair(arch)
    toks = torch.from_numpy(_tokens(tcfg, 2, 1, seq))
    kernel, _ = TM.forward(tcfg, tp, toks, attention="kernel")
    plain, _ = TM.forward(tcfg, tp, toks, attention="torch")
    default, _ = TM.forward(tcfg, tp, toks)
    _close(kernel, plain, rtol=ROUTE_TOL, atol=ROUTE_TOL)
    assert torch.equal(default, plain)


def test_attention_route_is_checked():
    _, tcfg, _, tp = _pair("yi_6b")
    with pytest.raises(ValueError, match="attention route"):
        TM.forward(tcfg, tp, torch.zeros((1, 4), dtype=torch.int64), attention="flash")


def test_kernel_route_raises_outside_k7s_contract():
    """A head dim K7 does not take fails on the kernel route; nothing falls
    back to the torch route."""
    import dataclasses

    cfg = dataclasses.replace(TR.get_arch("yi_6b").reduced(), head_dim=48)
    params, _ = TM.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 8), dtype=torch.int64)
    TM.forward(cfg, params, toks, attention="torch")
    with pytest.raises(ValueError, match="head dim"):
        TM.forward(cfg, params, toks, attention="kernel")


# ---------------------------------------------------------------------------
# Layers, function by function
# ---------------------------------------------------------------------------


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_norms_match_reference():
    x, w, b = _rand(0, 3, 5, 64), _rand(1, 64), _rand(2, 64)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           RL.rms_norm(jnp.asarray(x), jnp.asarray(w)), rtol=1e-6, atol=1e-6)
    _close(TL.layer_norm(*map(torch.from_numpy, (x, w, b))),
           RL.layer_norm(*map(jnp.asarray, (x, w, b))), rtol=1e-6, atol=1e-6)
    xb = torch.from_numpy(x).bfloat16()
    got = TL.rms_norm(xb, torch.from_numpy(w))
    want = RL.rms_norm(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


def test_rope_and_mrope_match_reference():
    pos = np.random.default_rng(0).integers(0, 4096, (2, 7)).astype(np.int32)
    x = _rand(1, 2, 3, 7, 32)
    for theta in (10000.0, 1e6):
        cos, sin = TL.rope_angles(torch.from_numpy(pos), 32, theta)
        rc, rs = RL.rope_angles(jnp.asarray(pos), 32, theta)
        _close(cos, rc, rtol=1e-5, atol=1e-5)
        _close(sin, rs, rtol=1e-5, atol=1e-5)
        _close(TL.apply_rope(torch.from_numpy(x), cos, sin), RL.apply_rope(jnp.asarray(x), rc, rs),
               rtol=1e-5, atol=1e-5)
    pos3 = np.random.default_rng(1).integers(0, 512, (3, 2, 7)).astype(np.int32)
    cos, sin = TL.mrope_angles(torch.from_numpy(pos3), 32, (4, 6, 6), 1e6)
    rc, rs = RL.mrope_angles(jnp.asarray(pos3), 32, (4, 6, 6), 1e6)
    _close(cos, rc, rtol=1e-5, atol=1e-5)
    _close(sin, rs, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="sections"):
        TL.mrope_angles(torch.from_numpy(pos3), 32, (4, 6, 5))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5), (False, None), (False, 3)])
def test_mask_chunk_matches_reference(causal, window):
    got = TL._mask_chunk(8, 4, 6, 10, causal, window)
    want = RL._mask_chunk(jnp.int32(8), jnp.int32(4), 6, 10, causal, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("s,chunk,window", [(64, 16, None), (64, 16, 20), (48, 32, None), (12, 4, 3)])
def test_blockwise_and_dense_attention_match_reference(s, chunk, window):
    """Blockwise (or its dense fallback where S is not a chunk multiple)."""
    q, k, v = (_rand(i, 2, 3, s, 16) for i in range(3))
    got = TL.blockwise_attention(*map(torch.from_numpy, (q, k, v)), causal=True, window=window,
                                 q_chunk=chunk, k_chunk=chunk)
    want = RL.blockwise_attention(*map(jnp.asarray, (q, k, v)), causal=True, window=window,
                                  q_chunk=chunk, k_chunk=chunk)
    _close(got, want, rtol=1e-5, atol=1e-5)
    dense = TL.dense_attention(*map(torch.from_numpy, (q, k, v)), causal=True, window=window)
    _close(dense, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pos,window", [(5, None), (11, 4), ([3, 9], None)])
def test_decode_attention_matches_reference(pos, window):
    q, kc, vc = _rand(0, 2, 4, 1, 16), _rand(1, 2, 2, 12, 16), _rand(2, 2, 2, 12, 16)
    got = TL.decode_attention(*map(torch.from_numpy, (q, kc, vc)), torch.tensor(pos), window=window)
    want = RL.decode_attention(*map(jnp.asarray, (q, kc, vc)), jnp.asarray(pos), window=window)
    _close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activations_match_reference(name):
    x = _rand(0, 1000) * 4
    _close(TL.ACTIVATIONS[name](torch.from_numpy(x)), RL.ACTIVATIONS[name](jnp.asarray(x)),
           rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# models_reference.json: the file the card is held to
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models_file():
    return json.loads(MODELS_REFERENCE_PATH.read_text())


def test_models_reference_file_is_current(models_file):
    """The JAX package computes today what the committed file holds."""
    built = build_models_reference()
    assert {k: v for k, v in built.items() if k != "archs"} == {
        k: v for k, v in models_file.items() if k != "archs"}
    assert set(built["archs"]) == set(models_file["archs"]) == set(ARCH_IDS)
    for arch, doc in built["archs"].items():
        have = models_file["archs"][arch]
        for key in ("capacity_factor", "tokens", "long_tokens"):
            assert doc[key] == have[key], (arch, key)
        for key in ("forward", "decode", "long_forward"):
            _close(decode_f32(doc[key]), decode_f32(have[key]), rtol=FILE_TOL, atol=FILE_TOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_port_matches_models_reference(models_file, arch):
    """The port on the CPU against the file: forward and stepwise decode at
    S = 12, and forward at S = 128, on both attention routes."""
    doc = models_file["archs"][arch]
    case = models_case(arch, TR.get_arch(arch).reduced())
    cfg = case["cfg"]
    assert cfg.capacity_factor == doc["capacity_factor"]
    assert case["tokens"].tolist() == doc["tokens"]
    params = TM.from_reference_params(cfg, TM.seeded_numpy_params(cfg, MODELS["seed"]))
    toks = torch.from_numpy(case["tokens"])
    for attention in ("torch", "kernel"):
        fwd, _ = TM.forward(cfg, params, toks, last_only=True, attention=attention)
        _close(fwd, decode_f32(doc["forward"]))
        long_fwd, _ = TM.forward(cfg, params, torch.from_numpy(case["long_tokens"]),
                                 last_only=True, attention=attention)
        _close(long_fwd, decode_f32(doc["long_forward"]))
    cache, _ = TM.init_cache(cfg, toks.shape[0], toks.shape[1])
    for t in range(toks.shape[1]):
        dec, cache = TM.decode_step(cfg, params, cache, toks[:, t:t + 1], t)
    _close(dec, decode_f32(doc["decode"]))

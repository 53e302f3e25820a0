"""Decode against forward in the port, case by case from
``tests/test_decode_consistency.py`` (stepwise decode equals the forward's
last position; the sliding-window ring evicts old tokens; prefill with
cache equals the forward), each also held to the JAX package on the same
parameters, and ``launch.serve.generate`` against the reference's.

Tolerances: decode against forward rtol = atol = 2e-3, the reference
test's own; the port against the reference RTOL = ATOL = 1e-4 (float32 in
both, sums in another order; about 2e-5 measured on the reduced archs).
``generate`` must give the reference's tokens, except from a step where
the reference's two largest logits lie within the port's tolerance of
each other (a near tie either package may break either way): there the
port's logits, teacher-forced along the reference's tokens, must still
agree within RTOL / ATOL at every step."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as ref_arch
from repro.launch import serve as RS
from repro.models import model as RM
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.launch import serve as TS
from repro_torch.models import model as TM

CASES = ["yi_6b", "mixtral_8x7b", "jamba_v01_52b", "xlstm_1p3b", "qwen2_vl_7b"]
DECODE_TOL = 2e-3
RTOL = ATOL = 1e-4


def _no_drop(cfg):
    """Forward == decode needs no capacity drops on the forward side (decode
    is dropless by construction)."""
    if cfg.num_experts > 1:
        return dataclasses.replace(cfg, capacity_factor=float(cfg.num_experts))
    return cfg


def _setup(arch, seed):
    cfg, rcfg = _no_drop(get_arch(arch).reduced()), _no_drop(ref_arch(arch).reduced())
    tree = TM.seeded_numpy_params(cfg, seed)
    return cfg, rcfg, TM.from_reference_params(cfg, tree), jax.tree.map(jnp.asarray, tree)


def _tokens(cfg, seed, b, s):
    shape = (b, s, cfg.num_codebooks) if cfg.num_codebooks > 1 else (b, s)
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, dtype=np.int32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", CASES)
def test_stepwise_decode_matches_forward(arch):
    cfg, rcfg, params, rparams = _setup(arch, 0)
    b, s = 2, 12
    toks = _tokens(cfg, 0, b, s)
    logits_fwd, _ = TM.forward(cfg, params, torch.from_numpy(toks))
    cache, _ = TM.init_cache(cfg, b, s)
    r_cache, _ = RM.init_cache(rcfg, b, s)
    for t in range(s):
        logits_dec, cache = TM.decode_step(cfg, params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        r_dec, r_cache = RM.decode_step(rcfg, rparams, r_cache, jnp.asarray(toks[:, t:t + 1]),
                                        jnp.int32(t))
        _close(logits_dec, r_dec, RTOL)
    _close(logits_fwd[:, -1], logits_dec, DECODE_TOL)


def test_swa_ring_buffer_evicts_old_tokens():
    """With window w, decoding past w positions attends only to the last w
    tokens (the forward over the whole sequence at the last position), and
    the ring's slots and positions are the reference's."""
    cfg, rcfg, params, rparams = _setup("mixtral_8x7b", 1)  # window = 16
    w = cfg.window
    b, s = 1, 24  # > window
    toks = _tokens(cfg, 1, b, s)
    cache, _ = TM.init_cache(cfg, b, s)  # cache_len = window
    r_cache, _ = RM.init_cache(rcfg, b, s)
    assert cache["block0"]["k"].shape[3] == w
    for t in range(s):
        logits_dec, cache = TM.decode_step(cfg, params, cache, torch.from_numpy(toks[:, t:t + 1]), t)
        r_dec, r_cache = RM.decode_step(rcfg, rparams, r_cache, jnp.asarray(toks[:, t:t + 1]),
                                        jnp.int32(t))
    logits_fwd, _ = TM.forward(cfg, params, torch.from_numpy(toks))
    _close(logits_fwd[:, -1], logits_dec, DECODE_TOL)
    _close(logits_dec, r_dec, RTOL)
    slot_pos = cache["block0"]["slot_pos"][0].numpy()
    np.testing.assert_array_equal(slot_pos, np.asarray(r_cache["block0"]["slot_pos"][0]))
    assert sorted(slot_pos.tolist()) == list(range(s - w, s))
    _close(cache["block0"]["k"], r_cache["block0"]["k"], RTOL)


def test_prefill_with_cache_matches_forward():
    cfg, rcfg, params, rparams = _setup("yi_6b", 2)
    toks = _tokens(cfg, 2, 2, 8)
    last, cache = TM.prefill_with_cache(cfg, params, torch.from_numpy(toks))
    logits_fwd, _ = TM.forward(cfg, params, torch.from_numpy(toks))
    _close(logits_fwd[:, -1], last, DECODE_TOL)
    r_last, r_cache = RM.prefill_with_cache(rcfg, rparams, jnp.asarray(toks))
    _close(last, r_last, RTOL)
    for key in ("k", "v"):
        _close(cache["block0"][key], r_cache["block0"][key], RTOL)
    np.testing.assert_array_equal(cache["block0"]["slot_pos"].numpy(),
                                  np.asarray(r_cache["block0"]["slot_pos"]))


def _logits_along(prefill, decode, tokens, s):
    """Logits of each generated step, teacher-forced along ``tokens``."""
    logits, cache = prefill
    out = [np.asarray(logits, np.float32)]
    for i in range(tokens.shape[1] - 1):
        logits, cache = decode(cache, tokens[:, i:i + 1], s + i)
        out.append(np.asarray(logits, np.float32))
    return np.stack(out, axis=1)  # (B, gen, [K,] V)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_generate_matches_reference(arch):
    cfg, rcfg, params, rparams = _setup(arch, 3)
    b, s, gen = 2, 8, 6
    prompt = _tokens(cfg, 3, b, s)
    got = TS.generate(cfg, params, torch.from_numpy(prompt), gen)
    want = np.asarray(RS.generate(rcfg, rparams, jnp.asarray(prompt), gen))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    assert bool(((got >= 0) & (got < cfg.vocab_size)).all())

    r_along = _logits_along(
        RM.prefill_with_cache(rcfg, rparams, jnp.asarray(prompt), cache_seq_len=s + gen),
        lambda c, t, p: RM.decode_step(rcfg, rparams, c, jnp.asarray(t), jnp.int32(p)),
        want, s)
    t_along = _logits_along(
        TM.prefill_with_cache(cfg, params, torch.from_numpy(prompt), cache_seq_len=s + gen),
        lambda c, t, p: TM.decode_step(cfg, params, c, torch.from_numpy(np.array(t)), p),
        want, s)
    _close(t_along, r_along, RTOL)
    differ = np.nonzero((got.numpy() != want).reshape(b, gen, -1).any(axis=(0, 2)))[0]
    if differ.size:
        step = differ[0]
        top2 = np.sort(r_along[:, step], axis=-1)[..., -2:]
        gap = (top2[..., 1] - top2[..., 0]).min()
        assert gap <= 2 * (ATOL + RTOL * np.abs(top2).max()), (
            f"tokens differ from step {step} where the reference's top-2 gap is {gap}")


def test_serve_cli_on_the_cpu(capsys):
    assert TS.main(["--arch", "qwen2_vl_7b", "--reduced", "--batch", "2", "--prompt-len", "5",
                    "--gen", "3", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and out["generated_shape"] == [2, 3] and out["in_range"]

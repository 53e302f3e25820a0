"""Model assembly: config-driven heterogeneous block stacks.

A model is ``n_stages`` repetitions of ``cfg.stage_pattern`` (a tuple of
(mixer, mlp) block kinds).  ``Model`` holds every block's parameters
stacked along a leading 'layers' axis, as the reference stacks them for its
scan; the forward and decode walk the stages in a Python loop.

Entry points (the reference's names):
  init_params / init_cache        -> (parameters or cache, logical axes)
  forward(cfg, params, tokens)    -> logits (full seq, or last position)
  loss_fn(cfg, params, batch)     -> (loss, {"ce", "aux"}), differentiable
  decode_step                     -> (logits, cache written in place)
  prefill_with_cache              -> (last logits, filled cache)
  shapes_and_axes / count_params_analytic   (on the meta device)
  from_reference_params           -> the reference's parameters as a Model

``params`` is a ``Model`` or its tree of stacked tensors
(``Model.stage(None)``, the training state's ``params``).  The serving
entry points run under ``torch.inference_mode()``; ``loss_fn`` runs the
same stack with gradients, under ``cfg.remat``'s activation checkpoints
(``torch.utils.checkpoint``) and with the chunked cross-entropy of
``cfg.loss_chunk``.

``attention=`` picks the prefill attention route (``blocks.attn_apply``):
``"kernel"`` (K7) by default for tokens on a CUDA device, ``"torch"`` for
tokens on the CPU.  The loss takes ``"torch"`` on every device: K7 has no
backward (nor has the reference's Pallas kernel), and ``"kernel"`` with
gradients enabled raises.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch import obs
from repro_torch.models import blocks, ssm, xlstm
from repro_torch.models.layers import ParamBlock, dense_param, ones_param, param_device, rms_norm
from repro_torch.parallel.sharding import (
    from_local,
    is_dtensor,
    redistribute,
    replicated,
    shard_hint,
)

__all__ = [
    "Model",
    "cache_len_for",
    "count_params_analytic",
    "decode_step",
    "default_positions",
    "forward",
    "from_reference_params",
    "hidden_forward",
    "init_cache",
    "init_params",
    "loss_fn",
    "prefill_with_cache",
    "seeded_numpy_params",
    "shapes_and_axes",
]

_MIXERS = {"attn": blocks.Attention, "mamba": ssm.Mamba, "mlstm": xlstm.MLstm,
           "slstm": xlstm.SLstm}
_MLPS = {"dense": blocks.Mlp, "moe": blocks.Moe}


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


class _Stage(ParamBlock):
    """One position of the stage pattern: ln1, mixer, (ln2, mlp)."""

    def __init__(self, gen, cfg, mixer: str, mlp: str, *, dtype, device):
        super().__init__()
        mk = dict(stack=cfg.n_stages, dtype=dtype, device=device)
        self.add("ln1", ones_param((cfg.d_model,), ("embed",), **mk))
        self.add_block("mixer", _MIXERS[mixer](gen, cfg, cfg.n_stages, dtype=dtype, device=device))
        if mlp != "none":
            self.add("ln2", ones_param((cfg.d_model,), ("embed",), **mk))
            self.add_block("mlp", _MLPS[mlp](gen, cfg, cfg.n_stages, dtype=dtype, device=device))


class Model(ParamBlock):
    """Every parameter of an architecture, named as the reference's tree:
    ``embed``, ``head``, ``final_norm`` and ``stages.block<i>.{ln1, mixer,
    ln2, mlp}``, each block's tensors stacked over the stages.  Drawn from
    ``gen`` on ``device`` (default: the generator's) in ``cfg.param_dtype``;
    on ``meta``, nothing is allocated."""

    def __init__(self, cfg, gen: torch.Generator | None = None, *, device=None):
        super().__init__()
        dtype = _dtype(cfg.param_dtype)
        device = param_device(gen, device)
        mk = dict(dtype=dtype, device=device)
        if cfg.num_codebooks > 1:
            k = cfg.num_codebooks
            self.add("embed", dense_param(gen, (k, cfg.vocab_size, cfg.d_model),
                                          ("codebooks", "vocab", "embed"), scale=1.0, **mk))
            self.add("head", dense_param(gen, (k, cfg.d_model, cfg.vocab_size),
                                         ("codebooks", "embed", "vocab"), **mk))
        else:
            self.add("embed", dense_param(gen, (cfg.vocab_size, cfg.d_model), ("vocab", "embed"),
                                          scale=1.0, **mk))
            self.add("head", dense_param(gen, (cfg.d_model, cfg.vocab_size), ("embed", "vocab"),
                                         **mk))
        self.add("final_norm", ones_param((cfg.d_model,), ("embed",), **mk))
        stages = ParamBlock()
        for i, (mixer, mlp) in enumerate(cfg.stage_pattern):
            stages.add_block(f"block{i}", _Stage(gen, cfg, mixer, mlp, **mk))
        self.add_block("stages", stages)


def init_params(cfg, gen: torch.Generator, *, device=None) -> tuple[Model, dict]:
    """(parameters, logical-axes tree) drawn from ``gen`` on its device
    (or ``device``)."""
    model = Model(cfg, gen, device=device)
    return model, model.axes


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}."))
        else:
            out[prefix + key] = value
    return out


def shapes_and_axes(cfg) -> tuple[dict, dict]:
    """(tree of meta tensors with each parameter's shape and type, tree of
    logical axes), allocating nothing (the reference's ``eval_shape``)."""
    model = Model(cfg, None, device="meta")
    return model.stage(None), model.axes


def count_params_analytic(cfg, active_only: bool = False, exclude_embed: bool = False) -> int:
    """Exact parameter count from the shapes.  ``active_only`` scales expert
    tables by top_k/E (MoE active params); ``exclude_embed`` drops the input
    embedding table (a gather, not a matmul) — the LM head IS counted."""
    shapes, axes = shapes_and_axes(cfg)
    ax_of = _flatten(axes)
    total = 0
    for name, leaf in _flatten(shapes).items():
        ax = ax_of[name]
        n = leaf.numel()
        if exclude_embed and "vocab" in ax and "embed" in ax:
            if ax.index("vocab") < ax.index("embed"):
                continue  # input embedding table
        if active_only and "experts" in ax:
            n = n * cfg.top_k // cfg.num_experts
        total += n
    return total


def from_reference_params(cfg, tree: dict, *, device=None) -> Model:
    """The JAX package's ``init_params`` tree (nested dicts of arrays with
    the same keys, each block stacked over stages) as a ``Model`` on
    ``device``, in ``cfg.param_dtype``: both packages then compute the same
    function.  Raises on a missing, extra or misshapen leaf."""
    model = Model(cfg, None, device="meta")
    want = _flatten(model.stage(None))
    got = _flatten(tree)
    if set(got) != set(want):
        raise ValueError(f"parameter names differ: missing {sorted(set(want) - set(got))}, "
                         f"extra {sorted(set(got) - set(want))}")
    dtype = _dtype(cfg.param_dtype)
    state = {}
    for name, value in got.items():
        # a copy: training writes the parameters in place, never the caller's arrays
        t = torch.from_numpy(np.array(value, dtype=np.float32)).to(device=device, dtype=dtype)
        if t.shape != want[name].shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(want[name].shape)}")
        state[name] = t
    model.load_state_dict(state, assign=True)
    return model


# Leaves drawn around one by ``seeded_numpy_params``: norm weights, Mamba's
# skip D, the mLSTM forget-gate bias (the reference's ones).
_ONES_LIKE = ("ln1", "ln2", "final_norm", "q_norm", "k_norm", "out_norm", "D", "b_fgate",
              "dt_norm", "b_norm", "c_norm")


def seeded_numpy_params(cfg, seed: int) -> dict:
    """Parameters both packages can load (the reference's tree of float32
    numpy arrays), from ``np.random.default_rng(seed)`` over the port's
    shapes in sorted name order, around the reference's init: 1 + 0.1 N
    for the leaves it sets to one, log(1..N) + 0.1 N for Mamba's A_log,
    0.1 N for other vectors (biases), N for embedding tables, N / sqrt(dh)
    for per-head (dh, dh) matrices and N / sqrt(fan-in) for the other
    matrices (fan-in: the first dim after the stage axis), with N standard
    normal draws."""
    shapes, axes = shapes_and_axes(cfg)
    ax_of = _flatten(axes)
    flat = _flatten(shapes)
    rng = np.random.default_rng(seed)
    values = {}
    for name in sorted(flat):
        shape = tuple(flat[name].shape)
        stacked = ax_of[name][:1] == ("layers",)
        inner, inner_axes = (shape[1:], ax_of[name][1:]) if stacked else (shape, ax_of[name])
        noise = rng.standard_normal(shape, dtype=np.float32)
        if name.rsplit(".", 1)[-1] in _ONES_LIKE:
            values[name] = 1.0 + 0.1 * noise
        elif inner_axes[-1] == "state":
            values[name] = np.log(np.arange(1, shape[-1] + 1, dtype=np.float32)) + 0.1 * noise
        elif len(inner) == 1:
            values[name] = 0.1 * noise
        elif inner_axes == ("heads", None, None):
            values[name] = noise * np.float32(inner[-1] ** -0.5)
        elif "vocab" in inner_axes and inner_axes.index("vocab") < inner_axes.index("embed"):
            values[name] = noise
        else:
            values[name] = noise * np.float32(inner[0] ** -0.5)
    tree: dict = {}
    for name, value in values.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def _lookup(table, ids):
    """``table[ids]``; on a DTensor table, vocab-parallel: each rank looks
    up the ids in its own block of vocab rows (the others masked to 0),
    with the embed dim gathered, and the blocks' partial sums are the
    rows.  DTensor's own embedding of a vocab-sharded table builds a mask
    of the wrong shape where the ids are batch-sharded, and its indexing
    backward has no placement on older releases."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    vocab_dims = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    table_pl = [Shard(0) if i in vocab_dims else Replicate() for i in range(mesh.ndim)]
    if not is_dtensor(ids):
        ids = replicated(ids, mesh)
    ids_pl = [Replicate() if i in vocab_dims or p.is_partial() else p
              for i, p in enumerate(ids.placements)]
    out_pl = [Partial() if i in vocab_dims else p for i, p in enumerate(ids_pl)]
    # the table's gradient: its vocab block, summed over the ids' shards
    grad_pl = [Shard(0) if i in vocab_dims else Partial() if p.is_shard() else Replicate()
               for i, p in enumerate(ids_pl)]
    coord = mesh.get_coordinate()
    block = 0
    for i in vocab_dims:
        block = block * mesh.size(i) + coord[i]

    def local(tab, idx):
        rel = idx.long() - block * tab.shape[0]
        inside = (rel >= 0) & (rel < tab.shape[0])
        rows = tab[torch.where(inside, rel, 0)]
        return rows * inside[..., None].to(rows.dtype)

    return local_map(local, out_placements=out_pl, in_placements=(table_pl, ids_pl),
                     in_grad_placements=(grad_pl, ids_pl), device_mesh=mesh)(
        redistribute(table, table_pl), redistribute(ids, ids_pl))


def _embed(cfg, params, tokens, dtype):
    with obs.span("model.embed"):
        if cfg.num_codebooks > 1:
            # tokens: (B, S, K); sum the K codebook embeddings
            x = sum(_lookup(params["embed"][k], tokens[..., k]) for k in range(cfg.num_codebooks))
        else:
            x = _lookup(params["embed"], tokens)
        return x.to(dtype)


def _codebook_logits(x, head):
    """(..., D) @ (K, D, V) -> (..., K, V): one product per codebook,
    stacked.  An einsum would view the codebook and vocab dims as one,
    which DTensor's older releases refuse where the vocab is sharded."""
    return torch.stack([x @ head[k] for k in range(head.shape[0])], dim=-2)


def _head(cfg, params, x):
    if cfg.num_codebooks > 1:
        return _codebook_logits(x, params["head"].to(x.dtype))
    return x @ params["head"].to(x.dtype)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------


def _attention_route(attention: str | None, device: torch.device) -> str:
    if attention is None:
        return "kernel" if device.type == "cuda" else "torch"
    if attention not in blocks.ATTENTION_ROUTES:
        raise ValueError(f"unknown attention route {attention!r}; "
                         f"expected one of {blocks.ATTENTION_ROUTES}")
    return attention


def _stage_list(stages, n: int) -> list[dict]:
    """Each stage's parameter dict (the slices the reference's scan hands
    its body), from a ``ParamBlock`` or a tree of stacked tensors: one
    ``unbind`` per stacked leaf, whose backward is one ``stack`` (slicing
    stage by stage would make each stage's gradient a full stacked tensor,
    n^2 bytes over the depth)."""
    if isinstance(stages, ParamBlock):
        stages = stages.stage(None)
    if isinstance(stages, dict):
        parts = {k: _stage_list(v, n) for k, v in stages.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(_unbind_stages(stages))


def _unbind_stages(v: torch.Tensor) -> tuple:
    """``v.unbind(0)``; for a DTensor, each rank's block unbound (the
    'layers' dim is never sharded), which also works under
    ``inference_mode`` on DTensors made outside it, where DTensor's own
    views cannot set their version counter."""
    if not is_dtensor(v):
        return v.unbind(0)
    from torch.distributed.tensor import Shard

    if any(p == Shard(0) for p in v.placements):
        raise ValueError(f"the stacked 'layers' dim is sharded: {v.placements}")
    placements = [Shard(p.dim - 1) if p.is_shard() else p for p in v.placements]
    return tuple(from_local(t, v.device_mesh, placements, shape=v.shape[1:], stride=v.stride()[1:])
                 for t in v.to_local().unbind(0))


def _remat(fn, *args, context_fn=noop_context_fn):
    """``fn(*args)`` under an activation checkpoint where gradients are on
    (``jax.checkpoint``'s role); a plain call under inference or no-grad."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)


# remat="dots": the stage checkpoint saves matrix-product outputs
# (jax.checkpoint_policies.dots_with_no_batch_dims_saveable's role).
_SAVE_PRODUCTS = functools.partial(
    create_selective_checkpoint_contexts,
    [torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default],
)
REMAT_MODES = ("none", "full", "stage", "block", "dots")


def _mixer_block(cfg, x, bp, kind, positions, attention):
    h = shard_hint(rms_norm(x, bp["ln1"]), "batch", None, "embed")
    if kind == "attn":
        with obs.span("model.attn"):
            y = blocks.attn_apply(bp["mixer"], h, cfg, positions, attention)
    elif kind == "mamba":
        with obs.span("model.mamba"):
            y = ssm.mamba_apply(bp["mixer"], h, cfg)
    elif kind == "mlstm":
        y = xlstm.mlstm_apply(bp["mixer"], h, cfg)
    else:
        y = xlstm.slstm_apply(bp["mixer"], h, cfg)
    return x + shard_hint(y, "batch", "seq", "embed")


def _mlp_block(cfg, x, bp, kind):
    """(x + the block's MLP, its aux loss or None for a dense MLP)."""
    h = shard_hint(rms_norm(x, bp["ln2"]), "batch", None, "embed")
    if kind == "dense":
        with obs.span("model.mlp"):
            y, a = blocks.mlp_apply(bp["mlp"], h, cfg), None
    else:
        with obs.span("model.moe"):
            y, a = blocks.moe_apply(bp["mlp"], h, cfg)
    return x + shard_hint(y, "batch", "seq", "embed"), a


def _stage_fn(cfg, x, stage_params, positions, attention, block_remat: bool = False):
    """One stage. ``block_remat`` (``cfg.remat == "block"``) checkpoints
    each mixer and MLP block: backward keeps one block's activations live
    instead of a whole stage's."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = _remat if block_remat else (lambda fn, *args: fn(*args))
    for i, (mixer, mlp) in enumerate(cfg.stage_pattern):
        bp = stage_params[f"block{i}"]
        x = remat(_mixer_block, cfg, x, bp, mixer, positions, attention)
        if mlp != "none":
            x, a = remat(_mlp_block, cfg, x, bp, mlp)
            if a is not None:
                aux = aux + a
        x = shard_hint(x, "batch", "seq", "embed")
    return x, aux


def default_positions(cfg, batch: int, seq: int, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.int32, device=device).expand(batch, seq)
    if cfg.rope_kind == "mrope":
        return pos.expand(3, batch, seq)
    return pos


def _positions_like(cfg, tokens) -> torch.Tensor:
    """``default_positions`` for ``tokens``; on their mesh, with the batch
    dim placed as theirs, if they are a DTensor."""
    b, s = tokens.shape[0], tokens.shape[1]
    if not is_dtensor(tokens):
        return default_positions(cfg, b, s, tokens.device)
    from torch.distributed.tensor import Replicate, Shard

    local = tokens.to_local()
    pos = default_positions(cfg, local.shape[0], s, local.device)
    placements = list(tokens.placements)
    if any(p.is_shard() and p.dim != 0 for p in placements):
        raise ValueError(f"tokens sharded beyond the batch dim: {tokens.placements}")
    if cfg.rope_kind == "mrope":
        placements = [Shard(1) if p.is_shard() else Replicate() for p in placements]
    shape = (3, b, s) if cfg.rope_kind == "mrope" else (b, s)
    return from_local(pos.contiguous(), tokens.device_mesh, placements, shape=torch.Size(shape),
                      stride=torch.empty(shape, device="meta").stride())


def _hidden(cfg, params, tokens, positions, attention) -> tuple[torch.Tensor, torch.Tensor]:
    """Embed + stage stack + final norm: the body of ``hidden_forward`` and
    of the loss.  With gradients on, ``cfg.remat`` places the checkpoints:
    "stage" (alias "full") one per stage; "block" one per mixer and MLP
    block, and none around the stage; "dots" one per stage that saves the
    matrix products; "none" saves everything."""
    if cfg.remat not in REMAT_MODES:
        raise ValueError(f"unknown remat {cfg.remat!r}; expected one of {REMAT_MODES}")
    attention = _attention_route(attention, tokens.device)
    if positions is None:
        positions = _positions_like(cfg, tokens)
    x = shard_hint(_embed(cfg, params, tokens, _dtype(cfg.compute_dtype)), "batch", "seq", "embed")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for stage_params in _stage_list(params["stages"], cfg.n_stages):
        args = (cfg, x, stage_params, positions, attention)
        if cfg.remat in ("full", "stage"):
            x, a = _remat(_stage_fn, *args)
        elif cfg.remat == "dots":
            x, a = _remat(_stage_fn, *args, context_fn=_SAVE_PRODUCTS)
        else:
            x, a = _stage_fn(*args, block_remat=cfg.remat == "block")
        aux = aux + a
    return rms_norm(x, params["final_norm"]), aux


@torch.inference_mode()
def hidden_forward(cfg, params: Model, tokens: torch.Tensor, positions: torch.Tensor | None = None,
                   *, attention: str | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Embed + stage stack + final norm. Returns (hidden (B, S, D), aux)."""
    return _hidden(cfg, params, tokens, positions, attention)


@torch.inference_mode()
def forward(cfg, params: Model, tokens: torch.Tensor, positions: torch.Tensor | None = None, *,
            last_only: bool = False, attention: str | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits, aux_loss).

    ``last_only`` returns next-token logits for the final position only,
    the serving prefill path (full (B, S, V) logits at long sequences and
    large vocabularies would be huge and serve no purpose)."""
    with obs.span("model.forward"):
        x, aux = _hidden(cfg, params, tokens, positions, attention)
        with obs.span("model.head"):
            if last_only:
                x = shard_hint(x[:, -1], "batch", "embed")
            else:
                x = shard_hint(x, "batch", None, "embed")  # gather seq for the head
            return _logits_hint(cfg, _head(cfg, params, x)), aux


def _logits_hint(cfg, logits):
    """Keep the logits vocab-sharded: the reductions over the vocab then
    run on the shards instead of all-gathering (B, S, V) per rank.  The
    seq axis stays unsharded, so that 'model' stays free for the vocab."""
    ax = (("batch",) + (None,) * (logits.ndim - 2 - (cfg.num_codebooks > 1))
          + (("codebooks",) if cfg.num_codebooks > 1 else ()) + ("vocab",))
    return shard_hint(logits, *ax)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logsumexp - label logit per position, in f32, the max held constant
    (the reference's ``stop_gradient``)."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    logz = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    if is_dtensor(logits):
        return logz - _vocab_parallel_label_logit(logits, labels)
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - label_logit


def _vocab_parallel_label_logit(logits, labels):
    """The label's logit from logits whose vocab dim may be sharded: each
    rank gathers from its own vocab block, with the labels outside it
    masked to 0, and the blocks' sum (one all-reduce of the (B, S) result)
    is the logit.  Replicating the (B, S, V) logits instead would all-gather
    them, which the reference's GSPMD program does not do."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = logits.device_mesh
    vdim = logits.ndim - 1
    logits = redistribute(logits, [Replicate() if p.is_partial() else p for p in logits.placements])
    vocab_dims = [i for i, p in enumerate(logits.placements) if p == Shard(vdim)]
    # placements as lists: local_map reads a tuple as one per output
    logits_pl = list(logits.placements)
    label_pl = [Replicate() if i in vocab_dims else p for i, p in enumerate(logits.placements)]
    out_pl = [Partial() if i in vocab_dims else p for i, p in enumerate(logits.placements)]
    coord = mesh.get_coordinate()
    block = 0
    for i in vocab_dims:
        block = block * mesh.size(i) + coord[i]

    def local(lg, lab):
        lab = lab.long() - block * lg.shape[-1]
        inside = (lab >= 0) & (lab < lg.shape[-1])
        picked = torch.gather(lg, -1, torch.where(inside, lab, 0)[..., None])[..., 0]
        return torch.where(inside, picked, 0.0)

    if not is_dtensor(labels):
        labels = replicated(labels, mesh)
    labels = redistribute(labels, label_pl)
    return local_map(local, out_placements=out_pl, in_placements=(logits_pl, label_pl),
                     device_mesh=mesh)(logits, labels)


def _ce_terms(cfg, head, x_chunk, labels_chunk) -> torch.Tensor:
    """Sum over the chunk of (logsumexp - label_logit). x_chunk: (B, c, D)."""
    if cfg.num_codebooks > 1:
        logits = _codebook_logits(x_chunk, head.to(x_chunk.dtype))
    else:
        logits = x_chunk @ head.to(x_chunk.dtype)
    return _nll(logits, labels_chunk).sum()


def loss_fn(cfg, params, batch: dict, *, attention: str = "torch"
            ) -> tuple[torch.Tensor, dict]:
    """(ce + aux_loss_coef * aux, {"ce", "aux"}) of ``batch`` (``tokens``,
    ``labels``, optional ``positions``), differentiable in ``params``.

    Where ``cfg.loss_chunk`` divides the sequence into more than one chunk,
    the LM head and cross-entropy run chunk by chunk, each under a
    checkpoint, so the (B, S, V) logits never exist at once; the same
    sums otherwise.  ``attention="kernel"`` with gradients enabled raises:
    K7 is forward only."""
    attention = _attention_route(attention, batch["tokens"].device)
    if attention == "kernel" and torch.is_grad_enabled():
        raise ValueError("attention='kernel' has no backward (K7 is forward only, as is the "
                         "reference's Pallas kernel); the loss trains through attention='torch'")
    labels = batch["labels"]
    chunk = cfg.loss_chunk
    seq = labels.shape[1]
    x, aux = _hidden(cfg, params, batch["tokens"], batch.get("positions"), attention)
    if chunk and seq % chunk == 0 and seq // chunk > 1:
        # one replicated copy of the (vocab-sharded) head for every chunk
        head = shard_hint(params["head"], *(None,) * params["head"].ndim)
        total_nll = torch.zeros((), dtype=torch.float32, device=x.device)
        for c0 in range(0, seq, chunk):
            total_nll = total_nll + _remat(_ce_terms, cfg, head, x[:, c0:c0 + chunk],
                                           labels[:, c0:c0 + chunk])
        ce = total_nll / labels.numel()
    else:
        x = shard_hint(x, "batch", None, "embed")  # gather seq for the head
        ce = _nll(_logits_hint(cfg, _head(cfg, params, x)), labels).mean()
    total = ce + cfg.aux_loss_coef * aux
    return total, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# KV / state caches + decode
# ---------------------------------------------------------------------------


def cache_len_for(cfg, seq_len: int) -> int:
    return min(seq_len, cfg.window) if cfg.window else seq_len


def init_cache(cfg, batch: int, seq_len: int, dtype=None, device=None) -> tuple[dict, dict]:
    """Every block's decode cache, stacked over stages, and its axes."""
    dtype = dtype or _dtype(cfg.compute_dtype)
    clen = cache_len_for(cfg, seq_len)
    stack = cfg.n_stages
    cache: dict[str, Any] = {}
    axes: dict[str, Any] = {}
    for i, (mixer, _) in enumerate(cfg.stage_pattern):
        if mixer == "attn":
            c, ax = blocks.attn_cache_init(cfg, batch, clen, stack, dtype, device)
        elif mixer == "mamba":
            c, ax = ssm.mamba_cache_init(cfg, batch, stack, dtype, device)
        elif mixer == "mlstm":
            c, ax = xlstm.mlstm_cache_init(cfg, batch, stack, dtype, device)
        else:
            c, ax = xlstm.slstm_cache_init(cfg, batch, stack, dtype, device)
        cache[f"block{i}"] = c
        axes[f"block{i}"] = ax
    return cache, axes


@torch.inference_mode()
def decode_step(cfg, params: Model, cache: dict, tokens: torch.Tensor, pos) -> tuple[torch.Tensor, dict]:
    """One decoding step for the whole stack: ``tokens`` (B, 1) or (B, 1, K)
    at position ``pos``.  Writes ``cache`` in place and returns (logits
    (B, V[, K]), cache)."""
    pos = int(pos)
    x = shard_hint(_embed(cfg, params, tokens, _dtype(cfg.compute_dtype)), "batch", "seq", "embed")
    stage_caches = _stage_list(cache, cfg.n_stages)  # views: decode writes them in place
    for s, stage_params in enumerate(_stage_list(params["stages"], cfg.n_stages)):
        for i, (mixer, mlp) in enumerate(cfg.stage_pattern):
            bp = stage_params[f"block{i}"]
            c = stage_caches[s][f"block{i}"]
            h = rms_norm(x, bp["ln1"])
            if mixer == "attn":
                y, _ = blocks.attn_decode(bp["mixer"], h, c, pos, cfg)
            elif mixer == "mamba":
                y, _ = ssm.mamba_decode(bp["mixer"], h, c, cfg)
            elif mixer == "mlstm":
                y, _ = xlstm.mlstm_decode(bp["mixer"], h, c, cfg)
            else:
                y, _ = xlstm.slstm_decode(bp["mixer"], h, c, cfg)
            x = x + y
            if mlp != "none":
                h = rms_norm(x, bp["ln2"])
                if mlp == "dense":
                    y = blocks.mlp_apply(bp["mlp"], h, cfg)
                else:
                    # dropless at decode: a dropped token would diverge
                    # from the prefill forward pass
                    y, _ = blocks.moe_apply(bp["mlp"], h, cfg, dropless=True)
                x = x + y
    x = rms_norm(x, params["final_norm"])
    return _logits_hint(cfg, _head(cfg, params, x[:, 0])), cache


# ---------------------------------------------------------------------------
# Prefill that also fills the decode cache (serving path)
# ---------------------------------------------------------------------------


@torch.inference_mode()
def prefill_with_cache(cfg, params: Model, tokens: torch.Tensor,
                       cache_seq_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """The last position's logits and a filled decode cache, by decoding
    the prompt token by token (the reference's strategy: exact, and
    sequential)."""
    b, s = tokens.shape[0], tokens.shape[1]
    clen = cache_len_for(cfg, cache_seq_len or s)
    cache, _ = init_cache(cfg, b, clen, device=tokens.device)
    logits = None
    for t in range(s):
        logits, cache = decode_step(cfg, params, cache, tokens[:, t:t + 1], t)
    return logits, cache

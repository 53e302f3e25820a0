"""Eight gloo ranks on a (4, 2) ("data", "model") mesh on the CPU, for
``tests/test_torch_mesh.py``:

    python tests/_torch_mesh_worker.py <rendezvous file> <inputs .npz> <result .json>

Each rank places the same seeded parameters and batch on the mesh
(``parallel.sharding.place``) and runs, under ``activation_sharding``:

1. the yi_6b reduced f32 loss and its gradients, then one
   ``make_train_step`` AdamW step from fresh placed state, and the serving
   forward (``inference_mode``, parameters placed with gradients on) on
   both attention routes; the same train step of the mixtral reduced arch,
   whose MoE takes its sharded branch (capacity factor E / k: no token
   dropped), and of the xlstm reduced arch in float64, whose gates'
   ``F.logsigmoid`` and mLSTM recurrence run through ``local_map``; rank 0
   writes the relative L2 distance of the loss, each
   gradient leaf, each updated parameter and the logits from the same
   computation unsharded;
2. the mixtral reduced MoE layer (``blocks.moe_apply``) on the inputs of
   the ``.npz``: the sharded dispatch, written out whole by rank 0; then
   on 512 tokens, above the compact path's rule: DTensor tokens on the
   capacity path against plain ones on the compact path;
3. ``place``'s blocks: every rank's local block of each parameter must be
   the global tensor's block at its mesh coordinate (``shard_slices``).

Imports torch and the port only (the spawned ranks load no JAX).
"""

import dataclasses
import json
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
SEED = 0


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = value
    return out


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    scale = want.norm().item()
    return (got - want).norm().item() / scale if scale else (got - want).norm().item()


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _rank(rank: int, store_path: str, npz_path: str, out_path: str) -> None:
    from repro_torch import obs
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import blocks
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as sh

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD)
    try:
        mesh = make_mesh((4, 2), ("data", "model"), device_type="cpu")
        result = {}

        # 1. the train steps
        def inputs(cfg):
            """(seeded numpy parameters, their axes, a batch, the batch placed)."""
            rng = np.random.default_rng(SEED)
            stream = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 33)).astype(np.int32))
            batch = {"tokens": stream[:, :-1].contiguous(), "labels": stream[:, 1:].contiguous()}
            placed_batch = {k: sh.place(v, sh.sharding_for(("batch", "seq"), v.shape, mesh))
                            for k, v in batch.items()}
            return (M.seeded_numpy_params(cfg, SEED), M.Model(cfg, None, device="meta").axes,
                    batch, placed_batch)

        def train_errors(cfg) -> dict:
            numpy_params, axes, batch, placed_batch = inputs(cfg)

            def fresh():
                return M.from_reference_params(cfg, numpy_params).stage(None)

            def placed():
                tree = fresh()
                return sh.place(tree, sh.tree_shardings(axes, tree, mesh))

            def loss_and_grads(params, batch):
                leaves = _flat(params)
                for p in leaves.values():
                    p.requires_grad_(True)
                loss, _ = M.loss_fn(cfg, params, batch)
                grads = torch.autograd.grad(loss, list(leaves.values()))
                return loss, dict(zip(leaves, grads))

            def stepped(params, batch):
                state = {"params": params,
                         "opt_state": adamw.init_state(adamw.AdamWConfig(), params)}
                state, _ = make_train_step(cfg, adamw.AdamWConfig())(state, batch)
                return _flat(state["params"])

            loss0, grads0 = loss_and_grads(fresh(), batch)
            params0 = stepped(fresh(), batch)
            with sh.activation_sharding(mesh):
                loss1, grads1 = loss_and_grads(placed(), placed_batch)
                params1 = stepped(placed(), placed_batch)
            return {"loss": _rel(_full(loss1.detach()), loss0.detach()),
                    "grads": {k: _rel(_full(g), grads0[k]) for k, g in grads1.items()},
                    "params": {k: _rel(_full(p.detach()), params0[k].detach())
                               for k, p in params1.items()}}

        cfg = get_arch("yi_6b").reduced()
        result["train"] = train_errors(cfg)
        # the MoE's sharded branch (per-shard capacity) under autograd; with
        # room for every token (capacity factor E / k) neither branch drops
        # one, so that the sharded and unsharded steps compute one function
        moe_cfg = get_arch("mixtral_8x7b").reduced()
        partition, partitions = blocks._token_partition, []
        blocks._token_partition = lambda *a: partitions.append(partition(*a)) or partitions[-1]
        try:
            result["moe_train"] = train_errors(dataclasses.replace(
                moe_cfg, capacity_factor=moe_cfg.num_experts / moe_cfg.top_k))
        finally:
            blocks._token_partition = partition
        result["moe_train"]["token_partitions"] = partitions
        # xLSTM's gates and mLSTM recurrence through local_map on the mesh, in
        # float64: the f32 step's own gradients lie up to 1.6e-5 (relative
        # L2) from float64's, above TRAIN_TOL, so two f32 orders of the same
        # sums could not be told from a fault at that tolerance
        result["xlstm_train"] = train_errors(
            get_arch("xlstm_1p3b").reduced().with_dtypes("float64", "float64"))

        # the serving forward (inference mode) on parameters placed with
        # gradients on, on both attention routes (K7's plain version here)
        numpy_params, axes, batch, placed_batch = inputs(cfg)
        model = M.from_reference_params(cfg, numpy_params)
        with sh.activation_sharding(mesh):
            placed_model = sh.place(model.stage(None), sh.tree_shardings(axes, model.stage(None),
                                                                          mesh))
            for route in ("kernel", "torch"):
                want, _ = M.forward(cfg, model, batch["tokens"], last_only=True, attention=route)
                got, _ = M.forward(cfg, placed_model, placed_batch["tokens"], last_only=True,
                                   attention=route)
                result[f"forward_{route}"] = _rel(_full(got), want)

        # 2. the MoE layer's sharded dispatch
        data = np.load(npz_path)
        p = {k[2:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("p/")}
        moe_axes = {k: v for k, v in M.Model(moe_cfg, None, device="meta").axes["stages"]["block0"]
                    ["mlp"].items() if k in p}
        moe_axes = {k: v[1:] for k, v in moe_axes.items()}  # one stage: no 'layers' dim
        p = sh.place(p, sh.tree_shardings(moe_axes, p, mesh))
        x = torch.from_numpy(data["x"])
        x = sh.place(x, sh.sharding_for(("batch", "seq", "embed"), x.shape, mesh))
        with torch.no_grad(), sh.activation_sharding(mesh):
            out, aux = blocks.moe_apply(p, x, moe_cfg)
        moe_out, moe_aux = _full(out), _full(aux)
        # above the compact path's rule (a mean load of 256 rows an expert),
        # DTensor tokens keep the capacity path; plain ones take the compact
        # path, and with no token dropped both compute one function
        nodrop = dataclasses.replace(moe_cfg, capacity_factor=moe_cfg.num_experts / moe_cfg.top_k)
        x_big = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (8, 64, moe_cfg.d_model), dtype=np.float32))
        plain_p = {k[2:]: torch.from_numpy(data[k]) for k in data.files if k.startswith("p/")}
        compact_layers = {}
        with torch.no_grad():
            with obs.tracing():
                want_big, _ = blocks.moe_apply(plain_p, x_big, nodrop)
                compact_layers["plain"] = obs.counters().get("moe.compact_layers", 0)
            placed_big = sh.place(x_big, sh.sharding_for(("batch", "seq", "embed"), x_big.shape,
                                                         mesh))
            with obs.tracing(), sh.activation_sharding(mesh):
                got_big, _ = blocks.moe_apply(p, placed_big, nodrop)
                compact_layers["dtensor"] = obs.counters().get("moe.compact_layers", 0)
        result["moe_rule"] = {"compact_layers": compact_layers,
                              "rel": _rel(_full(got_big), want_big)}

        # 3. place's blocks
        tree = M.from_reference_params(cfg, numpy_params).stage(None)
        shardings = sh.tree_shardings(axes, tree, mesh)
        blocks_ok = all(torch.equal(_flat(sh.place(tree, shardings))[k].to_local(),
                                    v[_flat(shardings)[k].shard_slices(v.shape,
                                                                       mesh.get_coordinate())])
                        for k, v in _flat(tree).items())
        flag = torch.tensor([int(blocks_ok)])
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        result["blocks_equal_on_every_rank"] = bool(flag.item())
        if rank == 0:
            result["moe_out"] = moe_out.tolist()
            result["moe_aux"] = float(moe_aux)
            with open(out_path, "w") as f:
                json.dump(result, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(_rank, args=tuple(sys.argv[1:4]), nprocs=WORLD, start_method="spawn")

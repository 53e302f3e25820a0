"""The port's substrate against the JAX package's: each case of
``tests/test_checkpoint_data_runtime.py`` (checkpoint atomicity and
round trip, data determinism and sharding, crash-restart resume identity
and a falling loss through ``launch.train.build`` on the CPU, health and
elastic policies), plus ``batch_at_step`` byte for byte against the
reference's, checkpoints crossing between the packages both ways, the
coordinator's preemption exit and the launcher's device rule."""

import json
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_reference import flat_keys

from repro.checkpoint.manager import CheckpointManager as RefCheckpointManager
from repro.configs.registry import get_arch as ref_get_arch
from repro.data import pipeline as RP
from repro.models import model as RM
from repro.optim import adamw as RA
from repro.runtime.elastic import largest_usable as ref_largest_usable
from repro.runtime.elastic import plan_remesh as ref_plan_remesh
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_arch
from repro_torch.data.pipeline import DataConfig, DataIterator, batch_at_step
from repro_torch.launch import train
from repro_torch.launch.train import build
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.elastic import largest_usable, plan_remesh
from repro_torch.runtime.health import HealthMonitor


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

# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------


def _state():
    return {
        "params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
        "opt": {"m": torch.ones((2, 3)), "step": torch.tensor(7, dtype=torch.int32)},
    }


def test_checkpoint_roundtrip_exact(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = _state()
    mgr.save(3, state, extra={"data_step": 3})
    restored, extra = mgr.restore(3, like=state)
    assert extra == {"data_step": 3}
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_checkpoint_keep_k_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state())
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_tmp_dirs_invisible(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _state())
    (tmp_path / "step_0000000009.tmp").mkdir()  # simulated crashed save
    assert mgr.all_steps() == [1]
    assert mgr.restore_latest(like=_state())[0] == 1


def test_checkpoint_bf16_leaves_round_trip(tmp_path):
    """bf16 (moment_dtype="bfloat16") is stored as its raw bits, uint16,
    with the manifest's dtype "bfloat16", and restored bit for bit; the
    like may live on the meta device; CUDA-free leaves come back on the
    CPU."""
    m = torch.randn((4, 5), generator=torch.Generator().manual_seed(0)).bfloat16()
    state = {"m": m, "w": torch.zeros(3)}
    mgr = CheckpointManager(tmp_path)
    path = mgr.save(1, state)
    manifest = json.loads((path / "manifest.json").read_text())
    assert [(e["key"], e["dtype"], e["shape"]) for e in manifest["leaves"]] == [
        ("m", "bfloat16", [4, 5]), ("w", "float32", [3])]
    assert np.load(path / "m.npy").dtype == np.uint16
    like = {"m": torch.empty((4, 5), dtype=torch.bfloat16, device="meta"),
            "w": torch.empty(3, device="meta")}
    restored, _ = mgr.restore(1, like)
    assert restored["m"].dtype == torch.bfloat16 and torch.equal(restored["m"], m)


def _ref_train_state(cfg, seed):
    """A small f32 train state of the JAX package (params of the port's
    ``cfg``, whose shapes both packages share, and AdamW moments after
    nothing), as numpy-loadable arrays."""
    params = jax.tree.map(jnp.asarray, TM.seeded_numpy_params(cfg, seed))
    opt = RA.init_state(RA.AdamWConfig(), params)
    opt = {"m": jax.tree.map(lambda p: p * 0.5, params), "v": jax.tree.map(jnp.square, params),
           "step": jnp.int32(4)}
    return {"params": params, "opt_state": opt}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    """A state written by the port restores through the JAX package's
    CheckpointManager with equal arrays, under the reference's keys and
    leaf order."""
    cfg = get_arch("jamba_v01_52b").reduced()
    params = TM.from_reference_params(cfg, TM.seeded_numpy_params(cfg, 1)).stage(None)
    state = {"params": params, "opt_state": adamw.init_state(adamw.AdamWConfig(), params)}
    state["opt_state"]["m"] = adamw.tree_map(lambda p: p.detach() * 0.5, params)
    path = CheckpointManager(tmp_path).save(5, state, extra={"data_step": 5})
    like = _ref_train_state(get_arch("jamba_v01_52b").reduced(), 0)
    restored, extra = RefCheckpointManager(tmp_path).restore(5, like)
    assert extra == {"data_step": 5}
    want = {k: v.detach().numpy() for k, v in flat_keys(state).items()}
    got = flat_keys(restored)
    assert got.keys() == want.keys()
    for key, value in got.items():
        assert value.dtype == want[key].dtype and np.array_equal(value, want[key]), key
    manifest = json.loads((path / "manifest.json").read_text())
    ref_order = [e["key"] for e in manifest["leaves"]]
    RefCheckpointManager(tmp_path / "ref").save(5, like)
    assert ref_order == [e["key"] for e in json.loads(
        (tmp_path / "ref" / "step_0000000005" / "manifest.json").read_text())["leaves"]]


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    state = _ref_train_state(get_arch("mixtral_8x7b").reduced(), 2)
    RefCheckpointManager(tmp_path).save(3, state, extra={"data_step": 3})
    like = adamw.tree_map(lambda a: torch.empty(a.shape, device="meta"), state)
    step, restored, extra = CheckpointManager(tmp_path).restore_latest(like)
    assert (step, extra) == (3, {"data_step": 3})
    want = flat_keys(state)
    for key, value in flat_keys(restored).items():
        assert isinstance(value, torch.Tensor)
        assert np.array_equal(value.numpy(), np.asarray(want[key])), key
    assert restored["opt_state"]["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


def test_data_deterministic_in_seed_step():
    cfg = DataConfig(vocab_size=1000, seq_len=16, global_batch=4, seed=7)
    a = batch_at_step(cfg, 5)
    b = batch_at_step(cfg, 5)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = batch_at_step(cfg, 6)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_data_host_shards_disjoint():
    kw = dict(vocab_size=1000, seq_len=16, global_batch=8, num_hosts=2, seed=0)
    h0 = batch_at_step(DataConfig(host_id=0, **kw), 3)
    h1 = batch_at_step(DataConfig(host_id=1, **kw), 3)
    assert h0["tokens"].shape == (4, 16)  # global/hosts
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    with pytest.raises(ValueError, match="divide"):
        DataConfig(vocab_size=10, seq_len=4, global_batch=3, num_hosts=2)


def test_data_labels_are_next_tokens():
    cfg = DataConfig(vocab_size=50, seq_len=8, global_batch=2)
    b = batch_at_step(cfg, 0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_iterator_seek_resume():
    cfg = DataConfig(vocab_size=100, seq_len=4, global_batch=2)
    it = DataIterator(cfg)
    for _ in range(3):
        next(it)
    state = it.state()
    step, batch = next(it)
    it2 = DataIterator.restore(cfg, state)
    step2, batch2 = next(it2)
    assert step == step2
    np.testing.assert_array_equal(batch["tokens"], batch2["tokens"])


@pytest.mark.parametrize("kw", [
    dict(vocab_size=151936, seq_len=64, global_batch=4, seed=3),
    dict(vocab_size=2048, seq_len=16, global_batch=6, num_hosts=3, host_id=2, seed=1),
    dict(vocab_size=512, seq_len=32, global_batch=2, num_codebooks=4, zipf_a=1.5),
])
def test_batch_at_step_equals_reference_byte_for_byte(kw):
    for step in (0, 1, 17):
        got = batch_at_step(DataConfig(**kw), step)
        want = RP.batch_at_step(RP.DataConfig(**kw), step)
        assert got.keys() == want.keys()
        for key in got:
            assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
            assert got[key].tobytes() == want[key].tobytes(), (step, key)


# ---------------------------------------------------------------------------
# coordinator: crash-restart resume identity, preemption, the device rule
# ---------------------------------------------------------------------------


def test_crash_restart_resumes_bit_identical(tmp_path):
    """Train 8 steps straight vs train-crash-at-5-restart: identical state."""

    def run(ckpt_dir, fail_at=None, steps=8):
        coord = build("yi_6b", reduced=True, batch=2, seq=16, steps=steps,
                      ckpt_dir=str(ckpt_dir), device="cpu")
        try:
            coord.run(steps=steps, fail_at_step=fail_at)
        except RuntimeError:
            assert fail_at is not None
        return coord

    c1 = run(tmp_path / "a")  # uninterrupted
    run(tmp_path / "b", fail_at=5)  # crashes after step 5
    c2b = run(tmp_path / "b")  # restart, resumes from checkpoint
    assert [m["step"] for m in c2b.metrics_log] == [4, 5, 6, 7]

    m1 = CheckpointManager(tmp_path / "a").restore_latest(like=c1.init_state_fn(device="meta"))
    m2 = CheckpointManager(tmp_path / "b").restore_latest(like=c2b.init_state_fn(device="meta"))
    assert m1[0] == m2[0] == 8
    for a, b in zip(tree_leaves(m1[1]), tree_leaves(m2[1])):
        assert torch.equal(a, b)


def test_training_loss_improves(tmp_path):
    coord = build("qwen3_8b", reduced=True, batch=2, seq=16, steps=12,
                  ckpt_dir=str(tmp_path / "c"), lr=1e-3, device="cpu")
    coord.run(steps=12)
    losses = [m["loss"] for m in coord.metrics_log]
    assert losses[-1] < losses[0]


def test_preemption_saves_then_exits_143(tmp_path):
    """SIGTERM sets the flag; the loop saves at the current step and exits
    with 143; a rerun resumes there."""
    coord = build("yi_6b", reduced=True, batch=2, seq=16, steps=6, ckpt_dir=str(tmp_path),
                  device="cpu")
    before = signal.getsignal(signal.SIGTERM)
    try:
        coord.install_preemption_handler()
        inner = coord.train_step

        def step_then_preempt(state, batch):
            out = inner(state, batch)
            if len(coord.metrics_log) == 2:
                signal.raise_signal(signal.SIGTERM)
            return out

        coord.train_step = step_then_preempt
        with pytest.raises(SystemExit) as exc:
            coord.run(steps=6)
    finally:
        signal.signal(signal.SIGTERM, before)
    assert exc.value.code == 143
    assert CheckpointManager(tmp_path).latest_step() == 3
    again = build("yi_6b", reduced=True, batch=2, seq=16, steps=6, ckpt_dir=str(tmp_path),
                  device="cpu")
    step, _ = again.run(steps=6)
    assert step == 6 and [m["step"] for m in again.metrics_log] == [3, 4, 5]


def test_restore_moves_leaves_to_the_run_device(tmp_path):
    """The coordinator restores into meta-built structure and puts every
    leaf on its device, parameters trainable again."""
    coord = build("yi_6b", reduced=True, batch=2, seq=16, steps=2, ckpt_dir=str(tmp_path),
                  device="cpu")
    coord.run(steps=2)
    step, state = build("yi_6b", reduced=True, batch=2, seq=16, steps=2, ckpt_dir=str(tmp_path),
                        device="cpu")._restore_or_init()
    assert step == 2 and state["opt_state"]["step"].item() == 2
    assert state["opt_state"]["step"].shape == ()
    assert all(t.device.type == "cpu" for t in tree_leaves(state))
    like = coord.init_state_fn(device="meta")
    assert all(t.device.type == "meta" for t in tree_leaves(like))
    assert flat_keys(like).keys() == flat_keys(state).keys()


def test_build_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    """No CUDA device: the default raises rather than train on the CPU, the
    CLI too; the CPU runs only by name."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build("yi_6b", reduced=True, batch=2, seq=8, steps=1, ckpt_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "yi_6b", "--reduced", "--ckpt-dir", str(tmp_path)])
    assert build("yi_6b", reduced=True, batch=2, seq=8, steps=1, ckpt_dir=str(tmp_path),
                 device="cpu").device == torch.device("cpu")


def test_train_main_on_the_cpu(tmp_path, capsys):
    assert train.main(["--arch", "qwen3_8b", "--reduced", "--steps", "3", "--batch", "2",
                       "--seq", "8", "--device", "cpu", "--ckpt-dir", str(tmp_path)]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu" and out["steps_run"] == 3 and out["final_step"] == 3


def test_train_init_matches_reference_structure():
    """The launcher's initial state: the reference's parameter tree (names and
    shapes) and AdamW state, on the meta device without drawing."""
    coord = build("jamba_v01_52b", reduced=True, batch=2, seq=8, steps=1, ckpt_dir="unused",
                  device="cpu")
    like = coord.init_state_fn(device="meta")
    r_params, _ = RM.shapes_and_axes(ref_get_arch("jamba_v01_52b").reduced())
    want = {k: tuple(v.shape) for k, v in flat_keys(r_params).items()}
    assert {k: tuple(v.shape) for k, v in flat_keys(like["params"]).items()} == want
    assert {k: tuple(v.shape) for k, v in flat_keys(like["opt_state"]["m"]).items()} == want
    assert like["opt_state"]["step"].dtype == torch.int32


# ---------------------------------------------------------------------------
# health + elastic
# ---------------------------------------------------------------------------


def test_health_dead_host_detection():
    mon = HealthMonitor(range(4), timeout_s=10)
    for h in range(4):
        mon.heartbeat(h, now=100.0)
    mon.heartbeat(2, now=130.0)
    dead = mon.dead_hosts(now=135.0)
    assert dead == [0, 1, 3]
    assert mon.alive_hosts() == [2]


def test_straggler_needs_patience():
    mon = HealthMonitor(range(4), straggler_factor=1.5, patience=3, ema_alpha=1.0)
    for h in range(4):
        mon.heartbeat(h, 0.0)
    for step in range(3):
        for h in range(4):
            mon.report_step_time(h, 10.0 if h == 1 else 1.0)
        s = mon.stragglers()
    assert s == [1]
    # one fast step resets the streak
    mon.report_step_time(1, 1.0)
    for h in (0, 2, 3):
        mon.report_step_time(h, 1.0)
    assert mon.stragglers() == []


def test_elastic_plan_prefers_power_of_two():
    assert largest_usable(16, 256, 1) == 16
    assert largest_usable(13, 256, 1) == 8  # 13 alive -> use 8
    plan = plan_remesh([0, 1, 2, 3, 5, 6, 7, 9, 10, 11, 12, 13, 14], 256)
    assert plan.num_hosts == 8
    assert len(plan.hosts) == 8
    assert plan.global_batch % plan.num_hosts == 0


def test_elastic_plan_no_survivors_raises():
    with pytest.raises(RuntimeError):
        plan_remesh([], 256)


@pytest.mark.parametrize("alive,batch,model_axis", [
    (list(range(16)), 256, 1), (list(range(13)), 256, 2), ([3, 1, 7], 12, 1),
    ([5, 9, 2, 8, 6], 10, 4), ([4], 7, 1), (list(range(7)), 21, 1),
])
def test_elastic_plan_equals_reference(alive, batch, model_axis):
    assert largest_usable(len(alive), batch, model_axis) == ref_largest_usable(
        len(alive), batch, model_axis)
    got, want = plan_remesh(alive, batch, model_axis), ref_plan_remesh(alive, batch, model_axis)
    assert (got.hosts, got.num_hosts, got.global_batch, got.mesh_data, got.mesh_model) == (
        want.hosts, want.num_hosts, want.global_batch, want.mesh_data, want.mesh_model)


def test_coordinator_handles_host_failure(tmp_path):
    coord = build("yi_6b", reduced=True, batch=8, seq=8, steps=1, ckpt_dir=str(tmp_path),
                  device="cpu")
    coord.health = HealthMonitor(range(6), timeout_s=10)
    for h in range(6):
        coord.health.heartbeat(h, now=0.0)
    for h in (0, 2, 3):
        coord.health.heartbeat(h, now=50.0)
    plan = coord.handle_host_failure(now=55.0, global_batch=8, model_axis=1)
    assert plan.hosts == (0, 2) and plan.num_hosts == 2
    assert coord.health.alive_hosts() == [0, 2, 3]
